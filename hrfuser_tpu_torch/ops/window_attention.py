"""Fused attention over pre-partitioned 7x7 windows.

Counterpart of `hrfuser_tpu/ops/pallas_attention.py:fused_window_attention`:

    Wo . MHA(q = x Wq + bq, k = y Wk + bk, v = y Wv + bv) + bo

on windows `[W, N, C]` that the caller has already partitioned and
layer-normed, with a per-head bias [H, N, N] and the scale d^-0.5 applied
to q. The result is pre-residual. The host folds d^-0.5 into Wq / bq
and calls `hrfuser::window_attention` (`ops/chain.py`) in windows mode
(no LN, no ring, no residual): kernel A (`csrc/window_attention.cu`) on
CUDA tensors, `chain.window_attention_plain` on CPU tensors.
`fused_window_attention_plain` is the same function on the unfolded
weights. Launches are counted in `fused_window_attention.launches`.

The kernel takes 7x7 windows only, so N must be 49 (the window of every
config); another N raises `ValueError` on every device.
"""

from __future__ import annotations

from typing import Optional

import torch

from hrfuser_tpu_torch.ops import chain

Tensor = torch.Tensor

TOKENS = 49


def fused_window_attention_plain(x: Tensor, y: Tensor, wq: Tensor,
                                 wk: Tensor, wv: Tensor, wo: Tensor,
                                 bq: Tensor, bk: Tensor, bv: Tensor,
                                 bo: Tensor, bias: Tensor,
                                 num_heads: int) -> Tensor:
    """The same function in float32 torch ops; output in x's dtype."""
    w, n, c = x.shape
    d = c // num_heads

    def heads(t):
        return t.reshape(w, n, num_heads, d).transpose(1, 2)

    xf, yf = x.float(), y.float()
    q = heads(xf @ wq.float() + bq.float()) * d ** -0.5
    k = heads(yf @ wk.float() + bk.float())
    v = heads(yf @ wv.float() + bv.float())
    attn = torch.softmax(q @ k.transpose(-1, -2) + bias.float()[None], -1)
    o = (attn @ v).transpose(1, 2).reshape(w, n, c)
    return (o @ wo.float() + bo.float()).to(x.dtype)


def _fold(wq, wk, wv, wo, bq, bk, bv, bo, bias, num_heads) -> chain.Folded:
    c = wq.shape[0]
    scale = (c // num_heads) ** -0.5
    f32 = torch.float32
    return chain.pack_attention(dict(
        wqkv=torch.cat([wq * scale, wk, wv], 1).to(f32).contiguous(),
        bqkv=torch.cat([bq * scale, bk, bv]).to(f32).contiguous(),
        wo=wo.to(f32).contiguous(), bo=bo.to(f32).contiguous(),
        bias=bias.to(f32).contiguous()), num_heads)


@chain.counts_launches('window_attention.fused_window_attention')
def fused_window_attention(x: Tensor, y: Tensor, wq: Tensor, wk: Tensor,
                           wv: Tensor, wo: Tensor, bq: Tensor, bk: Tensor,
                           bv: Tensor, bo: Tensor, bias: Tensor,
                           num_heads: int, block_windows: int = 16,
                           interpret: Optional[bool] = None) -> Tensor:
    """Attention over partitioned windows.

    Args:
        x: [W, 49, C] query windows (layer-normed), float32 or bfloat16.
        y: [W, 49, C] key/value windows (x itself for self-attention).
        wq/wk/wv/wo: [C, C] projections (x @ w); bq/bk/bv/bo: [C].
        bias: [H, 49, 49] relative-position bias.
        block_windows, interpret: accepted and ignored (the TPU kernel's
            windows per grid step and its Pallas interpreter switch).

    Returns:
        [W, 49, C] attention output (pre-residual), in x's dtype.
    """
    del block_windows, interpret
    if x.dim() != 3 or x.shape[1] != TOKENS:
        raise ValueError(
            f'fused_window_attention: windows [W, N, C] with N = {TOKENS} '
            f'(7x7) expected, got {tuple(x.shape)}; the kernel takes 7x7 '
            f'windows only')
    w, n, c = x.shape
    if c % num_heads:
        raise ValueError(f'fused_window_attention: C={c} not divisible by '
                         f'{num_heads} heads')
    p = _fold(wq, wk, wv, wo, bq, bk, bv, bo, bias, num_heads)
    out = chain.window_attention(
        x.reshape(w, 7, 7, c), None if y is x else y.reshape(-1, 7, 7, c),
        None, None, p, num_heads, 'window_attention.fused_window_attention',
        ln=False)
    return out.view(w, n, c)
