"""Block-level ops: one HRFormer / HRFuser block at a time, eval, NHWC.

Counterpart of `hrfuser_tpu/ops/pallas_block.py`, with its argument lists
and layouts:

  * `fused_window_attention` on centre-padded slabs `[B, Hp, Wp, C]` with
    per-head weights, served by kernel A (`csrc/window_attention.cu`,
    padded-frame mode);
  * `fused_cross_ffn` on an unpadded `[B, H, W, C]`, served by kernel B
    (`csrc/cross_ffn.cu`);
  * `fused_hrformer_block` and `fused_fusion_block`, which compose the two
    as the JAX entries do (pad, attention on the slab, crop, CrossFFN).

Where the JAX entries take a flax variables subtree, these take the
port's modules (`layers.attention`), e.g. loaded from a JAX tree with
`utils.jax_weights.hrformer_block_state_dict` /
`fusion_block_state_dict`. `interpret` is accepted and ignored (it selects
the Pallas interpreter on the JAX side).

Each function reaches the kernels through the registered ops
`hrfuser::window_attention` and `hrfuser::cross_ffn` (`ops/chain.py`):
on a CPU tensor they run the plain twins; on a CUDA tensor they launch
the kernels or raise. `fused_window_attention.launches` and
`fused_cross_ffn.launches` count the launches, the block entries' included
(they launch nothing of their own).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from hrfuser_tpu_torch.layers.common import cached
from hrfuser_tpu_torch.ops import chain
from hrfuser_tpu_torch.ops.window import (center_pad_shape,
                                          relative_position_index)

Tensor = torch.Tensor

_NEG = -1e9


def build_attn_bias(table: Tensor, num_heads: int, window: int, wp: int,
                    dtype: torch.dtype) -> Tensor:
    """Combined RPE bias + cross-window mask, [heads, T, T], T = window*wp
    (`pallas_block.py:167-184`).

    Token order is the slab's row-major (row, col); window membership is
    col // window, the within-window position row * window + col % window.
    In-window pairs carry the relative-position bias, pairs across windows
    -1e9."""
    n = window * window
    idx = torch.from_numpy(relative_position_index(window, window))
    bias = table[idx.reshape(-1).to(table.device)].reshape(n, n, num_heads)
    bias = bias.permute(2, 0, 1)
    t = torch.arange(window * wp, device=table.device)
    pos = (t // wp) * window + (t % wp) % window
    win = (t % wp) // window
    full = bias[:, pos][:, :, pos]
    same = win[:, None] == win[None, :]
    return full.masked_fill(~same[None], _NEG).to(dtype)


def _in_window_bias(bias_full: Tensor, window: int, wp: int) -> Tensor:
    """The [h, n, n] in-window bias of a `build_attn_bias` matrix: the
    pairs of the slab's first window."""
    p = torch.arange(window * window, device=bias_full.device)
    tok = (p // window) * wp + p % window
    return bias_full[:, tok][:, :, tok]


def _fold_heads(wq, bq, wk, bk, wv, bv, wo, bo, lnq, lnkv, bias_full,
                window: int, wp: int) -> chain.Folded:
    """Per-head JAX-layout weights -> kernel A's folded weights (d^-0.5 in
    Wq / bq, as `ops/chain.py:_fold_attention` does), packed by
    `chain.pack_attention`."""
    h, c, d = wq.shape

    def cols(t):                          # [h, C, d] -> [C, h*d]
        return t.permute(1, 0, 2).reshape(c, h * d)

    scale = d ** -0.5
    f32 = torch.float32
    return chain.pack_attention(dict(
        lnq=lnq.to(f32).contiguous(), lnkv=lnkv.to(f32).contiguous(),
        wqkv=torch.cat([cols(wq) * scale, cols(wk), cols(wv)], 1)
        .to(f32).contiguous(),
        bqkv=torch.cat([bq.reshape(-1) * scale, bk.reshape(-1),
                        bv.reshape(-1)]).to(f32).contiguous(),
        wo=wo.reshape(h * d, c).to(f32).contiguous(),
        bo=bo.reshape(c).to(f32).contiguous(),
        bias=_in_window_bias(bias_full, window, wp).to(f32).contiguous()), h)


def _crop(t: Tensor, pads, hw) -> Tensor:
    (pt, pl), (h, w) = pads, hw
    return t[:, pt:pt + h, pl:pl + w]


def _check_slab(xq: Tensor, window: int, pads, hw) -> None:
    h, w = hw
    pt, pb, pl, pr = center_pad_shape(h, w, window, window)
    if tuple(pads) != (pt, pl) or tuple(xq.shape[1:3]) != (h + pt + pb,
                                                           w + pl + pr):
        raise ValueError(
            f'fused_window_attention: slab {tuple(xq.shape[1:3])} with pads '
            f'{tuple(pads)} is not the centre padding of {h}x{w} '
            f'(pads ({pt}, {pl}), slab ({h + pt + pb}, {w + pl + pr}))')


def _slab_attention(xq: Tensor, xkv: Tensor, res: Tensor, p: chain.Folded,
                    num_heads: int, window: int, pads, hw,
                    add_kv: bool) -> Tensor:
    """Kernel A (`hrfuser::window_attention`) on a slab: self mode when
    `xkv` is `xq` and LN_kv is LN_q."""
    _check_slab(xq, window, pads, hw)
    self_mode = xkv is xq and p['lnkv'] is p['lnq']
    return chain.window_attention(
        xq, None if self_mode else xkv, res, xkv if add_kv else None, p,
        num_heads, 'block.fused_window_attention', padded_hw=tuple(hw))


@chain.counts_launches('block.fused_window_attention')
def fused_window_attention(xq: Tensor, xkv: Tensor, res: Tensor,
                           wq: Tensor, bq: Tensor, wk: Tensor, bk: Tensor,
                           wv: Tensor, bv: Tensor, wo: Tensor, bo: Tensor,
                           lnq: Tensor, lnkv: Tensor, bias_full: Tensor, *,
                           num_heads: int, window: int,
                           pads: Tuple[int, int], hw: Tuple[int, int],
                           add_kv: bool, interpret: bool = False) -> Tensor:
    """`res + mask . Wo . MHA(LN_q xq, LN_kv xkv) (+ xkv if add_kv)` on
    centre-padded slabs (`pallas_block.py:196`).

    xq, xkv, res: [B, Hp, Wp, C], the centre padding of a real `hw` map
    with `pads` = (top, left) (checked). Weights per head: wq/wk/wv
    [h, C, d], bq/bk/bv [h, 1, d], wo [h, d, C], bo [C]; lnq/lnkv [2, C]
    (scale; bias). `bias_full` [h, T, T], T = window * Wp, must come from
    `build_attn_bias`: the in-window pairs of every window carry the same
    relative-position bias and pairs across windows -1e9; only the first
    window's in-window [h, 49, 49] block is read. The LN'd kv tokens on
    the ring are zero; the ring of the output is `res (+ xkv)`. Every
    add_kv x self/cross combination runs: kernel A reads kv from xkv with
    LN_kv unless xkv is xq and lnkv is lnq.
    """
    del interpret
    wp = xq.shape[2]
    p = _fold_heads(wq, bq, wk, bk, wv, bv, wo, bo, lnq, lnkv, bias_full,
                    window, wp)
    return _slab_attention(xq, xkv, res, p, num_heads, window, pads, hw,
                           add_kv)


def _ffn(x: Tensor, p: chain.Folded) -> Tensor:
    return chain.ffn(x, p, 'block.fused_cross_ffn')


@chain.counts_launches('block.fused_cross_ffn')
def fused_cross_ffn(x: Tensor, ffn: nn.Module, norm: nn.LayerNorm, *,
                    interpret: bool = False) -> Tensor:
    """`x + CrossFFN(LN x)` with the BNs folded (`pallas_block.py:329`).

    x: [B, H, W, C] unpadded; `ffn` a `layers.attention.CrossFFN` (the
    JAX `ffn_p` / `ffn_s` trees), `norm` its LayerNorm (`ln_p`)."""
    del interpret
    deps = list(ffn.parameters()) + list(ffn.buffers()) + list(
        norm.parameters())
    p = cached(ffn, ('fold_cross_ffn', id(norm)),
               lambda: chain.fold_cross_ffn(norm, ffn.layers), deps)
    return _ffn(x, p)


def _check_heads(block: nn.Module, num_heads: int, window: int) -> None:
    if (block.num_heads, block.window_size) != (num_heads, window):
        raise ValueError(f'block has {block.num_heads} heads, window '
                         f'{block.window_size}; called with {num_heads}, '
                         f'{window}')


def _pad(x: Tensor, window: int):
    b, h, w, c = x.shape
    pt, pb, pl, pr = center_pad_shape(h, w, window, window)
    return F.pad(x, (0, 0, pl, pr, pt, pb)), (pt, pl), (h, w)


def fused_hrformer_block(x: Tensor, block: nn.Module, *, num_heads: int,
                         window: int = 7, interpret: bool = False) -> Tensor:
    """Eval `HRFormerBlock` forward through the two kernels
    (`pallas_block.py:418`); `block` is a `layers.attention.HRFormerBlock`.
    """
    del interpret
    _check_heads(block, num_heads, window)
    p = block.folded()
    xp, pads, hw = _pad(x, window)
    x1 = _slab_attention(xp, xp, xp, p['attn'], num_heads, window, pads, hw,
                         add_kv=False)
    return _ffn(_crop(x1, pads, hw).contiguous(), p['ffn'])


def fused_fusion_block(x: Tensor, mods: Sequence[Tensor], block: nn.Module,
                       *, num_heads: int, window: int = 7,
                       interpret: bool = False) -> Tensor:
    """Eval `HRFuserFusionBlock` forward through the kernels
    (`pallas_block.py:450`): every modality's MWCA queries the frozen
    block input, its raw feature is added (`add_kv`), then the CrossFFN.
    `block` is a `layers.attention.HRFuserFusionBlock`."""
    del interpret
    _check_heads(block, num_heads, window)
    p = block.folded()
    xp, pads, hw = _pad(x, window)
    res = xp
    zs: List[Tensor] = [_pad(z, window)[0] for z in mods]
    for z, pk in zip(zs, p['attn'], strict=True):
        res = _slab_attention(xp, z, res, pk, num_heads, window, pads, hw,
                              add_kv=True)
    return _ffn(_crop(res, pads, hw).contiguous(), p['ffn'])
