"""FLOP formulas of the registered ops, for `torch.utils.flop_counter`.

`FlopCounterMode` counts the aten products (matmuls, convolutions and
their backward) by itself, but a `torch.library` op is opaque to it: it
would count 0 for kernels A, B and C. Importing this module registers a
formula for each of the port's ops (`ops/__init__.py` does), so a forward
under the mode counts the kernels' work too (`apis/flops.py`).

Each formula counts the arithmetic the model asks for, a multiply-add as
2 FLOPs, and not the kernel's tiles: the bf16 plans pad rows to 64 and
heads to 48 wide, and kernel B pads its packed weights, but that padding
is no work of the model's, and a share of peak must not count it.

  * `hrfuser::window_attention` (kernel A): `T C (8 C + 4 N)` a call, N
    the tokens of a window (49 for 7x7), T the tokens of the query map
    padded to whole windows, as JAX's flax block pads before it
    contracts: q, k, v and the output projection `8 T C^2`; `q k^T` and
    `attn v` `2 T N C` each. The same in self and cross mode (q from
    `q_src`, k and v from `kv_src`).
  * `hrfuser::cross_ffn` (kernel B): `4 P C H + 18 P H` for P tokens,
    width C and H hidden channels: fc1 and fc2, then the depthwise 3x3
    (9 multiply-adds an output); `16 P C^2 + 72 P C` at H = 4 C.
  * `hrfuser::roi_align` (kernel C): a multiply-add per channel for each
    of the 4 bilinear taps of each of the `out^2 s^2` samples of a RoI
    (7x7 bins, 2x2 samples: 1568 C a RoI). In the adaptive mode
    (`sample_num=0`) s is `max_grid`, the grid the JAX gather pool's
    jaxpr contracts over whatever each RoI's own count: a bound on the
    work, which depends on the RoIs.
  * `hrfuser::greedy_keep`: 0, like the rest of NMS (comparisons only).
"""

from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import register_flop_formula

# the modules that define the ops
from hrfuser_tpu_torch.ops import chain, nms, roi_align  # noqa: F401


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def window_attention_flops(q_shape, window_tokens: int = 49,
                           padded: bool = True) -> int:
    """Kernel A's FLOPs on a query map [B, H, W, C] (or windows
    [W, ws, ws, C]) with `window_tokens` tokens a window; the heads split
    C, so the count does not depend on them. `padded=False` counts the
    map's own tokens only, the least work that produces them (a kernel's
    bound): the padding ring's queries, attention rows and projections
    are no output of the op's."""
    ws = math.isqrt(window_tokens)
    b, h, w, c = q_shape
    if padded:
        h, w = _round_up(h, ws), _round_up(w, ws)
    return b * h * w * c * (8 * c + 4 * window_tokens)


def cross_ffn_flops(x_shape, hidden: int) -> int:
    """Kernel B's FLOPs on [B, H, W, C] with `hidden` channels."""
    *lead, c = x_shape
    p = math.prod(lead)
    return 4 * p * c * hidden + 18 * p * hidden


def roi_align_flops(rois_shape, channels: int, out_size: int = 7,
                    sample_num: int = 2, max_grid: int = 4) -> int:
    """Kernel C's FLOPs for rois [B, N, 4] over C-channel levels; an
    adaptive grid (`sample_num=0`) counts `max_grid` samples an axis."""
    grid = sample_num or max_grid
    samples = out_size * out_size * grid * grid
    return math.prod(rois_shape[:-1]) * samples * 4 * 2 * channels


@register_flop_formula(torch.ops.hrfuser.window_attention)
def _window_attention(q_src, kv_src, res, z, lnq, lnkv, wqkv, bqkv, wo, bo,
                      bias, wqkv_p, wo_p, num_heads, padded_h, padded_w,
                      entry, out_shape=None):
    return window_attention_flops(q_src, bias[-1])


@register_flop_formula(torch.ops.hrfuser.cross_ffn)
def _cross_ffn(x, ln, w1, b1, wdw, bdw, w2, b2, w1_p, w2_p, entry,
               out_shape=None):
    return cross_ffn_flops(x, w1[1])


@register_flop_formula(torch.ops.hrfuser.roi_align)
def _roi_align(feats, rois, strides, out_size, sample_num, finest_scale,
               max_grid, aligned, entry, out_shape=None):
    return roi_align_flops(rois, feats[0][-1], out_size, sample_num,
                           max_grid)


@register_flop_formula(torch.ops.hrfuser.greedy_keep)
def _greedy_keep(*args, out_shape=None):
    return 0
