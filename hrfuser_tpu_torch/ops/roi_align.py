"""Aligned multilevel RoIAlign over an FPN pyramid.

Counterpart of the eval pool of `hrfuser_tpu.models.roi_heads.
cascade_roi_head` (`multilevel_roi_align_pallas`, variant v7, on the TPU;
the gather `multilevel_roi_align` elsewhere), and of the single-image
`multilevel_roi_align_pallas` entry with its v4 / v7 / v8 variants.
`multilevel_roi_align` runs kernel C (`csrc/roi_align.cu`, 16-byte
channel vectors: C % 8 == 0 in bfloat16, C % 4 == 0 in float32, levels
16-byte aligned) on CUDA tensors and its plain twin
`multilevel_roi_align_plain` (the gather formulation of
`hrfuser_tpu/ops/roi_align.py:157-192,282-315`) on CPU tensors.
`multilevel_roi_align_onehot` is the training pool, plain torch on every
device, as the JAX package trains through its one-hot formulation. Static
2x2 samples per bin, aligned=True; the adaptive grid (`sample_num=0` in
the JAX package) is not ported and raises. Features are NHWC per level
[B, H_l, W_l, C]; RoIs [B, N, 4]; the result is [B, N, out*out, C] in the
features' dtype with bins in (y, x) row-major order.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from hrfuser_tpu_torch.ops.chain import (check_device, count_launch,
                                         counts_launches)
from hrfuser_tpu_torch.utils import cuda_build

Tensor = torch.Tensor


def map_roi_levels(rois: Tensor, num_levels: int, finest_scale: int = 56
                   ) -> Tensor:
    """FPN level per RoI (`single_level_roi_extractor.py:36-57`)."""
    scale = torch.sqrt((rois[..., 2] - rois[..., 0])
                       * (rois[..., 3] - rois[..., 1]))
    lvl = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    return lvl.clamp(0, num_levels - 1).long()


def _axis_taps(start: Tensor, bin_size: Tensor, size: Tensor,
               out_size: int, sample_num: int):
    """Per-axis sample taps: lo, hi [..., out*grid] and their masked
    bilinear weights (`roi_align.py:_bilinear_weights`)."""
    g = (torch.arange(sample_num, dtype=start.dtype, device=start.device)
         + 0.5) / sample_num
    p = torch.arange(out_size, dtype=start.dtype, device=start.device)
    frac = (p[:, None] + g[None, :]).reshape(-1)
    coord = start[..., None] + frac * bin_size[..., None]
    sizef = size[..., None].to(coord.dtype)
    inside = (coord > -1.0) & (coord < sizef)
    c = torch.minimum(coord.clamp(min=0.0), sizef - 1.0)
    lo = torch.floor(c).long()
    hi = torch.minimum(lo + 1, size[..., None] - 1)
    w_hi = c - lo.to(c.dtype)
    w_lo = 1.0 - w_hi
    return lo, hi, w_lo * inside, w_hi * inside


def multilevel_roi_align_plain(feats: Sequence[Tensor], rois: Tensor,
                               strides: Sequence[int], out_size: int = 7,
                               sample_num: int = 2, finest_scale: int = 56
                               ) -> Tensor:
    """Gather RoIAlign in float32, one image at a time."""
    if sample_num < 1:
        raise ValueError(f'roi_align: sample_num={sample_num}; adaptive '
                         f'sampling (sample_num 0) is not ported, only a '
                         f'static grid (sample_num > 0)')
    b, n, _ = rois.shape
    c = feats[0].shape[-1]
    dev = rois.device
    lvl = map_roi_levels(rois, len(feats), finest_scale)
    heights = torch.tensor([f.shape[1] for f in feats], device=dev)
    widths = torch.tensor([f.shape[2] for f in feats], device=dev)
    sizes = [f.shape[1] * f.shape[2] for f in feats]
    offsets = torch.tensor([sum(sizes[:i]) for i in range(len(feats))],
                           device=dev)
    scale = torch.tensor([1.0 / s for s in strides], dtype=rois.dtype,
                         device=dev)[lvl]
    x1 = rois[..., 0] * scale - 0.5
    y1 = rois[..., 1] * scale - 0.5
    bin_w = (rois[..., 2] * scale - 0.5 - x1) / out_size
    bin_h = (rois[..., 3] * scale - 0.5 - y1) / out_size
    fh, fw = heights[lvl], widths[lvl]
    xlo, xhi, wxl, wxh = _axis_taps(x1, bin_w, fw, out_size, sample_num)
    ylo, yhi, wyl, wyh = _axis_taps(y1, bin_h, fh, out_size, sample_num)
    g = out_size * sample_num
    outs = []
    for i in range(b):
        flat = torch.cat([f[i].reshape(-1, c) for f in feats]).float()
        base = offsets[lvl[i]][:, None, None]
        stride = fw[i][:, None, None]

        def tap(yy, xx):
            idx = base + yy[i][:, :, None] * stride + xx[i][:, None, :]
            return flat[idx.reshape(-1)].reshape(n, g, g, c)

        wy_l, wy_h = wyl[i][:, :, None, None], wyh[i][:, :, None, None]
        wx_l, wx_h = wxl[i][:, None, :, None], wxh[i][:, None, :, None]
        val = (tap(ylo, xlo) * wy_l * wx_l + tap(ylo, xhi) * wy_l * wx_h
               + tap(yhi, xlo) * wy_h * wx_l + tap(yhi, xhi) * wy_h * wx_h)
        val = val.reshape(n, out_size, sample_num, out_size, sample_num, c)
        pooled = val.sum((2, 4)) / (sample_num * sample_num)
        outs.append(pooled.reshape(n, out_size * out_size, c))
    return torch.stack(outs).to(feats[0].dtype)


def _axis_onehot(start: Tensor, bin_size: Tensor, size: int, out_size: int,
                 sample_num: int, rnd) -> Tensor:
    """Separable sampling matrix of one axis, [B, N, out, size]: the total
    bilinear weight of feature row r in output bin p, with the grid
    weights, both taps and the (-1, size) inside mask folded in
    (`hrfuser_tpu/ops/roi_align.py:195-236`, static grid)."""
    g = (torch.arange(sample_num, dtype=start.dtype, device=start.device)
         + 0.5) / sample_num
    p = torch.arange(out_size, dtype=start.dtype, device=start.device)
    coord = start[..., None, None] + (p[:, None] + g) * bin_size[..., None,
                                                                  None]
    inside = (coord > -1.0) & (coord < float(size))
    c = coord.clamp(0.0, float(size) - 1.0)
    lo = torch.floor(c)
    hi = (lo + 1.0).clamp(max=float(size) - 1.0)
    w_hi = c - lo
    w_lo = 1.0 - w_hi
    w_lo = rnd(w_lo * inside / sample_num)[..., None]    # [B, N, out, g, 1]
    w_hi = rnd(w_hi * inside / sample_num)[..., None]
    rows = torch.arange(size, dtype=start.dtype, device=start.device)
    w = (rows == lo[..., None]) * w_lo + (rows == hi[..., None]) * w_hi
    return rnd(w.sum(-2))


def multilevel_roi_align_onehot(feats: Sequence[Tensor], rois: Tensor,
                                strides: Sequence[int], out_size: int = 7,
                                sample_num: int = 2, finest_scale: int = 56,
                                bf16_operands: bool = True) -> Tensor:
    """RoIAlign as separable one-hot matmuls, the training pool
    (`hrfuser_tpu/ops/roi_align.py:239-280`): per level, every RoI's
    y-weights times the map, then its x-weights, the RoIs of other levels
    masked to zero. Plain differentiable torch ops on any device; the
    backward is two transposed matmuls instead of a scatter.

    feats: per level [B, H_l, W_l, C]; rois [B, N, 4]. Returns float32
    [B, N, out*out, C], bins in (y, x) order. `bf16_operands` rounds the
    matmul operands to bfloat16 and multiplies in float32, which is what
    JAX's bf16 einsum with `preferred_element_type=f32` computes
    (`gather_bf16=True`); otherwise everything is float32.
    """
    if sample_num < 1:
        raise ValueError(f'roi_align: sample_num={sample_num}; only a static '
                         f'grid (sample_num > 0) is ported')

    def rnd(t):
        return t.to(torch.bfloat16).float() if bf16_operands else t

    b, n, _ = rois.shape
    lvl = map_roi_levels(rois, len(feats), finest_scale)
    out = None
    for li, f in enumerate(feats):
        _, h, w, c = f.shape
        scale = 1.0 / strides[li]
        x1 = rois[..., 0] * scale - 0.5
        y1 = rois[..., 1] * scale - 0.5
        roi_w = rois[..., 2] * scale - 0.5 - x1
        roi_h = rois[..., 3] * scale - 0.5 - y1
        wy = _axis_onehot(y1, roi_h / out_size, h, out_size, sample_num, rnd)
        wx = _axis_onehot(x1, roi_w / out_size, w, out_size, sample_num, rnd)
        wy = wy * (lvl == li)[..., None, None]
        tmp = torch.matmul(wy.reshape(b, n * out_size, h),
                           rnd(f.float()).reshape(b, h, w * c))
        tmp = rnd(tmp).reshape(b, n, out_size, w, c)     # [B, N, p, W, C]
        lvl_out = torch.matmul(wx[:, :, None], tmp)      # [B, N, p, q, C]
        out = lvl_out if out is None else out + lvl_out
    return out.reshape(b, n, out_size * out_size, -1)


def _launch(feats: Sequence[Tensor], rois: Tensor, strides: Sequence[int],
            out_size: int, sample_num: int, finest_scale: int) -> Tensor:
    """Validate and launch kernel C; counts nothing."""
    f0 = feats[0]
    if (len(feats) != 4 or len(strides) != 4 or out_size != 7
            or sample_num != 2
            or f0.dtype not in (torch.float32, torch.bfloat16)):
        raise ValueError('roi_align kernel: 4 levels, 7x7 bins, 2x2 '
                         'samples, float32/bfloat16 features')
    b, _, _, c = f0.shape
    vec = 16 // f0.element_size()        # channels in one 16-byte load
    if c % vec:
        raise ValueError(f'roi_align kernel: C={c} {f0.dtype} features need '
                         f'C % {vec} == 0 (16-byte channel vectors)')
    for f in feats:
        if (f.device != f0.device or f.dtype != f0.dtype or f.dim() != 4
                or f.shape[0] != b or f.shape[3] != c
                or not f.is_contiguous()):
            raise ValueError('roi_align kernel: levels must be contiguous '
                             f'[{b}, H, W, {c}] {f0.dtype} on {f0.device}')
        if f.data_ptr() % 16:
            raise ValueError('roi_align kernel: every level must start on '
                             'a 16-byte boundary')
    if (rois.device != f0.device or rois.dtype != torch.float32
            or rois.dim() != 3 or rois.shape[0] != b or rois.shape[2] != 4
            or not rois.is_contiguous()):
        raise ValueError(f'roi_align kernel: rois must be contiguous '
                         f'float32 [{b}, N, 4] on {f0.device}')
    n = rois.shape[1]
    out = torch.empty((b, n, 49, c), dtype=f0.dtype, device=f0.device)
    dims = [d for f in feats for d in (f.shape[1], f.shape[2])]
    lib = cuda_build.lib()
    cuda_build.check(lib.hrf_roi_align(
        *[f.data_ptr() for f in feats], *dims,
        *[1.0 / s for s in strides], rois.data_ptr(), out.data_ptr(),
        b, n, c, float(finest_scale), int(f0.dtype == torch.bfloat16),
        torch.cuda.current_stream(f0.device).cuda_stream), 'hrf_roi_align')
    return out


@torch.library.custom_op('hrfuser::roi_align', mutates_args=(),
                         device_types='cuda')
def roi_align_op(feats: List[Tensor], rois: Tensor, strides: List[int],
                 out_size: int, sample_num: int, finest_scale: int,
                 entry: str) -> Tensor:
    """Kernel C (`_launch`); one launch counted under `entry`."""
    out = _launch(feats, rois, strides, out_size, sample_num, finest_scale)
    count_launch(entry)
    return out


@roi_align_op.register_kernel('cpu')
def _roi_align_cpu(feats, rois, strides, out_size, sample_num, finest_scale,
                   entry):
    del entry
    return multilevel_roi_align_plain(feats, rois, strides, out_size,
                                      sample_num, finest_scale)


@roi_align_op.register_fake
def _roi_align_fake(feats, rois, strides, out_size, sample_num, finest_scale,
                    entry):
    b, n = rois.shape[:2]
    return feats[0].new_empty((b, n, out_size * out_size,
                               feats[0].shape[-1]))


def _roi_align(feats: Sequence[Tensor], rois: Tensor, strides: Sequence[int],
               out_size: int, sample_num: int, finest_scale: int,
               entry: str) -> Tensor:
    """`hrfuser::roi_align`: the plain twin for CPU tensors, kernel C for
    CUDA tensors (counted under `entry`)."""
    check_device(feats[0])
    return roi_align_op(list(feats), rois, list(strides), out_size,
                        sample_num, finest_scale, entry)


@counts_launches('multilevel_roi_align')
def multilevel_roi_align(feats: Sequence[Tensor], rois: Tensor,
                         strides: Sequence[int], out_size: int = 7,
                         sample_num: int = 2, finest_scale: int = 56
                         ) -> Tensor:
    """RoIAlign over 4 NHWC levels (kernel C on CUDA, plain on CPU)."""
    return _roi_align(feats, rois, strides, out_size, sample_num,
                      finest_scale, 'multilevel_roi_align')


# The TPU kernel's schedules (`pallas_roi_align.py` QP_VARIANTS): one
# function, served here by one kernel.
VARIANTS = ('v4', 'v7', 'v8')


@counts_launches('multilevel_roi_align_pallas')
def multilevel_roi_align_pallas(feats: Sequence[Tensor], rois: Tensor,
                                strides: Sequence[int] = (4, 8, 16, 32),
                                out_size: int = 7, sample_num: int = 2,
                                finest_scale: int = 56,
                                interpret: bool = False,
                                flat_out: bool = False,
                                variant: str = 'v7') -> Tensor:
    """Single-image RoIAlign with the signature of
    `hrfuser_tpu/ops/pallas_roi_align.py:834` (batched callers use
    `multilevel_roi_align`).

    feats: per-level [H_l, W_l, C]; rois: [N, 4]. Returns [N, out, out, C]
    with bins in (p, q) = (y, x) order or, with `flat_out`, [N, out*out, C]
    in the TPU kernels' (q, p) row order (x-bin major). `variant` v4, v7
    and v8 are three TPU schedules of one function (the same sampling,
    aligned=True, a static 2x2 grid); all three run kernel C, whose
    full-coverage contract pools every RoI exactly, so v4's oversize-
    gather fallback has nothing to catch. `interpret` is ignored. Unlike
    the TPU kernel, which always returns bfloat16, the result keeps the
    features' dtype (float32 or bfloat16). Launches are counted in
    `multilevel_roi_align_pallas.launches`.
    """
    del interpret
    if variant not in VARIANTS:
        raise ValueError(f'unknown RoIAlign kernel variant: {variant!r}; '
                         f'known: {VARIANTS}')
    if sample_num <= 0:
        raise ValueError('multilevel_roi_align_pallas needs a static sample '
                         'grid (sample_num > 0)')
    out = _roi_align([f[None].contiguous() for f in feats],
                     rois[None].contiguous(), strides, out_size, sample_num,
                     finest_scale, 'multilevel_roi_align_pallas')
    n, c = rois.shape[0], out.shape[-1]
    grid = out[0].reshape(n, out_size, out_size, c)
    if flat_out:
        return grid.transpose(1, 2).reshape(n, out_size * out_size, c)
    return grid

