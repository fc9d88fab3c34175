"""RoIAlign over an FPN pyramid, and on one map.

Counterpart of `hrfuser_tpu/ops/roi_align.py` and of the eval pool of
`hrfuser_tpu.models.roi_heads.cascade_roi_head` (`multilevel_roi_align_
pallas`, variant v7, on the TPU; the gather `multilevel_roi_align`
elsewhere), and of the single-image `multilevel_roi_align_pallas` entry
with its v4 / v7 / v8 variants. `multilevel_roi_align` runs kernel C
(`csrc/roi_align.cu`, 16-byte channel vectors: C % 8 == 0 in bfloat16,
C % 4 == 0 in float32, levels 16-byte aligned) on CUDA tensors and its
plain twin `multilevel_roi_align_plain` (the gather formulation of
`hrfuser_tpu/ops/roi_align.py:157-192,282-335`) on CPU tensors.
`multilevel_roi_align_onehot` is the training pool, plain torch on every
device, as the JAX package trains through its one-hot formulation;
`roi_align` is the single-level function, plain torch as JAX's is plain
jnp.

The sampling contract is JAX's (`roi_align.py:8-18`): `sample_num > 0`
samples a static `sample_num x sample_num` grid a bin; `sample_num = 0`
is the reference's `sampling_ratio=0`, `ceil(bin)` samples an axis,
clamped to `[1, max_grid]`, each axis's samples weighted `1 / count`;
`aligned` subtracts half a pixel (else the RoI is at least 1 pixel a
side). Features are NHWC per level [B, H_l, W_l, C]; RoIs [B, N, 4]; the
result is [B, N, out*out, C] in the features' dtype with bins in (y, x)
row-major order.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from hrfuser_tpu_torch.ops.chain import (check_device, count_launch,
                                         counts_launches)
from hrfuser_tpu_torch.utils import cuda_build

Tensor = torch.Tensor

# the twin gathers at most this many float32 values a tap at once (per
# chunk of RoIs): a whole 1000-RoI image at grid 4 and C = 256 would be
# 0.8 GB a tap
_CHUNK_VALUES = 1 << 24


def map_roi_levels(rois: Tensor, num_levels: int, finest_scale: int = 56
                   ) -> Tensor:
    """FPN level per RoI (`single_level_roi_extractor.py:36-57`)."""
    scale = torch.sqrt((rois[..., 2] - rois[..., 0])
                       * (rois[..., 3] - rois[..., 1]))
    lvl = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    return lvl.clamp(0, num_levels - 1).long()


def check_grid(sample_num: int, max_grid: int) -> int:
    """The per-axis sample bound of a bin: `sample_num`, or `max_grid` in
    the adaptive mode; raises for a negative `sample_num` or an adaptive
    bound below 1."""
    if sample_num < 0:
        raise ValueError(f'roi_align: sample_num={sample_num}; a static '
                         f'grid takes sample_num > 0, adaptive sampling '
                         f'sample_num 0')
    if sample_num == 0 and max_grid < 1:
        raise ValueError(f'roi_align: adaptive sampling needs max_grid >= '
                         f'1, not {max_grid}')
    return sample_num or max_grid


def _div(t: Tensor, d) -> Tensor:
    """`t / d`, a true division on every device: CUDA divides by a Python
    scalar as a multiply by its reciprocal, an ulp away, which moves the
    `ceil` of a bin that sits on an integer."""
    return t / t.new_tensor(float(d))


def _axis_samples(start: Tensor, roi_size: Tensor, out_size: int,
                  sample_num: int, max_grid: int):
    """One axis of `_sample_coords_per_roi` (`roi_align.py:282-335`): the
    sample coordinates [..., out*grid] and the per-sample weights
    [..., grid] (`active / count`; inactive samples reuse the last active
    coordinate)."""
    grid = check_grid(sample_num, max_grid)
    bin_size = _div(roi_size, out_size)
    g = torch.arange(grid, dtype=start.dtype, device=start.device)
    p = torch.arange(out_size, dtype=start.dtype, device=start.device)
    if sample_num > 0:
        cnt = torch.full_like(start, float(sample_num))
    else:
        cnt = torch.ceil(bin_size).clamp(1, grid)
    cnt = cnt[..., None]
    s = (torch.minimum(g, cnt - 1.0) + 0.5) / cnt          # [..., grid]
    frac = p[:, None] + s[..., None, :]                    # [..., out, grid]
    coord = start[..., None] + frac.flatten(-2) * bin_size[..., None]
    return coord, (g < cnt).to(start.dtype) / cnt


def _sample_coords(rois: Tensor, scale: Tensor, out_size: int,
                   sample_num: int, aligned: bool, max_grid: int):
    """(xs, ys, wx, wy) of every RoI (`_sample_coords_per_roi`)."""
    offset = 0.5 if aligned else 0.0
    x1 = rois[..., 0] * scale - offset
    y1 = rois[..., 1] * scale - offset
    roi_w = rois[..., 2] * scale - offset - x1
    roi_h = rois[..., 3] * scale - offset - y1
    if not aligned:
        roi_w, roi_h = roi_w.clamp(min=1.0), roi_h.clamp(min=1.0)
    xs, wx = _axis_samples(x1, roi_w, out_size, sample_num, max_grid)
    ys, wy = _axis_samples(y1, roi_h, out_size, sample_num, max_grid)
    return xs, ys, wx, wy


def _bilinear(coord: Tensor, size: Tensor):
    """Taps lo, hi of each sample and their bilinear weights, zero
    outside (-1, size) (`roi_align.py:_bilinear_weights`); `size` per
    RoI."""
    sizef = size[..., None].to(coord.dtype)
    inside = (coord > -1.0) & (coord < sizef)
    c = torch.minimum(coord.clamp(min=0.0), sizef - 1.0)
    lo = torch.floor(c).long()
    hi = torch.minimum(lo + 1, size[..., None] - 1)
    w_hi = c - lo.to(c.dtype)
    w_lo = 1.0 - w_hi
    return lo, hi, w_lo * inside, w_hi * inside


def _gather_pool(flat: Tensor, base: Tensor, fh: Tensor, fw: Tensor,
                 xs: Tensor, ys: Tensor, wx: Tensor, wy: Tensor,
                 out_size: int) -> Tensor:
    """Gather RoIAlign of one image's RoIs from `flat` [rows, C] float32:
    RoI r's map starts at row `base[r]`, is `fh[r]` x `fw[r]`; samples at
    xs / ys [N, out*grid] weighted wx / wy [N, grid]. [N, out*out, C],
    a chunk of RoIs at a time."""
    n, c = xs.shape[0], flat.shape[1]
    grid = wx.shape[1]
    g = out_size * grid
    chunk = max(1, _CHUNK_VALUES // (g * g * c))
    outs = []
    for s in range(0, n, chunk):
        sl = slice(s, s + chunk)
        xlo, xhi, wxl, wxh = _bilinear(xs[sl], fw[sl])
        ylo, yhi, wyl, wyh = _bilinear(ys[sl], fh[sl])
        m = xlo.shape[0]
        start = base[sl][:, None, None]
        stride = fw[sl][:, None, None]

        def tap(yy, xx):
            idx = start + yy[:, :, None] * stride + xx[:, None, :]
            return flat[idx.reshape(-1)].reshape(m, g, g, c)

        wy_l, wy_h = wyl[:, :, None, None], wyh[:, :, None, None]
        wx_l, wx_h = wxl[:, None, :, None], wxh[:, None, :, None]
        val = (tap(ylo, xlo) * wy_l * wx_l + tap(ylo, xhi) * wy_l * wx_h
               + tap(yhi, xlo) * wy_h * wx_l + tap(yhi, xhi) * wy_h * wx_h)
        val = (val.reshape(m, out_size, grid, out_size, grid, c)
               * wy[sl][:, None, :, None, None, None]
               * wx[sl][:, None, None, None, :, None])
        outs.append(val.sum((2, 4)).reshape(m, out_size * out_size, c))
    return torch.cat(outs)


def multilevel_roi_align_plain(feats: Sequence[Tensor], rois: Tensor,
                               strides: Sequence[int], out_size: int = 7,
                               sample_num: int = 2, finest_scale: int = 56,
                               max_grid: int = 4, aligned: bool = True
                               ) -> Tensor:
    """Gather RoIAlign in float32, one image at a time."""
    check_grid(sample_num, max_grid)
    b = rois.shape[0]
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
    xs, ys, wx, wy = _sample_coords(rois, scale, out_size, sample_num,
                                    aligned, max_grid)
    fh, fw = heights[lvl], widths[lvl]
    outs = []
    for i in range(b):
        flat = torch.cat([f[i].reshape(-1, c) for f in feats]).float()
        outs.append(_gather_pool(flat, offsets[lvl[i]], fh[i], fw[i], xs[i],
                                 ys[i], wx[i], wy[i], out_size))
    return torch.stack(outs).to(feats[0].dtype)


def roi_align(feat: Tensor, rois: Tensor, spatial_scale: float,
              out_size: int = 7, sample_num: int = 2, aligned: bool = True,
              max_grid: int = 4) -> Tensor:
    """Single-level RoIAlign (`hrfuser_tpu/ops/roi_align.py:119-146`),
    plain torch on any device. feat [H, W, C]; rois [N, 4] in image
    coordinates. Returns float32 [N, out, out, C] (the mean over each
    bin's samples)."""
    h, w, c = feat.shape
    n = rois.shape[0]
    scale = torch.full((n,), spatial_scale, dtype=rois.dtype,
                       device=rois.device)
    xs, ys, wx, wy = _sample_coords(rois, scale, out_size, sample_num,
                                    aligned, max_grid)
    zero = torch.zeros((n,), dtype=torch.long, device=rois.device)
    out = _gather_pool(feat.reshape(h * w, c).float(), zero, zero + h,
                       zero + w, xs, ys, wx, wy, out_size)
    return out.reshape(n, out_size, out_size, c)


def _axis_onehot(start: Tensor, roi_size: Tensor, size: int, out_size: int,
                 sample_num: int, max_grid: int, rnd) -> Tensor:
    """Separable sampling matrix of one axis, [B, N, out, size]: the total
    bilinear weight of feature row r in output bin p, with the grid
    weights, both taps and the (-1, size) inside mask folded in
    (`hrfuser_tpu/ops/roi_align.py:195-236`, static and adaptive grid)."""
    coord, wgt = _axis_samples(start, roi_size, out_size, sample_num,
                               max_grid)
    coord = coord.unflatten(-1, (out_size, wgt.shape[-1]))
    inside = (coord > -1.0) & (coord < float(size))
    c = coord.clamp(0.0, float(size) - 1.0)
    lo = torch.floor(c)
    hi = (lo + 1.0).clamp(max=float(size) - 1.0)
    w_hi = c - lo
    w_lo = 1.0 - w_hi
    wg = wgt[..., None, :]
    w_lo = rnd(w_lo * wg * inside)[..., None]            # [B, N, out, g, 1]
    w_hi = rnd(w_hi * wg * inside)[..., None]
    rows = torch.arange(size, dtype=start.dtype, device=start.device)
    w = (rows == lo[..., None]) * w_lo + (rows == hi[..., None]) * w_hi
    return rnd(w.sum(-2))


def multilevel_roi_align_onehot(feats: Sequence[Tensor], rois: Tensor,
                                strides: Sequence[int], out_size: int = 7,
                                sample_num: int = 2, finest_scale: int = 56,
                                bf16_operands: bool = True,
                                max_grid: int = 4, aligned: bool = True
                                ) -> Tensor:
    """RoIAlign as separable one-hot matmuls, the training pool
    (`hrfuser_tpu/ops/roi_align.py:238-279`): per level, every RoI's
    y-weights times the map, then its x-weights, the RoIs of other levels
    masked to zero. Plain differentiable torch ops on any device; the
    backward is two transposed matmuls instead of a scatter.

    feats: per level [B, H_l, W_l, C]; rois [B, N, 4]. Returns float32
    [B, N, out*out, C], bins in (y, x) order. `bf16_operands` rounds the
    matmul operands to bfloat16 and multiplies in float32, which is what
    JAX's bf16 einsum with `preferred_element_type=f32` computes
    (`gather_bf16=True`); otherwise everything is float32.
    """
    check_grid(sample_num, max_grid)

    def rnd(t):
        return t.to(torch.bfloat16).float() if bf16_operands else t

    b, n, _ = rois.shape
    lvl = map_roi_levels(rois, len(feats), finest_scale)
    offset = 0.5 if aligned else 0.0
    out = None
    for li, f in enumerate(feats):
        _, h, w, c = f.shape
        scale = 1.0 / strides[li]
        x1 = rois[..., 0] * scale - offset
        y1 = rois[..., 1] * scale - offset
        roi_w = rois[..., 2] * scale - offset - x1
        roi_h = rois[..., 3] * scale - offset - y1
        if not aligned:
            roi_w, roi_h = roi_w.clamp(min=1.0), roi_h.clamp(min=1.0)
        wy = _axis_onehot(y1, roi_h, h, out_size, sample_num, max_grid, rnd)
        wx = _axis_onehot(x1, roi_w, w, out_size, sample_num, max_grid, rnd)
        wy = wy * (lvl == li)[..., None, None]
        tmp = torch.matmul(wy.reshape(b, n * out_size, h),
                           rnd(f.float()).reshape(b, h, w * c))
        tmp = rnd(tmp).reshape(b, n, out_size, w, c)     # [B, N, p, W, C]
        lvl_out = torch.matmul(wx[:, :, None], tmp)      # [B, N, p, q, C]
        out = lvl_out if out is None else out + lvl_out
    return out.reshape(b, n, out_size * out_size, -1)


# launches of each of kernel C's plans (`plan`), next to the entries'
# counters: the model path's pools are one entry whatever the grid
PLAN_LAUNCHES = {'2x2': 0, 'grid': 0}


def plan(sample_num: int, aligned: bool) -> str:
    """The plan kernel C runs a grid with: '2x2' for an aligned 2x2 grid,
    'grid' (the general plan) for every other."""
    return '2x2' if sample_num == 2 and aligned else 'grid'


def plan_bytes(c: int, dtype: torch.dtype, grid: int) -> int:
    """Shared memory of kernel C's general plan for C channels of `dtype`
    and a grid bound of `grid` samples an axis (its RoI tables)."""
    return int(cuda_build.lib().hrf_roi_align_smem(
        c, int(dtype == torch.bfloat16), grid))


def _launch(feats: Sequence[Tensor], rois: Tensor, strides: Sequence[int],
            out_size: int, sample_num: int, finest_scale: int,
            max_grid: int = 4, aligned: bool = True) -> Tensor:
    """Validate and launch kernel C; counts nothing. An aligned 2x2 grid
    takes the 2x2 plan, every other grid the general one."""
    f0 = feats[0]
    if (len(feats) != 4 or len(strides) != 4 or out_size != 7
            or f0.dtype not in (torch.float32, torch.bfloat16)):
        raise ValueError('roi_align kernel: 4 levels, 7x7 bins, '
                         'float32/bfloat16 features')
    grid = check_grid(sample_num, max_grid)
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
    status = lib.hrf_roi_align(
        *[f.data_ptr() for f in feats], *dims,
        *[1.0 / s for s in strides], rois.data_ptr(), out.data_ptr(),
        b, n, c, float(finest_scale), int(f0.dtype == torch.bfloat16),
        sample_num, max_grid, int(aligned),
        torch.cuda.current_stream(f0.device).cuda_stream)
    if status == cuda_build.ERR_NO_PLAN:
        raise ValueError(
            f'roi_align kernel: no plan for a grid of up to {grid} samples '
            f'an axis at C={c} {f0.dtype}: its RoI tables need '
            f'{plan_bytes(c, f0.dtype, grid)} bytes of shared memory, more '
            f'than a block may use')
    cuda_build.check(status, 'hrf_roi_align')
    return out


@torch.library.custom_op('hrfuser::roi_align', mutates_args=(),
                         device_types='cuda')
def roi_align_op(feats: List[Tensor], rois: Tensor, strides: List[int],
                 out_size: int, sample_num: int, finest_scale: int,
                 max_grid: int, aligned: bool, entry: str) -> Tensor:
    """Kernel C (`_launch`); one launch counted under `entry`."""
    out = _launch(feats, rois, strides, out_size, sample_num, finest_scale,
                  max_grid, aligned)
    count_launch(entry)
    PLAN_LAUNCHES[plan(sample_num, aligned)] += 1
    return out


@roi_align_op.register_kernel('cpu')
def _roi_align_cpu(feats, rois, strides, out_size, sample_num, finest_scale,
                   max_grid, aligned, entry):
    del entry
    return multilevel_roi_align_plain(feats, rois, strides, out_size,
                                      sample_num, finest_scale, max_grid,
                                      aligned)


@roi_align_op.register_fake
def _roi_align_fake(feats, rois, strides, out_size, sample_num, finest_scale,
                    max_grid, aligned, entry):
    b, n = rois.shape[:2]
    return feats[0].new_empty((b, n, out_size * out_size,
                               feats[0].shape[-1]))


def _roi_align(feats: Sequence[Tensor], rois: Tensor, strides: Sequence[int],
               out_size: int, sample_num: int, finest_scale: int,
               max_grid: int, aligned: bool, entry: str) -> Tensor:
    """`hrfuser::roi_align`: the plain twin for CPU tensors, kernel C for
    CUDA tensors (counted under `entry`)."""
    check_device(feats[0])
    check_grid(sample_num, max_grid)
    return roi_align_op(list(feats), rois, list(strides), out_size,
                        sample_num, finest_scale, max_grid, aligned, entry)


@counts_launches('multilevel_roi_align')
def multilevel_roi_align(feats: Sequence[Tensor], rois: Tensor,
                         strides: Sequence[int], out_size: int = 7,
                         sample_num: int = 2, finest_scale: int = 56,
                         max_grid: int = 4, aligned: bool = True) -> Tensor:
    """RoIAlign over 4 NHWC levels (kernel C on CUDA, plain on CPU)."""
    return _roi_align(feats, rois, strides, out_size, sample_num,
                      finest_scale, max_grid, aligned, 'multilevel_roi_align')


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
    aligned=True, any static grid `sample_num > 0`); all three run kernel
    C, whose full-coverage contract pools every RoI exactly, so v4's
    oversize-gather fallback has nothing to catch. `interpret` is
    ignored. Unlike the TPU kernel, which always returns bfloat16, the
    result keeps the features' dtype (float32 or bfloat16). Launches are
    counted in `multilevel_roi_align_pallas.launches`.
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
                     finest_scale, 4, True, 'multilevel_roi_align_pallas')
    n, c = rois.shape[0], out.shape[-1]
    grid = out[0].reshape(n, out_size, out_size, c)
    if flat_out:
        return grid.transpose(1, 2).reshape(n, out_size * out_size, c)
    return grid
