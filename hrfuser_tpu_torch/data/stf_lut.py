"""SeeingThroughFog raw -> LUT conversion (decompanding + tone LUTs).

Port of `hrfuser_tpu/data/stf_lut.py`, itself a rebuild of
`SeeingThroughFog/tools/Raw2LUTImages/conversion_lib/` (`decompand.py`,
`process.py`): the RCCB stereo camera records 12-bit companded raw
frames; the published `cam_stereo_left_lut` images come from (1) a
piecewise-linear decompanding LUT to 16-bit linear, (2) a day/night
tone-mapping LUT, (3) Bayer demosaic + 8-bit shift + CLAHE +
rectification. The LUTs are built on the host in numpy, as in JAX;
`decompand_image` applies one by a gather on the image's device.

Step 3 (`raw_to_lut8`, `gated_raw_to_lut8`, minus rectification as in
JAX) runs as integer and float32 tensor ops on the image's device, each
routine equal bit for bit to the `cv2` call JAX makes, as measured
against the sandbox's `cv2` 5.0 (`tests/test_torch_stf_lut8.py`; no
`cv2` source was consulted):
  * `bayer_gb_to_bgr` = `cvtColor(raw, COLOR_BAYER_GB2BGR)` on uint16,
    its bilinear demosaic: green on even (row + column), blue on odd
    rows; `(a + b + 1) >> 1` and `(a + b + c + d + 2) >> 2` averages; the
    border copies its inner neighbour (columns, then rows).
  * `bgr_to_lab` / `lab_to_bgr` = `COLOR_BGR2LAB` / `COLOR_LAB2BGR` on
    uint8, `cv2`'s fixed-point paths: the sRGB gamma table, the
    cube-root table (2^15 scale), the D65 matrices at 2^12, and back
    through fixed-point L -> (Y, f(Y)) and a/b -> X, Z tables at 2^14
    and a 4096-entry inverse gamma table; both hold on all 2^24 inputs.
  * `clahe(img, clip)` = `createCLAHE(clip, (8, 8)).apply(img)`: tile
    histograms (BORDER_REFLECT_101 padding of both sides when either is
    not a multiple of 8), the clip limit `max(int(clip * area / 256),
    1)`, the excess spread as `cv2` spreads it, a float32 LUT scale, and
    bilinear interpolation between tile LUTs in float32, one rounding an
    operation, as `cv2`'s SSE build computes it (no fused multiply-add).

The kneepoint tables are sensor facts from the reference
(`process.py:23-36`, `decompand.py` usage).
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch


def _fb(x: float, bitdepth: int = 16) -> int:
    return int(x * 2 ** bitdepth)


DECOMP_KNEEPOINTS = [[1023, 1023], [2559, 4095], [3455, 32767],
                     [3967, 65535]]
COMP_KNEEPOINTS = [[1023, 1023], [4095, 2559], [32767, 3455],
                   [65535, 3967]]
DAYTIME_KNEEPOINTS = [[_fb(x), _fb(y)] for x, y in
                      [(0.005, 0.05), (0.01, 0.2), (0.03, 0.35),
                       (0.05, 0.4), (0.1, 0.5), (0.2, 0.7), (0.3, 0.8),
                       (0.4, 0.9), (0.5, 0.98)]]
NIGHTTIME_KNEEPOINTS = [[_fb(x), _fb(y)] for x, y in
                        [(0.0025, 0.1), (0.005, 0.25), (0.01, 0.4),
                         (0.1, 0.8), (0.2, 0.9), (0.3, 0.98)]]
GATED_KNEEPOINTS = [[_fb(x, 10), _fb(y, 10)] for x, y in
                    [(0.0025, 0.1), (0.005, 0.25), (0.01, 0.3),
                     (0.1, 0.4), (0.2, 0.5), (0.3, 0.6)]]


def decompand_lut(kneepoints: Sequence[Sequence[int]]) -> np.ndarray:
    """Piecewise-linear (de)companding LUT (`decompand.py` semantics).

    Each kneepoint (x2, y2) defines a segment from the previous kneepoint
    with slope (y2-y1)/(x2-x1) — the FIRST segment uses the sentinel
    (-1, -1) start — applied as `(src - src_min) * slope + dst_min`
    clamped at y2, with src_min/dst_min advancing to (x2+1, y2+1).
    """
    lut: List[np.ndarray] = []
    x1, y1 = -1.0, -1.0
    src_min, dst_min = 0, 0
    for x2, y2 in kneepoints:
        slope = (y2 - y1) / (x2 - x1)
        src = np.arange(src_min, x2 + 1, dtype=np.float64)
        vals = np.minimum((src - src_min) * slope + dst_min, y2)
        lut.append(vals)
        x1, y1 = float(x2), float(y2)
        src_min, dst_min = x2 + 1, y2 + 1
    return np.concatenate(lut).astype(np.uint16)


def tone_lut(kneepoints: Sequence[Sequence[int]], bit_depth: int = 16,
             start_point: Tuple[int, int] = (0, 0)) -> np.ndarray:
    """Tone-mapping LUT through kneepoints (`process.py
    create_lut_from_kneepoints` semantics: per-segment floor(m*x + c),
    closing segment to (2^bits, 2^bits))."""
    size = 2 ** bit_depth
    pts = [list(start_point)] + [list(p) for p in kneepoints] + \
        [[size, size]]
    lut = np.zeros((size,), np.uint16)
    for (x1, y1), (x2, y2) in zip(pts[:-1], pts[1:]):
        m = (y2 - y1) / float(x2 - x1)
        c = y1 - m * x1
        xs = np.arange(x1, min(x2, size))
        lut[x1:min(x2, size)] = np.floor(m * xs + c).astype(np.uint16)
    return lut


# module-level LUTs (cheap to build)
def luts():
    return {
        'decompand': decompand_lut(DECOMP_KNEEPOINTS),
        'compand': decompand_lut(COMP_KNEEPOINTS),
        'daytime': tone_lut(DAYTIME_KNEEPOINTS),
        'nighttime': tone_lut(NIGHTTIME_KNEEPOINTS),
        'gated': tone_lut(GATED_KNEEPOINTS, bit_depth=10),
    }


def decompand_image(raw: torch.Tensor) -> torch.Tensor:
    """12-bit companded raw [H, W] (any integer tensor; int16 is read as
    the bits of uint16) -> 16-bit linear, int32, on `raw`'s device."""
    lut = torch.from_numpy(decompand_lut(DECOMP_KNEEPOINTS).astype(
        np.int32)).to(raw.device)
    idx = raw.to(torch.int32)
    if raw.dtype == torch.int16:
        idx = idx & 0xFFFF
    if idx.numel() and not 0 <= int(idx.min()) <= int(idx.max()) < len(lut):
        raise ValueError(f'companded raw values {int(idx.min())}..'
                         f'{int(idx.max())}: the 12-bit LUT holds '
                         f'{len(lut)} entries')
    return lut[idx.long()]


def _as_int32(img, device) -> torch.Tensor:
    """An image as int32 on its device (a numpy array on `device`); int16
    is read as the bits of uint16."""
    if not isinstance(img, torch.Tensor):
        arr = np.asarray(img)
        return torch.from_numpy(arr.astype(np.int32)).to(device)
    out = img.to(torch.int32)
    return out & 0xFFFF if img.dtype == torch.int16 else out


def _bytes(img, device, what: str) -> torch.Tensor:
    """A uint8 image (array or tensor) as int32 on its device; any other
    type raises, so every table index derived from it is in range."""
    if img.dtype not in (np.uint8, torch.uint8):
        raise ValueError(f'{what} takes uint8, not {img.dtype}')
    return _as_int32(img, device)


def _raw(img, device, size: int, what: str) -> torch.Tensor:
    """A raw frame as int32 on its device, each value checked to index a
    table of `size` entries (one host sync)."""
    x = _as_int32(img, device)
    if x.numel() and not 0 <= int(x.min()) <= int(x.max()) < size:
        raise ValueError(f'{what}: values {int(x.min())}..{int(x.max())} '
                         f'index a table of {size} entries')
    return x


def _lut(table: np.ndarray, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] on idx's device, int32. The callers' indices are in
    range by construction (checked inputs, bounded fixed-point sums)."""
    t = torch.from_numpy(np.asarray(table).astype(np.int32)).to(idx.device)
    return t[idx.long()]


# -- CLAHE ------------------------------------------------------------------

def _reflect101(n: int, size: int) -> np.ndarray:
    """Indices 0..n-1 of a BORDER_REFLECT_101 extension of `size`."""
    idx = np.arange(n)
    if size == 1:
        return np.zeros(n, np.int64)
    period = 2 * (size - 1)
    idx = idx % period
    return np.where(idx < size, idx, period - idx)


def clahe(img, clip_limit: float, tiles=(8, 8), device='cuda'
          ) -> torch.Tensor:
    """`cv2.createCLAHE(clip_limit, tiles).apply(img)` for a uint8 [H, W]
    image, as uint8 on the image's device (see the module docstring)."""
    src = _bytes(img, device, 'clahe')
    h, w = src.shape
    tx, ty = tiles
    if h % ty or w % tx:
        rows = _reflect101(h + ty - h % ty, h)
        cols = _reflect101(w + tx - w % tx, w)
        padded = src[torch.as_tensor(rows, device=src.device)][
            :, torch.as_tensor(cols, device=src.device)]
    else:
        padded = src
    th, tw = padded.shape[0] // ty, padded.shape[1] // tx
    area = th * tw
    limit = max(int(clip_limit * area / 256), 1) if clip_limit > 0 else 0
    # one 256-bin histogram a tile
    by_tile = (padded.reshape(ty, th, tx, tw).permute(0, 2, 1, 3)
               .reshape(ty * tx, area))
    offsets = torch.arange(ty * tx, device=src.device)[:, None] * 256
    idx = (by_tile + offsets).reshape(-1)
    hist = torch.zeros(ty * tx * 256, dtype=torch.int64,
                       device=src.device).index_add_(
        0, idx, torch.ones_like(idx)).reshape(ty * tx, 256)
    if limit:
        excess = (hist - limit).clamp(min=0).sum(1, keepdim=True)
        hist = hist.clamp(max=limit) + excess // 256
        residual = excess % 256
        step = (256 // residual.clamp(min=1)).clamp(min=1)
        bins = torch.arange(256, device=src.device)[None]
        hist = hist + ((residual > 0) & (bins % step == 0)
                       & (bins // step < residual)).to(hist.dtype)
    scale = torch.tensor(np.float32(255) / np.float32(area),
                         device=src.device)
    luts = torch.round(hist.cumsum(1).to(torch.float32) * scale).clamp(
        0, 255).reshape(ty, tx, 256)

    def coords(n, size, tiles_n):
        inv = torch.tensor(np.float32(1) / np.float32(size),
                           device=src.device)
        f = torch.arange(n, device=src.device, dtype=torch.float32) * inv \
            - 0.5
        lo = torch.floor(f)
        frac = f - lo
        lo = lo.to(torch.int64)
        return lo.clamp(min=0), (lo + 1).clamp(max=tiles_n - 1), frac, \
            1 - frac

    y1, y2, ya, ya1 = coords(h, th, ty)
    x1, x2, xa, xa1 = coords(w, tw, tx)
    v = src.long()

    def at(ys, xs):
        return luts[ys[:, None], xs[None, :], v]

    res = ((at(y1, x1) * xa1 + at(y1, x2) * xa) * ya1[:, None]
           + (at(y2, x1) * xa1 + at(y2, x2) * xa) * ya[:, None])
    return torch.round(res).clamp(0, 255).to(torch.uint8)


# -- Bayer demosaic -----------------------------------------------------------

def bayer_gb_to_bgr(raw, device='cuda') -> torch.Tensor:
    """`cv2.cvtColor(raw, COLOR_BAYER_GB2BGR)` of a Bayer frame [H, W]
    (uint16 values; int16 tensors are read as their bits), as int32
    [H, W, 3] on its device. H and W are at least 3."""
    s = _as_int32(raw, device)
    h, w = s.shape
    if h < 3 or w < 3:
        raise ValueError(f'a Bayer frame of {h}x{w}: at least 3x3')
    c = s[1:-1, 1:-1]
    up, down, left, right = s[:-2, 1:-1], s[2:, 1:-1], s[1:-1, :-2], \
        s[1:-1, 2:]
    cross = (up + down + left + right + 2) >> 2
    diag = (s[:-2, :-2] + s[:-2, 2:] + s[2:, :-2] + s[2:, 2:] + 2) >> 2
    vert = (up + down + 1) >> 1
    hor = (left + right + 1) >> 1
    yy = torch.arange(1, h - 1, device=s.device)[:, None]
    xx = torch.arange(1, w - 1, device=s.device)[None, :]
    green = (yy + xx) % 2 == 0
    blue_row = yy % 2 == 1
    b = torch.where(green, torch.where(blue_row, hor, vert),
                    torch.where(blue_row, c, diag))
    r = torch.where(green, torch.where(blue_row, vert, hor),
                    torch.where(blue_row, diag, c))
    g = torch.where(green, c, cross)
    inner = torch.stack([b, g, r], -1)
    rows = torch.cat([inner[:, :1], inner, inner[:, -1:]], 1)
    return torch.cat([rows[:1], rows, rows[-1:]], 0)


# -- Lab ----------------------------------------------------------------------

def _srgb(x: np.ndarray) -> np.ndarray:
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def _srgb_inv(x: np.ndarray) -> np.ndarray:
    return np.where(x <= 0.0031308, x * 12.92,
                    1.055 * x ** (1 / 2.4) - 0.055)


# sRGB (D65) <-> XYZ and the D65 white point
RGB2XYZ = np.array([[0.412453, 0.357580, 0.180423],
                    [0.212671, 0.715160, 0.072169],
                    [0.019334, 0.119193, 0.950227]])
XYZ2RGB = np.array([[3.240479, -1.53715, -0.498535],
                    [-0.969256, 1.875991, 0.041556],
                    [0.055648, -0.204043, 1.057311]])
D65 = np.array([0.950456, 1.0, 1.088754])
# cube-root table entries that `cv2` rounds the other way (its float32
# evaluation lands on .5), found by comparing all 2^24 colours
_CBRT_FIXES = {49: -1, 628: 1}
# the smallest f(X) / f(Z) index `lab_to_bgr` forms (L = 0, b = 255)
_AB_MIN = -8145


@functools.cache
def lab_tables() -> dict:
    """The fixed-point tables of `bgr_to_lab` / `lab_to_bgr` (host)."""
    i = np.arange(256)
    tabs = {}
    tabs['gamma'] = np.round(255 * 8 * _srgb(i / 255)).astype(np.int64)
    x = np.arange(256 * 3 // 2 * 8) / (255 * 8)
    cbrt = np.round(2 ** 15 * np.where(x < 216 / 24389,
                                       x * 841 / 108 + 16 / 116,
                                       np.cbrt(x))).astype(np.int64)
    for k, d in _CBRT_FIXES.items():
        cbrt[k] += d
    tabs['cbrt'] = cbrt
    tabs['to_xyz'] = np.round(4096 * RGB2XYZ / D65[:, None]).astype(
        np.int64)
    # back: L -> (Y, f(Y)) at 2^14, a/b -> X, Z at 2^14, XYZ -> RGB at 2^12
    base = 1 << 14
    li = i * 100 / 255
    small = li <= 8
    y_lin = li / 903.3
    fy = (li + 16) / 116
    tabs['y'] = np.round(base * np.where(small, y_lin, fy ** 3)).astype(
        np.int64)
    tabs['fy'] = np.round(base * np.where(
        small, 7.787 * y_lin + 16 / 116, fy)).astype(np.int64)
    v = np.arange(base * 9 // 4) + _AB_MIN
    # linear below 6/29 (C's truncating division), cubed above in steps
    tabs['xz'] = np.where(v <= 3390, np.trunc(v * 108 / 841) - 290,
                          (((v * v) >> 14) * v) >> 14).astype(np.int64)
    tabs['to_rgb'] = np.round(4096 * XYZ2RGB * D65[None, :]).astype(
        np.int64)
    tabs['inv_gamma'] = np.round(255 * _srgb_inv(np.arange(4096) / 4096)
                                 ).astype(np.int64)
    return tabs


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x + (1 << (n - 1))) >> n


def bgr_to_lab(img, device='cuda') -> torch.Tensor:
    """`cv2.cvtColor(img, COLOR_BGR2LAB)` of uint8 BGR [H, W, 3]: uint8
    Lab (L * 255 / 100, a + 128, b + 128) on the image's device."""
    t = lab_tables()
    px = _bytes(img, device, 'bgr_to_lab')
    b, g, r = (_lut(t['gamma'], px[..., k]) for k in range(3))
    m = t['to_xyz']
    f = [_lut(t['cbrt'], _descale(r * int(m[k, 0]) + g * int(m[k, 1])
                                  + b * int(m[k, 2]), 12)) for k in range(3)]
    lightness = _descale(296 * f[1] - 1336934, 15)
    a = _descale(500 * (f[0] - f[1]) + (128 << 15), 15)
    bb = _descale(200 * (f[1] - f[2]) + (128 << 15), 15)
    return torch.stack([lightness, a, bb], -1).clamp(0, 255).to(torch.uint8)


def lab_to_bgr(lab, device='cuda') -> torch.Tensor:
    """`cv2.cvtColor(lab, COLOR_LAB2BGR)` of uint8 Lab [H, W, 3]: uint8
    BGR on the image's device."""
    t = lab_tables()
    px = _bytes(lab, device, 'lab_to_bgr').long()
    lightness, a, b = px[..., 0], px[..., 1], px[..., 2]
    y = _lut(t['y'], lightness).long()
    fy = _lut(t['fy'], lightness).long()
    adiv = ((5 * a * 53687 + (1 << 7)) >> 13) - 4194
    bdiv = ((b * 41943 + (1 << 4)) >> 9) - 10484
    x = _lut(t['xz'], fy + adiv - _AB_MIN).long()
    z = _lut(t['xz'], fy - bdiv - _AB_MIN).long()
    m = t['to_rgb']
    out = [_lut(t['inv_gamma'], _descale(
        x * int(m[k, 0]) + y * int(m[k, 1]) + z * int(m[k, 2]), 14
    ).clamp(0, 4095)) for k in (2, 1, 0)]
    return torch.stack(out, -1).to(torch.uint8)


# -- the 8-bit LUT images -------------------------------------------------------

def raw_to_lut8(raw_bayer, daytime: bool, device='cuda') -> torch.Tensor:
    """Raw 12-bit Bayer frame [H, W] -> 8-bit BGR LUT image [H, W, 3]
    uint8 on its device (`Rectify_image.process_lut`, minus rectification
    which needs the per-camera calib): decompand, day or night tone LUT,
    GB demosaic, >> 8, Lab, CLAHE 2.0 on L and 0.5 on a and b, back to
    BGR."""
    tabs = luts()
    lin = _lut(tabs['decompand'], _raw(raw_bayer, device,
                                       len(tabs['decompand']), 'raw_to_lut8'))
    toned = _lut(tabs['daytime'] if daytime else tabs['nighttime'], lin)
    img8 = (bayer_gb_to_bgr(toned) >> 8).to(torch.uint8)
    lab = bgr_to_lab(img8)
    lab = torch.stack([clahe(lab[..., 0], 2.0), clahe(lab[..., 1], 0.5),
                       clahe(lab[..., 2], 0.5)], -1)
    return lab_to_bgr(lab)


def gated_raw_to_lut8(raw, device='cuda') -> torch.Tensor:
    """Raw 10-bit gated frame [H, W] -> 8-bit grey LUT image [H, W]
    uint8 on its device (`process_rect_lut_gated8`, minus rectification):
    gated tone LUT, >> 2, CLAHE 2.0 with 8x8 tiles."""
    gated = luts()['gated']
    img = (_lut(gated, _raw(raw, device, len(gated), 'gated_raw_to_lut8'))
           >> 2).to(torch.uint8)
    return clahe(img, 2.0)
