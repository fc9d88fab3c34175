"""SeeingThroughFog raw -> LUT conversion (decompanding + tone LUTs).

Port of `hrfuser_tpu/data/stf_lut.py`, itself a rebuild of
`SeeingThroughFog/tools/Raw2LUTImages/conversion_lib/` (`decompand.py`,
`process.py`): the RCCB stereo camera records 12-bit companded raw
frames; the published `cam_stereo_left_lut` images come from (1) a
piecewise-linear decompanding LUT to 16-bit linear, (2) a day/night
tone-mapping LUT, (3) Bayer demosaic + 8-bit shift + CLAHE +
rectification. The LUTs are built on the host in numpy, as in JAX;
`decompand_image` applies one by a gather on the image's device. Step
3 (`raw_to_lut8`, `gated_raw_to_lut8`) needs a Bayer demosaic, a LAB
conversion and CLAHE bit-exact to `cv2`'s, which the port does not have
yet (ROADMAP §1, "The 8-bit LUT renderings"): both raise.

The kneepoint tables are sensor facts from the reference
(`process.py:23-36`, `decompand.py` usage).
"""

from __future__ import annotations

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


LUT8_NOT_PORTED = (
    '8-bit LUT images need a Bayer demosaic, a LAB conversion and CLAHE '
    'bit-exact to cv2, not ported yet (ROADMAP section 1, "The 8-bit LUT '
    'renderings": raw_to_lut8 / gated_raw_to_lut8 / --lut8)')


def raw_to_lut8(raw_bayer, daytime: bool):
    """Raw 12-bit Bayer frame -> 8-bit BGR LUT image: not ported."""
    raise NotImplementedError(LUT8_NOT_PORTED)


def gated_raw_to_lut8(raw):
    """Raw 10-bit gated frame -> 8-bit grey LUT image: not ported."""
    raise NotImplementedError(LUT8_NOT_PORTED)
