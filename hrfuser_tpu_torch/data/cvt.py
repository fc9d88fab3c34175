"""The colour conversions `cv2`'s small image decoders make, in numpy.

`cv2` does not convert every format's pixels the same way, so each
decoder (`data/{pxm,pam,pfm,bmp,sunras,hdr}.py`) names the conversion
its `cv2` decoder makes. Each one below was found by testing against the
`cv2` 5.0.0 (over all 2^24 BGR triples for the grey ones), not
taken from one shared formula:

  * `bgr_to_grey`: the `icvCvt_BGR2Gray_8u_C3C1R` fixed point of
    `imgcodecs/src/utils.cpp`, 14 bits, rounded: B 1868, G 9617, R 4899.
    PPM, PAM, Sun raster, palettes and 16/24-bit BMP read grey this way.
  * `bgr_to_grey_float`: a 32-bit BMP whose bit fields `cv2` decodes (a
    header of 56 bytes or more with red, green and blue masks) reads grey
    as float32 `(R * 0.299 + G * 0.587) + B * 0.114`, truncated, so the
    same pixels may read one lower than through the 3-channel route.
  * `bgr_to_grey_cvtcolor`: `cv2.cvtColor(..., COLOR_BGR2GRAY)` on uint8,
    15 bits, rounded: B 3735, G 19235, R 9798 (Radiance HDR read grey,
    after its saturating float -> uint8 step).
  * `high_byte`: a 16-bit sample read colour or grey keeps `v >> 8`
    (truncated, not rescaled).
  * `check_size`: the image sizes `cv2` takes (`validateInputImageSize`
    in `loadsave.cpp`).
  * `float_to_u8`: OpenCV's `saturate_cast<uchar>` of a float: rounded
    half to even, clipped to [0, 255], and 0 for NaN, infinities and
    values whose rounding leaves the int32 range.
"""

from __future__ import annotations

import numpy as np

# CV_IO_MAX_IMAGE_WIDTH / _HEIGHT / _PIXELS
MAX_SIDE, MAX_PIXELS = 1 << 20, 1 << 30
# icvCvt_BGR2Gray_8u_C3C1R: (B cB + G cG + R cR + 2^13) >> 14
_CB, _CG, _CR = 1868, 9617, 4899
# cvtColor's 8-bit RGB2Gray: (B + G + R weights) of 2^15, rounded
_YB, _YG, _YR = 3735, 19235, 9798


def check_size(name: str, w: int, h: int) -> None:
    """Refuse a width or height below 1 or above 2^20, or more than 2^30
    pixels, as `cv2` does before it decodes."""
    if not (0 < w <= MAX_SIDE and 0 < h <= MAX_SIDE and w * h <= MAX_PIXELS):
        raise ValueError(f'{name}: a {w}x{h} image, beyond the sizes cv2 '
                         f'reads')


def bgr_to_grey(bgr: np.ndarray, rgb: bool = False) -> np.ndarray:
    """uint8 [..., 3] BGR (RGB with `rgb`) -> uint8 grey, 14-bit fixed
    point, rounded; uint16 -> uint16 by the same weights (`cv2`'s 16-bit
    `icvCvt_BGRA2Gray_16u_CnC1R`, a TIFF's grey samples)."""
    b, g, r = (bgr[..., i].astype(np.int32) for i in ((2, 1, 0) if rgb
                                                      else (0, 1, 2)))
    return ((b * _CB + g * _CG + r * _CR + (1 << 13)) >> 14).astype(
        np.uint16 if bgr.dtype == np.uint16 else np.uint8)


def bgr_to_grey_float(bgr: np.ndarray) -> np.ndarray:
    """uint8 BGR [..., 3] -> uint8 grey in float32, truncated."""
    f = np.float32
    b, g, r = (bgr[..., i].astype(f) for i in range(3))
    return ((r * f(0.299) + g * f(0.587)) + b * f(0.114)).astype(np.uint8)


def bgr_to_grey_cvtcolor(bgr: np.ndarray) -> np.ndarray:
    """uint8 BGR [..., 3] -> uint8 grey as `cv2.cvtColor` gives it."""
    b, g, r = (bgr[..., i].astype(np.int32) for i in range(3))
    return ((b * _YB + g * _YG + r * _YR + (1 << 14)) >> 15).astype(np.uint8)


def grey_to_bgr(grey: np.ndarray) -> np.ndarray:
    """[H, W] -> [H, W, 3], the value repeated."""
    return np.repeat(grey[..., None], 3, -1)


def high_byte(img: np.ndarray) -> np.ndarray:
    """uint16 -> uint8 `v >> 8`; uint8 as it is."""
    return (img >> 8).astype(np.uint8) if img.dtype == np.uint16 else img


def float_to_u8(img: np.ndarray) -> np.ndarray:
    """float32 -> uint8 as OpenCV's `saturate_cast<uchar>` of a float."""
    r = np.rint(img.astype(np.float32))
    with np.errstate(invalid='ignore'):
        ok = np.isfinite(r) & (r >= -2.0 ** 31) & (r < 2.0 ** 31)
        return np.where(ok, np.clip(np.nan_to_num(r), 0, 255), 0).astype(
            np.uint8)
