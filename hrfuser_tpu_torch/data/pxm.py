"""PBM / PGM / PPM decoding (`P1`-`P6`, ASCII and raw) in numpy, as
`cv2` 5.0's `PxMDecoder` (`imgcodecs/src/grfmt_pxm.cpp`) reads them.

The header is `P<n>`, the width, the height and (but for PBM) `maxval`,
each number read as `cv2` reads it: comments (`#` to the end of the
line) and white space before it, one byte after it consumed, whatever
that byte is. The samples start after that byte.

  * `maxval` up to 255 gives 8-bit samples, above 255 16-bit ones
    (big-endian in the raw forms); above 65535 is refused.
  * Raw samples are not rescaled by `maxval` (a `P5` of maxval 100 reads
    its bytes as they are). ASCII 8-bit samples are clamped to `maxval`
    and rescaled, `v * 255 // maxval`; ASCII 16-bit ones only clamped.
  * PBM is 1 bit a sample, 1 = black, raw rows padded to a byte; it
    reads 0 / 255.

`imdecode(data, flag)` returns what `cv2.imdecode` does: 'unchanged'
the file's depth (uint8 / uint16), [H, W] for PBM / PGM, BGR [H, W, 3]
for PPM; 'color' uint8 BGR, 16-bit samples as `v >> 8`, grey repeated;
'grayscale' uint8 [H, W], PPM through `cvt.bgr_to_grey` after the
16 -> 8-bit step. A header `cv2` refuses, or data that ends early,
raises `ValueError`.
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np

from hrfuser_tpu_torch.data import cvt

SPACE = b' \t\n\v\f\r'
_DIGITS = b'0123456789'
INT_MAX = 2 ** 31 - 1
# one ASCII sample as `ReadNumber` reads it: white space and comments,
# the digits, and the one byte after them (consumed, whatever it is)
_NUMBER = re.compile(rb'((?:[ \t\n\v\f\r]|#[^\n\r]*[\n\r])*)([0-9]+)'
                     rb'([^0-9])')
# a PBM sample: one digit, nothing consumed after it
_BIT = re.compile(rb'((?:[ \t\n\v\f\r]|#[^\n\r]*[\n\r])*)([0-9])')


def matches(data: bytes) -> bool:
    """`PxMDecoder::checkSignature`: `P1`-`P6` and a space byte."""
    return (len(data) >= 3 and data[0] == 0x50 and 0x31 <= data[1] <= 0x36
            and data[2] in SPACE)


def _byte(data: bytes, pos: int) -> int:
    if pos >= len(data):
        raise ValueError('PNM: the file ends inside its header')
    return data[pos]


def _read_number(data: bytes, pos: int) -> Tuple[int, int]:
    """`ReadNumber` of `grfmt_pxm.cpp`: (value, position after the byte
    that ended it)."""
    code = _byte(data, pos)
    pos += 1
    while code not in _DIGITS:
        if code == 0x23:                                   # '#'
            while code not in (0x0a, 0x0d):
                code = _byte(data, pos)
                pos += 1
            code = _byte(data, pos)
            pos += 1
        elif code in SPACE:
            while code in SPACE:
                code = _byte(data, pos)
                pos += 1
        else:
            raise ValueError(f'PNM: unexpected byte 0x{code:02x} in the '
                             f'header')
    val = 0
    while code in _DIGITS:
        val = val * 10 + code - 0x30
        if val > INT_MAX:
            raise ValueError('PNM: a header number above 2^31 - 1')
        code = _byte(data, pos)
        pos += 1
    return val, pos


def _ascii(data: bytes, pos: int, n: int, bit: bool) -> np.ndarray:
    """The first `n` ASCII samples from `pos`, as `ReadNumber` reads them
    one after another: any gap that is not white space or a comment, or
    data that ends first, raises."""
    found = (_BIT if bit else _NUMBER).findall(data, pos)[:n]
    if len(found) < n:
        raise ValueError(f'PNM: {len(found)} ASCII samples of {n}')
    if b''.join(b''.join(f) for f in found) != \
            data[pos:pos + sum(len(b''.join(f)) for f in found)]:
        raise ValueError('PNM: a byte that is neither a digit, white space '
                         'nor a comment among the ASCII samples')
    digits = np.array([f[1] for f in found])
    if digits.dtype.itemsize > 10:
        raise ValueError('PNM: an ASCII sample above 2^31 - 1')
    vals = digits.astype(np.int64)
    if vals.size and vals.max() > INT_MAX:
        raise ValueError('PNM: an ASCII sample above 2^31 - 1')
    return vals


def imdecode(data: bytes, flag: str = 'color') -> np.ndarray:
    """Decode a PBM / PGM / PPM byte string (see the module docstring)."""
    if not matches(data):
        raise ValueError('not a PNM (P1-P6) payload')
    kind = data[1] - 0x30
    ch = 3 if kind in (3, 6) else 1
    pbm = kind in (1, 4)
    width, pos = _read_number(data, 2)
    height, pos = _read_number(data, pos)
    maxval = 1
    if not pbm:
        maxval, pos = _read_number(data, pos)
    if maxval > 65535:
        raise ValueError(f'PNM: maxval {maxval} above 65535')
    if maxval <= 0:
        raise ValueError(f'PNM: maxval {maxval}')
    cvt.check_size('PNM', width, height)
    wide = maxval > 255
    n = height * width * ch
    if kind >= 4:                                          # raw
        pitch = (width + 7) // 8 if pbm else width * ch * (2 if wide else 1)
        raw = np.frombuffer(data, np.uint8, height * pitch, pos) \
            if len(data) - pos >= height * pitch else None
        if raw is None:
            raise ValueError(f'PNM: {len(data) - pos} bytes of samples, '
                             f'{height * pitch} needed')
        if pbm:
            bits = np.unpackbits(raw.reshape(height, pitch), 1)[:, :width]
            px = np.where(bits == 1, 0, 255).astype(np.uint8)
        elif wide:
            px = raw.view('>u2').astype(np.uint16)
        else:
            px = raw.copy()
    else:                                                  # ASCII
        vals = _ascii(data, pos, n, pbm)
        if pbm:
            px = np.where(vals != 0, 0, 255).astype(np.uint8)
        else:
            vals = np.minimum(vals, maxval)
            px = (vals.astype(np.uint16) if wide
                  else (vals * 255 // maxval).astype(np.uint8))
    px = px.reshape(height, width, ch)
    if flag == 'unchanged':
        return px[..., 0].copy() if ch == 1 else px[..., ::-1].copy()
    px = cvt.high_byte(px)
    if flag == 'grayscale':
        return px[..., 0].copy() if ch == 1 else cvt.bgr_to_grey(px, rgb=True)
    return cvt.grey_to_bgr(px[..., 0]) if ch == 1 else px[..., ::-1].copy()
