"""Radiance HDR (RGBE) decoding in numpy, as `cv2` 5.0's `HdrDecoder`
(`imgcodecs/src/grfmt_hdr.cpp`, `rgbe.cpp`) reads it.

The header starts `#?RADIANCE` or `#?RGBE`. Its lines are read as C's
`fgets` reads them into 128 bytes (a line of 127 bytes or more is cut
into pieces) up to the first empty one; a line
`FORMAT=32-bit_rle_rgbe` must come before it. The next line gives the
size, `-Y <height> +X <width>` (the one orientation `cv2` reads).

Scanlines are flat RGBE pixels or new-style run-length ones (`2 2` and
the width, then each of the four channels in runs: a byte above 128 a
run of (byte - 128) copies of the next, else that many literal bytes).
As `rgbe.cpp` reads them: scanlines narrower than 8 or wider than 32767
are all flat, and the first scanline that does not start with the
run-length mark makes it and every scanline after it flat. Old-style run
codes (`1 1 1 n`) are read as the pixels they look like, as `cv2` does.

Pixels: `m * 2^(e - 136)` for mantissa m and exponent e (0 for e = 0;
no `+ 0.5`), as float32, file R, G, B -> B, G, R. `imdecode(data,
flag)` returns what `cv2.imdecode` does: 'unchanged' float32 [H, W, 3];
'color' uint8, `cvt.float_to_u8(v * 255)` (saturated); 'grayscale' that
uint8 image through `cvt.bgr_to_grey_cvtcolor`. A header `cv2` refuses,
a bad run or data that ends early raises `ValueError`. Runs are parsed
one at a time, each copied as one byte string; the rest is whole-array.
"""

from __future__ import annotations

import re
from typing import List, Tuple

import numpy as np

from hrfuser_tpu_torch.data import cvt

SIGNATURES = (b'#?RGBE', b'#?RADIANCE')
_FORMAT = b'FORMAT=32-bit_rle_rgbe\n'
_SIZE = re.compile(rb'-Y[ \t\n\v\f\r]*([+-]?[0-9]+)[ \t\n\v\f\r]*\+X'
                   rb'[ \t\n\v\f\r]*([+-]?[0-9]+)')


def matches(data: bytes) -> bool:
    """`HdrDecoder::checkSignature`."""
    return data.startswith(SIGNATURES)


def _line(data: bytes, pos: int) -> Tuple[bytes, int]:
    """`fgets(buf, 128, fp)`: up to and including a newline, at most 127
    bytes; as a C string (up to its first NUL)."""
    if pos >= len(data):
        raise ValueError('HDR: the file ends inside its header')
    end = data.find(b'\n', pos, pos + 127)
    end = min(pos + 127, len(data)) if end < 0 else end + 1
    return data[pos:end].split(b'\0', 1)[0], end


def _header(data: bytes) -> Tuple[int, int, int]:
    """(height, width, offset of the pixels)."""
    line, pos = _line(data, 0)
    seen = False
    while line[:1] not in (b'', b'\n'):
        seen = seen or line == _FORMAT
        line, pos = _line(data, pos)
    if not seen:
        raise ValueError('HDR: no FORMAT=32-bit_rle_rgbe line before the '
                         'blank line')
    line, pos = _line(data, pos)
    m = _SIZE.match(line)
    if m is None:
        raise ValueError(f'HDR: size line {line[:40]!r}: cv2 reads '
                         f'"-Y <height> +X <width>" only')
    h, w = int(m.group(1)), int(m.group(2))
    cvt.check_size('HDR', w, h)
    return h, w, pos


def _rle_scanline(data: bytes, pos: int, w: int, out: List[bytes]) -> int:
    """One new-style run-length scanline after its 4-byte mark: its
    bytes appended to `out` a run at a time, channel after channel; the
    position after it."""
    n = len(data)
    for _ in range(4):
        x = 0
        while x < w:
            if pos + 2 > n:
                raise ValueError('HDR: the file ends inside a scanline')
            count = data[pos]
            if count > 128:
                count -= 128
                if count > w - x:
                    raise ValueError('HDR: a run leaves its scanline')
                out.append(data[pos + 1:pos + 2] * count)
                pos += 2
            else:
                if count == 0 or count > w - x:
                    raise ValueError('HDR: bad literal count in a scanline')
                if pos + 1 + count > n:
                    raise ValueError('HDR: the file ends inside a scanline')
                out.append(data[pos + 1:pos + 1 + count])
                pos += 1 + count
            x += count
    return pos


def rgbe(data: bytes) -> np.ndarray:
    """The file's RGBE bytes, uint8 [H, W, 4] (R, G, B, E)."""
    if not matches(data):
        raise ValueError('not a Radiance HDR payload')
    h, w, pos = _header(data)
    runs: List[bytes] = []
    y = 0
    if 8 <= w <= 0x7fff:
        while y < h:
            if pos + 4 > len(data):
                raise ValueError('HDR: the file ends before its last '
                                 'scanline')
            mark = data[pos:pos + 4]
            if mark[0] != 2 or mark[1] != 2 or mark[2] & 0x80:
                break                           # flat from here to the end
            if (mark[2] << 8 | mark[3]) != w:
                raise ValueError('HDR: wrong scanline width')
            pos = _rle_scanline(data, pos + 4, w, runs)
            y += 1
    out = np.empty((h, 4, w), np.uint8)
    out[:y] = np.frombuffer(b''.join(runs), np.uint8).reshape(y, 4, w)
    out = out.transpose(0, 2, 1)
    if y < h:
        n = (h - y) * w * 4
        if pos + n > len(data):
            raise ValueError(f'HDR: {len(data) - pos} bytes of flat pixels, '
                             f'{n} needed')
        out[y:] = np.frombuffer(data, np.uint8, n, pos).reshape(h - y, w, 4)
    return out


def imdecode(data: bytes, flag: str = 'color') -> np.ndarray:
    """Decode a Radiance HDR byte string (see the module docstring)."""
    px = rgbe(data)
    e = px[..., 3:].astype(np.int32)
    m = px[..., 2::-1].astype(np.float32)
    img = np.where(e > 0, np.ldexp(m, e - 136), np.float32(0)).astype(
        np.float32)
    if flag == 'unchanged':
        return img
    with np.errstate(over='ignore'):
        bgr = cvt.float_to_u8(img * np.float32(255))
    return cvt.bgr_to_grey_cvtcolor(bgr) if flag == 'grayscale' else bgr
