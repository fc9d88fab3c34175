"""Sun raster decoding in numpy, as `cv2` 5.0's `SunRasterDecoder`
(`imgcodecs/src/grfmt_sunras.cpp`) reads it.

A big-endian header of eight words (magic `59 a6 6a 95`, width, height,
depth, length, type, map type, map length), the colour map, then rows
padded to 16 bits. Depths 1, 8, 24 and 32; colour maps none or
`RMT_EQUAL_RGB` (the map's bytes as all reds, all greens, all blues,
`maplength // 3` entries, at most 2^depth; entries past them black).
`cv2` 5.0 reads `RT_OLD` and `RT_STANDARD` only: it refuses
`RT_BYTE_ENCODED` (run-length) and `RT_FORMAT_RGB` at every depth, width
and map tried, so this reader refuses them too, naming the type.

What `cv2.imdecode` returns, and so `imdecode(data, flag)`:
  * 24 bits: B, G, R bytes; 32 bits: the last three bytes of each pixel
    as B, G, R (the first dropped); grey through `cvt.bgr_to_grey`.
  * 1 and 8 bits with a colour map: its entries (BGR), or [H, W] grey in
    'unchanged' when every entry is grey; grey reads through
    `cvt.bgr_to_grey` of each entry.
  * 1 and 8 bits without a map: 'color' reads 8 bits as grey and 1 bit
    as 0 / 255 (1 = white), but 'unchanged' and 'grayscale' read every
    pixel as 0: `cv2` converts them through a grey table it never fills.

A header `cv2` refuses, or data that ends early (a row's padding
included), raises `ValueError`.
"""

from __future__ import annotations

import struct

import numpy as np

from hrfuser_tpu_torch.data import cvt

MAGIC = b'\x59\xa6\x6a\x95'
TYPES = {0: 'RT_OLD', 1: 'RT_STANDARD', 2: 'RT_BYTE_ENCODED',
         3: 'RT_FORMAT_RGB', 4: 'RT_FORMAT_TIFF', 5: 'RT_FORMAT_IFF'}


def matches(data: bytes) -> bool:
    """`SunRasterDecoder`'s signature: the magic number."""
    return data[:4] == MAGIC


def imdecode(data: bytes, flag: str = 'color') -> np.ndarray:
    """Decode a Sun raster byte string (see the module docstring)."""
    if not matches(data):
        raise ValueError('not a Sun raster payload')
    if len(data) < 32:
        raise ValueError('Sun raster: the file ends inside its header')
    w, h, depth, _, kind, maptype, maplen = struct.unpack_from('>7i', data,
                                                               4)
    if w <= 0 or h <= 0 or depth not in (1, 8, 24, 32):
        raise ValueError(f'Sun raster: {w}x{h}, depth {depth}')
    cvt.check_size('Sun raster', w, h)
    if kind not in (0, 1):
        raise ValueError(f'Sun raster: type {kind} '
                         f'({TYPES.get(kind, "unknown")}): cv2 reads '
                         f'RT_OLD and RT_STANDARD only')
    if not ((maptype == 0 and maplen == 0)
            or (maptype == 1 and 0 < maplen <= 3 << depth and depth <= 8)):
        raise ValueError(f'Sun raster: map type {maptype}, map length '
                         f'{maplen}, depth {depth}')
    palette = np.zeros((256, 3), np.uint8)                  # B, G, R
    if maplen:
        if 32 + maplen > len(data):
            raise ValueError('Sun raster: the file ends inside its colour '
                             'map')
        n = maplen // 3
        cmap = np.frombuffer(data, np.uint8, 3 * n, 32).reshape(3, n)
        palette[:n] = cmap[::-1].T
        colour = bool((palette[:1 << depth]
                       != palette[:1 << depth, :1]).any())
    else:
        colour = depth > 8
    pitch = ((w * depth + 7) // 8 + 1) & -2
    pos = 32 + maplen
    if pos + h * pitch > len(data):
        raise ValueError(f'Sun raster: {len(data) - pos} bytes of pixels, '
                         f'{h * pitch} needed')
    rows = np.frombuffer(data, np.uint8, h * pitch, pos).reshape(h, pitch)
    target = ((3 if colour else 1) if flag == 'unchanged' else
              3 if flag == 'color' else 1)
    if depth > 8:
        bgr = rows[:, :w * depth // 8].reshape(h, w, depth // 8)[..., -3:]
        return (np.ascontiguousarray(bgr) if target == 3
                else cvt.bgr_to_grey(bgr))
    idx = (rows[:, :w] if depth == 8 else np.unpackbits(rows, 1)[:, :w])
    if target == 1:
        if not maplen:
            return np.zeros((h, w), np.uint8)
        grey = np.zeros(256, np.uint8)
        grey[:1 << depth] = cvt.bgr_to_grey(palette[:1 << depth])
        return grey[idx]
    if not maplen:
        grey = idx if depth == 8 else idx * np.uint8(255)
        return cvt.grey_to_bgr(grey.astype(np.uint8))
    return palette[idx]
