"""PNG decoding and encoding in numpy and `zlib`, in place of
`cv2.imdecode` / `cv2.imwrite`.

The card's machine has no `cv2`, PIL or `torchvision`, so the server
decodes its PNG payloads here and the offline converters write their
sensor images with `imwrite`. Every PNG decodes: colour types 0 (grey),
2 (RGB), 3 (palette, with tRNS), 4 (grey + alpha) and 6 (RGBA), at
every bit depth the type allows (1, 2, 4, 8, 16), plain or Adam7
interlaced, through the five scanline filters. A file that is not a PNG,
or whose header is not a valid one, raises `ValueError`.

`imdecode(data)` returns what `cv2.imdecode(buf, cv2.IMREAD_COLOR)` does
(libpng's transforms as cv2 asks for them): uint8 BGR [H, W, 3], 16-bit
samples keeping their high byte, grey of depth 1-4 scaled to 8 bits and
repeated into three channels, palettes expanded, alpha dropped.
`unchanged=True` returns what `cv2.IMREAD_UNCHANGED` does: the file's
depth (uint8, or uint16 for 16-bit files), [H, W] for grey, BGR
[H, W, 3], or BGRA [H, W, 4] for a file with alpha (grey + alpha as
grey repeated, RGB and palette files with tRNS as alpha from it).
`grayscale=True` returns what `cv2.IMREAD_GRAYSCALE` does: uint8
[H, W], a colour file through libpng's `png_set_rgb_to_gray` at cv2's
weights (0.299, 0.587: 9797 / 19234 / 3737 of 32768), truncated for
8-bit samples and rounded for 16-bit ones.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b'\x89PNG\r\n\x1a\n'


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError('truncated PNG chunk')
        yield kind, body
        pos += 12 + n


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters: [H, 1 + W * bpp] -> [H, W, bpp].

    Rows filtered with None, Sub or Up decode a whole row at a time. The
    Average and Paeth filters depend on the pixel to the left, so
    stretches of such rows decode by anti-diagonals (a pixel needs its
    left, upper and upper-left neighbours, all on earlier diagonals).
    """
    kinds = raw[:, 0]
    if kinds.max(initial=0) > 4:
        raise ValueError(f'unknown PNG filter {int(kinds.max())}')
    px = raw[:, 1:].reshape(h, w, bpp)
    # one zero row above and one zero pixel to the left of the image
    out = np.zeros((h + 1, w + 1, bpp), np.uint8)
    r = 0
    while r < h:
        k = kinds[r]
        if k <= 2:
            row = px[r]
            if k == 1:
                row = np.cumsum(row, axis=0, dtype=np.uint8)
            elif k == 2:
                row = row + out[r, 1:]
            out[r + 1, 1:] = row
            r += 1
            continue
        end = r
        while end < h and kinds[end] >= 3:
            end += 1
        _unfilter_block(px, kinds, out, r, end, w)
        r = end
    return out[1:, 1:]


def _unfilter_block(px, kinds, out, r0, r1, w):
    """Average / Paeth rows [r0, r1) by anti-diagonals of the block."""
    # the decoded row above the block, then the block's rows
    buf = out[r0:r1 + 1].astype(np.int16)
    flat = buf.reshape(-1, buf.shape[-1])
    stride = w + 1
    src = px[r0:r1].astype(np.int16)
    avg = kinds[r0:r1] == 3
    for d in range(r1 - r0 + w - 1):
        lo, hi = max(0, d - w + 1), min(r1 - r0, d + 1)
        rows = np.arange(lo, hi)
        cols = d - rows
        idx = (rows + 1) * stride + cols + 1
        a = flat[idx - 1]                                # left
        b = flat[idx - stride]                           # up
        c = flat[idx - stride - 1]                       # up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = np.where(avg[rows, None], (a + b) >> 1, paeth)
        flat[idx] = (src[rows, cols] + pred) & 255
    out[r0 + 1:r1 + 1] = buf[1:]


# colour type: (channels, allowed bit depths)
_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
          4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7's passes: first column, first row, column step, row step
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# libpng's png_set_rgb_to_gray(png, 1, 0.299, 0.587), as cv2 calls it:
# red and green as (w * 32768) / 100000 truncated, blue the rest of 32768
_GREY_R, _GREY_G = 29900 * 32768 // 100000, 58700 * 32768 // 100000
_GREY_B = 32768 - _GREY_R - _GREY_G


def _passes(h: int, w: int, interlace: int):
    """(rows, cols, first row, first col, row step, col step) of each
    non-empty (sub)image the data holds, in order."""
    if not interlace:
        return [(h, w, 0, 0, 1, 1)]
    out = []
    for x0, y0, dx, dy in _ADAM7:
        rows, cols = -(-(h - y0) // dy), -(-(w - x0) // dx)
        if rows > 0 and cols > 0:
            out.append((rows, cols, y0, x0, dy, dx))
    return out


def _samples(rows: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """Unfiltered rows [H, row bytes] -> samples [H, W, ch], uint8 for
    depths up to 8 (values as stored), uint16 for 16."""
    h = rows.shape[0]
    if depth == 16:
        return rows.reshape(h, w, ch, 2).view('>u2')[..., 0].astype(
            np.uint16)
    if depth == 8:
        return rows.reshape(h, w, ch)
    per = 8 // depth
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :w, None].astype(np.uint8)


def _decode_samples(data: bytes):
    """A PNG's header fields and its samples [H, W, ch] (de-interlaced),
    with its PLTE and tRNS chunks."""
    if data[:8] != SIGNATURE:
        raise ValueError('not a PNG payload')
    header, idat, plte, trns = None, [], None, None
    for kind, body in _chunks(data):
        if kind == b'IHDR' and len(body) == 13:
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'PLTE':
            plte = body
        elif kind == b'tRNS':
            trns = body
        elif kind == b'IDAT':
            idat.append(body)
        elif kind == b'IEND':
            break
    if header is None or not idat:
        raise ValueError('PNG without IHDR or IDAT')
    w, h, depth, color, _, _, interlace = header
    if color not in _TYPES or depth not in _TYPES[color][1]:
        raise ValueError(f'PNG bit depth {depth}, colour type {color}: not '
                         f'a valid combination')
    if interlace > 1:
        raise ValueError(f'PNG interlace method {interlace}')
    if color == 3 and plte is None:
        raise ValueError('palette PNG without a PLTE chunk')
    ch = _TYPES[color][0]
    bits = ch * depth
    bpp = max(1, bits // 8)                        # the filters' unit
    parts = _passes(h, w, interlace)
    sizes = [rows * (1 + -(-cols * bits // 8)) for rows, cols, *_ in parts]
    try:                              # no more than the header promises
        raw = zlib.decompressobj().decompress(b''.join(idat), sum(sizes) + 1)
    except zlib.error as e:
        raise ValueError(f'corrupt PNG image data: {e}') from e
    raw = np.frombuffer(raw, np.uint8)
    if raw.size != sum(sizes):
        raise ValueError('PNG image data does not match its header')
    passes, start = [], 0
    for (rows, cols, *_), size in zip(parts, sizes):
        rb = size // rows - 1
        block = raw[start:start + size].reshape(rows, 1 + rb)
        start += size
        unf = _unfilter(block, rows, rb // bpp, bpp).reshape(rows, rb)
        passes.append(_samples(unf, cols, ch, depth))
    if not interlace:
        return depth, color, passes[0], plte, trns
    img = np.zeros((h, w, ch), passes[0].dtype)
    for (_, _, y0, x0, dy, dx), px in zip(parts, passes):
        img[y0::dy, x0::dx] = px
    return depth, color, img, plte, trns


def imdecode(data: bytes, unchanged: bool = False,
             grayscale: bool = False) -> np.ndarray:
    """Decode a PNG byte string (see the module docstring)."""
    depth, color, px, plte, trns = _decode_samples(data)
    if depth < 8 and color == 0:      # png_set_expand_gray_1_2_4_to_8
        px = px * np.uint8(255 // ((1 << depth) - 1))
    if color == 3:                    # png_set_palette_to_rgb
        table = np.zeros((256, 3), np.uint8)
        pal = np.frombuffer(plte[:768], np.uint8)
        table[:len(pal) // 3] = pal[:len(pal) // 3 * 3].reshape(-1, 3)
        alpha = np.full(256, 255, np.uint8)
        if trns:
            alpha[:min(len(trns), 256)] = np.frombuffer(trns[:256], np.uint8)
        idx = px[..., 0]
        px = np.concatenate([table[idx], alpha[idx][..., None]], -1) \
            if trns else table[idx]
    elif color == 2 and trns and len(trns) >= 6 and unchanged:
        key = np.frombuffer(trns[:6], '>u2').astype(px.dtype)  # tRNS_to_alpha
        top = np.iinfo(px.dtype).max
        alpha = np.where((px == key).all(-1), 0, top).astype(px.dtype)
        px = np.concatenate([px, alpha[..., None]], -1)
    elif color == 4:                  # grey + alpha: grey repeated, alpha
        px = px[..., [0, 0, 0, 1]]
    ch = px.shape[-1]
    if grayscale:
        if ch == 1:
            grey = px[..., 0]
            return (grey >> 8).astype(np.uint8) if depth == 16 else grey
        return _rgb_to_grey(px[..., :3], depth)
    if unchanged:
        if ch == 1:
            return px[..., 0].copy()
        if ch == 3:
            return np.ascontiguousarray(px[..., ::-1])      # RGB -> BGR
        return np.ascontiguousarray(px[..., [2, 1, 0, 3]])  # RGBA -> BGRA
    if depth == 16:
        px = (px >> 8).astype(np.uint8)
    if ch == 1:
        return np.repeat(px, 3, -1)
    return np.ascontiguousarray(px[..., 2::-1])         # alpha dropped


def _rgb_to_grey(rgb: np.ndarray, depth: int) -> np.ndarray:
    """libpng's `png_do_rgb_to_gray` without gamma, at cv2's weights:
    8-bit samples truncate (a grey pixel stays as it is), 16-bit ones
    round before their high byte is kept."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    mix = _GREY_R * r + _GREY_G * g + _GREY_B * b
    if depth == 16:
        return (((mix + 16384) >> 15) >> 8).astype(np.uint8)
    same = (r == g) & (r == b)
    return np.where(same, r, mix >> 15).astype(np.uint8)


def imencode(img: np.ndarray) -> bytes:
    """PNG bytes of a uint8 or uint16 image, grey [H, W] or BGR
    [H, W, 3], as `cv2.imencode('.png', img)` gives them up to the
    compression: the file holds RGB, so `imdecode(imencode(x),
    unchanged=True)` and `cv2.imdecode(..., IMREAD_UNCHANGED)` return
    `x`. Scanline filter 0, zlib level 1 (cv2's default)."""
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f'PNG encodes uint8 or uint16, not {img.dtype}')
    grey = img.ndim == 2
    if not grey and not (img.ndim == 3 and img.shape[2] == 3):
        raise ValueError(f'PNG encodes [H, W] or [H, W, 3], not '
                         f'{list(img.shape)}')
    h, w = img.shape[:2]
    depth = 16 if img.dtype == np.uint16 else 8
    rows = np.ascontiguousarray(img if grey else img[..., ::-1]).astype(
        '>u2' if depth == 16 else np.uint8).view(np.uint8).reshape(h, -1)
    data = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1).tobytes()

    def chunk(kind, body):
        return (struct.pack('>I', len(body)) + kind + body
                + struct.pack('>I', zlib.crc32(kind + body)))

    return (SIGNATURE
            + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, depth,
                                         0 if grey else 2, 0, 0, 0))
            + chunk(b'IDAT', zlib.compress(data, 1)) + chunk(b'IEND', b''))


def imwrite(path: str, img: np.ndarray) -> None:
    """Write `imencode(img)` to `path` (as `cv2.imwrite` of a PNG)."""
    with open(path, 'wb') as f:
        f.write(imencode(img))
