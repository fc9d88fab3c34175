"""PNG decoding and encoding in numpy and `zlib`, in place of
`cv2.imdecode` / `cv2.imwrite`.

The card's machine has no `cv2`, PIL or `torchvision`, so the server
decodes its PNG payloads here and the offline converters write their
sensor images with `imwrite`. Supported: bit depths 8 and 16, colour
types 0 (grey), 2 (RGB) and 6 (RGBA, alpha dropped), non-interlaced, the
five scanline filters. Anything else (palette or interlaced PNG, or not
a PNG at all) raises `ValueError`.

`imdecode(data)` returns what `cv2.imdecode(buf, cv2.IMREAD_COLOR)` does
for these files: uint8 BGR [H, W, 3] (16-bit samples keep their high
byte, grey is repeated into three channels). `unchanged=True` returns
what `cv2.IMREAD_UNCHANGED` does, alpha dropped: the file's depth (uint8
or uint16), [H, W] for grey, BGR [H, W, 3] otherwise. `grayscale=True`
returns what `cv2.IMREAD_GRAYSCALE` does for a grey file: uint8 [H, W]
(16-bit samples keep their high byte). A colour file raises there: cv2
converts it to grey with libpng's fixed-point weights, which this
decoder does not reproduce bit for bit.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b'\x89PNG\r\n\x1a\n'
_CHANNELS = {0: 1, 2: 3, 6: 4}


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


def imdecode(data: bytes, unchanged: bool = False,
             grayscale: bool = False) -> np.ndarray:
    """Decode a PNG byte string (see the module docstring)."""
    if data[:8] != SIGNATURE:
        raise ValueError('not a PNG payload')
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b'IHDR' and len(body) == 13:
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'IDAT':
            idat.append(body)
        elif kind == b'IEND':
            break
    if header is None or not idat:
        raise ValueError('PNG without IHDR or IDAT')
    w, h, depth, color, _, _, interlace = header
    if depth not in (8, 16) or color not in _CHANNELS:
        raise ValueError(f'PNG bit depth {depth}, colour type {color}: '
                         f'only depths 8/16 and grey, RGB, RGBA decode')
    if interlace:
        raise ValueError('interlaced PNG is not supported')
    if grayscale and color != 0:
        raise ValueError('a colour PNG read as grey: only grey PNGs decode '
                         'in grayscale mode')
    ch, nbytes = _CHANNELS[color], depth // 8
    bpp = ch * nbytes
    size = h * (1 + w * bpp)
    try:                              # no more than the header promises
        raw = zlib.decompressobj().decompress(b''.join(idat), size + 1)
    except zlib.error as e:
        raise ValueError(f'corrupt PNG image data: {e}') from e
    raw = np.frombuffer(raw, np.uint8)
    if raw.size != size:
        raise ValueError('PNG image data does not match its header')
    px = _unfilter(raw.reshape(h, 1 + w * bpp), h, w, bpp)
    if nbytes == 2:
        img = px.reshape(h, w, ch, 2).view('>u2')[..., 0]
        img = img.astype(np.uint16) if unchanged else (img >> 8).astype(
            np.uint8)
    else:
        img = px.reshape(h, w, ch)
    img = img[..., :3]                                   # alpha dropped
    if ch == 1:
        return (img[..., 0].copy() if unchanged or grayscale
                else np.repeat(img, 3, -1))
    return np.ascontiguousarray(img[..., ::-1])          # RGB -> BGR


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
