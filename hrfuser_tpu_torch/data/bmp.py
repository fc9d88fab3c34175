"""BMP / DIB decoding in numpy, as `cv2` 5.0's `BmpDecoder`
(`imgcodecs/src/grfmt_bmp.cpp`) reads it.

Headers: `BITMAPCOREHEADER` (OS/2 v1, 12 bytes) and every header of 36
bytes or more (`BITMAPINFOHEADER` through v5). Depths 1, 4 and 8 with a
palette (`biClrUsed` entries, all 2^bpp when 0; entries past them black),
16 (555, or 565 through `BI_BITFIELDS`), 24 and 32; `BI_RLE4` (4 bits)
and `BI_RLE8` (8 bits). Rows are bottom-up, or top-down for a negative
height; raw rows are padded to 4 bytes. What `cv2` does, and so this:

  * A palette whose entries are all grey makes the image grey: 'unchanged'
    reads it [H, W]. So does every OS/2 v1 file, whatever its depth
    (`cv2` never marks one colour). Otherwise 'unchanged' gives BGR, or
    BGRA for a 32-bit `BI_BITFIELDS` file; a 32-bit `BI_RGB` file drops
    its fourth byte.
  * 16-bit samples widen as `v << 3` (565's green `v << 2`), not
    rescaled. 16-bit `BI_BITFIELDS` reads its three masks right after
    the header (also behind a v4 / v5 header, where they are the pixel
    data or the palette) and takes 555 or 565 only.
  * 32-bit `BI_BITFIELDS` with a header of 56 bytes or more whose red,
    green and blue masks are all non-zero: each channel is
    `((v & mask) >> shift) * 255 / (mask >> shift)` (in float32,
    `_masked`), alpha 255 without
    an alpha mask, and grey through `cvt.bgr_to_grey_float`. Any other
    32-bit file is B, G, R, A bytes, grey through `cvt.bgr_to_grey`.
  * RLE8: a run that ends a row moves to the next one, an end of line
    right after that is skipped, and end-of-line, delta and
    end-of-bitmap fill the pixels they pass over with palette entry 0
    (a delta (dx, dy) passes over dx + dy W pixels in raster order).
    RLE4 as `cv2` reads it: a run never leaves its row (one that would
    is refused), end of line and end of bitmap both fill to the row's
    end and go on reading, a delta skips dx pixels (its dy is read and
    ignored), and the image ends when its last row is passed.
  * Grey reads of a palette go through `cvt.bgr_to_grey` of each entry.

`imdecode(data, flag)` returns what `cv2.imdecode` does in 'color',
'unchanged' and 'grayscale'; a header `cv2` refuses, a run that leaves
its row, or data that ends early raise `ValueError`. Every step is a
whole-array pass, the run-length codes too (`_codes`, `_rle`).
"""

from __future__ import annotations

import struct
import numpy as np

from hrfuser_tpu_torch.data import cvt

_RGB, _RLE8, _RLE4, _BITFIELDS = 0, 1, 2, 3
_MASKS_555 = (0x7c00, 0x3e0, 0x1f)
_MASKS_565 = (0xf800, 0x7e0, 0x1f)


def matches(data: bytes) -> bool:
    """`BmpDecoder`'s signature: `BM`."""
    return data[:2] == b'BM'


def _u32(data: bytes, pos: int, fmt: str = '<I') -> int:
    if pos + struct.calcsize(fmt) > len(data):
        raise ValueError('BMP: the file ends inside its header')
    return struct.unpack_from(fmt, data, pos)[0]


class _Header:
    """The fields `BmpDecoder::readHeader` keeps."""

    def __init__(self, data: bytes):
        self.offset = _u32(data, 10, '<i')
        size = _u32(data, 14, '<i')
        if size <= 0:
            raise ValueError(f'BMP: header size {size}')
        self.masks32 = None
        self.colour = False
        palette = np.zeros((256, 3), np.uint8)          # B, G, R
        if size >= 36:
            w, h, bpp = (_u32(data, 18, '<i'), _u32(data, 22, '<i'),
                         _u32(data, 26) >> 16)
            comp = _u32(data, 30, '<i')
            clr_used = _u32(data, 46, '<i')
            if not 0 <= comp <= _BITFIELDS:
                raise ValueError(f'BMP: compression {comp} (JPEG, PNG or '
                                 f'alpha bit fields): not read')
            ok = w > 0 and h != 0 and (
                (bpp in (1, 4, 8, 24, 32) and comp == _RGB)
                or (bpp in (16, 32) and comp in (_RGB, _BITFIELDS))
                or (bpp == 4 and comp == _RLE4)
                or (bpp == 8 and comp == _RLE8))
            if not ok:
                raise ValueError(f'BMP: {bpp} bits, compression {comp}, '
                                 f'{w}x{h}: not a combination cv2 reads')
            pos = 14 + size
            self.colour = True
            if bpp <= 8:
                if not 0 <= clr_used <= 256:
                    raise ValueError(f'BMP: {clr_used} palette entries')
                n = clr_used or 1 << bpp
                if pos + 4 * n > len(data):
                    raise ValueError('BMP: the file ends inside its '
                                     'palette')
                palette[:n] = np.frombuffer(data, np.uint8, 4 * n,
                                            pos).reshape(n, 4)[:, :3]
                self.colour = bool((palette[:1 << bpp]
                                    != palette[:1 << bpp, :1]).any())
            elif bpp == 16 and comp == _BITFIELDS:
                masks = tuple(_u32(data, pos + 4 * i) for i in range(3))
                if masks == _MASKS_555:
                    bpp = 15
                elif masks != _MASKS_565:
                    raise ValueError(f'BMP: 16-bit masks '
                                     f'{[hex(m) for m in masks]}: cv2 reads '
                                     f'555 and 565 only')
            elif bpp == 32 and comp == _BITFIELDS and size >= 56:
                masks = tuple(_u32(data, 54 + 4 * i) for i in range(4))
                if all(masks[:3]):
                    self.masks32 = masks
            elif bpp == 16:
                bpp = 15
        elif size == 12:
            w, h = _u32(data, 18, '<H'), _u32(data, 20, '<H')
            bpp = _u32(data, 22) >> 16
            comp = _RGB
            if not (w > 0 and h != 0 and bpp in (1, 4, 8, 24, 32)):
                raise ValueError(f'BMP: OS/2 header, {bpp} bits, {w}x{h}')
            if bpp <= 8:
                n = 1 << bpp
                if 26 + 3 * n > len(data):
                    raise ValueError('BMP: the file ends inside its '
                                     'palette')
                palette[:n] = np.frombuffer(data, np.uint8, 3 * n,
                                            26).reshape(n, 3)
        else:
            raise ValueError(f'BMP: header size {size}: cv2 reads 12 or 36 '
                             f'and more')
        if self.offset < 0:
            raise ValueError(f'BMP: pixel data offset {self.offset}')
        cvt.check_size('BMP', w, abs(h))
        self.width, self.height, self.bpp, self.comp = w, abs(h), bpp, comp
        self.bottom_up = h > 0
        self.palette = palette
        # the channels 'unchanged' gives
        self.channels = (1 if not self.colour else
                         4 if bpp == 32 and comp != _RGB else 3)


def _spans(starts, counts) -> np.ndarray:
    """Positions covered by spans (start, count), in order."""
    counts = np.asarray(counts, np.int64)
    first = np.asarray(starts, np.int64) - np.cumsum(counts) + counts
    return np.repeat(first, counts) + np.arange(int(counts.sum()))


_EOL, _EOB, _DELTA, _ABS, _RUN = 0, 1, 2, 3, 4


def _codes(pairs: np.ndarray, four: bool) -> np.ndarray:
    """The byte pairs that start an RLE code. Every code is a whole
    number of pairs: a run, end of line or end of bitmap one, a delta
    two, an absolute block one and its padded bytes. So the codes are the
    pairs no absolute block or delta covers. Pairs `0, >= 2` look like
    those two; each one's successor among them is the first after its
    bytes, and the ones the codes reach are found by pointer doubling
    from the first."""
    n = len(pairs)
    where = np.flatnonzero((pairs[:, 0] == 0) & (pairs[:, 1] >= 2))
    code = pairs[where, 1].astype(np.int64)
    span = np.where(code == 2, 2, 1 + ((((code + 1) >> 1) + 1) & ~1) // 2
                    if four else 1 + ((code + 1) & ~1) // 2)
    # the k-th look-alike's successor, as an index into `where` (m: none)
    m = len(where)
    succ = np.append(np.searchsorted(where, where + span), m)
    reached = np.zeros(m + 1, bool)
    reached[0] = True
    while True:
        grown = reached.copy()
        grown[succ[reached]] = True
        if (grown == reached).all():
            break
        reached, succ = grown, succ[succ]
    chain = where[reached[:m]]
    keep = np.ones(n, bool)
    lengths = span[reached[:m]]
    at = _spans(chain + 1, lengths - 1)
    keep[at[at < n]] = False
    if chain.size and chain[-1] + lengths[-1] > n:
        keep[chain[-1]] = False            # its bytes run past the data
    return np.flatnonzero(keep)


def _rle(data: bytes, hd: _Header) -> np.ndarray:
    """Palette indices [H, W] (file row order) of an RLE4 / RLE8 image;
    pixels an escape passes over keep index 0. The codes and their
    positions are found in whole-array passes (`_codes`, then each
    position as the sum of the codes before it: an end of line moves to
    a row start that depends only on its own row's codes)."""
    w, h, four = hd.width, hd.height, hd.bpp == 4
    total = w * h
    buf = np.frombuffer(data, np.uint8)[hd.offset:]
    pairs = buf[:len(buf) // 2 * 2].reshape(-1, 2)
    at = _codes(pairs, four)
    b0 = pairs[at, 0].astype(np.int64)
    b1 = pairs[at, 1].astype(np.int64)
    kind = np.where(b0 > 0, _RUN, np.minimum(b1, _ABS))
    nxt = np.minimum(at + 1, len(pairs) - 1)
    skip = np.where(kind == _DELTA, pairs[nxt, 0].astype(np.int64)
                    + (0 if four else pairs[nxt, 1].astype(np.int64) * w),
                    0)
    if len(at) and kind[-1] == _DELTA and at[-1] + 1 >= len(pairs):
        kind, at, b0, b1, skip = (v[:-1] for v in (kind, at, b0, b1, skip))
    pixels = np.where(kind == _RUN, b0, np.where(kind == _ABS, b1, 0))
    eol = (kind == _EOL) | ((kind == _EOB) & four)
    after_px = np.concatenate([[False], (kind == _RUN) | (kind == _ABS)])
    inc = pixels + skip
    sums = np.concatenate([[0], np.cumsum(inc)])
    ends = np.flatnonzero(eol)
    starts = np.concatenate([[0], ends + 1])[:len(ends)]
    row = sums[ends] - sums[starts]         # the row's codes before it
    # `FillUniColor` to the row's end: from a row start, a whole row,
    # unless the code before ended its row (a run or absolute block)
    inc[ends] = w * ((row - 1 + np.where(after_px[ends], 0, 1)) // w + 1) \
        - row
    pos = np.concatenate([[0], np.cumsum(inc)])
    done = pos[1:] >= total
    stop = np.flatnonzero(((kind == _EOB) & (not four)) | (done & (
        (kind != _ABS) & ((kind != _RUN) | (not four)))))
    if not stop.size:
        raise ValueError('BMP: the RLE data ends before the image')
    k = int(stop[0]) + 1
    kind, at, pixels, b0, pos = kind[:k], at[:k], pixels[:k], b0[:k], pos[:k]
    x = pos % w
    filled = (kind == _RUN) | (kind == _ABS)
    prev = np.concatenate([[-1], kind[:-1]])
    pending = (x == 0) & ((prev == _ABS) | ((prev == _RUN) & four))
    bad = filled & (pending | (x + pixels > w))
    if bad.any():
        i = int(np.argmax(bad))
        raise ValueError(f'BMP: an RLE code of {int(pixels[i])} pixels at '
                         f'x = {w if pending[i] else int(x[i])} leaves its '
                         f'{w}-pixel row')
    size = np.where(kind == _ABS, (((pixels + 1) >> 1) + 1) & ~1 if four
                    else (pixels + 1) & ~1, 0)
    if ((kind == _ABS) & (2 * at + 2 + size > len(buf))).any():
        raise ValueError('BMP: the RLE data ends before the image')
    idx = np.zeros(total, np.uint8)
    for sel, literal in ((kind == _RUN, False), (kind == _ABS, True)):
        if not sel.any():
            continue
        start, count = pos[sel], pixels[sel]
        dst = _spans(start, count)
        k = dst - np.repeat(start, count)            # pixel within code
        if literal:
            src = np.repeat(2 * at[sel] + 2, count)
            val = buf[src + (k >> 1 if four else k)]
        else:
            val = np.repeat(pairs[at[sel], 1], count)
        if four:                      # high nibble first, then alternate
            val = np.where(k & 1 == 1, val & 15, val >> 4)
        idx[dst] = val
    return idx.reshape(h, w)


def _raw(data: bytes, hd: _Header) -> np.ndarray:
    """The pixel rows [H, row bytes] (file row order)."""
    bits = 16 if hd.bpp == 15 else hd.bpp
    pitch = ((hd.width * bits + 7) // 8 + 3) & -4
    if hd.offset + hd.height * pitch > len(data):
        raise ValueError(f'BMP: {max(0, len(data) - hd.offset)} bytes of '
                         f'pixels, {hd.height * pitch} needed')
    return np.frombuffer(data, np.uint8, hd.height * pitch,
                         hd.offset).reshape(hd.height, pitch)


def _indices(rows: np.ndarray, bpp: int, w: int) -> np.ndarray:
    if bpp == 8:
        return rows[:, :w]
    if bpp == 4:
        return np.stack([rows >> 4, rows & 15], 2).reshape(len(rows),
                                                           -1)[:, :w]
    return np.unpackbits(rows, 1)[:, :w]


def _masked(v: np.ndarray, mask: int) -> np.ndarray:
    """A 32-bit bit field scaled to 8 bits as `cv2` scales it: in float32,
    `float(field) * (255 / float(mask >> shift))`, truncated."""
    shift = (mask & -mask).bit_length() - 1
    field = ((v & np.uint32(mask)) >> np.uint32(shift)).astype(np.float32)
    return (field * (np.float32(255) / np.float32(mask >> shift))).astype(
        np.uint8)


def imdecode(data: bytes, flag: str = 'color') -> np.ndarray:
    """Decode a BMP byte string (see the module docstring)."""
    if not matches(data):
        raise ValueError('not a BMP payload')
    hd = _Header(data)
    w, h, bpp = hd.width, hd.height, hd.bpp
    target = (hd.channels if flag == 'unchanged' else
              3 if flag == 'color' else 1)
    if bpp <= 8:
        idx = (_rle(data, hd) if hd.comp in (_RLE4, _RLE8)
               else _indices(_raw(data, hd), bpp, w))
        if target == 1:
            grey = np.zeros(256, np.uint8)
            grey[:1 << bpp] = cvt.bgr_to_grey(hd.palette[:1 << bpp])
            out = grey[idx]
        else:
            out = hd.palette[idx]
    else:
        rows = _raw(data, hd)
        if bpp in (15, 16):
            v = rows[:, :2 * w].copy().view('<u2').astype(np.int32)
            bgr = np.stack([(v << 3) & 0xf8,
                            ((v >> 2) if bpp == 15 else (v >> 3))
                            & (0xf8 if bpp == 15 else 0xfc),
                            (v >> (7 if bpp == 15 else 8)) & 0xf8],
                           -1).astype(np.uint8)
            out = cvt.bgr_to_grey(bgr) if target == 1 else bgr
        elif bpp == 24:
            bgr = rows[:, :3 * w].reshape(h, w, 3)
            out = cvt.bgr_to_grey(bgr) if target == 1 else bgr
        elif hd.masks32 is not None:
            v = rows[:, :4 * w].copy().view('<u4')
            bgra = np.stack([_masked(v, m) if m else
                             np.full(v.shape, 255, np.uint8)
                             for m in (hd.masks32[2], hd.masks32[1],
                                       hd.masks32[0], hd.masks32[3])], -1)
            out = (cvt.bgr_to_grey_float(bgra[..., :3]) if target == 1
                   else bgra if target == 4 else bgra[..., :3])
        else:
            bgra = rows[:, :4 * w].reshape(h, w, 4)
            out = (cvt.bgr_to_grey(bgra[..., :3]) if target == 1
                   else bgra if target == 4 else bgra[..., :3])
    if hd.bottom_up:
        out = out[::-1]
    return np.ascontiguousarray(out)
