"""Writers of the small raster formats `cv2` reads, in numpy.

They write what `cv2.imwrite` cannot: every variant the port's readers
(`hrfuser_tpu_torch/data/{pxm,pam,pfm,bmp,sunras,hdr}.py`) take, from
pixels the caller gives, so a test can hold each reader to `cv2` on
bytes `cv2` did not write. `variants(rng, hw)` builds one of each, named;
`camera_frames(img)` writes a BGR camera frame in each family's main
variant. Numpy only: `chip_smoke.py` loads this file by path on the
card's machine, which has no `cv2`.

    PBM / PGM / PPM  `pnm(img, maxval, ascii, comments)`, `pbm(black, ...)`
    PAM              `pam(samples, tupltype, maxval)`
    PFM              `pfm(img, scale)` (scale < 0: little-endian)
    BMP / DIB        `bmp(pixels, bits, palette, ...)`, `rle(idx, four)`
    Sun raster       `sunras(pixels, depth, colormap, kind)`
    Radiance HDR     `to_rgbe(img)`, `hdr(rgbe, coding, header)`
"""

import struct
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

# --------------------------------------------------------------- PNM / PAM


def _ascii_rows(values: np.ndarray, per_line: int = 17,
                comments: bool = False) -> bytes:
    flat = [str(int(v)).encode() for v in values.reshape(-1)]
    lines = [b' '.join(flat[i:i + per_line])
             for i in range(0, len(flat), per_line)]
    if comments:
        lines = [ln + (b'\n# a comment between samples' if i % 5 == 2 else b'')
                 for i, ln in enumerate(lines)]
    return b'\n'.join(lines) + b'\n'


def pnm(img: np.ndarray, maxval: int = 255, ascii: bool = False,
        comments: bool = False) -> bytes:
    """PGM (`img` [H, W]) or PPM (BGR [H, W, 3], stored RGB), uint8 or
    uint16 samples written as they are (big-endian above maxval 255)."""
    grey = img.ndim == 2
    h, w = img.shape[:2]
    kind = (2 if grey else 3) + (0 if ascii else 3)
    head = b'P%d\n' % kind
    if comments:
        head += b'# written by tests/oracles/raster_files.py\n'
    head += b'%d %d\n' % (w, h)
    if comments:
        head += b'#  maxval next\n'
    head += b'%d\n' % maxval
    px = img if grey else img[..., ::-1]
    if ascii:
        return head + _ascii_rows(px, comments=comments)
    return head + np.ascontiguousarray(px).astype(
        '>u2' if maxval > 255 else np.uint8).tobytes()


def pbm(black: np.ndarray, ascii: bool = False,
        comments: bool = False) -> bytes:
    """PBM of a boolean [H, W] (True = black = 1), rows padded to a byte
    in the raw form."""
    h, w = black.shape
    head = b'P%d\n' % (1 if ascii else 4)
    if comments:
        head += b'# a bitmap\n'
    head += b'%d %d\n' % (w, h)
    bits = black.astype(np.uint8)
    if ascii:
        # runs of digits without spaces read one digit a sample
        rows = [b''.join(b'%d' % v for v in r) for r in bits]
        return head + b'\n'.join(rows) + b'\n'
    return head + np.packbits(bits, 1).tobytes()


def pam(samples: np.ndarray, tupltype: Optional[str] = None,
        maxval: int = 255, comment: bool = False) -> bytes:
    """PAM of samples [H, W, depth] in the file's order (uint8, or
    uint16 written big-endian above maxval 255)."""
    h, w, depth = samples.shape
    head = b'P7\n'
    if comment:
        head += b'# a PAM\n'
    head += b'WIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL %d\n' % (w, h, depth,
                                                           maxval)
    if tupltype:
        head += b'TUPLTYPE %s\n' % tupltype.encode()
    return head + b'ENDHDR\n' + np.ascontiguousarray(samples).astype(
        '>u2' if maxval > 255 else np.uint8).tobytes()


def pfm(img: np.ndarray, scale: float = -1.0) -> bytes:
    """PFM of float32 [H, W] or BGR [H, W, 3] (stored RGB, rows
    bottom-up); a negative scale writes little-endian samples."""
    colour = img.ndim == 3
    px = img[..., ::-1] if colour else img
    head = b'P%s\n%d %d\n%s\n' % (b'F' if colour else b'f', img.shape[1],
                                  img.shape[0], repr(float(scale)).encode())
    return head + np.ascontiguousarray(px[::-1]).astype(
        '<f4' if scale < 0 else '>f4').tobytes()

# --------------------------------------------------------------------- BMP


def _long_runs(row: np.ndarray, least: int):
    """(start, length) of each run of `least` or more equal values."""
    starts = np.concatenate([[0], np.flatnonzero(np.diff(row.astype(
        np.int32))) + 1]) if len(row) else np.zeros(0, np.int64)
    lengths = np.diff(np.append(starts, len(row)))
    keep = lengths >= least
    return zip(starts[keep].tolist(), lengths[keep].tolist())


def rle(idx: np.ndarray, four: bool, skip_zero: bool = False) -> bytes:
    """BI_RLE8 (BI_RLE4 with `four`) codes of palette indices [H, W] in
    file row order: runs of 2 or more encoded (RLE4: a run's two nibbles
    equal), other stretches of 3 or more absolute (RLE4: packed two a
    byte; padded to a word), an end of line after each row (RLE4: the
    last too, since `cv2` reads RLE4's end of bitmap as an end of line)
    and an end of bitmap last. `skip_zero`: runs of index 0 of 3 or more
    as deltas instead (and in RLE8 a row's trailing zeros as its end of
    line, trailing zero rows as the end of bitmap), which `cv2` fills
    with palette entry 0."""
    h, w = idx.shape
    out = bytearray()

    def literal(row, a, b):
        for k in range(a, b, 255):
            part = row[k:min(b, k + 255)].astype(np.uint8)
            if len(part) < 3:
                for v in part.tolist():
                    out.extend((1, (v << 4 | v) if four else v))
                continue
            if four:
                p = np.append(part, np.zeros(len(part) % 2, np.uint8))
                body = (p[0::2] << 4 | p[1::2]).astype(np.uint8).tobytes()
            else:
                body = part.tobytes()
            out.extend((0, len(part)))
            out.extend(body + b'\0' * (len(body) % 2))

    last = h
    if skip_zero and not four:
        nz = np.flatnonzero(idx.any(1))
        last = int(nz[-1]) + 1 if nz.size else 0
    for y in range(last):
        row = idx[y]
        end = w
        if skip_zero:
            nz = np.flatnonzero(row)
            end = int(nz[-1]) + 1 if nz.size else 0
        x = 0
        for start, n in _long_runs(row[:end], 2):
            literal(row, x, start)
            v = int(row[start])
            x = start + n
            if skip_zero and v == 0 and n >= 3:
                while n:
                    k = min(n, 255)
                    out.extend((0, 2, k, 0))
                    n -= k
                continue
            while n:
                k = min(n, 255)
                out.extend((k, (v << 4 | v) if four else v))
                n -= k
        literal(row, x, end)
        if y < last - 1 or four or last < h:
            out.extend((0, 0))
    out.extend((0, 1))
    return bytes(out)


def bmp(pixels: np.ndarray, bits: int = 24,
        palette: Optional[np.ndarray] = None, compression: str = 'rgb',
        header: str = 'info', top_down: bool = False,
        clr_used: Optional[int] = None,
        masks: Optional[Sequence[int]] = None, skip_zero: bool = False
        ) -> bytes:
    """A BMP. `pixels`: palette indices [H, W] for 1, 4 and 8 bits (with
    `palette`, BGR [n, 3]), BGR [H, W, 3] for 16 (555, or `masks`' 565)
    and 24 bits, BGRA [H, W, 4] for 32. `compression` 'rgb', 'rle8',
    'rle4' or 'bitfields' (`masks`: R, G, B (, A); a v4 / v5 header holds
    them, an info header writes R, G, B after itself). `header` 'core'
    (OS/2, 12 bytes), 'info' (40), 'v4' (108) or 'v5' (124). Rows are
    written bottom-up unless `top_down`."""
    h, w = pixels.shape[:2]
    comp = {'rgb': 0, 'rle8': 1, 'rle4': 2, 'bitfields': 3}[compression]
    rows = pixels if top_down else pixels[::-1]
    if compression in ('rle8', 'rle4'):
        body = rle(rows, comp == 2, skip_zero)
    else:
        if bits <= 8:
            if bits == 8:
                packed = rows.astype(np.uint8)
            else:
                per = 8 // bits
                pad = (-w) % per
                v = np.pad(rows.astype(np.uint8), ((0, 0), (0, pad)))
                v = v.reshape(h, -1, per)
                shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
                packed = (v << shifts).sum(2).astype(np.uint8)
        elif bits == 16:
            b, g, r = (rows[..., i].astype(np.uint16) for i in range(3))
            five = masks is None or tuple(masks[:3]) == (0x7c00, 0x3e0, 0x1f)
            v = ((r >> 3) << 10 | (g >> 3) << 5 | b >> 3) if five else \
                ((r >> 3) << 11 | (g >> 2) << 5 | b >> 3)
            packed = v.astype('<u2').view(np.uint8).reshape(h, -1)
        else:
            packed = rows.astype(np.uint8).reshape(h, -1)
        pitch = -(-packed.shape[1] // 4) * 4
        body = np.pad(packed, ((0, 0), (0, pitch - packed.shape[1]))
                      ).tobytes()
    pal = b''
    if palette is not None:
        entries = np.asarray(palette, np.uint8)
        if header == 'core':
            full = np.zeros((1 << bits, 3), np.uint8)
            full[:len(entries)] = entries[:1 << bits]
            pal = full.tobytes()
        else:
            pal = np.concatenate([entries, np.zeros((len(entries), 1),
                                                    np.uint8)], 1).tobytes()
    after = b''
    if header == 'core':
        head = struct.pack('<IHHHH', 12, w, h, 1, bits)
    else:
        size = {'info': 40, 'v4': 108, 'v5': 124}[header]
        n_pal = 0 if palette is None else len(palette)
        head = struct.pack('<IiiHHIIiiII', size, w, -h if top_down else h, 1,
                           bits, comp, len(body), 2835, 2835,
                           n_pal if clr_used is None else clr_used, 0)
        ext = b''
        if size > 40:
            m = list(masks or (0, 0, 0, 0)) + [0] * 4
            ext = struct.pack('<4I', *m[:4]) + b'BGRs' + bytes(36) + \
                bytes(12)
            if size == 124:
                ext += struct.pack('<4I', 4, 0, 0, 0)
        head += ext
        if size == 40 and masks is not None:
            after = struct.pack('<3I', *masks[:3])
    off = 14 + len(head) + len(after) + len(pal)
    return (b'BM' + struct.pack('<IHHI', off + len(body), 0, 0, off) + head
            + after + pal + body)

# -------------------------------------------------------------- Sun raster


def sunras(pixels: np.ndarray, depth: int,
           colormap: Optional[np.ndarray] = None, kind: int = 1) -> bytes:
    """A Sun raster: `pixels` indices [H, W] (1, 8 bits; `colormap` BGR
    [n, 3] written as RMT_EQUAL_RGB), BGR [H, W, 3] (24 bits, stored
    B, G, R) or [H, W, 4] (32 bits, stored X, B, G, R from [..., (3, 0,
    1, 2)]); rows padded to 16 bits. `kind` is the header's type word
    (1 RT_STANDARD, 0 RT_OLD; 2 and 3 write RT_STANDARD's bytes under a
    type `cv2` refuses)."""
    h, w = pixels.shape[:2]
    if depth == 1:
        rows = np.packbits(pixels.astype(np.uint8), 1)
    elif depth == 8:
        rows = pixels.astype(np.uint8)
    elif depth == 24:
        rows = pixels.astype(np.uint8).reshape(h, -1)
    else:
        rows = pixels[..., [3, 0, 1, 2]].astype(np.uint8).reshape(h, -1)
    rows = np.pad(rows, ((0, 0), (0, rows.shape[1] % 2)))
    cmap = b''
    if colormap is not None:
        cmap = np.asarray(colormap, np.uint8)[:, ::-1].T.tobytes()  # R, G, B
    body = rows.tobytes()
    return struct.pack('>8I', 0x59a66a95, w, h, depth, len(body), kind,
                       1 if cmap else 0, len(cmap)) + cmap + body

# ------------------------------------------------------------ Radiance HDR


def to_rgbe(img: np.ndarray) -> np.ndarray:
    """float32 BGR [H, W, 3] -> uint8 RGBE [H, W, 4], as Radiance's
    `float2rgbe` writes it (mantissas truncated)."""
    rgb = img[..., ::-1].astype(np.float64)
    v = rgb.max(-1)
    m, e = np.frexp(v)
    scale = np.where(v < 1e-32, 0, m * 256.0 / np.where(v > 0, v, 1))
    out = np.zeros(img.shape[:2] + (4,), np.uint8)
    out[..., :3] = (rgb * scale[..., None]).astype(np.uint8)
    out[..., 3] = np.where(v < 1e-32, 0, e + 128).astype(np.uint8)
    return out


def _hdr_runs(chan: np.ndarray) -> bytes:
    """One channel of a scanline in new-style runs: runs of 4 or more
    (at most 127 a code) as 128 + n, value; the bytes between them as
    literals of at most 128."""
    out = bytearray()

    def literal(a, b):
        for k in range(a, b, 128):
            part = chan[k:min(b, k + 128)]
            out.append(len(part))
            out.extend(part.tobytes())

    x = 0
    for start, n in _long_runs(chan, 4):
        literal(x, start)
        v, end = int(chan[start]), start + n
        while end - start >= 4:
            k = min(end - start, 127)
            out.extend((128 + k, v))
            start += k
        literal(start, end)
        x = end
    literal(x, len(chan))
    return bytes(out)


def hdr(rgbe: np.ndarray, coding: str = 'rle',
        header: bytes = b'#?RADIANCE\n# tests/oracles/raster_files.py\n'
                        b'EXPOSURE=1.0\nFORMAT=32-bit_rle_rgbe\n\n') -> bytes:
    """A Radiance HDR of RGBE bytes [H, W, 4]. `coding` 'flat', 'rle'
    (new-style runs, each scanline `2 2` and its width first) or
    'old_rle' (old-style repeat codes `1 1 1 n` for runs of a pixel,
    which `cv2` reads as the pixels they look like; zero pixels after
    them fill the file to a flat image's length, so that it reads)."""
    h, w = rgbe.shape[:2]
    head = header + b'-Y %d +X %d\n' % (h, w)
    if coding == 'flat':
        return head + np.ascontiguousarray(rgbe).tobytes()
    out = bytearray(head)
    for y in range(h):
        row = rgbe[y]
        if coding == 'rle':
            out.extend((2, 2, w >> 8, w & 255))
            for c in range(4):
                out.extend(_hdr_runs(np.ascontiguousarray(row[:, c])))
            continue
        x = 0
        while x < w:
            n = 1
            while x + n < w and (row[x + n] == row[x]).all() and n < 256:
                n += 1
            out.extend(row[x].tobytes())
            if n > 1:
                out.extend((1, 1, 1, n - 1))
            x += n
    if coding == 'old_rle':
        out.extend(bytes(len(head) + rgbe.size - len(out)))
    return bytes(out)

# ---------------------------------------------------------------- variants


def _palette(rng, n: int, grey: bool = False) -> np.ndarray:
    if grey:
        return np.repeat(rng.integers(0, 256, (n, 1)), 3, 1).astype(np.uint8)
    return rng.integers(0, 256, (n, 3)).astype(np.uint8)


def _blocky(rng, hw: Tuple[int, int], top: int) -> np.ndarray:
    """Indices in [0, top) with runs: 1x5 blocks of random values, some
    rows of zeros."""
    h, w = hw
    idx = np.repeat(rng.integers(0, top, (h, -(-w // 5))), 5, 1)[:, :w]
    idx[rng.random(h) < 0.2] = 0
    idx[:, rng.integers(0, w, 3)] = rng.integers(0, top, (h, 3))
    return idx.astype(np.uint8)


def variants(rng: np.random.Generator,
             hw: Tuple[int, int] = (37, 53)) -> Dict[str, bytes]:
    """name -> bytes of every variant the readers take, from `rng`."""
    h, w = hw
    bgr = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    grey = rng.integers(0, 256, (h, w)).astype(np.uint8)
    wide = rng.integers(0, 65536, (h, w, 3)).astype(np.uint16)
    out = {}
    # PNM
    out['pbm raw'] = pbm(rng.random((h, w)) < 0.5)
    out['pbm ascii'] = pbm(rng.random((h, w)) < 0.5, ascii=True,
                           comments=True)
    out['pgm raw'] = pnm(grey)
    out['pgm raw maxval 100'] = pnm(grey % 101, maxval=100)
    out['pgm raw 16-bit'] = pnm(wide[..., 0], maxval=65535)
    out['pgm ascii maxval 100'] = pnm(grey % 120, maxval=100, ascii=True,
                                      comments=True)
    out['pgm ascii 16-bit maxval 1000'] = pnm(
        wide[..., 0] % 1200, maxval=1000, ascii=True)
    out['ppm raw'] = pnm(bgr, comments=True)
    out['ppm raw 16-bit'] = pnm(wide, maxval=65535)
    out['ppm ascii'] = pnm(bgr, ascii=True, comments=True)
    out['ppm ascii 16-bit'] = pnm(wide, maxval=65535, ascii=True)
    # PAM
    out['pam blackandwhite'] = pam(
        rng.integers(0, 2, (h, w, 1)).astype(np.uint8), 'BLACKANDWHITE', 1)
    out['pam grayscale'] = pam(grey[..., None], 'GRAYSCALE', comment=True)
    out['pam grayscale 16-bit'] = pam(wide[..., :1], 'GRAYSCALE', 65535)
    out['pam grayscale_alpha'] = pam(bgr[..., :2], 'GRAYSCALE_ALPHA')
    out['pam rgb'] = pam(bgr, 'RGB')
    out['pam rgb 16-bit'] = pam(wide, 'RGB', 65535)
    out['pam rgb_alpha'] = pam(np.dstack([bgr, grey]), 'RGB_ALPHA')
    out['pam grey, no tuple type'] = pam(grey[..., None])
    out['pam rgb, no tuple type'] = pam(bgr)
    # PFM
    img = (rng.standard_normal((h, w, 3)) * 2 + 1).astype(np.float32)
    out['pfm colour little-endian'] = pfm(img, -1.0)
    out['pfm colour big-endian'] = pfm(img, 1.0)
    out['pfm grey little-endian scale 4'] = pfm(img[..., 1] * 4, -4.0)
    out['pfm grey big-endian'] = pfm(img[..., 2], 1.0)
    # BMP
    for bits, comp in ((1, 'rgb'), (4, 'rgb'), (8, 'rgb'), (4, 'rle4'),
                       (8, 'rle8')):
        top = 1 << bits
        idx = _blocky(rng, hw, top)
        pal = _palette(rng, top)
        out[f'bmp {bits}-bit {comp}'] = bmp(idx, bits, pal, comp)
        out[f'bmp {bits}-bit {comp} grey palette'] = bmp(
            idx, bits, _palette(rng, top, grey=True), comp)
    out['bmp 8-bit short palette'] = bmp(_blocky(rng, hw, 40), 8,
                                         _palette(rng, 30))
    out['bmp 8-bit rle8 deltas'] = bmp(_blocky(rng, hw, 256), 8,
                                       _palette(rng, 256), 'rle8',
                                       skip_zero=True)
    out['bmp 4-bit rle4 deltas'] = bmp(_blocky(rng, hw, 16), 4,
                                       _palette(rng, 16), 'rle4',
                                       skip_zero=True)
    out['bmp 16-bit 555'] = bmp(bgr, 16)
    out['bmp 16-bit 555 bitfields'] = bmp(bgr, 16, compression='bitfields',
                                          masks=(0x7c00, 0x3e0, 0x1f))
    out['bmp 16-bit 565 bitfields'] = bmp(bgr, 16, compression='bitfields',
                                          masks=(0xf800, 0x7e0, 0x1f))
    out['bmp 24-bit'] = bmp(bgr)
    out['bmp 24-bit top-down'] = bmp(bgr, top_down=True)
    bgra = np.dstack([bgr, grey])
    out['bmp 32-bit rgb'] = bmp(bgra, 32)
    out['bmp 32-bit bitfields'] = bmp(bgra, 32, compression='bitfields',
                                      masks=(0xff0000, 0xff00, 0xff))
    out['bmp 32-bit v4 alpha'] = bmp(
        bgra, 32, compression='bitfields', header='v4',
        masks=(0xff0000, 0xff00, 0xff, 0xff000000))
    out['bmp 32-bit v5 rgba masks'] = bmp(
        bgra, 32, compression='bitfields', header='v5',
        masks=(0xff, 0xff00, 0xff0000, 0xff000000))
    out['bmp 32-bit v5 10-10-10 no alpha'] = bmp(
        bgra, 32, compression='bitfields', header='v5',
        masks=(0x3ff00000, 0xffc00, 0x3ff, 0))
    out['bmp 24-bit os2'] = bmp(bgr, header='core')
    out['bmp 8-bit os2'] = bmp(_blocky(rng, hw, 256), 8, _palette(rng, 256),
                               header='core')
    out['bmp 1-bit os2'] = bmp(_blocky(rng, hw, 2), 1, _palette(rng, 2),
                               header='core')
    # Sun raster
    out['ras 1-bit'] = sunras(rng.integers(0, 2, hw), 1)
    out['ras 1-bit colour map'] = sunras(rng.integers(0, 2, hw), 1,
                                         _palette(rng, 2))
    out['ras 8-bit'] = sunras(grey, 8)
    out['ras 8-bit colour map'] = sunras(_blocky(rng, hw, 200), 8,
                                         _palette(rng, 200))
    out['ras 8-bit grey map'] = sunras(grey, 8, _palette(rng, 256, True))
    out['ras 24-bit'] = sunras(bgr, 24)
    out['ras 24-bit rt_old'] = sunras(bgr, 24, kind=0)
    out['ras 32-bit'] = sunras(bgra, 32)
    # Radiance HDR
    img = np.abs(rng.standard_normal((h, w, 3)) * 0.8).astype(np.float32)
    img[:, ::7] = img[:, :1]                      # runs for the RLE
    img[::5] = 0
    px = to_rgbe(img)
    out['hdr flat'] = hdr(px, 'flat')
    out['hdr rle'] = hdr(px, 'rle')
    out['hdr old rle'] = hdr(px, 'old_rle')
    out['hdr rle rgbe header'] = hdr(
        px, 'rle', b'#?RGBE\nFORMAT=32-bit_rle_rgbe\nGAMMA=2.2\n\n')
    out['hdr narrow flat'] = hdr(px[:, :5], 'flat')
    return out


def _early_eob(data: bytes) -> bytes:
    """An RLE BMP whose codes end with an end of bitmap after its first
    row (`cv2` reads RLE4's as an end of line and then runs out)."""
    off = struct.unpack_from('<I', data, 10)[0]
    return data[:data.index(b'\0\0', off) + 1] + b'\1'


# the variants `cv2` refuses: name -> bytes
def refused(rng: np.random.Generator,
            hw: Tuple[int, int] = (9, 11)) -> Dict[str, bytes]:
    h, w = hw
    bgr = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    px = to_rgbe(bgr.astype(np.float32) / 100)
    return {
        'pam rgb_alpha, no tuple type': pam(np.dstack([bgr, bgr[..., :1]])),
        'pam 16-bit rgb, no tuple type': pam(bgr.astype(np.uint16) * 257,
                                             maxval=65535),
        'pam unknown tuple type': pam(bgr, 'FOO'),
        'pam rgb of depth 4': pam(np.dstack([bgr, bgr[..., :1]]), 'RGB'),
        'bmp 16-bit other masks': bmp(bgr, 16, compression='bitfields',
                                      masks=(0xf00, 0xf0, 0xf)),
        'bmp 16-bit 565 in a v4 header': bmp(
            bgr, 16, compression='bitfields', header='v4',
            masks=(0xf800, 0x7e0, 0x1f, 0)),
        'bmp rle4, end of bitmap after row 0': _early_eob(
            bmp(np.ones((h, w), np.uint8), 4, _palette(rng, 16), 'rle4')),
        'bmp compression 4 (JPEG)': bmp(bgr)[:30] + b'\4' + bmp(bgr)[31:],
        'ras rt_byte_encoded': sunras(bgr, 24, kind=2),
        'ras rt_format_rgb': sunras(bgr, 24, kind=3),
        'pfm scale 0': pfm(bgr.astype(np.float32), 0.0),
        'hdr xyze': hdr(px, 'flat', b'#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n'),
        'hdr +Y orientation': hdr(px, 'flat')[:-px.size].replace(
            b'-Y', b'+Y') + px.tobytes(),
    }


def camera_frames(img: np.ndarray) -> Dict[str, Tuple[bytes, np.ndarray]]:
    """A BGR camera frame in each family's main variant: name -> (bytes,
    what 'unchanged' must read). P6 8-bit, P6 16-bit (`img * 257`), 24-bit
    BMP, RLE8 BMP (the frame on a 6x6x6 colour cube, its palette), Sun
    raster (8 bits with that colour map; `cv2` reads no RLE Sun raster),
    PFM (the frame as float32) and new-style RLE Radiance HDR (`img /
    255`, as its RGBE bytes read back)."""
    cube = np.round(img.astype(np.float32) * 5 / 255).astype(np.uint8)
    idx = (cube[..., 2] * 36 + cube[..., 1] * 6 + cube[..., 0]).astype(
        np.uint8)
    levels = (np.arange(6) * 51).astype(np.uint8)
    pal = np.stack(np.meshgrid(levels, levels, levels, indexing='ij'),
                   -1).reshape(-1, 3)[:, ::-1]          # index r*36+g*6+b
    pal = np.ascontiguousarray(pal)
    quant = pal[idx]
    f = (img.astype(np.float32) / np.float32(255)).astype(np.float32)
    px = to_rgbe(f)
    e = px[..., 3:].astype(np.int32)
    back = np.where(e > 0, np.ldexp(px[..., 2::-1].astype(np.float32),
                                    e - 136), 0).astype(np.float32)
    wide = img.astype(np.uint16) * 257
    return {
        'P6 8-bit': (pnm(img), img),
        'P6 16-bit': (pnm(wide, maxval=65535), wide),
        'BMP 24-bit': (bmp(img), img),
        'BMP RLE8': (bmp(idx, 8, pal, 'rle8'), quant),
        'Sun raster 8-bit colour map': (sunras(idx, 8, pal), quant),
        'PFM': (pfm(img.astype(np.float32), -1.0), img.astype(np.float32)),
        'HDR RLE': (hdr(px, 'rle'), back),
    }
