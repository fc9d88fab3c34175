"""TIFF decoding in numpy, as `cv2.imread` / `cv2.imdecode` 5.0 read it
through their libtiff 4.7 in `IMREAD_COLOR`, `IMREAD_GRAYSCALE` and
`IMREAD_UNCHANGED`. The card's machine has no `cv2`.

The container, here: the first image file directory of classic TIFF
(`II*\\0`, `MM\\0*`) or BigTIFF (`II+\\0`, `MM\\0+`, 8-byte offsets), in
either byte order, every field type parsed; strips or tiles (edge tiles
cropped), PlanarConfiguration 1 or 2, FillOrder 2 (bits reversed before
decoding, JPEG data excepted), SamplesPerPixel with ExtraSamples,
SampleFormat 1 / 2 / 3 at 1, 4, 8, 16, 32 and 64 bits, Orientation 1-8,
the first page only. The compressions and predictors are in
`data/tiff_codecs.py`; JPEG strips and tiles (compression 7) go through
the port's JPEG decoder (`data/jpeg.py`, pixels on `device`).

What `cv2` does with the samples, and so this (found by testing `cv2`
5.0):
  * 'color', 'grayscale', and 'unchanged' for 1- to 8-bit samples go
    through libtiff's RGBA reader (`data/tiff_rgba.py`): 16-bit samples
    become 8-bit, alpha is premultiplied, palettes and CMYK become RGB;
    then BGR, or grey through `cvt.bgr_to_grey`. 'unchanged' keeps one
    channel for grey images and 1-bit palettes, four for 4-sample RGB
    (BGRA) and CMYK (alpha 255), three otherwise; 8-bit signed samples
    come back as int8.
  * 'unchanged' for 16-, 32- and 64-bit grey or RGB samples with 1, 3 or
    4 samples reads them as stored (BGR / BGRA order): uint16, int16,
    uint32, int32, float32, uint64, int64, float64. Grey files of 3 or 4
    16-bit samples give one channel, `cvt.bgr_to_grey` of the first three
    at 16 bits.
  * 32- and 64-bit samples read colour or grey, float16, 2-, 10-, 12-
    and 14-bit samples, a 4-bit grey image, and more than 4 samples are
    refused by `cv2` (None); so are LZMA, ZSTD, WebP and old-style JPEG,
    which its libtiff is built without. This raises there.
  * libtiff applies the predictor under LZW and Deflate only: an
    uncompressed or PackBits file's Predictor tag is ignored.
  * Orientation is applied in every mode. In the RGBA reader libtiff
    mirrors each tile by itself, so a tiled file whose orientation
    mirrors left to right (2, 3, 6, 7) reads with its tiles mirrored in
    place (`tiff_rgba.orient`).
  * 16-bit planar files of more than one sample, read 'unchanged', make
    `cv2` read past the first plane: no answer is defined, and this
    raises.

Anything else `cv2` reads and this does not raises `ValueError` naming
the tag and its value (`_refuse`): CCITT G3 / G4 (compression 2, 3, 4,
32771), SGILog (34676, 34677), photometric interpretations other than
0, 1, 2, 3, 5 and 6 (YCbCr with JPEG only), JPEG with planes or CMYK.
Damaged or cut data raises too, where libtiff's RGBA reader fills what
it cannot decode and `cv2` returns the rest.

`imdecode(data, flag, device)` returns what `cv2.imdecode` does,
`imdecode(..., from_file=True)` and `imread(path)` what `cv2.imread`
does (the two differ on two points: `imdecode`'s docstring). Both read
'unchanged' by default.
"""

from __future__ import annotations

import struct
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from hrfuser_tpu_torch.data import cvt, tiff_codecs, tiff_rgba

# field type -> (struct format of one value, its size); ASCII and
# UNDEFINED come back as bytes, RATIONALs as (numerator, denominator)
_TYPES = {1: ('B', 1), 2: ('s', 1), 3: ('H', 2), 4: ('I', 4), 5: ('II', 8),
          6: ('b', 1), 7: ('s', 1), 8: ('h', 2), 9: ('i', 4), 10: ('ii', 8),
          11: ('f', 4), 12: ('d', 8), 13: ('I', 4), 16: ('Q', 8),
          17: ('q', 8), 18: ('Q', 8)}
_TAG_NAMES = {256: 'ImageWidth', 257: 'ImageLength', 258: 'BitsPerSample',
              259: 'Compression', 262: 'PhotometricInterpretation',
              266: 'FillOrder', 273: 'StripOffsets', 274: 'Orientation',
              277: 'SamplesPerPixel', 278: 'RowsPerStrip',
              279: 'StripByteCounts', 284: 'PlanarConfiguration',
              317: 'Predictor', 320: 'ColorMap', 322: 'TileWidth',
              323: 'TileLength', 324: 'TileOffsets', 325: 'TileByteCounts',
              332: 'InkSet', 338: 'ExtraSamples', 339: 'SampleFormat',
              347: 'JPEGTables', 530: 'YCbCrSubSampling'}
COMPRESSIONS = {1: 'none', 5: 'LZW', 7: 'JPEG', 8: 'Deflate',
                32773: 'PackBits', 32946: 'Deflate'}
PHOTOMETRICS = {0: 'MinIsWhite', 1: 'MinIsBlack', 2: 'RGB', 3: 'Palette',
                5: 'Separated', 6: 'YCbCr'}
FLAGS = ('color', 'unchanged', 'grayscale')


def _refuse(tag: int, value, why: str = '') -> ValueError:
    return ValueError(f'TIFF tag {tag} ({_TAG_NAMES.get(tag, "?")}) = '
                      f'{value}: not read{": " + why if why else ""}')


def directory(data: bytes) -> Tuple[str, Dict[int, object]]:
    """(byte order, {tag: values}) of the first image file directory.
    Numbers come back as lists, ASCII and UNDEFINED values as bytes,
    RATIONALs as (numerator, denominator) pairs."""
    order = {b'II': '<', b'MM': '>'}.get(bytes(data[:2]))
    if order is None or len(data) < 8:
        raise ValueError('not a TIFF file')
    (magic,) = struct.unpack(order + 'H', data[2:4])
    if magic == 42:
        big, (ifd,) = False, struct.unpack(order + 'I', data[4:8])
    elif magic == 43:
        if len(data) < 16 or struct.unpack(order + 'HH', data[4:8]) != (8, 0):
            raise ValueError('BigTIFF header with offsets that are not '
                             '8 bytes')
        big, (ifd,) = True, struct.unpack(order + 'Q', data[8:16])
    else:
        raise ValueError(f'TIFF version {magic}: not 42 (TIFF) or 43 '
                         f'(BigTIFF)')
    count_fmt, entry, inline = ('Q', 20, 8) if big else ('H', 12, 4)
    head = struct.calcsize(count_fmt)
    if ifd + head > len(data):
        raise ValueError(f'truncated TIFF: the first directory at {ifd}')
    (n,) = struct.unpack(order + count_fmt, data[ifd:ifd + head])
    if ifd + head + n * entry > len(data):
        raise ValueError(f'truncated TIFF: a directory of {n} entries')
    tags = {}
    for i in range(n):
        pos = ifd + head + entry * i
        tag, kind, count = struct.unpack(order + ('HHQ' if big else 'HHI'),
                                         data[pos:pos + entry - inline])
        if kind not in _TYPES:
            raise ValueError(f'TIFF tag {tag}: field type {kind} is not a '
                             f'TIFF type')
        fmt, size = _TYPES[kind]
        nbytes = size * count
        at = pos + (12 if big else 8)
        if nbytes > inline:
            (at,) = struct.unpack(order + ('Q' if big else 'I'),
                                  data[at:at + inline])
        raw = bytes(data[at:at + nbytes])
        if len(raw) != nbytes:
            raise ValueError(f'truncated TIFF: tag {tag}')
        if fmt == 's':
            tags[tag] = raw
        else:
            values = struct.unpack(order + fmt * count, raw)
            tags[tag] = (list(zip(values[::2], values[1::2])) if len(fmt) == 2
                         else list(values))
    return order, tags


class Layout(NamedTuple):
    """The fields of a first directory that decoding needs, checked."""
    order: str
    width: int
    height: int
    bits: int
    spp: int
    sample_format: int
    photometric: int
    compression: int
    predictor: int
    planar: int
    tile: Optional[Tuple[int, int]]       # (rows, columns); None: strips
    rows: int                             # of a strip or tile
    offsets: List[int]
    counts: List[int]
    fill_order: int
    orientation: int
    alpha: int                            # 0 none, 1 associated, 2 not
    colormap: Optional[np.ndarray]
    jpeg_tables: Optional[bytes]
    subsampling: Tuple[int, int]

    @property
    def dtype(self) -> np.dtype:
        """The samples' dtype in the file's byte order (1- and 4-bit
        samples unpack to uint8)."""
        if self.bits < 8:
            return np.dtype(np.uint8)
        kind = {1: 'u', 2: 'i', 3: 'f'}[self.sample_format]
        return np.dtype(f'{self.order}{kind}{self.bits // 8}')

    @property
    def grid(self) -> Tuple[int, int, int, int]:
        """(segment rows, segment columns, segments down, across)."""
        if self.tile:
            th, tw = self.tile
            return th, tw, -(-self.height // th), -(-self.width // tw)
        return self.rows, self.width, -(-self.height // self.rows), 1


def _one(tags, tag, default=None, allowed=None):
    values = tags.get(tag)
    if values is None:
        if default is None:
            raise ValueError(f'TIFF without tag {tag} '
                             f'({_TAG_NAMES.get(tag, "?")})')
        return default
    if isinstance(values, bytes) or not values:
        raise _refuse(tag, values)
    if len(set(values)) != 1:
        raise _refuse(tag, values, 'different values a sample')
    v = values[0]
    if allowed is not None and v not in allowed:
        raise _refuse(tag, v)
    return v


def layout(data: bytes) -> Layout:
    """Parse and check the first directory (see the module docstring for
    what is read)."""
    order, tags = directory(data)
    w, h = _one(tags, 256), _one(tags, 257)
    cvt.check_size('TIFF', w, h)
    spp = _one(tags, 277, 1)
    if not 1 <= spp <= 4:
        raise _refuse(277, spp, 'cv2 reads 1 to 4 samples a pixel')
    bits = _one(tags, 258, 1, (1, 4, 8, 16, 32, 64))
    fmt = _one(tags, 339, 1, (1, 2, 3))
    if fmt == 3 and bits not in (32, 64):
        raise _refuse(339, fmt, f'floating point samples of {bits} bits')
    compression = _one(tags, 259, 1)
    if compression not in COMPRESSIONS:
        raise _refuse(259, compression, 'read: none (1), LZW (5), JPEG (7),'
                      ' Deflate (8, 32946), PackBits (32773)')
    photometric = _one(tags, 262)
    if photometric not in PHOTOMETRICS:
        raise _refuse(262, photometric, 'read: ' + ', '.join(
            f'{k} ({v})' for k, v in PHOTOMETRICS.items()))
    planar = _one(tags, 284, 1, (1, 2))
    if spp == 1:
        planar = 1
    predictor = 1
    if compression in tiff_codecs.PREDICTED:
        predictor = _one(tags, 317, 1, (1, 2, 3))
        if predictor == 2 and bits < 8:
            raise _refuse(317, 2, f'horizontal differences of {bits}-bit '
                          f'samples')
        if predictor == 3 and fmt != 3:
            raise _refuse(317, 3, 'floating point differences of integer '
                          'samples')
    extra = tags.get(338, [])
    alpha = 0
    if extra:
        alpha = {0: 1 if spp > 3 else 0, 1: 1, 2: 2}.get(extra[0], 0)
    elif spp == 4 and photometric == 2:
        alpha = 1                 # libtiff's DEFAULT_EXTRASAMPLE_AS_ALPHA
    colormap = None
    if photometric == 3:
        cmap = tags.get(320)
        if cmap is None or len(cmap) != 3 << bits:
            raise _refuse(320, None if cmap is None else f'{len(cmap)} values',
                          f'a palette of {bits}-bit indices needs {3 << bits}')
        colormap = np.array(cmap, np.int64).reshape(3, 1 << bits).T
    if photometric == 5:
        _one(tags, 332, 1, (1,))
    if photometric == 6 and compression != 7:
        raise _refuse(262, 6, 'YCbCr is read JPEG-compressed only')
    if compression == 7:
        if (planar == 2 or photometric not in (1, 2, 6) or bits != 8
                or spp != (1 if photometric == 1 else 3)):
            raise _refuse(259, 7, f'JPEG is read for 8-bit grey, RGB and '
                          f'YCbCr pixels, not {spp} {bits}-bit samples of '
                          f'photometric {photometric} in planar '
                          f'configuration {planar}')
    tables = tags.get(347)
    if isinstance(tables, list):
        tables = bytes(tables)
    sub = tags.get(530, [2, 2])
    tiled = 322 in tags or 323 in tags
    if tiled:
        tile = (_one(tags, 323), _one(tags, 322))
        if min(tile) < 1:
            raise _refuse(322, tile[1], 'tiles of no pixels')
        rows = tile[0]
        offsets, counts = tags.get(324), tags.get(325)
        off_tag, count_tag = 324, 325
    else:
        tile = None
        rows = min(_one(tags, 278, 2 ** 32 - 1), h)
        if rows < 1:
            raise _refuse(278, rows)
        offsets, counts = tags.get(273), tags.get(279)
        off_tag, count_tag = 273, 279
    if offsets is None or isinstance(offsets, bytes):
        raise ValueError(f'TIFF without tag {off_tag} '
                         f'({_TAG_NAMES[off_tag]})')
    lay = Layout(order, w, h, bits, spp, fmt, photometric, compression,
                 predictor, planar, tile, rows, list(offsets), [],
                 _one(tags, 266, 1, (1, 2)), _one(tags, 274, 1,
                                                  tuple(range(1, 9))),
                 alpha, colormap, tables, tuple(sub[:2]))
    th, tw, down, across = lay.grid
    n = down * across * (spp if planar == 2 else 1)
    if counts is None:
        if compression != 1 or tiled:
            raise ValueError(f'TIFF without tag {count_tag} '
                             f'({_TAG_NAMES[count_tag]})')
        counts = [_segment_bytes(lay, min(th, h - k * th))
                  for k in range(down)] * (spp if planar == 2 else 1)
    if len(offsets) < n or len(counts) < n:
        raise ValueError(f'TIFF with {len(offsets)} offsets and '
                         f'{len(counts)} byte counts for {n} '
                         f'{"tiles" if tiled else "strips"}')
    return lay._replace(offsets=list(offsets[:n]), counts=list(counts[:n]))


def _segment_spp(lay: Layout) -> int:
    return 1 if lay.planar == 2 else lay.spp


def _segment_bytes(lay: Layout, rows: int) -> int:
    th, tw, _, _ = lay.grid
    return rows * -(-tw * _segment_spp(lay) * lay.bits // 8)


def _unpack(raw: np.ndarray, lay: Layout, rows: int) -> np.ndarray:
    """One segment's decoded bytes -> samples [rows, cols, spp] in native
    byte order (1- and 4-bit samples as uint8 values)."""
    _, cols, _, _ = lay.grid
    s = _segment_spp(lay)
    raw = raw[:_segment_bytes(lay, rows)]
    if lay.bits < 8:
        bits = np.unpackbits(raw.reshape(rows, -1), axis=1)
        if lay.bits == 4:
            bits = bits.reshape(rows, -1, 4)
            bits = (bits * np.array([8, 4, 2, 1], np.uint8)).sum(
                -1, dtype=np.uint8)
        return bits[:, :cols * s].reshape(rows, cols, s)
    v = tiff_codecs.native_bits(raw, lay.dtype).reshape(rows, cols, s)
    return v.view(lay.dtype.newbyteorder('='))


def _segments(data: bytes, lay: Layout) -> List[np.ndarray]:
    """Every strip or tile decompressed (and its bits reversed first for
    FillOrder 2), predictor undone, unpacked: samples [rows, cols, s]."""
    th, tw, down, across = lay.grid
    rows = [min(th, lay.height - k * th) if not lay.tile else th
            for k in range(down) for _ in range(across)]
    rows = rows * (lay.spp if lay.planar == 2 else 1)
    kind = 'tile' if lay.tile else 'strip'
    sizes = [_segment_bytes(lay, r) for r in rows]
    parts = []
    for k, (off, count) in enumerate(zip(lay.offsets, lay.counts)):
        part = bytes(data[off:off + count])
        if off >= len(data) or (lay.compression == 1
                                and len(part) < sizes[k]):
            raise ValueError(f'truncated TIFF: {kind} {k} at {off} of '
                             f'{count} bytes')
        parts.append(tiff_codecs.reverse_bits(part) if lay.fill_order == 2
                     else part)
    c = lay.compression
    if c == 1:
        raws = [np.frombuffer(p, np.uint8) for p in parts]
    elif c == 5:
        raws = tiff_codecs.lzw_decode(parts, sizes)
    elif c == 32773:
        raws = [tiff_codecs.packbits_decode(p, n)
                for p, n in zip(parts, sizes)]
    else:
        raws = [tiff_codecs.deflate_decode(p, n)
                for p, n in zip(parts, sizes)]
    out = []
    s = _segment_spp(lay)
    for k, (raw, want, r) in enumerate(zip(raws, sizes, rows)):
        if len(raw) < want:
            raise ValueError(f'TIFF {kind} {k} holds {len(raw)} of its '
                             f'{want} bytes')
        if lay.predictor != 1:
            out.append(tiff_codecs.predict(raw[:want], lay.predictor, r, tw,
                                           s, lay.dtype))
        else:
            out.append(_unpack(raw, lay, r))
    return out


def _jpeg_segments(data: bytes, lay: Layout, device) -> List[np.ndarray]:
    """Every JPEG strip or tile decoded by the port's decoder (pixels on
    `device`): RGB or grey samples [rows, cols, 3 or 1], uint8."""
    from hrfuser_tpu_torch.data import jpeg
    th, tw, down, across = lay.grid
    colour = {1: jpeg.GREY, 2: jpeg.RGB, 6: jpeg.YCBCR}[lay.photometric]
    kind = 'tile' if lay.tile else 'strip'
    out = []
    for k, (off, count) in enumerate(zip(lay.offsets, lay.counts)):
        rows = th if lay.tile else min(th, lay.height - (k // across) * th)
        stream = tiff_codecs.jpeg_stream(bytes(data[off:off + count]),
                                         lay.jpeg_tables)
        frame = jpeg.frame_info(stream)
        want = [(1, 1)] * lay.spp
        if lay.photometric == 6:
            want[0] = lay.subsampling
        got = [c[:2] for c in frame.comps]
        if got != want or frame.precision != 8:
            raise ValueError(f'TIFF JPEG {kind} {k}: {len(got)} components '
                             f'sampled {got} at {frame.precision} bits, not '
                             f'{want} at 8')
        # libtiff takes a last strip coded taller than the image and cuts it
        last_strip = not lay.tile and k == len(lay.offsets) - 1
        if frame.width != tw or not (frame.height == rows or (
                last_strip and frame.height > rows)):
            raise ValueError(f'TIFF JPEG {kind} {k} of {frame.width}x'
                             f'{frame.height}, not {tw}x{rows}')
        px = jpeg.decode_jpeg(stream, device, lay.photometric == 1,
                              colour).cpu().numpy()
        px = px[:rows]
        out.append(px[..., ::-1] if px.ndim == 3 else px[..., None])
    return out


def samples(data: bytes, lay: Layout, device='cuda') -> np.ndarray:
    """All samples [H', W', spp] in native byte order: the image, and for
    tiles the padding of the edge tiles beyond it (H', W' whole tiles)."""
    th, tw, down, across = lay.grid
    segs = (_jpeg_segments(data, lay, device) if lay.compression == 7
            else _segments(data, lay))
    full = np.empty((down * th if lay.tile else lay.height, across * tw,
                     lay.spp), segs[0].dtype)
    planes = lay.spp if lay.planar == 2 else 1
    for k, seg in enumerate(segs):
        p, i = divmod(k, down * across)
        y, x = (i // across) * th, (i % across) * tw
        chans = slice(p, p + 1) if planes > 1 else slice(None)
        full[y:y + seg.shape[0], x:x + tw, chans] = seg
    return full


def imdecode(data: bytes, flag: str = 'unchanged', device='cuda',
             from_file: bool = False,
             lay: Optional[Layout] = None) -> np.ndarray:
    """What `cv2.imdecode(buf, IMREAD_<FLAG>)` gives for a TIFF byte
    string (see the module docstring); JPEG strips and tiles have their
    pixels made on `device`. With `from_file`, what `cv2.imread` gives
    for a file of these bytes, which differs twice: it refuses a
    non-square image that orientation 5-8 turns, and it reads
    uncompressed tiles of any size through the RGBA reader, where
    `cv2.imdecode` returns None unless a tile's bytes (a plane's) are a
    multiple of 1024 (`cv2.imread` too, for FillOrder 2: libtiff copies
    those tiles rather than mapping them; measured). `lay` is
    `layout(data)` where the caller has it already."""
    if flag not in FLAGS:
        raise ValueError(f'imread flag {flag!r}: one of {FLAGS}')
    lay = layout(data) if lay is None else lay
    if from_file and lay.orientation >= 5 and lay.width != lay.height:
        raise _refuse(274, lay.orientation, f'cv2.imread returns None for a '
                      f'{lay.width}x{lay.height} file turned by it (only '
                      f'cv2.imdecode reads it)')
    raw_route = tiff_rgba.raw_route(lay, flag)
    if not raw_route:
        tiff_rgba.check_rgba(lay)
        copied = not from_file or lay.fill_order == 2
        if (lay.compression == 1 and lay.tile and copied
                and _segment_bytes(lay, lay.tile[0]) % 1024):
            raise _refuse(322, lay.tile[1], f'cv2 returns None for '
                          f'uncompressed tiles of '
                          f'{_segment_bytes(lay, lay.tile[0])} bytes it '
                          f'copies (a multiple of 1024 reads)')
    full = samples(data, lay, device)
    if raw_route:
        img = tiff_rgba.raw_image(full[:lay.height, :lay.width], lay)
        return np.ascontiguousarray(tiff_rgba.orient(img, lay.orientation))
    return tiff_rgba.rgba_read(full, lay, flag)


def imread(path: str, flag: str = 'unchanged', device='cuda') -> np.ndarray:
    """What `cv2.imread(path, IMREAD_<FLAG>)` gives for a TIFF file."""
    with open(path, 'rb') as f:
        return imdecode(f.read(), flag, device, from_file=True)
