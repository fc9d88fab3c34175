"""A TIFF writer in numpy, for the port's TIFF reader
(`hrfuser_tpu_torch/data/tiff.py`) to be held to `cv2` on files `cv2`
did not write.

`tiff(samples, ...)` writes the first page of a file from the samples
the caller gives: classic TIFF or BigTIFF, either byte order, strips or
tiles, chunky or planar, 1- to 64-bit integer or float samples, any
photometric interpretation with its tags, and each compression the port
reads, with the predictors. `variants(rng, hw)` builds one file of each
kind, named; `refused(rng)` the files the port leaves out;
`camera_frames(img)` a BGR camera frame in each main variant. JPEG
streams come from the port's own coder (`data/jpeg.py:encode_blocks` /
`encode_scan`, the pixel stage on the CPU); everything else is numpy,
`zlib` and `lzma`, so that `chip_smoke.py` loads this file by path on the
card's machine, which has no `cv2`, PIL or `tifffile`.
"""

import importlib.util
import lzma
import os
import struct
import zlib
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

_TYPES = {1: 'B', 2: 's', 3: 'H', 4: 'I', 5: 'II', 6: 'b', 7: 'B', 8: 'h',
          9: 'i', 10: 'ii', 11: 'f', 12: 'd', 16: 'Q', 17: 'q', 18: 'Q'}


def _offline_data():
    """`offline_data.py` beside this file (its LZW encoder), by path: this
    file is loaded by path on the card's machine too."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'offline_data.py')
    spec = importlib.util.spec_from_file_location('offline_data', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def packbits(data: bytes) -> bytes:
    """PackBits (Macintosh RLE, compression 32773): runs of 3 to 128
    equal bytes as (1 - n, byte), the rest as literal blocks of up to
    128 bytes."""
    a = np.frombuffer(data, np.uint8)
    out = bytearray()
    if not a.size:
        return b''
    edges = np.flatnonzero(np.diff(a)) + 1
    starts = np.concatenate([[0], edges])
    lengths = np.diff(np.concatenate([starts, [a.size]]))
    lit = bytearray()

    def flush():
        for k in range(0, len(lit), 128):
            chunk = lit[k:k + 128]
            out.append(len(chunk) - 1)
            out.extend(chunk)
        lit.clear()
    for s, n in zip(starts.tolist(), lengths.tolist()):
        if n < 3:
            lit.extend(a[s:s + n].tobytes())
            continue
        flush()
        while n > 0:
            m = min(n, 128)
            if m < 3:
                lit.extend(a[s:s + m].tobytes())
                break
            out.append((257 - m) & 0xFF)
            out.append(int(a[s]))
            n -= m
    flush()
    return bytes(out)


def _pack_bits(rows: np.ndarray, bits: int) -> np.ndarray:
    """[R, N] values below 2^bits -> [R, ceil(N bits / 8)] bytes, MSB
    first, each row padded."""
    r, n = rows.shape
    per = 8 // bits
    pad = (-n) % per
    v = np.concatenate([rows, np.zeros((r, pad), rows.dtype)], 1).astype(
        np.uint16).reshape(r, -1, per)
    shifts = (8 - bits * (1 + np.arange(per))).astype(np.uint16)
    return (v << shifts).sum(-1).astype(np.uint8)


def _float_predict(seg: np.ndarray) -> bytes:
    """Predictor 3 of a [h, w, s] float segment: each row's values as
    byte planes, most significant first, then byte differences at a
    stride of s (`tif_predict.c:fpDiff`)."""
    h, w, s = seg.shape
    size = seg.dtype.itemsize
    be = seg.astype(seg.dtype.newbyteorder('>')).reshape(h, w * s)
    planes = be.view(np.uint8).reshape(h, w * s, size).transpose(0, 2, 1)
    row = planes.reshape(h, size * w * s).astype(np.int16)
    diff = row.copy()
    diff[:, s:] = row[:, s:] - row[:, :-s]
    return (diff & 0xFF).astype(np.uint8).tobytes()


def _int_predict(seg: np.ndarray) -> np.ndarray:
    """Predictor 2: horizontal differences of each sample, wrapping."""
    d = seg.copy()
    d[:, 1:] = seg[:, 1:] - seg[:, :-1]
    return d


def _raw(seg: np.ndarray, bits: int, order: str, predictor: int) -> bytes:
    """A segment's bytes before compression."""
    if predictor == 3:
        return _float_predict(seg)
    if predictor == 2:              # integer differences, floats' bits too
        seg = _int_predict(seg.view(f'u{seg.dtype.itemsize}')
                           if seg.dtype.kind == 'f' else seg)
    h, w, s = seg.shape
    if bits < 8:
        return _pack_bits(seg.reshape(h, w * s), bits).tobytes()
    return seg.astype(seg.dtype.newbyteorder(order)).tobytes()


def _jpeg_segment(seg: np.ndarray, photometric: int, tables: bool) -> bytes:
    """One strip or tile as a JPEG stream from the port's coder: YCbCr
    4:2:0 from RGB samples (photometric 6), grey (1), or three components
    coded as they are (RGB, 2). Without `tables` the stream is
    abbreviated (its tables go in JPEGTables)."""
    import torch
    from hrfuser_tpu_torch.data import jpeg
    h, w, s = seg.shape
    luma_q, chroma_q = jpeg.quality_tables()
    zz = list(jpeg.ZIGZAG)
    if photometric == 6:
        blocks, comps = jpeg.encode_blocks(torch.from_numpy(
            np.ascontiguousarray(seg[..., ::-1])))
        ids = [(1, 0x22, 0), (2, 0x11, 1), (3, 0x11, 1)]
    elif s == 1:
        blocks, comps = jpeg.encode_blocks(torch.from_numpy(
            np.ascontiguousarray(seg[..., 0])))
        ids = [(1, 0x11, 0)]
    else:                                      # components as they are
        zig = torch.as_tensor(jpeg.ZIGZAG)
        per = []
        for c in range(s):
            plane = jpeg._replicate(torch.from_numpy(
                np.ascontiguousarray(seg[..., c])).to(torch.int64) - 128,
                -(-h // 8) * 8, -(-w // 8) * 8)
            per.append(jpeg._blocks(plane, luma_q if c == 0 else chroma_q
                                    ).reshape(-1, 64))
        blocks = torch.stack(per, 1).reshape(-1, 64)[:, zig].to(torch.int16)
        comps = tuple(range(s))
        ids = [(c, 0x11, 0 if c == 0 else 1) for c in range(s)]
    seg_ = jpeg._segment
    table_part = b''
    for i, t in enumerate([luma_q, chroma_q][:1 if s == 1 else 2]):
        table_part += seg_(0xDB, bytes([i]) + bytes(int(v) for v in t[zz]))
    for body in jpeg._DHT[:2 if s == 1 else 4]:
        table_part += seg_(0xC4, body)
    frame = bytes([8]) + h.to_bytes(2, 'big') + w.to_bytes(2, 'big')
    frame += bytes([len(ids)]) + b''.join(bytes(c) for c in ids)
    scan = bytes([len(ids)]) + b''.join(
        bytes([c[0], 0x00 if c[2] == 0 else 0x11]) for c in ids)
    body = jpeg.encode_scan(blocks.numpy(), comps)
    return (b'\xff\xd8' + (table_part if tables else b'')
            + seg_(0xC0, frame) + seg_(0xDA, scan + b'\x00\x3f\x00') + body
            + b'\xff\xd9')


def jpeg_tables(grey: bool) -> bytes:
    """The JPEGTables (tag 347) stream of `_jpeg_segment`'s abbreviated
    streams: SOI, the quantisation and Huffman tables, EOI."""
    from hrfuser_tpu_torch.data import jpeg
    luma_q, chroma_q = jpeg.quality_tables()
    zz = list(jpeg.ZIGZAG)
    out = b'\xff\xd8'
    for i, t in enumerate([luma_q] if grey else [luma_q, chroma_q]):
        out += jpeg._segment(0xDB, bytes([i]) + bytes(int(v) for v in t[zz]))
    for body in jpeg._DHT[:2 if grey else 4]:
        out += jpeg._segment(0xC4, body)
    return out + b'\xff\xd9'


def _compress(raw: bytes, compression: int) -> bytes:
    if compression == 1:
        return raw
    if compression == 5:
        return _offline_data().lzw_encode(raw)
    if compression in (8, 32946):
        return zlib.compress(raw, 6)
    if compression == 32773:
        return packbits(raw)
    if compression == 34925:
        return lzma.compress(raw)
    raise ValueError(f'the writer has no compression {compression}')


def _reverse_bits(data: bytes) -> bytes:
    table = np.array([int(f'{i:08b}'[::-1], 2) for i in range(256)],
                     np.uint8)
    return table[np.frombuffer(data, np.uint8)].tobytes()


def _entry(order: str, big: bool, tag: int, kind: int, values):
    """(tag, packed entry head, value bytes)."""
    if kind == 2:
        raw = values if isinstance(values, bytes) else values.encode()
        if not raw.endswith(b'\0'):
            raw += b'\0'
        count = len(raw)
    else:
        values = list(values) if isinstance(values, (list, tuple)) else [
            values]
        fmt = _TYPES[kind]
        count = len(values) if kind not in (5, 10) else len(values) // 2
        raw = struct.pack(order + fmt[0] * (count * len(fmt)), *values)
    return tag, kind, count, raw


def tiff(samples: np.ndarray, bits: Optional[int] = None,
         photometric: Optional[int] = None, compression: int = 1,
         predictor: int = 1, planar: int = 1,
         tile: Optional[Tuple[int, int]] = None, rows: Optional[int] = None,
         order: str = '<', big: bool = False,
         sample_format: Optional[int] = None, extra: Sequence[int] = (),
         colormap: Optional[np.ndarray] = None,
         orientation: Optional[int] = None, fill_order: int = 1,
         jpeg: str = 'abbreviated', tags: Sequence = (), drop: Sequence = (),
         pages: int = 1) -> bytes:
    """A TIFF of `samples` ([H, W] or [H, W, S], in the order the file
    stores them: RGB, CMYK, indices, ...), `extra` naming the ExtraSamples
    (tag 338) of the last samples. `bits` defaults to the dtype's; below
    8, `samples` holds values under 2^bits. `tile` = (height, width) of
    tiles (zero-padded at the edges), else strips of `rows` rows. `jpeg`:
    'abbreviated' (tables in tag 347) or 'whole' streams. `tags`: (tag,
    type, values) entries added or replacing the writer's; `drop`: tags
    left out. `pages` > 1 appends pages of other sizes after the first."""
    a = np.asarray(samples)
    if a.ndim == 2:
        a = a[..., None]
    h, w, s = a.shape
    kind = a.dtype.kind
    bits = bits or a.dtype.itemsize * 8
    if sample_format is None:
        sample_format = {'u': 1, 'i': 2, 'f': 3}[kind]
    if photometric is None:
        photometric = 1 if s - len(extra) == 1 else 2
    planes = [a] if planar == 1 else [a[..., c:c + 1] for c in range(s)]
    if tile:
        th, tw = tile
        grid = [(y, x) for y in range(0, h, th) for x in range(0, w, tw)]
    else:
        th, tw = (rows or h), w
        grid = [(y, 0) for y in range(0, h, th)]
    chunks = []
    for plane in planes:
        for y, x in grid:
            seg = plane[y:y + th, x:x + tw]
            if tile:
                pad = np.zeros((th, tw, plane.shape[2]), plane.dtype)
                pad[:seg.shape[0], :seg.shape[1]] = seg
                if compression == 7:          # edges repeated, as libjpeg
                    pad[seg.shape[0]:, :seg.shape[1]] = seg[-1:]
                    pad[:, seg.shape[1]:] = pad[:, seg.shape[1] - 1:
                                                seg.shape[1]]
                seg = pad
            if compression == 7:
                body = _jpeg_segment(seg, photometric, jpeg == 'whole')
            else:
                body = _compress(_raw(seg, bits, order, predictor),
                                 compression)
            if fill_order == 2:
                body = _reverse_bits(body)
            chunks.append(body)
    long_ = 16 if big else 4
    entries = {
        256: (4, w), 257: (4, h), 258: (3, [bits] * s),
        259: (3, compression), 262: (3, photometric), 277: (3, s),
        284: (3, planar)}
    if tile:
        entries.update({322: (4, tw), 323: (4, th),
                        324: (long_, [0] * len(chunks)),
                        325: (long_, [len(c) for c in chunks])})
    else:
        entries.update({273: (long_, [0] * len(chunks)), 278: (4, th),
                        279: (long_, [len(c) for c in chunks])})
    if predictor != 1:
        entries[317] = (3, predictor)
    if sample_format != 1:
        entries[339] = (3, [sample_format] * s)
    if extra:
        entries[338] = (3, list(extra))
    if colormap is not None:
        entries[320] = (3, [int(v) for v in np.asarray(colormap).T.reshape(
            -1)])
    if orientation is not None:
        entries[274] = (3, orientation)
    if fill_order != 1:
        entries[266] = (3, fill_order)
    if compression == 7:
        if photometric == 6:
            entries[530] = (3, [2, 2])
        if jpeg == 'abbreviated':
            entries[347] = (7, list(jpeg_tables(s == 1)))
    entries[282] = (5, [72, 1])
    entries[283] = (5, [72, 1])
    entries[296] = (3, 2)
    entries[305] = (2, 'tests/oracles/tiff_files.py')
    for tag, kind_, values in tags:
        entries[tag] = (kind_, values)
    for tag in drop:
        entries.pop(tag, None)
    return _assemble(order, big, chunks, entries,
                     [_other_page(a, p) for p in range(1, pages)])


def _other_page(a: np.ndarray, p: int):
    """A later page: another size, other values, uncompressed strips."""
    small = (np.asarray(a[::2, ::3]) + p).astype(a.dtype)
    hh, ww, s = small.shape
    entries = {256: (4, ww), 257: (4, hh),
               258: (3, [small.dtype.itemsize * 8] * s), 259: (3, 1),
               262: (3, 1 if s == 1 else 2), 277: (3, s), 273: (4, [0]),
               278: (4, hh)}
    return small, entries


def _assemble(order, big, chunks, entries, later) -> bytes:
    """Header, the data chunks, then each page's IFD and its values."""
    head = (b'II' if order == '<' else b'MM') + (
        struct.pack(order + 'HHHQ', 43, 8, 0, 0) if big
        else struct.pack(order + 'HI', 42, 0))
    out = bytearray(head)
    pages = [(chunks, entries)]
    for small, e in later:
        raw = small.astype(small.dtype.newbyteorder(order)).tobytes()
        e = dict(e)
        e[279] = (4, [len(raw)])
        pages.append(([raw], e))
    ifd_slots = []                 # where each page's IFD offset goes
    slot = 8 if big else 4
    for chunks_, e in pages:
        offsets = []
        for c in chunks_:
            offsets.append(len(out))
            out += c
            if len(out) % 2:
                out += b'\0'
        off_tag = 324 if 324 in e else 273
        if off_tag in e:
            e[off_tag] = (e[off_tag][0], offsets)
        ptr = 8 if big else 4
        inline = 8 if big else 4
        built = [_entry(order, big, t, k, v) for t, (k, v) in sorted(
            e.items())]
        ifd = len(out)
        struct.pack_into(order + ('Q' if big else 'I'), out, slot, ifd)
        n = len(built)
        size = (8 if big else 2) + n * (20 if big else 12) + ptr
        out += bytes(size)
        extra_at = len(out)
        blob = bytearray()
        pos = ifd + (8 if big else 2)
        struct.pack_into(order + ('Q' if big else 'H'), out, ifd, n)
        for tag, kind, count, raw in built:
            struct.pack_into(order + ('HHQ' if big else 'HHI'), out, pos,
                             tag, kind, count)
            vpos = pos + (12 if big else 8)
            if len(raw) <= inline:
                out[vpos:vpos + len(raw)] = raw
            else:
                where = extra_at + len(blob)
                struct.pack_into(order + ('Q' if big else 'I'), out, vpos,
                                 where)
                blob += raw
                if len(blob) % 2:
                    blob += b'\0'
            pos += 20 if big else 12
        slot = pos
        out += blob
    return bytes(out)


# ------------------------------------------------------------ the variants


def _image(rng, hw, channels=3, top=256, dtype=np.uint8):
    """Smooth ramps plus noise: strips that compress, and every value."""
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 5 + yy, yy * 7, (xx + yy) * 3, xx * yy][:channels],
                    -1) * (top // 256 or 1)
    noise = rng.integers(0, max(2, top // 16), (h, w, channels))
    return ((base + noise) % top).astype(dtype)


def _palette(rng, bits, wide):
    return rng.integers(0, 65536 if wide else 256, (1 << bits, 3)).astype(
        np.uint16)


def variants(rng: np.random.Generator,
             hw: Tuple[int, int] = (37, 53)) -> Dict[str, bytes]:
    """One file of each kind the port reads, named. 37x53 leaves edge
    tiles and a short last strip at every tile and strip size used."""
    rgb = _image(rng, hw)
    rgb16 = _image(rng, hw, top=65536, dtype=np.uint16)
    rgba = _image(rng, hw, 4)
    grey = rgb[..., 0]
    grey16 = rgb16[..., 1]
    bits1 = (rgb[..., 1] > 128).astype(np.uint8)
    v = {
        'grey 8-bit': tiff(grey),
        'grey 8-bit min-is-white LZW': tiff(grey, photometric=0,
                                            compression=5, rows=8),
        'grey 16-bit LZW predictor 2 big-endian': tiff(
            grey16, compression=5, predictor=2, rows=5, order='>'),
        'grey 16-bit Deflate tiles': tiff(grey16, compression=8,
                                          tile=(16, 32)),
        'grey 16-bit min-is-white PackBits': tiff(
            grey16, photometric=0, compression=32773, rows=7),
        'grey 16-bit three samples': tiff(rgb16, photometric=1,
                                          compression=5),
        'grey + alpha 8-bit tiles': tiff(rgba[..., :2], extra=[2],
                                         compression=8, tile=(16, 16)),
        'grey + alpha 16-bit': tiff(rgb16[..., :2], extra=[1],
                                    compression=5),
        'bilevel 1-bit PackBits': tiff(bits1, bits=1, compression=32773),
        'bilevel 1-bit min-is-white tiles': tiff(
            bits1, bits=1, photometric=0, compression=5, tile=(16, 32)),
        'palette 1-bit': tiff(bits1, bits=1, photometric=3,
                              colormap=_palette(rng, 1, True)),
        'palette 4-bit tiles': tiff(grey >> 4, bits=4, photometric=3,
                                    colormap=_palette(rng, 4, False),
                                    compression=5, tile=(16, 16)),
        'palette 8-bit 16-bit map': tiff(grey, photometric=3,
                                         colormap=_palette(rng, 8, True),
                                         compression=5),
        'palette 8-bit 8-bit map': tiff(grey, photometric=3,
                                        colormap=_palette(rng, 8, False),
                                        compression=32773),
        'rgb 8-bit': tiff(rgb),
        'rgb 8-bit LZW predictor 2 strips': tiff(rgb, compression=5,
                                                 predictor=2, rows=6),
        'rgb 8-bit Deflate tiles': tiff(rgb, compression=8, tile=(32, 32)),
        'rgb 8-bit Adobe Deflate predictor 2 tiles big-endian': tiff(
            rgb, compression=32946, predictor=2, tile=(16, 48), order='>'),
        'rgb 8-bit PackBits planar': tiff(rgb, compression=32773, planar=2,
                                          rows=9),
        'rgb 8-bit LZW planar tiles': tiff(rgb, compression=5, planar=2,
                                           tile=(16, 16)),
        'rgb 8-bit uncompressed tiles': tiff(rgb, tile=(32, 32)),
        'rgb 8-bit predictor 2 uncompressed (ignored)': tiff(
            rgb, predictor=2, rows=4),
        'rgb 8-bit fill order 2 LZW': tiff(rgb, compression=5,
                                           fill_order=2, rows=8),
        'rgb 8-bit BigTIFF': tiff(rgb, big=True, compression=5),
        'rgb 8-bit BigTIFF big-endian tiles': tiff(
            rgb, big=True, order='>', compression=8, tile=(16, 32)),
        'rgb 8-bit three pages': tiff(rgb, pages=3, compression=5),
        'rgb 16-bit LZW predictor 2': tiff(rgb16, compression=5,
                                           predictor=2, rows=8),
        'rgb 16-bit Deflate tiles': tiff(rgb16, compression=8,
                                         tile=(16, 16)),
        'rgba 8-bit associated': tiff(rgba, extra=[1], compression=5),
        'rgba 8-bit unassociated': tiff(rgba, extra=[2], compression=5),
        'rgba 8-bit unspecified': tiff(rgba, extra=[0], compression=8),
        'rgba 8-bit no ExtraSamples': tiff(rgba, drop=[338]),
        'rgba 8-bit unassociated planar tiles': tiff(
            rgba, extra=[2], planar=2, compression=5, tile=(16, 32)),
        'rgba 16-bit unassociated': tiff(
            _image(rng, hw, 4, 65536, np.uint16), extra=[2], compression=5),
        'cmyk 8-bit': tiff(rgba, photometric=5, compression=5),
        'cmyk 8-bit planar tiles': tiff(rgba, photometric=5, planar=2,
                                        compression=8, tile=(16, 16)),
    }
    for dtype in (np.int8, np.int16, np.int32, np.uint32, np.float32,
                  np.float64, np.int64, np.uint64):
        for c in ((1, 3, 4) if dtype in (np.int8, np.int16, np.int32,
                                         np.float32, np.float64) else (3,)):
            a = rng.normal(0, 60, hw + (c,)) * (
                1 if np.dtype(dtype).kind == 'f' else 1000 if np.dtype(
                    dtype).itemsize > 1 else 1)
            a = a.astype(dtype)
            pred = 3 if np.dtype(dtype).kind == 'f' else 2
            name = f'{np.dtype(dtype).name} {c} samples'
            v[name] = tiff(a, extra=[2] if c == 4 else [], compression=8,
                           predictor=pred, rows=10)
    v['float32 3 samples predictor 2'] = tiff(
        rng.normal(0, 1, hw + (3,)).astype(np.float32), compression=5,
        predictor=2)
    v['float64 tiles big-endian'] = tiff(
        rng.normal(0, 1, hw).astype(np.float64), compression=5,
        predictor=3, tile=(16, 16), order='>')
    for o in range(1, 9):
        v[f'rgb 8-bit orientation {o}'] = tiff(rgb, orientation=o, rows=8,
                                               compression=5)
    for o in (2, 6, 7):
        v[f'rgb 8-bit tiles orientation {o}'] = tiff(
            rgb, orientation=o, tile=(16, 32), compression=8)
    v['grey 16-bit tiles orientation 3'] = tiff(grey16, orientation=3,
                                                tile=(16, 16), compression=5)
    v['grey 16-bit orientation 6'] = tiff(grey16, orientation=6,
                                          compression=5)
    v['float32 orientation 8'] = tiff(rng.normal(0, 1, hw).astype(
        np.float32), orientation=8)
    v['jpeg YCbCr strips'] = tiff(rgb, photometric=6, compression=7,
                                  rows=16)
    v['jpeg YCbCr tiles big-endian'] = tiff(rgb, photometric=6,
                                            compression=7, tile=(16, 32),
                                            order='>')
    v['jpeg YCbCr whole streams BigTIFF'] = tiff(
        rgb, photometric=6, compression=7, rows=32, jpeg='whole', big=True)
    v['jpeg RGB strips'] = tiff(rgb, photometric=2, compression=7, rows=8)
    v['jpeg grey tiles'] = tiff(grey, compression=7, tile=(16, 16))
    v['jpeg YCbCr orientation 6'] = tiff(rgb, photometric=6, compression=7,
                                         rows=16, orientation=6)
    return v


def refused(rng: np.random.Generator,
            hw: Tuple[int, int] = (37, 53)) -> Dict[str, bytes]:
    """Files `cv2` 5.0 returns None for, in every mode."""
    rgb = _image(rng, hw)
    grey = rgb[..., 0]
    return {
        'LZMA (cv2 built without it)': tiff(rgb, compression=34925),
        'ZSTD (cv2 built without it)': tiff(grey, tags=[(259, 3, 50000)]),
        'WebP (cv2 built without it)': tiff(grey, tags=[(259, 3, 50001)]),
        'old-style JPEG (cv2 built without it)': tiff(
            grey, tags=[(259, 3, 6)]),
        'float16': tiff(rng.normal(0, 1, hw).astype(np.float16)),
        '2-bit grey': tiff(grey >> 6, bits=2),
        '4-bit grey': tiff(grey >> 4, bits=4),
        '2-bit palette': tiff(grey >> 6, bits=2, photometric=3,
                              colormap=_palette(rng, 2, False)),
        'rgb + 2 extra samples': tiff(_image(rng, hw, 4)[..., [0, 1, 2, 3, 3]],
                                      extra=[2, 0]),
        'cmyk 16-bit': tiff(_image(rng, hw, 4, 65536, np.uint16),
                            photometric=5),
        'cmyk 3 samples': tiff(rgb, photometric=5),
        'cmyk ink set 2': tiff(_image(rng, hw, 4), photometric=5,
                               tags=[(332, 3, 2)]),
        'float32 grey + alpha': tiff(rng.normal(0, 1, hw + (2,)).astype(
            np.float32), extra=[2]),
        'LZW predictor 2 on 1-bit samples': tiff(
            (grey > 128).astype(np.uint8), bits=1, compression=5,
            predictor=2),
        'jpeg fill order 2': tiff(rgb, photometric=6, compression=7,
                                  rows=16, fill_order=2),
    }


def camera_frames(img: np.ndarray) -> Dict[str, Tuple[bytes, np.ndarray,
                                                       np.ndarray]]:
    """A BGR camera frame in each main variant: name -> (bytes, what
    'unchanged' must read, what 'color' must read; 'grayscale' is
    `cvt.bgr_to_grey` of the latter). JPEG's pixels are its decoder's: the
    entries for it hold None. Only the first is LZW (the oracle's encoder
    is Python, about half a second a megabyte); the rest Deflate, PackBits
    and JPEG."""
    rgb = np.ascontiguousarray(img[..., ::-1])
    wide = rgb.astype(np.uint16) * 257
    cube = np.round(rgb.astype(np.float32) * 5 / 255).astype(np.uint8)
    idx = (cube[..., 0] * 36 + cube[..., 1] * 6 + cube[..., 2]).astype(
        np.uint8)
    levels = np.arange(6) * 51
    cmap = np.zeros((256, 3), np.uint16)
    cmap[:216] = np.stack(np.meshgrid(levels, levels, levels,
                                      indexing='ij'), -1).reshape(-1, 3)
    quant = cmap[idx].astype(np.uint8)[..., ::-1]
    h, w = img.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    alpha = (96 + (xx + yy) % 160).astype(np.uint8)
    rgba = np.dstack([rgb, alpha])
    pre = ((img.astype(np.int64) * alpha[..., None] + 127) // 255).astype(
        np.uint8)
    bgra = np.dstack([img, np.full((h, w), 255, np.uint8)])
    return {
        'LZW predictor 2 RGB strips': (
            tiff(rgb, compression=5, predictor=2, rows=16), img, img),
        'Deflate tiles': (tiff(rgb, compression=8, tile=(256, 256)), img,
                          img),
        'PackBits planar': (tiff(rgb, compression=32773, planar=2,
                                 rows=32), img, img),
        'JPEG YCbCr tiles': (tiff(rgb, photometric=6, compression=7,
                                  tile=(256, 256)), None, None),
        '16-bit RGB': (tiff(wide, compression=8, predictor=2, rows=16),
                       wide[..., ::-1], img),
        'palette': (tiff(idx, photometric=3, colormap=cmap,
                         compression=32773, rows=16), quant, quant),
        'CMYK': (tiff(np.dstack([255 - rgb, np.zeros((h, w), np.uint8)]),
                      photometric=5, compression=8, rows=16), bgra, img),
        'RGBA unassociated': (tiff(rgba, extra=[2], compression=8,
                                   rows=16), np.dstack([pre, alpha]), pre),
    }
