"""TIFF decoding in numpy, in place of `cv2.imread(path,
IMREAD_UNCHANGED)` for the STF gated raw frames.

The card's machine has no `cv2`. What `cv2` writes for a uint16 grey
frame is little-endian, LZW compressed (tag 259 = 5) with the horizontal
predictor (tag 317 = 2), in strips of a few rows. This reader takes what
such files need and no more: the first image of the file, grey (one
sample a pixel, black is zero), 8 or 16 bits unsigned, in strips,
uncompressed or LZW, predictor 1 or 2, either byte order. Anything else
raises `ValueError` naming the tag and its value. LZW is decoded in a few
whole-array passes over all strips (`_lzw_expand`), not code by code.

`imdecode(data)` returns uint8 or uint16 [H, W], as `cv2` does.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

_TYPE_FORMAT = {1: 'B', 3: 'H', 4: 'I'}          # BYTE, SHORT, LONG
_TAG_NAMES = {256: 'ImageWidth', 257: 'ImageLength', 258: 'BitsPerSample',
              259: 'Compression', 262: 'PhotometricInterpretation',
              266: 'FillOrder', 273: 'StripOffsets', 277: 'SamplesPerPixel',
              278: 'RowsPerStrip', 279: 'StripByteCounts',
              284: 'PlanarConfiguration', 317: 'Predictor',
              322: 'TileWidth', 339: 'SampleFormat'}
# tag: the values read; a missing tag takes the first (TIFF 6.0 default)
_ALLOWED = {258: (8, 16), 259: (1, 5), 262: (1,), 266: (1,), 277: (1,),
            284: (1,), 317: (1, 2), 339: (1,)}
_CLEAR, _EOI = 256, 257
# code k of a run (the codes after a Clear code) is 9 bits wide for
# k < 254, then 10, 11, and 12 from k = 1790 on: libtiff widens one code
# before the table needs it
_RUN_WIDTHS = np.repeat(np.array([9, 10, 11, 12], np.int64),
                        [254, 512, 1024, 2306])
_TAIL_WIDTHS = np.full(4096, 12, np.int64)


def _refuse(tag: int, value) -> ValueError:
    return ValueError(f'TIFF tag {tag} ({_TAG_NAMES[tag]}) = {value}: '
                      f'only grey 8- or 16-bit unsigned strips, '
                      f'uncompressed or LZW, predictor 1 or 2 are read')


def _tags(data: bytes, order: str) -> Dict[int, List[int]]:
    """The integer tags of the first image file directory."""
    (ifd,) = struct.unpack(order + 'I', data[4:8])
    (n,) = struct.unpack(order + 'H', data[ifd:ifd + 2])
    tags = {}
    for i in range(n):
        pos = ifd + 2 + 12 * i
        tag, kind, count = struct.unpack(order + 'HHI', data[pos:pos + 8])
        if kind not in _TYPE_FORMAT:
            continue                        # rationals, text: never needed
        fmt = order + _TYPE_FORMAT[kind] * count
        size = struct.calcsize(fmt)
        if size <= 4:
            raw = data[pos + 8:pos + 8 + size]
        else:
            (off,) = struct.unpack(order + 'I', data[pos + 8:pos + 12])
            raw = data[off:off + size]
        if len(raw) != size:
            raise ValueError(f'truncated TIFF: tag {tag}')
        tags[tag] = list(struct.unpack(fmt, raw))
    return tags


def _lzw_runs(data: bytes) -> Tuple[List[np.ndarray],
                                     Optional[Tuple[int, int]]]:
    """Split one strip's LZW stream into runs of codes, each decoded with
    a fresh table: the codes from the start or a Clear code up to the
    next Clear code. Reading stops at the end-of-information code, at the
    data's end, or at an invalid code (one past the table), which is
    returned as (code, table size) beside the runs before it."""
    buf = np.frombuffer(data + b'\0\0\0', np.uint8).astype(np.int64)
    end = len(data) * 8
    runs, run, pos, k0 = [], [], 0, 0
    while True:
        widths = _RUN_WIDTHS if k0 == 0 else _TAIL_WIDTHS
        stops = pos + np.cumsum(widths)
        n = int(np.searchsorted(stops, end, side='right'))
        starts = stops[:n] - widths[:n]
        i = starts >> 3
        word = (buf[i] << 16) | (buf[i + 1] << 8) | buf[i + 2]
        codes = ((word >> (24 - widths[:n] - (starts & 7)))
                 & ((1 << widths[:n]) - 1))
        # before code k of a run the table holds max(258, 257 + k)
        # entries; a code may also name the entry it is about to make
        k = k0 + np.arange(n)
        invalid = (codes >= 258) & (codes > 257 + k)
        hit = np.flatnonzero(invalid | (codes == _CLEAR) | (codes == _EOI))
        t = int(hit[0]) if hit.size else n
        run.append(codes[:t])
        if t == n == len(widths):                 # the run goes on
            pos, k0 = int(stops[-1]), k0 + n
            continue
        runs.append(np.concatenate(run))
        if t == n or codes[t] == _EOI:
            return runs, None
        if invalid[t]:
            return runs, (int(codes[t]), max(258, 257 + int(k[t])))
        pos, run, k0 = int(stops[t]), [], 0      # Clear: a fresh table


def _lzw_expand(runs: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """The bytes that runs of valid codes stand for, concatenated, and
    each run's count of them.

    Entry e >= 258 of a run's table is made at its code e - 257: the
    string of code e - 258 and the first byte of the next one. So code k
    naming it stands for a copy of code e - 258's output and the byte
    after it, one byte longer, and every output byte is a literal
    code's byte or a copy of an earlier one. Both chains (lengths
    through the codes, bytes through their sources) are followed by
    pointer doubling, a few whole-array passes in place of one Python
    step per code.
    """
    sizes = np.array([len(r) for r in runs], np.int64)
    codes = np.concatenate(runs) if runs else np.zeros(0, np.int64)
    copy = codes >= 258
    run_start = np.repeat(np.cumsum(sizes) - sizes, sizes)
    parent = np.where(copy, codes - 258 + run_start, np.arange(codes.size))
    length, p = copy.astype(np.int64), parent      # steps to p
    while True:
        pp = p[p]
        if np.array_equal(pp, p):
            break
        length = length + length[p]
        p = pp
    length += 1
    start = np.cumsum(length) - length
    total = int(length.sum())
    src = np.repeat(start[parent] - start, length) + np.arange(total)
    while True:
        ss = src[src]
        if np.array_equal(ss, src):
            break
        src = ss
    literal = np.zeros(total, np.uint8)
    literal[start[~copy]] = codes[~copy]
    ends = np.concatenate([[0], np.cumsum(length)])
    return literal[src], np.diff(ends[np.concatenate([[0], np.cumsum(sizes)])])


def _lzw_decode(strips: List[bytes], sizes: List[int]) -> List[np.ndarray]:
    """TIFF LZW strips (MSB-first codes of 9-12 bits, the width growing
    one code early, as libtiff writes) into at most `sizes` bytes each."""
    runs, owner, bad = [], [], {}
    for s, body in enumerate(strips):
        r, b = _lzw_runs(body)
        runs += r
        owner += [s] * len(r)
        if b is not None:
            bad[s] = b
    out, run_bytes = _lzw_expand(runs)
    per_strip = np.bincount(np.array(owner, np.int64), run_bytes,
                            len(strips)).astype(np.int64)
    ends = np.cumsum(per_strip)
    parts = []
    for s, size in enumerate(sizes):
        part = out[ends[s] - per_strip[s]:ends[s]]
        if len(part) < size and s in bad:
            raise ValueError(f'corrupt TIFF LZW data: code {bad[s][0]} '
                             f'with {bad[s][1]} table entries')
        parts.append(part[:size])
    return parts


def imdecode(data: bytes) -> np.ndarray:
    """Decode a TIFF byte string (see the module docstring)."""
    order = {b'II': '<', b'MM': '>'}.get(data[:2])
    if order is None:
        raise ValueError('not a TIFF file')
    (magic,) = struct.unpack(order + 'H', data[2:4])
    if magic != 42:
        raise ValueError(f'TIFF version {magic}: only classic TIFF (42) '
                         f'is read, not BigTIFF')
    tags = _tags(data, order)
    if 322 in tags:
        raise _refuse(322, tags[322][0])
    for tag, allowed in _ALLOWED.items():
        value = tags.get(tag, [allowed[0]])
        if tag == 258 and len(set(value)) == 1:
            value = value[:1]
        if len(value) != 1 or value[0] not in allowed:
            raise _refuse(tag, value[0] if len(value) == 1 else value)
    try:
        w, h = tags[256][0], tags[257][0]
        offsets = tags[273]
    except KeyError as e:
        raise ValueError(f'TIFF without tag {e.args[0]} '
                         f'({_TAG_NAMES[e.args[0]]})') from None
    bits, compression = tags[258][0], tags[259][0]
    nbytes = bits // 8
    rows = min(tags.get(278, [h])[0], h)
    strip = rows * w * nbytes
    counts = tags.get(279)
    if counts is None:
        if compression != 1:
            raise ValueError('TIFF tag 279 (StripByteCounts) missing')
        counts = [strip] * len(offsets)
    if len(offsets) != -(-h // rows) or len(counts) != len(offsets):
        raise ValueError(f'TIFF with {len(offsets)} strip offsets and '
                         f'{len(counts)} byte counts for {h} rows of '
                         f'{rows}')
    wants = [min(rows, h - k * rows) * w * nbytes
             for k in range(len(offsets))]
    parts = [data[off:off + count] for off, count in zip(offsets, counts)]
    parts = (_lzw_decode(parts, wants) if compression == 5
             else [np.frombuffer(p, np.uint8) for p in parts])
    for k, (body, want) in enumerate(zip(parts, wants)):
        if len(body) < want:
            raise ValueError(f'TIFF strip {k} holds {len(body)} of its '
                             f'{want} bytes')
    img = np.concatenate([p[:want] for p, want in zip(parts, wants)])
    dtype = np.dtype(np.uint8 if nbytes == 1 else order + 'u2')
    img = img.view(dtype).reshape(h, w)
    if tags.get(317, [1])[0] == 2:                  # horizontal differences
        return np.cumsum(img, axis=1, dtype=img.dtype.newbyteorder('='))
    return img.astype(img.dtype.newbyteorder('='))


def imread(path: str) -> np.ndarray:
    """`imdecode` of the file at `path`."""
    with open(path, 'rb') as f:
        return imdecode(f.read())
