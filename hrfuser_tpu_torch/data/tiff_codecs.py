"""TIFF's compressions and predictors in numpy, as libtiff 4.7 (the TIFF
reader `cv2` 5.0 bundles) decodes them, one function each.

  * `lzw_decode` (compression 5): MSB-first codes of 9-12 bits, the width
    growing one code early, as libtiff writes; decoded in a few
    whole-array passes over all strips (`_lzw_runs`, `_lzw_expand`), not
    code by code.
  * `packbits_decode` (32773): Macintosh run lengths (one pass over the
    run headers, then one gather for the bytes).
  * `deflate_decode` (8 and 32946): `zlib`.
  * `predict(...)`: predictor 2 (horizontal differences of each sample,
    at 8, 16, 32 and 64 bits) and 3 (floating point: byte planes, most
    significant first, then byte differences). libtiff applies a
    predictor only under LZW and Deflate, the codecs that set one up:
    uncompressed and PackBits data ignore the tag (`PREDICTED`).
  * `reverse_bits(data)`: FillOrder 2.
  * `jpeg_stream(data, tables)`: one strip's or tile's JPEG stream with
    the JPEGTables (tag 347) spliced in before its frame; the port's own
    decoder (`data/jpeg.py`) reads it.

Every step is numpy on the host, as libtiff runs them on the host for
`cv2`; none stands for a TPU kernel.
"""

from __future__ import annotations

import zlib
from typing import List, Optional, Tuple

import numpy as np

PREDICTED = (5, 8, 32946)           # the codecs libtiff gives a predictor
_REVERSED = np.array([int(f'{i:08b}'[::-1], 2) for i in range(256)],
                     np.uint8)
_CLEAR, _EOI = 256, 257
# code k of a run (the codes after a Clear code) is 9 bits wide for
# k < 254, then 10, 11, and 12 from k = 1790 on: libtiff widens one code
# before the table needs it
_RUN_WIDTHS = np.repeat(np.array([9, 10, 11, 12], np.int64),
                        [254, 512, 1024, 2306])
_TAIL_WIDTHS = np.full(4096, 12, np.int64)


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


def reverse_bits(data: bytes) -> bytes:
    """FillOrder 2: each byte's bits in reverse order (libtiff reverses
    the raw data before any codec but JPEG sees it)."""
    return _REVERSED[np.frombuffer(data, np.uint8)].tobytes()


def lzw_decode(strips: List[bytes], sizes: List[int]) -> List[np.ndarray]:
    """TIFF LZW strips into at most `sizes` bytes each (uint8 arrays); a
    strip that holds an invalid code before its size raises."""
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


def packbits_decode(data: bytes, size: int) -> np.ndarray:
    """PackBits into at most `size` bytes: a header byte n < 128 copies
    the next n + 1 bytes, n > 128 repeats the next byte 257 - n times,
    128 is skipped. The headers are found in one pass over the bytes,
    the output made by one gather."""
    heads, pos, end = [], 0, len(data)
    while pos < end:
        heads.append(pos)
        c = data[pos]
        pos += c + 2 if c < 128 else 1 if c == 128 else 2
    a = np.frombuffer(data, np.uint8)
    heads = np.array(heads, np.int64)
    n = a[heads].astype(np.int64)
    literal = n < 128
    count = np.where(literal, n + 1, np.where(n == 128, 0, 257 - n))
    total = int(count.sum())
    rel = np.arange(total) - np.repeat(np.cumsum(count) - count, count)
    idx = np.repeat(heads + 1, count) + np.where(np.repeat(literal, count),
                                                 rel, 0)
    return a[idx[idx < end]][:size]


def deflate_decode(data: bytes, size: int) -> np.ndarray:
    """zlib (Adobe and old-style Deflate) into at most `size` bytes; a
    stream that breaks off or is damaged raises."""
    try:
        out = zlib.decompressobj().decompress(data, size)
    except zlib.error as e:
        raise ValueError(f'corrupt TIFF Deflate data: {e}') from None
    return np.frombuffer(out, np.uint8)


def predict(raw: np.ndarray, predictor: int, rows: int, cols: int,
            spp: int, dtype: np.dtype) -> np.ndarray:
    """Undo predictor 2 or 3 on one segment's bytes (`rows` rows of
    `cols` pixels of `spp` samples of `dtype`, in the file's byte order):
    the samples [rows, cols, spp] in native order."""
    size = dtype.itemsize
    if predictor == 3:
        # byte planes, most significant first, differenced at a stride of
        # spp bytes along the row (the file's byte order does not enter)
        b = raw.reshape(rows, size * cols * spp)
        b = np.cumsum(b.reshape(rows, -1, spp), axis=1,
                      dtype=np.uint8).reshape(rows, size, cols * spp)
        be = np.ascontiguousarray(b.transpose(0, 2, 1)).view(
            dtype.newbyteorder('>'))
        return be.reshape(rows, cols, spp).astype(dtype.newbyteorder('='))
    v = native_bits(raw, dtype).reshape(rows, cols, spp)
    return np.cumsum(v, axis=1, dtype=v.dtype).view(
        dtype.newbyteorder('='))


def native_bits(raw: np.ndarray, dtype: np.dtype) -> np.ndarray:
    """Bytes of `dtype` samples in the file's byte order -> their bits as
    native unsigned integers (no float conversion touches them: a NaN's
    payload stays as it is)."""
    unsigned = np.dtype(f'u{dtype.itemsize}')
    return raw.view(unsigned.newbyteorder(dtype.byteorder)).astype(unsigned)


def jpeg_stream(data: bytes, tables: Optional[bytes]) -> bytes:
    """A strip's or tile's JPEG stream with JPEGTables' tables (the
    stream between its SOI and EOI) spliced in after the stream's SOI:
    its own tables, if any, come later and win, as libjpeg reads an
    abbreviated stream after a tables-only one."""
    if not tables or len(tables) < 4:
        return data
    if tables[:2] != b'\xff\xd8':
        raise ValueError('TIFF tag 347 (JPEGTables) does not start with '
                         'an SOI marker')
    body = tables[2:-2] if tables[-2:] == b'\xff\xd9' else tables[2:]
    if data[:2] != b'\xff\xd8':
        raise ValueError('a TIFF JPEG strip or tile does not start with an '
                         'SOI marker')
    return data[:2] + body + data[2:]
