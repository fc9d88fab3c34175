"""A baseline JPEG encoder in numpy, for testing decoders.

It writes sequential Huffman-coded JPEG streams (SOF0 or SOF1) from
coefficients the caller gives, so a test can put any value a baseline
stream can carry into a decoder, including coefficients whose inverse
DCT leaves the sample range. `image_coefficients` makes realistic
coefficients from a BGR or grey image (JFIF colour conversion, box
downsampling, float DCT, the IJG quality scaling of the Annex K tables).

    coefs, quant = image_coefficients(bgr, quality=90, sampling=(2, 2))
    data = encode(coefs, quant, bgr.shape[:2], sampling=(2, 2))

Coefficients are int arrays [block rows, block cols, 64] per component,
in natural (row-major) order, over the component's MCU-padded block
grid; `block_grid` gives the grid. The streams use the standard Huffman
tables of Annex K.3, so AC values must lie in [-1023, 1023] and DC
differences in [-2047, 2047]. Options: restart intervals, one scan per
component, 16-bit quantisation tables, JFIF or no APP0 marker, other
component identifiers. Entropy coding is vectorised over all
coefficients, so a 900x1600 frame takes about a second. Used by the
JPEG decoder's tests and by `chip_smoke.py` (loaded by path there).
"""

from typing import List, Optional, Sequence, Tuple

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# Annex K.1 quantisation tables, natural order
LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103,
    99])
CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32)

# Annex K.3 Huffman tables: (code counts of lengths 1-16, symbols)
DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
           list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
             list(range(12)))
AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41,
    0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91,
    0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24,
    0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a,
    0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53,
    0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66,
    0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
    0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93,
    0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7,
    0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa])
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12,
    0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14,
    0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15,
    0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17,
    0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37,
    0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a,
    0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65,
    0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
    0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a,
    0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5,
    0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9,
    0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa])


def quality_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """The IJG quality scaling (`jpeg_quality_scaling`) of the Annex K
    tables, clamped to [1, 255]: (luma, chroma), natural order."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return tuple(np.clip((t * scale + 50) // 100, 1, 255)
                 for t in (LUMA_Q, CHROMA_Q))


def block_grid(hw: Tuple[int, int], sampling: Sequence[Tuple[int, int]]
               ) -> List[Tuple[int, int]]:
    """Each component's MCU-padded block grid (rows, cols); `sampling`
    holds each component's (h, v) factors."""
    h, w = hw
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    mcu_rows = -(-h // (8 * vmax))
    mcu_cols = -(-w // (8 * hmax))
    return [(mcu_rows * v, mcu_cols * hs) for hs, v in sampling]


def _sampling(ncomp: int, sampling) -> List[Tuple[int, int]]:
    """(h, v) of luma's chroma subsampling, as every component's
    factors: chroma takes 1x1 and luma the given factors."""
    if ncomp == 1:
        return [(1, 1)]
    if isinstance(sampling[0], (tuple, list)):
        return [tuple(s) for s in sampling]
    return [tuple(sampling), (1, 1), (1, 1)]


_DCT = np.array([[(np.sqrt(0.125) if u == 0 else 0.5)
                  * np.cos((2 * x + 1) * u * np.pi / 16)
                  for x in range(8)] for u in range(8)])


def image_coefficients(img: np.ndarray, quality: int = 90,
                       sampling=(2, 2)):
    """A BGR [H, W, 3] or grey [H, W] uint8 image -> (coefficients per
    component, quantisation tables per component), for `encode`.
    `sampling` is luma's (h, v) factors, chroma taking (1, 1)."""
    img = np.asarray(img, np.float64)
    luma_q, chroma_q = quality_tables(quality)
    if img.ndim == 2:
        planes, quant = [img], [luma_q]
    else:
        b, g, r = img[..., 0], img[..., 1], img[..., 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128]
        quant = [luma_q, chroma_q, chroma_q]
    factors = _sampling(len(planes), sampling)
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    grids = block_grid(img.shape[:2], factors)
    coefs = []
    for plane, (hs, v), (bh, bw), q in zip(planes, factors, grids, quant):
        fy, fx = vmax // v, hmax // hs
        ph, pw = bh * 8 * fy, bw * 8 * fx
        plane = np.pad(plane, ((0, ph - plane.shape[0]),
                               (0, pw - plane.shape[1])), mode='edge')
        plane = plane.reshape(ph // fy, fy, pw // fx, fx).mean((1, 3))
        blocks = (plane - 128).reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        dct = _DCT @ blocks @ _DCT.T
        coefs.append(np.round(dct.reshape(bh, bw, 64) / q).astype(np.int32))
    return coefs, quant


def _code_table(spec):
    """Huffman code and length of each symbol (Annex C)."""
    counts, symbols = spec
    code, k, codes, lengths = 0, 0, np.zeros(256, np.int64), np.zeros(
        256, np.int64)
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes[symbols[k]], lengths[symbols[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return codes, lengths


def _category(v: np.ndarray):
    """(size, extra bits) of values: JPEG's magnitude category and the
    value's low `size` bits (ones' complement for negatives)."""
    a = np.abs(v)
    size = np.zeros(v.shape, np.int64)
    nz = a > 0
    size[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    bits = np.where(v < 0, v + (1 << size) - 1, v)
    return size, bits.astype(np.int64)


def _scan_words(blocks: np.ndarray, comp_of_block: np.ndarray,
                tables, new_interval: np.ndarray):
    """Entropy-code blocks [N, 64] (natural order) in stream order:
    (word values, word lengths, index of each word's block). A word is a
    Huffman code with its extra bits; DC predictors restart where
    `new_interval` is set."""
    n = len(blocks)
    zz = blocks[:, ZIGZAG].astype(np.int64)
    # DC differences, per component, reset at each restart
    dc = zz[:, 0]
    diff = np.empty(n, np.int64)
    last = {}
    for i in range(n):
        c = comp_of_block[i]
        if new_interval[i]:
            last = {}
        diff[i] = dc[i] - last.get(c, 0)
        last[c] = dc[i]
    if np.abs(diff).max(initial=0) > 2047:
        raise ValueError('a DC difference beyond 2047')
    if np.abs(zz[:, 1:]).max(initial=0) > 1023:
        raise ValueError('an AC value beyond 1023')
    dc_codes = np.stack([tables[c][0][0] for c in range(len(tables))])
    dc_lens = np.stack([tables[c][0][1] for c in range(len(tables))])
    ac_codes = np.stack([tables[c][1][0] for c in range(len(tables))])
    ac_lens = np.stack([tables[c][1][1] for c in range(len(tables))])

    size, bits = _category(diff)
    words = [(np.arange(n), 0, (dc_codes[comp_of_block, size] << size) | bits,
              dc_lens[comp_of_block, size] + size)]
    # AC: one word per nonzero coefficient, ZRL words for runs of 16
    # zeros before it, an EOB where the block ends in zeros
    blk, k = np.nonzero(zz[:, 1:])
    k = k + 1
    prev = np.zeros_like(k)
    same = np.zeros(len(blk), bool)
    same[1:] = blk[1:] == blk[:-1]
    prev[same] = k[:-1][same[1:]]
    run = k - prev - 1
    zrl = run // 16
    run = run % 16
    size, bits = _category(zz[blk, k])
    c = comp_of_block[blk]
    sym = run * 16 + size
    if zrl.any():
        zb = np.repeat(blk, zrl)
        zk = np.repeat(k, zrl) - 0.5             # just before its value
        zc = comp_of_block[zb]
        words.append((zb, zk, ac_codes[zc, 0xf0], ac_lens[zc, 0xf0]))
    words.append((blk, k, (ac_codes[c, sym] << size) | bits,
                  ac_lens[c, sym] + size))
    last_k = np.zeros(n, np.int64)
    np.maximum.at(last_k, blk, k)
    eob = np.nonzero(last_k < 63)[0]
    ce = comp_of_block[eob]
    words.append((eob, 64, ac_codes[ce, 0], ac_lens[ce, 0]))
    block = np.concatenate([np.broadcast_to(w[0], np.shape(w[2]))
                            for w in words])
    pos = np.concatenate([np.broadcast_to(np.asarray(w[1], np.float64),
                                          np.shape(w[2])) for w in words])
    value = np.concatenate([w[2] for w in words])
    length = np.concatenate([w[3] for w in words])
    order = np.lexsort((pos, block))
    return value[order], length[order], block[order]


def _pack(value: np.ndarray, length: np.ndarray) -> bytes:
    """Words of up to 32 bits, MSB first, into bytes; the last byte is
    padded with one bits."""
    total = int(length.sum())
    pad = (-total) % 8
    value = np.r_[value, (1 << pad) - 1]
    length = np.r_[length, pad]
    start = np.cumsum(length) - length
    bit = np.repeat(np.arange(len(value)), length)
    offset = np.arange(total + pad) - np.repeat(start, length)
    shift = np.repeat(length, length) - 1 - offset
    bits = (value[bit] >> shift) & 1
    return np.packbits(bits.astype(np.uint8)).tobytes()


def _stuff(data: bytes) -> bytes:
    """0xFF data bytes followed by 0x00, as the entropy-coded segment
    needs."""
    return data.replace(b'\xff', b'\xff\x00')


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, 'big') + body


def encode(coefs: Sequence[np.ndarray], quant: Sequence[np.ndarray],
           hw: Tuple[int, int], sampling=(2, 2), restart: int = 0,
           interleaved: bool = True, quant16: bool = False,
           jfif: bool = True, ids: Optional[Sequence[int]] = None,
           sof: int = 0xC0) -> bytes:
    """A baseline JPEG stream of the given coefficients.

    Args:
        coefs: per component, int [block rows, block cols, 64] natural
            order, over `block_grid(hw, factors)`.
        quant: per component, its quantisation table (64, natural
            order); components with equal tables share one.
        hw: the image's (height, width).
        sampling: luma's (h, v) factors (chroma 1x1), or every
            component's (h, v).
        restart: the restart interval in MCUs (0: none).
        interleaved: one scan for all components, or one each.
        quant16: write 16-bit quantisation tables.
        jfif: write the JFIF APP0 marker.
        ids: component identifiers (default 1, 2, 3).
        sof: the frame marker, 0xC0 (baseline) or 0xC1 (extended).
    """
    ncomp = len(coefs)
    factors = _sampling(ncomp, sampling)
    grids = block_grid(hw, factors)
    for c, g in zip(coefs, grids):
        if c.shape != (*g, 64):
            raise ValueError(f'coefficients {c.shape}; the grid is {g}')
    ids = list(ids or range(1, ncomp + 1))
    tabs, qidx = [], []
    for q in quant:
        q = np.asarray(q).ravel()
        for i, t in enumerate(tabs):
            if np.array_equal(t, q):
                qidx.append(i)
                break
        else:
            qidx.append(len(tabs))
            tabs.append(q)
    huff = [(DC_LUMA, AC_LUMA)] + [(DC_CHROMA, AC_CHROMA)] * (ncomp - 1)
    out = bytearray(b'\xff\xd8')
    if jfif:
        out += _segment(0xE0, b'JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00')
    for i, t in enumerate(tabs):
        if quant16:
            body = bytes([0x10 | i]) + t[ZIGZAG].astype('>u2').tobytes()
        else:
            body = bytes([i]) + t[ZIGZAG].astype(np.uint8).tobytes()
        out += _segment(0xDB, body)
    frame = bytes([8]) + hw[0].to_bytes(2, 'big') + hw[1].to_bytes(2, 'big')
    frame += bytes([ncomp])
    for c in range(ncomp):
        frame += bytes([ids[c], factors[c][0] * 16 + factors[c][1], qidx[c]])
    out += _segment(sof, frame)
    for t, (dc, ac) in enumerate(huff[:min(ncomp, 2)]):
        for cls, spec in ((0, dc), (1, ac)):
            out += _segment(0xC4, bytes([cls * 16 + t, *spec[0], *spec[1]]))
    if restart:
        out += _segment(0xDD, restart.to_bytes(2, 'big'))
    tables = [tuple(_code_table(s) for s in h) for h in huff]
    scans = [list(range(ncomp))] if interleaved else [[c] for c in
                                                      range(ncomp)]
    h, w = hw
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    for comps in scans:
        body = bytes([len(comps)])
        for c in comps:
            t = min(c, 1)
            body += bytes([ids[c], t * 16 + t])
        out += _segment(0xDA, body + b'\x00\x3f\x00')
        if len(comps) > 1:
            mcu_rows, mcu_cols = grids[0][0] // factors[0][1], \
                grids[0][1] // factors[0][0]
            parts, owner = [], []
            for c in comps:
                hs, v = factors[c]
                g = coefs[c].reshape(mcu_rows, v, mcu_cols, hs, 64)
                parts.append(g.transpose(0, 2, 1, 3, 4).reshape(
                    mcu_rows, mcu_cols, v * hs, 64))
                owner += [c] * (v * hs)
            blocks = np.concatenate(parts, 2).reshape(-1, 64)
            comp_of_block = np.tile(owner, mcu_rows * mcu_cols)
            per_mcu = len(owner)
        else:
            c = comps[0]
            hs, v = factors[c]
            rows = -(-(-(-h * v // vmax)) // 8)
            cols = -(-(-(-w * hs // hmax)) // 8)
            blocks = coefs[c][:rows, :cols].reshape(-1, 64)
            comp_of_block = np.full(len(blocks), c)
            per_mcu = 1
        mcu = np.arange(len(blocks)) // per_mcu
        interval = mcu // restart if restart else np.zeros_like(mcu)
        new = np.r_[True, interval[1:] != interval[:-1]]
        value, length, block = _scan_words(blocks, comp_of_block, tables,
                                           new)
        seg = interval[block]
        bounds = np.searchsorted(seg, np.arange(seg.max(initial=0) + 2))
        for i in range(len(bounds) - 1):
            a, b = bounds[i], bounds[i + 1]
            if i:
                out += bytes([0xFF, 0xD0 + (i - 1) % 8])
            out += _stuff(_pack(value[a:b], length[a:b]))
    out += b'\xff\xd9'
    return bytes(out)
