"""A baseline JPEG encoder in numpy, for testing decoders.

It writes JPEG streams from coefficients the caller gives, so a test can
put any value a stream can carry into a decoder, including coefficients
whose inverse DCT leaves the sample range: sequential Huffman-coded
(SOF0 or SOF1), progressive Huffman-coded (SOF2: `progression`'s
spectral selection and successive approximation, every EOB run 1),
arithmetic-coded sequential (SOF9) and progressive (SOF10), with 1, 3
or 4 components (CMYK or YCCK behind an Adobe marker). The same
coefficients give the same pixels in every mode. `image_coefficients`
makes realistic coefficients from a BGR, CMYK or grey image (JFIF colour
conversion, box downsampling, float DCT, the IJG quality scaling of the
Annex K tables).

    coefs, quant = image_coefficients(bgr, quality=90, sampling=(2, 2))
    data = encode(coefs, quant, bgr.shape[:2], sampling=(2, 2))

Coefficients are int arrays [block rows, block cols, 64] per component,
in natural (row-major) order, over the component's MCU-padded block
grid; `block_grid` gives the grid. Huffman streams use the standard
tables of Annex K.3, so AC values must lie in [-1023, 1023] and DC
differences in [-2047, 2047]. Options: restart intervals, one scan per
component, 16-bit quantisation tables, JFIF or no APP0 marker, other
component identifiers, arithmetic conditioning (DAC). Huffman coding is
vectorised over all coefficients, so a 900x1600 frame takes about a
second; the arithmetic coder runs one decision at a time in Python, 5-8 s
for such a frame. Used by the JPEG decoder's tests and by
`chip_smoke.py` (loaded by path there).
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
    factors: chroma takes 1x1, luma (and a fourth component, as libjpeg
    samples K) the given factors."""
    if ncomp == 1:
        return [(1, 1)]
    if isinstance(sampling[0], (tuple, list)):
        return [tuple(s) for s in sampling]
    return [tuple(sampling), (1, 1), (1, 1), tuple(sampling)][:ncomp]


_DCT = np.array([[(np.sqrt(0.125) if u == 0 else 0.5)
                  * np.cos((2 * x + 1) * u * np.pi / 16)
                  for x in range(8)] for u in range(8)])


def _ycc(r, g, b):
    return [0.299 * r + 0.587 * g + 0.114 * b,
            -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
            0.5 * r - 0.418688 * g - 0.081312 * b + 128]


def image_coefficients(img: np.ndarray, quality: int = 90,
                       sampling=(2, 2), ycck: bool = False):
    """A BGR [H, W, 3], CMYK [H, W, 4] or grey [H, W] uint8 image ->
    (coefficients per component, quantisation tables per component), for
    `encode`. `sampling` is luma's (h, v) factors (and K's), chroma
    taking (1, 1). CMYK is stored as it is, or with `ycck` as YCCK (the
    inverted C, M, Y as RGB to YCbCr, K as it is: libjpeg's
    cmyk_ycck_convert); write either with `adobe=0` or `adobe=2`."""
    img = np.asarray(img, np.float64)
    luma_q, chroma_q = quality_tables(quality)
    if img.ndim == 2:
        planes, quant = [img], [luma_q]
    elif img.shape[2] == 4:
        c, m, y, k = (img[..., i] for i in range(4))
        planes = (_ycc(255 - c, 255 - m, 255 - y) if ycck else [c, m, y])
        planes.append(k)
        quant = [luma_q, chroma_q, chroma_q, luma_q]
    else:
        b, g, r = img[..., 0], img[..., 1], img[..., 2]
        planes = _ycc(r, g, b)
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


def _scan_blocks(coefs, factors, grids, hw, comps):
    """A scan's blocks [N, 64] (natural order) in stream order, each
    block's component and MCU index: MCU by MCU when the scan holds
    several components, else over the component's own block grid."""
    h, w = hw
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
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
    return blocks, comp_of_block, np.arange(len(blocks)) // per_mcu


def _shift(v: np.ndarray, al: int) -> np.ndarray:
    """An AC point transform: |v| >> Al with v's sign."""
    return np.sign(v) * (np.abs(v) >> al)


def _ac_words(zz: np.ndarray, first: int, comp_of_block, tables):
    """Huffman words of AC values zz [N, L] at zigzag positions first ..
    first + L - 1 (runs, ZRLs, an EOB where the band ends in zeros): the
    baseline scan's AC part, and a progressive AC first scan's."""
    n, span = zz.shape
    ac_codes = np.stack([t[1][0] for t in tables])
    ac_lens = np.stack([t[1][1] for t in tables])
    if np.abs(zz).max(initial=0) > 1023:
        raise ValueError('an AC value beyond 1023')
    words = []
    blk, j = np.nonzero(zz)
    k = j + first
    prev = np.full_like(k, first - 1)
    same = np.zeros(len(blk), bool)
    same[1:] = blk[1:] == blk[:-1]
    prev[same] = k[:-1][same[1:]]
    run = k - prev - 1
    zrl = run // 16
    run = run % 16
    size, bits = _category(zz[blk, j])
    c = comp_of_block[blk]
    sym = run * 16 + size
    if zrl.any():
        zb = np.repeat(blk, zrl)
        zk = np.repeat(k, zrl) - 0.5             # just before its value
        zc = comp_of_block[zb]
        words.append((zb, zk, ac_codes[zc, 0xf0], ac_lens[zc, 0xf0]))
    words.append((blk, k, (ac_codes[c, sym] << size) | bits,
                  ac_lens[c, sym] + size))
    last_k = np.full(n, first - 1)
    np.maximum.at(last_k, blk, k)
    eob = np.nonzero(last_k < first + span - 1)[0]
    ce = comp_of_block[eob]
    words.append((eob, 64, ac_codes[ce, 0], ac_lens[ce, 0]))
    return words


def _dc_words(dc: np.ndarray, comp_of_block, tables, new_interval):
    """Huffman words of DC values, as differences per component that
    restart where `new_interval` is set."""
    n = len(dc)
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
    dc_codes = np.stack([t[0][0] for t in tables])
    dc_lens = np.stack([t[0][1] for t in tables])
    size, bits = _category(diff)
    return [(np.arange(n), 0, (dc_codes[comp_of_block, size] << size) | bits,
             dc_lens[comp_of_block, size] + size)]


def _refine_words(zz: np.ndarray, first: int, ah: int, al: int,
                  comp_of_block, tables):
    """Huffman words of a progressive AC refinement scan (jcphuff.c
    encode_mcu_AC_refine with every EOB run 1): zz [N, L] the band's
    coefficients. A newly nonzero coefficient is coded with its zero run
    and sign; an older one sends its next bit, held back to follow the
    next code in the block (a ZRL, a new coefficient or the EOB)."""
    n, span = zz.shape
    ac_codes = np.stack([t[1][0] for t in tables])
    ac_lens = np.stack([t[1][1] for t in tables])
    a = np.abs(zz) >> al
    newly = a == 1
    last_new = np.where(newly.any(1),
                        span - 1 - np.argmax(newly[:, ::-1], 1), -1)
    r = np.zeros(n, np.int64)
    words, anchors, held = [], [], []      # anchors: (block, j, key)
    for j in range(span):
        col = a[:, j]
        nz = col > 0
        z = np.nonzero(nz & (r > 15) & (j <= last_new))[0]
        if len(z):
            cz = comp_of_block[z]
            key = first + j - 0.6
            words.append((z, np.full(len(z), key), ac_codes[cz, 0xf0],
                          ac_lens[cz, 0xf0]))
            anchors.append((z, np.full(len(z), j), np.full(len(z), key)))
            more = r[z] // 16 - 1
            zb = np.repeat(z, more)
            words.append((zb, np.full(len(zb), first + j - 0.5),
                          ac_codes[comp_of_block[zb], 0xf0],
                          ac_lens[comp_of_block[zb], 0xf0]))
            r[z] %= 16
        b = np.nonzero(col == 1)[0]
        if len(b):
            cb = comp_of_block[b]
            sym = r[b] * 16 + 1
            sign = (zz[b, j] > 0).astype(np.int64)
            words.append((b, np.full(len(b), float(first + j)),
                          (ac_codes[cb, sym] << 1) | sign,
                          ac_lens[cb, sym] + 1))
            anchors.append((b, np.full(len(b), j), np.full(len(b),
                                                           float(first + j))))
            r[b] = 0
        p = np.nonzero(col > 1)[0]
        if len(p):
            held.append((p, np.full(len(p), j), col[p] & 1))
        r[~nz] += 1
    hb = np.concatenate([h[0] for h in held]) if held else np.zeros(0, int)
    hj = np.concatenate([h[1] for h in held]) if held else np.zeros(0, int)
    hv = np.concatenate([h[2] for h in held]) if held else np.zeros(0, int)
    # an EOB where zeros or held bits are left after the last code
    after = np.zeros(n, bool)
    if len(hb):
        last_anchor = np.full(n, -1)
        for ab, aj, _ in anchors:
            np.maximum.at(last_anchor, ab, aj)
        after[hb[hj >= last_anchor[hb]]] = True
    tail = r > 0
    eob = np.nonzero(tail | after)[0]
    ce = comp_of_block[eob]
    words.append((eob, np.full(len(eob), 64.0), ac_codes[ce, 0],
                  ac_lens[ce, 0]))
    anchors.append((eob, np.full(len(eob), span), np.full(len(eob), 64.0)))
    if len(hb):
        ab = np.concatenate([x[0] for x in anchors])
        aj = np.concatenate([x[1] for x in anchors])
        ak = np.concatenate([x[2] for x in anchors])
        order = np.lexsort((aj, ab))
        code = (ab * 128 + aj)[order]
        idx = np.searchsorted(code, hb * 128 + hj, side='right')
        key = ak[order][idx] + 0.01 + hj / 1e4
        words.append((hb, key, hv, np.ones(len(hb), np.int64)))
    return words


def _join_words(words):
    """Words (block, key, value, length) in stream order."""
    block = np.concatenate([np.broadcast_to(w[0], np.shape(w[2]))
                            for w in words])
    pos = np.concatenate([np.broadcast_to(np.asarray(w[1], np.float64),
                                          np.shape(w[2])) for w in words])
    value = np.concatenate([np.asarray(w[2], np.int64) for w in words])
    length = np.concatenate([np.asarray(w[3], np.int64) for w in words])
    order = np.lexsort((pos, block))
    return value[order], length[order], block[order]


# -- arithmetic coding (the QM coder of Annex D, as jcarith.c codes) ------

# Table D.2: (Qe, next index after an LPS, after an MPS, switch MPS)
QE_TABLE = (
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0),
    (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0),
    (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0cef, 43, 21, 0),
    (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
    (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0),
    (0x2ef1, 67, 40, 0), (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0),
    (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0),
    (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0),
    (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0),
    (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0),
    (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0),
    (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0),
    (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
    (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
    (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0))
# statistics bins: 64 a DC table, 256 an AC table (16 of each), and the
# fixed 0.5 bin (state 113) that signs and DC refinements use
DC_BINS, AC_BINS = 0, 16 * 64
FIXED_BIN = AC_BINS + 16 * 256


def qm_encode(decisions) -> bytes:
    """Code binary decisions (each bin * 2 + bit, every bin starting at
    state 0, MPS 0) into stuffed bytes (jcarith.c arith_encode and
    finish_pass)."""
    state = bytearray(FIXED_BIN + 1)
    state[FIXED_BIN] = 113
    qe_of = [q[0] for q in QE_TABLE]
    nl_of = [q[1] | (q[3] << 7) for q in QE_TABLE]
    nm_of = [q[2] for q in QE_TABLE]
    out = bytearray()
    a, c, ct, sc, zc, buffer = 0x10000, 0, 11, 0, 0, -1

    def emit(byte, carry):
        """A finished byte of C (with a carry into the held one); the
        held byte, zero runs and stacked 0xFF bytes go out as they
        settle."""
        nonlocal sc, zc, buffer
        if carry:
            if buffer >= 0:
                out.extend(bytes(zc))
                zc = 0
                out.append(buffer + 1)
                if buffer + 1 == 0xFF:
                    out.append(0)
            zc += sc
            sc = 0
            buffer = byte
        elif byte == 0xFF:
            sc += 1
        else:
            if buffer == 0:
                zc += 1
            elif buffer >= 0:
                out.extend(bytes(zc))
                zc = 0
                out.append(buffer)
            if sc:
                out.extend(bytes(zc))
                zc = 0
                out.extend(b'\xff\x00' * sc)
                sc = 0
            buffer = byte

    for d in decisions:
        st, val = d >> 1, d & 1
        sv = state[st]
        i = sv & 0x7F
        qe = qe_of[i]
        a -= qe
        if val != sv >> 7:
            if a >= qe:
                c += a
                a = qe
            state[st] = (sv & 0x80) ^ nl_of[i]
        else:
            if a >= 0x8000:
                continue
            if a < qe:
                c += a
                a = qe
            state[st] = (sv & 0x80) ^ nm_of[i]
        # renormalise: double A and C until A >= 0x8000, a byte out each
        # time CT runs out
        shift = 16 - a.bit_length()
        while shift:
            step = shift if shift < ct else ct
            a <<= step
            c <<= step
            ct -= step
            shift -= step
            if ct == 0:
                temp = c >> 19
                emit(temp & 0xFF, temp > 0xFF)
                c &= 0x7FFFF
                ct = 8
    # termination (section D.1.8)
    temp = (a - 1 + c) & 0xFFFF0000
    c = temp + 0x8000 if temp < c else temp
    c <<= ct
    if c & 0xF8000000:
        if buffer >= 0:
            out.extend(bytes(zc))
            zc = 0
            out.append(buffer + 1)
            if buffer + 1 == 0xFF:
                out.append(0)
        zc += sc
    else:
        emit(0x100, False)          # settles the held byte and 0xFF run
    if c & 0x7FFF800:
        out.extend(bytes(zc))
        for byte in ((c >> 19) & 0xFF, (c >> 11) & 0xFF)[
                :2 if c & 0x7F800 else 1]:
            out.append(byte)
            if byte == 0xFF:
                out.append(0)
    return bytes(out)


def _arith_value(add, bins, x, k_bins, v):
    """Figures F.8-F.9: the magnitude of the nonzero value v (its sign
    already coded) from the bin of its first decision `x`; `k_bins` is
    an AC value's X2 bin (189 or 217 on), None for DC (X1 = 20 on).
    Returns the magnitude category's top bit (0 for |v| = 1)."""
    v = abs(v) - 1
    st, m = x, 0
    if v:
        add(st, 1)
        nb = v.bit_length()
        m = 1 << (nb - 1)
        if k_bins is None:
            st = bins + 20
            for _ in range(nb - 1):
                add(st, 1)
                st += 1
        elif nb > 1:
            add(st, 1)
            st = k_bins
            for _ in range(nb - 2):
                add(st, 1)
                st += 1
    add(st, 0)
    st += 14
    top = m
    while m > 1:
        m >>= 1
        add(st, 1 if m & v else 0)
    return top


def _arith_dc(add, tbl, ctx, diff, dac):
    """Figure F.4 for one DC difference; returns the next context."""
    bins = DC_BINS + 64 * tbl
    st = bins + ctx
    if diff == 0:
        add(st, 0)
        return 0
    add(st, 1)
    add(st + 1, 0 if diff > 0 else 1)
    m = _arith_value(add, bins, st + (2 if diff > 0 else 3), None, diff)
    low, high = dac.get(tbl, (0, 1))
    if m < (1 << low) >> 1:
        return 0
    ctx = 4 if diff > 0 else 8
    return ctx + 8 if m > (1 << high) >> 1 else ctx


def _arith_ac(add, tbl, zz, first, last, kx):
    """Figure F.5 over positions first..last of zigzag values zz (a list;
    index 0 = position `first`)."""
    bins = AC_BINS + 256 * tbl
    ke = last
    while ke >= first and zz[ke - first] == 0:
        ke -= 1
    k = first
    while k <= ke:
        st = bins + 3 * (k - 1)
        add(st, 0)
        while zz[k - first] == 0:
            add(st + 1, 0)
            st += 3
            k += 1
        add(st + 1, 1)
        v = zz[k - first]
        add(FIXED_BIN, 0 if v > 0 else 1)
        _arith_value(add, bins, st + 2, bins + (189 if k <= kx else 217), v)
        k += 1
    if k <= last:
        add(bins + 3 * (k - 1), 1)


def _arith_refine(add, tbl, zz, first, last, ah, al):
    """Figure G.10 (jcarith.c encode_mcu_AC_refine) over one block's
    band zz (a list; index 0 = position `first`)."""
    bins = AC_BINS + 256 * tbl
    a = [abs(v) >> al for v in zz]
    ke = last
    while ke >= first and a[ke - first] == 0:
        ke -= 1
    kex = ke
    while kex >= first and abs(zz[kex - first]) >> ah == 0:
        kex -= 1
    k = first
    while k <= ke:
        st = bins + 3 * (k - 1)
        if k > kex:
            add(st, 0)
        while True:
            v = a[k - first]
            if v:
                if v >> 1:
                    add(st + 2, v & 1)
                else:
                    add(st + 1, 1)
                    add(FIXED_BIN, 0 if zz[k - first] > 0 else 1)
                break
            add(st + 1, 0)
            st += 3
            k += 1
        k += 1
    if k <= last:
        add(bins + 3 * (k - 1), 1)


def _arith_interval(blocks, comp_of_block, ss, se, ah, al, progressive,
                    tbl, dac, kx):
    """The coded bytes of one restart interval of a scan; `tbl` gives a
    component's DC and AC table."""
    decisions = []
    push = decisions.append

    def add(st, bit):
        push(st * 2 + bit)

    ctx, last = {}, {}
    for zz, c in zip(blocks[:, ZIGZAG].tolist(), comp_of_block.tolist()):
        if not progressive or (ss == 0 and ah == 0):       # DC first
            dc = zz[0] >> al if progressive else zz[0]
            ctx[c] = _arith_dc(add, tbl[c], ctx.get(c, 0),
                               dc - last.get(c, 0), dac)
            last[c] = dc
        elif ss == 0:                                       # DC refine
            add(FIXED_BIN, (zz[0] >> al) & 1)
        if not progressive:
            _arith_ac(add, tbl[c], zz[1:], 1, 63, kx[tbl[c]])
        elif ss and not ah:
            band = [(abs(v) >> al) * (1 if v > 0 else -1)
                    for v in zz[ss:se + 1]]
            _arith_ac(add, tbl[c], band, ss, se, kx[tbl[c]])
        elif ss:
            _arith_refine(add, tbl[c], zz[ss:se + 1], ss, se, ah, al)
    return qm_encode(decisions)


def _adobe(transform: int) -> bytes:
    """The APP14 body libjpeg writes: 'Adobe', version 100, flags 0, the
    colour transform."""
    return b'Adobe' + bytes([0, 100, 0, 0, 0, 0, transform])


def progression(ncomp: int, interleaved: bool = True):
    """A progressive script of spectral selection and successive
    approximation: (components, Ss, Se, Ah, Al) a scan. DC first at
    Al 1, each component's AC 1-5 then 6-63 at Al 2, their refinement to
    Al 1, the DC refinement, each component's AC refinement to Al 0."""
    comps = list(range(ncomp))
    dc = [comps] if interleaved else [[c] for c in comps]
    return ([(s, 0, 0, 0, 1) for s in dc]
            + [([c], 1, 5, 0, 2) for c in comps]
            + [([c], 6, 63, 0, 2) for c in comps]
            + [([c], 1, 63, 2, 1) for c in comps]
            + [(s, 0, 0, 1, 0) for s in dc]
            + [([c], 1, 63, 1, 0) for c in comps])


def encode(coefs: Sequence[np.ndarray], quant: Sequence[np.ndarray],
           hw: Tuple[int, int], sampling=(2, 2), restart: int = 0,
           interleaved: bool = True, quant16: bool = False,
           jfif: bool = True, ids: Optional[Sequence[int]] = None,
           sof: int = 0xC0, progressive: bool = False,
           arithmetic: bool = False, adobe: Optional[int] = None,
           dac: Optional[dict] = None) -> bytes:
    """A JPEG stream of the given coefficients.

    Args:
        coefs: per component, int [block rows, block cols, 64] natural
            order, over `block_grid(hw, factors)`.
        quant: per component, its quantisation table (64, natural
            order); components with equal tables share one.
        hw: the image's (height, width).
        sampling: luma's (h, v) factors (chroma 1x1; a fourth component
            takes luma's), or every component's (h, v).
        restart: the restart interval in MCUs (0: none).
        interleaved: one scan for all components, or one each (for a
            progressive stream: its DC scans).
        quant16: write 16-bit quantisation tables.
        jfif: write the JFIF APP0 marker.
        ids: component identifiers (default 1, 2, 3, 4).
        sof: the frame marker of a sequential Huffman stream, 0xC0
            (baseline) or 0xC1 (extended).
        progressive: code the scans of `progression`: SOF2, or SOF10
            with `arithmetic`.
        arithmetic: arithmetic coding (SOF9, or SOF10 with
            `progressive`), with conditioning `dac` ({DC table: (L, U)},
            and {16 + AC table: Kx}) written as a DAC segment.
        adobe: write an Adobe APP14 marker with this colour transform (0:
            RGB or CMYK as stored, 1: YCbCr, 2: YCCK).
    """
    ncomp = len(coefs)
    factors = _sampling(ncomp, sampling)
    grids = block_grid(hw, factors)
    for c, g in zip(coefs, grids):
        if c.shape != (*g, 64):
            raise ValueError(f'coefficients {c.shape}; the grid is {g}')
    ids = list(ids or range(1, ncomp + 1))
    if arithmetic:
        sof = 0xCA if progressive else 0xC9
    elif progressive:
        sof = 0xC2
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
    table_of = [min(c, 1) for c in range(ncomp)]
    out = bytearray(b'\xff\xd8')
    if jfif:
        out += _segment(0xE0, b'JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00')
    if adobe is not None:
        out += _segment(0xEE, _adobe(adobe))
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
    dac = dict(dac or {})
    if arithmetic and dac:
        body = b''
        for index, val in sorted(dac.items()):
            body += bytes([index, val[0] | val[1] << 4 if index < 16
                           else val])
        out += _segment(0xCC, body)
    elif not arithmetic:
        for t, (dc, ac) in enumerate(huff[:min(ncomp, 2)]):
            for cls, spec in ((0, dc), (1, ac)):
                out += _segment(0xC4, bytes([cls * 16 + t, *spec[0],
                                             *spec[1]]))
    if restart:
        out += _segment(0xDD, restart.to_bytes(2, 'big'))
    tables = [tuple(_code_table(s) for s in h) for h in huff]
    if progressive:
        scans = progression(ncomp, interleaved)
    else:
        comps_ = [list(range(ncomp))] if interleaved else [
            [c] for c in range(ncomp)]
        scans = [(s, 0, 63, 0, 0) for s in comps_]
    dc_range = {t: v for t, v in dac.items() if t < 16}
    kx = [dac.get(16 + t, 5) for t in range(16)]
    for comps, ss, se, ah, al in scans:
        body = bytes([len(comps)])
        for c in comps:
            t = table_of[c]
            body += bytes([ids[c], t * 16 + t])
        out += _segment(0xDA, body + bytes([ss, se, ah * 16 + al]))
        blocks, owner, mcu = _scan_blocks(coefs, factors, grids, hw, comps)
        interval = mcu // restart if restart else np.zeros_like(mcu)
        bounds = np.searchsorted(interval,
                                 np.arange(interval.max(initial=0) + 2))
        if arithmetic:
            segs = [_arith_interval(blocks[a:b], owner[a:b], ss, se, ah, al,
                                    progressive, table_of, dc_range, kx)
                    for a, b in zip(bounds[:-1], bounds[1:])]
        else:
            new = np.r_[True, interval[1:] != interval[:-1]]
            zz = blocks[:, ZIGZAG].astype(np.int64)
            if not progressive:
                words = (_dc_words(zz[:, 0], owner, tables, new)
                         + _ac_words(zz[:, 1:], 1, owner, tables))
            elif ss == 0 and ah == 0:
                words = _dc_words(zz[:, 0] >> al, owner, tables, new)
            elif ss == 0:
                words = [(np.arange(len(zz)), 0, (zz[:, 0] >> al) & 1,
                          np.ones(len(zz), np.int64))]
            elif ah == 0:
                words = _ac_words(_shift(zz[:, ss:se + 1], al), ss, owner,
                                  tables)
            else:
                words = _refine_words(zz[:, ss:se + 1], ss, ah, al, owner,
                                      tables)
            value, length, block = _join_words(words)
            seg = interval[block]
            cuts = np.searchsorted(seg, np.arange(len(bounds)))
            segs = [_stuff(_pack(value[a:b], length[a:b]))
                    for a, b in zip(cuts[:-1], cuts[1:])]
        for i, data in enumerate(segs):
            if i:
                out += bytes([0xFF, 0xD0 + (i - 1) % 8])
            out += data
    out += b'\xff\xd9'
    return bytes(out)


# -- lossless (SOF3, Annex H) ------------------------------------------------

# a DC-class table for the 17 difference categories 0-16: two codes of 2
# bits, three of 3, then one of each length 4-15 (the all-ones code of
# 15 bits unused)
LOSSLESS_TABLE = ([0, 2, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0],
                  [2, 3, 1, 4, 5, 0, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
                   16])


def lossless_predict(s: np.ndarray, predictor: int, first_rows,
                     initial: int) -> np.ndarray:
    """Each sample's prediction (ITU T.81 H.1.2.1) from the samples s
    [rows, cols] the decoder rebuilds: rows in `first_rows` (the scan's
    first and each restart interval's) start from `initial` and predict
    from the left, other rows' first column from above, the rest by
    `predictor` (1-7) over Ra (left), Rb (above), Rc (above left)."""
    s = np.asarray(s, np.int64)
    p = np.empty_like(s)
    ra, rb, rc = s[1:, :-1], s[:-1, 1:], s[:-1, :-1]
    p[1:, 1:] = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
                 5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                 7: (ra + rb) >> 1}[predictor]
    p[1:, 0] = s[:-1, 0]
    first = np.zeros(len(s), bool)
    first[list(first_rows)] = True
    p[first, 0] = initial
    p[first, 1:] = s[first, :-1]
    return p


def lossless_differences(s: np.ndarray, predictor: int, first_rows,
                         initial: int) -> np.ndarray:
    """The differences a lossless scan codes for samples s: modulo 2^16,
    in [-32767, 32768] (32768 is category 16)."""
    d = (np.asarray(s, np.int64)
         - lossless_predict(s, predictor, first_rows, initial)) % 65536
    return np.where(d > 32768, d - 65536, d)


def encode_lossless(img: np.ndarray, precision: int = 8, predictor: int = 1,
                    pt: int = 0, restart: int = 0, sampling=None,
                    marker: Optional[str] = None,
                    ids: Optional[Sequence[int]] = None,
                    interleaved: bool = True, diffs=None,
                    sof: int = 0xC3, table=LOSSLESS_TABLE,
                    dht: bool = True) -> bytes:
    """A lossless JPEG stream (SOF3, Huffman-coded, one DC-class table
    `LOSSLESS_TABLE` for every component) of an image, vectorised: the
    decoder rebuilds the samples exactly, so every difference follows
    from the point-transformed input at once.

    Args:
        img: [H, W] or [H, W, C] integers below 2^precision, the
            components in stored order (a colour frame is R, G, B as
            libjpeg stores it; CMYK as C, M, Y, K).
        precision: the frame's sample precision P.
        predictor: the scan's predictor Ss, 1-7.
        pt: the point transform Al: the samples coded are img >> pt.
        restart: the restart interval in MCUs (0: none). The decoder
            restarts prediction at each interval's first row: give whole
            MCU rows.
        sampling: each component's (h, v); a component's samples are
            img's taken every (hmax / h, vmax / v) pixels. Default 1x1.
        marker: None, 'jfif', or 'adobe0' / 'adobe1' / 'adobe2' (an
            Adobe APP14 with that colour transform).
        ids: component identifiers (default 1, 2, ...).
        interleaved: one scan for all components, or one each.
        diffs: per component, differences to code in place of img's
            ([MCU rows * v, MCU cols * h] for an interleaved scan, the
            component's sample grid otherwise): any value in
            [-32767, 32768].
        sof: the frame marker (0xC3; another code writes the same
            segments under it).
        table: the Huffman table (counts of lengths 1-16, symbols),
            written as DC table 0 unless `dht` is False.
    """
    img = np.asarray(img, np.int64)
    if img.ndim == 2:
        img = img[..., None]
    hgt, wid, ncomp = img.shape
    if img.min(initial=0) < 0 or img.max(initial=0) >= 1 << precision:
        raise ValueError(f'samples beyond {precision} bits')
    header = [tuple(f) for f in (sampling or [(1, 1)] * ncomp)]
    # a 1-component frame is one sample an MCU whatever its factors say
    factors = header if ncomp > 1 else [(1, 1)]
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    ids = list(ids or range(1, ncomp + 1))
    mcu_rows, mcu_cols = -(-hgt // vmax), -(-wid // hmax)
    initial = 1 << (precision - pt - 1)
    codes, lens = _code_table(table)
    out = bytearray(b'\xff\xd8')
    if marker == 'jfif':
        out += _segment(0xE0, b'JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00')
    elif marker:
        out += _segment(0xEE, _adobe(int(marker[-1])))
    frame = (bytes([precision]) + hgt.to_bytes(2, 'big')
             + wid.to_bytes(2, 'big') + bytes([ncomp]))
    for c in range(ncomp):
        frame += bytes([ids[c], header[c][0] * 16 + header[c][1], 0])
    out += _segment(sof, frame)
    if dht:
        out += _segment(0xC4, bytes([0, *table[0], *table[1]]))
    if restart:
        out += _segment(0xDD, restart.to_bytes(2, 'big'))

    def grid_diffs(c, rows, cols, per_row, mcu_h):
        """Component c's differences over a grid of `rows` x `cols`
        samples, its real samples predicted with restarts every
        `restart` MCUs of `per_row` a row, `mcu_h` sample rows an MCU
        row."""
        if diffs is not None:
            return np.asarray(diffs[c], np.int64)
        h, v = factors[c]
        s = img[::vmax // v, ::hmax // h, c] >> pt
        first = [0]
        if restart:
            first = [r * mcu_h for r in range(rows // mcu_h)
                     if (r * per_row) % restart == 0]
        g = np.zeros((rows, cols), np.int64)
        g[:s.shape[0], :s.shape[1]] = lossless_differences(
            s, predictor, [f for f in first if f < len(s)], initial)
        return g

    scans = [list(range(ncomp))] if interleaved else [[c] for c in
                                                     range(ncomp)]
    for comps in scans:
        body = bytes([len(comps)])
        for c in comps:
            body += bytes([ids[c], 0])
        out += _segment(0xDA, body + bytes([predictor, 0, pt]))
        if len(comps) > 1 or ncomp == 1:
            parts = []
            for c in comps:
                h, v = factors[c]
                rows, cols = mcu_rows, mcu_cols
                g = grid_diffs(c, rows * v, cols * h, cols, v)
                parts.append(g.reshape(rows, v, cols, h).transpose(
                    0, 2, 1, 3).reshape(rows, cols, v * h))
            d = np.concatenate(parts, 2)
            per_row = d.shape[1]
            d = d.reshape(len(d) * per_row, -1)
        else:
            h, v = factors[comps[0]]
            rows, cols = -(-hgt * v // vmax), -(-wid * h // hmax)
            d = grid_diffs(comps[0], rows, cols, cols, 1).reshape(-1, 1)
        mcu = np.repeat(np.arange(len(d)), d.shape[1])
        d = d.ravel()
        size, bits = _category(d)
        extra = np.where(size == 16, 0, size)
        value = (codes[size] << extra) | np.where(size == 16, 0, bits)
        length = lens[size] + extra
        interval = mcu // restart if restart else np.zeros_like(mcu)
        cuts = np.searchsorted(interval,
                               np.arange(interval.max(initial=0) + 2))
        for i, (a, b) in enumerate(zip(cuts[:-1], cuts[1:])):
            if i:
                out += bytes([0xFF, 0xD0 + (i - 1) % 8])
            out += _stuff(_pack(value[a:b], length[a:b]))
    out += b'\xff\xd9'
    return bytes(out)
