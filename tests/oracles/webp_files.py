"""A WebP writer in numpy, for the port's WebP reader
(`hrfuser_tpu_torch/data/webp.py`) to be held to `cv2` on files `cv2`
did not write.

  * `lossless(img)`: a real VP8L encode of a BGR or BGRA image: subtract
    green, then predictor mode 11 (select) everywhere, one group of
    prefix codes built from the histograms (length-limited Huffman), no
    LZ77 and no colour cache. Whole-array numpy: a 900x1600 frame in
    about a second.
  * `lossy(bgr, q)`: a simple real VP8 encode: each macroblock 16x16 DC
    or TM predicted (whichever is closer) from the decoder's own
    reconstruction, chroma likewise, libwebp's forward DCT and WHT, one
    quantiser index `q`, no segments, the normal loop filter, the
    default coefficient probabilities and the boolean encoder. The
    pixels it decodes to are the decoder's to say: `cv2` is the judge.
  * `fuzz_lossless(rng, h, w)` / `fuzz_lossy(rng, h, w)`: random but
    valid syntax, to reach what the real encodes leave out: every
    transform in random order (colour indexing with each bundling),
    predictor modes 0-15 by tile, cross-colour multipliers, colour caches
    of 1-11 bits, meta prefix codes, LZ77 copies through the distance
    map and beyond it, simple and normal prefix codes with repeat codes
    and max_symbol; segments with their map, quantiser and filter
    deltas, both filter types, sharpness, mode and reference filter
    deltas, 1-8 token partitions, probability updates, the skip flag,
    B_PRED with all ten modes, every 16x16 and chroma mode, and
    coefficients in every token category.
  * `container(...)`, `with_alpha(...)`, `animation(...)`: the RIFF
    file around a bitstream, `VP8X` with `ALPH` (raw or VP8L-coded, each
    filter), and `ANIM` / `ANMF` frames at an offset.

Only numpy, so that `chip_smoke.py` loads this file by path on the
card's machine, which has no `cv2` or PIL. The VP8 probability tables
are RFC 6386's constants, read from `csrc/webp_decode.cpp`
(`_vp8_tables`). `PINNED` holds SHA-256 digests of `cv2`'s decode of
the camera frames `camera_frames` writes (tests/test_torch_webp.py
checks them against `cv2`).
"""

import heapq
import os
import re
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# --------------------------------------------------------- container


def chunk(tag: bytes, payload: bytes) -> bytes:
    """A RIFF chunk: tag, size, payload, a pad byte to even length."""
    return (tag + struct.pack('<I', len(payload)) + payload
            + (b'\0' if len(payload) & 1 else b''))


def riff(body: bytes) -> bytes:
    return b'RIFF' + struct.pack('<I', 4 + len(body)) + b'WEBP' + body


def _le24(v: int) -> bytes:
    return struct.pack('<I', v)[:3]


def vp8x(width: int, height: int, flags: int) -> bytes:
    """The extended header: flags (alpha 0x10, animation 0x02, ICCP
    0x20, EXIF 0x08, XMP 0x04) and the canvas size."""
    return chunk(b'VP8X', bytes([flags, 0, 0, 0]) + _le24(width - 1)
                 + _le24(height - 1))


def container(bitstream: bytes, lossless: bool) -> bytes:
    """A simple-format file: RIFF, one VP8 or VP8L chunk."""
    return riff(chunk(b'VP8L' if lossless else b'VP8 ', bitstream))


def alph(alpha: np.ndarray, method: int = 1, filt: int = 0,
         pre: int = 0, rng: Optional[np.random.Generator] = None) -> bytes:
    """An ALPH payload: the header byte, then the alpha plane filtered
    (0 none, 1 horizontal, 2 vertical, 3 gradient) and raw (method 0)
    or VP8L-coded (method 1: green channel, a fuzzed stream with `rng`)."""
    res = _alpha_filter(alpha.astype(np.int32), filt)
    head = bytes([method | filt << 2 | pre << 4])
    if method == 0:
        return head + res.astype(np.uint8).tobytes()
    argb = (0xff000000 | res.astype(np.uint32) << 8).astype(np.uint32)
    if rng is None:
        return head + _encode_stream(argb, level0=True).bytes()
    return head + _fuzz_stream(rng, argb).bytes()


def with_alpha(vp8: bytes, width: int, height: int, alpha_payload: bytes,
               flags: int = 0x10, extra: Sequence[bytes] = ()) -> bytes:
    """An extended-format lossy file: VP8X, any `extra` chunks, ALPH,
    VP8."""
    return riff(vp8x(width, height, flags) + b''.join(extra)
                + chunk(b'ALPH', alpha_payload) + chunk(b'VP8 ', vp8))


def animation(canvas: Tuple[int, int], frames, flags: int = 0x02,
              background: int = 0xff336699, loops: int = 0) -> bytes:
    """An animated file on a (width, height) canvas. Each frame is
    (bitstream chunks, width, height, x, y, bits): the chunks (ALPH and
    VP8, or VP8L) as they sit in a still file, the ANMF offset (even),
    `bits` its dispose (1) and no-blend (2) flags."""
    body = vp8x(*canvas, flags) + chunk(b'ANIM', struct.pack(
        '<IH', background, loops))
    for chunks, w, h, x, y, bits in frames:
        body += chunk(b'ANMF', _le24(x // 2) + _le24(y // 2) + _le24(w - 1)
                      + _le24(h - 1) + _le24(100) + bytes([bits]) + chunks)
    return riff(body)


def _alpha_filter(a: np.ndarray, filt: int) -> np.ndarray:
    """The residuals libwebp's unfiltering adds back (mod 256)."""
    if filt == 0:
        return a & 0xff
    pred = np.zeros_like(a)
    pred[0, 1:] = a[0, :-1]
    pred[1:, 0] = a[:-1, 0]
    if filt == 1:
        pred[1:, 1:] = a[1:, :-1]
    elif filt == 2:
        pred[1:, 1:] = a[:-1, 1:]
    else:
        pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    return (a - pred) & 0xff


# ----------------------------------------------------------- bit writers

class Bits:
    """An LSB-first bit writer (VP8L)."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value: int, nbits: int) -> None:
        self.acc |= (value & ((1 << nbits) - 1)) << self.n
        self.n += nbits
        while self.n >= 8:
            self.out.append(self.acc & 0xff)
            self.acc >>= 8
            self.n -= 8

    def put_packed(self, codes: np.ndarray, lengths: np.ndarray) -> None:
        """Many codes at once (uint64 values, each under 64 bits)."""
        lengths = lengths.astype(np.int64)
        pending = np.array([(self.acc >> k) & 1 for k in range(self.n)],
                           np.uint8)
        self.acc = self.n = 0
        parts = [pending]
        step = 1 << 18
        for s in range(0, codes.size, step):
            c = codes[s:s + step].astype('<u8')
            bits = np.unpackbits(c.view(np.uint8).reshape(-1, 8), axis=1,
                                 bitorder='little')
            parts.append(bits[np.arange(64)[None, :]
                              < lengths[s:s + step, None]])
        stream = np.concatenate(parts)
        tail = stream.size % 8
        self.out.extend(np.packbits(stream[:stream.size - tail],
                                    bitorder='little').tobytes())
        for b in stream[stream.size - tail:]:
            self.put(int(b), 1)

    def bytes(self) -> bytes:
        out = bytes(self.out)
        return out + bytes([self.acc]) if self.n else out


_NORM = [7 - (r + 1).bit_length() + 1 for r in range(128)]
_NEW_RANGE = [((r + 1) << _NORM[r]) - 1 for r in range(128)]


class BoolEncoder:
    """libwebp's boolean encoder (VP8PutBit, carry through pending 0xff
    bytes); `range` holds the range less one."""

    def __init__(self):
        self.range = 254
        self.value = 0
        self.run = 0
        self.nb_bits = -8
        self.buf = bytearray()

    def put(self, bit: int, prob: int) -> int:
        split = (self.range * prob) >> 8
        if bit:
            self.value += split + 1
            self.range -= split + 1
        else:
            self.range = split
        if self.range < 127:
            shift = _NORM[self.range]
            self.range = _NEW_RANGE[self.range]
            self.value <<= shift
            self.nb_bits += shift
            if self.nb_bits > 0:
                self._flush()
        return bit

    def _flush(self):
        s = 8 + self.nb_bits
        bits = self.value >> s
        self.value -= bits << s
        self.nb_bits -= 8
        if (bits & 0xff) != 0xff:
            if bits & 0x100 and self.buf:
                self.buf[-1] += 1
            if self.run:
                self.buf.extend(bytes([0 if bits & 0x100 else 0xff])
                                * self.run)
                self.run = 0
            self.buf.append(bits & 0xff)
        else:
            self.run += 1

    def value_bits(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.put((v >> i) & 1, 128)

    def signed(self, v: int, n: int) -> None:
        self.value_bits(abs(v), n)
        self.put(int(v < 0), 128)

    def flag_signed(self, v: int, n: int) -> None:
        """An optional signed value: a flag, then magnitude and sign."""
        self.put(int(v != 0), 128)
        if v:
            self.signed(v, n)

    def finish(self) -> bytes:
        self.value_bits(0, 9 - self.nb_bits)
        self.nb_bits = 0
        self._flush()
        return bytes(self.buf)


# -------------------------------------------------------- prefix codes

def code_lengths(counts: np.ndarray, limit: int = 15) -> np.ndarray:
    """Huffman code lengths of these counts, none over `limit` (counts
    halved until they fit); one used symbol gets length 1."""
    counts = np.asarray(counts, np.int64)
    lengths = np.zeros(counts.size, np.int32)
    used = np.flatnonzero(counts)
    if used.size == 0:
        return lengths
    if used.size == 1:
        lengths[used[0]] = 1
        return lengths
    c = counts.copy()
    while True:
        heap = [(int(c[s]), i, [int(s)]) for i, s in enumerate(used)]
        heapq.heapify(heap)
        depth = {int(s): 0 for s in used}
        k = len(heap)
        while len(heap) > 1:
            a = heapq.heappop(heap)
            b = heapq.heappop(heap)
            for s in a[2] + b[2]:
                depth[s] += 1
            heapq.heappush(heap, (a[0] + b[0], k, a[2] + b[2]))
            k += 1
        if max(depth.values()) <= limit:
            for s, d in depth.items():
                lengths[s] = d
            return lengths
        c = np.where(c > 0, np.maximum(c >> 1, 1), 0)


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Each symbol's code, bit-reversed for an LSB-first writer (the
    decoder reads a code's first bit first)."""
    codes = np.zeros(lengths.size, np.int64)
    code = 0
    prev = 0
    for s in sorted(np.flatnonzero(lengths), key=lambda s: (lengths[s], s)):
        code <<= int(lengths[s]) - prev
        prev = int(lengths[s])
        codes[s] = int(f'{code:0{prev}b}'[::-1], 2)
        code += 1
    return codes


class Code:
    """A prefix code for one alphabet: lengths, codes; a single used
    symbol takes no bits."""

    def __init__(self, counts: np.ndarray, limit: int = 15):
        self.lengths = code_lengths(counts, limit)
        if np.count_nonzero(self.lengths) == 0:
            self.lengths[0] = 1          # an unused alphabet: symbol 0
        self.codes = canonical_codes(self.lengths)
        self.single = np.count_nonzero(self.lengths) == 1
        self.bits = np.where(self.single, 0, self.lengths)

    def put(self, bw: Bits, symbol: int) -> None:
        if not self.single:
            bw.put(int(self.codes[symbol]), int(self.lengths[symbol]))


_CL_ORDER = [17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14,
             15]


def _length_tokens(lengths, rng=None):
    """The code-length code's tokens (symbol, extra bits, extra value)."""
    out = []
    lengths = [int(v) for v in lengths]
    i, n, prev, run = 0, len(lengths), 8, 0
    use_repeats = rng is None or rng.random() < 0.8
    while i < n:
        v = lengths[i]
        if run == 0:            # the run of v from i, kept while it lasts
            run = 1
            while i + run < n and lengths[i + run] == v:
                run += 1
        if v == 0 and use_repeats and run >= 3:
            take = min(run, 138)
            if take >= 11:
                out.append((18, 7, take - 11))
            else:
                take = min(take, 10)
                out.append((17, 3, take - 3))
        elif v != 0 and use_repeats and v == prev and run >= 3:
            take = min(run, 6)
            out.append((16, 2, take - 3))
        else:
            take = 1
            out.append((v, 0, 0))
            if v:
                prev = v
        i += take
        run -= take
    return out


def write_code(bw: Bits, code: Code, alphabet: int, rng=None) -> None:
    """A prefix code's description: simple when it can be (and `rng`
    allows), else the code-length code and its tokens."""
    used = np.flatnonzero(code.lengths[:alphabet])
    if (used.size <= 2 and used.max() < 256 and code.lengths[used].max() == 1
            and (rng is None or rng.random() < 0.7)):
        bw.put(1, 1)
        bw.put(used.size - 1, 1)
        if used[0] < 2 and (rng is None or rng.random() < 0.5):
            bw.put(0, 1)
            bw.put(int(used[0]), 1)
        else:
            bw.put(1, 1)
            bw.put(int(used[0]), 8)
        if used.size == 2:
            bw.put(int(used[1]), 8)
        return
    lengths = code.lengths[:alphabet]
    last = int(used.max()) + 1
    use_max = rng is not None and last < alphabet and rng.random() < 0.5
    if use_max:
        tokens = _length_tokens(lengths[:last], rng)
        use_max = len(tokens) >= 2
    if not use_max:
        tokens = _length_tokens(lengths, rng)
    cl = Code(np.bincount([t[0] for t in tokens], minlength=19), 7)
    order = [int(cl.lengths[k]) for k in _CL_ORDER]
    num = max([4] + [k + 1 for k, v in enumerate(order) if v])
    bw.put(0, 1)
    bw.put(num - 4, 4)
    for k in range(num):
        bw.put(order[k], 3)
    if use_max:
        m = len(tokens) - 2
        k = 0
        while m >= 1 << (2 + 2 * k):
            k += 1
        bw.put(1, 1)
        bw.put(k, 3)
        bw.put(m, 2 + 2 * k)
    else:
        bw.put(0, 1)
    for sym, nbits, val in tokens:
        cl.put(bw, sym)
        if nbits:
            bw.put(val, nbits)


# ------------------------------------------------------- VP8L streams

def _prefix(v: int) -> Tuple[int, int, int]:
    """A length or distance v >= 1 as (symbol, extra bits, extra value)."""
    d = v - 1
    if d < 4:
        return d, 0, 0
    hb = d.bit_length() - 1
    second = (d >> (hb - 1)) & 1
    extra = hb - 1
    return 2 * hb + second, extra, d & ((1 << extra) - 1)


_DIST_MAP = None


def _dist_map():
    """The decoder's 120 distance codes, (dy << 4) | (8 - dx)."""
    global _DIST_MAP
    if _DIST_MAP is None:
        _DIST_MAP = _read_table('kCodeToPlane', 120)
    return _DIST_MAP


class Stream:
    """A VP8L image stream being written: a bit writer and its symbols."""

    def __init__(self):
        self.bw = Bits()

    def bytes(self) -> bytes:
        return self.bw.bytes()


def _encode_stream(argb: np.ndarray, level0: bool,
                   bw: Optional[Bits] = None) -> Stream:
    """Literals only, one group, no cache: the plain stream, whole-array."""
    st = Stream()
    if bw is not None:
        st.bw = bw
    bw = st.bw
    if level0:
        bw.put(0, 1)                 # no (more) transforms
    bw.put(0, 1)                     # no colour cache
    if level0:
        bw.put(0, 1)                 # no meta codes
    flat = argb.reshape(-1).astype(np.uint32)
    chans = [(flat >> 8) & 0xff, (flat >> 16) & 0xff, flat & 0xff,
             flat >> 24]
    codes = []
    for k, ch in enumerate(chans):
        size = 280 if k == 0 else 256
        code = Code(np.bincount(ch, minlength=size))
        write_code(bw, code, size)
        codes.append(code)
    write_code(bw, Code(np.zeros(40, np.int64)), 40)
    value = np.zeros(flat.size, np.uint64)
    length = np.zeros(flat.size, np.int64)
    for code, ch in zip(codes, chans):
        l = code.bits[ch].astype(np.int64)
        value |= code.codes[ch].astype(np.uint64) << length.astype(np.uint64)
        length += l
    bw.put_packed(value, length)
    return st


def _channels(argb: np.ndarray) -> np.ndarray:
    """uint32 ARGB [...] -> int32 [..., 4] as (A, R, G, B)."""
    a = argb.astype(np.uint32)
    return np.stack([a >> 24, (a >> 16) & 0xff, (a >> 8) & 0xff, a & 0xff],
                    -1).astype(np.int32)


def _pack(ch: np.ndarray) -> np.ndarray:
    ch = ch.astype(np.int64) & 0xff
    return ((ch[..., 0] << 24) | (ch[..., 1] << 16) | (ch[..., 2] << 8)
            | ch[..., 3]).astype(np.uint32)


def _predictions(img: np.ndarray) -> np.ndarray:
    """Every predictor mode's prediction of each pixel from `img` (h x w
    ARGB), [16, h*w, 4] channels; the decoder's first row and column
    rules are applied by the caller."""
    w = img.shape[1]
    flat = _channels(img.reshape(-1))
    n = flat.shape[0]
    pad = np.zeros((w + 1, 4), np.int32)
    ext = np.concatenate([pad, flat, np.zeros((1, 4), np.int32)])
    i = np.arange(n) + w + 1
    L, T, TR, TL = ext[i - 1], ext[i - w], ext[i - w + 1], ext[i - w - 1]

    def avg(a, b):
        return (a + b) >> 1

    black = np.broadcast_to(np.array([255, 0, 0, 0], np.int32), L.shape)
    sel = (np.abs(L - TL).sum(-1) - np.abs(T - TL).sum(-1)) <= 0
    select = np.where(sel[:, None], T, L)
    full = np.clip(L + T - TL, 0, 255)
    a = avg(L, T)
    d = a - TL
    half = np.clip(a + np.where(d < 0, -((-d) >> 1), d >> 1), 0, 255)
    preds = [black, L, T, TR, TL, avg(avg(L, TR), T), avg(L, TL), avg(L, T),
             avg(TL, T), avg(T, TR), avg(avg(L, TL), avg(T, TR)), select,
             full, half, black, black]
    return np.stack(preds)


def _predict_forward(img: np.ndarray, modes: np.ndarray,
                     bits: int) -> np.ndarray:
    """Residuals the predictor transform's inverse adds back, with the
    per-tile `modes` [th, tw]."""
    h, w = img.shape
    preds = _predictions(img)
    yy, xx = np.mgrid[0:h, 0:w]
    m = modes[yy >> bits, xx >> bits].reshape(-1)
    m = np.where(yy.reshape(-1) == 0, np.where(xx.reshape(-1) == 0, 0, 1),
                 np.where(xx.reshape(-1) == 0, 2, m))
    pred = preds[m, np.arange(h * w)]
    res = _channels(img.reshape(-1)) - pred
    return _pack(res).reshape(h, w)


def _sub_green(img: np.ndarray) -> np.ndarray:
    c = _channels(img)
    c[..., 1] -= c[..., 2]
    c[..., 3] -= c[..., 2]
    return _pack(c)


def _delta(pred, color):
    pred = pred.astype(np.int8).astype(np.int32)
    color = color.astype(np.int8).astype(np.int32)
    return (pred * color) >> 5


def _cross_color_forward(img, mult, bits):
    h, w = img.shape
    yy, xx = np.mgrid[0:h, 0:w]
    m = mult[yy >> bits, xx >> bits]
    g2r, g2b, r2b = m[..., 0], m[..., 1], m[..., 2]
    c = _channels(img)
    g, r, b = c[..., 2].copy(), c[..., 1].copy(), c[..., 3].copy()
    c[..., 1] = r - _delta(g2r, g & 0xff)
    c[..., 3] = b - _delta(g2b, g & 0xff) - _delta(r2b, r & 0xff)
    return _pack(c)


def lossless(img: np.ndarray) -> bytes:
    """A real VP8L file of a BGR (opaque) or BGRA uint8 image."""
    h, w = img.shape[:2]
    alpha = img.shape[2] == 4
    b, g, r = (img[..., k].astype(np.uint32) for k in range(3))
    a = img[..., 3].astype(np.uint32) if alpha else np.full((h, w), 255,
                                                           np.uint32)
    argb = (a << 24) | (r << 16) | (g << 8) | b
    bw = Bits()
    bw.put(0x2f, 8)
    bw.put(w - 1, 14)
    bw.put(h - 1, 14)
    bw.put(int(alpha), 1)
    bw.put(0, 3)
    bw.put(1, 1)
    bw.put(2, 2)                       # subtract green
    cur = _sub_green(argb)
    bits = 4
    bw.put(1, 1)
    bw.put(0, 2)                       # predictor, mode 11 on every tile
    bw.put(bits - 2, 3)
    th, tw = -(-h // (1 << bits)), -(-w // (1 << bits))
    modes = np.full((th, tw), 11)
    _encode_stream((0xff000000 | (modes.astype(np.uint32) << 8)).astype(
        np.uint32), False, bw)
    cur = _predict_forward(cur, modes, bits)
    _encode_stream(cur, True, bw)
    return container(bw.bytes(), True)


# ------------------------------------------------ fuzzed VP8L streams

def _fuzz_codes(rng, bw, hists, cache_size):
    """Codes from histograms (a little noise added to some) for one
    group; written to `bw`."""
    codes = []
    for k, hist in enumerate(hists):
        size = (280 + cache_size) if k == 0 else (40 if k == 4 else 256)
        hist = hist.copy()
        if rng.random() < 0.3:
            hist += rng.integers(0, 2, size) * (rng.random() < 0.5)
        code = Code(hist)
        write_code(bw, code, size, rng)
        codes.append(code)
    return codes


def _hash(argb: int, bits: int) -> int:
    return ((0x1e35a7bd * argb) & 0xffffffff) >> (32 - bits)


def _fuzz_symbols(rng, flat, width, cache_bits):
    """A random parse of `flat` (ARGB) into literals, cache hits and
    copies the decoder reproduces: [(position, kind, payload)]."""
    n = flat.size
    cache = [0] * (1 << cache_bits) if cache_bits else None
    out = []
    i = 0
    dmap = _dist_map()
    vals = flat.tolist()
    while i < n:
        done = False
        if i > 0 and rng.random() < 0.35:
            if rng.random() < 0.5:
                code = int(rng.integers(1, 121))
                d = dmap[code - 1]
                dist = max(1, (d >> 4) * width + 8 - (d & 0xf))
            else:
                code = None
                dist = int(rng.choice([1, 2, width, width + 1,
                                       int(rng.integers(1, i + 1))]))
            if dist <= i:
                length = 0
                while (i + length < n and length < 4096
                       and vals[i + length] == vals[i + length - dist]):
                    length += 1
                if length:
                    length = int(rng.integers(1, length + 1))
                    if code is None:
                        code = dist + 120
                    out.append((i, 'copy', (length, code)))
                    if cache is not None:
                        for p in range(i, i + length):
                            cache[_hash(vals[p], cache_bits)] = vals[p]
                    i += length
                    done = True
        if done:
            continue
        v = vals[i]
        if cache is not None and cache[_hash(v, cache_bits)] == v \
                and rng.random() < 0.7:
            out.append((i, 'cache', _hash(v, cache_bits)))
        else:
            out.append((i, 'lit', v))
        if cache is not None:
            cache[_hash(v, cache_bits)] = v
        i += 1
    return out


def _write_symbols(rng, bw, flat, width, height, level0, cache_bits=None,
                   meta=None):
    """Colour cache, meta codes, codes and symbols of one stream."""
    if cache_bits is None:
        cache_bits = int(rng.integers(1, 12)) if rng.random() < 0.5 else 0
    if cache_bits:
        bw.put(1, 1)
        bw.put(cache_bits, 4)
    else:
        bw.put(0, 1)
    cache_size = 1 << cache_bits if cache_bits else 0
    groups = np.zeros(1, np.int64)
    hb = 0
    if level0:
        if meta is None:
            meta = rng.random() < 0.5
        if meta:
            hb = int(rng.integers(2, 6))
            th, tw = -(-height // (1 << hb)), -(-width // (1 << hb))
            ngroups = int(rng.integers(1, 5))
            groups = rng.integers(0, ngroups, (th, tw))
            if rng.random() < 0.3:      # a sparse group numbering
                groups = groups * int(rng.integers(2, 5))
            bw.put(1, 1)
            bw.put(hb - 2, 3)
            img = (0xff000000 | (groups.astype(np.uint32) << 8)).astype(
                np.uint32)
            _fuzz_stream(rng, img, level0=False, bw=bw)
        else:
            bw.put(0, 1)
    syms = _fuzz_symbols(rng, flat, width, cache_bits)
    ng = int(groups.max()) + 1
    hists = [[np.zeros(s, np.int64) for s in (280 + cache_size, 256, 256,
                                                256, 40)]
             for _ in range(ng)]

    def group_of(pos):
        if not hb:
            return 0
        y, x = divmod(pos, width)
        return int(groups[y >> hb, x >> hb])

    coded = []
    for pos, kind, payload in syms:
        g = group_of(pos)
        hs = hists[g]
        if kind == 'lit':
            v = payload
            parts = [(0, (v >> 8) & 0xff), (1, (v >> 16) & 0xff),
                     (2, v & 0xff), (3, v >> 24)]
            coded.append((g, parts, []))
        elif kind == 'cache':
            coded.append((g, [(0, 280 + payload)], []))
        else:
            length, code = payload
            ls, lb, lv = _prefix(length)
            ds, db, dv = _prefix(code)
            coded.append((g, [(0, 256 + ls)], [(lb, lv)])
                         + ((ds, db, dv),))
        for k, s in coded[-1][1]:
            hs[k][s] += 1
        if kind == 'copy':
            hs[4][coded[-1][3][0]] += 1
    codes = [_fuzz_codes(rng, bw, hists[g], cache_size) for g in range(ng)]
    for item in coded:
        g, parts, extra = item[:3]
        cs = codes[g]
        if extra:
            cs[0].put(bw, parts[0][1])
            bw.put(extra[0][1], extra[0][0])
            ds, db, dv = item[3]
            cs[4].put(bw, ds)
            bw.put(dv, db)
        else:
            for k, s in parts:
                cs[k].put(bw, s)


def _fuzz_stream(rng, argb, level0=True, bw=None,
                 header=None) -> Stream:
    """A random valid VP8L stream of `argb` (h x w): with `level0` random
    transforms first (each at most once, colour indexing first when it
    fits), then cache, meta codes and symbols."""
    st = Stream()
    if bw is not None:
        st.bw = bw
    bw = st.bw
    if header is not None:
        bw.put(0x2f, 8)
        bw.put(argb.shape[1] - 1, 14)
        bw.put(argb.shape[0] - 1, 14)
        bw.put(header, 1)
        bw.put(0, 3)
    cur = argb.astype(np.uint32)
    h, w = cur.shape
    if level0:
        colours = np.unique(cur)
        kinds = ['green', 'predict', 'cross']
        rng.shuffle(kinds)
        kinds = kinds[:int(rng.integers(0, 4))]
        if colours.size <= 256 and rng.random() < 0.6:
            kinds = ['index'] + kinds
        for kind in kinds:
            bw.put(1, 1)
            if kind == 'index':
                pal = colours.copy()
                rng.shuffle(pal)
                n = pal.size
                bw.put(3, 2)
                bw.put(n - 1, 8)
                delta = _channels(pal)
                delta[1:] -= _channels(pal)[:-1]
                _fuzz_stream(rng, _pack(delta)[None, :], level0=False, bw=bw)
                index = np.searchsorted(np.sort(pal), cur)
                order = np.argsort(pal)
                idx = order[index]
                bits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
                per = 1 << bits
                pw = -(-w // per)
                padded = np.zeros((h, pw * per), np.int64)
                padded[:, :w] = idx
                bpp = 8 >> bits
                packed = np.zeros((h, pw), np.int64)
                for k in range(per):
                    packed |= padded[:, k::per] << (k * bpp)
                cur = (0xff000000 | (packed.astype(np.uint32) << 8)).astype(
                    np.uint32)
                w = pw
            elif kind == 'green':
                bw.put(2, 2)
                cur = _sub_green(cur)
            elif kind == 'predict':
                bits = int(rng.integers(2, 10))
                bw.put(0, 2)
                bw.put(bits - 2, 3)
                th, tw = -(-h // (1 << bits)), -(-w // (1 << bits))
                modes = rng.integers(0, 16, (th, tw))
                _fuzz_stream(rng, (rng.integers(0, 1 << 32, (th, tw),
                                                dtype=np.uint64)
                                   .astype(np.uint32) & 0xfffff0ff)
                             | (modes.astype(np.uint32) << 8),
                             level0=False, bw=bw)
                cur = _predict_forward(cur, modes, bits)
            else:
                bits = int(rng.integers(2, 10))
                bw.put(1, 2)
                bw.put(bits - 2, 3)
                th, tw = -(-h // (1 << bits)), -(-w // (1 << bits))
                mult = rng.integers(0, 256, (th, tw, 3))
                code = (0xff000000 | (mult[..., 2] << 16) | (mult[..., 1] << 8)
                        | mult[..., 0]).astype(np.uint32)
                _fuzz_stream(rng, code, level0=False, bw=bw)
                cur = _cross_color_forward(cur, mult, bits)
        bw.put(0, 1)
    _write_symbols(rng, bw, cur.reshape(-1), w, h, level0)
    return st


def fuzz_lossless(rng: np.random.Generator, h: int, w: int,
                  colours: Optional[int] = None, alpha: bool = True
                  ) -> Tuple[bytes, np.ndarray]:
    """A random valid VP8L file and the BGRA pixels it holds."""
    if colours is None:
        colours = int(rng.choice([2, 3, 4, 5, 16, 17, 200, 0]))
    if colours:
        pal = rng.integers(0, 1 << 32, colours, dtype=np.uint64).astype(
            np.uint32)
        argb = pal[rng.integers(0, colours, (h, w))]
    else:
        yy, xx = np.mgrid[0:h, 0:w]
        base = ((xx * 7 + yy * 3) % 256).astype(np.uint32) * 0x010101
        argb = (base ^ rng.integers(0, 16, (h, w)).astype(np.uint32)
                * 0x01010101)
    if not alpha:
        argb = argb | 0xff000000
    argb = argb.astype(np.uint32)
    data = _fuzz_stream(rng, argb, header=int(alpha)).bytes()
    bgra = argb.view(np.uint8).reshape(h, w, 4)
    return container(data, True), bgra


# --------------------------------------------------------------- VP8

def _read_table(name: str, size: int) -> List[int]:
    """A constant table of `csrc/webp_decode.cpp` (RFC 6386's
    probabilities, the lossless distance map)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..',
                        '..', 'hrfuser_tpu_torch', 'csrc', 'webp_decode.cpp')
    with open(path) as f:
        text = f.read()
    m = re.search(name + r'\[[^=]*=\s*\{([^;]*)\};', text)
    vals = [int(v) for v in re.findall(r'\d+', m.group(1))]
    assert len(vals) == size, (name, len(vals))
    return vals


_TABLES = {}


def _vp8_tables():
    if not _TABLES:
        _TABLES['proba0'] = np.array(_read_table('kCoeffProba0', 1056),
                                     np.int64).reshape(4, 8, 3, 11)
        _TABLES['update'] = np.array(_read_table('kCoeffUpdate', 1056),
                                     np.int64).reshape(4, 8, 3, 11)
        _TABLES['bmode'] = np.array(_read_table('kBModeProba', 900),
                                    np.int64).reshape(10, 10, 9)
    return _TABLES


DC_TABLE = [
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20,
    20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28, 29, 30, 31, 32, 33,
    34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 46, 47, 48, 49,
    50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 66, 67,
    68, 69, 70, 71, 72, 73, 74, 75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84,
    85, 86, 87, 88, 89, 91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108,
    110, 112, 114, 116, 118, 122, 124, 126, 128, 130, 132, 134, 136, 138,
    140, 143, 145, 148, 151, 154, 157]
AC_TABLE = [
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
    23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40,
    41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    60, 62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92, 94,
    96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128,
    131, 134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170,
    173, 177, 181, 185, 189, 193, 197, 201, 205, 209, 213, 217, 221, 225,
    229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284]
ZIGZAG = [0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15]
BANDS = [0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0]
_CATS = [[173, 148, 140], [176, 155, 140, 135], [180, 157, 141, 134, 130],
         [254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129]]
# libwebp's mode numbers: B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL,
# B_HD, B_HU; 16x16 and chroma: DC 0, TM 1, V 2, H 3
DC, TM, V, H = 0, 1, 2, 3
# each 4x4 mode's path in the B_PRED tree: (probability index, bit)
_BMODE_PATH = {0: [(0, 0)], 1: [(0, 1), (1, 0)],
               2: [(0, 1), (1, 1), (2, 0)],
               3: [(0, 1), (1, 1), (2, 1), (3, 0), (4, 0)],
               4: [(0, 1), (1, 1), (2, 1), (3, 0), (4, 1), (5, 0)],
               5: [(0, 1), (1, 1), (2, 1), (3, 0), (4, 1), (5, 1)],
               6: [(0, 1), (1, 1), (2, 1), (3, 1), (6, 0)],
               7: [(0, 1), (1, 1), (2, 1), (3, 1), (6, 1), (7, 0)],
               8: [(0, 1), (1, 1), (2, 1), (3, 1), (6, 1), (7, 1), (8, 0)],
               9: [(0, 1), (1, 1), (2, 1), (3, 1), (6, 1), (7, 1), (8, 1)]}
_YMODE_PATH = {DC: [(145, 1), (156, 0), (163, 0)],
               V: [(145, 1), (156, 0), (163, 1)],
               H: [(145, 1), (156, 1), (128, 0)],
               TM: [(145, 1), (156, 1), (128, 1)]}
_UVMODE_PATH = {DC: [(142, 0)], V: [(142, 1), (114, 0)],
                H: [(142, 1), (114, 1), (183, 0)],
                TM: [(142, 1), (114, 1), (183, 1)]}


class MB:
    """One macroblock's decisions: segment, skip, modes, and quantised
    levels in zigzag order: y2 [16] (16x16 modes), y [16, 16], u and v
    [4, 16]."""

    def __init__(self):
        self.segment = 0
        self.skip = 0
        self.is_i4x4 = False
        self.ymode = DC
        self.imodes = [0] * 16
        self.uvmode = DC
        self.y2 = np.zeros(16, np.int64)
        self.y = np.zeros((16, 16), np.int64)
        self.u = np.zeros((4, 16), np.int64)
        self.v = np.zeros((4, 16), np.int64)

    def empty(self):
        return not (self.y2.any() or self.y[:, 0 if self.is_i4x4 else 1:]
                    .any() or self.u.any() or self.v.any())


def _write_large(e: BoolEncoder, p, v: int):
    """GetLargeValue's tree for v >= 2."""
    if v <= 4:
        e.put(0, p[3])
        if v == 2:
            e.put(0, p[4])
        else:
            e.put(1, p[4])
            e.put(v - 3, p[5])
    elif v <= 10:
        e.put(1, p[3])
        e.put(0, p[6])
        if v <= 6:
            e.put(0, p[7])
            e.put(v - 5, 159)
        else:
            e.put(1, p[7])
            e.put((v - 7) >> 1, 165)
            e.put((v - 7) & 1, 145)
    else:
        e.put(1, p[3])
        e.put(1, p[6])
        for cat, probs in enumerate(_CATS):
            nb = len(probs)
            base = 3 + (8 << cat)
            if v < base + (1 << nb) or cat == 3:
                break
        e.put(cat >> 1, p[8])
        e.put(cat & 1, p[9 + (cat >> 1)])
        rest = v - base
        for k, pr in enumerate(probs):
            e.put((rest >> (nb - 1 - k)) & 1, pr)


def _write_coeffs(e: BoolEncoder, proba, typ: int, ctx: int, levels,
                  first: int) -> int:
    """One block's tokens; returns the decoder's nz (position after the
    last token)."""
    nzs = [n for n in range(first, 16) if levels[n]]
    last = nzs[-1] if nzs else -1
    n = first
    p = proba[typ][BANDS[n]][ctx]
    while n < 16:
        if n > last:
            e.put(0, p[0])
            return n
        e.put(1, p[0])
        while levels[n] == 0:
            e.put(0, p[1])
            n += 1
            p = proba[typ][BANDS[n]][0]
        e.put(1, p[1])
        v = abs(int(levels[n]))
        if v == 1:
            e.put(0, p[2])
            nxt = 1
        else:
            e.put(1, p[2])
            _write_large(e, p, v)
            nxt = 2
        e.put(int(levels[n] < 0), 128)
        n += 1
        p = proba[typ][BANDS[n]][nxt]
    return 16


class VP8Frame:
    """Writes a key frame from its header and macroblock decisions."""

    def __init__(self, width, height, **hdr):
        self.width, self.height = width, height
        self.mb_w, self.mb_h = (width + 15) >> 4, (height + 15) >> 4
        self.h = dict(profile=0, use_segment=0, update_map=0,
                      update_data=0, absolute=1, quant=[0] * 4,
                      lf=[0] * 4, seg_probs=[255] * 3, simple=0, level=0,
                      sharpness=0, use_lf_delta=0, update_lf=0,
                      ref_delta=[0] * 4, mode_delta=[0] * 4, parts=0,
                      base_q=40, dq=[0] * 5, updates={}, skip_prob=None)
        self.h.update(hdr)

    def quant(self, segment: int):
        """(y1, y2, uv) dequantisation factors (dc, ac) of a segment."""
        h = self.h
        q = h['base_q']
        if h['use_segment']:
            q = h['quant'][segment] + (0 if h['absolute'] else q)
        d = h['dq']

        def c(v, m=127):
            return min(max(v, 0), m)
        y2ac = (AC_TABLE[c(q + d[2])] * 101581) >> 16
        return ((DC_TABLE[c(q + d[0])], AC_TABLE[c(q)]),
                (DC_TABLE[c(q + d[1])] * 2, max(y2ac, 8)),
                (DC_TABLE[c(q + d[3], 117)], AC_TABLE[c(q + d[4])]))

    def proba(self):
        t = _vp8_tables()
        p = t['proba0'].copy()
        for (a, b, c, k), v in self.h['updates'].items():
            p[a, b, c, k] = v
        return p

    def bitstream(self, mbs: List[List[MB]]) -> bytes:
        h = self.h
        t = _vp8_tables()
        e = BoolEncoder()
        e.put(0, 128)                     # colour space
        e.put(0, 128)                     # clamping
        e.put(h['use_segment'], 128)
        if h['use_segment']:
            e.put(h['update_map'], 128)
            e.put(h['update_data'], 128)
            if h['update_data']:
                e.put(h['absolute'], 128)
                for v in h['quant']:
                    e.flag_signed(v, 7)
                for v in h['lf']:
                    e.flag_signed(v, 6)
            if h['update_map']:
                for v in h['seg_probs']:
                    e.put(int(v != 255), 128)
                    if v != 255:
                        e.value_bits(v, 8)
        e.put(h['simple'], 128)
        e.value_bits(h['level'], 6)
        e.value_bits(h['sharpness'], 3)
        e.put(h['use_lf_delta'], 128)
        if h['use_lf_delta']:
            e.put(h['update_lf'], 128)
            if h['update_lf']:
                for v in h['ref_delta'] + h['mode_delta']:
                    e.flag_signed(v, 6)
        e.value_bits(h['parts'], 2)
        e.value_bits(h['base_q'], 7)
        for v in h['dq']:
            e.flag_signed(v, 4)
        e.put(0, 128)                     # refresh entropy probs
        upd = t['update']
        for a in range(4):
            for b in range(8):
                for c in range(3):
                    for k in range(11):
                        key = (a, b, c, k)
                        if key in h['updates']:
                            e.put(1, int(upd[a, b, c, k]))
                            e.value_bits(h['updates'][key], 8)
                        else:
                            e.put(0, int(upd[a, b, c, k]))
        skip_prob = h['skip_prob']
        e.put(int(skip_prob is not None), 128)
        if skip_prob is not None:
            e.value_bits(skip_prob, 8)
        bmode = t['bmode']
        intra_t = [0] * (4 * self.mb_w)
        for row in mbs:
            intra_l = [0] * 4
            for x, mb in enumerate(row):
                if h['use_segment'] and h['update_map']:
                    sp = h['seg_probs']
                    s = mb.segment
                    e.put(s >> 1, sp[0])
                    e.put(s & 1, sp[1 + (s >> 1)])
                if skip_prob is not None:
                    e.put(mb.skip, skip_prob)
                top = intra_t[4 * x:4 * x + 4]
                if not mb.is_i4x4:
                    for pr, bit in _YMODE_PATH[mb.ymode]:
                        e.put(bit, pr)
                    top = [mb.ymode] * 4
                    intra_l = [mb.ymode] * 4
                else:
                    e.put(0, 145)
                    for yy in range(4):
                        left = intra_l[yy]
                        for xx in range(4):
                            m = mb.imodes[yy * 4 + xx]
                            probs = bmode[top[xx]][left]
                            for k, bit in _BMODE_PATH[m]:
                                e.put(bit, int(probs[k]))
                            top[xx] = m
                            left = m
                        intra_l[yy] = left
                intra_t[4 * x:4 * x + 4] = top
                for pr, bit in _UVMODE_PATH[mb.uvmode]:
                    e.put(bit, pr)
        part0 = e.finish()
        nparts = 1 << h['parts']
        encs = [BoolEncoder() for _ in range(nparts)]
        proba = self.proba().tolist()
        top_nz = [[0] * 9 for _ in range(self.mb_w)]
        for y, row in enumerate(mbs):
            te = encs[y & (nparts - 1)]
            left = [0] * 9
            for x, mb in enumerate(row):
                tn = top_nz[x]
                if skip_prob is not None and mb.skip:
                    for k in range(8):
                        tn[k] = left[k] = 0
                    if not mb.is_i4x4:
                        tn[8] = left[8] = 0
                    continue
                first, typ = 0, 3
                if not mb.is_i4x4:
                    nz = _write_coeffs(te, proba, 1, tn[8] + left[8],
                                       mb.y2.tolist(), 0)
                    tn[8] = left[8] = int(nz > 0)
                    first, typ = 1, 0
                for b in range(16):
                    bx, by = b & 3, b >> 2
                    nz = _write_coeffs(te, proba, typ, tn[bx] + left[by],
                                       mb.y[b].tolist(), first)
                    tn[bx] = left[by] = int(nz > first)
                for ci, blocks in enumerate((mb.u, mb.v)):
                    for b in range(4):
                        bx, by = b & 1, b >> 1
                        k_t, k_l = 4 + 2 * ci + bx, 4 + 2 * ci + by
                        nz = _write_coeffs(te, proba, 2, tn[k_t] + left[k_l],
                                           blocks[b].tolist(), 0)
                        tn[k_t] = left[k_l] = int(nz > 0)
        parts = [pe.finish() for pe in encs]
        tag = (0 | h['profile'] << 1 | 1 << 4 | len(part0) << 5)
        out = bytearray(struct.pack('<I', tag)[:3])
        out += b'\x9d\x01\x2a' + struct.pack('<HH', self.width, self.height)
        out += part0
        for p in parts[:-1]:
            out += struct.pack('<I', len(p))[:3]
        for p in parts:
            out += p
        return bytes(out)


# ---- transforms for the real encoder

def _fdct(blocks: np.ndarray) -> np.ndarray:
    """libwebp's forward DCT of residual blocks [..., 4, 4]."""
    d = blocks.astype(np.int64)
    a0, a1 = d[..., 0] + d[..., 3], d[..., 1] + d[..., 2]
    a2, a3 = d[..., 1] - d[..., 2], d[..., 0] - d[..., 3]
    tmp = np.stack([(a0 + a1) * 8, (a2 * 2217 + a3 * 5352 + 1812) >> 9,
                    (a0 - a1) * 8, (a3 * 2217 - a2 * 5352 + 937) >> 9], -1)
    t = tmp
    a0, a1 = t[..., 0, :] + t[..., 3, :], t[..., 1, :] + t[..., 2, :]
    a2, a3 = t[..., 1, :] - t[..., 2, :], t[..., 0, :] - t[..., 3, :]
    out = np.stack([(a0 + a1 + 7) >> 4,
                    ((a2 * 2217 + a3 * 5352 + 12000) >> 16) + (a3 != 0),
                    (a0 - a1 + 7) >> 4,
                    (a3 * 2217 - a2 * 5352 + 51000) >> 16], -2)
    return out


def _idct_add(coefs: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """The decoder's inverse DCT of [..., 16] coefficients added to
    [..., 4, 4] predictions, clipped."""
    c = coefs.astype(np.int64).reshape(coefs.shape[:-1] + (4, 4))

    def m1(a):
        return ((a * 20091) >> 16) + a

    def m2(a):
        return (a * 35468) >> 16
    a = c[..., 0, :] + c[..., 2, :]
    b = c[..., 0, :] - c[..., 2, :]
    cc = m2(c[..., 1, :]) - m1(c[..., 3, :])
    d = m1(c[..., 1, :]) + m2(c[..., 3, :])
    tmp = np.stack([a + d, b + cc, b - cc, a - d], -1)   # [.., col, row]
    dc = tmp[..., 0, :] + 4
    a = dc + tmp[..., 2, :]
    b = dc - tmp[..., 2, :]
    cc = m2(tmp[..., 1, :]) - m1(tmp[..., 3, :])
    d = m1(tmp[..., 1, :]) + m2(tmp[..., 3, :])
    out = np.stack([a + d, b + cc, b - cc, a - d], -1) >> 3
    return np.clip(pred.astype(np.int64) + out, 0, 255)


def _rgb_to_yuv(bgr: np.ndarray):
    """BT.601 limited range, 4:2:0 by 2x2 averages (edges replicated)."""
    f = bgr.astype(np.float64)
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    y = 16 + (65.481 * r + 128.553 * g + 24.966 * b) / 255
    u = 128 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255
    v = 128 + (112.0 * r - 93.786 * g - 18.214 * b) / 255
    h, w = y.shape
    ph, pw = h + (h & 1), w + (w & 1)

    def sub(c):
        c = np.pad(c, ((0, ph - h), (0, pw - w)), mode='edge')
        return (c[0::2, 0::2] + c[1::2, 0::2] + c[0::2, 1::2]
                + c[1::2, 1::2]) / 4
    return (np.clip(np.rint(y), 0, 255), np.clip(np.rint(sub(u)), 0, 255),
            np.clip(np.rint(sub(v)), 0, 255))


def _quantise(c, q):
    return np.clip(np.sign(c) * ((np.abs(c) + q // 2) // q), -2048, 2048)


def _predict_batch(rec: np.ndarray, ys, xs, n: int):
    """DC and TM predictions [2, k, n, n] of the k macroblocks at block
    rows `ys`, columns `xs`, from `rec` (the reconstruction with a border:
    127 above, 129 to the left, 127 in its corner)."""
    y0, x0 = ys * n, xs * n
    ar = np.arange(n)
    top = rec[y0[:, None], x0[:, None] + 1 + ar]
    left = rec[y0[:, None] + 1 + ar, x0[:, None]]
    tl = rec[y0, x0]
    st, sl = top.sum(1), left.sum(1)
    shift = 4 if n == 16 else 3
    dc = np.where((ys > 0) & (xs > 0), (st + sl + n) >> (shift + 1),
                  np.where(ys > 0, (st + n // 2) >> shift,
                           np.where(xs > 0, (sl + n // 2) >> shift, 128)))
    dcp = np.broadcast_to(dc[:, None, None], (len(ys), n, n))
    tm = np.clip(top[:, None, :] + left[:, :, None] - tl[:, None, None], 0,
                 255)
    return np.stack([dcp, tm])


def _blocks(a: np.ndarray, n: int) -> np.ndarray:
    """[k, n, n] -> [k, (n/4)^2, 4, 4] raster 4x4 blocks."""
    k = a.shape[0]
    m = n // 4
    return a.reshape(k, m, 4, m, 4).transpose(0, 1, 3, 2, 4).reshape(
        k, m * m, 4, 4)


def _unblocks(b: np.ndarray, n: int) -> np.ndarray:
    k = b.shape[0]
    m = n // 4
    return b.reshape(k, m, m, 4, 4).transpose(0, 1, 3, 2, 4).reshape(k, n, n)


def _iwht_batch(y2: np.ndarray) -> np.ndarray:
    """The decoder's inverse WHT of [k, 16] -> [k, 16] block DCs."""
    d = y2.astype(np.int64)
    a0, a1 = d[:, 0:4] + d[:, 12:16], d[:, 4:8] + d[:, 8:12]
    a2, a3 = d[:, 4:8] - d[:, 8:12], d[:, 0:4] - d[:, 12:16]
    t = np.concatenate([a0 + a1, a3 + a2, a0 - a1, a3 - a2], 1)
    t = t.reshape(-1, 4, 4)                  # [k, i, j] = tmp[i * 4 + j]
    dc = t[:, :, 0] + 3
    a0, a1 = dc + t[:, :, 3], t[:, :, 1] + t[:, :, 2]
    a2, a3 = t[:, :, 1] - t[:, :, 2], dc - t[:, :, 3]
    return np.stack([(a0 + a1) >> 3, (a3 + a2) >> 3, (a0 - a1) >> 3,
                     (a3 - a2) >> 3], 2).reshape(-1, 16)


def _fwht_batch(dc: np.ndarray) -> np.ndarray:
    """libwebp's forward WHT of [k, 4, 4] block DCs -> [k, 16]."""
    d = dc.astype(np.int64)
    a0, a1 = d[:, :, 0] + d[:, :, 2], d[:, :, 1] + d[:, :, 3]
    a2, a3 = d[:, :, 1] - d[:, :, 3], d[:, :, 0] - d[:, :, 2]
    t = np.stack([a0 + a1, a3 + a2, a3 - a2, a0 - a1], 2)
    a0, a1 = t[:, 0] + t[:, 2], t[:, 1] + t[:, 3]
    a2, a3 = t[:, 1] - t[:, 3], t[:, 0] - t[:, 2]
    return np.stack([(a0 + a1) >> 1, (a3 + a2) >> 1, (a3 - a2) >> 1,
                     (a0 - a1) >> 1], 1).reshape(-1, 16)


def lossy(bgr: np.ndarray, q: int = 40, level: int = 20,
          parts: int = 0) -> bytes:
    """A real VP8 bitstream (no container) of a BGR uint8 image. The
    macroblocks of one anti-diagonal depend on none of each other, so
    each diagonal is one batch of whole-array steps."""
    hgt, wid = bgr.shape[:2]
    frame = VP8Frame(wid, hgt, base_q=q, level=level, sharpness=2,
                     parts=parts, skip_prob=200)
    mw, mh = frame.mb_w, frame.mb_h
    src = []
    for c, n in zip(_rgb_to_yuv(bgr), (16, 8, 8)):
        src.append(np.pad(c, ((0, mh * n - c.shape[0]),
                              (0, mw * n - c.shape[1])),
                          mode='edge').astype(np.int64))
    rec = []
    for n in (16, 8, 8):
        r = np.zeros((mh * n + 1, mw * n + 1), np.int64)
        r[0, :] = 127
        r[1:, 0] = 129
        rec.append(r)
    y1, y2, uv = frame.quant(0)
    qy1 = np.array([y1[0]] + [y1[1]] * 15)
    qy2 = np.array([y2[0]] + [y2[1]] * 15)
    quv = np.array([uv[0]] + [uv[1]] * 15)
    mbs = [[MB() for _ in range(mw)] for _ in range(mh)]
    zz = np.array(ZIGZAG)
    for d in range(mw + mh - 1):
        ys = np.arange(max(0, d - mw + 1), min(mh, d + 1))
        xs = d - ys
        k = len(ys)
        # luma: 16x16 DC or TM, the closer
        preds = _predict_batch(rec[0], ys, xs, 16)
        blk = np.stack([src[0][y * 16:y * 16 + 16, x * 16:x * 16 + 16]
                        for y, x in zip(ys, xs)])
        sad = np.abs(blk[None] - preds).sum((2, 3))
        ymode = np.argmin(sad, 0)
        pred = preds[ymode, np.arange(k)]
        coef = _fdct(_blocks(blk - pred, 16)).reshape(k, 16, 16)
        y2lev = _quantise(_fwht_batch(coef[:, :, 0].reshape(k, 4, 4)), qy2)
        aclev = _quantise(coef, qy1)
        deq = aclev * qy1
        deq[:, :, 0] = _iwht_batch(y2lev * qy2)
        out = _unblocks(_idct_add(deq, _blocks(pred, 16)), 16)
        for i, (y, x) in enumerate(zip(ys, xs)):
            rec[0][1 + y * 16:17 + y * 16, 1 + x * 16:17 + x * 16] = out[i]
        # chroma: one mode for both planes
        cp = [_predict_batch(rec[c], ys, xs, 8) for c in (1, 2)]
        cb = [np.stack([src[c][y * 8:y * 8 + 8, x * 8:x * 8 + 8]
                        for y, x in zip(ys, xs)]) for c in (1, 2)]
        sad = sum(np.abs(b[None] - p).sum((2, 3)) for b, p in zip(cb, cp))
        uvmode = np.argmin(sad, 0)
        clev = []
        for c, b, p in zip((1, 2), cb, cp):
            pr = p[uvmode, np.arange(k)]
            lev = _quantise(_fdct(_blocks(b - pr, 8)).reshape(k, 4, 16), quv)
            clev.append(lev)
            o = _unblocks(_idct_add(lev * quv, _blocks(pr, 8)), 8)
            for i, (y, x) in enumerate(zip(ys, xs)):
                rec[c][1 + y * 8:9 + y * 8, 1 + x * 8:9 + x * 8] = o[i]
        for i, (y, x) in enumerate(zip(ys, xs)):
            mb = mbs[y][x]
            mb.ymode = (DC, TM)[ymode[i]]
            mb.uvmode = (DC, TM)[uvmode[i]]
            mb.y2 = y2lev[i][zz]
            mb.y = aclev[i][:, zz]
            mb.y[:, 0] = 0
            mb.u = clev[0][i][:, zz]
            mb.v = clev[1][i][:, zz]
            mb.skip = int(mb.empty())
    return frame.bitstream(mbs)


def fuzz_lossy(rng: np.random.Generator, h: int, w: int) -> bytes:
    """A random valid VP8 bitstream (no container): random header
    fields, modes and sparse coefficients kept where the decoder's
    transforms stay within 16 bits."""
    use_segment = int(rng.random() < 0.6)
    hdr = dict(
        profile=int(rng.integers(0, 4)), use_segment=use_segment,
        update_map=int(use_segment and rng.random() < 0.8),
        update_data=int(use_segment and rng.random() < 0.8),
        absolute=int(rng.random() < 0.5),
        quant=[int(v) for v in rng.integers(-30, 60, 4)],
        lf=[int(v) for v in rng.integers(-20, 40, 4)],
        seg_probs=[int(v) for v in rng.choice([255, 1, 60, 128, 200], 3)],
        simple=int(rng.random() < 0.4), level=int(rng.choice(
            [0, 1, 8, 20, 40, 63])), sharpness=int(rng.integers(0, 8)),
        use_lf_delta=int(rng.random() < 0.6), update_lf=int(rng.random()
                                                              < 0.8),
        ref_delta=[int(v) for v in rng.integers(-20, 20, 4)],
        mode_delta=[int(v) for v in rng.integers(-20, 20, 4)],
        parts=int(rng.integers(0, 4)), base_q=int(rng.integers(0, 128)),
        dq=[int(v) for v in rng.integers(-15, 16, 5)],
        skip_prob=int(rng.integers(1, 256)) if rng.random() < 0.7 else None)
    if not use_segment:
        hdr['update_map'] = hdr['update_data'] = 0
    ups = {}
    for _ in range(int(rng.integers(0, 40))):
        key = tuple(int(v) for v in (rng.integers(0, 4), rng.integers(0, 8),
                                     rng.integers(0, 3), rng.integers(0, 11)))
        ups[key] = int(rng.integers(1, 256))
    hdr['updates'] = ups
    frame = VP8Frame(w, h, **hdr)
    mbs = []
    density = float(rng.choice([0.05, 0.2, 0.5]))

    def levels(n, q, first=0):
        out = np.zeros(n, np.int64)
        top = max(1, 1024 // q)
        for k in range(first, n):
            if rng.random() < density:
                mag = int(rng.choice([1, 2, 3, 4, 6, 9, 15, 40, 120, 600]))
                out[k] = min(mag, top) * (1 if rng.random() < 0.5 else -1)
        return out

    for _ in range(frame.mb_h):
        row = []
        for _ in range(frame.mb_w):
            mb = MB()
            mb.segment = int(rng.integers(0, 4)) if hdr['update_map'] else 0
            y1, y2, uv = frame.quant(mb.segment)
            mb.is_i4x4 = bool(rng.random() < 0.5)
            mb.ymode = int(rng.integers(0, 4))
            mb.imodes = [int(v) for v in rng.integers(0, 10, 16)]
            mb.uvmode = int(rng.integers(0, 4))
            if hdr['skip_prob'] is not None and rng.random() < 0.3:
                mb.skip = 1
            else:
                if not mb.is_i4x4:
                    mb.y2 = levels(16, max(y2) * 4)
                for b in range(16):
                    mb.y[b] = levels(16, max(y1), 0 if mb.is_i4x4 else 1)
                for b in range(4):
                    mb.u[b] = levels(16, max(uv))
                    mb.v[b] = levels(16, max(uv))
                if hdr['skip_prob'] is not None:
                    mb.skip = int(mb.empty())
            row.append(mb)
        mbs.append(row)
    return frame.bitstream(mbs)


# ------------------------------------------------- files for the checks

def camera_frames(img: np.ndarray, with_lossless: bool = True
                  ) -> Dict[str, bytes]:
    """A BGR camera frame as lossy VP8, lossy VP8X + ALPH (a VP8L-coded,
    gradient-filtered alpha plane) and, `with_lossless`, lossless VP8L."""
    h, w = img.shape[:2]
    vp8 = lossy(img, q=30)
    yy, xx = np.mgrid[0:h, 0:w]
    alpha = ((xx * 255) // max(w - 1, 1) ^ (yy & 8) * 4).astype(np.uint8)
    out = {'lossy': container(vp8, False),
           'lossy_alpha': with_alpha(vp8, w, h, alph(alpha, 1, 3))}
    if with_lossless:
        out['lossless'] = lossless(img)
    return out


# SHA-256 of cv2 5.0's decode of `camera_frames(camera(0))`: the lossy
# frame read colour, and the lossy frame with alpha in each mode
PINNED: Dict[str, str] = {
    'lossy color':
        '3b0d96eea9fc32773cbcac0b8f76461ad8231a3f0375e39cd07c76b6665388c0',
    'lossy_alpha color':
        '3b0d96eea9fc32773cbcac0b8f76461ad8231a3f0375e39cd07c76b6665388c0',
    'lossy_alpha unchanged':
        '59422883c0cc9fe09d3f348bfa15968589f7513866f71e2a8ad4cc91df7f824c',
    'lossy_alpha grayscale':
        '318ccce29e142c187db42915eb4db16f502e8c380cb0dedb5a2132a91e71dda6',
}


def camera(seed: int = 0, hw: Tuple[int, int] = (900, 1600)) -> np.ndarray:
    """A camera-like uint8 BGR frame, `chip_smoke.py`'s `_camera_image`:
    smooth ramps and uniform noise."""
    rng = np.random.default_rng(seed)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 200 / w, yy * 200 / h, (xx + yy) * 100 / (h + w)],
                   -1) + rng.integers(0, 40, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)
