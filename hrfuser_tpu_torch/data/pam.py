"""PAM (`P7`) decoding in numpy, as `cv2` 5.0's `PAMDecoder`
(`imgcodecs/src/grfmt_pam.cpp`) reads it.

Header lines `WIDTH`, `HEIGHT`, `DEPTH`, `MAXVAL` (each once, numbers as
C's `strtol(s, 0, 0)` reads them), `TUPLTYPE` and `ENDHDR`; comments
(`#`) and unknown fields are skipped. `TUPLTYPE` is one of
`BLACKANDWHITE`, `GRAYSCALE`, `GRAYSCALE_ALPHA`, `RGB`, `RGB_ALPHA`, with
the depth it names (1, 1, 2, 3, 4); any other tuple type is refused.
Without one, `cv2` takes depth 1 as grey (`MAXVAL` 1: black and white)
and depth 3 as RGB, both only up to `MAXVAL` 255, and refuses anything
else: a 16-bit or a 4-channel PAM without a tuple type does not read.
Samples are 8-bit up to `MAXVAL` 255, big-endian 16-bit above.

What `cv2.imdecode` returns, and so `imdecode(data, flag)`:
  * 'unchanged': the samples as stored, channels in the file's order
    (an RGB PAM stays RGB), [H, W] for depth 1;
  * 'color': uint8 (16-bit samples as `v >> 8`), depth 1 repeated, an
    RGB PAM again in the file's order (`cv2` does not swap it);
  * 'grayscale': uint8, an RGB PAM through `cvt.bgr_to_grey` with red
    first, a GRAYSCALE_ALPHA PAM as pixel x // 3's grey sample at x (the
    row conversion of `cv2` writes 3 bytes a source pixel);
  * `MAXVAL` 1 (any tuple type): each row's first bytes read as packed
    bits, 1 = 255, as `cv2` does.
`cv2` leaves part of the image unwritten (uninitialised memory) for
GRAYSCALE_ALPHA and RGB_ALPHA read 'color' wider than one pixel, and for
RGB_ALPHA read 'grayscale' unless 3 ceil(W / 4) >= W; no answer is
defined there, and these raise `ValueError` naming the case, as every
header `cv2` refuses and data that ends early do.
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np

from hrfuser_tpu_torch.data import cvt
from hrfuser_tpu_torch.data.pxm import SPACE

# tuple type -> depth
TUPLTYPES = {'BLACKANDWHITE': 1, 'GRAYSCALE': 1, 'GRAYSCALE_ALPHA': 2,
             'RGB': 3, 'RGB_ALPHA': 4}
_FIELDS = ('WIDTH', 'HEIGHT', 'DEPTH', 'MAXVAL', 'TUPLTYPE')
_STRTOL = re.compile(rb'[ \t\n\v\f\r]*([+-]?)(0[xX][0-9a-fA-F]+|[1-9][0-9]*'
                     rb'|0[0-7]*)')


def matches(data: bytes) -> bool:
    """`PAMDecoder::checkSignature`: `P7` and a space byte."""
    return len(data) >= 3 and data[:2] == b'P7' and data[2] in SPACE


def _strtol(value: bytes) -> int:
    m = _STRTOL.match(value)
    if m is None:
        raise ValueError(f'PAM: header value {value!r} is not a number')
    digits = m.group(2)
    base = 16 if digits[1:2] in (b'x', b'X') else 8 if len(digits) > 1 \
        and digits[:1] == b'0' else 10
    v = int(digits, base) * (-1 if m.group(1) == b'-' else 1)
    if not -2 ** 31 <= v < 2 ** 31:
        raise ValueError(f'PAM: header value {value!r} out of range')
    return v


def _header(data: bytes) -> Tuple[dict, int]:
    """The header fields, and the offset of the samples."""
    pos, fields = 3, {}

    def byte():
        nonlocal pos
        if pos >= len(data):
            raise ValueError('PAM: the file ends inside its header')
        pos += 1
        return data[pos - 1]

    while True:
        code = byte()
        while code in SPACE:
            code = byte()
        if code == 0x23:                                    # a comment
            while code not in (0x0a, 0x0d):
                code = byte()
            continue
        name = bytearray()
        for _ in range(8):
            name.append(code)
            code = byte()
            if code in SPACE:
                break
        else:
            raise ValueError(f'PAM: header field {bytes(name)!r}... longer '
                             f'than 8 bytes')
        name = name.decode('latin-1')
        if name == 'ENDHDR':
            return fields, pos
        while code in SPACE:
            code = byte()
        value = bytearray()
        for _ in range(255):
            value.append(code)
            code = byte()
            if code in (0x0a, 0x0d):
                break
        else:
            raise ValueError(f'PAM: header value of {name} longer than 255 '
                             f'bytes')
        if name not in _FIELDS:
            continue
        if name in fields:
            raise ValueError(f'PAM: {name} given twice')
        if name == 'TUPLTYPE':
            tt = bytes(value).decode('latin-1')
            if tt not in TUPLTYPES:
                raise ValueError(f'PAM: tuple type {tt!r} is not one cv2 '
                                 f'reads ({", ".join(TUPLTYPES)})')
            fields[name] = tt
        else:
            fields[name] = _strtol(bytes(value))


def imdecode(data: bytes, flag: str = 'color') -> np.ndarray:
    """Decode a PAM byte string (see the module docstring)."""
    if not matches(data):
        raise ValueError('not a PAM (P7) payload')
    fields, pos = _header(data)
    missing = [f for f in _FIELDS[:4] if f not in fields]
    if missing:
        raise ValueError(f'PAM: no {", ".join(missing)} in the header')
    w, h, ch, maxval = (fields[f] for f in _FIELDS[:4])
    if maxval > 65535:
        raise ValueError(f'PAM: MAXVAL {maxval} above 65535')
    tt = fields.get('TUPLTYPE')
    if tt is None:
        if ch == 1 and maxval < 256:
            tt = 'BLACKANDWHITE' if maxval == 1 else 'GRAYSCALE'
        elif ch == 3 and maxval < 256:
            tt = 'RGB'
        else:
            raise ValueError(f'PAM: no tuple type, DEPTH {ch}, MAXVAL '
                             f'{maxval}: cv2 reads none of these')
    if TUPLTYPES[tt] != ch:
        raise ValueError(f'PAM: tuple type {tt} with DEPTH {ch}')
    cvt.check_size('PAM', w, h)
    wide = maxval > 255
    row = w * ch * (2 if wide else 1)
    if len(data) - pos < h * row:
        raise ValueError(f'PAM: {len(data) - pos} bytes of samples, '
                         f'{h * row} needed')
    raw = np.frombuffer(data, np.uint8, h * row, pos).reshape(h, row)
    if maxval == 1:                      # cv2 reads packed bits
        bits = np.unpackbits(raw[:, :(w + 7) // 8], 1)[:, :w]
        grey = (bits * np.uint8(255)).astype(np.uint8)
        target = ch if flag == 'unchanged' else 3 if flag == 'color' else 1
        if target == 1:
            return grey
        if target == 3:
            return cvt.grey_to_bgr(grey)
        raise ValueError(f'PAM: MAXVAL 1 with DEPTH {ch} read unchanged: cv2 '
                         f'reads 1 or 3 channels there')
    px = (raw.view('>u2').astype(np.uint16) if wide else raw).reshape(h, w,
                                                                      ch)
    if flag == 'unchanged':
        return px[..., 0].copy() if ch == 1 else px.copy()
    px = cvt.high_byte(px)
    if flag == 'color':
        if ch == 1:
            return cvt.grey_to_bgr(px[..., 0])
        if ch == 3:
            return px.copy()
        if w > 1:
            raise ValueError(f'PAM: {tt} read colour: cv2 writes only the '
                             f'first ceil(W / {ch}) pixels of a row and '
                             f'leaves the rest undefined')
        return (cvt.grey_to_bgr(px[..., 0]) if ch == 2
                else px[..., 2::-1].copy())
    if ch == 1:
        return px[..., 0].copy()
    if ch == 3:
        return cvt.bgr_to_grey(px, rgb=True)
    if 3 * -(-w // ch) < w:
        raise ValueError(f'PAM: {tt} {w} wide read grey: cv2 writes only the '
                         f'first {3 * -(-w // ch)} bytes of a row and leaves '
                         f'the rest undefined')
    return px[:, np.arange(w) // 3, 0].copy()
