"""PFM decoding (`PF` colour, `Pf` grey) in numpy, as `cv2` 5.0's
`PFMDecoder` (`imgcodecs/src/grfmt_pfm.cpp`) reads it.

The header is `PF` or `Pf`, a newline, then the width, the height and
the scale, each ended by one white-space byte. The scale's sign gives
the byte order of the float32 samples (negative: little-endian), its
magnitude divides them (as a multiply by float32 `1 / |scale|`); a zero
scale is refused. Rows are stored bottom-up, colour as RGB.

`imdecode(data, flag)` returns what `cv2.imdecode` does: 'unchanged'
float32 [H, W] or BGR [H, W, 3]; 'color' and 'grayscale' the same pixels
as uint8 (`cvt.float_to_u8`, scale 1), with the file's channel count:
`cv2`'s PFM reader converts depth and never channels, so a `PF` read
grey gives [H, W, 3] and a `Pf` read colour [H, W]. `cv2.imread`
refuses those two ("Internal imread issue"), and so does
`loading.imread`.
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np

from hrfuser_tpu_torch.data import cvt
from hrfuser_tpu_torch.data.pxm import SPACE


_INT = re.compile(rb'[ \t\n\v\f\r]*[+-]?[0-9]+')
# what C's strtod reads: decimal, hexadecimal, inf / infinity, nan
_FLOAT = re.compile(rb'[ \t\n\v\f\r]*([+-]?)(?:(0[xX](?:[0-9a-fA-F]+\.?'
                    rb'[0-9a-fA-F]*|\.[0-9a-fA-F]+)(?:[pP][+-]?[0-9]+)?)|'
                    rb'((?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][+-]?[0-9]+)?)|'
                    rb'((?i:infinity|inf|nan)))')


def matches(data: bytes) -> bool:
    """`PFMDecoder::checkSignature`: `Pf` or `PF` and a space byte."""
    return (len(data) >= 3 and data[:1] == b'P' and data[1:2] in (b'f', b'F')
            and data[2] in SPACE)


def _number(data: bytes, pos: int, pattern: re.Pattern) -> Tuple[float,
                                                                   int]:
    """`read_number`: up to 40 bytes, ended by a white-space byte, read
    as C's `atoi` / `atof` read a prefix (nothing readable is 0); `cv2`
    refuses a byte above 0x7f there."""
    end = pos
    while True:
        if end >= len(data):
            raise ValueError('PFM: the file ends inside its header')
        end += 1
        if data[end - 1] in SPACE or end - pos == 40:
            break
    if max(data[pos:end]) >= 0x80:
        raise ValueError('PFM: a byte above 0x7f in a header number')
    m = pattern.match(data[pos:end])
    if m is None:
        return 0.0, end
    if pattern is _INT:
        return float(int(m.group(0))), end
    sign = -1.0 if m.group(1) == b'-' else 1.0
    if m.group(2):
        text = m.group(2).decode()
        return sign * float.fromhex(text + ('' if 'p' in text.lower()
                                            else 'p0')), end
    return sign * float((m.group(3) or m.group(4)).decode()), end


def imdecode(data: bytes, flag: str = 'color') -> np.ndarray:
    """Decode a PFM byte string (see the module docstring)."""
    if not matches(data):
        raise ValueError('not a PFM (PF / Pf) payload')
    if data[2:3] != b'\n':
        raise ValueError('PFM: no newline after the PF / Pf tag')
    ch = 3 if data[1:2] == b'F' else 1
    w, pos = _number(data, 3, _INT)
    h, pos = _number(data, pos, _INT)
    scale, pos = _number(data, pos, _FLOAT)
    w, h = int(w), int(h)
    cvt.check_size('PFM', w, h)
    if not abs(scale) > 0:
        raise ValueError(f'PFM: scale {scale}')
    n = h * w * ch * 4
    if len(data) - pos < n:
        raise ValueError(f'PFM: {len(data) - pos} bytes of samples, {n} '
                         f'needed')
    px = np.frombuffer(data, '<f4' if scale < 0 else '>f4', h * w * ch,
                       pos).astype(np.float32).reshape(h, w, ch)[::-1]
    px = px * np.float32(1.0 / abs(scale))
    px = px[..., 0] if ch == 1 else px[..., ::-1]
    px = np.ascontiguousarray(px)
    return px if flag == 'unchanged' else cvt.float_to_u8(px)
