"""WebP decoding without a WebP library, as `cv2` 5.0 reads it.

`cv2` bundles libwebp and reads a WebP through `WebPDecoder`
(`imgcodecs/src/grfmt_webp.cpp`); the JAX package's loader and server
reach it through `cv2.imread` / `cv2.imdecode`. This module reads the
container in Python and hands the bitstream to `csrc/webp_decode.cpp`
(VP8L, VP8, ALPH and libwebp's output stage), built with `g++` into
`build/` at first use and bound with `ctypes`.

What `cv2` does, and so this:
  * It takes a file as WebP only when libwebp's `WebPGetFeatures` accepts
    its first 32 bytes (`WEBP_HEADER_SIZE`): fewer bytes, or a header it
    refuses, and `cv2` finds no decoder. Those 32 bytes also fix the
    channels: 4 when they say alpha (a `VP8X` chunk's alpha flag, or a
    simple VP8L file's alpha bit), else 3.
  * A still image decodes as `WebPDecodeBGRInto` / `WebPDecodeBGRAInto`
    do (`_headers`, libwebp's `ParseHeadersInternal` over the whole
    file): RIFF and chunk sizes checked against the data (a RIFF size
    past the end refuses the file; bytes after it are read), the
    optional chunks of a `VP8X` file skipped (the last `ALPH` kept; a
    lossy image decodes it even when the read drops it, so a damaged one
    refuses the file), a `VP8X` canvas that differs from the frame
    refused, and the VP8 or VP8L bitstream run to the end of the data.
  * An animation (`VP8X` with its animation flag) is read as `cv2` 5.0
    reads it through libwebp's `WebPAnimDecoder`: the whole file must
    demux (`_first_frame`: libwebp's demux.c checks, no partial file),
    and the first frame is decoded onto a transparent black canvas at its
    `ANMF` offset; its blend and dispose flags and the `ANIM` background
    colour change nothing in the first frame.
  * 'color' drops alpha (not blended), 'unchanged' keeps BGR or BGRA,
    'grayscale' is `cv2.cvtColor(BGR2GRAY)` of the colour read
    (`cvt.bgr_to_grey_cvtcolor`).

`imdecode(data, flag)` returns what `cv2.imdecode` does in those modes
and raises `ValueError` (text starting `WebP`) wherever `cv2` returns
None. Since `cv2`'s signature check is `WebPGetFeatures`, it also reads
what libwebp takes without a RIFF container: a bare `VP8 ` / `VP8L`
chunk (an `ALPH` chunk before a `VP8 ` one), or a raw VP8L or VP8
bitstream (`matches`).
"""

from __future__ import annotations

import ctypes
import struct
import threading
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import numpy as np

from hrfuser_tpu_torch.data import cvt
from hrfuser_tpu_torch.utils import host_build

SOURCE = Path(__file__).resolve().parents[1] / 'csrc' / 'webp_decode.cpp'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build'
HEADER_SIZE = 32                      # cv2's WEBP_HEADER_SIZE
MAX_FILE_SIZE = 64 << 20              # cv2.imread's default file limit
_MAX_PAYLOAD = 0xffffffff - 8 - 1     # libwebp's MAX_CHUNK_PAYLOAD
_MAX_AREA = 1 << 32
_ANIMATION, _ALPHA = 0x02, 0x10
_VALID_FLAGS = 0x3e                   # alpha, animation, ICCP, EXIF, XMP

_P = ctypes.c_void_p
_SIGNATURES = {
    'hrf_webp_decode': [_P, ctypes.c_long, ctypes.c_int, _P, ctypes.c_long,
                        ctypes.c_int, ctypes.c_int, ctypes.c_int, _P,
                        ctypes.c_long, ctypes.c_char_p, ctypes.c_int],
}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()          # the loader's prefetch thread may build


def build(again: bool = False) -> Path:
    """Compile `csrc/webp_decode.cpp` into `build/` unless this source is
    built (or `again`); returns the library's path."""
    return host_build.build(SOURCE, BUILD_DIR, 'libhrfuser_webp',
                            'the WebP decoder', again)


def lib() -> ctypes.CDLL:
    """The loaded WebP decoder (built at first use)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = host_build.load(build, 'the WebP decoder', _SIGNATURES)
    return _lib


def matches(data: bytes) -> bool:
    """A RIFF container of WebP (`RIFF`, a size, `WEBP`), or other bytes
    whose first 32 libwebp's `WebPGetFeatures` takes, as `cv2`'s
    signature check does: a bare chunk or a raw bitstream."""
    if data[:4] == b'RIFF' and data[8:12] == b'WEBP':
        return True
    return (data[:4] != b'RIFF' and len(data) >= HEADER_SIZE
            and _headers(data[:HEADER_SIZE], whole=False)[0] == _OK)


def _le32(data, pos: int) -> int:
    return struct.unpack_from('<I', data, pos)[0]


def _le24(data, pos: int) -> int:
    return data[pos] | data[pos + 1] << 8 | data[pos + 2] << 16


class Headers(NamedTuple):
    """What `ParseHeadersInternal` finds: the image size, alpha (the
    `VP8X` flag, a VP8L alpha bit or an `ALPH` chunk) and animation
    flags, and where the bitstream starts (it runs to the end of the
    data), whether it is VP8L, and the `ALPH` payload (start, size)."""
    width: int
    height: int
    has_alpha: bool
    animation: bool
    offset: int = 0
    lossless: bool = False
    alpha: Optional[Tuple[int, int]] = None


_OK, _SHORT, _BAD = 'ok', 'not enough data', 'bitstream error'


def _vp8_info(data, pos: int, size: int, chunk_size: int):
    """`VP8GetInfo`: the frame's (width, height), None if refused."""
    if size < 10 or bytes(data[pos + 3:pos + 6]) != b'\x9d\x01\x2a':
        return None
    bits = data[pos] | data[pos + 1] << 8 | data[pos + 2] << 16
    w = (data[pos + 7] << 8 | data[pos + 6]) & 0x3fff
    h = (data[pos + 9] << 8 | data[pos + 8]) & 0x3fff
    if (bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1
            or bits >> 5 >= chunk_size or w == 0 or h == 0):
        return None
    return w, h


def _vp8l_info(data, pos: int, size: int):
    """`VP8LGetInfo`: (width, height, alpha bit), None if refused."""
    if size < 5 or data[pos] != 0x2f or data[pos + 4] >> 5 != 0:
        return None
    bits = _le32(data, pos + 1)
    return (bits & 0x3fff) + 1, (bits >> 14 & 0x3fff) + 1, bits >> 28 & 1


def _headers(data, whole: bool):
    """libwebp's `ParseHeadersInternal`. `whole`: the decoder's call,
    every byte of the file at hand (`have_all_data`, a `Headers` with
    the bitstream's place); else `WebPGetFeatures`' (size, alpha and
    animation only). Returns (status, Headers or None)."""
    data = memoryview(data).cast('B')
    n = len(data)
    if n < 12:
        return _SHORT, None
    pos, size, riff_size = 0, n, 0
    if data[:4] == b'RIFF':
        if bytes(data[8:12]) != b'WEBP':
            return _BAD, None
        riff_size = _le32(data, 4)
        if riff_size < 12 or riff_size > _MAX_PAYLOAD:
            return _BAD, None
        if whole and riff_size > size - 8:
            return _SHORT, None
        pos, size = 12, size - 12
    if size < 8:
        return _SHORT, None
    found_vp8x, flags, canvas = False, 0, (0, 0)
    if bytes(data[pos:pos + 4]) == b'VP8X':
        if _le32(data, pos + 4) != 10:
            return _BAD, None
        if size < 18:
            return _SHORT, None
        flags = _le32(data, pos + 8)
        canvas = (1 + _le24(data, pos + 12), 1 + _le24(data, pos + 15))
        if canvas[0] * canvas[1] >= _MAX_AREA:
            return _BAD, None
        pos, size, found_vp8x = pos + 18, size - 18, True
    animation = bool(flags & _ANIMATION)
    if riff_size == 0 and found_vp8x:
        return _BAD, None
    has_alpha = bool(flags & _ALPHA)
    image = canvas
    if found_vp8x and animation and not whole:
        return _OK, Headers(*image, has_alpha, animation)
    status, alpha, lossless = _OK, None, False
    while True:          # a loop to leave early, as libwebp's goto
        if size < 4:
            status = _SHORT
            break
        if (riff_size and found_vp8x) or (
                not riff_size and bytes(data[pos:pos + 4]) == b'ALPH'):
            # the optional chunks up to the bitstream
            total = 4 + 8 + 10
            while True:
                if size < 8:
                    status = _SHORT
                    break
                chunk = _le32(data, pos + 4)
                if chunk > _MAX_PAYLOAD:
                    status = _BAD
                    break
                disk = (8 + chunk + 1) & ~1
                total += disk
                if riff_size and total > riff_size:
                    status = _BAD
                    break
                tag = bytes(data[pos:pos + 4])
                if tag in (b'VP8 ', b'VP8L'):
                    break
                if size < disk:
                    status = _SHORT
                    break
                if tag == b'ALPH':
                    alpha = (pos + 8, chunk)
                pos, size = pos + disk, size - disk
            if status != _OK:
                break
        if size < 8:
            status = _SHORT
            break
        tag = bytes(data[pos:pos + 4])
        if tag in (b'VP8 ', b'VP8L'):
            chunk = _le32(data, pos + 4)
            if riff_size >= 12 and chunk > riff_size - 12:
                status = _BAD
                break
            if whole and chunk > size - 8:
                status = _SHORT
                break
            lossless = tag == b'VP8L'
            pos, size = pos + 8, size - 8
        else:          # a raw bitstream, no chunk header
            lossless = _vp8l_info(data, pos, size) is not None
            chunk = size
        if chunk > _MAX_PAYLOAD:
            return _BAD, None
        if not lossless:
            if size < 10:
                status = _SHORT
                break
            info = _vp8_info(data, pos, size, chunk)
            if info is None:
                return _BAD, None
            image = info
        else:
            if size < 5:
                status = _SHORT
                break
            info = _vp8l_info(data, pos, size)
            if info is None:
                return _BAD, None
            image, has_alpha = info[:2], bool(info[2])
        if found_vp8x and canvas != image:
            return _BAD, None
        break
    if status == _OK or (status == _SHORT and found_vp8x and not whole):
        return _OK, Headers(*image, has_alpha or alpha is not None,
                            animation, pos, lossless, alpha)
    return status, None


def features(data) -> Headers:
    """The size, alpha and animation `cv2` reads off the first 32 bytes;
    `ValueError` where it finds no WebP decoder for them."""
    if len(data) < HEADER_SIZE:
        raise ValueError(f'WebP: {len(data)} bytes, fewer than the '
                         f'{HEADER_SIZE} cv2 needs')
    status, head = _headers(data[:HEADER_SIZE], whole=False)
    if status != _OK:
        raise ValueError(f'WebP: a header libwebp refuses ({status})')
    return head


def _decode_into(buf: np.ndarray, head: Headers, out: np.ndarray,
                 start: int = 0) -> None:
    """The bitstream of `head` (in `buf`) decoded into `out` (uint8
    [H, W, C] rows, C 3 or 4) at element `start`."""
    err = ctypes.create_string_buffer(256)
    base = buf.ctypes.data
    alpha_ptr, alpha_size = None, 0
    if head.alpha is not None and not head.lossless:
        alpha_ptr, alpha_size = base + head.alpha[0], head.alpha[1]
    rc = lib().hrf_webp_decode(
        base + head.offset, buf.size - head.offset, int(head.lossless),
        alpha_ptr, alpha_size, head.width, head.height, out.shape[2],
        out.ctypes.data + start, out.strides[0], err, len(err))
    if rc != 0:
        raise ValueError(f'WebP: {err.value.decode()}')


def _still(buf: np.ndarray, channels: int) -> np.ndarray:
    status, head = _headers(buf, whole=True)
    if status != _OK:
        raise ValueError(f'WebP: the container is damaged ({status})')
    out = np.empty((head.height, head.width, channels), np.uint8)
    _decode_into(buf, head, out)
    return out


class _Frame:
    """A frame as libwebp's demuxer keeps it."""

    def __init__(self):
        self.x = self.y = self.width = self.height = 0
        self.num = 0
        self.complete = False
        self.image = self.alpha = None        # (chunk start, chunk size)


def _first_frame(buf: np.ndarray) -> np.ndarray:
    """An animation as `WebPAnimDecoder` gives its first frame: BGRA on
    the canvas, transparent black outside the frame. The whole file must
    pass libwebp's demuxer (`WebPDemux`, no partial data)."""
    def bad(why):
        raise ValueError(f'WebP: the animation does not demux ({why})')

    data = memoryview(buf)
    n = len(data)
    if n < 20:
        bad('too short')
    riff_size = _le32(data, 4)
    if riff_size < 8 or riff_size > _MAX_PAYLOAD:
        bad('RIFF size')
    end = riff_end = riff_size + 8
    if n < riff_end:
        bad('the file ends inside its RIFF chunk')
    pos = 12

    def size_invalid(size):
        return size > riff_end - pos

    if end - pos < 8 or bytes(data[pos:pos + 4]) != b'VP8X':
        bad('no VP8X chunk')
    vp8x = _le32(data, pos + 4)
    pos += 8
    if vp8x > _MAX_PAYLOAD or vp8x < 10:
        bad('VP8X size')
    vp8x += vp8x & 1
    if size_invalid(vp8x) or end - pos < vp8x:
        bad('VP8X size')
    flags = data[pos]
    canvas_w, canvas_h = 1 + _le24(data, pos + 4), 1 + _le24(data, pos + 7)
    if canvas_w * canvas_h >= _MAX_AREA:
        bad('canvas size')
    pos += vp8x
    if size_invalid(8) or end - pos < 8:
        bad('no chunk after VP8X')
    is_animation = bool(flags & _ANIMATION)
    frames, anim_chunks = [], 0

    def store_frame(frame, num, min_size):
        """libwebp's StoreFrame: the ALPH and image chunks of a frame."""
        nonlocal pos
        alpha_chunks = image_chunks = 0
        if end - pos < 8 or end - pos < min_size:
            return 'more'
        status, done = 'ok', False
        while not done and status == 'ok':
            chunk_start = pos
            tag = bytes(data[pos:pos + 4])
            payload = _le32(data, pos + 4)
            pos += 8
            if payload > _MAX_PAYLOAD:
                return 'error'
            padded = payload + (payload & 1)
            available = min(padded, end - pos)
            chunk_size = 8 + available
            if size_invalid(padded):
                return 'error'
            if padded > end - pos:
                status = 'more'
            if tag == b'VP8L' and alpha_chunks:
                return 'error'          # VP8L carries its own alpha
            if tag == b'ALPH' and alpha_chunks == 0:
                alpha_chunks = 1
                frame.alpha = (chunk_start, chunk_size)
                frame.num = num
                pos += available
            elif tag in (b'VP8 ', b'VP8L') and image_chunks == 0:
                st, head = _headers(data[chunk_start:chunk_start
                                         + chunk_size], whole=False)
                if status == 'more' and st == _SHORT:
                    return 'more'
                if st != _OK:
                    return 'error'
                image_chunks = 1
                frame.image = (chunk_start, chunk_size)
                frame.width, frame.height = head.width, head.height
                frame.num = num
                frame.complete = status == 'ok'
                pos += available
            else:
                pos -= 8
                done = True
            if pos == riff_end:
                done = True
            elif end - pos < 8:
                status = 'more'
        return status

    while True:
        tag = bytes(data[pos:pos + 4])
        chunk = _le32(data, pos + 4)
        pos += 8
        if chunk > _MAX_PAYLOAD:
            bad('chunk size')
        padded = chunk + (chunk & 1)
        if size_invalid(padded):
            bad('a chunk past the RIFF end')
        status = 'ok'
        if tag in (b'VP8X', b'ALPH', b'VP8 ', b'VP8L'):
            bad(f'a {tag.decode("latin-1")} chunk outside a frame')
        elif tag == b'ANIM':
            if padded < 6:
                bad('ANIM size')
            if end - pos < padded:
                status = 'more'
            elif anim_chunks == 0:
                anim_chunks = 1
                pos += padded
            else:
                pos += padded
        elif tag == b'ANMF':
            if anim_chunks == 0:
                bad('ANMF before ANIM')
            if size_invalid(16) or padded < 16:
                bad('ANMF size')
            if end - pos < 16:
                status = 'more'
            else:
                frame = _Frame()
                frame.x, frame.y = 2 * _le24(data, pos), 2 * _le24(data,
                                                                  pos + 3)
                fw, fh = 1 + _le24(data, pos + 6), 1 + _le24(data, pos + 9)
                if fw * fh >= _MAX_AREA:
                    bad('frame size')
                frame.width, frame.height = fw, fh
                pos += 16
                start = pos
                status = store_frame(frame, len(frames) + 1, padded - 16)
                if status != 'error' and pos - start > padded - 16:
                    status = 'error'
                if status != 'error' and is_animation and frame.num > 0:
                    if frames and not frames[-1].complete:
                        status = 'error'
                    else:
                        frames.append(frame)
                if status == 'error':
                    bad('a frame')
        else:           # ICCP, EXIF, XMP and unknown chunks
            if padded <= end - pos:
                pos += padded
            else:
                status = 'more'
        if status != 'ok':
            bad('the file ends inside a chunk')
        if pos == riff_end:
            break
        if end - pos < 8:
            bad('the file ends inside a chunk header')
    if flags & ~_VALID_FLAGS & 0xff or not frames:
        bad('flags' if frames else 'no frame')
    for f in frames:
        if not f.complete:
            bad('an incomplete frame')
        if f.alpha is not None and f.alpha[0] > f.image[0]:
            bad('ALPH after the image')
        if f.width <= 0 or f.height <= 0 or f.x + f.width > canvas_w \
                or f.y + f.height > canvas_h:
            bad('a frame outside the canvas')
    first = frames[0]
    lo = first.image[0] if first.alpha is None else first.alpha[0]
    fragment = buf[lo:first.image[0] + first.image[1]]
    status, head = _headers(fragment, whole=True)
    if status != _OK:
        raise ValueError(f'WebP: the first frame is damaged ({status})')
    canvas = np.zeros((canvas_h, canvas_w, 4), np.uint8)
    _decode_into(np.ascontiguousarray(fragment), head, canvas,
                 (first.y * canvas_w + first.x) * 4)
    return canvas


def imdecode(data: bytes, flag: str = 'color',
             from_file: bool = False) -> np.ndarray:
    """What `cv2.imdecode(buf, IMREAD_<FLAG>)` gives for WebP bytes:
    'color' uint8 BGR [H, W, 3], 'unchanged' BGR or BGRA, 'grayscale'
    uint8 [H, W]; `ValueError` where `cv2` returns None. `from_file`:
    what `cv2.imread` gives for a file of these bytes, which also refuses
    files over `OPENCV_IMGCODECS_WEBP_MAX_FILE_SIZE` (64 MiB; the buffer
    read has no limit)."""
    if from_file and len(data) > MAX_FILE_SIZE:
        raise ValueError(f'WebP: a file of {len(data)} bytes, over the '
                         f'{MAX_FILE_SIZE} cv2.imread reads')
    head = features(data)
    cvt.check_size('WebP', head.width, head.height)
    channels = 4 if head.has_alpha else 3
    buf = np.frombuffer(data, np.uint8)
    if head.animation:
        img = _first_frame(buf)
        if channels == 3 or flag != 'unchanged':
            img = img[..., :3]
    else:
        img = _still(buf, 4 if channels == 4 and flag == 'unchanged' else 3)
    if flag == 'grayscale':
        return cvt.bgr_to_grey_cvtcolor(img)
    return np.ascontiguousarray(img)
