"""JPEG decoding and encoding without a JPEG library: Huffman on the
host, pixels on the card.

The port's JPEG decoder, in place of libjpeg (which the JAX package's
loader links, `hrfuser_tpu/data/native.py`, and which `cv2` bundles):
  * `decode_coefficients(data)`: the host half, `csrc/jpeg_entropy.cpp`
    (markers, Huffman and arithmetic decoding of sequential and
    progressive scans, sequential by nature, and libjpeg's block
    smoothing of incomplete progressive frames), bound with ctypes. It
    returns each component's quantised coefficients and quantisation
    table in one int16 array.
  * `pixels(coefs, frame, grey)`: the kernel half, `csrc/jpeg_pixels.cu`,
    two launches an image: dequantisation and the integer inverse DCT
    into one sample plane per component, then upsampling and colour
    conversion into BGR, or grey. A CUDA tensor launches the kernel (or
    raises); a CPU tensor takes the plain twin `pixels_plain`, nothing
    else does.
  * `decode_jpeg(data, device, grey)`: both, with one host-to-device copy
    of the coefficients on the caller's current stream.

The pixels are libjpeg-turbo's on x86-64, where its SIMD code does the
inverse DCT (`jidctint-avx2.asm` / `-sse2.asm`): the ISLOW integer
transform (CONST_BITS 13, PASS1_BITS 2, columns then rows) in 16-bit
lanes, so products and some sums wrap at 16 bits, each pass saturates
to 16 bits, and the output saturates to [-128, 127] before +128; a block
whose rows 1-7 are zero takes the shortcut `(c * q) << 2` in 16 bits.
Then fancy upsampling as `jdsample.c` does it (h2v1, h1v2, h2v2 linear
interpolation between sample centres, edges repeated; plain repetition
for other integral ratios and for chroma 2 samples wide or less) and
`jdcolor.c`'s fixed-point YCbCr->RGB (SCALEBITS 16). For streams an
encoder writes the result is also libjpeg's C path's; they differ only
for coefficients whose transform overflows 16 bits, where this decoder
keeps the SIMD code's answer, which is what the JAX package's decoder
and `cv2` give (tests/test_torch_jpeg.py). 4-component files are what
`cv2` makes of them (the JAX package's decoder refuses them, and its
loader falls through to `cv2`): YCCK turned CMYK by `jdcolor.c`, then
CMYK to BGR by `cv2`'s own arithmetic, the Adobe marker's inversion
ignored as `cv2` ignores it. A grey read (`grey=True`, what
`cv2.IMREAD_GRAYSCALE` gives) of a grey or YCbCr file is its luma,
whose chroma is then not transformed; of an RGB file `jdcolor.c`'s
`rgb_gray_convert`; of a CMYK or YCCK one `cv2`'s CMYK -> grey.
Hierarchical, 12-bit and 2-component files raise `JpegError` naming the
mode (tests/test_torch_jpeg_modes.py for the rest).

Lossless files (SOF3) decode as `cv2` (libjpeg-turbo 3) decodes them,
the JAX package's only reader of them: `decode_samples(data)` rebuilds
the samples on the host (`hrf_jpeg_decode_samples`: prediction, the
point transform, subsampled components repeated to full size), and
`lossless_pixels` (twin `lossless_pixels_plain`) converts them with the
kernel's colour launch alone: RGB to BGR, CMYK as `cv2` does, a
1-component frame as it is. libjpeg converts no colour in lossless
mode, so a colour read of a 1-component frame, a grey read of an RGB
one, and YCbCr or YCCK frames raise (tests/test_torch_jpeg_lossless.py).

The writer, `imencode(img)` / `imwrite(path, img)`, gives the bytes
`cv2.imencode('.jpg', img)` gives with its defaults (libjpeg-turbo:
quality 95, 4:2:0, ISLOW, the standard Huffman tables): a JFIF 1.01
APP0, the IJG quality scaling of the Annex K tables, SOF0 with Y 2x2 and
Cb / Cr 1x1 (one 1x1 component for a grey image), the four Annex K.3
Huffman tables, one interleaved scan, no restart markers. Its pixel
stage runs as integer tensor ops on the image's device
(`encode_blocks`): libjpeg's fixed-point RGB -> YCbCr (`jccolor.c`), the
right and bottom edges replicated to whole MCUs (`jcprepct.c`, with the
dummy blocks `jccoefct.c` makes), h2v2 downsampling with the
alternating bias 1, 2 (`jcsample.c`), the ISLOW forward DCT
(`jfdctint.c`) and libjpeg-turbo's reciprocal division by `q << 3`
(`jcdctmgr.c`). Its entropy stage, DC differences, AC run lengths, byte
stuffing and 1-bit padding, is `hrf_jpeg_encode_scan` in
`csrc/jpeg_entropy.cpp`, on the host.

The host library is built with `g++ -O3 -shared -fPIC` into `build/` at
the repository root at first use, named by a hash of the source. Nothing
is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from hrfuser_tpu_torch.ops.chain import on_cpu
from hrfuser_tpu_torch.utils import cuda_build, host_build

SOURCE = Path(__file__).resolve().parents[1] / 'csrc' / 'jpeg_entropy.cpp'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build'
GREY, YCBCR, RGB, CMYK, YCCK = 0, 1, 2, 3, 4

_P = ctypes.c_void_p
_SIGNATURES = {
    'hrf_jpeg_info': [ctypes.c_char_p, ctypes.c_long, _P, ctypes.c_char_p,
                      ctypes.c_int],
    'hrf_jpeg_decode': [ctypes.c_char_p, ctypes.c_long, _P, ctypes.c_long,
                        ctypes.c_char_p, ctypes.c_int],
    'hrf_jpeg_decode_samples': [ctypes.c_char_p, ctypes.c_long, _P,
                                ctypes.c_long, ctypes.c_char_p,
                                ctypes.c_int],
    'hrf_jpeg_encode_scan': [_P, ctypes.c_long, ctypes.c_int, _P, _P,
                             ctypes.c_long, _P, ctypes.c_char_p,
                             ctypes.c_int],
}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()          # the loader's prefetch thread may build


class JpegError(OSError, ValueError):
    """A JPEG this decoder cannot read: damaged, or a mode it refuses
    (an `IOError`, and a `ValueError` so that the server answers 400)."""


def build(again: bool = False) -> Path:
    """Compile `csrc/jpeg_entropy.cpp` into `build/` unless this source
    is built (or `again`); returns the library's path. Raises
    `RuntimeError` with the compiler's output if it cannot be built."""
    return host_build.build(SOURCE, BUILD_DIR, 'libhrfuser_jpeg',
                            'the JPEG entropy decoder', again)


def lib() -> ctypes.CDLL:
    """The loaded entropy decoder (built at first use). A cached library
    that does not load (built on another machine) is built again."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = host_build.load(build, 'the JPEG entropy decoder',
                                   _SIGNATURES)
    return _lib


class Frame(NamedTuple):
    """A JPEG frame's layout: image size, colour space (GREY, YCBCR, RGB,
    CMYK or YCCK) and per component (h, v, block rows, block cols), the
    block grid padded to whole MCUs. A lossless frame (SOF3) has its
    sample precision and its first scan's point transform `pt`, and each
    component (1, 1, rows, cols): its samples come out at full size,
    padded to whole 8x8 tiles (`decode_samples`)."""
    height: int
    width: int
    colour: int
    comps: Tuple[Tuple[int, int, int, int], ...]
    lossless: bool = False
    precision: int = 8
    pt: int = 0

    @property
    def blocks(self) -> Tuple[int, ...]:
        return tuple(r * c for _, _, r, c in self.comps)

    @property
    def size(self) -> int:
        """int16 values of `decode_coefficients`' array: every block's 64
        coefficients, then 64 quantisation values a component."""
        return 64 * (sum(self.blocks) + len(self.comps))

    def sampled(self, i: int) -> Tuple[int, int]:
        """Component i's sample rows and columns that hold the image
        (libjpeg's downsampled_height / _width)."""
        hmax = max(c[0] for c in self.comps)
        vmax = max(c[1] for c in self.comps)
        h, v = self.comps[i][:2]
        return (-(-self.height * v // vmax), -(-self.width * h // hmax))

    def expand(self, i: int) -> Tuple[int, int]:
        """Component i's upsampling factors (rows, columns)."""
        hmax = max(c[0] for c in self.comps)
        vmax = max(c[1] for c in self.comps)
        h, v = self.comps[i][:2]
        if hmax % h or vmax % v:
            raise JpegError(f'sampling factors {h}x{v} of {hmax}x{vmax}: '
                            f'only integral ratios are supported')
        return vmax // v, hmax // h


def _error(buf) -> str:
    return buf.value.decode(errors='replace')


def frame_info(data: bytes) -> Frame:
    """The frame header of a JPEG byte string."""
    info = (ctypes.c_int * 24)()
    err = ctypes.create_string_buffer(256)
    if lib().hrf_jpeg_info(data, len(data), info, err, len(err)):
        raise JpegError(_error(err))
    n = info[2]
    comps = tuple(tuple(info[4 + 4 * c:8 + 4 * c]) for c in range(n))
    frame = Frame(info[0], info[1], info[3], comps, bool(info[20]),
                  info[21], info[22])
    for i in range(n):
        frame.expand(i)
    return frame


def jpeg_shape(data: bytes) -> Tuple[int, int, int]:
    """A JPEG's (height, width, components)."""
    f = frame_info(data)
    return f.height, f.width, len(f.comps)


def decode_coefficients(data: bytes, frame: Optional[Frame] = None
                        ) -> Tuple[Frame, np.ndarray]:
    """Entropy-decode a JPEG on the host: (frame, int16 array of
    `frame.size` values: each component's [block rows, block cols, 64]
    coefficients in natural order, one after the other, then each
    component's 64 quantisation values). A lossless frame raises (it
    holds samples: `decode_samples`)."""
    frame = frame or frame_info(data)
    out = np.empty(frame.size, np.int16)
    err = ctypes.create_string_buffer(256)
    if lib().hrf_jpeg_decode(data, len(data), out.ctypes.data, out.size,
                             err, len(err)):
        raise JpegError(_error(err))
    return frame, out


def decode_samples(data: bytes, frame: Optional[Frame] = None
                   ) -> Tuple[Frame, np.ndarray]:
    """Decode a lossless JPEG on the host (entropy decoding, prediction,
    the point transform and, for subsampled components, repetition to
    full size): (frame, uint8 array of each component's plane
    [rows * 8, cols * 8], the image at its top left, one after the
    other). Any other frame raises."""
    frame = frame or frame_info(data)
    out = np.empty(64 * sum(frame.blocks), np.uint8)
    err = ctypes.create_string_buffer(256)
    if lib().hrf_jpeg_decode_samples(data, len(data), out.ctypes.data,
                                     out.size, err, len(err)):
        raise JpegError(_error(err))
    return frame, out


def split(coefs: Tensor, frame: Frame):
    """Views of `decode_coefficients`' array: per component its blocks
    [rows, cols, 64] and its quantisation table [64]."""
    blocks, start = [], 0
    for _, _, r, c in frame.comps:
        blocks.append(coefs[start:start + r * c * 64].view(r, c, 64))
        start += r * c * 64
    quant = coefs[start:].view(len(frame.comps), 64)
    return blocks, list(quant)


# -- the plain twin ---------------------------------------------------------

def _wrap16(x: Tensor) -> Tensor:
    return ((x + 32768) & 0xFFFF) - 32768


def _wrap32(x: Tensor) -> Tensor:
    return ((x + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31


def _idct_1d(x, shift: int):
    """One 8-point pass of the ISLOW transform as the SIMD code computes
    it: x[0..7] int64 tensors of 16-bit values; returns the 8 outputs
    descaled by `shift` and saturated to 16 bits."""
    x0, x1, x2, x3, x4, x5, x6, x7 = x
    tmp3 = x2 * 10703 + x6 * 4433
    tmp2 = x2 * 4433 + x6 * -10704
    tmp0 = _wrap16(x0 + x4) * 8192
    tmp1 = _wrap16(x0 - x4) * 8192
    tmp10, tmp13 = _wrap32(tmp0 + tmp3), _wrap32(tmp0 - tmp3)
    tmp11, tmp12 = _wrap32(tmp1 + tmp2), _wrap32(tmp1 - tmp2)
    z3 = _wrap16(x7 + x3)
    z4 = _wrap16(x5 + x1)
    z3p = z3 * -6436 + z4 * 9633
    z4p = z3 * 9633 + z4 * 6437
    o0 = _wrap32(x7 * -4927 + x1 * -7373 + z3p)
    o1 = _wrap32(x5 * -4176 + x3 * -20995 + z4p)
    o2 = _wrap32(x5 * -20995 + x3 * 4177 + z3p)
    o3 = _wrap32(x7 * -7373 + x1 * 4926 + z4p)
    half = 1 << (shift - 1)
    outs = [(tmp10, o3, 1), (tmp11, o2, 1), (tmp12, o1, 1), (tmp13, o0, 1),
            (tmp13, o0, -1), (tmp12, o1, -1), (tmp11, o2, -1),
            (tmp10, o3, -1)]
    return [(_wrap32(_wrap32(a + s * b) + half) >> shift).clamp(-32768, 32767)
            for a, b, s in outs]


def idct_plain(blocks: Tensor, quant: Tensor) -> Tensor:
    """Dequantise and inverse-DCT blocks [..., 64] (natural order) with a
    table [64] into samples [..., 8, 8] uint8 (launch 1's function)."""
    shape = blocks.shape[:-1]
    c = blocks.reshape(-1, 8, 8).to(torch.int64)
    deq = _wrap16(c * quant.to(torch.int64).view(8, 8))
    # pass 1, columns: rows 1-7 all zero take the 16-bit shortcut
    full = torch.stack(_idct_1d(deq.unbind(1), 11), 1)
    short = _wrap16(deq[:, :1, :] * 4).expand(-1, 8, -1)
    dc_only = (c[:, 1:, :] == 0).flatten(1).all(1)
    ws = torch.where(dc_only[:, None, None], short, full)
    # pass 2, rows
    rows = torch.stack(_idct_1d(ws.unbind(2), 18), 2)
    out = rows.clamp(-128, 127) + 128
    return out.to(torch.uint8).view(*shape, 8, 8)


def _planes(blocks, quant):
    """Each component's samples [rows * 8, cols * 8] uint8."""
    out = []
    for b, q in zip(blocks, quant):
        r, c = b.shape[:2]
        out.append(idct_plain(b, q).permute(0, 2, 1, 3).reshape(r * 8,
                                                                 c * 8))
    return out


def _upsample(plane: Tensor, frame: Frame, i: int) -> Tensor:
    """Component i's samples at full size [H, W] int64 (launch 2's
    upsampling)."""
    hgt, wid = frame.height, frame.width
    dh, dw = frame.sampled(i)
    ey, ex = frame.expand(i)
    p = plane[:dh, :dw].to(torch.int64)
    ys = torch.arange(hgt, device=p.device)
    xs = torch.arange(wid, device=p.device)

    def rows(r):
        return p.index_select(0, r.clamp(0, dh - 1))

    def cols(a, c):
        return a.index_select(1, c.clamp(0, dw - 1))

    if (ey, ex) == (1, 1):
        return p[:hgt, :wid]
    if (ey, ex) == (1, 2) and dw > 2:             # h2v1 fancy
        j, u = xs >> 1, xs & 1
        near = cols(p, j)
        far = cols(p, j + 2 * u - 1)
        return ((3 * near + far + 1 + u) >> 2)[:hgt]
    if (ey, ex) == (2, 1):                        # h1v2 fancy
        i_, v = ys >> 1, (ys & 1)[:, None]
        near = rows(i_)
        far = rows(i_ + 2 * v[:, 0] - 1)
        return ((3 * near + far + 1 + v) >> 2)[:, :wid]
    if (ey, ex) == (2, 2) and dw > 2:             # h2v2 fancy
        i_, v = ys >> 1, (ys & 1)
        colsum = 3 * rows(i_) + rows(i_ + 2 * v - 1)       # [H, dw]
        j, u = xs >> 1, xs & 1
        return (3 * cols(colsum, j) + cols(colsum, j + 2 * u - 1)
                + 8 - u) >> 4
    return cols(rows(ys // ey), xs // ex)


def _ycc_rgb(y, cb, cr):
    """`jdcolor.c`'s fixed-point YCbCr -> RGB (SCALEBITS 16), clamped."""
    xb, xr = cb - 128, cr - 128
    return [(y + v).clamp(0, 255) for v in (
        (91881 * xr + 32768) >> 16,
        (-22554 * xb + 32768 - 46802 * xr) >> 16,
        (116130 * xb + 32768) >> 16)]


def _colour(samples, colour: int, grey: bool = False) -> Tensor:
    """Full-size components (int64 [H, W] each) -> BGR uint8 [H, W, 3],
    or grey uint8 [H, W] (launch 2's colour conversion). CMYK (and YCCK,
    first turned CMYK by `jdcolor.c`'s `ycck_cmyk_convert`) goes to BGR
    as `cv2` does it (`icvCvt_CMYK2BGR_8u_C4C3R`: each of C, M, Y becomes
    k - ((255 - v) * k >> 8), then B, G, R = Y, M, C); grey from RGB is
    `rgb_gray_convert`, from CMYK `cv2`'s `icvCvt_CMYK2Gray_8u_C4C1R`."""
    if colour in (GREY, YCBCR) and grey:
        return samples[0].to(torch.uint8)
    if colour == GREY:
        y = samples[0]
        return torch.stack([y, y, y], -1).to(torch.uint8)
    if colour == RGB:
        r, g, b = samples
        if grey:
            return ((19595 * r + 38470 * g + 7471 * b + 32768) >> 16).to(
                torch.uint8)
        return torch.stack([b, g, r], -1).to(torch.uint8)
    if colour in (CMYK, YCCK):
        if colour == YCCK:
            cmy = [255 - v for v in _ycc_rgb(*samples[:3])]
        else:
            cmy = samples[:3]
        k = samples[3]
        c, m, y = (k - (((255 - v) * k) >> 8) for v in cmy)
        if grey:
            return ((y * 1868 + m * 9617 + c * 4899 + 8192) >> 14).to(
                torch.uint8)
        return torch.stack([y, m, c], -1).to(torch.uint8)
    red, green, blue = _ycc_rgb(*samples)
    return torch.stack([blue, green, red], -1).to(torch.uint8)


def _luma_only(frame: Frame, grey: bool) -> bool:
    """A grey read of a grey or YCbCr file needs its first component
    alone (libjpeg decodes no chroma then)."""
    return grey and frame.colour in (GREY, YCBCR)


def pixels_plain(coefs: Tensor, frame: Frame, grey: bool = False) -> Tensor:
    """The kernel's plain twin: `decode_coefficients`' array (int16, any
    device) -> BGR uint8 [H, W, 3] (grey [H, W] if `grey`) on its
    device."""
    blocks, quant = split(coefs, frame)
    if _luma_only(frame, grey):
        blocks, quant = blocks[:1], quant[:1]
    planes = _planes(blocks, quant)
    full = [_upsample(p, frame, i) for i, p in enumerate(planes)]
    return _colour(full, frame.colour, grey)


# -- the kernel -------------------------------------------------------------

def _params(frame: Frame):
    """The kernel's per-component parameters: block rows and columns,
    sample rows and columns, upsampling factors."""
    params = []
    for i, (h, v, r, c) in enumerate(frame.comps):
        params += [r, c, *frame.sampled(i), *frame.expand(i)]
    return (ctypes.c_int * len(params))(*params)


def _launch_colour(planes: Tensor, frame: Frame, params, coded: int,
                   grey: bool) -> Tensor:
    """Launch 2 over the first `coded` planes (uint8, 64 bytes a block)."""
    shape = (frame.height, frame.width) + (() if grey else (3,))
    out = torch.empty(shape, dtype=torch.uint8, device=planes.device)
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    cuda_build.check(cuda_build.lib().hrf_jpeg_color(
        planes.data_ptr(), out.data_ptr(), params, coded, frame.height,
        frame.width, frame.colour, 1 if grey else 3, stream),
        'hrf_jpeg_color')
    pixels.launches += 1
    return out


def _launch(coefs: Tensor, frame: Frame, grey: bool) -> Tensor:
    if (coefs.dtype != torch.int16 or coefs.dim() != 1
            or coefs.numel() != frame.size or not coefs.is_contiguous()):
        raise ValueError(f'jpeg pixels kernel: coefficients must be a '
                         f'contiguous int16 vector of {frame.size}')
    n = len(frame.comps)
    coded = 1 if _luma_only(frame, grey) else n
    dev = coefs.device
    planes = torch.empty(64 * sum(frame.blocks[:coded]), dtype=torch.uint8,
                         device=dev)
    params = _params(frame)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cuda_build.check(cuda_build.lib().hrf_jpeg_idct(
        coefs.data_ptr(), planes.data_ptr(), params, n, coded, stream),
        'hrf_jpeg_idct')
    pixels.launches += 1
    pixels.idct_launches += 1
    if grey and coded == 1 and frame.expand(0) == (1, 1):
        # full-size luma: its plane, cropped, is the grey image
        _, _, r, c = frame.comps[0]
        return planes.view(r * 8, c * 8)[:frame.height,
                                         :frame.width].contiguous()
    return _launch_colour(planes, frame, params, coded, grey)


def pixels(coefs: Tensor, frame: Frame, grey: bool = False) -> Tensor:
    """`decode_coefficients`' array as a tensor -> BGR uint8 [H, W, 3] (or
    with `grey` the grey image [H, W] `cv2.IMREAD_GRAYSCALE` gives) on its
    device: the kernel for a CUDA tensor, the plain twin for a CPU one.
    The kernel counts its launches in `pixels.launches`: two a frame, one
    for a grey read of a grey or YCbCr file whose luma is full size (its
    plane cropped by one PyTorch copy, a device kernel not counted
    there); launch 1 alone also in `pixels.idct_launches`. A lossless
    frame's colour launch (`lossless_pixels`) counts in
    `pixels.launches` too."""
    if on_cpu(coefs):
        return pixels_plain(coefs, frame, grey)
    return _launch(coefs, frame, grey)


pixels.launches = 0
pixels.idct_launches = 0


# -- lossless frames: the samples come from the host, launch 2 alone ---------

def _lossless_read(frame: Frame, grey: bool) -> None:
    """Raise where `cv2.imdecode` returns None for a lossless frame:
    libjpeg converts no colour in lossless mode, so a 1-component frame
    reads only grey (or unchanged) and an RGB one only in colour."""
    if grey and frame.colour == RGB:
        raise JpegError('a grey read of an RGB lossless JPEG is not '
                        'supported (libjpeg converts no colour in lossless '
                        'mode)')
    if not grey and frame.colour == GREY:
        raise JpegError('a colour read of a 1-component lossless JPEG is '
                        'not supported (libjpeg converts no colour in '
                        'lossless mode)')


def lossless_planes(planes: Tensor, frame: Frame):
    """Views of `decode_samples`' array: each component's samples [H, W]."""
    _, _, r, c = frame.comps[0]
    return list(planes.view(len(frame.comps), r * 8, c * 8)[
        :, :frame.height, :frame.width])


def lossless_pixels_plain(planes: Tensor, frame: Frame,
                          grey: bool = False) -> Tensor:
    """The colour launch's plain twin on a lossless frame:
    `decode_samples`' array (uint8, any device) -> BGR uint8 [H, W, 3] (RGB
    reordered, CMYK as `cv2` converts it), or with `grey` the grey image
    [H, W] (a 1-component frame's samples, CMYK's `cv2` grey)."""
    _lossless_read(frame, grey)
    samples = [p.to(torch.int64) for p in lossless_planes(planes, frame)]
    return _colour(samples, frame.colour, grey)


def lossless_pixels(planes: Tensor, frame: Frame,
                    grey: bool = False) -> Tensor:
    """`decode_samples`' array as a tensor -> what `lossless_pixels_plain`
    gives, on its device: for a CUDA tensor the kernel's colour launch
    alone (launch 2, counted in `pixels.launches`; the planes are full
    size, so it repeats and interpolates nothing), the plain twin for a
    CPU one. A 1-component frame takes no launch: its plane, cropped by
    one PyTorch copy, is the image."""
    _lossless_read(frame, grey)
    if on_cpu(planes):
        return lossless_pixels_plain(planes, frame, grey)
    n = len(frame.comps)
    if (planes.dtype != torch.uint8 or planes.dim() != 1
            or planes.numel() != 64 * sum(frame.blocks)
            or not planes.is_contiguous()):
        raise ValueError(f'jpeg colour kernel: samples must be a contiguous '
                         f'uint8 vector of {64 * sum(frame.blocks)}')
    if n == 1:
        return lossless_planes(planes, frame)[0].contiguous()
    return _launch_colour(planes, frame, _params(frame), n, grey)


def decode_jpeg(data: bytes, device='cuda', grey: bool = False,
                colour: Optional[int] = None) -> Tensor:
    """A JPEG byte string -> BGR uint8 [H, W, 3] on `device` (what
    `cv2.imdecode(buf, IMREAD_COLOR)` gives; with `grey`, uint8 [H, W] as
    `IMREAD_GRAYSCALE` gives). Entropy decoding runs here; the
    coefficients go to `device` in one copy, on its current stream, and
    the pixels are made there. A lossless frame's samples are rebuilt
    here and go to `device` in one copy; only their colour conversion
    runs there (`lossless_pixels`). `colour` (GREY, YCBCR, RGB, ...)
    replaces the colour space the markers name, as a container that
    states it does (a TIFF's photometric interpretation)."""
    frame = frame_info(data)
    if colour is not None:
        frame = frame._replace(colour=colour)
    if frame.lossless:
        _lossless_read(frame, grey)
        _, planes = decode_samples(data, frame)
        return lossless_pixels(torch.from_numpy(planes).to(device), frame,
                               grey)
    _, coefs = decode_coefficients(data, frame)
    return pixels(torch.from_numpy(coefs).to(device), frame, grey)


# -- the writer ---------------------------------------------------------------

QUALITY = 95                      # cv2.IMWRITE_JPEG_QUALITY's default
# natural (row-major) index of each zigzag position
ZIGZAG = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19,
          26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49,
          56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52,
          45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)
# Annex K.1's quantisation tables, natural order
LUMA_Q = (16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
          14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
          18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113,
          92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100,
          103, 99)
CHROMA_Q = (17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
            24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99
            ) + (99,) * 32
# Annex K.3's Huffman tables as DHT bodies: class/id, 16 counts, symbols
_DHT = (
    bytes([0x00, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0,
           *range(12)]),
    bytes.fromhex(
        '10000201030302040305050404000001'
        '7d01020300041105122131410613516107227114328191a1082342b1c11552d1'
        'f02433627282090a161718191a25262728292a3435363738393a434445464748'
        '494a535455565758595a636465666768696a737475767778797a838485868788'
        '898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4'
        'c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7'
        'f8f9fa'),
    bytes([0x01, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0,
           *range(12)]),
    bytes.fromhex(
        '11000201020404030407050404000102'
        '770001020311040521310612415107617113223281081442'
        '91a1b1c109233352f0156272d10a162434e125f11718191a262728292a353637'
        '38393a434445464748494a535455565758595a636465666768696a7374757677'
        '78797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3'
        'b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8'
        'e9eaf2f3f4f5f6f7f8f9fa'))
# libjpeg's FIX(x) of the RGB -> YCbCr weights (SCALEBITS 16)
_FIX = {k: int(v * 65536 + 0.5) for k, v in (
    ('0.299', 0.299), ('0.587', 0.587), ('0.114', 0.114),
    ('0.16874', 0.16874), ('0.33126', 0.33126), ('0.5', 0.5),
    ('0.41869', 0.41869), ('0.08131', 0.08131))}


def quality_tables() -> Tuple[np.ndarray, np.ndarray]:
    """The IJG quality scaling (`jcparam.c`) of the Annex K tables at
    `QUALITY`, baseline (clamped to 1-255): luma and chroma, natural
    order."""
    scale = 200 - QUALITY * 2
    return tuple(np.clip((np.asarray(t) * scale + 50) // 100, 1, 255)
                 for t in (LUMA_Q, CHROMA_Q))


def _reciprocals(quant: np.ndarray) -> np.ndarray:
    """libjpeg-turbo's `compute_reciprocal` for the ISLOW divisors
    `quant << 3` (16-bit DCTELEM): [3, 64] int64 of reciprocal,
    correction and shift; x -> sign(x) * (((|x| + corr) * recip) >>
    (shift + 16))."""
    out = np.zeros((3, 64), np.int64)
    for i, q in enumerate(np.asarray(quant).ravel()):
        d = int(q) << 3
        r = 16 + d.bit_length() - 1
        fq, fr = divmod(1 << r, d)
        c = d // 2
        if fr == 0:
            fq >>= 1
            r -= 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        out[:, i] = fq, c, r - 16
    return out


def _descale(x: Tensor, n: int) -> Tensor:
    return (x + (1 << (n - 1))) >> n


def _fdct_1d(d, first: bool):
    """One 8-point pass of `jfdctint.c` (CONST_BITS 13, PASS1_BITS 2):
    rows (`first`, left scaled up by 4) or columns (scaled by 8 overall)."""
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    n = 11 if first else 15
    o = [None] * 8
    if first:
        o[0], o[4] = (tmp10 + tmp11) << 2, (tmp10 - tmp11) << 2
    else:
        o[0], o[4] = _descale(tmp10 + tmp11, 2), _descale(tmp10 - tmp11, 2)
    z1 = (tmp12 + tmp13) * 4433
    o[2] = _descale(z1 + tmp13 * 6270, n)
    o[6] = _descale(z1 - tmp12 * 15137, n)
    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * 9633
    tmp4, tmp5, tmp6, tmp7 = (tmp4 * 2446, tmp5 * 16819, tmp6 * 25172,
                              tmp7 * 12299)
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    o[7] = _descale(tmp4 + z1 + z3, n)
    o[5] = _descale(tmp5 + z2 + z4, n)
    o[3] = _descale(tmp6 + z2 + z3, n)
    o[1] = _descale(tmp7 + z1 + z4, n)
    return o


def forward_dct(samples: Tensor) -> Tensor:
    """ISLOW forward DCT of uint8 sample blocks [..., 8, 8] (centred on
    128): int64 coefficients [..., 8, 8], scaled up by 8."""
    x = samples.to(torch.int64) - 128
    rows = torch.stack(_fdct_1d(x.unbind(-1), True), -1)
    return torch.stack(_fdct_1d(rows.unbind(-2), False), -2)


def quantize(coefs: Tensor, quant: np.ndarray) -> Tensor:
    """Divide [..., 64] DCT coefficients (natural order) by `quant << 3`
    as libjpeg-turbo does (`_reciprocals`): int64."""
    recip, corr, shift = (torch.as_tensor(v, device=coefs.device)
                          for v in _reciprocals(quant))
    mag = ((coefs.abs() + corr) * recip) >> (shift + 16)
    return torch.where(coefs < 0, -mag, mag)


def _replicate(plane: Tensor, rows: int, cols: int) -> Tensor:
    """`plane` grown to [rows, cols] by repeating its last row and
    column (`expand_bottom_edge` / `expand_right_edge`)."""
    h, w = plane.shape
    r = torch.arange(rows, device=plane.device).clamp(max=h - 1)
    c = torch.arange(cols, device=plane.device).clamp(max=w - 1)
    return plane.index_select(0, r).index_select(1, c)


def _blocks(plane: Tensor, quant: np.ndarray) -> Tensor:
    """A padded sample plane [8R, 8C] -> quantised blocks [R, C, 64]."""
    rows, cols = plane.shape[0] // 8, plane.shape[1] // 8
    b = plane.reshape(rows, 8, cols, 8).transpose(1, 2)
    return quantize(forward_dct(b).reshape(rows, cols, 64), quant)


def encode_blocks(img: Tensor):
    """The pixel stage of `imencode` on `img`'s device: BGR uint8
    [H, W, 3] (or grey [H, W]) -> (int16 [MCUs * per_mcu, 64] quantised
    blocks in zigzag order, MCU by MCU; each MCU block's component).
    Colour is 4:2:0: an MCU holds Y's 2x2 blocks, then Cb, then Cr."""
    luma_q, chroma_q = quality_tables()
    h, w = img.shape[:2]
    zigzag = torch.as_tensor(ZIGZAG, device=img.device)
    if img.dim() == 2:
        y = _replicate(img, -(-h // 8) * 8, -(-w // 8) * 8)
        blocks = _blocks(y, luma_q).reshape(-1, 64)
        return blocks[:, zigzag].to(torch.int16), (0,)
    px = img.to(torch.int64)
    b, g, r = px[..., 0], px[..., 1], px[..., 2]
    f = _FIX
    half, offset = 1 << 15, 128 << 16
    planes = [
        (f['0.299'] * r + f['0.587'] * g + f['0.114'] * b + half) >> 16,
        (-f['0.16874'] * r - f['0.33126'] * g + f['0.5'] * b + offset
         + half - 1) >> 16,
        (f['0.5'] * r - f['0.41869'] * g - f['0.08131'] * b + offset
         + half - 1) >> 16]
    mrows, mcols = -(-h // 16), -(-w // 16)
    # luma: real blocks over its own grid, then the MCU grid's dummies
    hb, wb = -(-h // 8), -(-w // 8)
    lum = _blocks(_replicate(planes[0], hb * 8, wb * 8), luma_q)
    grid = torch.zeros((2 * mrows, 2 * mcols, 64), dtype=torch.int64,
                       device=img.device)
    grid[:hb, :wb] = lum
    if wb % 2:                  # right dummies: DC of the block to the left
        grid[:hb, wb, 0] = grid[:hb, wb - 1, 0]
    if hb % 2:                  # bottom dummies: DC of the MCU's top right
        grid[hb, :, 0] = grid[hb - 1, 1::2, 0].repeat_interleave(2)
    # chroma: the input edge-replicated to whole 2x2 pairs and MCU width,
    # summed in pairs with the bias 1, 2, 1, 2 along the row, then its
    # last row repeated to the MCU height
    bias = 1 + torch.arange(mcols * 8, device=img.device) % 2
    chroma = []
    for plane in planes[1:]:
        p = _replicate(plane, -(-h // 2) * 2, mcols * 16)
        s = p.reshape(p.shape[0] // 2, 2, mcols * 8, 2).sum((1, 3))
        sub = _replicate((s + bias) >> 2, mrows * 8, mcols * 8)
        chroma.append(_blocks(sub, chroma_q))
    mcu = torch.cat([
        grid.reshape(mrows, 2, mcols, 2, 64).permute(0, 2, 1, 3, 4).reshape(
            mrows, mcols, 4, 64),
        chroma[0][:, :, None], chroma[1][:, :, None]], 2)
    blocks = mcu.reshape(-1, 64)[:, zigzag]
    return blocks.to(torch.int16), (0, 0, 0, 0, 1, 2)


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, 'big') + body


def headers(height: int, width: int, grey: bool) -> bytes:
    """SOI through SOS, as libjpeg writes them for `cv2.imwrite`."""
    luma_q, chroma_q = quality_tables()
    zz = list(ZIGZAG)
    out = b'\xff\xd8' + _segment(0xE0, b'JFIF\x00\x01\x01\x00\x00\x01\x00'
                                 b'\x01\x00\x00')
    tables = [luma_q] if grey else [luma_q, chroma_q]
    for i, t in enumerate(tables):
        out += _segment(0xDB, bytes([i]) + bytes(int(v) for v in t[zz]))
    comps = [(1, 0x11, 0)] if grey else [(1, 0x22, 0), (2, 0x11, 1),
                                        (3, 0x11, 1)]
    frame = bytes([8]) + height.to_bytes(2, 'big') + width.to_bytes(2, 'big')
    frame += bytes([len(comps)]) + b''.join(bytes(c) for c in comps)
    out += _segment(0xC0, frame)
    for body in _DHT[:2 if grey else 4]:
        out += _segment(0xC4, body)
    scan = bytes([len(comps)]) + b''.join(
        bytes([c[0], 0x00 if c[2] == 0 else 0x11]) for c in comps)
    return out + _segment(0xDA, scan + b'\x00\x3f\x00')


def encode_scan(blocks: np.ndarray, comps) -> bytes:
    """The entropy-coded segment of int16 zigzag blocks [n, 64], MCU by
    MCU (`comps[j]`: the component of an MCU's j-th block), on the host."""
    blocks = np.ascontiguousarray(blocks, np.int16)
    per_mcu = len(comps)
    comp = (ctypes.c_int * per_mcu)(*comps)
    # a block codes to at most 16 + 11 + 63 * (16 + 10) bits, each byte
    # possibly stuffed: 420 bytes
    cap = 420 * len(blocks) + 64
    out = np.empty(cap, np.uint8)
    written = ctypes.c_long(0)
    err = ctypes.create_string_buffer(256)
    if lib().hrf_jpeg_encode_scan(blocks.ctypes.data,
                                  len(blocks) // per_mcu, per_mcu, comp,
                                  out.ctypes.data, cap,
                                  ctypes.byref(written), err, len(err)):
        raise JpegError(_error(err))
    return out[:written.value].tobytes()


def imencode(img, device='cuda') -> bytes:
    """JPEG bytes of a uint8 BGR [H, W, 3] or grey [H, W] image, equal to
    `cv2.imencode('.jpg', img)[1]` (tests/test_torch_jpeg_encode.py). A
    tensor's pixels are coded on its device, an array's on `device`; the
    blocks come back in one copy and are Huffman-coded here."""
    if not isinstance(img, Tensor):
        img = torch.from_numpy(np.ascontiguousarray(img)).to(device)
    if img.dtype != torch.uint8 or not (
            img.dim() == 2 or (img.dim() == 3 and img.shape[2] == 3)):
        raise ValueError(f'JPEG encodes uint8 [H, W] or [H, W, 3], not '
                         f'{img.dtype} {list(img.shape)}')
    h, w = img.shape[:2]
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f'a JPEG frame of {h}x{w}')
    blocks, comps = encode_blocks(img)
    return (headers(h, w, img.dim() == 2)
            + encode_scan(blocks.cpu().numpy(), comps) + b'\xff\xd9')


def imwrite(path: str, img, device='cuda') -> None:
    """Write `imencode(img)` to `path` (as `cv2.imwrite` of a .jpg)."""
    data = imencode(img, device)
    with open(path, 'wb') as f:
        f.write(data)
