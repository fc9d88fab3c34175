"""JPEG decoding without a JPEG library: Huffman on the host, pixels on
the card.

The port's JPEG decoder, in place of libjpeg (which the JAX package's
loader links, `hrfuser_tpu/data/native.py`, and which `cv2` bundles):
  * `decode_coefficients(data)`: the host half, `csrc/jpeg_entropy.cpp`
    (markers and Huffman decoding, sequential by nature), bound with
    ctypes. It returns each component's quantised coefficients and
    quantisation table in one int16 array.
  * `pixels(coefs, frame)`: the kernel half, `csrc/jpeg_pixels.cu`, two
    launches an image: dequantisation and the integer inverse DCT into
    one sample plane per component, then chroma upsampling and colour
    conversion into BGR. A CUDA tensor launches the kernel (or raises); a
    CPU tensor takes the plain twin `pixels_plain`, nothing else does.
  * `decode_jpeg(data, device)`: both, with one host-to-device copy of
    the coefficients on the caller's current stream.

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
and `cv2` give (tests/test_torch_jpeg.py). Progressive, lossless,
hierarchical, arithmetic-coded, 12-bit and 2- or 4-component files raise
`JpegError` naming the mode.

The host library is built with `g++ -O3 -shared -fPIC` into `build/` at
the repository root at first use, named by a hash of the source. Nothing
is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from hrfuser_tpu_torch.ops.chain import on_cpu
from hrfuser_tpu_torch.utils import cuda_build

SOURCE = Path(__file__).resolve().parents[1] / 'csrc' / 'jpeg_entropy.cpp'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build'
GREY, YCBCR, RGB = 0, 1, 2

_P = ctypes.c_void_p
_SIGNATURES = {
    'hrf_jpeg_info': [ctypes.c_char_p, ctypes.c_long, _P, ctypes.c_char_p,
                      ctypes.c_int],
    'hrf_jpeg_decode': [ctypes.c_char_p, ctypes.c_long, _P, ctypes.c_long,
                        ctypes.c_char_p, ctypes.c_int],
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
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f'libhrfuser_jpeg_{tag}.so'
    if out.exists() and not again:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    cmd = ['g++', '-O3', '-std=c++17', '-shared', '-fPIC', str(SOURCE),
           '-o', str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f'the JPEG entropy decoder needs g++: {e}') from e
    if proc.returncode != 0:
        raise RuntimeError(f'building the JPEG entropy decoder failed\n'
                           f'{" ".join(cmd)}\n{proc.stderr}')
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded entropy decoder (built at first use). A cached library
    that does not load (built on another machine) is built again."""
    global _lib
    with _lock:
        if _lib is None:
            try:
                handle = ctypes.CDLL(str(build()))
            except OSError:
                path = build(again=True)
                try:
                    handle = ctypes.CDLL(str(path))
                except OSError as e:
                    raise RuntimeError(f'the JPEG entropy decoder {path} '
                                       f'does not load ({e})') from e
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


class Frame(NamedTuple):
    """A JPEG frame's layout: image size, colour space (GREY, YCBCR or
    RGB) and per component (h, v, block rows, block cols), the block
    grid padded to whole MCUs."""
    height: int
    width: int
    colour: int
    comps: Tuple[Tuple[int, int, int, int], ...]

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
    info = (ctypes.c_int * 16)()
    err = ctypes.create_string_buffer(256)
    if lib().hrf_jpeg_info(data, len(data), info, err, len(err)):
        raise JpegError(_error(err))
    n = info[2]
    comps = tuple(tuple(info[4 + 4 * c:8 + 4 * c]) for c in range(n))
    frame = Frame(info[0], info[1], info[3], comps)
    for i in range(n):
        frame.expand(i)
    return frame


def jpeg_shape(data: bytes) -> Tuple[int, int, int]:
    """A JPEG's (height, width, components)."""
    f = frame_info(data)
    return f.height, f.width, len(f.comps)


def decode_coefficients(data: bytes) -> Tuple[Frame, np.ndarray]:
    """Huffman-decode a JPEG on the host: (frame, int16 array of
    `frame.size` values: each component's [block rows, block cols, 64]
    coefficients in natural order, one after the other, then each
    component's 64 quantisation values)."""
    frame = frame_info(data)
    out = np.empty(frame.size, np.int16)
    err = ctypes.create_string_buffer(256)
    if lib().hrf_jpeg_decode(data, len(data), out.ctypes.data, out.size,
                             err, len(err)):
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


def _colour(samples, colour: int) -> Tensor:
    """Full-size components (int64 [H, W] each) -> BGR uint8 [H, W, 3]
    (launch 2's colour conversion)."""
    if colour == GREY:
        y = samples[0]
        return torch.stack([y, y, y], -1).to(torch.uint8)
    if colour == RGB:
        r, g, b = samples
        return torch.stack([b, g, r], -1).to(torch.uint8)
    y, cb, cr = samples
    xb, xr = cb - 128, cr - 128
    red = y + ((91881 * xr + 32768) >> 16)
    green = y + ((-22554 * xb + 32768 - 46802 * xr) >> 16)
    blue = y + ((116130 * xb + 32768) >> 16)
    return torch.stack([blue, green, red], -1).clamp(0, 255).to(torch.uint8)


def pixels_plain(coefs: Tensor, frame: Frame) -> Tensor:
    """The kernel's plain twin: `decode_coefficients`' array (int16, any
    device) -> BGR uint8 [H, W, 3] on its device."""
    blocks, quant = split(coefs, frame)
    planes = _planes(blocks, quant)
    full = [_upsample(p, frame, i) for i, p in enumerate(planes)]
    return _colour(full, frame.colour)


# -- the kernel -------------------------------------------------------------

def _launch(coefs: Tensor, frame: Frame) -> Tensor:
    if (coefs.dtype != torch.int16 or coefs.dim() != 1
            or coefs.numel() != frame.size or not coefs.is_contiguous()):
        raise ValueError(f'jpeg pixels kernel: coefficients must be a '
                         f'contiguous int16 vector of {frame.size}')
    n = len(frame.comps)
    blocks = frame.blocks
    dev = coefs.device
    planes = torch.empty(64 * sum(blocks), dtype=torch.uint8, device=dev)
    out = torch.empty((frame.height, frame.width, 3), dtype=torch.uint8,
                      device=dev)
    params = []
    for i, (h, v, r, c) in enumerate(frame.comps):
        dh, dw = frame.sampled(i)
        ey, ex = frame.expand(i)
        params += [r, c, dh, dw, ey, ex]
    params = (ctypes.c_int * len(params))(*params)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = cuda_build.lib()
    cuda_build.check(lib.hrf_jpeg_idct(coefs.data_ptr(), planes.data_ptr(),
                                       params, n, stream), 'hrf_jpeg_idct')
    pixels.launches += 1
    cuda_build.check(lib.hrf_jpeg_color(planes.data_ptr(), out.data_ptr(),
                                        params, n, frame.height,
                                        frame.width, frame.colour, stream),
                     'hrf_jpeg_color')
    pixels.launches += 1
    return out


def pixels(coefs: Tensor, frame: Frame) -> Tensor:
    """`decode_coefficients`' array as a tensor -> BGR uint8 [H, W, 3] on
    its device: the kernel (two launches, counted in `pixels.launches`)
    for a CUDA tensor, the plain twin for a CPU one."""
    if on_cpu(coefs):
        return pixels_plain(coefs, frame)
    return _launch(coefs, frame)


pixels.launches = 0


def decode_jpeg(data: bytes, device='cuda') -> Tensor:
    """A JPEG byte string -> BGR uint8 [H, W, 3] on `device` (what
    `cv2.imdecode(buf, IMREAD_COLOR)` gives). Huffman decoding runs here;
    the coefficients go to `device` in one copy, on its current stream,
    and the pixels are made there."""
    frame, coefs = decode_coefficients(data)
    return pixels(torch.from_numpy(coefs).to(device), frame)
