"""The JAX package's native loader API (`hrfuser_tpu/data/native.py`),
under its name, with no library.

The JAX module binds `_native/loader.cpp` (libpng, libjpeg, a pthread
pool). Here the same functions stand on the port's own decoders:
`data/png.py` for PNG, `data/jpeg.py` for JPEG (entropy decoding on the
host, pixels on `device`), and the sensor dequantisation runs on
`device` in float32.

  * `png16_shape(path)` / `decode_png16(path)`: a PNG's samples [H, W, C]
    as `cv2.IMREAD_UNCHANGED` reads them (`data/png.py`), C kept for grey.
  * `decode_jpeg_bgr(path, device)`: BGR uint8 [H, W, 3] as
    `cv2.IMREAD_COLOR` reads the file (every JPEG `data/jpeg.py` reads:
    the JAX function's libjpeg 2.1 reads fewer, and its loader falls
    through to `cv2` for the rest).
  * `decode_sensor_png(path, scale, shift, mean, std, device)`: decode,
    dequantise and normalise, float32 [H, W, C] on `device`, in
    `loader.cpp:101-110`'s order and rounding: times the float32
    reciprocal of `scale`, minus `shift`, minus the channel's mean, times
    the float32 reciprocal of its std. The JAX library is built with
    plain `g++ -O3` (no FMA), so each step rounds on its own, as each
    PyTorch elementwise op does: the result is bit-equal on the CPU and
    on the card.
  * `decode_sensor_batch(paths, shapes, ...)`: PNG decoding (zlib's
    inflate releases the GIL) on a pool of `num_threads` host threads,
    then each file's dequantisation on `device`; a file that is missing,
    does not decode or has another shape than `shapes` gives counts as a
    failure, and any failure raises `IOError` naming how many.

Where the JAX library departs from `cv2`, this module follows `cv2` and
`data/png.py` (tests/test_torch_native.py): an 8-bit PNG reads as its
values v, not v x 257 (`png_set_expand_16`); a palette file reads as BGR
(BGRA with tRNS) and an RGB file with tRNS as BGRA, where
`loader.cpp:58-96` sizes the buffer by the file's channel count and then
writes the expanded pixels past its end; grey + alpha reads as BGRA
(grey repeated), not as the JAX library's two channels.
"""

from __future__ import annotations

import os.path as osp
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from hrfuser_tpu_torch.data import png
from hrfuser_tpu_torch.data.device_pipeline import to_device
from hrfuser_tpu_torch.data.pipelines.loading import read_jpeg


def available() -> bool:
    """Always True: nothing is built or linked."""
    return True


def _png(path: str) -> np.ndarray:
    """A PNG file's samples [H, W, C] as `cv2.IMREAD_UNCHANGED` reads
    them; a missing or undecodable file raises `IOError`."""
    if not osp.exists(path):
        raise FileNotFoundError(path)
    with open(path, 'rb') as f:
        data = f.read()
    try:
        img = png.imdecode(data, unchanged=True)
    except (ValueError, IndexError) as e:
        raise IOError(f'{path}: {e}') from e
    return img[..., None] if img.ndim == 2 else img


def png16_shape(path: str):
    """(height, width, channels) of `decode_png16(path)`."""
    return _png(path).shape


def decode_png16(path: str) -> np.ndarray:
    """A PNG's samples [H, W, C] at the file's depth (uint16 for a 16-bit
    file, uint8 otherwise), BGR(A) for colour, as `cv2.IMREAD_UNCHANGED`
    reads them."""
    return _png(path)


def decode_jpeg_bgr(path: str, device='cuda') -> np.ndarray:
    """A JPEG file as BGR uint8 [H, W, 3] on the host, its pixels made on
    `device`; a file that does not decode raises `IOError`."""
    if not osp.exists(path):
        raise FileNotFoundError(path)
    with open(path, 'rb') as f:
        return read_jpeg(f.read(), device)


def _dequantize(raw: np.ndarray, scale: float, shift: float, mean, std,
                device) -> torch.Tensor:
    """float32 [H, W, C] on `device`: ((v * (1 / scale) - shift) - mean)
    * (1 / std), each step rounded, the reciprocals taken in float32 as
    `loader.cpp` takes them."""
    t = to_device(raw, device)
    if raw.dtype == np.uint16:                    # int16 bits on the way
        t = t.to(torch.int32) & 0xFFFF
    x = t.to(torch.float32)

    def vec(v):
        return torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(
            x.device)

    x = x * vec(np.float32(1) / np.float32(scale))
    x = x - vec(np.float32(shift))
    if mean is not None:
        x = x - vec(mean)
    if std is not None:
        x = x * vec(np.float32(1) / np.asarray(std, np.float32))
    return x


def decode_sensor_png(path: str, scale: float, shift: float,
                      mean: Optional[Sequence[float]] = None,
                      std: Optional[Sequence[float]] = None,
                      device='cuda') -> torch.Tensor:
    """Decode a sensor PNG and dequantise (and normalise) it: float32
    [H, W, C] on `device`, `(v / scale - shift - mean) / std` as the JAX
    library rounds it."""
    return _dequantize(_png(path), scale, shift, mean, std, device)


def decode_sensor_batch(paths: Sequence[str], shapes, scale: float,
                        shift: float, means=None, stds=None,
                        num_threads: int = 4,
                        device='cuda') -> List[torch.Tensor]:
    """`decode_sensor_png` of many files: `shapes[i]` is file i's
    (h, w, c), `means[i]` / `stds[i]` its normalisation. The PNGs decode
    on `num_threads` host threads; raises `IOError` naming the number of
    files that failed (missing, undecodable, or of another shape)."""

    def read(i):
        try:
            img = _png(paths[i])
        except OSError:
            return None
        return img if img.shape == tuple(shapes[i]) else None

    with ThreadPoolExecutor(max(1, num_threads)) as pool:
        raws = list(pool.map(read, range(len(paths))))
    failures = sum(r is None for r in raws)
    if failures:
        raise IOError(f'decode_sensor_batch: {failures} failures')
    return [_dequantize(r, scale, shift,
                        None if means is None else means[i],
                        None if stds is None else stds[i], device)
            for i, r in enumerate(raws)]
