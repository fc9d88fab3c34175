"""Preprocessing on the tensors' device: raw camera and sensor images in,
model-ready batches out.

Port of `hrfuser_tpu/data/device_pipeline.py:25-110`. Every function runs
where its input tensors live (the card for a served request, the CPU in
the tests). On top of the JAX module it resizes on the device
(`resize_image`), which the JAX package leaves to `cv2` on the host.

All arithmetic is float32. The cast to the detector's dtype comes after
normalisation and padding: bfloat16 cannot hold a dequantised uint16
value (65535 / 100 - 200) to better than about 2.

uint16 sensor images travel to the device as their int16 bit pattern
(`to_device`), since `torch.uint16` has few operations on either build;
`dequantize_sensor` reads an int16 tensor as that pattern.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from hrfuser_tpu_torch.data import norms as norm_tables
from hrfuser_tpu_torch.data.projection import SCALE, SHIFT

Tensor = torch.Tensor


def to_device(x: Union[np.ndarray, Tensor], device) -> Tensor:
    """A host array or tensor on `device`; uint16 moves as int16 bits."""
    if isinstance(x, np.ndarray):
        x = np.ascontiguousarray(x)
        if x.dtype == np.uint16:
            x = x.view(np.int16)
        x = torch.from_numpy(x)
    elif x.dtype == torch.uint16:
        x = x.view(torch.int16)
    return x.to(device)


def normalize_image(img: Tensor, mean, std, to_rgb: bool = True) -> Tensor:
    """uint8/float BGR [B, H, W, 3] -> normalized float32 (RGB)."""
    x = img.to(torch.float32)
    if to_rgb:
        x = x.flip(-1)
    return ((x - torch.tensor(mean, dtype=torch.float32, device=x.device))
            / torch.tensor(std, dtype=torch.float32, device=x.device))


def dequantize_sensor(img: Tensor, scale: float = SCALE,
                      shift: float = SHIFT) -> Tensor:
    """uint16 sensor png values -> raw float (`loading.py:303-310`); an
    int16 tensor is read as the bit pattern of uint16."""
    if img.dtype in (torch.int16, torch.uint16):
        img = img.view(torch.int16).to(torch.int32) & 0xFFFF
    # a tensor divisor: CUDA multiplies by the reciprocal of a Python
    # scalar, one ulp off numpy's quotient
    scale = torch.tensor(scale, dtype=torch.float32, device=img.device)
    return img.to(torch.float32) / scale - shift


def sensor_values(img: Tensor, name: str, scale: float = SCALE,
                  shift: float = SHIFT) -> Tensor:
    """A sensor stream's raw float32 values. Floating-point streams are
    taken as raw; integer ones are uint16 projections, dequantized, except
    the STF gated image: a grey image whose integer values are its
    intensities (the JAX loader reads it as a grey image cast to float,
    `hrfuser_tpu/data/pipelines/loading.py:114`)."""
    if img.is_floating_point():
        return img.to(torch.float32)
    if name != 'gated':
        return dequantize_sensor(img, scale, shift)
    if img.dtype == torch.int16:                 # uint16 bits
        img = img.to(torch.int32) & 0xFFFF
    return img.to(torch.float32)


def normalize_sensor(raw: Tensor, mean, std) -> Tensor:
    return ((raw - torch.tensor(mean, dtype=torch.float32, device=raw.device))
            / torch.tensor(std, dtype=torch.float32, device=raw.device))


def pad_to_divisor(x: Tensor, divisor: int = 32) -> Tensor:
    """Zero-pad [B, H, W, C] at the bottom and right to multiples of
    `divisor`."""
    ph = (-x.shape[1]) % divisor
    pw = (-x.shape[2]) % divisor
    if ph == 0 and pw == 0:
        return x
    return F.pad(x, (0, 0, 0, pw, 0, ph))


def _nearest_index(src: int, dst: int) -> np.ndarray:
    """`cv2.INTER_NEAREST`'s source index of each output pixel:
    floor(x / (dst / src)) in double precision, clamped to the edge."""
    ifx = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * ifx), src - 1).astype(
        np.int64)


def resize_image(x: Tensor, hw: Tuple[int, int],
                 mode: str = 'bilinear') -> Tensor:
    """Resize [B, H, W, C] to `hw` = (h, w).

    'bilinear': `cv2.INTER_LINEAR` on a float image (half-pixel centres,
    no antialiasing), computed in float32 by `interpolate`. 'nearest':
    `cv2.INTER_NEAREST` (floor(dst * src / dst), not 'nearest-exact'), a
    gather that keeps the input's dtype.
    """
    h, w = hw
    if tuple(x.shape[1:3]) == (h, w):
        return x
    if mode == 'nearest':
        rows = torch.from_numpy(_nearest_index(x.shape[1], h)).to(x.device)
        cols = torch.from_numpy(_nearest_index(x.shape[2], w)).to(x.device)
        return x.index_select(1, rows).index_select(2, cols)
    if mode != 'bilinear':
        raise ValueError(f'resize mode {mode!r}: bilinear or nearest')
    y = F.interpolate(x.to(torch.float32).permute(0, 3, 1, 2), size=(h, w),
                      mode='bilinear', align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1).contiguous()


def modality_drop(generator: torch.Generator, streams: List[Tensor],
                  drop_p: Sequence[float]) -> List[Tensor]:
    """Train-time modality dropout (RandomDrop semantics): zero each
    stream independently per sample with prob p. The draws come from
    `generator`, on its own device."""
    out = []
    for x, p in zip(streams, drop_p):
        u = torch.rand((x.shape[0],), generator=generator,
                       device=generator.device)
        keep = (u >= p).to(device=x.device, dtype=x.dtype)
        out.append(x * keep[:, None, None, None])
    return out


def make_device_preprocess(dataset: str = 'nuscenes',
                           modalities: Sequence[str] = ('lidar', 'radar'),
                           pad_divisor: int = 32,
                           sensor_scale: float = SCALE,
                           sensor_shift: float = SHIFT):
    """Preprocess: raw tensors -> model-ready float32 batch.

    Inputs: img uint8 (or float) [B, H, W, 3] BGR, already on the target
    grid (`resize_image`); per modality in `modalities` order [B, H, W, C]
    (`sensor_values`: integer uint16 png values are dequantized, the
    gated image's integers taken as intensities, floats as raw). Each
    stream is normalized with its own table.
    """
    tables = norm_tables.STF if dataset == 'stf' else norm_tables.NUS

    def preprocess(img: Tensor, mods: Optional[List[Tensor]] = None
                   ) -> Tuple[Tensor, Optional[List[Tensor]]]:
        img = pad_to_divisor(normalize_image(img, **tables['img']),
                             pad_divisor)
        if not mods:
            return img, None
        out = []
        for name, m in zip(modalities, mods, strict=True):
            raw = sensor_values(m, name, sensor_scale, sensor_shift)
            t = tables[name]
            out.append(pad_to_divisor(
                normalize_sensor(raw, t['mean'], t['std']), pad_divisor))
        return img, out

    return preprocess


def make_raw_predictor(detector):
    """Raw-input predictor of a `Detector`: uint8 camera and uint16
    sensor batches on the model grid (host arrays or tensors) in,
    batched `Detections` out; preprocessing runs on the detector's
    device."""
    data = detector.data
    pre = make_device_preprocess(data.dataset, data.modalities,
                                 data.pad_divisor)

    def run(img_u8, mod_u16, img_shapes, scale_factors):
        img, mods = pre(to_device(img_u8, detector.device),
                        [to_device(m, detector.device) for m in mod_u16]
                        if mod_u16 else None)
        return detector(img, mods, img_shapes, scale_factors)

    return run
