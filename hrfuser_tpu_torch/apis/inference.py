"""Inference API: `init_detector` -> `Detector`; `inference_detector`.

Counterpart of `hrfuser_tpu/apis/inference.py` (the reference's
`init_detector` / `inference_detector`, `mmdet/apis/inference.py:17-153`).
A `Detector` answers preprocessed batches; `inference_detector` answers
one raw request (a BGR uint8 camera image and its sensor images) and
preprocesses it on the detector's device. Weights come from a checkpoint
(`utils/checkpoint.py`) or are random, drawn from a seeded
`torch.Generator` with the JAX package's initializers (truncated
LeCun-normal kernels, zero biases, truncated-normal(0.02) RPE tables,
unit norms).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from hrfuser_tpu_torch.configs import DataCfg, get_experiment
from hrfuser_tpu_torch.data.device_pipeline import (make_device_preprocess,
                                                    resize_image, to_device)
from hrfuser_tpu_torch.data.pipelines.transforms import rescale_size
from hrfuser_tpu_torch.models.detectors.cascade_rcnn import (CascadeRCNN,
                                                             predict)
from hrfuser_tpu_torch.models.roi_heads.cascade_roi_head import Detections
from hrfuser_tpu_torch.utils.checkpoint import load_weights

ArrayLike = Union[np.ndarray, torch.Tensor]

# flax's truncated_normal(stddev) is truncated at +-2 stddev and rescaled
# by this factor so its variance is stddev^2
_TRUNC_STD = 0.87962566103423978


def _trunc_normal_(t: torch.Tensor, std: float, g: torch.Generator) -> None:
    s = std / _TRUNC_STD
    nn.init.trunc_normal_(t, 0.0, s, -2 * s, 2 * s, generator=g)


def init_weights_(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter as the JAX package's `init` would."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith('relative_position_bias_table'):
                _trunc_normal_(p, 0.02, generator)
            elif p.dim() > 1:                    # conv / linear kernels
                _trunc_normal_(p, 1.0 / math.sqrt(p[0].numel()), generator)
            else:                                # biases; norms below
                p.zero_()
        for m in model.modules():
            if isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
                m.weight.fill_(1.0)
            if isinstance(m, nn.BatchNorm2d):
                m.reset_running_stats()


class Detector:
    """A ready-to-run detector: model + data config + device + compute
    dtype."""

    def __init__(self, model: CascadeRCNN, data: DataCfg,
                 device: torch.device, dtype: torch.dtype = torch.float32):
        self.model = model
        self.cfg = model.cfg
        self.data = data
        self.device = device
        self.dtype = dtype

    def _tensor(self, x: ArrayLike, dtype: torch.dtype) -> torch.Tensor:
        return torch.as_tensor(x).to(device=self.device, dtype=dtype)

    def __call__(self, img: ArrayLike,
                 mod_imgs: Optional[Sequence[ArrayLike]],
                 img_shapes: Optional[ArrayLike] = None,
                 scale_factors: Optional[ArrayLike] = None) -> Detections:
        """img: [B, H, W, 3] and mod_imgs: [B, H, W, C_k], preprocessed
        (normalized, padded to /32). Returns batched `Detections`."""
        f32 = torch.float32
        with torch.no_grad():
            return predict(
                self.model, self._tensor(img, self.dtype),
                [self._tensor(m, self.dtype) for m in mod_imgs or []],
                None if img_shapes is None else self._tensor(img_shapes, f32),
                None if scale_factors is None
                else self._tensor(scale_factors, f32))


def init_detector(config: str, device: Union[str, torch.device] = 'cuda',
                  seed: int = 0, dtype: torch.dtype = torch.float32,
                  checkpoint: Optional[str] = None) -> Detector:
    """Build a detector from a config name, with the weights of
    `checkpoint` (a file or a checkpoint directory) or seeded random
    ones.

    It runs on the card (its kernels) unless the caller passes
    `device='cpu'`, which runs the kernels' plain twins. The weights are
    drawn and loaded on the CPU, so one seed gives the same weights on
    every device.
    """
    exp = get_experiment(config)
    model = CascadeRCNN(exp.model)
    init_weights_(model, torch.Generator().manual_seed(seed))
    if checkpoint:
        load_weights(checkpoint, model)
    device = torch.device(device)
    return Detector(model.eval().to(device), exp.data, device, dtype)


def request_to_device(detector: Detector, img: ArrayLike,
                      mod_imgs: Optional[Sequence[ArrayLike]] = None
                      ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Copy one request's images to the detector's device, each with a
    batch axis of 1 (uint16 as its int16 bits, `to_device`)."""
    return (to_device(img, detector.device)[None],
            [to_device(m, detector.device)[None] for m in mod_imgs or []])


def preprocess_request(detector: Detector, img: torch.Tensor,
                       mods: Sequence[torch.Tensor]):
    """One request on the device -> the model's inputs.

    The camera image is resized (bilinear) to `data.img_scale` with the
    `Resize` size rule (STF: (1248, 384) keeping the aspect ratio, as the
    JAX `inference_detector` does; the dataset crops belong to the
    loader), sensor images not on its grid are brought there by nearest
    neighbour, then each is normalized with its dataset's table and
    padded (`sensor_values`). A fusion model asked without sensor images
    gets zeroed streams in normalized space, which modality dropout
    trains it to tolerate; a camera-only model gets none. Returns (img,
    mods, img_shapes, scale_factors), float32.
    """
    data = detector.data
    want = list(detector.cfg.backbone.mod_in_channels[
        :detector.cfg.backbone.num_fused_modalities])
    got = [m.shape[-1] for m in mods]
    if got and got != want:
        raise ValueError(f'sensor images with {got} channels; the model '
                         f'takes {want} ({", ".join(data.modalities)})')
    h, w = img.shape[1:3]
    new_h, new_w, scale_factor = rescale_size(h, w, data.img_scale)
    img = resize_image(img, (new_h, new_w))
    mods = [resize_image(m, (new_h, new_w), 'nearest') for m in mods]
    pre = make_device_preprocess(data.dataset, data.modalities,
                                 data.pad_divisor)
    img, mods = pre(img, mods)
    if data.modalities and mods is None:
        mods = [img.new_zeros((*img.shape[:3], c))
                for c in detector.cfg.backbone.mod_in_channels]
    dev = detector.device
    return (img, mods,
            torch.tensor([[new_h, new_w]], dtype=torch.float32, device=dev),
            torch.from_numpy(scale_factor)[None].to(dev))


def detections_of(out: Detections, i: int = 0) -> Dict[str, np.ndarray]:
    """Image `i`'s valid detections as numpy arrays."""
    v = out.valid[i].cpu().numpy()
    return dict(boxes=out.boxes[i].float().cpu().numpy()[v],
                scores=out.scores[i].float().cpu().numpy()[v],
                labels=out.labels[i].cpu().numpy()[v])


def inference_detector(detector: Detector, img: ArrayLike,
                       mod_imgs: Optional[Sequence[ArrayLike]] = None
                       ) -> Dict[str, np.ndarray]:
    """Detect objects in one raw request.

    Args:
        img: [H, W, 3] uint8 BGR camera image, any size.
        mod_imgs: the sensor images in the config's modality order,
            [h, w, C] uint16 (png values, dequantized on the device; the
            STF gated image [h, w, 1], its integers taken as
            intensities) or float32 (raw values); None for camera only.

    Returns:
        dict(boxes [N, 4] in the original image's frame, scores [N],
        labels [N]) of the valid detections.
    """
    img_t, mods_t = request_to_device(detector, img, mod_imgs)
    return detections_of(detector(*preprocess_request(detector, img_t,
                                                      mods_t)))
