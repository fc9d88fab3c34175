"""Batched inference API: `init_detector` -> callable `Detector`.

Counterpart of `hrfuser_tpu.apis.inference` for preprocessed batches
(the reference's `init_detector`, `mmdet/apis/inference.py:17-153`).
Weights are random, drawn from a seeded `torch.Generator` with the JAX
package's initializers (truncated LeCun-normal kernels, zero biases,
truncated-normal(0.02) RPE tables, unit norms); checkpoint loading waits
for a later change (a reference `.pth` already loads with
`model.load_state_dict`).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from hrfuser_tpu_torch.configs import get_config
from hrfuser_tpu_torch.models.detectors.cascade_rcnn import (CascadeRCNN,
                                                             predict)
from hrfuser_tpu_torch.models.roi_heads.cascade_roi_head import Detections

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
    """A ready-to-run detector: model + device + compute dtype."""

    def __init__(self, model: CascadeRCNN, device: torch.device,
                 dtype: torch.dtype = torch.float32):
        self.model = model
        self.cfg = model.cfg
        self.device = device
        self.dtype = dtype

    def _tensor(self, x: ArrayLike, dtype: torch.dtype) -> torch.Tensor:
        return torch.as_tensor(x).to(device=self.device, dtype=dtype)

    def __call__(self, img: ArrayLike, mod_imgs: Sequence[ArrayLike],
                 img_shapes: Optional[ArrayLike] = None,
                 scale_factors: Optional[ArrayLike] = None) -> Detections:
        """img: [B, H, W, 3] and mod_imgs: [B, H, W, C_k], preprocessed
        (normalized, padded to /32). Returns batched `Detections`."""
        f32 = torch.float32
        with torch.no_grad():
            return predict(
                self.model, self._tensor(img, self.dtype),
                [self._tensor(m, self.dtype) for m in mod_imgs],
                None if img_shapes is None else self._tensor(img_shapes, f32),
                None if scale_factors is None
                else self._tensor(scale_factors, f32))


def init_detector(config: str, device: Union[str, torch.device] = 'cuda',
                  seed: int = 0, dtype: torch.dtype = torch.float32
                  ) -> Detector:
    """Build a detector from a config name with seeded random weights.

    It runs on the card (its kernels) unless the caller passes
    `device='cpu'`, which runs the kernels' plain twins. The weights are
    drawn on the CPU, so one seed gives the same weights on every device.
    """
    model = CascadeRCNN(get_config(config))
    init_weights_(model, torch.Generator().manual_seed(seed))
    device = torch.device(device)
    return Detector(model.eval().to(device), device, dtype)
