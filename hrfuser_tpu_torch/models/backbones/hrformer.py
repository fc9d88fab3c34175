"""HRFormer stem (`hrfuser_tpu.models.backbones.hrformer.Stem`).

conv3x3/2 -> BN -> ReLU -> conv3x3/2 -> BN -> ReLU, 64 channels. The
reference keeps the stem's convs directly on the backbone (`conv1`,
`bn1`, `conv2`, `bn2`; `conv_a`/`norm_a`/`conv_b`/`norm_b` for the
modality streams), so the stem is a function over those modules. The
camera-only HRFormer backbone is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from hrfuser_tpu_torch.layers.common import conv_bn


def stem(x: torch.Tensor, conv1: nn.Conv2d, bn1: nn.BatchNorm2d,
         conv2: nn.Conv2d, bn2: nn.BatchNorm2d) -> torch.Tensor:
    x = conv_bn(x, conv1, bn1, relu=True)
    return conv_bn(x, conv2, bn2, relu=True)
