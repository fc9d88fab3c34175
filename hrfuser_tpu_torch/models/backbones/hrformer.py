"""Camera-only HRFormer backbone, NHWC.

Counterpart of `hrfuser_tpu.models.backbones.hrformer` (the reference
`mmdet/models/backbones/hrformer.py:564-740`): a two-conv stride-2 stem,
a Bottleneck stage 1, then three multi-resolution HRFormer stages joined
by transitions (each HRModule rematerialised in a training backward
with `cfg.remat`). The reference keeps the stem's convs directly on the
backbone (`conv1`, `bn1`, `conv2`, `bn2`; `conv_a`/`norm_a`/`conv_b`/
`norm_b` for HRFuser's modality streams), so the stem is a function over
those modules. Parameter names are the reference's.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from hrfuser_tpu_torch.layers.common import conv3x3, conv_bn, res_layer
from hrfuser_tpu_torch.models.backbones.hr_config import HRBackboneCfg
from hrfuser_tpu_torch.models.backbones.hr_modules import (HRStage,
                                                           Transition)

Tensor = torch.Tensor


def stem(x: Tensor, conv1: nn.Conv2d, bn1: nn.BatchNorm2d,
         conv2: nn.Conv2d, bn2: nn.BatchNorm2d) -> Tensor:
    """conv3x3/2 -> BN -> ReLU -> conv3x3/2 -> BN -> ReLU, 64 channels."""
    x = conv_bn(x, conv1, bn1, relu=True)
    return conv_bn(x, conv2, bn2, relu=True)


class HRFormerBackbone(nn.Module):
    """stem -> layer1 -> transition1 -> stage2 -> transition2 -> stage3
    -> transition3 -> stage4 (`hrfuser_tpu/models/backbones/hrformer.py:
    39-75`), with the standard transitions throughout."""

    def __init__(self, cfg: HRBackboneCfg):
        super().__init__()
        self.cfg = cfg
        self.conv1 = conv3x3(3, 64, 2)
        self.bn1 = nn.BatchNorm2d(64)
        self.conv2 = conv3x3(64, 64, 2)
        self.bn2 = nn.BatchNorm2d(64)
        self.layer1 = res_layer(cfg.stage1.block, 64,
                                cfg.stage1.num_channels[0],
                                cfg.stage1.num_blocks[0])
        self.transition1 = Transition(cfg.stage1.out_channels,
                                      cfg.stage2.out_channels)
        self.transition2 = Transition(cfg.stage2.out_channels,
                                      cfg.stage3.out_channels)
        self.transition3 = Transition(cfg.stage3.out_channels,
                                      cfg.stage4.out_channels)
        self.stage2 = HRStage(cfg.stage2, cfg.remat)
        self.stage3 = HRStage(cfg.stage3, cfg.remat)
        self.stage4 = HRStage(cfg.stage4, cfg.remat)

    def forward(self, x: Tensor) -> List[Tensor]:
        """x: [B, H, W, 3]. Returns one NHWC map per branch (strides 4, 8,
        16, 32)."""
        x = self.layer1(stem(x, self.conv1, self.bn1, self.conv2, self.bn2))
        xs = self.stage2(self.transition1([x]))
        xs = self.stage3(self.transition2(xs))
        return self.stage4(self.transition3(xs))
