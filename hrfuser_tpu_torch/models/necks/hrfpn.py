"""HRFPN neck (`mmdet/models/necks/hrfpn.py:12-100`), NHWC.

Counterpart of `hrfuser_tpu.models.necks.hrfpn`: bilinear-upsample every
branch to stride 4, concat, 1x1 reduce, then average-pool a 5-level
pyramid and apply one 3x3 conv per level.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from hrfuser_tpu_torch.layers.common import bilinear_resize, conv_bn

Tensor = torch.Tensor


class ConvModule(nn.Module):
    """mmcv ConvModule without norm/act: only `.conv` (reference names)."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, padding=k // 2)


class HRFPN(nn.Module):
    def __init__(self, in_channels: int, out_channels: int = 256):
        super().__init__()
        self.reduction_conv = ConvModule(in_channels, out_channels, 1)
        self.fpn_convs = nn.ModuleList(
            [ConvModule(out_channels, out_channels, 3) for _ in range(5)])

    def forward(self, inputs: List[Tensor]) -> List[Tensor]:
        hw = inputs[0].shape[1:3]
        ups = [inputs[0]] + [bilinear_resize(x, hw) for x in inputs[1:]]
        x = conv_bn(torch.cat(ups, -1), self.reduction_conv.conv)
        outs = [x]
        for i in range(1, len(self.fpn_convs)):
            k = 2 ** i
            outs.append(F.avg_pool2d(x.permute(0, 3, 1, 2), k, k)
                        .permute(0, 2, 3, 1))
        return [conv_bn(o, m.conv) for o, m in zip(outs, self.fpn_convs)]
