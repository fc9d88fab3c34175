"""Shared2FC bbox head (`mmdet/models/roi_heads/bbox_heads/
convfc_bbox_head.py:201-215`).

Counterpart of `hrfuser_tpu.models.roi_heads.bbox_head`: flatten the 7x7
RoI feature, two shared FC + ReLU, a (num_classes + 1)-way classifier and
a class-agnostic 4-d regressor. `shared_fcs.0.weight` keeps the
reference's CHW flatten order; the pool emits [N, 49, C] rows, so the
weight is permuted to that order (once and cached in eval, differentiably
on every call in training) instead of transposing the activations.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from hrfuser_tpu_torch.layers.common import cached, linear

Tensor = torch.Tensor


class Shared2FCBBoxHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int,
                 fc_out_channels: int = 1024, roi_size: int = 7):
        super().__init__()
        self.in_channels = in_channels
        self.shared_fcs = nn.ModuleList([
            nn.Linear(in_channels * roi_size ** 2, fc_out_channels),
            nn.Linear(fc_out_channels, fc_out_channels)])
        self.fc_cls = nn.Linear(fc_out_channels, num_classes + 1)
        self.fc_reg = nn.Linear(fc_out_channels, 4)

    def forward(self, roi_feats: Tensor) -> Tuple[Tensor, Tensor]:
        """roi_feats [..., 49, C] -> (cls logits [..., C+1], deltas
        [..., 4]), float32."""
        fc0 = self.shared_fcs[0]
        c = self.in_channels
        dt = roi_feats.dtype

        def permuted():
            w = fc0.weight.reshape(fc0.out_features, c, -1).transpose(1, 2)
            return w.reshape(fc0.out_features, -1).to(dt), fc0.bias.to(dt)

        w0, b0 = (permuted() if fc0.training else
                  cached(fc0, ('qc_rows', dt), permuted,
                         [fc0.weight, fc0.bias]))
        x = F.relu(F.linear(roi_feats.flatten(-2), w0, b0))
        x = F.relu(linear(x, self.shared_fcs[1]))
        return (linear(x, self.fc_cls).float(),
                linear(x, self.fc_reg).float())
