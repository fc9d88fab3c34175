"""Cascade RoI head: 3-stage refinement with fixed-size outputs.

Counterpart of `hrfuser_tpu.models.roi_heads.cascade_roi_head` (the
reference `CascadeRoIHead.simple_test`, `mmdet/models/roi_heads/
cascade_roi_head.py:288-411`): per stage RoIAlign + Shared2FC; between
stages RoIs are refined by decoding the class-agnostic deltas; stage
logits are averaged and softmaxed once, then multiclass NMS gives the
fixed-size detection set. Every image of the batch runs at once; RoIs are
[B, R, 4] with a validity mask. `forward_stage` pools with kernel C in
eval and with the one-hot formulation in training (`pool_method`, as the
JAX head trains).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence, Tuple

import torch
from torch import nn
from torch.utils import _pytree

from hrfuser_tpu_torch.models.roi_heads.bbox_head import Shared2FCBBoxHead
from hrfuser_tpu_torch.ops.boxes import delta2bbox
from hrfuser_tpu_torch.ops.nms import multiclass_nms
from hrfuser_tpu_torch.ops.roi_align import (multilevel_roi_align,
                                             multilevel_roi_align_onehot)

Tensor = torch.Tensor

# Per-stage delta std schedule (`cascade_rcnn_hrfuser_fpn_nus_clr_fusion.py`).
STAGE_STDS = ((0.1, 0.1, 0.2, 0.2), (0.05, 0.05, 0.1, 0.1),
              (0.033, 0.033, 0.067, 0.067))


@dataclasses.dataclass(frozen=True)
class RoIHeadCfg:
    """`hrfuser_tpu`'s `RoIHeadCfg` without its TPU eval-pool knobs: eval
    pools with kernel C, training with the one-hot formulation
    (`pool_method`), whose einsum operands are rounded to bfloat16 when
    `gather_bf16` is set. `sample_num` > 0 samples a static grid a bin;
    0 is the reference's exact `sampling_ratio=0` (ceil(bin) samples an
    axis, capped at `max_grid`), in both pools."""
    num_classes: int
    num_stages: int = 3
    stage_loss_weights: Tuple[float, ...] = (1.0, 0.5, 0.25)
    stage_stds: Tuple[Tuple[float, ...], ...] = STAGE_STDS
    fc_out_channels: int = 1024
    roi_size: int = 7
    sample_num: int = 2
    max_grid: int = 4
    pool_method: str = 'onehot'
    gather_bf16: bool = True
    finest_scale: int = 56
    featmap_strides: Tuple[int, ...] = (4, 8, 16, 32)
    score_thr: float = 0.05
    nms_iou: float = 0.5
    max_per_img: int = 100


class Detections(NamedTuple):
    boxes: Tensor       # [B, max_per_img, 4]
    scores: Tensor      # [B, max_per_img]
    labels: Tensor      # [B, max_per_img] int32, -1 padding
    valid: Tensor       # [B, max_per_img] bool


# the name a saved `torch.export` program (`apis/export.py`) gives its
# output type; loading one needs this registration
_pytree._register_namedtuple(
    Detections, serialized_type_name='hrfuser_tpu_torch.Detections')


class CascadeRoIHead(nn.Module):
    def __init__(self, cfg: RoIHeadCfg, in_channels: int):
        super().__init__()
        self.cfg = cfg
        self.bbox_head = nn.ModuleList([
            Shared2FCBBoxHead(in_channels, cfg.num_classes,
                              cfg.fc_out_channels, cfg.roi_size)
            for _ in range(cfg.num_stages)])

    def forward_stage(self, stage: int, feats: Sequence[Tensor],
                      rois: Tensor) -> Tuple[Tensor, Tensor]:
        cfg = self.cfg
        if self.training:
            if cfg.pool_method != 'onehot':
                raise ValueError(f'training pools with the one-hot '
                                 f'formulation, not {cfg.pool_method!r}')
            pooled = multilevel_roi_align_onehot(
                feats, rois, cfg.featmap_strides, cfg.roi_size,
                cfg.sample_num, cfg.finest_scale, cfg.gather_bf16,
                cfg.max_grid)
        else:
            pooled = multilevel_roi_align(
                feats, rois.contiguous(), cfg.featmap_strides, cfg.roi_size,
                cfg.sample_num, cfg.finest_scale, cfg.max_grid)
        return self.bbox_head[stage](pooled)

    def decode_cascade(self, feats: Sequence[Tensor], proposals: Tensor,
                       proposal_valid: Tensor, img_hw: Tensor
                       ) -> Tuple[Tensor, Tensor]:
        """Cascade refine + decode without NMS.

        feats: 4 NHWC levels [B, H_l, W_l, C] (strides 4..32); proposals
        [B, R, 4]; proposal_valid [B, R]; img_hw [B, 2]. Returns boxes
        [B, R, 4] and stage-averaged softmax scores [B, R, C+1], zero on
        invalid proposals.
        """
        cfg = self.cfg
        rois = proposals
        ms_logits = []
        deltas = None
        for i in range(cfg.num_stages):
            logits, deltas = self.forward_stage(i, feats, rois)
            ms_logits.append(logits)
            if i < cfg.num_stages - 1:
                rois = delta2bbox(rois, deltas, stds=cfg.stage_stds[i],
                                  max_shape=img_hw)
        avg_logits = sum(ms_logits) / float(len(ms_logits))
        scores = torch.softmax(avg_logits, -1)
        boxes = delta2bbox(rois, deltas, stds=cfg.stage_stds[-1],
                           max_shape=img_hw)
        scores = torch.where(proposal_valid[..., None], scores,
                             torch.zeros_like(scores))
        return boxes, scores

    def simple_test(self, feats: Sequence[Tensor], proposals: Tensor,
                    proposal_valid: Tensor, img_hw: Tensor,
                    scale_factors: Tensor) -> Detections:
        """Batched cascade inference; boxes are divided by scale_factors
        [B, 4] back to the original image frame."""
        cfg = self.cfg
        boxes, scores = self.decode_cascade(feats, proposals,
                                            proposal_valid, img_hw)
        boxes = boxes / scale_factors[:, None, :].to(boxes.dtype)
        return Detections(*multiclass_nms(boxes, scores, cfg.score_thr,
                                          cfg.nms_iou, cfg.max_per_img))
