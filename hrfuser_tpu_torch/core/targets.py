"""Training targets of the RPN and of each cascade RCNN stage.

Counterpart of `hrfuser_tpu.core.targets` (the reference
`AnchorHead.get_targets`, `mmdet/models/dense_heads/anchor_head.py:
299-452`, and `BBoxHead.get_targets`): assign, sample, encode, over
fixed-size tensors with weight masks. Each function takes one image.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from hrfuser_tpu_torch.core.assigners import max_iou_assign
from hrfuser_tpu_torch.core.samplers import random_sample, select_fixed
from hrfuser_tpu_torch.ops.boxes import bbox2delta

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AssignSampleCfg:
    pos_iou_thr: float
    neg_iou_thr: float
    min_pos_iou: float
    match_low_quality: bool
    num: int
    pos_fraction: float
    add_gt_as_proposals: bool


RPN_TRAIN_CFG = AssignSampleCfg(0.7, 0.3, 0.3, True, 256, 0.5, False)
RCNN_TRAIN_CFGS = (
    AssignSampleCfg(0.5, 0.5, 0.5, False, 512, 0.25, True),
    AssignSampleCfg(0.6, 0.6, 0.6, False, 512, 0.25, True),
    AssignSampleCfg(0.7, 0.7, 0.7, False, 512, 0.25, True),
)


class RPNTargets(NamedTuple):
    cls_targets: Tensor    # [N] float (1 = object)
    cls_weights: Tensor    # [N]
    bbox_targets: Tensor   # [N, 4]
    bbox_weights: Tensor   # [N, 4]
    num_samples: Tensor    # scalar (pos + neg), the loss avg factor share


def rpn_targets_single(uniforms, anchors: Tensor, valid_flags: Tensor,
                       gt_boxes: Tensor, gt_valid: Tensor, img_hw: Tensor,
                       allowed_border: float = 0.0,
                       cfg: AssignSampleCfg = RPN_TRAIN_CFG) -> RPNTargets:
    """Anchor targets of one image. `allowed_border=0` (HRFuser's train
    cfg) keeps only anchors wholly inside the (h, w) `img_hw`
    (`anchor_inside_flags`, `anchor_head.py:171`)."""
    h, w = img_hw[0], img_hw[1]
    inside = (valid_flags & (anchors[:, 0] >= -allowed_border)
              & (anchors[:, 1] >= -allowed_border)
              & (anchors[:, 2] <= w + allowed_border)
              & (anchors[:, 3] <= h + allowed_border))
    labels = torch.zeros(gt_boxes.shape[:1], dtype=torch.int32,
                         device=gt_boxes.device)
    assign = max_iou_assign(gt_boxes, labels, gt_valid, anchors, inside,
                            cfg.pos_iou_thr, cfg.neg_iou_thr,
                            cfg.min_pos_iou, cfg.match_low_quality)
    sample = random_sample(uniforms, assign.gt_inds > 0, assign.gt_inds == 0,
                           cfg.num, cfg.pos_fraction)
    pos = sample.pos_mask
    safe = (assign.gt_inds.long() - 1).clamp(0, gt_boxes.shape[0] - 1)
    deltas = bbox2delta(anchors, gt_boxes[safe])
    return RPNTargets(
        (assign.gt_inds > 0).float(), (pos | sample.neg_mask).float(),
        torch.where(pos[:, None], deltas, torch.zeros_like(deltas)),
        pos.float()[:, None].expand(-1, 4),
        (sample.num_pos + sample.num_neg).float())


class RCNNStageTargets(NamedTuple):
    rois: Tensor           # [S, 4] sampled boxes
    labels: Tensor         # [S] int32 (num_classes = background)
    label_weights: Tensor  # [S]
    bbox_targets: Tensor   # [S, 4]
    bbox_weights: Tensor   # [S, 4]
    is_gt: Tensor          # [S] bool, the roi is a prepended gt box
    valid: Tensor          # [S] bool
    num_pos: Tensor


def rcnn_stage_targets_single(uniforms, proposals: Tensor,
                              prop_valid: Tensor, gt_boxes: Tensor,
                              gt_labels: Tensor, gt_valid: Tensor,
                              num_classes: int, stds: Tuple[float, ...],
                              cfg: AssignSampleCfg) -> RCNNStageTargets:
    """Assign, sample and encode one cascade stage of one image. With
    `add_gt_as_proposals` the candidates are `[gt_boxes; proposals]`, the
    gts assigned to themselves (`BaseSampler.sample`, gts prepended)."""
    g = gt_boxes.shape[0]
    assign = max_iou_assign(gt_boxes, gt_labels, gt_valid, proposals,
                            prop_valid, cfg.pos_iou_thr, cfg.neg_iou_thr,
                            cfg.min_pos_iou, cfg.match_low_quality)
    if cfg.add_gt_as_proposals:
        cand = torch.cat([gt_boxes, proposals])
        ids = torch.arange(1, g + 1, dtype=torch.int32,
                           device=gt_boxes.device)
        gt_inds = torch.cat([torch.where(gt_valid, ids, -ids.new_ones(g)),
                             assign.gt_inds])
        is_gt_row = torch.cat([gt_valid, torch.zeros_like(prop_valid)])
    else:
        cand, gt_inds = proposals, assign.gt_inds
        is_gt_row = torch.zeros_like(prop_valid)

    sample = random_sample(uniforms, gt_inds > 0, gt_inds == 0, cfg.num,
                           cfg.pos_fraction)
    idx, is_pos, valid = select_fixed(sample, cfg.num)
    idx = idx.long()
    rois = cand[idx]
    safe = (gt_inds[idx].long() - 1).clamp(0, g - 1)
    labels = torch.where(is_pos, gt_labels[safe].int(),
                         torch.full_like(idx, num_classes, dtype=torch.int32))
    deltas = bbox2delta(rois, gt_boxes[safe], stds=stds)
    return RCNNStageTargets(
        rois, labels, valid.float(),
        torch.where(is_pos[:, None], deltas, torch.zeros_like(deltas)),
        is_pos.float()[:, None].expand(-1, 4), is_gt_row[idx] & valid,
        valid, sample.num_pos.float())
