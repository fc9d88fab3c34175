"""Max-IoU assigner over padded gt and box sets.

Counterpart of `hrfuser_tpu.core.assigners` (the reference
`MaxIoUAssigner`, `mmdet/core/bbox/assigners/max_iou_assigner.py:11-213`).
Encoding as in the reference: -1 ignore, 0 negative, k > 0 assigned to
gt k-1. One image at a time.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hrfuser_tpu_torch.ops.boxes import bbox_overlaps

Tensor = torch.Tensor


class AssignResult(NamedTuple):
    gt_inds: Tensor       # [N] int32 (-1 ignore / 0 neg / k>0 -> gt k-1)
    max_overlaps: Tensor  # [N]
    labels: Tensor        # [N] int32 assigned gt label, -1 if none


def max_iou_assign(gt_boxes: Tensor, gt_labels: Tensor, gt_valid: Tensor,
                   boxes: Tensor, box_valid: Tensor, pos_iou_thr: float,
                   neg_iou_thr: float, min_pos_iou: float,
                   match_low_quality: bool) -> AssignResult:
    """Assign each of N boxes to a gt, negative or ignore.

    gt_boxes [G, 4] with gt_valid [G]; boxes [N, 4] with box_valid [N].
    A box is negative when its best overlap is below `neg_iou_thr`,
    positive to its argmax gt at `pos_iou_thr` or above; with
    `match_low_quality` each gt whose row maximum reaches `min_pos_iou`
    claims every box at that maximum, later gts overriding earlier ones.
    When every gt slot is padding, every valid box is negative
    (`max_iou_assigner.py:128-140`).
    """
    ious = bbox_overlaps(gt_boxes, boxes)                # [G, N]
    ious = torch.where(gt_valid[:, None] & box_valid[None, :], ious,
                       torch.full_like(ious, -1.0))
    raw_max = ious.max(0).values                         # [N] (-1: no gt)
    argmax_gt = ious.argmax(0)                           # first maximum
    max_ov = raw_max.clamp(min=0.0)

    gt_inds = torch.full(boxes.shape[:1], -1, dtype=torch.int32,
                         device=boxes.device)
    gt_inds = torch.where(max_ov < neg_iou_thr, torch.zeros_like(gt_inds),
                          gt_inds)
    gt_inds = torch.where((raw_max >= pos_iou_thr) & (raw_max >= 0),
                          argmax_gt.int() + 1, gt_inds)

    if match_low_quality:
        gt_max = ious.max(1).values                      # [G]
        claim = ((ious == gt_max[:, None]) & (gt_max[:, None] >= min_pos_iou)
                 & gt_valid[:, None])
        ids = torch.arange(1, ious.shape[0] + 1, dtype=torch.int32,
                           device=boxes.device)[:, None]
        claimed_by = torch.where(claim, ids, torch.zeros_like(ids)).max(0)
        gt_inds = torch.where(claimed_by.values > 0, claimed_by.values,
                              gt_inds)

    gt_inds = torch.where(box_valid, gt_inds, torch.full_like(gt_inds, -1))
    safe = (gt_inds.long() - 1).clamp(0, gt_boxes.shape[0] - 1)
    labels = torch.where(gt_inds > 0, gt_labels[safe].int(),
                         torch.full_like(gt_inds, -1))
    return AssignResult(gt_inds, max_ov, labels)
