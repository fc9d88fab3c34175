"""Test-time augmentation by horizontal flip.

Counterpart of `hrfuser_tpu.models.detectors.tta` (`tta.py:39-163`). The
reference ships `MultiScaleFlipAug` + `aug_test`
(`pipelines/test_time_aug.py`, `two_stage.py:230-243`), though every
shipped config runs it with `flip=False`. Two fusers, each on the whole
batch at once (JAX `vmap`s the per-image part):

  * `predict_tta_flip`: detection level. `predict` on the original and
    the mirrored inputs, the second set of boxes mirrored back, then
    class-aware NMS over both.
  * `predict_aug_test_flip`: proposal level, as the reference's
    `merge_aug_proposals` + `CascadeRoIHead.aug_test` /
    `merge_aug_bboxes`: each view's RPN proposals mapped to the original
    frame, concatenated and NMS-merged at the RPN IoU (top
    `max_per_img`); the same merged proposals are cascade-decoded in
    both frames, the decoded boxes mapped back, boxes and scores
    averaged over the views, rescaled, and one multiclass NMS runs.

The flip mirrors the padded tensor, so the box mapping is exact when the
content width equals the padded width, as in every shipped config (640
and 1248 are multiples of 32).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from hrfuser_tpu_torch.models.detectors.cascade_rcnn import (
    CascadeRCNN, default_shapes, predict, rpn_proposals)
from hrfuser_tpu_torch.models.roi_heads.cascade_roi_head import Detections
from hrfuser_tpu_torch.ops.nms import NEG_INF, batched_nms, multiclass_nms, nms

Tensor = torch.Tensor


def _flip_boxes(boxes: Tensor, width: Tensor) -> Tensor:
    """Mirror [B, N, 4] boxes about images of `width` [B, 1] px
    (`bbox_flip`)."""
    return torch.stack([width - boxes[..., 2], boxes[..., 1],
                        width - boxes[..., 0], boxes[..., 3]], -1)


def _flipped(img: Tensor, mod_imgs: Optional[Sequence[Tensor]]):
    return (torch.flip(img, dims=[2]),
            [torch.flip(m, dims=[2]) for m in mod_imgs or []])


def _live(scores: Tensor, valid: Tensor) -> Tensor:
    return torch.where(valid, scores, torch.full_like(scores, NEG_INF))


def predict_tta_flip(model: CascadeRCNN, img: Tensor,
                     mod_imgs: Optional[Sequence[Tensor]] = None,
                     img_shapes: Optional[Tensor] = None,
                     scale_factors: Optional[Tensor] = None) -> Detections:
    """The original and the horizontally flipped pass, NMS-fused.
    Arguments and result as `predict`'s."""
    img_shapes, scale_factors = default_shapes(img, img_shapes,
                                               scale_factors)
    d1 = predict(model, img, mod_imgs, img_shapes, scale_factors)
    d2 = predict(model, *_flipped(img, mod_imgs), img_shapes, scale_factors)
    # the detections are rescaled, so mirror about the original width
    orig_w = (img_shapes[:, 1] / scale_factors[:, 0])[:, None]
    back = _flip_boxes(d2.boxes, orig_w) * d2.valid[..., None]
    cfg = model.cfg.roi
    return Detections(*batched_nms(
        torch.cat([d1.boxes, back], 1),
        torch.cat([_live(d1.scores, d1.valid), _live(d2.scores, d2.valid)],
                  1),
        torch.cat([d1.labels, d2.labels], 1), cfg.nms_iou, cfg.max_per_img))


def predict_aug_test_flip(model: CascadeRCNN, img: Tensor,
                          mod_imgs: Optional[Sequence[Tensor]] = None,
                          img_shapes: Optional[Tensor] = None,
                          scale_factors: Optional[Tensor] = None
                          ) -> Detections:
    """Flip TTA with the reference's merging: proposals merged across the
    two views, the cascade decoded on them in each view, boxes and scores
    averaged, one final multiclass NMS. Arguments and result as
    `predict`'s."""
    cfg = model.cfg
    img_shapes, scale_factors = default_shapes(img, img_shapes,
                                               scale_factors)
    width = img_shapes[:, 1:2]
    views = [model.forward_features(img, mod_imgs),
             model.forward_features(*_flipped(img, mod_imgs))]
    p1, p2 = (rpn_proposals(cfg, *v, img_shapes) for v in views)
    # merge_aug_proposals: map back, concatenate, NMS, top max_per_img
    boxes, _, valid = nms(
        torch.cat([p1.boxes, _flip_boxes(p2.boxes, width)], 1),
        torch.cat([_live(p1.scores, p1.valid), _live(p2.scores, p2.valid)],
                  1), cfg.rpn_test.nms_iou, cfg.rpn_test.max_per_img)
    decode = model.roi_head.decode_cascade
    boxes1, scores1 = decode(views[0][0][:4], boxes, valid, img_shapes)
    boxes2, scores2 = decode(views[1][0][:4],
                             _flip_boxes(boxes, width) * valid[..., None],
                             valid, img_shapes)
    # merge_aug_bboxes: mean over the views, rescale, multiclass NMS
    boxes = (boxes1 + _flip_boxes(boxes2, width)) * 0.5
    scores = (scores1 + scores2) * 0.5
    boxes = boxes / scale_factors[:, None, :].to(boxes.dtype)
    r = cfg.roi
    return Detections(*multiclass_nms(boxes, scores, r.score_thr, r.nms_iou,
                                      r.max_per_img))
