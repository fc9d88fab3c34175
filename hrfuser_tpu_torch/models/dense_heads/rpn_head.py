"""RPN head and batched fixed-size proposal decode.

Counterpart of `hrfuser_tpu.models.dense_heads.rpn_head` (the reference
`mmdet/models/dense_heads/rpn_head.py:33-68,103-235`): a shared 3x3 conv
+ ReLU, then 1x1 sigmoid-cls and 1x1 delta-reg per level. Proposals:
per-level top `nms_pre` by sigmoid score (stable descending sort, so ties
resolve to the lower index as `jax.lax.top_k` does), delta decode clipped
to the image, the `min_bbox_size` filter, level-batched NMS, top
`max_per_img`. Every image of the batch is decoded at once. Training
decodes its proposals the same way, without gradient, under the train
caps `RPN_PROPOSAL_TRAIN` (`hrfuser_tpu/models/detectors/train_loss.py:
33-34`).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from hrfuser_tpu_torch.layers.common import conv_bn
from hrfuser_tpu_torch.ops.boxes import delta2bbox
from hrfuser_tpu_torch.ops.nms import NEG_INF, batched_nms, sort_desc

Tensor = torch.Tensor

# the RPN's proposal cfg in training (`train_cfg.rpn_proposal`)
RPN_PROPOSAL_TRAIN = dict(nms_pre=2000, max_per_img=2000, nms_iou=0.7,
                          min_bbox_size=0.0)


class RPNHead(nn.Module):
    """Per-level conv tower; weights shared across levels."""

    def __init__(self, feat_channels: int = 256, num_anchors: int = 3):
        super().__init__()
        self.rpn_conv = nn.Conv2d(feat_channels, feat_channels, 3, padding=1)
        self.rpn_cls = nn.Conv2d(feat_channels, num_anchors, 1)
        self.rpn_reg = nn.Conv2d(feat_channels, num_anchors * 4, 1)

    def forward(self, feats: List[Tensor]) -> Tuple[List[Tensor],
                                                     List[Tensor]]:
        cls_scores, bbox_preds = [], []
        for f in feats:
            h = F.relu(conv_bn(f, self.rpn_conv))
            cls_scores.append(conv_bn(h, self.rpn_cls))
            bbox_preds.append(conv_bn(h, self.rpn_reg))
        return cls_scores, bbox_preds


class Proposals(NamedTuple):
    boxes: Tensor       # [B, max_per_img, 4]
    scores: Tensor      # [B, max_per_img]
    valid: Tensor       # [B, max_per_img] bool


def get_proposals(cls_scores: Sequence[Tensor], bbox_preds: Sequence[Tensor],
                  anchors: Sequence[Tensor], img_hw: Tensor,
                  nms_pre: int = 1000, max_per_img: int = 1000,
                  nms_iou: float = 0.7, min_bbox_size: float = 0.0
                  ) -> Proposals:
    """Batched proposal decode.

    Args:
        cls_scores: per level [B, H, W, A] logits.
        bbox_preds: per level [B, H, W, A*4].
        anchors: per level [H*W*A, 4].
        img_hw: [B, 2] (h, w) unpadded image shapes for clipping.
    """
    lvl_scores, lvl_deltas, lvl_anchors, lvl_ids = [], [], [], []
    for lvl, (score, delta, anc) in enumerate(
            zip(cls_scores, bbox_preds, anchors)):
        b = score.shape[0]
        s = torch.sigmoid(score.reshape(b, -1).float())
        d = delta.reshape(b, -1, 4).float()
        k = min(nms_pre, s.shape[1])
        top_s, top_i = sort_desc(s)
        top_s, top_i = top_s[:, :k], top_i[:, :k]
        lvl_scores.append(top_s)
        lvl_deltas.append(
            torch.gather(d, 1, top_i[..., None].expand(-1, -1, 4)))
        lvl_anchors.append(anc[top_i])
        lvl_ids.append(torch.full_like(top_i, lvl))
    scores = torch.cat(lvl_scores, 1)
    proposals = delta2bbox(torch.cat(lvl_anchors, 1),
                           torch.cat(lvl_deltas, 1), max_shape=img_hw)
    w = proposals[..., 2] - proposals[..., 0]
    h = proposals[..., 3] - proposals[..., 1]
    ok = (w > min_bbox_size) & (h > min_bbox_size)
    scores = torch.where(ok, scores, torch.full_like(scores, NEG_INF))
    boxes, out_scores, _, valid = batched_nms(
        proposals, scores, torch.cat(lvl_ids, 1), nms_iou, max_per_img)
    return Proposals(boxes, out_scores, valid)


def train_proposals(cls_scores: Sequence[Tensor], bbox_preds: Sequence[Tensor],
                    anchors: Sequence[Tensor], img_hw: Tensor,
                    cfg: Optional[dict] = None) -> Proposals:
    """Proposals of a training step (no gradient flows into the cascade),
    `RPN_PROPOSAL_TRAIN` unless `cfg` overrides it."""
    with torch.no_grad():
        return get_proposals([c.detach() for c in cls_scores],
                             [p.detach() for p in bbox_preds], anchors,
                             img_hw, **(cfg or RPN_PROPOSAL_TRAIN))
