"""Cascade R-CNN detector: HRFuser backbone + HRFPN + RPN + cascade head.

Counterpart of `hrfuser_tpu.models.detectors.cascade_rcnn` (the reference
`two_stage.py` / `cascade_rcnn.py`). `predict` takes NHWC images as the
JAX `predict` does (`cascade_rcnn.py:137-182`), with the batch dimension
written out where the JAX version `vmap`s the per-image RPN decode and
RoI path. The activations' dtype (float32 or bfloat16) is the input
images' dtype.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
from torch import nn

from hrfuser_tpu_torch.models.backbones.hr_config import HRBackboneCfg
from hrfuser_tpu_torch.models.backbones.hrfuser import HRFuserBackbone
from hrfuser_tpu_torch.models.dense_heads.rpn_head import (RPNHead,
                                                           get_proposals)
from hrfuser_tpu_torch.models.necks.hrfpn import HRFPN
from hrfuser_tpu_torch.models.roi_heads.cascade_roi_head import (
    CascadeRoIHead, Detections, RoIHeadCfg)
from hrfuser_tpu_torch.ops.anchors import AnchorGenerator

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class RPNTestCfg:
    nms_pre: int = 1000
    max_per_img: int = 1000
    nms_iou: float = 0.7
    min_bbox_size: float = 0.0


@dataclasses.dataclass(frozen=True)
class DetectorCfg:
    backbone: HRBackboneCfg
    roi: RoIHeadCfg
    rpn_test: RPNTestCfg = RPNTestCfg()
    neck_out_channels: int = 256
    anchor_strides: Tuple[int, ...] = (4, 8, 16, 32, 64)
    anchor_scales: Tuple[float, ...] = (8,)
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)

    def anchor_generator(self) -> AnchorGenerator:
        return AnchorGenerator(strides=self.anchor_strides,
                               ratios=self.anchor_ratios,
                               scales=self.anchor_scales)


class CascadeRCNN(nn.Module):
    def __init__(self, cfg: DetectorCfg):
        super().__init__()
        self.cfg = cfg
        self.backbone = HRFuserBackbone(cfg.backbone)
        self.neck = HRFPN(sum(cfg.backbone.out_channels),
                          cfg.neck_out_channels)
        self.rpn_head = RPNHead(cfg.neck_out_channels,
                                len(cfg.anchor_ratios)
                                * len(cfg.anchor_scales))
        self.roi_head = CascadeRoIHead(cfg.roi, cfg.neck_out_channels)

    def forward_features(self, img: Tensor, mod_imgs: List[Tensor]):
        """Backbone + neck + RPN maps, all NHWC: 5 pyramid levels
        [B, H_l, W_l, C], cls logits [B, H_l, W_l, A] and deltas
        [B, H_l, W_l, 4A]."""
        feats = self.neck(self.backbone(img, list(mod_imgs)))
        cls_scores, bbox_preds = self.rpn_head(feats)
        return feats, cls_scores, bbox_preds


def predict(model: CascadeRCNN, img: Tensor, mod_imgs: List[Tensor],
            img_shapes: Optional[Tensor] = None,
            scale_factors: Optional[Tensor] = None) -> Detections:
    """Batched end-to-end inference.

    Args:
        img: [B, H, W, 3] (padded to /32).
        mod_imgs: per-modality [B, H, W, C_k].
        img_shapes: [B, 2] (h, w) unpadded shapes for box clipping;
            defaults to the padded shape.
        scale_factors: [B, 4] resize factors for rescaling to the
            original image; defaults to 1.

    Returns:
        `Detections` with a leading batch axis.
    """
    b, h, w, _ = img.shape
    dev = img.device
    if img_shapes is None:
        img_shapes = torch.tensor([[h, w]], dtype=torch.float32,
                                  device=dev).expand(b, 2)
    if scale_factors is None:
        scale_factors = torch.ones((b, 4), dtype=torch.float32, device=dev)
    cfg = model.cfg
    feats, cls_scores, bbox_preds = model.forward_features(img, mod_imgs)
    anchors = [torch.from_numpy(a).to(dev) for a in
               cfg.anchor_generator().grid_anchors(
                   [tuple(f.shape[1:3]) for f in feats])]
    r = cfg.rpn_test
    props = get_proposals(cls_scores, bbox_preds, anchors, img_shapes,
                          r.nms_pre, r.max_per_img, r.nms_iou,
                          r.min_bbox_size)
    return model.roi_head.simple_test(feats[:4], props.boxes, props.valid,
                                      img_shapes, scale_factors)
