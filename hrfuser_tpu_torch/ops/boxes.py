"""Box math: IoU, delta coding, clipping, flips, areas and scaling.

Torch counterpart of `hrfuser_tpu.ops.boxes` (the reference
`mmdet/core/bbox/coder/delta_xywh_bbox_coder.py:118-260` and
`iou2d_calculator.py`). Boxes are `[x1, y1, x2, y2]` float32; padded
slots are zero boxes. Every function takes any leading batch dims.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

Tensor = torch.Tensor


def bbox_overlaps(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """Pairwise IoU: [..., N, 4] x [..., M, 4] -> [..., N, M]."""
    area1 = ((boxes1[..., 2] - boxes1[..., 0])
             * (boxes1[..., 3] - boxes1[..., 1]))
    area2 = ((boxes2[..., 2] - boxes2[..., 0])
             * (boxes2[..., 3] - boxes2[..., 1]))
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / union.clamp(min=1e-6)


def clip_boxes(boxes: Tensor, img_hw: Tensor) -> Tensor:
    """Clip [..., N, 4] boxes to [0, w] x [0, h]; img_hw is [..., 2]."""
    h = img_hw[..., 0:1].to(boxes.dtype)
    w = img_hw[..., 1:2].to(boxes.dtype)
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([torch.minimum(x1.clamp(min=0), w),
                        torch.minimum(y1.clamp(min=0), h),
                        torch.minimum(x2.clamp(min=0), w),
                        torch.minimum(y2.clamp(min=0), h)], dim=-1)


def bbox2delta(proposals: Tensor, gt: Tensor,
               means: Sequence[float] = (0., 0., 0., 0.),
               stds: Sequence[float] = (1., 1., 1., 1.)) -> Tensor:
    """Encode gt boxes as (dx, dy, dw, dh) deltas of [..., N, 4] proposals
    (`hrfuser_tpu/ops/boxes.py:51-81`): centres and sizes without the
    legacy +1, zero-size proposals and gts guarded at 1e-6."""
    pxy = (proposals[..., :2] + proposals[..., 2:]) * 0.5
    pwh = (proposals[..., 2:] - proposals[..., :2]).clamp(min=1e-6)
    gxy = (gt[..., :2] + gt[..., 2:]) * 0.5
    gwh = (gt[..., 2:] - gt[..., :2]).clamp(min=1e-6)
    deltas = torch.cat([(gxy - pxy) / pwh, torch.log(gwh / pwh)], dim=-1)
    means = torch.tensor(means, dtype=deltas.dtype, device=deltas.device)
    stds = torch.tensor(stds, dtype=deltas.dtype, device=deltas.device)
    return (deltas - means) / stds


def delta2bbox(rois: Tensor, deltas: Tensor,
               stds: Sequence[float] = (1., 1., 1., 1.),
               max_shape: Tensor = None) -> Tensor:
    """Decode (dx, dy, dw, dh) deltas on [..., N, 4] rois.

    dw/dh are clamped to |log(16 / 1000)| as in the reference.
    `max_shape` is an [..., 2] (h, w) tensor with the rois' leading dims,
    or None for no clipping.
    """
    denorm = deltas * torch.tensor(stds, dtype=deltas.dtype,
                                   device=deltas.device)
    dxy = denorm[..., :2]
    max_ratio = abs(math.log(16 / 1000))
    dwh = denorm[..., 2:].clamp(-max_ratio, max_ratio)
    pxy = (rois[..., :2] + rois[..., 2:]) * 0.5
    pwh = rois[..., 2:] - rois[..., :2]
    gxy = pxy + pwh * dxy
    gwh = pwh * torch.exp(dwh)
    boxes = torch.cat([gxy - gwh * 0.5, gxy + gwh * 0.5], dim=-1)
    if max_shape is not None:
        boxes = clip_boxes(boxes, max_shape)
    return boxes


def bbox_flip(boxes: Tensor, img_shape: Tuple[int, int],
              direction: str = 'horizontal') -> Tensor:
    """Flip boxes inside an (h, w) image (`transforms.py` bbox_flip)."""
    h, w = img_shape
    x1, y1, x2, y2 = boxes.unbind(-1)
    if direction == 'horizontal':
        return torch.stack([w - x2, y1, w - x1, y2], -1)
    if direction == 'vertical':
        return torch.stack([x1, h - y2, x2, h - y1], -1)
    raise ValueError(direction)


def bbox_area(boxes: Tensor) -> Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def bbox_center_size(boxes: Tensor) -> Tuple[Tensor, Tensor]:
    """(centres [..., 2], sizes [..., 2])."""
    return ((boxes[..., :2] + boxes[..., 2:]) * 0.5,
            boxes[..., 2:] - boxes[..., :2])


def scale_boxes(boxes: Tensor, scale_factor) -> Tensor:
    """Multiply box coordinates by [sx, sy, sx, sy] (rescale to the
    original image)."""
    return boxes * torch.as_tensor(scale_factor, dtype=boxes.dtype,
                                   device=boxes.device)
