"""Training forward: RPN and 3-stage cascade losses.

Counterpart of `hrfuser_tpu.models.detectors.train_loss` (the reference
`TwoStageDetector.forward_train`, `mmdet/models/detectors/two_stage.py:
107-186`, `CascadeRoIHead.forward_train`, `cascade_roi_head.py:191-286`,
and `AnchorHead.loss`, `anchor_head.py:453-542`): targets are assigned
and sampled per image every step, the RPN's train proposals carry no
gradient, each stage refines its RoIs with detached deltas and drops the
gt RoIs before the next stage, and the loss names are the reference's.
Every random draw comes from `draws` (`core/samplers.Draws`).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from hrfuser_tpu_torch.core.losses import (accuracy_parts, sigmoid_bce,
                                           smooth_l1, softmax_ce)
from hrfuser_tpu_torch.core.samplers import Draws
from hrfuser_tpu_torch.core.targets import (RCNN_TRAIN_CFGS, AssignSampleCfg,
                                            rcnn_stage_targets_single,
                                            rpn_targets_single)
from hrfuser_tpu_torch.layers.common import train_generator
from hrfuser_tpu_torch.models.dense_heads.rpn_head import train_proposals
from hrfuser_tpu_torch.ops.boxes import delta2bbox
from hrfuser_tpu_torch.parallel.mesh import sum_over_ranks

Tensor = torch.Tensor


def _stack(per_image):
    return type(per_image[0])(*(torch.stack(t) for t in zip(*per_image)))


def _global_sums(group, *values: Tensor):
    """`values` summed over the ranks of `group`, in one collective that
    stays on the device."""
    return sum_over_ranks(torch.stack([v.float() for v in values]),
                          group).unbind()


def forward_train(model, batch: Dict, draws: Draws,
                  rpn_proposal_cfg: Optional[dict] = None,
                  rcnn_train_cfgs: Optional[Sequence[AssignSampleCfg]] = None,
                  group=None) -> Dict[str, Tensor]:
    """The losses of one batch, `model` in training mode.

    batch: `img` [B, H, W, 3]; `mod_imgs` per-modality [B, H, W, C_k]
    (none for a camera-only model); `gt_boxes` [B, G, 4], `gt_labels`
    [B, G], `gt_valid` [B, G]; optional `img_shapes` [B, 2] (h, w), the
    padded shape by default. Tensors on the model's device.
    `rpn_proposal_cfg` / `rcnn_train_cfgs` override the reference caps
    (2000 proposals, 512 sampled RoIs a stage).

    Returns `loss_rpn_cls`, `loss_rpn_bbox`, `s{i}.loss_cls`,
    `s{i}.loss_bbox`, `s{i}.acc` and their sum without the accuracies,
    `loss`.

    With a data-parallel `group` (`parallel.mesh.Group`) the batch is
    this rank's rows of the joined batch, rows [rank * B, (rank + 1) *
    B): the sampler keys are those of the joined batch's images, every
    loss divides by its factor summed over the ranks (then clamped at 1,
    as JAX clamps the joined batch's), so the ranks' losses sum to the
    joined batch's, and the accuracies are the joined batch's.
    """
    if not model.training:
        raise ValueError('forward_train needs the model in training mode '
                         '(model.train())')
    cfg = model.cfg
    img = batch['img']
    b, h, w, _ = img.shape
    dev = img.device
    img_shapes = batch.get('img_shapes')
    if img_shapes is None:
        img_shapes = torch.tensor([[h, w]], dtype=torch.float32,
                                  device=dev).expand(b, 2)
    gt_boxes, gt_labels = batch['gt_boxes'], batch['gt_labels']
    gt_valid = batch['gt_valid']
    first = 0 if group is None else group.rank * b

    with train_generator(draws.generator):
        feats, rpn_cls, rpn_reg = model.forward_features(
            img, batch.get('mod_imgs'))

    # ---- RPN targets and losses over the concatenated levels ----
    gen = cfg.anchor_generator()
    sizes = [tuple(f.shape[1:3]) for f in feats]
    anchors = [torch.from_numpy(a).to(dev) for a in gen.grid_anchors(sizes)]
    flags = torch.from_numpy(np.concatenate(gen.valid_flags(sizes, (h, w))))
    all_anchors, flags = torch.cat(anchors), flags.to(dev)
    cls_flat = torch.cat([c.reshape(b, -1) for c in rpn_cls], 1).float()
    reg_flat = torch.cat([r.reshape(b, -1, 4) for r in rpn_reg], 1).float()
    n = all_anchors.shape[0]
    rpn_t = _stack([rpn_targets_single(
        draws.uniforms('rpn', first + i, n, dev), all_anchors, flags, gt_boxes[i],
        gt_valid[i], img_shapes[i]) for i in range(b)])
    rpn_avg, = _global_sums(group, rpn_t.num_samples.sum())
    losses = {
        'loss_rpn_cls': sigmoid_bce(cls_flat, rpn_t.cls_targets,
                                    rpn_t.cls_weights, rpn_avg),
        'loss_rpn_bbox': smooth_l1(reg_flat, rpn_t.bbox_targets,
                                   rpn_t.bbox_weights, rpn_avg,
                                   beta=1.0 / 9.0),
    }

    # ---- cascade stages on the RPN's train proposals ----
    props = train_proposals(rpn_cls, rpn_reg, anchors, img_shapes,
                            rpn_proposal_cfg)
    proposals, prop_valid = props.boxes, props.valid
    roi = cfg.roi
    for i, s_cfg in enumerate((rcnn_train_cfgs or RCNN_TRAIN_CFGS)
                              [:roi.num_stages]):
        n = gt_boxes.shape[1] + proposals.shape[1]
        tgt = _stack([rcnn_stage_targets_single(
            draws.uniforms(i, first + j, n, dev), proposals[j], prop_valid[j],
            gt_boxes[j], gt_labels[j], gt_valid[j], roi.num_classes,
            roi.stage_stds[i], s_cfg) for j in range(b)])
        logits, deltas = model.roi_head.forward_stage(i, feats[:4], tgt.rois)
        flat_logits = logits.reshape(-1, logits.shape[-1])
        flat_labels = tgt.labels.reshape(-1)
        flat_lw = tgt.label_weights.reshape(-1)
        wgt = roi.stage_loss_weights[i]
        cls_avg, bbox_avg, acc_num, acc_den = _global_sums(
            group, (flat_lw > 0).sum(), tgt.valid.sum(),
            *accuracy_parts(flat_logits.detach(), flat_labels, flat_lw))
        losses[f's{i}.loss_cls'] = wgt * softmax_ce(
            flat_logits, flat_labels, flat_lw, cls_avg)
        losses[f's{i}.loss_bbox'] = wgt * smooth_l1(
            deltas.reshape(-1, 4), tgt.bbox_targets.reshape(-1, 4),
            tgt.bbox_weights.reshape(-1, 4), bbox_avg, beta=1.0)
        losses[f's{i}.acc'] = acc_num / acc_den.clamp(min=1.0)
        if i < roi.num_stages - 1:
            proposals = delta2bbox(tgt.rois, deltas.detach(),
                                   stds=roi.stage_stds[i],
                                   max_shape=img_shapes)
            prop_valid = tgt.valid & ~tgt.is_gt
    losses['loss'] = sum(v for k, v in losses.items()
                         if not k.endswith('acc'))
    return losses
