"""Fixed-size greedy NMS in plain torch.

Counterpart of `hrfuser_tpu.ops.nms`: candidates are ordered by a stable
descending sort (score ties keep index order, as `jnp.argsort(-s)` and
`jax.lax.top_k` do), then resolved in blocks of `BLOCK` candidates, as
in the JAX version. Each block is first suppressed by the boxes kept in
earlier blocks, then settled by iterating the in-block suppression map
to its fixed point, which equals the sequential greedy result. The block
loop stops once every image has `max_out` survivors: later candidates
rank below all of them.

Every function takes a leading batch dim [B, N, ...] (or none) and returns
fixed-size outputs with a `valid` mask. Padded candidates carry a score
of `NEG_INF`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from hrfuser_tpu_torch.ops.boxes import bbox_overlaps

Tensor = torch.Tensor

NEG_INF = -1e10
BLOCK = 256             # candidates resolved per step of the block loop
PRE_NMS_CAP = 2000      # multiclass candidates entering NMS (top scores)


def sort_desc(scores: Tensor) -> Tuple[Tensor, Tensor]:
    """Stable descending sort along the last dim (ties: lower index first)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True)


@torch.library.custom_op('hrfuser::greedy_keep', mutates_args=())
def greedy_keep(sboxes: Tensor, valid: Tensor, iou_threshold: float,
                max_out: int) -> Tensor:
    """Greedy keep mask over score-sorted boxes [B, N, 4], valid [B, N].

    A registered op on every device: its block loop syncs with the host
    (it stops at a fixed point and once `max_out` survive), so a tracer
    records the op and steps over the loop."""
    b, n = valid.shape
    keep = valid.clone()
    idx = torch.arange(BLOCK, device=valid.device)
    tri = idx[:, None] < idx[None, :]
    kept = torch.zeros(b, dtype=torch.long, device=valid.device)
    for start in range(0, n, BLOCK):
        stop = min(start + BLOCK, n)
        blk = sboxes[:, start:stop]
        blk_keep = keep[:, start:stop]
        if start:
            iou = bbox_overlaps(blk, sboxes[:, :start])     # [B, k, start]
            sup = ((iou > iou_threshold) & keep[:, None, :start]).any(-1)
            blk_keep = blk_keep & ~sup
        k = stop - start
        m = (bbox_overlaps(blk, blk) > iou_threshold) & tri[:k, :k]
        keep0 = blk_keep
        cur = keep0 & ~(m & keep0[:, :, None]).any(1)
        for _ in range(k):
            nxt = keep0 & ~(m & cur[:, :, None]).any(1)
            if torch.equal(nxt, cur):
                break
            cur = nxt
        keep[:, start:stop] = cur
        kept += cur.sum(-1)
        if bool((kept >= max_out).all()):
            break
    return keep


@greedy_keep.register_fake
def _greedy_keep_fake(sboxes, valid, iou_threshold, max_out):
    return torch.empty_like(valid, memory_format=torch.contiguous_format)


def _select(keep: Tensor, sscores: Tensor, max_out: int):
    """First `max_out` kept candidates in sorted order, padded."""
    b, n = keep.shape
    kept_scores = torch.where(keep, sscores, torch.full_like(sscores, NEG_INF))
    if n < max_out:
        kept_scores = torch.cat([kept_scores, kept_scores.new_full(
            (b, max_out - n), NEG_INF)], 1)
    top_scores, top_idx = sort_desc(kept_scores)
    top_scores, top_idx = top_scores[:, :max_out], top_idx[:, :max_out]
    out_valid = top_scores > NEG_INF / 2
    return top_idx.clamp(max=n - 1), top_scores, out_valid


def batched_nms(boxes: Tensor, scores: Tensor, idxs: Tensor,
                iou_threshold: float, max_out: int
                ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Class/level-aware NMS via the coordinate-offset trick.

    Boxes of different `idxs` never suppress each other. Returns (boxes,
    scores, idxs, valid), each [..., max_out(, 4)]; padding is zero boxes,
    score 0 and idx -1.
    """
    unbatched = boxes.dim() == 2
    if unbatched:
        boxes, scores, idxs = boxes[None], scores[None], idxs[None]
    live = scores > NEG_INF / 2
    max_coord = torch.where(live, boxes.max(-1).values,
                            torch.zeros_like(scores)).max(-1).values
    shifted = boxes + (idxs.to(boxes.dtype)
                       * (max_coord[:, None] + 1.0))[..., None]
    sscores, order = sort_desc(scores)
    sboxes = torch.gather(shifted, 1, order[..., None].expand(-1, -1, 4))
    keep = greedy_keep(sboxes.detach(), sscores > NEG_INF / 2,
                       iou_threshold, max_out)
    top_idx, top_scores, valid = _select(keep, sscores, max_out)
    src = torch.gather(order, 1, top_idx)
    out_boxes = torch.gather(boxes, 1, src[..., None].expand(-1, -1, 4))
    out_boxes = out_boxes * valid[..., None]
    out_scores = torch.where(valid, top_scores, torch.zeros_like(top_scores))
    out_idxs = torch.where(valid, torch.gather(idxs, 1, src),
                           torch.full_like(src, -1)).to(idxs.dtype)
    out = (out_boxes, out_scores, out_idxs, valid)
    return tuple(t[0] for t in out) if unbatched else out


def nms(boxes: Tensor, scores: Tensor, iou_threshold: float, max_out: int
        ) -> Tuple[Tensor, Tensor, Tensor]:
    """Single-class greedy NMS: (boxes, scores, valid), [..., max_out]."""
    zeros = torch.zeros(scores.shape, dtype=torch.long, device=scores.device)
    out_boxes, out_scores, _, valid = batched_nms(
        boxes, scores, zeros, iou_threshold, max_out)
    return out_boxes, out_scores, valid


def multiclass_nms(boxes: Tensor, scores: Tensor, score_thr: float,
                   iou_threshold: float, max_per_img: int
                   ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Multi-class NMS (`mmdet/core/post_processing/bbox_nms.py:8-96`).

    boxes: [..., N, 4] class-agnostic; scores: [..., N, C+1] softmax
    scores with background last. The top `PRE_NMS_CAP` candidates above
    `score_thr` enter NMS, as in the JAX version. Returns (boxes, scores,
    labels int32 (-1 padding), valid), each [..., max_per_img(, 4)].
    """
    unbatched = boxes.dim() == 2
    if unbatched:
        boxes, scores = boxes[None], scores[None]
    b, n, _ = boxes.shape
    num_classes = scores.shape[-1] - 1
    cand_boxes = boxes[:, :, None, :].expand(b, n, num_classes, 4)
    cand_boxes = cand_boxes.reshape(b, -1, 4)
    cand_scores = scores[..., :num_classes].reshape(b, -1)
    cand_labels = torch.arange(num_classes, dtype=torch.int32,
                               device=boxes.device).repeat(n)
    cand_labels = cand_labels[None].expand(b, -1)
    cand_scores = torch.where(cand_scores > score_thr, cand_scores,
                              torch.full_like(cand_scores, NEG_INF))
    if PRE_NMS_CAP < cand_scores.shape[1]:
        cand_scores, top = sort_desc(cand_scores)
        cand_scores, top = cand_scores[:, :PRE_NMS_CAP], top[:, :PRE_NMS_CAP]
        cand_boxes = torch.gather(cand_boxes, 1,
                                  top[..., None].expand(-1, -1, 4))
        cand_labels = torch.gather(cand_labels, 1, top)
    out = batched_nms(cand_boxes, cand_scores, cand_labels, iou_threshold,
                      max_per_img)
    return tuple(t[0] for t in out) if unbatched else out
