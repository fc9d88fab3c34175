"""Proposal recall (AR@N) evaluation.

Rebuild of `eval_recalls` / `CocoDataset.fast_eval_recall`
(`mmdet/core/evaluation/recall.py:12-120`, `mmdet/datasets/coco.py:331-351`):
average recall of class-agnostic proposals against per-image ground truth,
reported per (proposal budget, IoU threshold).

Matching follows the reference exactly: per image, greedily pair the
(gt, proposal) with the globally best IoU among the top-N score-ranked
proposals, remove both, repeat — each gt keeps the IoU of its match.
Recall@thr = fraction of gts whose matched IoU >= thr.

Pure numpy, runs host-side on eval results (proposals are tiny).

A verbatim copy of `hrfuser_tpu/evaluation/recall.py`: the port imports
nothing of the JAX package. `tests/test_torch_evaluation.py` holds the two
equal.
"""

from __future__ import annotations

from typing import Dict, Sequence, Union

import numpy as np


def _iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU, [len(a), len(b)] (x1 y1 x2 y2, exclusive widths)."""
    area_a = np.maximum(a[:, 2] - a[:, 0], 0) * np.maximum(
        a[:, 3] - a[:, 1], 0)
    area_b = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(
        b[:, 3] - b[:, 1], 0)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    wh = np.maximum(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def _greedy_gt_ious(gts: np.ndarray, proposals: np.ndarray) -> np.ndarray:
    """IoU each gt gets under greedy best-first matching ([G] array).

    Mirrors the inner loop of `_recalls` (`recall.py:18-33`): repeatedly
    take the gt whose best remaining proposal IoU is globally largest,
    consume that proposal, and continue. Unmatched gts keep 0.
    """
    g = len(gts)
    out = np.zeros(g, np.float32)
    if g == 0 or len(proposals) == 0:
        return out
    ious = _iou_np(gts, proposals).astype(np.float32)
    for _ in range(g):
        row_best = ious.argmax(axis=1)
        row_max = ious[np.arange(g), row_best]
        gi = row_max.argmax()
        if row_max[gi] < 0:      # every gt or proposal consumed
            break
        out[gi] = row_max[gi]
        ious[gi, :] = -1
        ious[:, row_best[gi]] = -1
    return out


def eval_recalls(gts: Sequence[np.ndarray],
                 proposals: Sequence[np.ndarray],
                 proposal_nums: Union[int, Sequence[int]] = (100, 300, 1000),
                 iou_thrs: Union[float, Sequence[float]] = 0.5
                 ) -> np.ndarray:
    """Recall table [len(proposal_nums), len(iou_thrs)].

    Args:
        gts: per image [G, 4] gt boxes (x1 y1 x2 y2).
        proposals: per image [P, 4] or [P, 5] (5th column = score; when
            present, proposals are re-ranked by it before truncation,
            matching `eval_recalls` `recall.py:94-108`).
    """
    if isinstance(proposal_nums, int):
        proposal_nums = [proposal_nums]
    if isinstance(iou_thrs, float):
        iou_thrs = [iou_thrs]
    proposal_nums = np.asarray(list(proposal_nums), np.int64)
    iou_thrs = np.asarray(list(iou_thrs), np.float64)

    assert len(gts) == len(proposals)
    ranked = []
    for p in proposals:
        p = np.asarray(p, np.float32).reshape(-1, p.shape[-1] if p.ndim > 1
                                              else 5)
        if p.shape[-1] == 5:
            p = p[np.argsort(-p[:, 4], kind='stable')][:, :4]
        ranked.append(p)

    total_gt = int(sum(len(g) for g in gts))
    recalls = np.zeros((len(proposal_nums), len(iou_thrs)), np.float64)
    if total_gt == 0:
        return recalls

    for k, pn in enumerate(proposal_nums):
        matched = [_greedy_gt_ious(np.asarray(g, np.float32), p[:pn])
                   for g, p in zip(gts, ranked)]
        all_ious = np.concatenate(matched) if matched else np.zeros(0)
        for i, thr in enumerate(iou_thrs):
            recalls[k, i] = float((all_ious >= thr).sum()) / total_gt
    return recalls


def fast_eval_recall(dataset, proposals: Sequence[np.ndarray],
                     proposal_nums: Sequence[int] = (100, 300, 1000),
                     iou_thrs: Union[float, Sequence[float], None] = None
                     ) -> Dict[str, float]:
    """AR@N over a dataset's gt (reference `fast_eval_recall`,
    `coco.py:331-351`): mean recall over IoU thresholds per budget.

    Default thresholds follow the reference caller
    (`coco.py:428-447`): AR is averaged over IoU 0.5:0.95:10, not 0.5
    alone — a 0.5-only default inflated AR vs the baseline metric.

    `dataset` needs `__len__` + `get_ann_info(i) -> {'bboxes': [G, 4]}`.
    """
    gt_bboxes = [np.asarray(dataset.get_ann_info(i)['bboxes'],
                            np.float32).reshape(-1, 4)
                 for i in range(len(dataset))]
    if iou_thrs is None:
        iou_thrs = np.linspace(0.5, 0.95, 10)
    recalls = eval_recalls(gt_bboxes, proposals, list(proposal_nums),
                           iou_thrs)
    ar = recalls.mean(axis=1)
    return {f'AR@{n}': float(a) for n, a in zip(proposal_nums, ar)}
