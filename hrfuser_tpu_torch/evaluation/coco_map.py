"""Self-contained COCO-style bbox mAP (numpy; no pycocotools).

Replaces the reference's pycocotools `COCOeval` dependency
(`mmdet/datasets/coco.py:383-560`, C extension) with a pure-numpy
implementation of the COCO protocol: 10 IoU thresholds .5:.05:.95,
101-point interpolated precision, area ranges (all/small/medium/large),
maxDets=100, per-class then mean. Matching follows COCOeval: detections
sorted by score, each matched to the best still-unmatched gt with
IoU >= threshold; crowd/ignored gts absorb detections without penalty.

A verbatim copy of `hrfuser_tpu/evaluation/coco_map.py`: the port imports
nothing of the JAX package. `tests/test_torch_evaluation.py` holds the two
equal.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    'all': (0.0, 1e10),
    'small': (0.0, 32.0 ** 2),
    'medium': (32.0 ** 2, 96.0 ** 2),
    'large': (96.0 ** 2, 1e10),
}


def _iou(dets: np.ndarray, gts: np.ndarray) -> np.ndarray:
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    ad = (dets[:, 2] - dets[:, 0]) * (dets[:, 3] - dets[:, 1])
    ag = (gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1])
    lt = np.maximum(dets[:, None, :2], gts[None, :, :2])
    rb = np.minimum(dets[:, None, 2:], gts[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / np.maximum(ad[:, None] + ag[None, :] - inter, 1e-9)


def _last_argmax(values: np.ndarray) -> int:
    """Index of the max, ties broken toward the LAST occurrence
    (COCOeval's `if iou < best: continue` update rule)."""
    return len(values) - 1 - int(values[::-1].argmax())


def _greedy_match(ious: np.ndarray, g_ig_s: np.ndarray,
                  d_out_of_range: np.ndarray):
    """COCOeval greedy matching over all IoU thresholds.

    Args:
        ious: [D, G] with gts sorted non-ignored-first.
        g_ig_s: [G] ignore flags (sorted the same way).
        d_out_of_range: [D] det-area outside the range being evaluated.

    Returns (matched [T, D], ignored [T, D]).
    """
    n_d, n_g = ious.shape
    t = len(IOU_THRS)
    matched = np.zeros((t, n_d), bool)
    ignored = np.zeros((t, n_d), bool)
    g_real = ~g_ig_s
    for ti, thr in enumerate(IOU_THRS):
        thr_eff = min(thr, 1 - 1e-10)
        g_used = np.zeros(n_g, bool)
        for di in range(n_d):
            iou_d = ious[di]
            ok = iou_d >= thr_eff
            # real (non-ignored, unmatched) gts take priority; ignored
            # gts absorb leftovers but are SINGLE-USE like any other
            # non-crowd gt (COCOeval `gtm` check; found by differential
            # fuzz vs the COCOeval oracle)
            real_ok = ok & g_real & ~g_used
            if real_ok.any():
                best = _last_argmax(np.where(real_ok, iou_d, -1.0))
            else:
                ig_ok = ok & g_ig_s & ~g_used
                if not ig_ok.any():
                    continue
                best = _last_argmax(np.where(ig_ok, iou_d, -1.0))
            g_used[best] = True
            matched[ti, di] = True
            ignored[ti, di] = g_ig_s[best]
        # unmatched dets outside the area range are ignored, not FP
        ignored[ti] |= (~matched[ti]) & d_out_of_range
    return matched, ignored


def _match_image_all_areas(dets: np.ndarray, det_scores: np.ndarray,
                           gts: np.ndarray, gt_ignore: np.ndarray,
                           max_dets: int):
    """COCOeval-style greedy matching for one image/class, all area
    ranges at once (IoUs computed a single time).

    Returns ({area: (matched [T, D], ignored [T, D], n_gt)}, scores [D])
    where D is the number of kept detections (score-sorted, truncated to
    max_dets).
    """
    order = np.argsort(-det_scores, kind='stable')[:max_dets]
    dets = dets[order]
    n_d, n_g = len(dets), len(gts)

    g_area = (gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1]) \
        if n_g else np.zeros(0)
    d_area = (dets[:, 2] - dets[:, 0]) * (dets[:, 3] - dets[:, 1]) \
        if n_d else np.zeros(0)
    ious_full = _iou(dets, gts)

    out = {}
    for aname, arng in AREA_RANGES.items():
        g_ig = gt_ignore | (g_area < arng[0]) | (g_area > arng[1])
        # sort gts: non-ignored first (COCOeval matches them first)
        g_order = np.argsort(g_ig, kind='stable')
        g_ig_s = g_ig[g_order]
        d_out = (d_area < arng[0]) | (d_area > arng[1])
        matched, ignored = _greedy_match(ious_full[:, g_order], g_ig_s,
                                         d_out)
        out[aname] = (matched, ignored, int((~g_ig).sum()))
    return out, det_scores[order]


def evaluate_coco_map(predictions: Sequence[dict], groundtruths: Sequence[dict],
                      num_classes: int, max_dets: int = 100,
                      class_ids: Optional[Sequence[int]] = None
                      ) -> Dict[str, float]:
    """COCO bbox mAP over paired per-image predictions/gts.

    Args:
        predictions: per image dict(boxes [N,4], scores [N], labels [N]).
        groundtruths: per image dict(boxes [M,4], labels [M],
            ignore [M] bool optional).
        class_ids: restrict evaluation to this label subset (the
            reference's `evaluation_ids`, `mmdet/datasets/coco.py:485-486`
            — classes outside the subset contribute neither dets nor gts,
            and the mean runs over the subset only).

    Returns:
        {'mAP', 'mAP_50', 'mAP_75', 'mAP_s', 'mAP_m', 'mAP_l',
         'AP_<cls>' per class}
    """
    t = len(IOU_THRS)
    r = len(RECALL_THRS)
    n_areas = len(AREA_RANGES)
    eval_cls = list(class_ids) if class_ids is not None \
        else list(range(num_classes))
    # precision[t, r, class, area]; non-evaluated classes stay -1 and are
    # dropped by `_mean` exactly like empty-gt classes
    precision = -np.ones((t, r, num_classes, n_areas))

    area_names = list(AREA_RANGES)
    for ci in eval_cls:
        acc = {a: {'m': [], 'ig': [], 'n_gt': 0} for a in area_names}
        scores_all = []
        for pred, gt in zip(predictions, groundtruths):
            p_sel = pred['labels'] == ci
            g_sel = gt['labels'] == ci
            g_ignore = np.asarray(
                gt.get('ignore', np.zeros(len(gt['labels']), bool))
            )[g_sel]
            per_area, sc = _match_image_all_areas(
                np.asarray(pred['boxes'])[p_sel],
                np.asarray(pred['scores'])[p_sel],
                np.asarray(gt['boxes'])[g_sel], g_ignore, max_dets)
            scores_all.append(sc)
            for a in area_names:
                m, ig, n_gt = per_area[a]
                acc[a]['m'].append(m)
                acc[a]['ig'].append(ig)
                acc[a]['n_gt'] += n_gt

        scores = np.concatenate(scores_all)
        order = np.argsort(-scores, kind='stable')
        for ai, a in enumerate(area_names):
            n_gt_total = acc[a]['n_gt']
            if n_gt_total == 0:
                continue
            matched = np.concatenate(acc[a]['m'], axis=1)[:, order]
            ignored = np.concatenate(acc[a]['ig'], axis=1)[:, order]

            for ti in range(t):
                keep = ~ignored[ti]
                tp = np.cumsum(matched[ti][keep])
                fp = np.cumsum(~matched[ti][keep])
                rec = tp / n_gt_total
                prec = tp / np.maximum(tp + fp, 1e-9)
                # monotone precision envelope
                if len(prec):
                    prec = np.maximum.accumulate(prec[::-1])[::-1]
                inds = np.searchsorted(rec, RECALL_THRS, side='left')
                q = np.zeros(r)
                valid = inds < len(prec)
                q[valid] = prec[inds[valid]]
                precision[ti, :, ci, ai] = q

    def _mean(p):
        p = p[p > -1]
        return float(p.mean()) if p.size else float('nan')

    results = {
        'mAP': _mean(precision[:, :, :, 0]),
        'mAP_50': _mean(precision[0, :, :, 0]),
        'mAP_75': _mean(precision[5, :, :, 0]),
        'mAP_s': _mean(precision[:, :, :, 1]),
        'mAP_m': _mean(precision[:, :, :, 2]),
        'mAP_l': _mean(precision[:, :, :, 3]),
    }
    for ci in range(num_classes):
        results[f'AP_cls{ci}'] = _mean(precision[:, :, ci, 0])
    return results
