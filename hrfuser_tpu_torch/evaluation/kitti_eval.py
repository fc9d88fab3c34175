"""KITTI 2D AP evaluation (pure numpy).

A verbatim copy of `hrfuser_tpu/evaluation/kitti_eval.py` (the port
imports nothing of the JAX package; `tests/test_torch_kitti.py` holds the
two equal). Rebuild of `mmdet/core/evaluation/kitti_utils/eval.py`, the
2D bbox metric only:
  * difficulty gates easy/moderate/hard: min height 40/25/25 px, max
    occlusion 0/1/2, max truncation .15/.3/.5 (`eval.py:31-33`)
  * neighbor-class absorption (Van~Car, Person_sitting~Pedestrian) and
    DontCare regions absorb detections without FP (`:39-83,249-267`)
  * 41 recall-sample thresholds from TP scores (`get_thresholds`, `:9-27`)
  * AP = mean of max-interpolated precision at every 4th of the 41 points
    (11-point, `get_mAP`, `:573-577`), x100.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

MIN_HEIGHT = (40.0, 25.0, 25.0)
MAX_OCCLUSION = (0, 1, 2)
MAX_TRUNCATION = (0.15, 0.3, 0.5)
N_SAMPLE_PTS = 41
NEIGHBOR = {'car': ('van',), 'pedestrian': ('person_sitting',)}
DEFAULT_MIN_OVERLAP = {'car': 0.7, 'pedestrian': 0.5, 'cyclist': 0.5}


def _iou(a: np.ndarray, b: np.ndarray, criterion: int = -1) -> np.ndarray:
    """criterion -1: IoU; 0: intersection / area(a)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    if criterion == 0:
        denom = np.broadcast_to(area_a[:, None], inter.shape)
    else:
        denom = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(denom, 1e-9)


def _clean(gt: dict, dt: dict, cls: str, difficulty: int):
    """Per-image gt/dt classification (`clean_data`, `eval.py:29-83`)."""
    cls = cls.lower()
    names = [str(n).lower() for n in gt['name']]
    ignored_gt, dc_boxes = [], []
    num_valid = 0
    for i, name in enumerate(names):
        bbox = gt['bbox'][i]
        height = bbox[3] - bbox[1]
        if name == cls:
            valid = 1
        elif name in NEIGHBOR.get(cls, ()):
            valid = 0
        else:
            valid = -1
        occ = gt.get('occluded', np.zeros(len(names)))[i]
        trunc = gt.get('truncated', np.zeros(len(names)))[i]
        ignore = (occ > MAX_OCCLUSION[difficulty]
                  or trunc > MAX_TRUNCATION[difficulty]
                  or height <= MIN_HEIGHT[difficulty]
                  or occ == -1)
        if valid == 1 and not ignore:
            ignored_gt.append(0)
            num_valid += 1
        elif valid == 0 or (ignore and valid == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if gt['name'][i] == 'DontCare':
            dc_boxes.append(bbox)

    ignored_dt = []
    for i, name in enumerate(str(n).lower() for n in dt['name']):
        height = abs(dt['bbox'][i, 3] - dt['bbox'][i, 1])
        if height < MIN_HEIGHT[difficulty]:
            ignored_dt.append(1)
        elif name == cls:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)

    return (num_valid, np.asarray(ignored_gt, np.int64),
            np.asarray(ignored_dt, np.int64),
            np.asarray(dc_boxes, np.float64).reshape(-1, 4))


def _match(overlaps, gt_boxes, dt_boxes, dt_scores, ignored_gt, ignored_dt,
           dc_boxes, min_overlap, thresh, compute_fp):
    """`compute_statistics_jit` (`eval.py:165-282`), bbox metric."""
    n_dt, n_gt = len(dt_boxes), len(gt_boxes)
    assigned = np.zeros(n_dt, bool)
    ignored_threshold = (dt_scores < thresh) if compute_fp \
        else np.zeros(n_dt, bool)
    tp = fp = fn = 0
    tp_scores = []
    for i in range(n_gt):
        if ignored_gt[i] == -1:
            continue
        det_idx, valid_det = -1, None
        max_ov, assigned_ignored = 0.0, False
        for j in range(n_dt):
            if ignored_dt[j] == -1 or assigned[j] or ignored_threshold[j]:
                continue
            ov = overlaps[j, i]
            if not compute_fp and ov > min_overlap and \
                    (valid_det is None or dt_scores[j] > valid_det):
                det_idx, valid_det = j, dt_scores[j]
            elif compute_fp and ov > min_overlap and \
                    (ov > max_ov or assigned_ignored) and ignored_dt[j] == 0:
                max_ov, det_idx, valid_det = ov, j, 1.0
                assigned_ignored = False
            elif compute_fp and ov > min_overlap and valid_det is None \
                    and ignored_dt[j] == 1:
                det_idx, valid_det = j, 1.0
                assigned_ignored = True
        if valid_det is None and ignored_gt[i] == 0:
            fn += 1
        elif valid_det is not None and (ignored_gt[i] == 1
                                        or ignored_dt[det_idx] == 1):
            assigned[det_idx] = True
        elif valid_det is not None:
            tp += 1
            tp_scores.append(dt_scores[det_idx])
            assigned[det_idx] = True
    if compute_fp:
        fp = int(np.sum(~assigned & (ignored_dt == 0) & ~ignored_threshold))
        if len(dc_boxes):
            ov_dc = _iou(dt_boxes, dc_boxes, criterion=0)
            nstuff = 0
            for i in range(len(dc_boxes)):
                for j in range(n_dt):
                    if assigned[j] or ignored_dt[j] != 0 \
                            or ignored_threshold[j]:
                        continue
                    if ov_dc[j, i] > min_overlap:
                        assigned[j] = True
                        nstuff += 1
            fp -= nstuff
    return tp, fp, fn, tp_scores


def _get_thresholds(scores: np.ndarray, num_gt: int) -> List[float]:
    scores = np.sort(scores)[::-1]
    thresholds, current_recall = [], 0.0
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)
                and i < len(scores) - 1):
            continue
        thresholds.append(score)
        current_recall += 1 / (N_SAMPLE_PTS - 1.0)
    return thresholds


def kitti_eval_2d(gt_annos: Sequence[dict], dt_annos: Sequence[dict],
                  classes: Sequence[str],
                  min_overlaps: Dict[str, float] = None
                  ) -> Dict[str, float]:
    """2D bbox AP over (easy, moderate, hard) per class.

    Args:
        gt_annos/dt_annos: per-image KITTI annos dicts with 'name',
            'bbox' [N,4] (+'occluded'/'truncated' for gts, 'score' for dts).

    Returns:
        {'<Class>_2d_easy/moderate/hard': AP(%), 'mAP_2d_moderate': ...}
    """
    assert len(gt_annos) == len(dt_annos)
    min_overlaps = min_overlaps or DEFAULT_MIN_OVERLAP
    results: Dict[str, float] = {}
    mods = []
    for cls in classes:
        min_ov = min_overlaps.get(cls.lower(), 0.5)
        for difficulty, dname in enumerate(('easy', 'moderate', 'hard')):
            cleaned = [_clean(gt, dt, cls, difficulty)
                       for gt, dt in zip(gt_annos, dt_annos)]
            total_valid = sum(c[0] for c in cleaned)
            ap = 0.0
            if total_valid > 0:
                ious = [
                    _iou(np.asarray(dt['bbox'], np.float64).reshape(-1, 4),
                         np.asarray(gt['bbox'], np.float64).reshape(-1, 4))
                    for gt, dt in zip(gt_annos, dt_annos)]
                all_tp_scores = []
                for (nv, ig, idt, dc), gt, dt, ov in zip(
                        cleaned, gt_annos, dt_annos, ious):
                    _, _, _, s = _match(
                        ov, np.asarray(gt['bbox']).reshape(-1, 4),
                        np.asarray(dt['bbox']).reshape(-1, 4),
                        np.asarray(dt.get('score', [])), ig, idt, dc,
                        min_ov, 0.0, compute_fp=False)
                    all_tp_scores += s
                thresholds = _get_thresholds(np.asarray(all_tp_scores),
                                             total_valid)
                pr = np.zeros((len(thresholds), 3))
                for ti, thr in enumerate(thresholds):
                    for (nv, ig, idt, dc), gt, dt, ov in zip(
                            cleaned, gt_annos, dt_annos, ious):
                        tp, fp, fn, _ = _match(
                            ov, np.asarray(gt['bbox']).reshape(-1, 4),
                            np.asarray(dt['bbox']).reshape(-1, 4),
                            np.asarray(dt.get('score', [])), ig, idt, dc,
                            min_ov, thr, compute_fp=True)
                        pr[ti] += (tp, fp, fn)
                prec = np.zeros(N_SAMPLE_PTS)
                prec[:len(thresholds)] = pr[:, 0] / np.maximum(
                    pr[:, 0] + pr[:, 1], 1e-9)
                for i in range(N_SAMPLE_PTS):
                    prec[i] = prec[i:].max() if i < len(thresholds) else 0.0
                ap = float(prec[::4].sum() / 11 * 100)
            results[f'{cls}_2d_{dname}'] = ap
            if dname == 'moderate':
                mods.append(ap)
    results['mAP_2d_moderate'] = float(np.mean(mods)) if mods else 0.0
    return results
