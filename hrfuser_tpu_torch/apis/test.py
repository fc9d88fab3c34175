"""Evaluation API: batched inference over a loader + metrics.

Port of `hrfuser_tpu/apis/test.py:27-157` (the reference's
`single_gpu_test`, `mmdet/apis/test.py:18-308`) for one device: iterate
the test loader, run the detector, collect per-image detections on the
host, then evaluate with the dataset's metric (COCO mAP for nuScenes).
Multi-GPU inference is ROADMAP §1 item 6; KITTI evaluation (STF) comes
with the STF configuration.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from hrfuser_tpu_torch.apis.inference import Detector
from hrfuser_tpu_torch.configs import Experiment
from hrfuser_tpu_torch.data.device_pipeline import make_raw_predictor
from hrfuser_tpu_torch.evaluation.coco_map import evaluate_coco_map
from hrfuser_tpu_torch.evaluation.recall import fast_eval_recall


def _is_raw(img) -> bool:
    return img.dtype in (np.uint8, torch.uint8)


def run_inference(detector: Detector, loader: Iterable[dict],
                  progress: bool = True,
                  devices: Optional[Sequence] = None) -> List[dict]:
    """Run the detector over a loader; returns per-image dicts (boxes in
    original-image coordinates, scores, labels, meta).

    Each batch is a dict: `img` [B, H, W, 3], either preprocessed
    (float, normalized and padded) or raw uint8 BGR on the model grid,
    which is preprocessed on the detector's device with its sensor
    images (uint16); `mod_imgs`, `img_shapes` [B, 2], `scale_factors`
    [B, 4], `metas`, and `num_real`, the leading rows that are real
    images (the rest pad the batch).
    """
    if devices is not None and len(devices) > 1:
        raise NotImplementedError(
            'run_inference runs on one device; inference over several '
            'GPUs is ROADMAP §1 item 6')
    raw = make_raw_predictor(detector)
    results: List[dict] = []
    t0 = time.time()
    for bi, batch in enumerate(loader):
        img = batch['img']
        run = raw if _is_raw(img) else detector
        out = run(img, batch.get('mod_imgs'), batch['img_shapes'],
                  batch['scale_factors'])
        boxes, scores, labels, valid = (
            t.float().cpu().numpy() if t.is_floating_point()
            else t.cpu().numpy()
            for t in (out.boxes, out.scores, out.labels, out.valid))
        for i in range(int(batch.get('num_real', len(img)))):
            v = valid[i]
            results.append(dict(boxes=boxes[i][v], scores=scores[i][v],
                                labels=labels[i][v],
                                meta=batch['metas'][i]))
        if progress and bi % 20 == 0:
            rate = len(results) / max(time.time() - t0, 1e-6)
            print(f'\r[test] {len(results)} imgs ({rate:.1f} img/s)', end='')
    if progress:
        print()
    return results


def evaluate_nuscenes(results: List[dict], dataset, num_classes: int,
                      class_ids=None) -> Dict[str, float]:
    preds, gts = [], []
    for i, det in enumerate(results):
        ann = dataset.get_ann_info(i)
        preds.append(dict(boxes=det['boxes'], scores=det['scores'],
                          labels=det['labels']))
        gts.append(dict(boxes=ann['bboxes'], labels=ann['labels']))
    return evaluate_coco_map(preds, gts, num_classes, class_ids=class_ids)


def evaluate_proposal_recall(results: List[dict], dataset,
                             proposal_nums=(100, 300, 1000)
                             ) -> Dict[str, float]:
    """AR@N of the detections treated as class-agnostic proposals
    (reference `metric='proposal_fast'`, `mmdet/datasets/coco.py:331-351`)."""
    proposals = [np.concatenate(
        [r['boxes'], r['scores'][:, None]], axis=1) for r in results]
    return fast_eval_recall(dataset, proposals, proposal_nums)


def evaluate_stf(results: List[dict], dataset, classes,
                 eval_on_crop=None) -> Dict[str, float]:
    raise NotImplementedError(
        'KITTI evaluation (STF) is not ported yet: it comes with the STF '
        'configuration (ROADMAP §1)')


def evaluate(cfg: Experiment, results: List[dict], dataset
             ) -> Dict[str, float]:
    if cfg.data.dataset == 'stf':
        return evaluate_stf(results, dataset, cfg.data.classes,
                            cfg.data.eval_on_crop)
    return evaluate_nuscenes(results, dataset, len(cfg.data.classes),
                             class_ids=cfg.data.evaluation_class_ids)
