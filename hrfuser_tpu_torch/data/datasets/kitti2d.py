"""SeeingThroughFog (STF) KITTI-2D dataset.

Copy of `hrfuser_tpu/data/datasets/kitti2d.py:20-123` (the reference
`Kitti2DDataset`, `mmdet/datasets/kitti2d_dataset.py:10-419`):
loads `dense_infos_*.pkl` (pickled lists of KITTI-style info dicts;
several `ann_files`, the weather-split test set, are concatenated),
maps class names, gives the pipeline's per-sample dicts (`sample`: the
camera, lidar, radar and gated files under `data_root`), converts
detections back to KITTI annos and gives the GT annos for evaluation
with the `eval_on_crop` cropping (`:362-419`).
`tests/test_torch_kitti.py` and `tests/test_torch_data_datasets.py`
hold it equal to the JAX class.
"""

from __future__ import annotations

import os.path as osp
import pickle
from typing import List, Optional, Sequence

import numpy as np


class Kitti2DDataset:
    def __init__(self, ann_files, classes: Sequence[str],
                 data_root: str = '', filter_empty_gt: bool = True,
                 test_mode: bool = False):
        if isinstance(ann_files, str):
            ann_files = [ann_files]
        self.data_root = data_root
        self.classes = list(classes)
        self.cat2label = {c: i for i, c in enumerate(self.classes)}
        self.test_mode = test_mode

        self.data_infos: List[dict] = []
        for f in ann_files:
            path = f if osp.isabs(f) else osp.join(data_root, f)
            with open(path, 'rb') as fh:
                self.data_infos.extend(pickle.load(fh))

        if filter_empty_gt and not test_mode:
            self.data_infos = [
                info for info in self.data_infos
                if len(info['annos']['name']) > 0
                and not (len(info['annos']['name']) == 1
                         and info['annos']['name'][0] == 'ignore')]

        self.flag = np.array(
            [1 if info['image']['image_shape'][1]
             / info['image']['image_shape'][0] > 1 else 0
             for info in self.data_infos], np.uint8)

    def __len__(self) -> int:
        return len(self.data_infos)

    def get_ann_info(self, idx: int) -> dict:
        annos = self.data_infos[idx]['annos']
        names = annos['name']
        keep = np.array([i for i, n in enumerate(names)
                         if n in self.cat2label], np.int64)
        boxes = annos['bbox'][keep] if len(keep) else \
            np.zeros((0, 4), np.float32)
        labels = np.array([self.cat2label[names[i]] for i in keep], np.int64)
        return dict(bboxes=boxes.astype(np.float32), labels=labels)

    def sample(self, idx: int) -> dict:
        info = self.data_infos[idx]
        img_info = dict(filename=info['image']['image_path'])
        results = dict(
            img_info=img_info,
            ann_info=self.get_ann_info(idx),
            img_prefix=self.data_root,
            lidar_prefix=self.data_root,
            radar_prefix=self.data_root,
            gated_prefix=self.data_root,
            lidar_info=info.get('lidar_projections', {}),
            radar_info=info.get('radar_projections', {}),
            sample_idx=idx,
        )
        return results

    def detections_to_kitti(self, det_boxes, det_scores, det_labels,
                            det_valid) -> List[dict]:
        """Per-image KITTI-style annos from padded detection arrays
        (`bbox2result_kitti2d`, `kitti2d_dataset.py:252-360`)."""
        out = []
        for i in range(len(det_boxes)):
            v = det_valid[i]
            n = int(v.sum())
            names = np.array([self.classes[c] for c in det_labels[i][v]])
            out.append(dict(
                name=names,
                bbox=det_boxes[i][v].astype(np.float32),
                score=det_scores[i][v].astype(np.float32),
                truncated=-np.ones(n), occluded=-np.ones(n),
                alpha=-10 * np.ones(n),
                dimensions=np.zeros((n, 3)), location=-1000 * np.ones((n, 3)),
                rotation_y=-10 * np.ones(n)))
        return out

    def gt_annos(self, crop: Optional[Sequence[int]] = None) -> List[dict]:
        """GT annos for evaluation, optionally cropped to the train-time
        frame (`evaluate`'s `eval_on_crop`, `:392-419`): boxes shifted by
        the crop offset, kept if >= 10% of their area stays in frame."""
        out = []
        for info in self.data_infos:
            annos = {k: np.asarray(v) for k, v in info['annos'].items()}
            if crop is not None:
                ch, cw, oy, ox = crop
                boxes = annos['bbox'].astype(np.float32).copy()
                if len(boxes):
                    area0 = ((boxes[:, 2] - boxes[:, 0])
                             * (boxes[:, 3] - boxes[:, 1]))
                    boxes -= np.array([ox, oy, ox, oy], np.float32)
                    boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, cw)
                    boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, ch)
                    area = ((boxes[:, 2] - boxes[:, 0])
                            * (boxes[:, 3] - boxes[:, 1]))
                    keep = ((boxes[:, 2] > boxes[:, 0])
                            & (boxes[:, 3] > boxes[:, 1])
                            & (area / np.maximum(area0, 1e-6) >= 0.1))
                    annos = {k: (v[keep] if v.ndim >= 1
                                 and len(v) == len(keep) else v)
                             for k, v in annos.items()}
                    annos['bbox'] = boxes[keep]
            out.append(annos)
        return out
