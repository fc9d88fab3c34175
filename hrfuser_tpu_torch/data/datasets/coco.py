"""nuScenes COCO-style dataset (plain json reader).

Port of `hrfuser_tpu/data/datasets/coco.py:20-114` (the reference's
extended `CocoDataset`, `mmdet/datasets/coco.py`): reads
`nuscenes_infos_{train,val}_mono3d.coco.json`, maps the config's class
names to labels, indexes the extra `lidar_projections` /
`radar_projections` arrays by image id (each entry's id is the image id
with an `l` / `r` suffix, `coco.py:60-72`), parses nuScenes
`visibility_token`s (`:143-194`) and gives per-sample info dicts for the
pipeline. No pycocotools: the json is plain COCO plus the sensor arrays.
"""

from __future__ import annotations

import json
import os.path as osp
from typing import Dict, List, Optional, Sequence

import numpy as np


class CocoFusionDataset:
    """COCO json + per-image sensor projection index."""

    def __init__(self, ann_file: str, classes: Sequence[str],
                 data_root: str = '', img_prefix: str = '',
                 lidar_prefix: str = '', radar_prefix: str = '',
                 min_visibility: Optional[int] = None,
                 filter_empty_gt: bool = True, test_mode: bool = False):
        self.data_root = data_root
        self.img_prefix = osp.join(data_root, img_prefix) if img_prefix \
            else data_root
        self.lidar_prefix = osp.join(data_root, lidar_prefix) if lidar_prefix \
            else data_root
        self.radar_prefix = osp.join(data_root, radar_prefix) if radar_prefix \
            else data_root
        self.classes = list(classes)
        self.test_mode = test_mode
        self.min_visibility = min_visibility

        path = ann_file if osp.isabs(ann_file) else osp.join(data_root,
                                                             ann_file)
        with open(path) as f:
            coco = json.load(f)

        cat_name_to_id = {c['name']: c['id'] for c in coco['categories']}
        self.cat_ids = [cat_name_to_id[c] for c in self.classes]
        self.cat2label = {cid: i for i, cid in enumerate(self.cat_ids)}

        self.img_infos: List[dict] = coco['images']
        self.anns_by_img: Dict[int, List[dict]] = {}
        for ann in coco['annotations']:
            self.anns_by_img.setdefault(ann['image_id'], []).append(ann)

        # projection entries carry id = <image_id> + 'l'/'r'
        # (`nuscenes_converter.py:710-724`; matched in `coco.py:60-72`)
        self.lidar_by_img: Dict[str, dict] = {
            e['id'][:-1]: e for e in coco.get('lidar_projections', [])}
        self.radar_by_img: Dict[str, dict] = {
            e['id'][:-1]: e for e in coco.get('radar_projections', [])}

        if filter_empty_gt and not test_mode:
            self.img_infos = [info for info in self.img_infos
                              if self.anns_by_img.get(info['id'])]

        # aspect-ratio group flag (`custom.py` _set_group_flag)
        self.flag = np.array(
            [1 if info['width'] / info['height'] > 1 else 0
             for info in self.img_infos], np.uint8)

    def __len__(self) -> int:
        return len(self.img_infos)

    def get_ann_info(self, idx: int) -> dict:
        info = self.img_infos[idx]
        anns = self.anns_by_img.get(info['id'], [])
        boxes, labels, vis = [], [], []
        for a in anns:
            if a.get('iscrowd', 0) or a.get('category_id') not in self.cat2label:
                continue
            x, y, w, h = a['bbox']
            if w < 1 or h < 1:
                continue
            v = a.get('visibility_token')
            if v is not None:
                v = int(v)
                if self.min_visibility is not None and v < self.min_visibility:
                    continue
            boxes.append([x, y, x + w, y + h])
            labels.append(self.cat2label[a['category_id']])
            vis.append(v if v is not None else -1)
        return dict(
            bboxes=np.asarray(boxes, np.float32).reshape(-1, 4),
            labels=np.asarray(labels, np.int64),
            visibilities=np.asarray(vis, np.int64))

    def _sensor_info(self, table: Dict[str, dict], img_id) -> dict:
        """{channel_group: {file_name, pixel_scale_factor, shift,
        empty_channels}, ...} for one image."""
        entry = table.get(img_id)
        return dict(entry) if entry else {}

    def sample(self, idx: int) -> dict:
        """Pipeline input dict for one sample (`pre_pipeline` semantics)."""
        info = self.img_infos[idx]
        results = dict(
            img_info=info,
            ann_info=self.get_ann_info(idx),
            img_prefix=self.img_prefix,
            lidar_prefix=self.lidar_prefix,
            radar_prefix=self.radar_prefix,
            lidar_info=self._sensor_info(self.lidar_by_img, info['id']),
            radar_info=self._sensor_info(self.radar_by_img, info['id']),
            sample_idx=idx,
        )
        return results
