"""Dataset wrappers: Concat / Repeat / ClassBalanced.

Port of `hrfuser_tpu/data/datasets/wrappers.py:18-100` (the reference's
`mmdet/datasets/dataset_wrappers.py`): the STF test set is a concat of
four weather-split pkls; `RepeatDataset` and `ClassBalancedDataset`
(LVIS-style repeat factors with `oversample_thr`) are part of the
training surface.
"""

from __future__ import annotations

import bisect
import math
from collections import defaultdict
from typing import List, Sequence

import numpy as np


class ConcatDataset:
    def __init__(self, datasets: Sequence):
        if not datasets:
            raise ValueError('ConcatDataset of no datasets')
        self.datasets = list(datasets)
        self.cumulative = []
        total = 0
        for d in self.datasets:
            total += len(d)
            self.cumulative.append(total)
        self.flag = np.concatenate([d.flag for d in self.datasets]) \
            if all(hasattr(d, 'flag') for d in self.datasets) else None

    def __len__(self):
        return self.cumulative[-1]

    def _locate(self, idx: int):
        ds = bisect.bisect_right(self.cumulative, idx)
        prev = self.cumulative[ds - 1] if ds else 0
        return ds, idx - prev

    def sample(self, idx: int) -> dict:
        ds, local = self._locate(idx)
        return self.datasets[ds].sample(local)

    def get_ann_info(self, idx: int) -> dict:
        ds, local = self._locate(idx)
        return self.datasets[ds].get_ann_info(local)


class RepeatDataset:
    def __init__(self, dataset, times: int):
        self.dataset = dataset
        self.times = times
        self._len = len(dataset) * times
        if hasattr(dataset, 'flag'):
            self.flag = np.tile(dataset.flag, times)

    def __len__(self):
        return self._len

    def sample(self, idx: int) -> dict:
        return self.dataset.sample(idx % len(self.dataset))

    def get_ann_info(self, idx: int) -> dict:
        return self.dataset.get_ann_info(idx % len(self.dataset))


class ClassBalancedDataset:
    """Oversample images containing rare categories
    (`dataset_wrappers.py` ClassBalancedDataset, LVIS-style
    repeat-factor sampling with `oversample_thr`)."""

    def __init__(self, dataset, oversample_thr: float):
        self.dataset = dataset
        n = len(dataset)
        # category frequencies over images
        cat_freq = defaultdict(float)
        img_cats: List[set] = []
        for i in range(n):
            labels = set(int(v) for v in dataset.get_ann_info(i)['labels'])
            img_cats.append(labels)
            for c in labels:
                cat_freq[c] += 1.0 / n
        cat_repeat = {
            c: max(1.0, math.sqrt(oversample_thr / f))
            for c, f in cat_freq.items()}
        indices = []
        for i in range(n):
            repeat = max([cat_repeat[c] for c in img_cats[i]], default=1.0)
            indices += [i] * int(math.ceil(repeat))
        self.indices = indices
        if hasattr(dataset, 'flag'):
            self.flag = np.asarray([dataset.flag[i] for i in indices],
                                   np.uint8)

    def __len__(self):
        return len(self.indices)

    def sample(self, idx: int) -> dict:
        return self.dataset.sample(self.indices[idx])

    def get_ann_info(self, idx: int) -> dict:
        return self.dataset.get_ann_info(self.indices[idx])
