"""Pipeline assembly and batched loading (host, numpy).

Port of `hrfuser_tpu/data/loader.py:33-179` (the reference dataloader
assembly, `mmdet/datasets/builder.py:86-199`): the train and test
pipelines of each dataset family, deterministic per-sample seeding, and
fixed-size batches. The seeding is the JAX loader's, so for the same
files and seed the batches are the JAX loader's batches:
  * train order: `default_rng(seed + epoch).permutation(n)`; test order
    is the dataset's;
  * each sample's `results['rng']`: `default_rng((seed * 1_000_003 +
    epoch) * 1_000_003 + idx)`;
  * a short last batch (test mode) is padded by repeating its last
    sample, and `num_real` says how many rows are real.

The batch dict:
    img [B,H,W,3] float32 (normalized, padded), mod_imgs [list of
    [B,H,W,C]], gt_boxes [B,G,4], gt_labels [B,G] int32, gt_valid [B,G],
    img_shapes [B,2], scale_factors [B,4], num_real, metas [list of dicts]
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np

from hrfuser_tpu_torch.configs import DataCfg
from hrfuser_tpu_torch.data import norms
from hrfuser_tpu_torch.data.pipelines.loading import (
    LoadAnnotations, LoadGatedImageFromFile, LoadImageFromFile,
    LoadProjectedSensorImageFile)
from hrfuser_tpu_torch.data.pipelines.transforms import (Compose, Crop,
                                                         FormatBundle,
                                                         Normalize, Pad,
                                                         RandomDrop,
                                                         RandomFlip, Resize)


def build_pipeline(cfg: DataCfg, train: bool, max_gts: int = 100,
                   device='cuda') -> Compose:
    """Train/test pipeline per dataset family (reference dataset configs);
    JPEG camera frames decode their pixels on `device`."""
    is_stf = cfg.dataset == 'stf'
    norm = norms.STF if is_stf else norms.NUS
    mods = list(cfg.modalities)
    steps: List = [LoadImageFromFile(device=device)]

    if 'lidar' in mods:
        ch = 'yzi' if is_stf else 'rih'
        steps += [LoadProjectedSensorImageFile('lidar', [ch]),
                  Normalize(**norm['lidar'], keys=['lidar_img'],
                            sensor_type='lidar')]
    if 'radar' in mods:
        if is_stf:
            steps += [LoadProjectedSensorImageFile('radar', ['yzv'],
                                                   delete_channels=[0])]
        else:
            steps += [LoadProjectedSensorImageFile('radar', ['riv'])]
        steps += [Normalize(**norm['radar'], keys=['radar_img'],
                            sensor_type='radar')]
    if 'gated' in mods:
        steps += [LoadGatedImageFromFile(),
                  Normalize(**norm['gated'], keys=['gated_img'],
                            sensor_type='gated')]

    if train:
        steps.append(LoadAnnotations(with_bbox=True,
                                     with_visibility=not is_stf))

    skip = [f'{m}_img' for m in mods]
    if is_stf:
        c1, c2 = cfg.crops
        steps += [Crop((c1[0], c1[1]), offsets=(c1[2], c1[3]),
                       skip_keys=skip),
                  Resize((1280, 768), keep_ratio=False, skip_keys=skip),
                  Crop((c2[0], c2[1]), offsets=(c2[2], c2[3]),
                       thresh_in_frame=0.1)]
    else:
        steps += [Resize(cfg.img_scale, keep_ratio=True, skip_keys=skip)]

    if train:
        steps.append(RandomFlip(cfg.flip_ratio))
    steps += [Normalize(**norm['img'], keys=['img'], sensor_type='img'),
              Pad(cfg.pad_divisor)]
    if train and cfg.modality_drop_p:
        keys = ['img'] + [f'{m}_img' for m in mods]
        steps.append(RandomDrop(list(cfg.modality_drop_p), keys))
    steps.append(FormatBundle(max_gts=max_gts,
                              sensor_keys=['img'] + skip))
    return Compose(steps)


class DetDataLoader:
    """Deterministic batched loader over a dataset + pipeline.

    With `prefetch > 0` a background thread prepares up to `prefetch`
    batches ahead, so host preprocessing overlaps the device's work (the
    reference's `workers_per_gpu` analogue). An error in that thread is
    raised in the iterating one; an iteration left early stops the
    thread. The epoch counter advances when an iteration runs to its end.
    JPEG camera frames decode their pixels on `device` (the card unless
    the caller passes 'cpu'), on a stream of the loading thread's own.
    """

    def __init__(self, dataset, cfg: DataCfg, batch_size: int,
                 train: bool, seed: int = 0, max_gts: int = 100,
                 drop_last: Optional[bool] = None, prefetch: int = 2,
                 device='cuda'):
        self.dataset = dataset
        self.cfg = cfg
        self.batch_size = batch_size
        self.train = train
        self.seed = seed
        self.epoch = 0
        self.pipeline = build_pipeline(cfg, train, max_gts, device)
        self.modalities = list(cfg.modalities)
        self.drop_last = train if drop_last is None else drop_last
        self.prefetch = prefetch

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if not self.train:
            return np.arange(n)
        rng = np.random.default_rng(self.seed + self.epoch)
        return rng.permutation(n)

    def _load_one(self, idx: int) -> dict:
        results = self.dataset.sample(idx)
        results['rng'] = np.random.default_rng(
            (self.seed * 1_000_003 + self.epoch) * 1_000_003 + idx)
        return self.pipeline(results)

    def _make_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        idxs = self._indices()
        bs = self.batch_size
        for b in range(len(self)):
            chunk = idxs[b * bs:(b + 1) * bs]
            samples = [self._load_one(i) for i in chunk]
            # pad a short final batch by repeating the last sample
            while len(samples) < bs:
                samples.append(samples[-1])
            yield self._collate(samples, real=len(chunk))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.prefetch <= 0:
            yield from self._make_batches()
            self.epoch += 1
            return
        q: 'queue.Queue' = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        done = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                for batch in self._make_batches():
                    if not put(batch):
                        return
            except BaseException as e:          # re-raised by the consumer
                put(e)
                return
            put(done)

        t = threading.Thread(target=producer, daemon=True,
                             name='DetDataLoader')
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()
        self.epoch += 1

    def _collate(self, samples: List[dict], real: int
                 ) -> Dict[str, np.ndarray]:
        batch = dict(
            img=np.stack([s['img'] for s in samples]),
            gt_boxes=np.stack([s['gt_boxes'] for s in samples]),
            gt_labels=np.stack([s['gt_labels'] for s in samples]),
            gt_valid=np.stack([s['gt_valid'] for s in samples]),
            img_shapes=np.stack([s['img_shape'] for s in samples]),
            scale_factors=np.stack([s['scale_factor'] for s in samples]),
        )
        if self.modalities:
            batch['mod_imgs'] = [
                np.stack([s[f'{m}_img'] for s in samples])
                for m in self.modalities]
        batch['num_real'] = np.asarray(real, np.int32)
        batch['metas'] = [s['meta'] for s in samples]
        return batch
