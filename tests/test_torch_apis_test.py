"""`run_inference` and the evaluators of the port (`apis/test.py`).

`run_inference` keeps `num_real` rows of each batch, answers raw uint8 /
uint16 batches (preprocessed on the device) as the preprocessed ones,
and over several ranks refuses metas without the dataset index; `evaluate_nuscenes` and
`evaluate_proposal_recall` give the JAX package's numbers on the same
results (to 1e-6); `evaluate` sends STF data to the KITTI evaluation.
"""

import dataclasses
import pickle

import numpy as np
import pytest
import torch

from hrfuser_tpu.apis import test as jax_test
from hrfuser_tpu.configs import get_config as jax_get_config
from hrfuser_tpu_torch import get_experiment, init_detector
from hrfuser_tpu_torch.apis import test as port_test
from hrfuser_tpu_torch.apis.inference import detections_of
from hrfuser_tpu_torch.data.datasets.kitti2d import Kitti2DDataset
from hrfuser_tpu_torch.data.device_pipeline import (make_device_preprocess,
                                                    to_device)
from hrfuser_tpu_torch.parallel.mesh import Group

NAME = 'tiny_fusion_test'
B, H, W = 3, 64, 96


@pytest.fixture(scope='module')
def det():
    return init_detector(NAME, 'cpu', seed=0)


def _raw_batch(seed, num_real=B):
    rng = np.random.default_rng(seed)
    return dict(
        img=rng.integers(0, 256, (B, H, W, 3)).astype(np.uint8),
        mod_imgs=[rng.integers(19900, 21000, (B, H, W, 3)).astype(np.uint16)
                  for _ in range(2)],
        img_shapes=np.array([[H, W]] * B, np.float32),
        scale_factors=np.full((B, 4), 0.5, np.float32),
        metas=[{'id': f'{seed}-{i}'} for i in range(B)], num_real=num_real)


def _preprocessed(batch):
    pre = make_device_preprocess('nuscenes', ('lidar', 'radar'))
    img, mods = pre(torch.from_numpy(batch['img']),
                    [to_device(m, 'cpu') for m in batch['mod_imgs']])
    return dict(batch, img=img.numpy(), mod_imgs=[m.numpy() for m in mods])


def test_run_inference_keeps_num_real_rows(det):
    batches = [_raw_batch(0, num_real=2), _raw_batch(1)]
    results = port_test.run_inference(det, batches, progress=False)
    assert len(results) == 2 + B
    assert [r['meta']['id'] for r in results] == ['0-0', '0-1', '1-0',
                                                  '1-1', '1-2']
    for bi, batch in enumerate(batches):
        pre = _preprocessed(batch)
        out = det(pre['img'], pre['mod_imgs'], pre['img_shapes'],
                  pre['scale_factors'])
        for i in range(batch['num_real']):
            got = results[bi * 2 + i]
            want = detections_of(out, i)
            for k in ('boxes', 'scores', 'labels'):
                np.testing.assert_array_equal(got[k], want[k])


def test_raw_and_preprocessed_batches_agree(det):
    raw = _raw_batch(2)
    a = port_test.run_inference(det, [raw], progress=False)
    b = port_test.run_inference(det, [_preprocessed(raw)], progress=False)
    assert len(a) == len(b) == B
    assert sum(len(r['labels']) for r in a) > 0
    for ra, rb in zip(a, b):
        for k in ('boxes', 'scores', 'labels'):
            np.testing.assert_array_equal(ra[k], rb[k])
        assert ra['boxes'][:, 2].max(initial=0) <= W / 0.5 + 1e-3


def test_more_than_one_device_raises(det):
    """Over several ranks the collected images are put in dataset order
    by their metas' `sample_idx`; metas without it raise. (The sharded
    path itself: `test_torch_parallel_eval.py`.)"""
    group = Group(0, 2, torch.device('cpu'), 'gloo')
    with pytest.raises(ValueError, match="'sample_idx'"):
        port_test.run_inference(det, [_raw_batch(0)], progress=False,
                                group=group)


class _StubDataset:
    """Seeded ground truth: the first two detections of each image,
    jittered, and one random box of every class."""

    def __init__(self, results, num_classes, seed=0):
        rng = np.random.default_rng(seed)
        self.anns = []
        for r in results:
            near = r['boxes'][:2] + rng.normal(0, 2, (len(r['boxes'][:2]), 4))
            xy = rng.uniform(0, 150, (num_classes, 2))
            rand = np.concatenate([xy, xy + rng.uniform(5, 60, xy.shape)], 1)
            self.anns.append(dict(
                bboxes=np.concatenate([near, rand]).astype(np.float32),
                labels=np.concatenate([r['labels'][:2],
                                       np.arange(num_classes)])))

    def __len__(self):
        return len(self.anns)

    def get_ann_info(self, i):
        return self.anns[i]


@pytest.fixture(scope='module')
def results(det):
    return port_test.run_inference(det, [_raw_batch(3), _raw_batch(4)],
                                   progress=False)


def test_evaluate_nuscenes_equals_jax(results):
    ds = _StubDataset(results, 4)
    got = port_test.evaluate_nuscenes(results, ds, 4)
    want = jax_test.evaluate_nuscenes(results, ds, 4)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6, nan_ok=True), k
    # every class has ground truth (the area subsets may have none)
    assert all(np.isfinite(v) for k, v in got.items()
               if k.startswith('AP_cls') or k in ('mAP', 'mAP_50', 'mAP_75'))


def test_evaluate_proposal_recall_equals_jax(results):
    ds = _StubDataset(results, 4, seed=1)
    got = port_test.evaluate_proposal_recall(results, ds, (5, 20))
    assert got == pytest.approx(
        jax_test.evaluate_proposal_recall(results, ds, (5, 20)), abs=1e-6)


def _kitti_dataset(results, classes, path):
    """A `Kitti2DDataset` over `_StubDataset`'s ground truth, pickled as
    `dense_infos`."""
    infos = []
    for i, ann in enumerate(_StubDataset(results, len(classes)).anns):
        n = len(ann['labels'])
        infos.append({'image': {'image_path': f'{i}.png',
                                'image_shape': np.array([H, W])},
                      'annos': {'name': np.array([classes[c] for c in
                                                  ann['labels']]),
                                'bbox': ann['bboxes'],
                                'truncated': np.zeros(n),
                                'occluded': np.zeros(n)}})
    with open(path, 'wb') as f:
        pickle.dump(infos, f)
    return Kitti2DDataset(str(path), classes, test_mode=True)


def test_evaluate_dispatches_on_the_dataset(results, tmp_path):
    exp = get_experiment(NAME)
    ds = _StubDataset(results, 4)
    jcfg = jax_get_config(NAME)
    got = port_test.evaluate(exp, results, ds)
    want = jax_test.evaluate(jcfg, results, ds)
    assert got == pytest.approx(want, abs=1e-6, nan_ok=True)
    # STF data goes to the KITTI evaluation, as in JAX
    stf = dataclasses.replace(exp, data=dataclasses.replace(exp.data,
                                                            dataset='stf'))
    jstf = dataclasses.replace(jcfg, data=dataclasses.replace(jcfg.data,
                                                              dataset='stf'))
    kitti = _kitti_dataset(results, exp.data.classes, tmp_path / 'gt.pkl')
    got = port_test.evaluate(stf, results, kitti)
    assert got == jax_test.evaluate(jstf, results, kitti)
    assert 'mAP_2d_moderate' in got
