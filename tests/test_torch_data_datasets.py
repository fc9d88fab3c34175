"""The port's datasets (`data/datasets/{coco,kitti2d,wrappers}.py`)
against the JAX package's, on the CPU.

A nuScenes-style COCO json (non-contiguous category ids, a crowd box, a
box under 1 px, an unknown category, visibility tokens, an image with no
boxes, `l` / `r`-suffixed projection ids) and an STF `dense_infos` pkl
are written to a temporary folder. Lengths, aspect-ratio flags, index
maps, `get_ann_info` and the pipeline's `sample()` dicts must be equal.
`build_dataset` over folders of every split file the CLIs read equals the
JAX datasets built over the files the JAX CLIs name.
"""

import json
import pickle
from types import SimpleNamespace

import numpy as np
import pytest

from hrfuser_tpu.data.datasets import coco as jax_coco
from hrfuser_tpu.data.datasets import kitti2d as jax_kitti2d
from hrfuser_tpu.data.datasets import wrappers as jax_wrappers
from hrfuser_tpu_torch.data.datasets import (build_dataset, coco, kitti2d,
                                             wrappers)
from tests.oracles.data_files import write_nuscenes, write_stf

CLASSES = ['car', 'truck', 'pedestrian']
STF_CLASSES = ['PassengerCar', 'Pedestrian', 'RidableVehicle']


@pytest.fixture(scope='module')
def coco_json(tmp_path_factory):
    root = tmp_path_factory.mktemp('coco')
    rng = np.random.default_rng(0)
    images, anns, lidar, radar = [], [], [], []
    for i in range(6):
        w, h = (1600, 900) if i != 4 else (600, 900)
        images.append(dict(file_name=f'samples/{i}.jpg', id=f'tok{i}',
                           width=w, height=h))
        for j in range(0 if i == 2 else 4):
            x, y = rng.uniform(0, 1000, 2)
            anns.append(dict(
                image_id=f'tok{i}', id=10 * i + j,
                bbox=[x, y, 0.5 if j == 3 else 40., 30.],
                category_id=[7, 3, 11, 3][j] if i != 5 else 99,
                iscrowd=int(j == 2 and i == 1),
                visibility_token=str(1 + (i + j) % 4)))
        for table, suffix, ch in ((lidar, 'l', 'rih'), (radar, 'r', 'riv')):
            table.append({'id': f'tok{i}{suffix}', ch: dict(
                file_name=f'{ch}/{i}.png', pixel_scale_factor=100.0,
                shift=200.0, empty_channels=[2] if suffix == 'r' else [])})
    cats = [dict(id=7, name='car'), dict(id=3, name='truck'),
            dict(id=11, name='pedestrian'), dict(id=99, name='bus')]
    path = root / 'ann.json'
    path.write_text(json.dumps(dict(images=images, annotations=anns,
                                    categories=cats, lidar_projections=lidar,
                                    radar_projections=radar)))
    return str(root)


def _same(a, b):
    if isinstance(b, dict):
        assert set(a) == set(b), set(a) ^ set(b)
        for k in b:
            _same(a[k], b[k])
    elif isinstance(b, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _same_dataset(got, want):
    assert len(got) == len(want)
    np.testing.assert_array_equal(got.flag, want.flag)
    for i in range(len(want)):
        _same(got.get_ann_info(i), want.get_ann_info(i))
        _same(got.sample(i), want.sample(i))


COCO_CASES = [dict(), dict(test_mode=True), dict(min_visibility=2),
              dict(filter_empty_gt=False),
              dict(img_prefix='samples', lidar_prefix='l', radar_prefix='r')]


@pytest.mark.parametrize('kw', COCO_CASES, ids=lambda kw: ','.join(kw)
                         or 'default')
def test_coco_fusion_dataset_equals_jax(coco_json, kw):
    got = coco.CocoFusionDataset('ann.json', CLASSES, data_root=coco_json,
                                 **kw)
    want = jax_coco.CocoFusionDataset('ann.json', CLASSES,
                                      data_root=coco_json, **kw)
    _same_dataset(got, want)
    assert got.cat2label == want.cat2label == {7: 0, 3: 1, 11: 2}
    assert len(got) == (5 if not (kw.get('test_mode')
                                  or 'filter_empty_gt' in kw) else 6)
    s = got.sample(0)
    assert s['lidar_info']['rih']['file_name'] == 'rih/0.png'


def _stf_info(i, names):
    n = len(names)
    return {'image': {'image_path': f'cam_stereo_left_lut/{i:05d}.png',
                      'image_shape': np.array([1024, 1920])},
            'annos': {'name': np.array(names),
                      'bbox': np.arange(4 * n, dtype=np.float32).reshape(
                          n, 4) * [1, 1, 3, 3] + i,
                      'truncated': np.zeros(n), 'occluded': np.zeros(n)},
            'lidar_projections': {'yzi': {
                'file_name': f'lidar_hdl64_strongest_yzi/{i:05d}.png',
                'pixel_scale_factor': 100.0, 'shift': 200.0,
                'empty_channels': []}},
            'radar_projections': {'yzv': {
                'file_name': f'radar_targets_yzv/{i:05d}.png',
                'pixel_scale_factor': 100.0, 'shift': 200.0,
                'empty_channels': []}}}


@pytest.fixture(scope='module')
def stf_pkls(tmp_path_factory):
    root = tmp_path_factory.mktemp('stf')
    splits = {'dense_infos_train.pkl': [
        _stf_info(0, ['PassengerCar', 'DontCare']), _stf_info(1, []),
        _stf_info(2, ['ignore']), _stf_info(3, ['Pedestrian', 'Cyclist',
                                                'RidableVehicle'])],
        'dense_infos_snow.pkl': [_stf_info(4, ['Pedestrian'])]}
    for name, infos in splits.items():
        with open(root / name, 'wb') as f:
            pickle.dump(infos, f)
    return str(root)


@pytest.mark.parametrize('test_mode', [False, True])
def test_kitti2d_samples_equal_jax(stf_pkls, test_mode):
    files = ['dense_infos_train.pkl', 'dense_infos_snow.pkl']
    got = kitti2d.Kitti2DDataset(files, STF_CLASSES, data_root=stf_pkls,
                                 test_mode=test_mode)
    want = jax_kitti2d.Kitti2DDataset(files, STF_CLASSES, data_root=stf_pkls,
                                      test_mode=test_mode)
    _same_dataset(got, want)
    assert len(got) == (5 if test_mode else 3)
    assert got.sample(0)['gated_prefix'] == stf_pkls


def _wrapped(mods, coco_json, stf_pkls, kind):
    m_coco, m_kitti, m_wrap = mods
    a = m_coco.CocoFusionDataset('ann.json', CLASSES, data_root=coco_json)
    b = m_coco.CocoFusionDataset('ann.json', CLASSES, data_root=coco_json,
                                 test_mode=True)
    if kind == 'concat':
        return m_wrap.ConcatDataset([a, b, a])
    if kind == 'repeat':
        return m_wrap.RepeatDataset(b, 3)
    if kind == 'concat stf':
        return m_wrap.ConcatDataset([m_kitti.Kitti2DDataset(
            f, STF_CLASSES, data_root=stf_pkls, test_mode=True)
            for f in ('dense_infos_snow.pkl', 'dense_infos_train.pkl')])
    return m_wrap.ClassBalancedDataset(a, oversample_thr=float(kind[-3:]))


@pytest.mark.parametrize('kind', ['concat', 'repeat', 'concat stf',
                                  'balanced 0.3', 'balanced 0.9'])
def test_wrappers_equal_jax(coco_json, stf_pkls, kind):
    got = _wrapped((coco, kitti2d, wrappers), coco_json, stf_pkls, kind)
    want = _wrapped((jax_coco, jax_kitti2d, jax_wrappers), coco_json,
                    stf_pkls, kind)
    _same_dataset(got, want)
    if kind.startswith('balanced'):
        assert got.indices == want.indices
        # 0.3: every class is in at least 0.3 of the images, none repeats
        assert (len(got) > len(got.dataset)) == (kind == 'balanced 0.9')
    if kind == 'concat':
        assert got.cumulative == want.cumulative == [5, 11, 16]


def test_empty_concat_raises():
    with pytest.raises(ValueError):
        wrappers.ConcatDataset([])


# the split files of `tools/test.py:98-140` and `tools/train.py:138-210`
JAX_SPLITS = {
    ('nuscenes', 'train'): ['nuscenes_infos_train_mono3d.coco.json'],
    ('nuscenes', 'val'): ['nuscenes_infos_val_mono3d.coco.json'],
    ('nuscenes', 'test'): ['nuscenes_infos_val_mono3d.coco.json'],
    ('stf', 'train'): ['dense_infos_train.pkl'],
    ('stf', 'val'): ['dense_infos_val.pkl'],
    ('stf', 'test'): ['dense_infos_test_clear.pkl',
                      'dense_infos_light_fog.pkl',
                      'dense_infos_dense_fog.pkl', 'dense_infos_snow.pkl']}


@pytest.fixture(scope='module')
def split_roots(tmp_path_factory):
    """A folder a dataset, each split file of a different length."""
    nus = tmp_path_factory.mktemp('nus_splits')
    for n, name in enumerate(sorted({f for (d, _), fs in JAX_SPLITS.items()
                                     if d == 'nuscenes' for f in fs}), 2):
        write_nuscenes(nus, n, (45, 80), (18, 32), CLASSES, seed=n,
                       splits=(name,))
    stf = tmp_path_factory.mktemp('stf_splits')
    for n, name in enumerate(sorted({f for (d, _), fs in JAX_SPLITS.items()
                                     if d == 'stf' for f in fs}), 2):
        write_stf(stf, n, (45, 80), (18, 32), STF_CLASSES, seed=n,
                  splits=(name,))
    return {'nuscenes': str(nus), 'stf': str(stf)}


@pytest.mark.parametrize('dataset,split', sorted(JAX_SPLITS))
def test_build_dataset_reads_the_jax_split_files(split_roots, dataset,
                                                 split):
    classes = CLASSES if dataset == 'nuscenes' else STF_CLASSES
    root = split_roots[dataset]
    files = JAX_SPLITS[dataset, split]
    test_mode = split != 'train'
    got = build_dataset(SimpleNamespace(dataset=dataset, classes=classes),
                        root, split)
    if dataset == 'stf':
        want = jax_kitti2d.Kitti2DDataset(files, classes, data_root=root,
                                          test_mode=test_mode)
    else:
        want = jax_coco.CocoFusionDataset(files[0], classes, data_root=root,
                                          test_mode=test_mode)
    assert got.test_mode == test_mode
    _same_dataset(got, want)
