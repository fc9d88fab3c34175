"""The port's KITTI-2D evaluation half equals the JAX package's.

`evaluation/kitti_eval.py` (a copy of the JAX evaluator), the annotation
half of `data/datasets/kitti2d.py:Kitti2DDataset` and
`apis/test.py:evaluate_stf`, each against its JAX original on the same
inputs: the cases of `tests/test_evaluation.py`, seeded random annos, and
the synthetic `dense_infos` pickles of `tests/test_kitti2d_dataset.py`.
Pure numpy on both sides, so every result is held equal exactly.
"""

import pickle

import numpy as np
import pytest

from hrfuser_tpu.apis import test as jax_test
from hrfuser_tpu.data.datasets.kitti2d import Kitti2DDataset as JaxKitti
from hrfuser_tpu.evaluation.kitti_eval import kitti_eval_2d as jax_eval
from hrfuser_tpu_torch.apis import test as port_test
from hrfuser_tpu_torch.configs import get_experiment
from hrfuser_tpu_torch.data.datasets.kitti2d import Kitti2DDataset
from hrfuser_tpu_torch.evaluation.kitti_eval import kitti_eval_2d
from tests.test_evaluation import _many
from tests.test_kitti2d_dataset import CLASSES, _info

STF = ['Pedestrian', 'Cyclist', 'Car']
CROP = (384, 1248, 394, 296)


def _same(got, want):
    """Equal nested dicts / arrays, exactly (names, dtypes, values)."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _dontcare(n=50):
    gts, dts = _many(n)
    for g, d in zip(gts, dts):
        g['name'] = np.array(['Car', 'DontCare'])
        g['bbox'] = np.vstack([g['bbox'], [[300, 0, 400, 60.]]])
        g['occluded'] = np.array([0, -1])
        g['truncated'] = np.zeros(2)
        d['name'] = np.array(['Car', 'Car'])
        d['bbox'] = np.vstack([d['bbox'], [[300, 0, 400, 60.]]])
        d['score'] = np.append(d['score'], d['score'][0] - 0.001)
    return gts, dts


def _random_annos(seed, n_img=30):
    """GT with every class, neighbour classes, DontCare, occlusion and
    truncation levels and heights around the gates; detections near the
    GT (jittered), some with other labels, plus false positives."""
    rng = np.random.default_rng(seed)
    names = np.array(STF + ['Van', 'Person_sitting', 'DontCare', 'Truck'])
    gts, dts = [], []
    for _ in range(n_img):
        n = rng.integers(0, 8)
        xy = rng.uniform(0, 1000, (n, 2))
        wh = rng.uniform(10, 120, (n, 2))
        box = np.concatenate([xy, xy + wh], 1)
        gts.append(dict(name=rng.choice(names, n), bbox=box,
                        occluded=rng.integers(0, 3, n).astype(float),
                        truncated=rng.uniform(0, 0.6, n)))
        keep = rng.random(n) < 0.8
        det = box[keep] + rng.normal(0, 3, (int(keep.sum()), 4))
        # a kept GT's own class where it is one of STF's, else any
        det_names = [g if g in STF else rng.choice(STF)
                     for g in gts[-1]['name'][keep]]
        fp = rng.integers(0, 3)
        fxy = rng.uniform(0, 1000, (fp, 2))
        det = np.concatenate([det, np.concatenate(
            [fxy, fxy + rng.uniform(20, 90, (fp, 2))], 1)])
        dts.append(dict(name=np.array(det_names + list(
                            rng.choice(STF, fp)), dtype=str),
                        bbox=det, score=rng.uniform(0.05, 1, len(det))))
    return gts, dts


CASES = {
    'perfect': lambda: _many(50),
    'single_gt': lambda: ([dict(name=np.array(['Car']),
                                bbox=np.array([[0, 0, 100, 60.]]),
                                occluded=np.zeros(1),
                                truncated=np.zeros(1))],
                          [dict(name=np.array(['Car']),
                                bbox=np.array([[0, 0, 100, 60.]]),
                                score=np.array([0.9]))]),
    'difficulty_gates': lambda: _many(50, h=30.0),
    'dontcare': _dontcare,
    'random_0': lambda: _random_annos(0),
    'random_1': lambda: _random_annos(1),
    'random_2': lambda: _random_annos(2, n_img=60),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_kitti_eval_2d_equals_jax(case):
    gts, dts = CASES[case]()
    got = kitti_eval_2d(gts, dts, STF)
    assert got == jax_eval(gts, dts, STF)
    assert len(got) == 3 * 3 + 1
    if case.startswith('random'):                # not a degenerate case
        assert 0 < got['mAP_2d_moderate'] < 100


@pytest.fixture
def pkl_files(tmp_path):
    """`tests/test_kitti2d_dataset.py`'s pickles: a train split with an
    empty frame and a DontCare box, and two weather splits."""
    train = [
        _info('a', [[100., 100., 300., 260.]], ['PassengerCar']),
        _info('b', [], []),
        _info('c', [[0., 0., 50., 50.], [400., 300., 480., 420.]],
              ['DontCare', 'Pedestrian']),
        _info('f', [[300., 400., 700., 600.], [1500., 700., 1600., 790.]],
              ['RidableVehicle', 'PassengerCar']),
    ]
    split1 = [_info('d', [[10., 10., 60., 60.]], ['PassengerCar'])]
    split2 = [_info('e', [[20., 20., 70., 70.]], ['Pedestrian'])]
    paths = []
    for name, infos in (('train.pkl', train), ('s1.pkl', split1),
                        ('s2.pkl', split2)):
        p = tmp_path / name
        with open(p, 'wb') as f:
            pickle.dump(infos, f)
        paths.append(str(p))
    return paths


@pytest.mark.parametrize('files,test_mode', [(slice(0, 1), False),
                                             (slice(0, 1), True),
                                             (slice(1, 3), True)])
def test_dataset_annotations_equal_jax(pkl_files, files, test_mode):
    ds = Kitti2DDataset(pkl_files[files], CLASSES, test_mode=test_mode)
    ref = JaxKitti(pkl_files[files], CLASSES, test_mode=test_mode)
    assert len(ds) == len(ref)
    for i in range(len(ds)):
        _same(ds.get_ann_info(i), ref.get_ann_info(i))
    for crop in (None, CROP):
        got, want = ds.gt_annos(crop=crop), ref.gt_annos(crop=crop)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)


def _detections(n_img, seed):
    """Padded detection arrays in the original frame (some invalid)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 1700, (n_img, 12, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(20, 200, (n_img, 12, 2))],
                           -1).astype(np.float32)
    return (boxes, rng.uniform(0, 1, (n_img, 12)).astype(np.float32),
            rng.integers(0, 3, (n_img, 12)), rng.random((n_img, 12)) < 0.7)


def test_detections_to_kitti_equals_jax(pkl_files):
    ds = Kitti2DDataset(pkl_files[0], CLASSES, test_mode=True)
    ref = JaxKitti(pkl_files[0], CLASSES, test_mode=True)
    dets = _detections(len(ds), 0)
    got, want = ds.detections_to_kitti(*dets), ref.detections_to_kitti(*dets)
    assert len(got) == len(want) == len(ds)
    for g, w in zip(got, want):
        _same(g, w)


def test_evaluate_stf_equals_jax(pkl_files):
    ds = Kitti2DDataset(pkl_files[0], CLASSES, test_mode=True)
    ref = JaxKitti(pkl_files[0], CLASSES, test_mode=True)
    boxes, scores, labels, valid = _detections(len(ds), 1)
    # a detection on each GT box (in the uncropped frame), so the APs are
    # not all zero
    for i, info in enumerate(ds.data_infos):
        for j, (box, name) in enumerate(zip(info['annos']['bbox'],
                                            info['annos']['name'])):
            if name in CLASSES:
                boxes[i, j], labels[i, j] = box, CLASSES.index(name)
                valid[i, j], scores[i, j] = True, 0.95
    results = [dict(boxes=b[v], scores=s[v], labels=lb[v], meta=None)
               for b, s, lb, v in zip(boxes, scores, labels, valid)]
    for crop in (None, CROP):
        got = port_test.evaluate_stf(results, ds, CLASSES, crop)
        assert got == jax_test.evaluate_stf(results, ref, CLASSES, crop)
        assert len(got) == 10 and all(np.isfinite(v) for v in got.values())
    assert port_test.evaluate_stf(results, ds, CLASSES)['mAP_2d_moderate'] > 0


def test_evaluate_dispatches_stf_to_kitti(pkl_files):
    exp = get_experiment('cascade_rcnn_hrfuser_t_1x_stf_r1248_4mod')
    ds = Kitti2DDataset(pkl_files[0], exp.data.classes, test_mode=True)
    results = [dict(boxes=np.zeros((0, 4), np.float32),
                    scores=np.zeros(0, np.float32),
                    labels=np.zeros(0, np.int64), meta=None)] * len(ds)
    got = port_test.evaluate(exp, results, ds)
    assert got == port_test.evaluate_stf(results, ds, exp.data.classes,
                                         exp.data.eval_on_crop)
    assert set(got) == {f'{c}_2d_{d}' for c in exp.data.classes
                        for d in ('easy', 'moderate', 'hard')} | {
                            'mAP_2d_moderate'}
