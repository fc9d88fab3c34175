"""The port's copies of the evaluators equal the JAX package's.

`hrfuser_tpu_torch.evaluation.{coco_map,recall}` against
`hrfuser_tpu.evaluation.{coco_map,recall}` on the fixtures of
`tests/test_evaluation.py` (COCO cases), `tests/test_eval_recall.py` and
`tests/test_eval_differential.py`'s COCOeval-oracle cases, to 1e-6; the
oracles hold the port's numbers too.
"""

import numpy as np
import pytest

from hrfuser_tpu.evaluation import coco_map as jax_coco
from hrfuser_tpu.evaluation import recall as jax_recall
from hrfuser_tpu_torch.evaluation import coco_map, recall
from tests.oracles.coco_eval_oracle import coco_map_oracle
from tests.oracles.recall_oracle import eval_recalls_oracle
from tests.test_eval_differential import _coco_scene
from tests.test_eval_recall import _rand_boxes, _StubDataset

KEYS = ('mAP', 'mAP_50', 'mAP_75', 'mAP_s', 'mAP_m', 'mAP_l')


def _same(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        if np.isnan(want[k]):
            assert np.isnan(got[k]), k
        else:
            assert got[k] == pytest.approx(want[k], abs=1e-6), k


def _gt(boxes, labels):
    return dict(boxes=np.asarray(boxes, np.float32),
                labels=np.asarray(labels, np.int64))


def _pred(boxes, scores, labels):
    return dict(boxes=np.asarray(boxes, np.float32),
                scores=np.asarray(scores, np.float32),
                labels=np.asarray(labels, np.int64))


# the COCO cases of tests/test_evaluation.py and test_eval_recall.py
COCO_CASES = {
    'perfect': ([_pred([[10, 10, 100, 100], [200, 50, 300, 150]],
                       [0.9, 0.8], [0, 1])],
                [_gt([[10, 10, 100, 100], [200, 50, 300, 150]], [0, 1])],
                2, None),
    'miss_and_fp': ([_pred([[400, 400, 500, 500], [10, 10, 110, 110]],
                           [0.95, 0.9], [0, 0])],
                    [_gt([[10, 10, 110, 110]], [0])], 1, None),
    'localization': ([_pred([[0, 0, 100, 62]], [0.9], [0])],
                     [_gt([[0, 0, 100, 100]], [0])], 1, None),
    'class_subset': ([_pred([[0, 0, 50, 50]], [0.9], [0])],
                     [_gt([[0, 0, 50, 50], [60, 60, 120, 130]], [0, 1])],
                     2, (0,)),
}


@pytest.mark.parametrize('case', sorted(COCO_CASES))
def test_coco_cases_equal_jax(case):
    preds, gts, n, ids = COCO_CASES[case]
    got = coco_map.evaluate_coco_map(preds, gts, n, class_ids=ids)
    _same(got, jax_coco.evaluate_coco_map(preds, gts, n, class_ids=ids))
    if case == 'perfect':
        assert got['mAP'] == pytest.approx(1.0, abs=1e-6)
    if case == 'class_subset':
        assert got['mAP'] == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize('seed', range(30))
def test_coco_map_equals_jax_and_cocoeval_oracle(seed):
    rng = np.random.default_rng(seed)
    num_classes = int(rng.integers(1, 4))
    preds, gts = _coco_scene(rng, num_classes, n_imgs=int(rng.integers(1, 6)),
                             ignore_prob=float(rng.choice([0.0, 0.2, 0.5])))
    got = coco_map.evaluate_coco_map(preds, gts, num_classes)
    _same(got, jax_coco.evaluate_coco_map(preds, gts, num_classes))
    ref = coco_map_oracle(preds, gts, num_classes)
    _same({k: got[k] for k in KEYS}, {k: ref[k] for k in KEYS})


def test_coco_map_duplicate_dets_on_ignored_gt():
    gt = [dict(boxes=np.array([[100., 100., 150., 150.],
                               [300., 100., 350., 160.]]),
               labels=np.array([0, 0]), ignore=np.array([True, False]))]
    pred = [dict(boxes=np.array([[100., 100., 150., 150.],
                                 [101., 101., 151., 151.],
                                 [102., 99., 150., 149.],
                                 [300., 100., 350., 160.]]),
                 scores=np.array([0.9, 0.8, 0.7, 0.95]),
                 labels=np.array([0, 0, 0, 0]))]
    _same(coco_map.evaluate_coco_map(pred, gt, 1),
          jax_coco.evaluate_coco_map(pred, gt, 1))


def _recall_scene(seed):
    rng = np.random.default_rng(seed)
    gts, props = [], []
    for _ in range(6):
        n_gt, n_p = int(rng.integers(0, 10)), int(rng.integers(0, 60))
        g = _rand_boxes(rng, n_gt)
        n_near = min(n_p, n_gt)
        near = g[:n_near] + rng.normal(0, 10, (n_near, 4)).astype(
            np.float32) if n_near else np.zeros((0, 4), np.float32)
        p = np.concatenate([near, _rand_boxes(rng, n_p - n_near)]).clip(
            0, 640)
        p[:, 2] = np.maximum(p[:, 2], p[:, 0] + 1)
        p[:, 3] = np.maximum(p[:, 3], p[:, 1] + 1)
        scores = rng.uniform(0, 1, n_p).astype(np.float32)
        gts.append(g)
        props.append(np.concatenate([p, scores[:, None]], axis=1))
    return gts, props


@pytest.mark.parametrize('seed', range(20))
def test_eval_recalls_equal_jax_and_oracle(seed):
    gts, props = _recall_scene(seed)
    nums, thrs = (5, 20, 50), [0.3, 0.5, 0.7, 0.9]
    got = recall.eval_recalls(gts, props, nums, thrs)
    np.testing.assert_allclose(
        got, jax_recall.eval_recalls(gts, props, nums, thrs), atol=1e-6)
    np.testing.assert_allclose(
        got, eval_recalls_oracle(gts, props, nums, thrs), atol=1e-7)


def test_eval_recalls_unscored_proposals_keep_order():
    gts = [np.asarray([[0., 0., 10., 10.]], np.float32)]
    props = [np.asarray([[100., 100., 110., 110.], [0., 0., 10., 10.]],
                        np.float32)]
    got = recall.eval_recalls(gts, props, (1, 2), 0.5)
    np.testing.assert_array_equal(
        got, jax_recall.eval_recalls(gts, props, (1, 2), 0.5))
    assert got[0, 0] == 0.0 and got[1, 0] == 1.0


@pytest.mark.parametrize('iou_thrs', [0.5, None])
def test_fast_eval_recall_equals_jax(iou_thrs):
    g = np.asarray([[0., 0., 50., 50.], [100., 100., 200., 180.]],
                   np.float32)
    ds = _StubDataset([g, np.zeros((0, 4), np.float32)])
    dets = [np.concatenate([g + 1.0, np.asarray([[0.9], [0.8]], np.float32)],
                           axis=1), np.zeros((0, 5), np.float32)]
    got = recall.fast_eval_recall(ds, dets, (1, 2), iou_thrs)
    assert got == jax_recall.fast_eval_recall(ds, dets, (1, 2), iou_thrs)
    if iou_thrs == 0.5:
        assert got == {'AR@1': 0.5, 'AR@2': 1.0}
