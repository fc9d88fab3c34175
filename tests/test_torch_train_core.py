"""The port's assigner, sampler, targets, losses and `bbox2delta` vs the
JAX package's (`hrfuser_tpu.core.*`, `hrfuser_tpu.ops.boxes`).

The cases of the JAX `tests/test_train_components.py` (slow-marked there)
plus seeded random ones, each run through both packages on the same
inputs; the sampler takes JAX's own uniforms (the split chain of
`samplers.py:37-47`), so both sample the same rows. Integer outputs and
masks must be equal, floats within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrfuser_tpu.core import assigners as jax_assigners
from hrfuser_tpu.core import losses as jax_losses
from hrfuser_tpu.core import samplers as jax_samplers
from hrfuser_tpu.core import targets as jax_targets
from hrfuser_tpu.ops.boxes import bbox2delta as jax_bbox2delta
from hrfuser_tpu_torch.core import losses, targets
from hrfuser_tpu_torch.core.assigners import max_iou_assign
from hrfuser_tpu_torch.core.samplers import random_sample, select_fixed
from hrfuser_tpu_torch.ops.boxes import bbox2delta

TOL = 1e-6


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """One intra-op thread: the tensors are small, and the test workers
    run side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _same(got, want, tol=TOL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype.kind in 'biu':
        np.testing.assert_array_equal(got.astype(want.dtype), want)
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _jax_uniforms(key, n):
    """The (positive, negative) keys JAX's `random_sample(key, ...)`
    draws."""
    kp, kn = jax.random.split(key)
    return tuple(_t(jax.random.uniform(k, (n,))) for k in (kp, kn))


def _boxes(rng, n, lo=0., hi=90., size=(8., 40.)):
    xy = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(*size, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


# (gt boxes, labels, gt_valid, boxes, box_valid, pos, neg, min_pos, lowq)
_ASSIGN = {
    'basic': ([[0., 0., 100., 100.], [200., 200., 300., 300.]], [3, 7],
              [True, True], [[0., 0., 100., 100.], [0., 0., 50., 100.],
                             [500., 500., 600., 600.],
                             [190., 190., 290., 290.]],
              [True] * 4, 0.7, 0.3, 0.3, True),
    'low_quality': ([[0., 0., 60., 60.]], [1], [True],
                    [[0., 0., 100., 100.], [300., 300., 400., 400.]],
                    [True, True], 0.7, 0.3, 0.3, True),
    'no_low_quality': ([[0., 0., 60., 60.]], [1], [True],
                       [[0., 0., 100., 100.], [300., 300., 400., 400.]],
                       [True, True], 0.7, 0.3, 0.3, False),
    'invalid_gt_ignored': ([[0., 0., 100., 100.], [0., 0., 100., 100.]],
                           [0, 5], [False, True], [[0., 0., 100., 100.]],
                           [True], 0.7, 0.3, 0.3, True),
    'all_gts_invalid': ([[0.] * 4] * 3, [0, 0, 0], [False] * 3,
                        [[0., 0., 10., 10.], [5., 5., 30., 30.]],
                        [True, True], 0.7, 0.3, 0.3, True),
}


def _random_assign_case(seed, lowq):
    rng = np.random.default_rng(seed)
    gts = _boxes(rng, 6)
    gts[4:] = 0.                                   # two padded gt slots
    boxes = np.concatenate([_boxes(rng, 300), gts[:2] + 1.0])
    valid = rng.random(len(boxes)) > 0.1
    return (gts, rng.integers(0, 10, 6), [True] * 4 + [False] * 2, boxes,
            valid, 0.5, 0.4, 0.3, lowq)


_ASSIGN.update({f'random{s}_{lq}': _random_assign_case(s, lq)
                for s in (0, 1) for lq in (True, False)})


@pytest.mark.parametrize('case', sorted(_ASSIGN))
def test_max_iou_assign_matches_jax(case):
    gt, lab, gtv, boxes, bv, pos, neg, minp, lowq = _ASSIGN[case]
    args = [np.asarray(gt, np.float32), np.asarray(lab, np.int32),
            np.asarray(gtv, bool), np.asarray(boxes, np.float32),
            np.asarray(bv, bool)]
    want = jax_assigners.max_iou_assign(*map(jnp.asarray, args), pos, neg,
                                        minp, lowq)
    got = max_iou_assign(*map(_t, args), pos, neg, minp, lowq)
    for g, w in zip(got, want):
        _same(g, w)


# (key, number of positive / negative candidates, then filler, num, frac)
_SAMPLE = {
    'quota': (0, 300, 700, 0, 256, 0.5),
    'few_positives': (1, 10, 990, 0, 256, 0.5),
    'fewer_than_quota': (2, 2, 2, 1, 4, 0.5),
    'rcnn_quota': (3, 40, 300, 60, 512, 0.25),
    'no_positives': (4, 0, 50, 20, 64, 0.5),
}


@pytest.mark.parametrize('case', sorted(_SAMPLE))
def test_random_sample_and_select_fixed_match_jax(case):
    seed, npos, nneg, other, num, frac = _SAMPLE[case]
    rng = np.random.default_rng(seed)
    kind = rng.permutation(np.repeat([0, 1, 2], [npos, nneg, other]))
    pos, neg = kind == 0, kind == 1
    key = jax.random.PRNGKey(seed)
    want = jax_samplers.random_sample(key, jnp.asarray(pos),
                                      jnp.asarray(neg), num, frac)
    got = random_sample(_jax_uniforms(key, len(kind)), _t(pos), _t(neg),
                        num, frac)
    for g, w in zip(got, want):
        _same(g, w)
    assert int(got.num_pos) == min(npos, int(num * frac))
    for n_out in (num, len(kind) + 3):
        for g, w in zip(select_fixed(got, n_out),
                        jax_samplers.select_fixed(want, n_out)):
            _same(g, w)


@pytest.mark.parametrize('seed', [0, 1])
def test_rpn_targets_match_jax(seed):
    rng = np.random.default_rng(seed)
    anchors = (rng.uniform(-10, 90, (500, 2)).repeat(2, 1)
               + np.asarray([0., 0., 30., 30.])).astype(np.float32)
    flags = rng.random(500) > 0.05
    gt = np.asarray([[10., 10., 45., 45.], [40., 50., 95., 100.],
                     [0., 0., 0., 0.]], np.float32)
    gtv = np.asarray([True, True, False])
    key = jax.random.PRNGKey(seed)
    want = jax_targets.rpn_targets_single(
        key, jnp.asarray(anchors), jnp.asarray(flags), jnp.asarray(gt),
        jnp.asarray(gtv), (128., 120.))
    got = targets.rpn_targets_single(
        _jax_uniforms(key, 500), _t(anchors), _t(flags), _t(gt), _t(gtv),
        torch.tensor([128., 120.]))
    assert float(got.num_samples) <= 256 and float(got.bbox_weights.sum()) > 0
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize('stage', range(3))
def test_rcnn_stage_targets_match_jax(stage):
    rng = np.random.default_rng(stage)
    props = (rng.uniform(0, 80, (200, 2)).repeat(2, 1)
             + np.asarray([0., 0., 40., 40.])).astype(np.float32)
    pvalid = rng.random(200) > 0.1
    gt = np.asarray([[10., 10., 50., 50.], [60., 60., 100., 100.],
                     [0., 0., 0., 0.]], np.float32)
    labels = np.asarray([2, 5, 0], np.int32)
    gtv = np.asarray([True, True, False])
    key = jax.random.PRNGKey(10 + stage)
    stds = (0.1, 0.1, 0.2, 0.2)
    jcfg = jax_targets.RCNN_TRAIN_CFGS[stage]
    want = jax_targets.rcnn_stage_targets_single(
        key, jnp.asarray(props), jnp.asarray(pvalid), jnp.asarray(gt),
        jnp.asarray(labels), jnp.asarray(gtv), num_classes=10, stds=stds,
        cfg=jcfg)
    got = targets.rcnn_stage_targets_single(
        _jax_uniforms(key, 203), _t(props), _t(pvalid), _t(gt), _t(labels),
        _t(gtv), 10, stds, targets.RCNN_TRAIN_CFGS[stage])
    assert tuple(got.rois.shape) == (512, 4)
    assert int(got.is_gt.sum()) == 2
    assert set(got.labels[got.labels < 10].tolist()) <= {2, 5}
    for g, w in zip(got, want):
        _same(g, w)


def test_train_cfgs_equal_jax():
    assert targets.RPN_TRAIN_CFG.__dict__ == jax_targets.RPN_TRAIN_CFG.__dict__
    assert ([c.__dict__ for c in targets.RCNN_TRAIN_CFGS]
            == [c.__dict__ for c in jax_targets.RCNN_TRAIN_CFGS])


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_bbox2delta_matches_jax(seed):
    rng = np.random.default_rng(seed)
    props, gt = _boxes(rng, 64), _boxes(rng, 64)
    props[:3] = [[5., 5., 5., 9.], [0., 0., 0., 0.], [3., 4., 8., 4.]]
    stds = (0.1, 0.1, 0.2, 0.2) if seed else (1., 1., 1., 1.)
    _same(bbox2delta(_t(props), _t(gt), stds=stds),
          jax_bbox2delta(jnp.asarray(props), jnp.asarray(gt), stds=stds))


def _loss_inputs(seed):
    rng = np.random.default_rng(seed)
    return dict(
        logits=(rng.normal(0, 3, (40,))).astype(np.float32),
        targets=(rng.random(40) > 0.5).astype(np.float32),
        weights=(rng.random(40) > 0.3).astype(np.float32),
        cls_logits=rng.normal(0, 2, (40, 11)).astype(np.float32),
        labels=rng.integers(0, 11, 40).astype(np.int32),
        pred=rng.normal(0, 1, (40, 4)).astype(np.float32),
        target=rng.normal(0, 1, (40, 4)).astype(np.float32),
        bw=(rng.random((40, 4)) > 0.5).astype(np.float32))


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('name', ['sigmoid_bce', 'softmax_ce', 'smooth_l1',
                                  'smooth_l1_ninth', 'accuracy'])
def test_losses_match_jax(name, seed):
    x = _loss_inputs(seed)
    avg = float(x['weights'].sum())
    calls = {
        'sigmoid_bce': lambda m, a: m.sigmoid_bce(
            a(x['logits']), a(x['targets']), a(x['weights']), avg),
        'softmax_ce': lambda m, a: m.softmax_ce(
            a(x['cls_logits']), a(x['labels']), a(x['weights']), avg),
        'smooth_l1': lambda m, a: m.smooth_l1(
            a(x['pred']), a(x['target']), a(x['bw']), avg, beta=1.0),
        'smooth_l1_ninth': lambda m, a: m.smooth_l1(
            a(x['pred']), a(x['target']), a(x['bw']), avg, beta=1.0 / 9.0),
        'accuracy': lambda m, a: m.accuracy(
            a(x['cls_logits']), a(x['labels']), a(x['weights'])),
    }
    _same(calls[name](losses, _t), calls[name](jax_losses, jnp.asarray))


def test_loss_values_of_the_jax_test():
    assert float(losses.sigmoid_bce(torch.tensor([10., -10.]),
                                    torch.tensor([1., 0.]), torch.ones(2),
                                    2.0)) < 1e-3
    assert float(losses.softmax_ce(torch.tensor([[10., 0., 0.]]),
                                   torch.tensor([0]), torch.ones(1),
                                   1.0)) < 1e-3
    sl = losses.smooth_l1(torch.tensor([[1.0]]), torch.tensor([[0.0]]),
                          torch.ones((1, 1)), 1.0, beta=1.0)
    assert abs(float(sl) - 0.5) < 1e-6
