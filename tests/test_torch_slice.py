"""The ported eval slice vs the JAX detector on `tiny_fusion_test`.

JAX variables (the exact `init` tree, numpy-filled) -> bridge -> port;
both packages then run the same 64x96 batch-1 inputs at f32 on CPU, the
JAX side un-jitted, with its CPU routing (flax blocks, gather RoIAlign).
The JAX config pools in f32 (`gather_bf16=False`) so both sides compute
the same function. Tolerances are the ones `test_full_model_parity.py`
established for a torch rebuild of this model.

`roi.sample_num=0` (adaptive RoIAlign, `max_grid` 4) on the same
weights and maps: JAX pools it in eval with its gather formulation
(`hrfuser_tpu/models/roi_heads/cascade_roi_head.py:117-120`), the route
its reference parity uses (`tests/test_full_model_parity.py:47`); the
port with `hrfuser::roi_align`, here its CPU twin. The port's `predict`
and a `torch.export` program of it (carrying the op's `sample_num` 0,
`max_grid` 4 and `aligned`) equal JAX's `roi_test` on JAX's proposals at
`slice_pair`'s tolerances, and differ from the port's own 2x2 pool.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrfuser_tpu.configs import get_config as jax_get_config
from hrfuser_tpu.models import CascadeRCNN as JaxCascadeRCNN
from hrfuser_tpu.models import predict as jax_predict
from hrfuser_tpu.models.dense_heads.rpn_head import get_proposals_single
from hrfuser_tpu_torch.apis.export import export_predict
from hrfuser_tpu_torch.apis.inference import Detector
from hrfuser_tpu_torch.configs import get_config, get_experiment
from hrfuser_tpu_torch.models.detectors.cascade_rcnn import (CascadeRCNN,
                                                             predict)
from hrfuser_tpu_torch.utils.jax_weights import state_dict_from_jax
from tests.oracles.random_variables import random_variables
from tests.oracles.slice_pair import assert_detections_close

NAME = 'tiny_fusion_test'
H, W = 64, 96


class _Slice:
    def __init__(self):
        jcfg = jax_get_config(NAME).model
        self.jcfg = dataclasses.replace(
            jcfg, roi=dataclasses.replace(jcfg.roi, gather_bf16=False))
        self.jdet = JaxCascadeRCNN(self.jcfg)
        rng = np.random.default_rng(3)
        self.img = rng.normal(0, 1, (1, H, W, 3)).astype(np.float32)
        self.mods = [rng.normal(0, 1, (1, H, W, 3)).astype(np.float32)
                     for _ in range(2)]
        self.variables = random_variables(
            self.jdet, jnp.asarray(self.img),
            [jnp.asarray(m) for m in self.mods], False, seed=5)
        self.model = CascadeRCNN(get_config(NAME)).eval()
        self.model.load_state_dict(
            state_dict_from_jax(self.variables, self.model.cfg), strict=True)
        self.jfeats, self.jcls, self.jreg = self.jdet.apply(
            self.variables, jnp.asarray(self.img),
            [jnp.asarray(m) for m in self.mods], False,
            method='forward_features')
        with torch.no_grad():
            self.feats, self.cls, self.reg = self.model.forward_features(
                torch.from_numpy(self.img),
                [torch.from_numpy(m) for m in self.mods])


@pytest.fixture(scope='module')
def s():
    return _Slice()


@pytest.mark.parametrize('lvl', range(5))
def test_neck_and_rpn_maps_match_jax(s, lvl):
    for name, got, want in (('neck', s.feats, s.jfeats),
                            ('rpn cls', s.cls, s.jcls),
                            ('rpn reg', s.reg, s.jreg)):
        np.testing.assert_allclose(got[lvl].numpy(), np.asarray(want[lvl]),
                                   atol=5e-3, rtol=1e-3,
                                   err_msg=f'{name} level {lvl}')


def _jax_proposals(s):
    cfg = s.jcfg
    anchors = [jnp.asarray(a) for a in cfg.anchor_generator().grid_anchors(
        [tuple(f.shape[1:3]) for f in s.jfeats])]
    return get_proposals_single(
        [c[0] for c in s.jcls], [r[0] for r in s.jreg], anchors,
        (jnp.float32(H), jnp.float32(W)), nms_pre=cfg.rpn_test.nms_pre,
        max_per_img=cfg.rpn_test.max_per_img, nms_iou=cfg.rpn_test.nms_iou)


def test_decode_cascade_matches_jax_on_identical_proposals(s):
    props = _jax_proposals(s)
    want_boxes, want_scores = s.jdet.apply(
        s.variables, [f[0] for f in s.jfeats[:4]], props.boxes, props.valid,
        (jnp.float32(H), jnp.float32(W)), method='roi_decode')
    valid = np.asarray(props.valid)
    assert valid.sum() > 10
    with torch.no_grad():
        boxes, scores = s.model.roi_head.decode_cascade(
            s.feats[:4], torch.tensor(np.asarray(props.boxes))[None],
            torch.tensor(valid)[None], torch.tensor([[H, W]]).float())
    np.testing.assert_allclose(boxes[0].numpy()[valid],
                               np.asarray(want_boxes)[valid], atol=0.15,
                               rtol=1e-3)
    np.testing.assert_allclose(scores[0].numpy()[valid],
                               np.asarray(want_scores)[valid], atol=5e-3,
                               rtol=0)


def test_predict_detections_match_jax(s):
    want = jax_predict(s.jdet, s.variables, jnp.asarray(s.img),
                       [jnp.asarray(m) for m in s.mods])
    with torch.no_grad():
        got = predict(s.model, torch.from_numpy(s.img),
                      [torch.from_numpy(m) for m in s.mods])
    assert got.boxes.shape == (1, 20, 4)
    valid = np.asarray(want.valid)
    assert valid.sum() > 0
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               atol=1e-2, rtol=0)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-4, rtol=0)


def _adaptive(cfg):
    return dataclasses.replace(cfg, roi=dataclasses.replace(cfg.roi,
                                                            sample_num=0))


@pytest.fixture(scope='module')
def adaptive(s):
    """The port's `sample_num=0` model on the slice's weights, and JAX's
    `sample_num=0` detections on its own proposals from its maps."""
    model = CascadeRCNN(_adaptive(get_config(NAME))).eval()
    model.load_state_dict(s.model.state_dict())
    props = _jax_proposals(s)
    want = JaxCascadeRCNN(_adaptive(s.jcfg)).apply(
        s.variables, [f[0] for f in s.jfeats[:4]], props.boxes, props.valid,
        (jnp.float32(H), jnp.float32(W)), jnp.ones(4, jnp.float32), True,
        method='roi_test')
    return model, want


def _inputs(s):
    return torch.from_numpy(s.img), [torch.from_numpy(m) for m in s.mods]


def test_adaptive_predict_matches_jax_gather_route(s, adaptive):
    model, want = adaptive
    assert model.cfg.roi.sample_num == 0 and model.cfg.roi.max_grid == 4
    with torch.no_grad():
        got = predict(model, *_inputs(s))
    assert_detections_close(got, want, s.jcfg.roi.max_per_img)


def test_adaptive_grid_changes_the_cascade(s, adaptive):
    props = _jax_proposals(s)
    valid = torch.tensor(np.asarray(props.valid))[None]
    boxes = torch.tensor(np.asarray(props.boxes))[None]
    hw = torch.tensor([[H, W]]).float()
    with torch.no_grad():
        scores = [m.roi_head.decode_cascade(s.feats[:4], boxes, valid, hw)[1]
                  for m in (adaptive[0], s.model)]
    assert (scores[0] - scores[1])[valid].abs().max() > 1e-4


def test_exported_adaptive_program_matches_eager_and_jax(s, adaptive,
                                                         tmp_path):
    model, want = adaptive
    det = Detector(model, get_experiment(NAME).data, torch.device('cpu'))
    program = export_predict(det, 1, (H, W))
    calls = [n.args for n in program.graph.nodes
             if n.op == 'call_function' and 'roi_align' in str(n.target)]
    assert len(calls) == 3
    assert all(a[4:8] == (0, 56, 4, True) for a in calls), calls
    torch.export.save(program, tmp_path / 'adaptive.pt2')
    run = torch.export.load(tmp_path / 'adaptive.pt2').module()
    img, mods = _inputs(s)
    with torch.no_grad():
        got = run(img, *mods)
        eager = predict(model, img, mods)
    for k in got._fields:
        assert torch.equal(getattr(got, k), getattr(eager, k)), k
    assert_detections_close(got, want, s.jcfg.roi.max_per_img)
