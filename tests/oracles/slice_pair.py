"""One detector config on both packages, with the same weights and inputs.

Test support for the port's slice tests: the JAX variables tree (the
exact `init` tree, numpy-filled) goes through `state_dict_from_jax` into
the port's `CascadeRCNN`, loaded strictly; both packages then run the
same batch-1 f32 inputs on the CPU, the JAX side un-jitted with its CPU
routing (flax blocks, gather RoIAlign) and pooling in f32
(`gather_bf16=False`), so both compute the same function. Each stage of
the eval path is exposed for comparison: backbone branches, neck and RPN
maps, proposals, the cascade decode on identical proposals, and the
final `Detections`; `check_*` hold each to `tests/test_torch_slice.py`'s
tolerances: maps 5e-3 absolute and 1e-3 relative (proposals, each
package's from its own maps, too); the cascade decode on identical
proposals boxes 0.15 px (1e-3 relative) and scores 5e-3; final
detections boxes 1e-2 px with the decode's 1e-3 relative (the cascade's
exp of the deltas scales a box's error with its size) and scores 1e-4
unless the caller sets another tolerance.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import torch

from hrfuser_tpu.models import CascadeRCNN as JaxCascadeRCNN
from hrfuser_tpu.models.dense_heads.rpn_head import get_proposals_single
from hrfuser_tpu_torch.models.dense_heads.rpn_head import get_proposals
from hrfuser_tpu_torch.models.detectors.cascade_rcnn import (CascadeRCNN,
                                                             predict)
from hrfuser_tpu_torch.utils.jax_weights import state_dict_from_jax
from tests.oracles.random_variables import random_variables


class SlicePair:
    def __init__(self, jax_model_cfg, port_model_cfg, hw, seed=3):
        self.h, self.w = hw
        self.jcfg = dataclasses.replace(
            jax_model_cfg, roi=dataclasses.replace(jax_model_cfg.roi,
                                                   gather_bf16=False))
        self.jdet = JaxCascadeRCNN(self.jcfg)
        bb = port_model_cfg.backbone
        rng = np.random.default_rng(seed)
        self.img = rng.normal(0, 1, (1, *hw, 3)).astype(np.float32)
        self.mods = [rng.normal(0, 1, (1, *hw, c)).astype(np.float32)
                     for c in bb.mod_in_channels[:bb.num_fused_modalities]]
        self.variables = random_variables(self.jdet, self._jimg,
                                          self._jmods, False, seed=5)
        self.model = CascadeRCNN(port_model_cfg).eval()
        self.model.load_state_dict(
            state_dict_from_jax(self.variables, port_model_cfg), strict=True)

    @property
    def _jimg(self):
        return jnp.asarray(self.img)

    @property
    def _jmods(self):
        return [jnp.asarray(m) for m in self.mods] or None

    def _tmods(self):
        return [torch.from_numpy(m) for m in self.mods]

    @functools.cached_property
    def _jax_features(self):
        """JAX's forward_features and, captured on the way, its backbone
        outputs (one pass: the un-jitted JAX forward is the slow part)."""
        out, state = self.jdet.apply(
            self.variables, self._jimg, self._jmods, False,
            method='forward_features',
            capture_intermediates=lambda mdl, name: (
                mdl.name == 'backbone' and name == '__call__'))
        return out, state['intermediates']['backbone']['__call__'][0]

    @functools.cached_property
    def backbone(self):
        """(port, JAX) backbone outputs, one map per branch."""
        with torch.no_grad():
            b = self.model.backbone
            img = torch.from_numpy(self.img)
            got = b(img, self._tmods()) if self.mods else b(img)
        return got, self._jax_features[1]

    @functools.cached_property
    def features(self):
        """(port, JAX) (neck levels, RPN cls, RPN reg)."""
        with torch.no_grad():
            got = self.model.forward_features(torch.from_numpy(self.img),
                                              self._tmods())
        return got, self._jax_features[0]

    @functools.cached_property
    def proposals(self):
        """(port, JAX) proposals of image 0, each from its own maps."""
        (feats, cls, reg), (jfeats, jcls, jreg) = self.features
        r = self.jcfg.rpn_test
        gen = self.jcfg.anchor_generator()
        janchors = gen.grid_anchors([tuple(f.shape[1:3]) for f in jfeats])
        want = get_proposals_single(
            [c[0] for c in jcls], [t[0] for t in jreg],
            [jnp.asarray(a) for a in janchors],
            (jnp.float32(self.h), jnp.float32(self.w)), nms_pre=r.nms_pre,
            max_per_img=r.max_per_img, nms_iou=r.nms_iou)
        anchors = self.model.cfg.anchor_generator().grid_anchors(
            [tuple(f.shape[1:3]) for f in feats])
        with torch.no_grad():
            got = get_proposals(cls, reg, [torch.from_numpy(a)
                                           for a in anchors],
                                torch.tensor([[self.h, self.w]]).float(),
                                r.nms_pre, r.max_per_img, r.nms_iou,
                                r.min_bbox_size)
        return got, want

    def decode_on_jax_proposals(self):
        """(port, JAX) cascade boxes and scores on JAX's proposals, and
        their valid mask."""
        (feats, _, _), (jfeats, _, _) = self.features
        props = self.proposals[1]
        hw = (jnp.float32(self.h), jnp.float32(self.w))
        want = self.jdet.apply(self.variables, [f[0] for f in jfeats[:4]],
                               props.boxes, props.valid, hw,
                               method='roi_decode')
        valid = np.asarray(props.valid)
        with torch.no_grad():
            got = self.model.roi_head.decode_cascade(
                feats[:4], torch.tensor(np.asarray(props.boxes))[None],
                torch.tensor(valid)[None],
                torch.tensor([[self.h, self.w]]).float())
        return got, want, valid

    def detections(self, run=None):
        """(port, JAX) `Detections` of image 0: the port's whole
        `predict` (or `run(img, *mods)`, e.g. an exported program); JAX's
        `roi_test` on its proposals from its maps, the body of its
        `predict` (`cascade_rcnn.py:167-182`) without running the maps
        again."""
        (jfeats, _, _), props = self._jax_features[0], self.proposals[1]
        hw = (jnp.float32(self.h), jnp.float32(self.w))
        want = self.jdet.apply(self.variables, [f[0] for f in jfeats[:4]],
                               props.boxes, props.valid, hw,
                               jnp.ones(4, jnp.float32), True,
                               method='roi_test')
        with torch.no_grad():
            got = (predict(self.model, torch.from_numpy(self.img),
                           self._tmods()) if run is None else
                   run(torch.from_numpy(self.img), *self._tmods()))
        return got, want


def check_backbone(s, branch):
    got, want = s.backbone
    assert len(got) == len(want) == 4
    assert tuple(got[branch].shape) == want[branch].shape
    np.testing.assert_allclose(got[branch].numpy(),
                               np.asarray(want[branch]), atol=5e-3,
                               rtol=1e-3)


def check_neck_and_rpn(s, lvl):
    got, want = s.features
    for name, g, w in zip(('neck', 'rpn cls', 'rpn reg'), got, want):
        assert tuple(g[lvl].shape) == w[lvl].shape, name
        np.testing.assert_allclose(g[lvl].numpy(), np.asarray(w[lvl]),
                                   atol=5e-3, rtol=1e-3,
                                   err_msg=f'{name} level {lvl}')


def check_proposals(s):
    got, want = s.proposals
    valid = np.asarray(want.valid)
    assert valid.sum() > 10
    np.testing.assert_array_equal(got.valid[0].numpy(), valid)
    np.testing.assert_allclose(got.boxes[0].numpy()[valid],
                               np.asarray(want.boxes)[valid], atol=5e-3,
                               rtol=1e-3)


def check_decode(s):
    (boxes, scores), (want_boxes, want_scores), valid = \
        s.decode_on_jax_proposals()
    np.testing.assert_allclose(boxes[0].numpy()[valid],
                               np.asarray(want_boxes)[valid], atol=0.15,
                               rtol=1e-3)
    np.testing.assert_allclose(scores[0].numpy()[valid],
                               np.asarray(want_scores)[valid], atol=5e-3,
                               rtol=0)


def check_detections(s, score_tol=1e-4, run=None):
    got, want = s.detections(run)
    assert_detections_close(got, want, s.jcfg.roi.max_per_img, score_tol)


def assert_detections_close(got, want, max_per_img, score_tol=1e-4):
    """The port's batch-1 `Detections` (torch) against JAX's for image 0
    (unbatched, or batched with `want.boxes.ndim == 3`)."""
    if np.asarray(want.boxes).ndim == 3:
        want = type(want)(*(np.asarray(t)[0] for t in want))
    assert got.boxes.shape == (1, max_per_img, 4)
    valid = np.asarray(want.valid)
    assert valid.sum() > 0
    np.testing.assert_array_equal(got.valid[0].numpy(), valid)
    np.testing.assert_array_equal(got.labels[0].numpy(),
                                  np.asarray(want.labels))
    np.testing.assert_allclose(got.boxes[0].numpy(), np.asarray(want.boxes),
                               atol=1e-2, rtol=1e-3)
    np.testing.assert_allclose(got.scores[0].numpy(),
                               np.asarray(want.scores), atol=score_tol,
                               rtol=0)
