"""Flip test-time augmentation vs the JAX package on `tiny_fusion_test`.

`predict_tta_flip` (detection-level fusion) and `predict_aug_test_flip`
(proposals merged across the two views, the cascade decoded in both,
averaged) on the same 64x96 batch-1 inputs at f32 on the CPU, with the
JAX variables carried over by the bridge. The JAX functions run
un-jitted and share their forwards of the image and its mirror
(`_SharedViews`), so the slow un-jitted trunk runs twice in all.
Detections are held to
`tests/oracles/slice_pair.py`'s final tolerances (boxes 1e-2 px and 1e-3
relative; scores 5e-3, as `test_torch_stf_slice.py` sets: each view's
proposals come from each package's own maps). Also JAX's
mirror-consistency property (`tests/test_models.py:166`) on the port:
the image and its mirror see the same two views in swapped roles.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrfuser_tpu.configs import get_config as jax_get_config
from hrfuser_tpu.models import predict_aug_test_flip as jax_aug_test_flip
from hrfuser_tpu.models import predict_tta_flip as jax_tta_flip
from hrfuser_tpu_torch.configs import get_config
from hrfuser_tpu_torch.models import predict_aug_test_flip, predict_tta_flip
from tests.oracles.slice_pair import SlicePair

NAME = 'tiny_fusion_test'
HW = (64, 96)
SCORE_TOL = 5e-3


class _SharedViews:
    """The JAX detector with its `forward_features` memoised by input, so
    the two TTA functions share the forwards of the image and its
    mirror."""

    def __init__(self, jdet):
        self.cfg, self.jdet, self.views = jdet.cfg, jdet, {}

    def apply(self, variables, *args, method):
        if method != 'forward_features':
            return self.jdet.apply(variables, *args, method=method)
        key = np.asarray(args[0]).tobytes()
        if key not in self.views:
            self.views[key] = self.jdet.apply(variables, *args,
                                              method=method)
        return self.views[key]


@pytest.fixture(scope='module')
def s():
    s = SlicePair(jax_get_config(NAME).model, get_config(NAME), HW)
    s.shared = _SharedViews(s.jdet)
    return s


def _port(fn, s, flip=False):
    img, mods = s.img, s.mods
    if flip:
        img, mods = img[:, :, ::-1], [m[:, :, ::-1] for m in mods]
    with torch.no_grad():
        return fn(s.model, torch.from_numpy(img.copy()),
                  [torch.from_numpy(m.copy()) for m in mods])


def _check(got, want, max_per_img):
    assert got.boxes.shape == (1, max_per_img, 4)
    valid = np.asarray(want.valid)
    assert valid.sum() > 0
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               atol=1e-2, rtol=1e-3)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=SCORE_TOL, rtol=0)


@pytest.mark.parametrize('name', ['tta_flip', 'aug_test_flip'])
def test_flip_tta_matches_jax(s, name):
    port_fn, jax_fn = {'tta_flip': (predict_tta_flip, jax_tta_flip),
                       'aug_test_flip': (predict_aug_test_flip,
                                         jax_aug_test_flip)}[name]
    want = jax_fn(s.shared, s.variables, jnp.asarray(s.img),
                  [jnp.asarray(m) for m in s.mods])
    _check(_port(port_fn, s), want, s.jcfg.roi.max_per_img)


def test_aug_test_flip_mirror_consistency(s):
    """The image and its mirror: equal score multisets, mirrored boxes."""
    d1 = _port(predict_aug_test_flip, s)
    d2 = _port(predict_aug_test_flip, s, flip=True)
    v1, v2 = d1.valid[0].numpy(), d2.valid[0].numpy()
    b1, b2 = d1.boxes[0].numpy(), d2.boxes[0].numpy()
    assert np.isfinite(b1).all() and np.isfinite(b2).all()
    assert v1.sum() == v2.sum() > 0
    np.testing.assert_allclose(np.sort(d1.scores[0].numpy()[v1]),
                               np.sort(d2.scores[0].numpy()[v2]), atol=1e-4)
    w = float(HW[1])
    mirrored = np.stack([w - b2[v2][:, 2], w - b2[v2][:, 0]], -1)
    np.testing.assert_allclose(
        np.sort(np.stack([b1[v1][:, 0], b1[v1][:, 2]], -1), axis=0),
        np.sort(mirrored, axis=0), atol=1e-3)


def test_tta_flip_keeps_the_single_pass_detections_in_the_frame(s):
    """Every fused box lies inside the 96x64 frame, and the fused top
    score is at least the single pass's: one NMS over both sets keeps
    the best box of either."""
    from hrfuser_tpu_torch.models import predict
    single = _port(predict, s)
    fused = _port(predict_tta_flip, s)
    boxes = fused.boxes[0].numpy()[fused.valid[0].numpy()]
    assert (boxes >= 0).all() and (boxes[:, [0, 2]] <= HW[1]).all()
    assert (boxes[:, [1, 3]] <= HW[0]).all()
    assert fused.scores[0].max() >= single.scores[0].max()
