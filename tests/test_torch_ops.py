"""Port box ops and NMS vs the JAX package's ops on the same inputs.

`hrfuser_tpu_torch.ops.nms` is plain torch; the JAX versions
(`hrfuser_tpu.ops.nms`) are the reference, including their greedy order
on score ties (stable descending sort) and their fixed-size padding.
Boxes and scores must match exactly: both sides run the same f32 ops.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrfuser_tpu.models.dense_heads.rpn_head import \
    get_proposals_single as jax_get_proposals
from hrfuser_tpu.ops import boxes as jax_boxes
from hrfuser_tpu.ops.nms import NEG_INF
from hrfuser_tpu.ops.nms import batched_nms as jax_batched_nms
from hrfuser_tpu.ops.nms import multiclass_nms as jax_multiclass_nms
from hrfuser_tpu.ops.nms import nms as jax_nms
from hrfuser_tpu_torch.models.dense_heads.rpn_head import get_proposals
from hrfuser_tpu_torch.ops import boxes, nms


def _rand(n, seed, clusters=8, tie_levels=None):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(50, 550, (clusters, 2))
    cxy = centers[rng.integers(0, clusters, n)] + rng.normal(0, 10, (n, 2))
    wh = rng.uniform(20, 80, (n, 2))
    b = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    s = rng.uniform(0, 1, n).astype(np.float32)
    if tie_levels:                                   # many exact score ties
        s = (np.floor(s * tie_levels) / tie_levels).astype(np.float32)
    return b, s


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _assert_same(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy()
        if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)


@pytest.mark.parametrize('seed,n,max_out,ties', [
    (0, 200, 100, None),           # one block of 256
    (1, 300, 50, 8),               # score ties: stable order decides
    (2, 40, 100, None),            # fewer boxes than max_out
    (3, 700, 16, None),            # early exit from the block loop
    (4, 700, 400, None),           # three blocks, all resolved
])
def test_nms_matches_jax(seed, n, max_out, ties):
    b, s = _rand(n, seed, tie_levels=ties)
    b[::17, 2:] = b[::17, :2]                        # zero-area boxes
    want = jax_nms(jnp.asarray(b), jnp.asarray(s), 0.5, max_out)
    got = nms.nms(*_t(b, s), 0.5, max_out)
    _assert_same(got, want)


def test_nms_all_neg_inf_scores():
    b, _ = _rand(30, 4)
    s = np.full(30, NEG_INF, np.float32)
    want = jax_nms(jnp.asarray(b), jnp.asarray(s), 0.5, 10)
    got = nms.nms(*_t(b, s), 0.5, 10)
    _assert_same(got, want)
    assert not got[2].any()


@pytest.mark.parametrize('ties', [None, 4])
def test_batched_nms_matches_jax_per_image(ties):
    per_image = [_rand(300, 20 + i, tie_levels=ties) for i in range(3)]
    rng = np.random.default_rng(5)
    idxs = [rng.integers(0, 4, 300).astype(np.int32) for _ in range(3)]
    per_image[1][1][:40] = NEG_INF                   # padded candidates
    got = nms.batched_nms(
        torch.from_numpy(np.stack([b for b, _ in per_image])),
        torch.from_numpy(np.stack([s for _, s in per_image])),
        torch.from_numpy(np.stack(idxs)), 0.6, 64)
    for i, ((b, s), ix) in enumerate(zip(per_image, idxs)):
        want = jax_batched_nms(jnp.asarray(b), jnp.asarray(s),
                               jnp.asarray(ix), 0.6, 64)
        _assert_same([g[i] for g in got], want)


def test_multiclass_nms_matches_jax():
    rng = np.random.default_rng(0)
    n, c = 300, 10
    b = _rand(n, 5)[0]
    logits = rng.normal(0, 1.5, (n, c + 1)).astype(np.float32)
    scores = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    scores[::7] = 0.0                                # invalid proposals
    want = jax_multiclass_nms(jnp.asarray(b), jnp.asarray(scores),
                              0.05, 0.5, 100)       # 3000 candidates, cap 2000
    got = nms.multiclass_nms(*_t(b, scores), 0.05, 0.5, 100)
    _assert_same(got, want)
    assert got[2].dtype == torch.int32


def test_box_ops_match_jax():
    rng = np.random.default_rng(1)
    b1, _ = _rand(40, 6)
    b2, _ = _rand(30, 7)
    b2[:5, 2:] = b2[:5, :2]                          # zero-area
    np.testing.assert_allclose(
        boxes.bbox_overlaps(*_t(b1, b2)).numpy(),
        np.asarray(jax_boxes.bbox_overlaps(jnp.asarray(b1),
                                           jnp.asarray(b2))),
        atol=1e-7, rtol=0)
    deltas = rng.normal(0, 2, (40, 4)).astype(np.float32)  # hits the clamp
    stds = (0.1, 0.1, 0.2, 0.2)
    want = jax_boxes.delta2bbox(jnp.asarray(b1), jnp.asarray(deltas),
                                stds=stds, max_shape=(300., 500.))
    got = boxes.delta2bbox(*_t(b1, deltas), stds=stds,
                           max_shape=torch.tensor([300., 500.]))
    # XLA may fuse the centre/size arithmetic: 1 ulp apart
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-6)


def test_proposals_match_jax_per_image():
    """Batched RPN decode vs the JAX single-image decode (top-k ties go
    to the lower index on both sides)."""
    rng = np.random.default_rng(2)
    sizes = [(16, 24), (8, 12), (4, 6)]
    anchors = [rng.uniform(0, 90, (h * w * 3, 4)).astype(np.float32)
               for h, w in sizes]
    anchors = [np.concatenate([a[:, :2], a[:, :2] + 8 + a[:, 2:]], 1)
               for a in anchors]
    cls = [np.round(rng.normal(0, 2, (2, h, w, 3)), 1).astype(np.float32)
           for h, w in sizes]
    reg = [rng.normal(0, 0.5, (2, h, w, 12)).astype(np.float32)
           for h, w in sizes]
    img_hw = np.array([[64., 96.], [60., 90.]], np.float32)
    got = get_proposals(_t(*cls), _t(*reg), _t(*anchors),
                        torch.from_numpy(img_hw), nms_pre=200,
                        max_per_img=100, nms_iou=0.7)
    for i in range(2):
        want = jax_get_proposals(
            [jnp.asarray(c[i]) for c in cls],
            [jnp.asarray(r[i]) for r in reg],
            [jnp.asarray(a) for a in anchors],
            (jnp.float32(img_hw[i, 0]), jnp.float32(img_hw[i, 1])),
            nms_pre=200, max_per_img=100, nms_iou=0.7)
        np.testing.assert_array_equal(got.valid[i].numpy(),
                                      np.asarray(want.valid))
        np.testing.assert_allclose(got.boxes[i].numpy(),
                                   np.asarray(want.boxes), atol=1e-4)
        np.testing.assert_allclose(got.scores[i].numpy(),
                                   np.asarray(want.scores), atol=1e-6)


# the JAX package's small public helpers, each against its JAX original
HELPERS = {
    'bbox_area': lambda m, b: m.bbox_area(b),
    'bbox_center_size': lambda m, b: m.bbox_center_size(b),
    'bbox_flip_horizontal': lambda m, b: m.bbox_flip(b, (60, 90)),
    'bbox_flip_vertical': lambda m, b: m.bbox_flip(b, (60, 90), 'vertical'),
    'scale_boxes': lambda m, b: m.scale_boxes(b, [0.5, 2.0, 0.5, 2.0]),
}


@pytest.mark.parametrize('name', [*HELPERS, 'version'])
def test_small_helpers_equal_jax(name):
    if name == 'version':
        from hrfuser_tpu import __version__ as want
        from hrfuser_tpu_torch import __version__ as got
        assert got == want
        return
    b, _ = _rand(50, 11)
    b = np.stack([b, b[::-1]])                      # a leading batch dim
    got = HELPERS[name](boxes, torch.from_numpy(b))
    want = HELPERS[name](jax_boxes, jnp.asarray(b))
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError):
        boxes.bbox_flip(torch.from_numpy(b), (60, 90), 'diagonal')
