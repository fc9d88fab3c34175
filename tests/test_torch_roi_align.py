"""Port RoIAlign (plain twin of kernel C) vs the JAX gather RoIAlign.

On the CPU the JAX cascade head pools with the gather formulation
(`CascadeRoIHead._pool` turns 'pallas' into 'gather' off-TPU), which is
the reference here at f32 (`gather_dtype=None`). The `slow` case adds
the Pallas v7 kernel in interpret mode at the tolerance
`tests/test_pallas_roi_align.py` uses (it rounds to bf16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrfuser_tpu.ops.roi_align import map_roi_levels as jax_map_levels
from hrfuser_tpu.ops.roi_align import multilevel_roi_align as jax_pool
from hrfuser_tpu_torch.ops import roi_align

STRIDES = (4, 8, 16, 32)


def _feats(rng, b, h0, w0, c):
    return [rng.normal(0, 1, (b, -(-h0 // 2 ** i), -(-w0 // 2 ** i), c))
            .astype(np.float32) for i in range(4)]


def _edge_rois(h, w):
    """Edge cases: outside / partly outside, zero boxes, slivers across
    the whole stride-4 level, tiny boxes, every level."""
    return np.array([
        [4., 4., 100., 90.],
        [0., 0., 0., 0.],                # zero-padded proposal -> level 0
        [-30., -20., -2., -1.],          # fully outside, top-left
        [w + 5., h + 5., w + 60., h + 40.],  # fully outside, bottom-right
        [-8., -4., 40., 44.],            # partly outside
        [0., 10., w, 14.],               # full-width sliver
        [20., 0., 23., h],               # full-height sliver
        [5., 5., 6., 6.],                # tiny
        [10., 5., 200., 180.],
        [0., 0., w, h],                  # whole image, coarsest level
        [w - 30., h - 30., w, h],        # right/bottom edge
        [50., 40., 150., 120.],
    ], np.float32)


def _random_rois(rng, n, h, w):
    x1 = rng.uniform(-20, w, n)
    y1 = rng.uniform(-20, h, n)
    bw = rng.uniform(1, w, n)
    bh = rng.uniform(1, h, n)
    return np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(np.float32)


@pytest.mark.parametrize('h,w,c', [
    (64, 96, 16),
    (72, 200, 8),            # stride-32 level width 25: not a multiple of 8
])
def test_plain_roi_align_matches_jax_gather(h, w, c):
    rng = np.random.default_rng(h + w)
    b = 2
    feats = _feats(rng, b, h, w, c)
    rois = np.stack([np.concatenate([_edge_rois(h, w),
                                     _random_rois(rng, 20, h, w)])
                     for _ in range(b)])
    rois[1] = rois[1][::-1]
    got = roi_align.multilevel_roi_align(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(rois),
        STRIDES).numpy()
    assert got.shape == (b, rois.shape[1], 49, c)
    for i in range(b):
        want = np.asarray(jax_pool([jnp.asarray(f[i]) for f in feats],
                                   jnp.asarray(rois[i]), list(STRIDES),
                                   gather_dtype=None))
        np.testing.assert_allclose(got[i].reshape(want.shape), want,
                                   atol=1e-5, rtol=0)


def test_map_roi_levels_matches_jax():
    rng = np.random.default_rng(3)
    rois = np.concatenate([_edge_rois(384, 640),
                           _random_rois(rng, 200, 384, 640)])
    got = roi_align.map_roi_levels(torch.from_numpy(rois), 4).numpy()
    want = np.asarray(jax_map_levels(jnp.asarray(rois), 4))
    np.testing.assert_array_equal(got, want)
    assert got[1] == 0                               # zero box


def test_roi_align_keeps_feature_dtype_and_counts_no_cpu_launch():
    rng = np.random.default_rng(4)
    feats = [torch.from_numpy(f).to(torch.bfloat16)
             for f in _feats(rng, 1, 32, 48, 8)]
    rois = torch.from_numpy(_edge_rois(32, 48)[None])
    before = roi_align.multilevel_roi_align.launches
    out = roi_align.multilevel_roi_align(feats, rois, STRIDES)
    assert out.dtype == torch.bfloat16
    assert roi_align.multilevel_roi_align.launches == before


@pytest.mark.slow
def test_plain_roi_align_matches_pallas_interpret():
    from hrfuser_tpu.ops.pallas_roi_align import multilevel_roi_align_pallas
    rng = np.random.default_rng(0)
    h, w = 64, 96
    feats = _feats(rng, 1, h, w, 256)
    rois = np.concatenate([_edge_rois(h, w), _random_rois(rng, 12, h, w)])
    want = np.asarray(multilevel_roi_align_pallas(
        [jnp.asarray(f[0]) for f in feats], jnp.asarray(rois), STRIDES,
        interpret=True), np.float32)
    got = roi_align.multilevel_roi_align(
        [torch.from_numpy(f) for f in feats],
        torch.from_numpy(rois[None]), STRIDES).numpy()[0]
    np.testing.assert_allclose(got.reshape(want.shape), want, atol=0.05,
                               rtol=0.05)
