"""Port RoIAlign (plain twin of kernel C) vs the JAX gather RoIAlign.

On the CPU the JAX cascade head pools with the gather formulation
(`CascadeRoIHead._pool` turns 'pallas' into 'gather' off-TPU), which is
the reference here at f32 (`gather_dtype=None`). The `slow` case adds
the Pallas v7 kernel in interpret mode at the tolerance
`tests/test_pallas_roi_align.py` uses (it rounds to bf16).

The single-image entry `multilevel_roi_align_pallas` (variants v4, v7,
v8, one kernel) is held to the JAX gather path at f32 on the cases of
`tests/test_pallas_roi_align.py`: edge and outside boxes, many random
RoIs, the flat (q, p) row order, the right edge of a level whose width is
not a multiple of 8, more oversize RoIs than v4's fallback takes per
iteration, and full-axis slivers. Its `slow` cases hold it to the v4 and
v8 Pallas kernels in interpret mode.
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


@pytest.mark.parametrize('c,dtype,offset,match', [
    (12, torch.bfloat16, 0, 'C % 8'),
    (6, torch.float32, 0, 'C % 4'),
    (32, torch.bfloat16, 1, '16-byte boundary'),
    (32, torch.float32, 2, '16-byte boundary'),
])
def test_kernel_launcher_refuses_what_it_cannot_vector_load(c, dtype, offset,
                                                           match):
    """Kernel C loads 16-byte channel vectors: the launcher raises before
    it reaches the library for a C that does not fill them or a level
    that does not start on a 16-byte boundary (checked on CPU tensors)."""
    feats = [torch.zeros((1, 32 // 2 ** i, 32 // 2 ** i, c), dtype=dtype)
             for i in range(4)]
    flat = torch.zeros(feats[0].numel() + offset, dtype=dtype)
    feats[0] = flat[offset:].view(feats[0].shape)
    rois = torch.tensor([[[0., 0., 50., 50.]]])
    with pytest.raises(ValueError, match=match):
        roi_align._launch(feats, rois, STRIDES, 7, 2, 56)


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


# ---------------------------------------------------------------------------
# the single-image variant entry (`pallas_roi_align.py:834`)
# ---------------------------------------------------------------------------

def _level_feats(rng, h0, w0, c=256):
    return [rng.normal(0, 1, (h0 // 2 ** i, w0 // 2 ** i, c))
            .astype(np.float32) for i in range(4)]


def _variant_case(name):
    """(feats, rois) of the `tests/test_pallas_roi_align.py` cases."""
    rng = np.random.default_rng(dict(edge=0, many=1, flat=2, right=31,
                                     oversize=7, slivers=3)[name])
    if name == 'edge':
        rois = [[4., 4., 100., 90.], [0., 0., 30., 20.], [-8., -4., 40., 44.],
                [10., 5., 200., 180.], [0., 0., 383., 250.],
                [100., 60., 380., 255.], [5., 5., 6., 6.],
                [50., 40., 150., 120.]]
        return _level_feats(rng, 64, 96), np.array(rois, np.float32)
    if name == 'many':
        feats = _level_feats(rng, 96, 160)
        n = 64
        x1, y1 = rng.uniform(-10, 500, n), rng.uniform(-10, 300, n)
        w, h = rng.uniform(2, 400, n), rng.uniform(2, 250, n)
        return feats, np.stack([x1, y1, x1 + w, y1 + h], -1).astype(
            np.float32)
    if name == 'flat':
        feats = _level_feats(rng, 64, 96)
        wh = rng.uniform(4, 300, (16, 2))
        xy = rng.uniform(0, 1, (16, 2)) * (np.array([380., 250.]) - wh)
        return feats, np.concatenate([xy, xy + wh], -1).astype(np.float32)
    if name == 'right':                  # STF stride-8 level width 156
        feats = [rng.normal(0, 1, (312 // s, 1248 // s, 256))
                 .astype(np.float32) for s in STRIDES]
        rois = [[x2 - 112., y1, x2, y1 + 112.]
                for x2 in (1247., 1240., 1200.) for y1 in (10., 100., 200.)]
        rois += [[0., 0., 100., 80.], [600., 100., 710., 190.]]
        return feats, np.array(rois, np.float32)
    if name == 'oversize':               # 24 > v4's FALLBACK of 16
        wide = [[5. + i, 40., 620. + i, 52.] for i in range(12)]
        tall = [[30. + i, 2., 44. + i, 370.] for i in range(12)]
        normal = [[10., 10., 120., 100.], [200., 80., 320., 200.],
                  [0., 0., 60., 60.], [100., 100., 400., 300.]]
        return (_level_feats(rng, 96, 160),
                np.array(wide + tall + normal, np.float32))
    w_img, h_img = 384, 256              # full-axis slivers
    rois = [[0., 100., w_img - 1., 101.5], [200., 0., 201.2, h_img - 1.],
            [0., 0., w_img - 1., 12.], [370., 0., w_img - 1., h_img - 1.],
            [0., 0., w_img - 1., h_img - 1.], [10., 20., 60., 70.],
            [0., 0., 2., 2.],
            [w_img - 3., h_img - 3., w_img - 1., h_img - 1.]]
    return _level_feats(rng, 64, 96), np.array(rois, np.float32)


def _pallas_entry(feats, rois, variant, flat_out=False):
    return roi_align.multilevel_roi_align_pallas(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(rois),
        STRIDES, flat_out=flat_out, variant=variant).numpy()


@pytest.mark.parametrize('variant', roi_align.VARIANTS)
@pytest.mark.parametrize('name', ['edge', 'many', 'right', 'oversize',
                                  'slivers'])
def test_pallas_entry_matches_jax_gather(name, variant):
    feats, rois = _variant_case(name)
    want = np.asarray(jax_pool([jnp.asarray(f) for f in feats],
                               jnp.asarray(rois), list(STRIDES),
                               gather_dtype=None))
    got = _pallas_entry(feats, rois, variant)
    assert got.shape == want.shape == (len(rois), 7, 7, 256)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize('variant', roi_align.VARIANTS)
def test_pallas_entry_flat_out_is_qp_order(variant):
    feats, rois = _variant_case('flat')
    full = _pallas_entry(feats, rois, variant)
    flat = _pallas_entry(feats, rois, variant, flat_out=True)
    assert flat.shape == (16, 49, 256)
    np.testing.assert_array_equal(flat.reshape(16, 7, 7, 256).swapaxes(1, 2),
                                  full)


def test_pallas_entry_rejects_unknown_variant():
    feats, rois = _variant_case('edge')
    with pytest.raises(ValueError, match='variant'):
        _pallas_entry(feats, rois, 'v3')


@pytest.mark.slow
@pytest.mark.parametrize('variant', ['v4', 'v8'])
@pytest.mark.parametrize('name', ['edge', 'right', 'oversize', 'slivers'])
def test_pallas_entry_matches_pallas_interpret(name, variant):
    from hrfuser_tpu.ops.pallas_roi_align import multilevel_roi_align_pallas
    feats, rois = _variant_case(name)
    want = np.asarray(multilevel_roi_align_pallas(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois), STRIDES,
        interpret=True, variant=variant), np.float32)
    got = _pallas_entry(feats, rois, variant)
    np.testing.assert_allclose(got, want, atol=0.05, rtol=0.05)


@pytest.mark.parametrize('sample_num', [0, -1])
def test_adaptive_sampling_raises_on_the_cpu(sample_num):
    """`sample_num=0` is the JAX package's adaptive mode
    (`hrfuser_tpu/ops/roi_align.py:8-14`), not ported: the CPU path
    raises as the card's does, instead of returning NaN."""
    feats = [torch.zeros((1, 64 // s, 64 // s, 8)) for s in (4, 8, 16, 32)]
    rois = torch.tensor([[[4., 4., 40., 40.]]])
    with pytest.raises(ValueError, match='adaptive sampling'):
        roi_align.multilevel_roi_align_plain(feats, rois, (4, 8, 16, 32),
                                             sample_num=sample_num)
    with pytest.raises(ValueError, match='adaptive sampling'):
        roi_align.multilevel_roi_align(feats, rois, (4, 8, 16, 32),
                                       sample_num=sample_num)
