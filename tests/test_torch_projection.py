"""The port's sensor projection (`data/projection.py`) against the JAX
package on the same seeded numpy inputs.

`splat_lidar`, `splat_radar_pillars` and `stf_splat` must give bit-equal
uint16 images in both modes on inputs that make the order of writes
matter: many points on a few pixels (with depth ties), points exactly
on half pixels (both packages round half to even) and on the 1-pixel
margin, pillars that are inverted or empty, and values whose
quantization sits next to a truncation edge. The cases of
`tests/test_projection.py` are mirrored on the port.
"""

import numpy as np
import pytest
import torch

from hrfuser_tpu.data import projection as J
from hrfuser_tpu_torch.data import projection as P

W, H = 160, 96
MODES = ['reference', 'zbuffer']


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _u16(img):
    return img.numpy().astype(np.uint16)


def _crowded_uv(rng, n, scale=2.5):
    """[2, n] full-resolution pixels: a quarter on 24 target pixels, a
    quarter exactly on half target pixels, some off the grid."""
    uv = np.stack([rng.uniform(0, W * scale, n), rng.uniform(0, H * scale, n)])
    k = n // 4
    uv[:, :k] = np.stack([rng.integers(0, 6, k),
                          rng.integers(0, 4, k)]) * scale
    uv[:, k:2 * k] = (rng.integers(0, 60, (2, k)) + 0.5) * scale
    uv[0, 2 * k:2 * k + 10] = W * scale + 5                  # clipped right
    uv[1, 2 * k + 10:2 * k + 20] = -3.0                      # clipped top
    return uv


def test_half_pixels_round_to_even():
    uv = np.array([[0.5, 1.5, 2.5, 3.5], [0.5, 0.5, 0.5, 0.5]]) * 2.5
    got = P._prep_pixels(torch.from_numpy(uv), 2.5, (W, H)).numpy()
    np.testing.assert_array_equal(got[:, 0], [0, 2, 2, 4])
    np.testing.assert_array_equal(got, J._prep_pixels(uv, 2.5, (W, H)))


@pytest.mark.parametrize('mode', MODES)
def test_splat_lidar_bit_equal(mode):
    args = _lidar_inputs(np.random.default_rng(0))
    want = J.splat_lidar(*args, (W, H), 2.5, mode)
    got = P.splat_lidar(*_t(*args), (W, H), 2.5, mode)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == (H, W, 3)
        np.testing.assert_array_equal(_u16(g), w)


def _lidar_inputs(rng, n=2000):
    uv = _crowded_uv(rng, n)
    d = rng.uniform(1, 80, n)
    d[:300] = np.round(d[:300])                               # depth ties
    inten = rng.uniform(0, 255, n).astype(np.float32)         # as devkit
    return uv, d, inten, rng.normal(0, 10, (3, n))


def _pillar_inputs(rng, m=300):
    uv = _crowded_uv(rng, m)
    top = uv.copy()
    top[1] -= rng.uniform(-20, 150, m)           # some inverted or empty
    # 100 pillars on 5 columns, so each column holds about 20
    uv[:, :100] = np.stack([rng.integers(0, 5, 100) * 2.5,
                            rng.uniform(50, 240, 100)])
    top[:, :100] = uv[:, :100]
    top[1, :100] -= rng.uniform(-10, 100, 100)
    d = rng.uniform(1, 80, m)
    d[:50] = np.round(d[:50] / 10) * 10
    rcs = rng.uniform(-10, 30, m).astype(np.float32)
    vel = rng.uniform(0, 20, m).astype(np.float32)
    return uv, top, d, rcs, vel, rng.normal(0, 10, (3, m))


@pytest.mark.parametrize('mode', MODES)
def test_splat_radar_pillars_bit_equal(mode):
    args = _pillar_inputs(np.random.default_rng(1))
    want = J.splat_radar_pillars(*args, (W, H), 2.5, mode)
    got = P.splat_radar_pillars(*_t(*args), (W, H), 2.5, mode)
    assert (want[0] != 20000).sum() > 1000
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_u16(g), w)


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('sensor', ['lidar', 'radar'])
def test_splats_of_several_images_in_one_pass(sensor, mode):
    """Points of three images in one call (`image`, `n_images`): each
    image equal to JAX's splat of that image's points alone, in order."""
    rng = np.random.default_rng(6)
    args = (_lidar_inputs(rng) if sensor == 'lidar'
            else _pillar_inputs(rng))
    image = rng.integers(0, 3, args[0].shape[1])          # interleaved
    splat = {'lidar': (J.splat_lidar, P.splat_lidar),
             'radar': (J.splat_radar_pillars, P.splat_radar_pillars)}[sensor]
    got = splat[1](*_t(*args), (W, H), 2.5, mode,
                   image=torch.from_numpy(image), n_images=3)
    for b in range(3):
        part = [a[..., image == b] for a in args]
        want = splat[0](*part, (W, H), 2.5, mode)
        for g, w in zip(got, want):
            assert g.shape == (3, H, W, 3)
            np.testing.assert_array_equal(_u16(g[b]), w)


def test_pillar_zbuffer_depends_on_order():
    """A far pillar drawn first, then a near one over part of it, then a
    mid one over both: the mid one is skipped over the near rows, so it
    leaves no mark at all, and the result is not a per-pixel minimum."""
    uv = np.array([[10., 10., 10.], [60., 40., 80.]]) * 2.5
    top = np.array([[10., 10., 10.], [20., 30., 25.]]) * 2.5
    d = np.array([50., 10., 30.])
    args = (uv, top, d, np.zeros(3), np.zeros(3), np.zeros((3, 3)))
    want = J.splat_radar_pillars(*args, (W, H), 2.5, 'zbuffer')[0]
    got = _u16(P.splat_radar_pillars(*_t(*args), (W, H), 2.5,
                                     'zbuffer')[0])
    np.testing.assert_array_equal(got, want)
    col = J.dequantize(want[:, 10, 0])
    assert (np.abs(col[20:30] - 50) < .01).all()
    assert (np.abs(col[30:40] - 10) < .01).all()
    assert (np.abs(col[40:60] - 50) < .01).all()   # 30 m never drawn


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('radar', [False, True])
def test_stf_splat_bit_equal(radar, mode):
    rng = np.random.default_rng(2)
    n = 2000
    coords = np.stack([rng.integers(0, W, n), rng.integers(0, H, n)], 1)
    coords[:500] %= 5
    vals = rng.normal(0, 20, (n, 3))
    vals[:300, 1] = np.round(vals[:300, 1])
    want = J.stf_splat(coords, vals, (W, H), radar, mode)
    got = P.stf_splat(*_t(coords, vals), (W, H), radar, mode)
    assert got.shape == (H, W, 3)
    np.testing.assert_array_equal(_u16(got), want)


def test_quantization_truncates_at_the_edges_as_numpy():
    """Values whose (v + 200) * 100 lands one ulp either side of an
    integer, in float64 and float32, and negative and wrapping ones."""
    base = np.arange(-199.0, 400.0, 0.01)
    vals = np.concatenate([base, np.nextafter(base, -np.inf),
                           np.nextafter(base, np.inf), [-250.0, 500.0]])
    for v in (vals, vals.astype(np.float32)):
        want = ((v + J.SHIFT) * J.SCALE).astype(np.uint16)
        got = P._quantize(torch.from_numpy(v)).numpy().astype(np.uint16)
        np.testing.assert_array_equal(got, want)


def test_margin_mask_and_projection_equal_jax():
    rng = np.random.default_rng(3)
    k = np.array([[500., 0., 80.], [0., 500., 48.], [0., 0., 1.]])
    pts = rng.uniform([-5, -3, -2], [5, 3, 30], (400, 3)).T
    # points exactly on the margin u = 1, u = W - 1, v = 1, v = H - 1
    z = 10.0
    edges = np.array([[1., 20.], [W - 1., 20.], [30., 1.], [30., H - 1.],
                      [1.0000001, 20.]])
    pts[:, :5] = np.stack([(edges[:, 0] - 80.) * z / 500.,
                           (edges[:, 1] - 48.) * z / 500., np.full(5, z)])
    pts[2, 5] = 1.0                                   # z == min_dist
    uv_j, m_j = J.project_to_image(pts, k, (W, H))
    uv_p, m_p = P.project_to_image(torch.from_numpy(pts), k, (W, H))
    np.testing.assert_array_equal(m_p.numpy(), m_j)
    assert not m_j[:4].any() and m_j[4] and not m_j[5]
    # numpy's BLAS sums K @ p in its own order: a few ulps apart
    np.testing.assert_allclose(uv_p.numpy(), uv_j, rtol=1e-13)


def test_apply_matrix_matches_matmul():
    rng = np.random.default_rng(4)
    m = rng.normal(size=(3, 4))
    p = rng.normal(size=(3, 50))
    got = P.apply_matrix(m, torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(got, m[:, :3] @ p + m[:, 3:], rtol=1e-13,
                               atol=1e-13)
    got = P.apply_matrix(m[:, :3], torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(got, m[:, :3] @ p, rtol=1e-13, atol=1e-13)


# the cases of tests/test_projection.py, on the port

def test_quantize_roundtrip():
    vals = np.array([-199.99, -1.5, 0.0, 3.14159, 100.0, 400.0])
    np.testing.assert_allclose(P.dequantize(P.quantize(vals)), vals,
                               atol=0.01)
    np.testing.assert_array_equal(P.quantize(vals), J.quantize(vals))


def test_quat_identity_and_rotation():
    np.testing.assert_allclose(P.quat_to_rot([1, 0, 0, 0]), np.eye(3),
                               atol=1e-12)
    q = [np.cos(np.pi / 4), 0, 0, np.sin(np.pi / 4)]
    np.testing.assert_allclose(P.quat_to_rot(q) @ [1, 0, 0], [0, 1, 0],
                               atol=1e-12)
    np.testing.assert_array_equal(P.quat_to_rot(q), J.quat_to_rot(q))


def test_transform_matrix_inverse():
    t, q = [1.0, -2.0, 3.0], [np.cos(0.3), 0, np.sin(0.3), 0]
    tm = P.transform_matrix(t, q)
    np.testing.assert_allclose(tm @ P.transform_matrix(t, q, inverse=True),
                               np.eye(4), atol=1e-12)
    np.testing.assert_array_equal(tm, J.transform_matrix(t, q))


def test_project_to_image():
    k = np.array([[500., 0., 320.], [0., 500., 180.], [0., 0., 1.]])
    pts = np.array([[0., 0., 10.], [0., 0., -5.], [100., 0., 10.]]).T
    uv, mask = P.project_to_image(torch.from_numpy(pts), k, (640, 360))
    assert mask.tolist() == [True, False, False]
    np.testing.assert_allclose(uv[:, 0].numpy(), [320., 180.], atol=1e-9)


def test_splat_lidar_background_decodes_to_zero():
    rih, xz0 = P.splat_lidar(*_t(np.zeros((2, 0)), np.zeros(0), np.zeros(0),
                                 np.zeros((3, 0))))
    assert rih.shape == (360, 640, 3)
    np.testing.assert_allclose(P.dequantize(_u16(rih)), 0.0)
    np.testing.assert_allclose(P.dequantize(_u16(xz0)), 0.0)


def test_splat_lidar_writes_point():
    rih, xz0 = P.splat_lidar(*_t(np.array([[100.0], [50.0]]),
                                 np.array([9.1]), np.array([17.0]),
                                 np.array([[1.0], [-2.0], [9.0]])))
    np.testing.assert_allclose(P.dequantize(_u16(rih)[20, 40]),
                               [9.1, 17.0, 2.0], atol=0.01)
    np.testing.assert_allclose(P.dequantize(_u16(xz0)[20, 40])[:2],
                               [1.0, 9.0], atol=0.01)


def test_splat_lidar_zbuffer_vs_reference():
    args = _t(np.array([[100.0, 100.0], [50.0, 50.0]]), np.array([5., 20.]),
              np.zeros(2), np.array([[0., 0.], [0., 0.], [5., 20.]]))
    ref, _ = P.splat_lidar(*args, mode='reference')
    zb, _ = P.splat_lidar(*args, mode='zbuffer')
    assert abs(P.dequantize(_u16(ref)[20, 40, 0]) - 20.0) < 0.01
    assert abs(P.dequantize(_u16(zb)[20, 40, 0]) - 5.0) < 0.01


def test_radar_pillars():
    riv, _ = P.splat_radar_pillars(*_t(
        np.array([[100.0], [250.0]]), np.array([[100.0], [50.0]]),
        np.array([30.0]), np.array([4.0]), np.array([8.5]),
        np.array([[2.0], [0.0], [30.0]])))
    col = P.dequantize(_u16(riv)[:, 40, 0])
    assert (np.abs(col[20:100] - 30.0) < 0.01).all()
    assert (col[:20] == 0).all() and (col[100:] == 0).all()
    assert abs(P.dequantize(_u16(riv)[50, 40, 2]) - 8.5) < 0.01


def test_radar_pillar_endpoints():
    pts = np.array([[1.0, 2.0], [3.0, 4.0], [0.5, -0.2]])
    top = P.radar_pillar_endpoints(torch.from_numpy(pts), 3.0).numpy()
    np.testing.assert_array_equal(top, J.radar_pillar_endpoints(pts, 3.0))
    np.testing.assert_allclose(top[2], 3.0)


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match='mode'):
        P.splat_lidar(*_t(np.zeros((2, 1)), np.ones(1), np.ones(1),
                          np.ones((3, 1))), mode='nearest')
