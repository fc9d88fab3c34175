"""The port's gated -> RGB warping (`data/gated_warp.py`,
`tools/stf_gated_warp.py`) against the JAX package, and its homography
and resize against `cv2`, on the same seeded inputs.

Tolerances, measured here:
- `depth_warp`: equal to JAX on depths with no ties (JAX breaks ties by
  an unstable sort; the port gives a tie to the lower source index).
- `inverse_depth_warp`: float64 in both, cast to float32 once; equal to
  JAX to 1 float32 ulp (numpy's BLAS and the port's elementwise sums
  differ in the last float64 bits). After the CLI's truncation to
  uint16, no pixel differs on these inputs.
- `resize_image` (bilinear, float32) vs `cv2.resize(INTER_LINEAR)` on a
  512x960 -> 1024x1920 depth map: within 2e-6 relative.
- `homography_from_points` vs `cv2.findHomography(RANSAC)` on exact
  correspondences: 1e-6 (H normalised to h33 = 1).
- `homography_warp` vs `cv2.warpPerspective`: float32 within 2e-4 on
  values of 0-250 where all four taps lie in the image, 2e-3 where a tap
  crosses into the 0 border (cv2 5.0 computes coordinates and weights in
  float32, the port in float64, and at the border a coordinate's
  rounding meets a step of the whole value); uint8 and uint16 within one
  count.
"""

import importlib.util
import os
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from hrfuser_tpu.data import gated_warp as J
from hrfuser_tpu_torch.data import gated_warp as P
from hrfuser_tpu_torch.data.device_pipeline import resize_image
from hrfuser_tpu_torch.tools import stf_gated_warp
from tests.oracles.offline_data import write_gated_frame

ROOT = Path(__file__).resolve().parents[1]


def _k(f=100.0, cx=32.0, cy=24.0):
    return np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]])


def _pose(rng):
    q = np.array([1.0, *rng.normal(0, 0.02, 3)])
    from hrfuser_tpu_torch.data.projection import transform_matrix
    return transform_matrix(rng.normal(0, 0.3, 3), q / np.linalg.norm(q))


def test_depth_warp_equals_jax_without_ties():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (48, 64, 2)).astype(np.float32)
    depth = rng.uniform(3, 30, (48, 64)).astype(np.float32)   # no ties
    depth[rng.random((48, 64)) < 0.1] = 0                     # invalid
    k2 = _k(90.0, 40.0, 30.0)
    t = _pose(rng)
    want, want_m = J.depth_warp(img, depth, _k(), k2, t, (80, 60))
    got, got_m = P.depth_warp(torch.from_numpy(img), torch.from_numpy(depth),
                              _k(), k2, t, (80, 60))
    np.testing.assert_array_equal(got_m.numpy(), want_m)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want_m.sum() > 1000


def test_depth_warp_ties_go_to_the_lower_source_index():
    """Three pixels at one depth onto one target pixel (a target lens of
    almost no focal length)."""
    img = torch.tensor([[1.0, 2.0, 3.0]])
    depth = torch.full((1, 3), 5.0)
    k_src = np.array([[1.0, 0, 1.0], [0, 1.0, 0.0], [0, 0, 1.0]])
    k_tgt = np.array([[1e-6, 0, 1.0], [0, 1.0, 0.0], [0, 0, 1.0]])
    out, mask = P.depth_warp(img, depth, k_src, k_tgt, np.eye(4), (3, 1))
    assert out[0, 1, 0].item() == 1.0 and mask.sum().item() == 1


@pytest.mark.parametrize('channels', [1, 3])
def test_inverse_depth_warp_equals_jax(channels):
    rng = np.random.default_rng(1)
    src = rng.uniform(0, 1023, (72, 128, channels)).astype(np.float32)
    depth = rng.uniform(4, 60, (96, 160)).astype(np.float32)
    depth[rng.random(depth.shape) < 0.05] = 0              # -> 250 m
    k_src, k_tgt = _k(110.0, 64.0, 36.0), _k(130.0, 80.0, 48.0)
    t = _pose(rng)
    off = J.ego_motion_offset(12.0, 7.0, 0.045)
    want = J.inverse_depth_warp(src[..., 0] if channels == 1 else src,
                                depth, k_src, k_tgt, t, off)
    got = P.inverse_depth_warp(
        torch.from_numpy(src[..., 0] if channels == 1 else src),
        torch.from_numpy(depth), k_src, k_tgt, t, off).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    assert (want > 0).mean() > 0.5
    # the CLI's truncation to uint16: no pixel moves by a count
    assert (got.astype(np.uint16) != want.astype(np.uint16)).sum() == 0


def test_disparity_to_depth_equals_jax():
    rng = np.random.default_rng(2)
    disp = rng.uniform(-1, 80, (48, 64)).astype(np.float32)
    disp[0, :3] = [0.0, np.nan, 1e-30]
    want = J.disparity_to_depth(disp, 2355.722801, 0.202993)
    got = P.disparity_to_depth(torch.from_numpy(disp), 2355.722801, 0.202993)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_depth_resize_against_cv2():
    yy, xx = np.mgrid[0:512, 0:960]
    depth = (5 + 50 * (0.5 + 0.5 * np.sin(xx / 37.0) * np.cos(yy / 23.0))
             ).astype(np.float32)
    want = cv2.resize(depth, (1920, 1024))
    got = resize_image(torch.from_numpy(depth)[None, :, :, None],
                       (1024, 1920))[0, :, :, 0].numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)


def _homography(rng):
    return np.array([[1.1, 0.02, 5.0], [-0.01, 0.95, -3.0],
                     [2e-4, -1e-4, 1.0]])


def _apply(m, pts):
    q = m @ np.vstack([pts.T, np.ones(len(pts))])
    return (q[:2] / q[2]).T


def test_homography_on_exact_points_matches_cv2():
    rng = np.random.default_rng(3)
    m_true = _homography(rng)
    src = rng.uniform(0, 100, (20, 2)).astype(np.float32)
    dst = _apply(m_true, src.astype(np.float64)).astype(np.float32)
    want, _ = cv2.findHomography(src.reshape(-1, 1, 2), dst.reshape(-1, 1, 2),
                                 cv2.RANSAC, 10.0)
    got = P.homography_from_points(src, dst).numpy()
    np.testing.assert_allclose(got, want / want[2, 2], atol=1e-6)
    np.testing.assert_allclose(got, m_true, atol=1e-3)


def test_homography_finds_the_inliers_among_outliers():
    rng = np.random.default_rng(4)
    m_true = _homography(rng)
    src = rng.uniform(0, 200, (50, 2))
    dst = _apply(m_true, src)
    bad = rng.choice(50, 10, replace=False)                   # 20 %
    dst[bad] += rng.uniform(30, 80, (10, 2)) * rng.choice([-1, 1], (10, 2))
    got = P.homography_from_points(
        src, dst, generator=torch.Generator().manual_seed(7)).numpy()
    np.testing.assert_allclose(got, m_true, atol=1e-8)
    err = np.linalg.norm(_apply(got, src) - dst, axis=1)
    assert set(np.nonzero(err > 10)[0]) == set(bad)
    with pytest.raises(ValueError, match='4 or more'):
        P.homography_from_points(src[:3], dst[:3])


@pytest.mark.parametrize('dtype,tol,edge_tol', [(np.float32, 2e-4, 2e-3),
                                                (np.uint16, 1, 1),
                                                (np.uint8, 1, 1)])
def test_homography_warp_against_cv2(dtype, tol, edge_tol):
    yy, xx = np.mgrid[0:60, 0:90]
    img = 125 + 60 * np.sin(xx / 7.0) + 50 * np.cos(yy / 5.0)
    img = (img * (200 if dtype == np.uint16 else 1)).astype(dtype)
    m = np.array([[1.05, 0.03, -3.3], [-0.02, 0.97, 2.1], [1e-4, -2e-4, 1.0]])
    want = cv2.warpPerspective(img, m, (96, 64))
    got = P.homography_warp(torch.from_numpy(img), m, (96, 64)).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    diff = np.abs(got.astype(np.float64) - want)
    ty, tx = np.mgrid[0:64, 0:96]
    u, v = _apply(np.linalg.inv(m), np.stack([tx.ravel(), ty.ravel()],
                                             1)).T.reshape(2, 64, 96)
    inside = (u >= 0) & (u <= 89) & (v >= 0) & (v <= 59)
    assert diff[inside].max() <= tol, diff[inside].max()
    assert diff.max() <= edge_tol, diff.max()
    assert (want == 0).sum() > 100 and ((want == 0) == (got == 0)).mean() > .99


# the cases of tests/test_gated_warp.py, on the port

def test_identity_warp():
    img = np.random.default_rng(0).uniform(0, 255, (48, 64)).astype(
        np.float32)
    out, mask = P.depth_warp(torch.from_numpy(img), torch.full((48, 64), 5.0),
                             _k(), _k(), np.eye(4), (64, 48))
    assert mask.all()
    np.testing.assert_allclose(out[..., 0].numpy(), img, atol=1e-3)


def test_translated_camera_shifts_image():
    img = torch.zeros(48, 64)
    img[24, 32] = 1.0
    t = np.eye(4)
    t[0, 3] = 1.0
    out, _ = P.depth_warp(img, torch.full((48, 64), 10.0), _k(), _k(), t,
                          (64, 48))
    assert out[24, 42, 0].item() == 1.0


def test_zbuffer_keeps_nearest():
    img = torch.zeros(2, 2)
    img[0, 0], img[0, 1] = 1.0, 2.0
    depth = torch.tensor([[10.0, 5.0], [0, 0]])
    k = np.array([[1e-6, 0, 16.0], [0, 100.0, 12.0], [0, 0, 1.0]])
    out, _ = P.depth_warp(img, depth, k, k, np.eye(4), (32, 24))
    assert out[..., 0].max().item() == 2.0


def test_homography_roundtrip():
    rng = np.random.default_rng(1)
    src = rng.uniform(0, 100, (20, 2)).astype(np.float32)
    m_true = np.array([[1.1, 0.02, 5.0], [-0.01, 0.95, -3.0], [0, 0, 1.0]])
    dst = _apply(m_true, src.astype(np.float64)).astype(np.float32)
    m = P.homography_from_points(src, dst)
    np.testing.assert_allclose((m / m[2, 2]).numpy(), m_true, atol=1e-3)
    img = torch.from_numpy(rng.uniform(0, 1, (100, 100)).astype(np.float32))
    assert P.homography_warp(img, m, (100, 100)).shape == (100, 100)


def test_disparity_to_depth():
    depth = P.disparity_to_depth(torch.tensor([[0.0, 1.0], [2.0, 4.0]]),
                                 focal=100.0, baseline=0.2)
    assert depth[0, 0].item() == 0.0
    np.testing.assert_allclose(depth[0, 1].item(), 20.0)
    np.testing.assert_allclose(depth[1, 1].item(), 5.0)


def test_inverse_depth_warp_identity():
    img = np.random.default_rng(0).uniform(0, 255, (16, 20)).astype(
        np.float32)
    k = np.array([[10., 0., 10.], [0., 10., 8.], [0., 0., 1.]])
    out = P.inverse_depth_warp(torch.from_numpy(img),
                               torch.full((16, 20), 5.0), k, k, np.eye(4))
    np.testing.assert_allclose(out[..., 0].numpy(), img, atol=1e-4)


def test_inverse_depth_warp_translation_shifts():
    img = torch.zeros(16, 20)
    img[:, 10] = 1.0
    k = np.array([[10., 0., 10.], [0., 10., 8.], [0., 0., 1.]])
    t = np.eye(4)
    t[0, 3] = 1.0
    out = P.inverse_depth_warp(img, torch.full((16, 20), 5.0), k, k,
                               t)[..., 0]
    assert out[:, 8].min().item() > 0.99
    assert out[:, 10].max().item() < 1e-6


def test_ego_motion_offset_direction():
    np.testing.assert_allclose(P.ego_motion_offset(10.0, 0.0, 0.1),
                               [0.0, 0.0, -1.0], atol=1e-9)
    np.testing.assert_array_equal(P.ego_motion_offset(10.0, 12.0, 0.1),
                                  J.ego_motion_offset(10.0, 12.0, 0.1))


# the CLI

def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        'jax_stf_gated_warp', ROOT / 'tools' / 'stf_gated_warp.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_warp_frame_equals_the_jax_tool(tmp_path):
    """One frame at full size: three 720x1280 slices (uncompressed TIFFs,
    which both `cv2` and `data/tiff.py` read), a 1024x1920 disparity; the
    768x1280 crop equal to the JAX CLI's, from the raw slices (uint16)
    and from their 8-bit LUT images (`--lut8`, uint8)."""
    rng = np.random.default_rng(5)
    write_gated_frame(str(tmp_path), 'f_00001', rng)
    jax_tool = _jax_tool()
    for lut8, dtype in ((False, np.uint16), (True, np.uint8)):
        want = jax_tool.warp_frame(str(tmp_path), 'f_00001',
                                   'cam_stereo_sgm', use_lut8=lut8)
        got = stf_gated_warp.warp_frame(str(tmp_path), 'f_00001',
                                        'cam_stereo_sgm', use_lut8=lut8,
                                        device='cpu')
        assert got.dtype == dtype and got.shape == (768, 1280)
        np.testing.assert_array_equal(got, want)
        assert (want > 0).mean() > 0.8


def test_warp_frame_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        stf_gated_warp.warp_frame('r', 'f', 'cam_stereo_sgm')


def test_what_reaches_the_model_from_each_converter_mode(tmp_path):
    """The STF gated chain, converter to loader: `write_gated_frame` ->
    the port's `warp_frame` (uint16, or `--lut8`) -> `png.imwrite` ->
    `LoadGatedImageFromFile` (`'grayscale'`, as both packages read it).
    A uint16 PNG keeps its high byte only: the 10-bit warp (0-1023)
    reaches the model as at most 4 grey levels; the `--lut8` PNG reaches
    it with its 8-bit levels intact."""
    from hrfuser_tpu_torch.data import png
    from hrfuser_tpu_torch.data.pipelines.loading import (
        LoadGatedImageFromFile)
    write_gated_frame(str(tmp_path), 'f_00001', np.random.default_rng(0))
    seen = {}
    for lut8 in (False, True):
        warped = stf_gated_warp.warp_frame(str(tmp_path), 'f_00001',
                                           'cam_stereo_sgm', use_lut8=lut8,
                                           device='cpu')
        folder = 'lut8' if lut8 else 'grey16'
        os.makedirs(tmp_path / folder, exist_ok=True)
        png.imwrite(str(tmp_path / folder / 'f_00001.png'), warped)
        out = LoadGatedImageFromFile(folder)(
            {'gated_prefix': str(tmp_path),
             'img_info': {'filename': 'f_00001.png'}})
        loaded = out['gated_img'][..., 0]
        seen[folder] = (len(np.unique(warped)), len(np.unique(loaded)))
        if lut8:
            np.testing.assert_array_equal(loaded, warped)
        else:
            np.testing.assert_array_equal(loaded, warped >> 8)
    print(f'distinct values (warp, loaded): {seen}')
    assert seen['grey16'][0] > 400 and seen['grey16'][1] <= 4
    assert seen['lut8'][1] == seen['lut8'][0] > 100
