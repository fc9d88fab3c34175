"""The port's 3D box utilities (`ops/box3d.py`, float64 tensors) against
`hrfuser_tpu/ops/box3d.py` on the same seeded numpy inputs, at 1e-12,
and the cases of `tests/test_box3d.py` on the port."""

import numpy as np
import pytest
import torch

from hrfuser_tpu.ops import box3d as J
from hrfuser_tpu_torch.ops import box3d as P

TOL = dict(rtol=1e-12, atol=1e-12)
VELO2CAM = np.array([[0., -1., 0., 0.], [0., 0., -1., 0.],
                     [1., 0., 0., 0.27], [0., 0., 0., 1.]])


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float64))


def _close(got, want):
    assert got.dtype in (torch.float64, torch.bool)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _boxes(rng, n):
    return np.concatenate([rng.uniform(-20, 20, (n, 3)),
                           rng.uniform(0.5, 5, (n, 3)),
                           rng.uniform(-np.pi, np.pi, (n, 1))], 1)


def test_frame_transforms_equal_jax():
    rng = np.random.default_rng(0)
    r_rect = np.eye(4)
    r_rect[:3, :3] = J.rotation_3d_in_axis(np.eye(3)[None], np.array([0.01]),
                                           0)[0]
    pts = rng.normal(0, 10, (50, 3))
    boxes = _boxes(rng, 20)
    _close(P.lidar_to_camera(_t(pts), r_rect, VELO2CAM),
           J.lidar_to_camera(pts, r_rect, VELO2CAM))
    _close(P.camera_to_lidar(_t(pts), r_rect, VELO2CAM),
           J.camera_to_lidar(pts, r_rect, VELO2CAM))
    _close(P.box_camera_to_lidar(_t(boxes), r_rect, VELO2CAM),
           J.box_camera_to_lidar(boxes, r_rect, VELO2CAM))


@pytest.mark.parametrize('axis', [0, 1, 2])
def test_corners_and_rotation_equal_jax(axis):
    rng = np.random.default_rng(1)
    boxes = _boxes(rng, 30)
    _close(P.center_to_corner_box3d(_t(boxes[:, :3]), _t(boxes[:, 3:6]),
                                    _t(boxes[:, 6]), axis=axis),
           J.center_to_corner_box3d(boxes[:, :3], boxes[:, 3:6], boxes[:, 6],
                                    axis=axis))
    _close(P.corners_nd(_t(boxes[:, 3:5]), 0.5),
           J.corners_nd(boxes[:, 3:5], 0.5))


def test_projection_and_boxes_equal_jax():
    rng = np.random.default_rng(2)
    boxes = _boxes(rng, 30)
    boxes[:, 2] = rng.uniform(5, 40, 30)
    k = np.array([[720., 0., 600.], [0., 720., 180., ], [0., 0., 1.]])
    pts = rng.uniform([-10, -5, 1], [10, 5, 40], (40, 3))
    _close(P.points_cam2img(_t(pts), k), J.points_cam2img(pts, k))
    _close(P.points_cam2img(_t(pts), k, with_depth=True),
           J.points_cam2img(pts, k, with_depth=True))
    _close(P.box3d_to_bbox(_t(boxes), k), J.box3d_to_bbox(boxes, k))
    _close(P.limit_period(_t(boxes[:, 6] * 3)),
           J.limit_period(boxes[:, 6] * 3))
    lidar_pts = rng.uniform(-20, 20, (300, 3))
    np.testing.assert_array_equal(
        P.points_in_rbbox(_t(lidar_pts), _t(boxes)).numpy(),
        J.points_in_rbbox(lidar_pts, boxes))
    scan = np.concatenate([rng.uniform([-30, -30, -2], [30, 30, 2],
                                       (300, 3)), rng.uniform(0, 1, (300, 1))],
                          1)
    np.testing.assert_array_equal(
        P.remove_outside_points(_t(scan), np.eye(4), VELO2CAM, k,
                                (360, 1200)).numpy(),
        J.remove_outside_points(scan, np.eye(4), VELO2CAM, k, (360, 1200)))


@pytest.mark.parametrize('mode,eps', [('iou', 0.0), ('iof', 0.0),
                                      ('iou', 1.0)])
def test_iou_2d_equals_jax(mode, eps):
    rng = np.random.default_rng(3)
    xy = rng.uniform(0, 50, (40, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(1, 20, (40, 2))], 1)
    _close(P.iou_2d(_t(boxes[:25]), _t(boxes[25:]), mode, eps),
           J.iou_2d(boxes[:25], boxes[25:], mode, eps))


# the cases of tests/test_box3d.py, on the port

def test_camera_lidar_roundtrip():
    pts = np.random.default_rng(0).normal(0, 10, (50, 3))
    back = P.camera_to_lidar(P.lidar_to_camera(_t(pts), np.eye(4), VELO2CAM),
                             np.eye(4), VELO2CAM)
    np.testing.assert_allclose(back.numpy(), pts, atol=1e-9)


def test_center_to_corner_box3d_axis_aligned():
    c = P.center_to_corner_box3d(_t([[1., 2., 3.]]), _t([[2., 4., 6.]]),
                                 angles=_t([0.0])).numpy()
    assert c.shape == (1, 8, 3)
    np.testing.assert_allclose(c[0].min(0), [0., -2., 0.])
    np.testing.assert_allclose(c[0].max(0), [2., 2., 6.])


def test_corner_rotation_yaw90():
    c = P.center_to_corner_box3d(_t([[0., 0., 0.]]), _t([[2., 1., 4.]]),
                                 angles=_t([np.pi / 2]),
                                 origin=(0.5, 0.5, 0.5)).numpy()
    np.testing.assert_allclose(c[0].max(0), [2., 0.5, 1.], atol=1e-9)


def test_points_cam2img():
    k = np.array([[100., 0., 50., 0.], [0., 100., 60., 0.], [0., 0., 1., 0.]])
    p = _t([[[2., 4., 2.]]])
    np.testing.assert_allclose(P.points_cam2img(p, k).numpy(),
                               [[[150., 260.]]])
    np.testing.assert_allclose(
        P.points_cam2img(p, k, with_depth=True)[..., 2].numpy(), [[2.0]])


def test_box3d_to_bbox_contains_projection():
    k = np.array([[100., 0., 50.], [0., 100., 60.], [0., 0., 1.]])
    x1, y1, x2, y2 = P.box3d_to_bbox(_t([[0., 1., 10., 2., 2., 2., 0.]]),
                                     k)[0].tolist()
    assert x1 < 50 < x2 and y1 < 60 < y2


def test_points_in_rbbox():
    m = P.points_in_rbbox(_t([[1.5, 0., 0.5], [0., 1.5, 0.5], [0., 0., 2.5]]),
                          _t([[0., 0., 0., 2., 4., 2., np.pi / 2]]))
    assert m[:, 0].tolist() == [True, False, False]


def test_limit_period():
    np.testing.assert_allclose(P.limit_period(_t([np.pi * 1.25])).numpy(),
                               [np.pi * 0.25], atol=1e-12)


def test_iou_2d_modes():
    b = _t([[0., 0., 2., 2.]])
    q = _t([[1., 1., 3., 3.], [4., 4., 5., 5.]])
    np.testing.assert_allclose(P.iou_2d(b, q).numpy(), [[1. / 7., 0.]])
    np.testing.assert_allclose(P.iou_2d(b, q, mode='iof').numpy(),
                               [[0.25, 0.]])


def test_remove_outside_points():
    v2c = np.array([[0., -1., 0., 0.], [0., 0., -1., 0.], [1., 0., 0., 0.],
                    [0., 0., 0., 1.]])
    k = np.array([[100., 0., 50.], [0., 100., 60.], [0., 0., 1.]])
    pts = _t([[10., 0., 0., 1.], [-10., 0., 0., 1.], [10., 30., 0., 1.]])
    kept = P.remove_outside_points(pts, np.eye(4), v2c, k, (120, 100))
    assert kept.shape == (1, 4)
    np.testing.assert_allclose(kept[0, :3].numpy(), [10., 0., 0.])


def test_box_camera_to_lidar_dims():
    lid = P.box_camera_to_lidar(_t([[1., 2., 3., 4., 1.5, 1.8, 0.3]]),
                                np.eye(4), np.eye(4))
    np.testing.assert_allclose(lid[0, 3:6].numpy(), [1.8, 4., 1.5])
    np.testing.assert_allclose(lid[0, 6].item(), -0.3 - np.pi / 2)
