"""3D box utilities for the offline tooling, on float64 tensors.

Port of `hrfuser_tpu/ops/box3d.py` (the parts of mmdet's
`box_np_ops.py` the converters and KITTI tooling use): frame transforms
(camera <-> lidar), box -> corner expansion with yaw rotation, image
projection, point-in-box tests and axis-aligned IoU. Every function runs
where its tensors live.

Conventions: KITTI camera boxes are [x, y, z, l, h, w, ry] with the
origin at the bottom center; lidar boxes [x, y, z, w, l, h, yaw].
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def _homogeneous(points: Tensor) -> Tensor:
    return torch.cat([points[:, :3], torch.ones_like(points[:, :1])], 1)


def _rect_velo(r_rect: Tensor, velo2cam: Tensor, like: Tensor) -> Tensor:
    return (torch.as_tensor(r_rect, dtype=like.dtype, device=like.device)
            @ torch.as_tensor(velo2cam, dtype=like.dtype, device=like.device))


def camera_to_lidar(points: Tensor, r_rect: Tensor,
                    velo2cam: Tensor) -> Tensor:
    """Camera-rect frame -> lidar frame ([N, 3] -> [N, 3])."""
    m = _rect_velo(r_rect, velo2cam, points)
    return (_homogeneous(points) @ torch.linalg.inv(m.T))[:, :3]


def lidar_to_camera(points: Tensor, r_rect: Tensor,
                    velo2cam: Tensor) -> Tensor:
    m = _rect_velo(r_rect, velo2cam, points)
    return (_homogeneous(points) @ m.T)[:, :3]


def box_camera_to_lidar(boxes: Tensor, r_rect: Tensor,
                        velo2cam: Tensor) -> Tensor:
    """KITTI camera boxes [x,y,z,l,h,w,ry] -> lidar [x,y,z,w,l,h,yaw]."""
    xyz = camera_to_lidar(boxes[:, :3], r_rect, velo2cam)
    l, h, w = boxes[:, 3:4], boxes[:, 4:5], boxes[:, 5:6]
    yaw = -boxes[:, 6:7] - math.pi / 2
    return torch.cat([xyz, w, l, h, yaw], 1)


def rotation_3d_in_axis(points: Tensor, angles: Tensor,
                        axis: int = 2) -> Tensor:
    """Rotate [N, M, 3] point sets by per-box angles around one axis."""
    s, c = torch.sin(angles), torch.cos(angles)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    if axis == 2:
        rot = [c, -s, z, s, c, z, z, z, o]
    elif axis == 1:
        rot = [c, z, s, z, o, z, -s, z, c]
    elif axis == 0:
        rot = [o, z, z, z, c, -s, z, s, c]
    else:
        raise ValueError(axis)
    rot = torch.stack(rot, -1).reshape(-1, 3, 3)          # [N, 3, 3]
    return torch.einsum('nij,nmj->nmi', rot, points)


def corners_nd(dims: Tensor, origin=0.5) -> Tensor:
    """[N, D] dims -> [N, 2**D, D] axis-aligned corner offsets."""
    d = dims.shape[1]
    axes = [torch.tensor([0.0, 1.0], dtype=dims.dtype,
                         device=dims.device)] * d
    grid = torch.stack(torch.meshgrid(*axes, indexing='ij'), -1).reshape(
        -1, d)
    origin = torch.as_tensor(origin, dtype=dims.dtype,
                             device=dims.device).expand(d)
    return (grid[None] - origin[None, None]) * dims[:, None, :]


def center_to_corner_box3d(centers: Tensor, dims: Tensor,
                           angles: Optional[Tensor] = None,
                           origin=(0.5, 1.0, 0.5),
                           axis: int = 1) -> Tensor:
    """[N, 3] centers + dims (+yaw) -> [N, 8, 3] corners. The default
    origin (0.5, 1.0, 0.5) and axis 1 are the KITTI camera-frame
    convention (bottom-center origin, yaw about y)."""
    corners = corners_nd(dims, origin)
    if angles is not None:
        corners = rotation_3d_in_axis(corners, angles, axis)
    return corners + centers[:, None, :]


def points_cam2img(points_3d: Tensor, proj: Tensor,
                   with_depth: bool = False) -> Tensor:
    """[..., 3] camera points -> [..., 2] pixels via a 3x4 / 4x4 P."""
    shape = points_3d.shape[:-1]
    pts = points_3d.reshape(-1, 3)
    proj = torch.as_tensor(proj, dtype=pts.dtype, device=pts.device)
    p4 = torch.eye(4, dtype=pts.dtype, device=pts.device)
    p4[:proj.shape[0], :proj.shape[1]] = proj
    uvw = _homogeneous(pts) @ p4.T
    uv = uvw[:, :2] / uvw[:, 2:3]
    if with_depth:
        return torch.cat([uv, uvw[:, 2:3]], 1).reshape(*shape, 3)
    return uv.reshape(*shape, 2)


def box3d_to_bbox(boxes: Tensor, proj: Tensor) -> Tensor:
    """KITTI camera boxes [N, 7] -> tight image boxes [N, 4]."""
    corners = center_to_corner_box3d(boxes[:, :3], boxes[:, 3:6],
                                     boxes[:, 6])
    uv = points_cam2img(corners, proj)                   # [N, 8, 2]
    return torch.cat([uv.amin(1), uv.amax(1)], 1)


def limit_period(val: Tensor, offset: float = 0.5,
                 period: float = math.pi) -> Tensor:
    """Wrap angles into [-offset*period, (1-offset)*period)."""
    return val - torch.floor(val / period + offset) * period


def points_in_rbbox(points: Tensor, boxes: Tensor,
                    origin=(0.5, 0.5, 0.0)) -> Tensor:
    """[P, 3] points x [N, 7] lidar boxes -> [P, N] membership mask
    (points rotated into each box frame, yaw about z, and compared with
    the half-dims)."""
    dims, yaw = boxes[:, 3:6], boxes[:, 6]
    rel = points[:, None, :3] - boxes[None, :, :3]       # [P, N, 3]
    s, c = torch.sin(-yaw), torch.cos(-yaw)
    x = rel[..., 0] * c[None] - rel[..., 1] * s[None]
    y = rel[..., 0] * s[None] + rel[..., 1] * c[None]
    z = rel[..., 2]
    org = torch.as_tensor(origin, dtype=dims.dtype, device=dims.device)
    lo = -dims * org[None, :]
    hi = dims * (1.0 - org[None, :])
    return ((x >= lo[None, :, 0]) & (x <= hi[None, :, 0])
            & (y >= lo[None, :, 1]) & (y <= hi[None, :, 1])
            & (z >= lo[None, :, 2]) & (z <= hi[None, :, 2]))


def iou_2d(boxes: Tensor, query: Tensor, mode: str = 'iou',
           eps: float = 0.0) -> Tensor:
    """Axis-aligned [N, 4] x [K, 4] IoU / IoF (`box_np_ops.iou_jit`,
    the +eps pixel convention included)."""
    area_q = ((query[:, 2] - query[:, 0] + eps)
              * (query[:, 3] - query[:, 1] + eps))
    area_b = ((boxes[:, 2] - boxes[:, 0] + eps)
              * (boxes[:, 3] - boxes[:, 1] + eps))
    iw = (torch.minimum(boxes[:, None, 2], query[None, :, 2])
          - torch.maximum(boxes[:, None, 0], query[None, :, 0]) + eps)
    ih = (torch.minimum(boxes[:, None, 3], query[None, :, 3])
          - torch.maximum(boxes[:, None, 1], query[None, :, 1]) + eps)
    inter = iw.clamp_min(0) * ih.clamp_min(0)
    if mode == 'iou':
        union = area_b[:, None] + area_q[None, :] - inter
    else:                                                # 'iof'
        union = area_b[:, None].expand_as(inter)
    return torch.where(inter > 0, inter / union.clamp_min(1e-12),
                       torch.zeros_like(inter))


def remove_outside_points(points: Tensor, r_rect: Tensor,
                          velo2cam: Tensor, proj: Tensor,
                          image_shape: Tuple[int, int]) -> Tensor:
    """Lidar points that project inside the image and in front of the
    camera."""
    cam = lidar_to_camera(points[:, :3], r_rect, velo2cam)
    uvz = points_cam2img(cam, proj, with_depth=True)
    h, w = image_shape
    keep = ((uvz[:, 2] > 0) & (uvz[:, 0] >= 0) & (uvz[:, 0] < w)
            & (uvz[:, 1] >= 0) & (uvz[:, 1] < h))
    return points[keep]
