"""Offline sensor -> image-plane projection, on the tensors' device.

Port of `hrfuser_tpu/data/projection.py`: nuScenes lidar / radar ->
camera-plane "sensor images" and the STF variant. The point functions
(`project_to_image`, `splat_*`, `stf_splat`, `radar_pillar_endpoints`)
take tensors on any device and return int32 tensors holding the uint16
values; the calibration math (`quat_to_rot`, `transform_matrix`) and the
per-box 2D helpers (`box3d_corners`, `convex_hull_2d`,
`clip_polygon_to_rect`, `box3d_to_2d`) stay float64 numpy on the host,
as in JAX, so the annotation JSON comes out byte-equal.

Storage format: uint16 PNG, value = (raw + shift) * scale with
scale = 100, shift = 200, truncated; the background, shift * scale,
dequantizes to 0.

Bit-equal to the JAX loops, on every device:
- geometry, pixel rounding and quantisation run in the inputs' dtype
  (float64 for points), as numpy does; matrices are applied as sums of
  elementwise products in a fixed order, and divisors are device
  tensors (CUDA divides by a Python scalar as a multiply by its
  reciprocal);
- where several points land on one pixel, the winner is decided by
  `scatter_reduce` over point indices, never by repeated-index writes,
  whose winner CUDA leaves undefined. `mode='reference'`: the last point
  wins (the reference compares its quantized buffer with the raw
  distance, always true after the first write). `mode='zbuffer'`: the
  first point of least depth wins (a point is skipped when `depth <= d`).
- nuScenes radar pillars in zbuffer mode depend on the order of the
  pillars (a skipped pillar leaves no mark), so they are resolved column
  by column, the k-th pillar of every column at step k.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

SCALE = 100.0
SHIFT = 200.0
MODES = ('reference', 'zbuffer')


def quantize(values: np.ndarray, scale: float = SCALE,
             shift: float = SHIFT) -> np.ndarray:
    return ((values + shift) * scale).astype(np.uint16)


def dequantize(img: np.ndarray, scale: float = SCALE,
               shift: float = SHIFT) -> np.ndarray:
    return img.astype(np.float32) / scale - shift


def quat_to_rot(q) -> np.ndarray:
    """Quaternion (w, x, y, z) -> 3x3 rotation matrix."""
    w, x, y, z = q
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n == 0 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array([
        [1 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1 - (xx + yy)],
    ])


def transform_matrix(translation, rotation_quat,
                     inverse: bool = False) -> np.ndarray:
    """4x4 homogeneous transform from translation + quaternion."""
    tm = np.eye(4)
    rot = quat_to_rot(rotation_quat)
    if inverse:
        tm[:3, :3] = rot.T
        tm[:3, 3] = -rot.T @ np.asarray(translation)
    else:
        tm[:3, :3] = rot
        tm[:3, 3] = np.asarray(translation)
    return tm


def to_uint16(img: Tensor) -> np.ndarray:
    """An int32 image of uint16 values -> a host uint16 array (moved as
    its int16 bits, half the bytes)."""
    return img.to(torch.int16).cpu().numpy().view(np.uint16)


def apply_matrix(m, points: Tensor) -> Tensor:
    """`m @ points` for a small matrix `m` [R, K] and points [K, ...] on
    any device; `m` [R, K + 1] applies a homogeneous transform
    (`(m @ [points; 1])[:R]`). `m` is a host matrix, or a tensor
    [R, K (+ 1), ...] whose trailing dimensions broadcast against a row
    of points (a matrix per camera, per point). Sums of elementwise
    products in column order, so every device rounds alike."""
    if not torch.is_tensor(m):
        m = np.asarray(m, np.float64).tolist()
    rows = []
    for row in m:
        acc = points[0] * row[0]
        for k in range(1, points.shape[0]):
            acc = acc + points[k] * row[k]
        if len(row) == points.shape[0] + 1:
            acc = acc + row[-1]
        rows.append(acc)
    return torch.stack(rows)


def project_to_image(points_cam: Tensor, intrinsic,
                     img_wh: Tuple[int, int], min_dist: float = 1.0
                     ) -> Tuple[Tensor, Tensor]:
    """Pinhole projection of camera-frame points [3, ...] with a 3x3
    `intrinsic` (see `apply_matrix`): (uv [2, ...], mask [...]), the
    mask selecting points in front (`z > min_dist`) and inside the image
    (`img_wh`: ints, or tensors broadcast against the points) with a
    1 px margin (`map_pointcloud_to_image`)."""
    w, h = img_wh
    z = points_cam[2]
    uvw = apply_matrix(intrinsic, points_cam)
    uv = uvw[:2] / torch.clamp_min(uvw[2:3], 1e-9)
    mask = ((z > min_dist) & (uv[0] > 1) & (uv[0] < w - 1)
            & (uv[1] > 1) & (uv[1] < h - 1))
    return uv, mask


def _prep_pixels(uv: Tensor, scale_factor: float,
                 img_wh: Tuple[int, int]) -> Tensor:
    """Round (half to even, as `np.rint`) + clip projected pixels onto
    the target grid: [N, 2] int64 (x, y)."""
    w, h = img_wh
    scale = torch.tensor(scale_factor, dtype=uv.dtype, device=uv.device)
    px = torch.round(uv.T / scale)
    px = torch.stack([px[:, 0].clamp(0, w - 1), px[:, 1].clamp(0, h - 1)],
                     1)
    return px.to(torch.int64)


def _quantize(values: Tensor) -> Tensor:
    """`np.uint16((v + SHIFT) * SCALE)` in the values' dtype: truncated,
    wrapped to 16 bits; int32."""
    return (((values + SHIFT) * SCALE).to(torch.int64) & 0xFFFF).to(
        torch.int32)


def last_writer(lin: Tensor, n_pix: int) -> Tensor:
    """Per pixel, the largest index of the points on it (-1: none)."""
    idx = torch.arange(lin.numel(), device=lin.device)
    return torch.full((n_pix,), -1, dtype=torch.int64,
                      device=lin.device).scatter_reduce(0, lin, idx, 'amax')


def nearest_writer(lin: Tensor, depth: Tensor, n_pix: int) -> Tensor:
    """Per pixel, the first of its points of least depth (-1: none)."""
    inf = torch.tensor(float('inf'), dtype=depth.dtype, device=depth.device)
    dmin = inf.expand(n_pix).clone().scatter_reduce(0, lin, depth, 'amin')
    n = lin.numel()
    idx = torch.arange(n, device=lin.device)
    idx = torch.where((depth == dmin[lin]) & (depth < inf), idx, n)
    win = torch.full((n_pix,), n, dtype=torch.int64,
                     device=lin.device).scatter_reduce(0, lin, idx, 'amin')
    return torch.where(win == n, -1, win)


def _winners(lin: Tensor, depth: Tensor, n_pix: int, mode: str) -> Tensor:
    if mode not in MODES:
        raise ValueError(f'mode {mode!r}: one of {MODES}')
    if mode == 'reference':
        return last_writer(lin, n_pix)
    return nearest_writer(lin, depth, n_pix)


def _paint(win: Tensor, q: Tensor) -> Tensor:
    """Each pixel's winner's quantized values (the background where it
    has none): [n_pix, C] int32."""
    bg = torch.full((1, q.shape[1]), int(SCALE * SHIFT), dtype=torch.int32,
                    device=q.device)
    q = torch.cat([q, bg])
    return q[torch.where(win < 0, q.shape[0] - 1, win)]


def splat_lidar(uv: Tensor, distances: Tensor, intensities: Tensor,
                points_cam: Tensor, target_wh: Tuple[int, int] = (640, 360),
                scale_factor: float = 2.5, mode: str = 'reference',
                image: Optional[Tensor] = None, n_images: int = 1
                ) -> Tuple[Tensor, Tensor]:
    """Lidar points -> (rih, xz0) [H, W, 3] images; given `image`, each
    point's image index, [n_images, H, W, 3] (the images of several
    cameras in one pass, each as if splatted alone).

    Channels: range, intensity, height (= -y_cam) and x_cam, z_cam, 0.
    """
    w, h = target_wh
    px = _prep_pixels(uv, scale_factor, target_wh)
    lin = px[:, 1] * w + px[:, 0]
    if image is not None:
        lin = lin + image * (h * w)
    win = _winners(lin, distances, n_images * h * w, mode)
    q = torch.stack([_quantize(distances), _quantize(intensities),
                     _quantize(-points_cam[1]), _quantize(points_cam[0]),
                     _quantize(points_cam[2])], 1)
    img = _paint(win, q).reshape(*(() if image is None else (n_images,)),
                                 h, w, 5)
    bg = torch.full_like(img[..., :1], int(SCALE * SHIFT))
    return img[..., :3], torch.cat([img[..., 3:], bg], -1)


def _pillars_zbuffer(x: Tensor, top: Tensor, bot: Tensor, d: Tensor,
                     q: Tensor, target_wh: Tuple[int, int]) -> Tensor:
    """Order-dependent nuScenes pillars: a pillar is drawn when its depth
    is below every depth already drawn in its rows, and then sets them.
    Columns are independent, so step k draws the k-th pillar of every
    column at once. Returns [H, W, C] int32."""
    w, h = target_wh
    dev = x.device
    depth = torch.full((h, w), float('inf'), dtype=d.dtype, device=dev)
    img = torch.full((h, w, q.shape[1]), int(SCALE * SHIFT),
                     dtype=torch.int32, device=dev)
    if x.numel() == 0:
        return img
    order = torch.argsort(x, stable=True)           # by column, input order
    counts = torch.bincount(x, minlength=w)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=dev) - start[x[order]]
    by_step = torch.argsort(rank, stable=True)
    per_step = torch.bincount(rank).tolist()
    rows = torch.arange(h, device=dev)[:, None]
    for sel in torch.split(by_step, per_step):
        xs = x[sel]
        inside = (rows >= top[sel]) & (rows < bot[sel])           # [H, A]
        col = depth[:, xs]
        seen = torch.where(inside, col, torch.inf).amin(0)
        drawn = inside & ~(seen <= d[sel])
        depth[:, xs] = torch.where(drawn, torch.minimum(col, d[sel]), col)
        img[:, xs] = torch.where(drawn[..., None], q[sel], img[:, xs])
    return img


def splat_radar_pillars(uv: Tensor, uv_top: Tensor, distances: Tensor,
                        rcs: Tensor, velocities: Tensor, points_cam: Tensor,
                        target_wh: Tuple[int, int] = (640, 360),
                        scale_factor: float = 2.5, mode: str = 'reference',
                        image: Optional[Tensor] = None, n_images: int = 1
                        ) -> Tuple[Tensor, Tensor]:
    """Radar points -> (riv, xz0) [H, W, 3] images of vertical pillars;
    given `image`, [n_images, H, W, 3] as `splat_lidar`.

    Each return is drawn down its column over the half-open rows
    [y_top, y) from its projected top endpoint (3 m up, computed by the
    caller) to its ground projection; a pillar with y <= y_top is
    skipped. Channels: range (xz-plane), RCS, ego-motion-compensated
    speed, and x_cam, z_cam, 0.
    """
    if mode not in MODES:
        raise ValueError(f'mode {mode!r}: one of {MODES}')
    w, h = target_wh
    px = _prep_pixels(uv, scale_factor, target_wh)
    top = _prep_pixels(uv_top, scale_factor, target_wh)[:, 1]
    q = torch.stack([_quantize(distances), _quantize(rcs),
                     _quantize(velocities), _quantize(points_cam[0]),
                     _quantize(points_cam[2])], 1)
    keep = torch.nonzero(px[:, 1] > top)[:, 0]
    x, top, bot = px[keep, 0], top[keep], px[keep, 1]
    b = 0 if image is None else image[keep]
    if mode == 'zbuffer':
        # the images side by side: a column of image b is column b * W + x
        img = _pillars_zbuffer(x + b * w, top, bot, distances[keep], q[keep],
                               (n_images * w, h))
        if image is not None:
            img = img.reshape(h, n_images, w, 5).transpose(0, 1)
    else:
        lens = bot - top
        pillar = torch.repeat_interleave(
            torch.arange(keep.numel(), device=keep.device), lens)
        first = torch.cumsum(lens, 0) - lens
        row = top[pillar] + torch.arange(pillar.numel(),
                                         device=keep.device) - first[pillar]
        if image is not None:
            row = row + b[pillar] * h
        win = last_writer(row * w + x[pillar], n_images * h * w)
        win = torch.where(win < 0, -1, pillar[win.clamp_min(0)])
        img = _paint(win, q[keep]).reshape(
            *(() if image is None else (n_images,)), h, w, 5)
    bg = torch.full_like(img[..., :1], int(SCALE * SHIFT))
    return img[..., :3], torch.cat([img[..., 3:], bg], -1)


def stf_splat(img_coords: Tensor, values: Tensor,
              target_wh: Tuple[int, int] = (1280, 768),
              radar: bool = False, mode: str = 'reference') -> Tensor:
    """STF lidar / radar -> [H, W, 3] image (`run_2d_projection_on_
    dataset.py:create_img`).

    Lidar: per-pixel (y, z, intensity) of the last point (`mode` is not
    read, as in JAX). Radar: full-height columns of (height y, depth z,
    velocity) per return; in zbuffer mode the first return of least
    depth (`values[:, 1]`) in a column wins.

    Args:
        img_coords: [N, 2] integer (x, y) pixels inside the image.
        values: [N, 3] raw channel values.
    """
    w, h = target_wh
    coords = img_coords.to(torch.int64)
    q = _quantize(values)
    if not radar:
        lin = coords[:, 1] * w + coords[:, 0]
        return _paint(last_writer(lin, h * w), q).reshape(h, w, 3)
    win = _winners(coords[:, 0], values[:, 1], w, mode)
    return _paint(win, q)[None].expand(h, w, 3).contiguous()


def radar_pillar_endpoints(points_sensor: Tensor,
                           pillar_height: float = 3.0) -> Tensor:
    """Top endpoints of radar pillars in the sensor frame: same (x, y),
    z raised to `pillar_height` (`nuscenes_explorer.py:966-971`)."""
    top = points_sensor.clone()
    top[2] = pillar_height
    return top


def box3d_corners(center, size, quat_wxyz) -> np.ndarray:
    """8 corners [3, 8] of a 3D box (w, l, h sizes; nuScenes convention:
    x-right/size[0]=w, y-forward/size[1]=l, z-up/size[2]=h)."""
    w, l, h = size
    x = np.array([1, 1, 1, 1, -1, -1, -1, -1]) * (l / 2.0)
    y = np.array([1, -1, -1, 1, 1, -1, -1, 1]) * (w / 2.0)
    z = np.array([1, 1, -1, -1, 1, 1, -1, -1]) * (h / 2.0)
    corners = np.stack([x, y, z])
    return quat_to_rot(quat_wxyz) @ corners + np.asarray(center)[:, None]


def convex_hull_2d(pts: np.ndarray) -> np.ndarray:
    """Convex hull of [N, 2] points (Andrew's monotone chain), CCW order."""
    pts = np.unique(np.asarray(pts, np.float64), axis=0)
    if len(pts) <= 2:
        return pts
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    pts = pts[order]

    def cross(o, a, b):
        return ((a[0] - o[0]) * (b[1] - o[1])
                - (a[1] - o[1]) * (b[0] - o[0]))

    lower: list = []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    upper: list = []
    for p in pts[::-1]:
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    return np.asarray(lower[:-1] + upper[:-1])


def clip_polygon_to_rect(poly: np.ndarray, x_max: float, y_max: float,
                         x_min: float = 0.0, y_min: float = 0.0
                         ) -> np.ndarray:
    """Sutherland-Hodgman clip of a convex polygon against an axis-aligned
    rectangle: the clipped vertices [M, 2], possibly none."""
    def clip_edge(pts, inside, intersect):
        out = []
        n = len(pts)
        for i in range(n):
            cur, nxt = pts[i], pts[(i + 1) % n]
            cin, nin = inside(cur), inside(nxt)
            if cin:
                out.append(cur)
                if not nin:
                    out.append(intersect(cur, nxt))
            elif nin:
                out.append(intersect(cur, nxt))
        return out

    def x_cut(a, b, x):
        t = (x - a[0]) / (b[0] - a[0])
        return np.array([x, a[1] + t * (b[1] - a[1])])

    def y_cut(a, b, y):
        t = (y - a[1]) / (b[1] - a[1])
        return np.array([a[0] + t * (b[0] - a[0]), y])

    pts = [p for p in np.asarray(poly, np.float64)]
    for inside, intersect in (
            (lambda p: p[0] >= x_min, lambda a, b: x_cut(a, b, x_min)),
            (lambda p: p[0] <= x_max, lambda a, b: x_cut(a, b, x_max)),
            (lambda p: p[1] >= y_min, lambda a, b: y_cut(a, b, y_min)),
            (lambda p: p[1] <= y_max, lambda a, b: y_cut(a, b, y_max))):
        if not pts:
            return np.zeros((0, 2))
        pts = clip_edge(pts, inside, intersect)
    return np.asarray(pts) if pts else np.zeros((0, 2))


def box3d_to_2d(corners_cam: np.ndarray, intrinsic: np.ndarray,
                img_wh: Tuple[int, int]) -> Optional[Tuple[float, ...]]:
    """Tight 2D box from camera-frame 3D corners
    (`nuscenes_converter.get_2d_boxes` / `post_process_coords`): corners
    behind the camera (z <= 0) dropped, the convex hull of the projected
    corners intersected with the canvas, and the intersection's bounding
    box returned. None if no corner is in front or the hull misses the
    canvas."""
    front = corners_cam[2] > 0
    if not front.any():
        return None
    pts = intrinsic @ corners_cam[:, front]
    uv = (pts[:2] / pts[2:3]).T                           # [N, 2]
    w, h = img_wh
    hull = convex_hull_2d(uv)
    if len(hull) == 1:                                    # degenerate: point
        clipped = hull if (0 <= hull[0, 0] <= w
                           and 0 <= hull[0, 1] <= h) else np.zeros((0, 2))
    elif len(hull) == 2:                                  # degenerate: segment
        clipped = clip_polygon_to_rect(np.vstack([hull, hull[::-1]]), w, h)
    else:
        clipped = clip_polygon_to_rect(hull, w, h)
    if len(clipped) == 0:
        return None
    x1, y1 = clipped.min(axis=0)
    x2, y2 = clipped.max(axis=0)
    if x2 <= x1 or y2 <= y1:
        return None
    return float(x1), float(y1), float(x2), float(y2)

