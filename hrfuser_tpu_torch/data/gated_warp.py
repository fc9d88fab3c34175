"""STF gated-camera -> RGB-frame warping, on the tensors' device.

Port of `hrfuser_tpu/data/gated_warp.py` (the Gated2RGB preprocessing,
`SeeingThroughFog/tools/ProjectionTools/Gated2RGB/`): the gated slices
are re-rendered into the RGB camera frame either per pixel through
stereo depth and the calib TF tree (`depth_warp`, `inverse_depth_warp`)
or through a global homography (`homography_from_points`,
`homography_warp`, in place of `cv2.findHomography` /
`cv2.warpPerspective`). Images and depth maps are tensors on any
device; camera matrices and extrinsics are small host arrays, applied
as sums of elementwise products (`projection.apply_matrix`), so every
device rounds alike. The geometry runs in float64, as numpy does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from hrfuser_tpu_torch.data.projection import apply_matrix, nearest_writer

Tensor = torch.Tensor
RANSAC_HYPOTHESES = 2000


def _pixel_grid(h: int, w: int, device) -> Tuple[Tensor, Tensor]:
    """Row-major (x, y) float64 coordinates of an [h, w] grid."""
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float64, device=device),
        torch.arange(w, dtype=torch.float64, device=device), indexing='ij')
    return xs.reshape(-1), ys.reshape(-1)


def depth_warp(src_img: Tensor, src_depth: Tensor, k_src, k_tgt,
               t_src_to_tgt, tgt_wh: Tuple[int, int]
               ) -> Tuple[Tensor, Tensor]:
    """Forward-warp `src_img` into the target camera using per-pixel depth.

    Every source pixel is back-projected with its depth, transformed with
    the 4x4 extrinsic `t_src_to_tgt`, projected with `k_tgt` and rounded
    to a pixel; the nearest point wins a pixel, and on equal depth the
    lower source index (JAX sorts far to near with an unstable sort, so
    its ties are its own).

    Args:
        src_img: [H, W] or [H, W, C].
        src_depth: [H, W] metric depth (<= 0 = invalid).
        tgt_wh: (W_t, H_t).

    Returns:
        (warped [H_t, W_t, C] in `src_img`'s dtype, valid [H_t, W_t]).
    """
    h, w = src_depth.shape
    wt, ht = tgt_wh
    img = src_img[..., None] if src_img.dim() == 2 else src_img
    xs, ys = _pixel_grid(h, w, src_depth.device)
    valid = (src_depth > 0).reshape(-1)
    z = src_depth.reshape(-1)[valid].to(torch.float64)
    px = torch.stack([xs[valid] * z, ys[valid] * z, z])
    pts_src = apply_matrix(np.linalg.inv(np.asarray(k_src, np.float64)), px)
    pts_tgt = apply_matrix(np.asarray(t_src_to_tgt, np.float64)[:3],
                           pts_src)
    front = pts_tgt[2] > 1e-6
    pts_tgt = pts_tgt[:, front]
    uvw = apply_matrix(k_tgt, pts_tgt)
    u = torch.round(uvw[0] / uvw[2]).to(torch.int64)
    v = torch.round(uvw[1] / uvw[2]).to(torch.int64)
    vals = img.reshape(h * w, -1)[valid][front]
    inb = (u >= 0) & (u < wt) & (v >= 0) & (v < ht)
    win = nearest_writer(v[inb] * wt + u[inb], pts_tgt[2, inb], ht * wt)
    vals = torch.cat([vals[inb], torch.zeros_like(vals[:1])])
    out = vals[torch.where(win < 0, vals.shape[0] - 1, win)]
    return out.reshape(ht, wt, -1), (win >= 0).reshape(ht, wt)


def inverse_depth_warp(src_img: Tensor, tgt_depth: Tensor, k_src, k_tgt,
                       t_tgt_to_src, ego_offset=None) -> Tensor:
    """Inverse warp: render `src_img` onto the TARGET grid using the
    target camera's per-pixel depth (the reference's
    `image_transformer.transform_with_target_depth`): back-project every
    target pixel with its stereo depth, shift by the ego-motion offset,
    transform into the source camera, project with `k_src` and sample the
    source image bilinearly, in float64. A sample outside the source
    image is 0; `u0` is clipped to `W_s - 2`, so `u == W_s - 1` samples
    with weight 1 on the last column.

    Args:
        src_img: [H_s, W_s] or [H_s, W_s, C].
        tgt_depth: [H_t, W_t] metric depth (<= 0 taken as 250 m).
        t_tgt_to_src: 4x4 target-cam -> source-cam extrinsic (host).
        ego_offset: optional [3] translation of the target-frame points.

    Returns:
        warped [H_t, W_t, C] float32.
    """
    ht, wt = tgt_depth.shape
    img = src_img[..., None] if src_img.dim() == 2 else src_img
    hs, ws, c = img.shape
    z = torch.where(tgt_depth > 0, tgt_depth, 250.0).to(
        torch.float64).reshape(-1)
    xs, ys = _pixel_grid(ht, wt, tgt_depth.device)
    pts = apply_matrix(np.linalg.inv(np.asarray(k_tgt, np.float64)),
                       torch.stack([xs * z, ys * z, z]))
    if ego_offset is not None:
        off = np.asarray(ego_offset, np.float64).tolist()
        pts = torch.stack([pts[i] + off[i] for i in range(3)])
    pts = apply_matrix(np.asarray(t_tgt_to_src, np.float64)[:3], pts)
    uvw = apply_matrix(k_src, pts)
    ok = pts[2] > 1e-6
    u = torch.where(ok, uvw[0] / uvw[2], 0.0)
    v = torch.where(ok, uvw[1] / uvw[2], 0.0)
    ok &= (u >= 0) & (u <= ws - 1) & (v >= 0) & (v <= hs - 1)
    u0 = torch.where(ok, u, 0.0).floor().to(torch.int64).clamp(0, ws - 2)
    v0 = torch.where(ok, v, 0.0).floor().to(torch.int64).clamp(0, hs - 2)
    fu = (u - u0)[:, None]
    fv = (v - v0)[:, None]
    f = img.to(torch.float64).reshape(hs * ws, c)
    i00 = v0 * ws + u0
    val = ((1 - fv) * ((1 - fu) * f[i00] + fu * f[i00 + 1])
           + fv * ((1 - fu) * f[i00 + ws] + fu * f[i00 + ws + 1]))
    val = torch.where(ok[:, None], val, 0.0)
    return val.reshape(ht, wt, c).to(torch.float32)


def ego_motion_offset(speed_mps: float, heading_deg: float,
                      delay_s: float) -> np.ndarray:
    """Target-frame point offset for ego motion during a slice delay
    (`image_transformer.py:201-202`: z -= cos(a)*v*dt, y += sin(a)*v*dt)."""
    a = np.deg2rad(heading_deg)
    return np.array([0.0, np.sin(a) * speed_mps * delay_s,
                     -np.cos(a) * speed_mps * delay_s])


def _dlt_systems(src: Tensor, dst: Tensor) -> Tensor:
    """The DLT rows of correspondences [..., N, 2] -> [..., 2N, 9]."""
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    o, z = torch.ones_like(x), torch.zeros_like(x)
    rx = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], -1)
    ry = torch.stack([z, z, z, x, y, o, -v * x, -v * y, -v], -1)
    return torch.stack([rx, ry], -2).flatten(-3, -2)


def _normalizer(p: Tensor) -> Tensor:
    """Hartley's similarity: centroid to 0, mean distance sqrt(2)."""
    c = p.mean(0)
    s = np.sqrt(2.0) / (p - c).norm(dim=1).mean().clamp_min(1e-12)
    t = torch.eye(3, dtype=p.dtype, device=p.device)
    t[0, 0] = t[1, 1] = s
    t[:2, 2] = -s * c
    return t


def _reprojection_sq(h: Tensor, src: Tensor, dst: Tensor) -> Tensor:
    """Squared reprojection error of every point under every H:
    h [I, 3, 3], src / dst [N, 2] -> [I, N]."""
    p = torch.cat([src, torch.ones_like(src[:, :1])], 1)
    q = torch.einsum('ijk,nk->inj', h, p)
    uv = q[..., :2] / q[..., 2:]
    return ((uv - dst) ** 2).sum(-1)


def homography_from_points(src_pts, dst_pts, ransac_thresh: float = 10.0,
                           generator: Optional[torch.Generator] = None
                           ) -> Tensor:
    """RANSAC homography (the reference's hand-labelled-points fallback,
    `cv2.findHomography(..., RANSAC, ransac_thresh)`): 2000 minimal
    4-point DLT hypotheses (cv2's iteration cap), the one with the most
    points within `ransac_thresh` pixels (the first on a tie), then the
    Hartley-normalised DLT least squares over its inliers. [3, 3]
    float64 with h33 = 1, on the points' device (the CPU for host
    arrays).

    The 4-point samples are drawn from `generator`, a CPU
    `torch.Generator` (seed 0 if None), so every device tests the same
    hypotheses. Fewer than 4 inliers raise `ValueError`.
    """
    src = torch.as_tensor(src_pts).to(torch.float64).reshape(-1, 2)
    dst = torch.as_tensor(dst_pts).to(torch.float64).reshape(-1, 2).to(
        src.device)
    n = src.shape[0]
    if n < 4 or dst.shape[0] != n:
        raise ValueError(f'a homography needs 4 or more correspondences, '
                         f'got {n} and {dst.shape[0]}')
    g = generator or torch.Generator().manual_seed(0)
    pick = torch.rand(RANSAC_HYPOTHESES, n, generator=g).argsort(1)[:, :4]
    pick = pick.to(src.device)
    a = _dlt_systems(src[pick], dst[pick])                  # [I, 8, 9]
    sol, info = torch.linalg.solve_ex(a[..., :8], -a[..., 8])
    hyp = torch.cat([sol, torch.ones_like(sol[:, :1])], 1).reshape(-1, 3, 3)
    err = _reprojection_sq(hyp, src, dst)
    inl = (err <= ransac_thresh ** 2) & (info == 0)[:, None]
    inliers = inl[int(torch.argmax(inl.sum(1)))]
    if int(inliers.sum()) < 4:
        raise ValueError('no homography: fewer than 4 correspondences '
                         'agree with any 4-point hypothesis')
    ts, td = _normalizer(src[inliers]), _normalizer(dst[inliers])
    norm = [(t[:2, :2] @ p[inliers].T + t[:2, 2:]).T
            for t, p in ((ts, src), (td, dst))]
    a = _dlt_systems(*norm)
    _, vecs = torch.linalg.eigh(a.T @ a)
    h = torch.linalg.inv(td) @ vecs[:, 0].reshape(3, 3) @ ts
    return h / h[2, 2]


def homography_warp(src_img: Tensor, m, tgt_wh: Tuple[int, int]) -> Tensor:
    """`cv2.warpPerspective(src_img, m, tgt_wh)` with `INTER_LINEAR` and a
    constant 0 border: every target pixel (x, y) samples the source at
    `m^-1 (x, y, 1)` bilinearly, each of its four taps outside the image
    counting 0. Coordinates and weights in float64 (cv2 5.0 computes
    them in float32, without the 1/32-pixel table of earlier versions);
    an integer image is rounded half to even and clamped to its type."""
    hs, ws = src_img.shape[:2]
    wt, ht = tgt_wh
    img = src_img[..., None] if src_img.dim() == 2 else src_img
    c = img.shape[2]
    minv = np.linalg.inv(np.asarray(torch.as_tensor(m).cpu(), np.float64))
    xs, ys = _pixel_grid(ht, wt, img.device)
    q = apply_matrix(minv, torch.stack([xs, ys, torch.ones_like(xs)]))
    # non-finite and far-off coordinates sample only the border
    u = torch.nan_to_num(q[0] / q[2], nan=-2.0, posinf=-2.0,
                         neginf=-2.0).clamp(-2.0, ws + 1.0)
    v = torch.nan_to_num(q[1] / q[2], nan=-2.0, posinf=-2.0,
                         neginf=-2.0).clamp(-2.0, hs + 1.0)
    u0, v0 = u.floor(), v.floor()
    fu, fv = (u - u0)[:, None], (v - v0)[:, None]
    u0, v0 = u0.to(torch.int64), v0.to(torch.int64)
    f = img.to(torch.float64).reshape(hs * ws, c)

    def tap(dv, du):
        yy, xx = v0 + dv, u0 + du
        inside = (xx >= 0) & (xx < ws) & (yy >= 0) & (yy < hs)
        idx = torch.where(inside, yy * ws + xx, 0)
        return torch.where(inside[:, None], f[idx], 0.0)

    val = ((1 - fv) * ((1 - fu) * tap(0, 0) + fu * tap(0, 1))
           + fv * ((1 - fu) * tap(1, 0) + fu * tap(1, 1)))
    if img.is_floating_point():
        out = val.to(img.dtype)
    else:
        info = torch.iinfo(img.dtype)
        out = torch.round(val).clamp(info.min, info.max).to(img.dtype)
    out = out.reshape(ht, wt, c)
    return out[..., 0] if src_img.dim() == 2 else out


def disparity_to_depth(disparity: Tensor, focal: float,
                       baseline: float) -> Tensor:
    """Stereo disparity -> metric depth, float32 (`image_transformer.
    disparity2depth_psm`: depth = f * B / disparity, 0 where the
    disparity is not positive). f * B is a device tensor: CUDA would
    otherwise divide by way of a reciprocal, one ulp off numpy."""
    d = disparity.to(torch.float32)
    fb = torch.tensor(focal * baseline, dtype=torch.float32, device=d.device)
    return torch.where(d > 0, fb / d, 0.0)
