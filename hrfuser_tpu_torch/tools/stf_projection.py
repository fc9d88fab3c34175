"""STF offline projection: velodyne / radar -> camera-frame sensor PNGs.

Port of `tools/stf_projection.py` (the reference's
`SeeingThroughFog/tools/ProjectionTools/run_2d_projection_on_dataset.py`):
for every frame of a split, the lidar scan and the radar targets are
projected into the camera frame on the card and written as quantized
uint16 `lidar_projections/yzi` / `radar_projections/yzv` PNGs.

    python -m hrfuser_tpu_torch.tools.stf_projection --root data/dense \\
        --calib-root calibs/ --split splits/train_clear.txt [--device cpu]

It runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from hrfuser_tpu_torch.data import png
from hrfuser_tpu_torch.data.projection import (apply_matrix,
                                               project_to_image, stf_splat,
                                               to_uint16)
from hrfuser_tpu_torch.data.stf_io import (load_calib, load_radar_targets,
                                           load_split, load_velodyne_scan)
from hrfuser_tpu_torch.tools import resolve_device


def _splat(points, extra, k, t_velo2cam, target_wh, radar, mode):
    """Points [N, >=3] (velodyne frame) + the third channel [N] -> one
    [H, W, 3] image of (height -y_cam, depth z_cam, `extra`)."""
    cam = apply_matrix(np.asarray(t_velo2cam, np.float64)[:3],
                       points[:, :3].T.to(torch.float64))
    uv, mask = project_to_image(cam, k, target_wh, min_dist=1.0)
    coords = torch.round(uv[:, mask].T)
    coords = torch.stack([coords[:, 0].clamp(0, target_wh[0] - 1),
                          coords[:, 1].clamp(0, target_wh[1] - 1)], 1)
    vals = torch.stack([-cam[1, mask], cam[2, mask],
                        extra[mask].to(torch.float64)], -1)
    return stf_splat(coords, vals, target_wh, radar=radar, mode=mode)


def project_frame(scan, radar, k, t_velo2cam, target_wh=(1280, 768),
                  mode='reference', device='cuda'):
    """One frame: (yzi, yzv) uint16 [H, W, 3] host images.

    Args:
        scan: velodyne points [N, 5] (x, y, z, intensity, ring).
        radar: radar targets [M, 5] (x, y, 0, velocity, distance).
    """
    device = resolve_device(device)
    scan = torch.as_tensor(np.asarray(scan)).to(device)
    radar = torch.as_tensor(np.asarray(radar)).to(device)
    yzi = _splat(scan, scan[:, 3], k, t_velo2cam, target_wh, False, mode)
    yzv = _splat(radar, radar[:, 3], k, t_velo2cam, target_wh, True, mode)
    return to_uint16(yzi), to_uint16(yzv)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description='STF lidar / radar projection')
    ap.add_argument('--root', required=True)
    ap.add_argument('--calib-root', required=True)
    ap.add_argument('--split', required=True,
                    help='txt file of frame ids (one per line)')
    ap.add_argument('--lidar-dir', default='lidar_hdl64_strongest')
    ap.add_argument('--radar-dir', default='radar_targets')
    ap.add_argument('--mode', default='reference',
                    choices=['reference', 'zbuffer'])
    ap.add_argument('--device', default='cuda')
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    k, t = load_calib(args.calib_root)
    frames = load_split(args.split)
    out_lidar = os.path.join(args.root, 'lidar_projections', 'yzi')
    out_radar = os.path.join(args.root, 'radar_projections', 'yzv')
    os.makedirs(out_lidar, exist_ok=True)
    os.makedirs(out_radar, exist_ok=True)
    for fid in frames:
        scan = load_velodyne_scan(
            os.path.join(args.root, args.lidar_dir, fid + '.bin'))
        radar_path = os.path.join(args.root, args.radar_dir, fid + '.json')
        radar = (load_radar_targets(radar_path)
                 if os.path.exists(radar_path) else np.zeros((0, 5)))
        yzi, yzv = project_frame(scan, radar, k, t, mode=args.mode,
                                 device=device)
        png.imwrite(os.path.join(out_lidar, fid + '.png'), yzi)
        png.imwrite(os.path.join(out_radar, fid + '.png'), yzv)
        print(f'[stf] {fid}')


if __name__ == '__main__':
    main()
