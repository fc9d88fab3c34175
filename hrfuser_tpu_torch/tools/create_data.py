"""Offline nuScenes conversion: sensor PNGs and the extended COCO json.

Port of `tools/create_data.py` (the reference `tools/create_data.py` +
`tools/data_converter/nuscenes_converter.py`): walks the nuScenes
samples, projects LIDAR_TOP and the five radars into every camera at
640x360 (scale 2.5) on the card, writes the quantized uint16 sensor
PNGs (`lidar_samples/{rih,xz0}`, `radar_samples/{riv,xz0}`) and emits
`nuscenes_infos_{train,val}_mono3d.coco.json`, the extended COCO json
with `lidar_projections` / `radar_projections` that
`data/datasets/coco.py` reads.

`convert_sample` does one sample's work from a DB (anything with the
devkit's `get(table, token)`), the sample record and its loaded point
clouds, so it runs without the devkit; the CLI needs the `nuscenes`
devkit for the tables and point-cloud files (its `RadarPointCloud`
filters returns by default, as the reference's converter does).

    python -m hrfuser_tpu_torch.tools.create_data nuscenes \\
        --root-path data/nuscenes --version v1.0-trainval [--device cpu]

It runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np
import torch

from hrfuser_tpu_torch.data import png
from hrfuser_tpu_torch.data.projection import (SCALE, SHIFT, apply_matrix,
                                               project_to_image,
                                               radar_pillar_endpoints,
                                               splat_lidar,
                                               splat_radar_pillars,
                                               to_uint16, transform_matrix)
from hrfuser_tpu_torch.tools import resolve_device

CAMS = ['CAM_FRONT', 'CAM_FRONT_RIGHT', 'CAM_FRONT_LEFT', 'CAM_BACK',
        'CAM_BACK_LEFT', 'CAM_BACK_RIGHT']
RADARS = ['RADAR_FRONT', 'RADAR_FRONT_LEFT', 'RADAR_FRONT_RIGHT',
          'RADAR_BACK_LEFT', 'RADAR_BACK_RIGHT']
GRID_WH = (640, 360)
GROUPS = {'lidar_img': ('lidar_samples', ('rih', 'xz0')),
          'radar_img': ('radar_samples', ('riv', 'xz0'))}


def _group_info(folder, groups, token):
    """Per-camera projection info entry (reference `:426-431`)."""
    entry = {'width': GRID_WH[0], 'height': GRID_WH[1],
             'background': SCALE * SHIFT, 'img_scale_factor': 2.5}
    for g in groups:
        entry[g] = {
            'file_name': osp.join(folder, g, token + '.png'),
            'pixel_scale_factor': SCALE, 'shift': SHIFT,
            'empty_channels': [2] if g == 'xz0' else None,
        }
    return entry


def sample_info(db, sample) -> Dict:
    """The info record of one sample (ego pose, cameras, the sensor
    image entries), as the JAX converter builds it."""
    lidar_sd = db.get('sample_data', sample['data']['LIDAR_TOP'])
    pose = db.get('ego_pose', lidar_sd['ego_pose_token'])
    info = {'token': sample['token'],
            'timestamp': sample['timestamp'],
            'ego2global_translation': pose['translation'],
            'ego2global_rotation': pose['rotation'],
            'cams': {}, 'lidar_img': {}, 'radar_img': {}}
    for cam in CAMS:
        cam_sd = db.get('sample_data', sample['data'][cam])
        cs_cam = db.get('calibrated_sensor',
                        cam_sd['calibrated_sensor_token'])
        info['cams'][cam] = {
            'sample_data_token': cam_sd['token'],
            'data_path': cam_sd['filename'],
            'cam_intrinsic': cs_cam['camera_intrinsic'],
            'sensor2ego_translation': cs_cam['translation'],
            'sensor2ego_rotation': cs_cam['rotation'],
            'width': cam_sd['width'], 'height': cam_sd['height'],
        }
        for key, (folder, groups) in GROUPS.items():
            info[key][cam] = _group_info(folder, groups, cam_sd['token'])
    return info


def _sensor_to_cam(db, sensor_sd, cam_sd) -> np.ndarray:
    """The 4x4 sensor -> ego -> global -> ego' -> camera chain
    (`nuscenes_explorer.map_pointcloud_to_image`)."""
    cs = db.get('calibrated_sensor', sensor_sd['calibrated_sensor_token'])
    pose = db.get('ego_pose', sensor_sd['ego_pose_token'])
    cs_cam = db.get('calibrated_sensor', cam_sd['calibrated_sensor_token'])
    pose_cam = db.get('ego_pose', cam_sd['ego_pose_token'])
    return (transform_matrix(cs_cam['translation'], cs_cam['rotation'],
                             inverse=True)
            @ transform_matrix(pose_cam['translation'], pose_cam['rotation'],
                               inverse=True)
            @ transform_matrix(pose['translation'], pose['rotation'])
            @ transform_matrix(cs['translation'], cs['rotation']))


def _norm(rows) -> torch.Tensor:
    """`np.linalg.norm(x, axis=0)` of a few rows, summed in numpy's
    order."""
    acc = rows[0] * rows[0]
    for r in rows[1:]:
        acc = acc + r * r
    return torch.sqrt(acc)


def _per_camera(mats, device, counts=None) -> torch.Tensor:
    """Host matrices [cameras, (sensors,) R, C] -> coefficients
    [R, C, cameras, 1 or points] for `apply_matrix`: one matrix per
    camera, and with `counts` one per sensor's run of points."""
    m = torch.as_tensor(np.asarray(mats, np.float64), device=device)
    if counts is None:
        return m.permute(1, 2, 0)[..., None]
    m = m.repeat_interleave(torch.as_tensor(counts, device=device), 1)
    return m.permute(2, 3, 0, 1)


def convert_sample(db, sample, lidar, radars, out_dir: Optional[str] = None,
                   device='cuda', mode: str = 'reference'):
    """One sample: its info record and, per camera, the four uint16 sensor
    images `rih`, `xz0` (lidar) and `riv`, `rxz0` (radar).

    All six cameras and five radars go through one pass: every point is
    projected into every camera, and each camera's visible points are
    splatted into its own image, in the order the JAX loop visits them
    (camera by camera, the radars in `RADARS` order), so the images are
    those of one camera at a time.

    Args:
        db: the nuScenes tables (`get(table, token)`).
        sample: the `sample` record.
        lidar: LIDAR_TOP points [>=4, N] (x, y, z, intensity; float32
            from `LidarPointCloud`).
        radars: {radar channel: points [18, M]} for the five radars
            (`RadarPointCloud`: x, y, z at rows 0-2, RCS at 5,
            compensated velocity at 8-9).
        out_dir: where to write the PNGs; None writes nothing.
    """
    device = resolve_device(device)
    info = sample_info(db, sample)
    lidar_sd = db.get('sample_data', sample['data']['LIDAR_TOP'])
    cam_sds = [db.get('sample_data', sample['data'][cam]) for cam in CAMS]
    radar_sds = [db.get('sample_data', sample['data'][r]) for r in RADARS]
    k = _per_camera([db.get('calibrated_sensor', sd[
        'calibrated_sensor_token'])['camera_intrinsic'] for sd in cam_sds],
        device)
    wh = torch.tensor([[sd['width'], sd['height']] for sd in cam_sds],
                      device=device).T[..., None]
    n = len(CAMS)

    pc = torch.as_tensor(np.asarray(lidar)).to(device)
    t = _per_camera([_sensor_to_cam(db, lidar_sd, sd)[:3] for sd in cam_sds],
                    device)
    pts = apply_matrix(t, pc[:3].to(torch.float64))          # [3, cams, N]
    uv, mask = project_to_image(pts, k, (wh[0], wh[1]))
    cam, i = torch.nonzero(mask, as_tuple=True)     # camera-major
    pts = pts[:, cam, i]
    rih, xz0 = splat_lidar(uv[:, cam, i], _norm(pts), pc[3, i], pts,
                           GRID_WH, mode=mode, image=cam, n_images=n)

    rpc = torch.as_tensor(np.concatenate(
        [np.asarray(radars[r]) for r in RADARS], 1)).to(device)
    t = _per_camera([[_sensor_to_cam(db, r_sd, sd)[:3] for r_sd in radar_sds]
                     for sd in cam_sds], device,
                    [np.asarray(radars[r]).shape[1] for r in RADARS])
    p = apply_matrix(t, rpc[:3].to(torch.float64))            # [3, cams, M]
    top = apply_matrix(t, radar_pillar_endpoints(rpc[:3]).to(torch.float64))
    uv_r, mask = project_to_image(p, k, (wh[0], wh[1]))
    uv_t, _ = project_to_image(top, k, (wh[0], wh[1]))
    cam, i = torch.nonzero(mask, as_tuple=True)     # camera-major
    p = p[:, cam, i]
    riv, rxz0 = splat_radar_pillars(
        uv_r[:, cam, i], uv_t[:, cam, i], _norm(p[[0, 2]]), rpc[5, i],
        _norm(rpc[8:10, i]), p, GRID_WH, mode=mode, image=cam, n_images=n)

    host = to_uint16(torch.stack([rih, xz0, riv, rxz0]))
    images = {cam: dict(zip(('rih', 'xz0', 'riv', 'rxz0'), host[:, c]))
              for c, cam in enumerate(CAMS)}
    if out_dir is not None:
        jobs = []
        for cam in CAMS:
            li, ri = info['lidar_img'][cam], info['radar_img'][cam]
            for entry, group, key in ((li, 'rih', 'rih'), (li, 'xz0', 'xz0'),
                                      (ri, 'riv', 'riv'),
                                      (ri, 'xz0', 'rxz0')):
                path = osp.join(out_dir, entry[group]['file_name'])
                os.makedirs(osp.dirname(path), exist_ok=True)
                jobs.append((path, images[cam][key]))
        # zlib lets go of the GIL: the 24 encodes run side by side
        with ThreadPoolExecutor(min(len(jobs), os.cpu_count() or 1)) as pool:
            list(pool.map(lambda job: png.imwrite(*job), jobs))
    return info, images


def nuscenes_data_prep(root_path: str, version: str, out_dir: str = None,
                       skip_pngs: bool = False, device='cuda'):
    device = resolve_device(device)
    try:
        from nuscenes.nuscenes import NuScenes
        from nuscenes.utils import splits as nus_splits
        from nuscenes.utils.data_classes import (LidarPointCloud,
                                                 RadarPointCloud)
    except ImportError as e:
        raise SystemExit(
            'The nuScenes devkit is required for offline conversion '
            '(`pip install nuscenes-devkit` on a machine with network '
            'access). The per-sample work is `convert_sample` in '
            'hrfuser_tpu_torch/tools/create_data.py.') from e
    from hrfuser_tpu_torch.data.nuscenes_export import export_2d_annotation

    out_dir = out_dir or root_path
    nusc = NuScenes(version=version, dataroot=root_path, verbose=True)
    if version == 'v1.0-trainval':
        train_scenes = set(nus_splits.train)
        val_scenes = set(nus_splits.val)
    elif version == 'v1.0-mini':
        train_scenes = set(nus_splits.mini_train)
        val_scenes = set(nus_splits.mini_val)
    elif version == 'v1.0-test':
        train_scenes, val_scenes = set(nus_splits.test), set()
    else:
        raise SystemExit(f'unknown version {version}')

    def points(sd, cls):
        return cls.from_file(osp.join(root_path, sd['filename'])).points

    train_infos, val_infos = [], []
    for si, sample in enumerate(nusc.sample):
        scene = nusc.get('scene', sample['scene_token'])
        dest = (train_infos if scene['name'] in train_scenes
                else val_infos if scene['name'] in val_scenes else None)
        if dest is None:
            continue
        if skip_pngs:
            info = sample_info(nusc, sample)
        else:
            lidar = points(nusc.get('sample_data',
                                    sample['data']['LIDAR_TOP']),
                           LidarPointCloud)
            radars = {r: points(nusc.get('sample_data', sample['data'][r]),
                                RadarPointCloud) for r in RADARS}
            info, _ = convert_sample(nusc, sample, lidar, radars, out_dir,
                                     device)
        dest.append(info)
        if si % 100 == 0:
            print(f'[create_data] {si}/{len(nusc.sample)} samples')

    for split, infos in (('train', train_infos), ('val', val_infos)):
        if not infos:
            continue
        base = osp.join(out_dir, f'nuscenes_infos_{split}')
        with open(base + '.pkl', 'wb') as f:
            pickle.dump({'infos': infos, 'metadata': {'version': version}},
                        f)
        export_2d_annotation(nusc, infos, base + '_mono3d.coco.json')
        print(f'[create_data] wrote {base}_mono3d.coco.json '
              f'({len(infos)} samples)')


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description='nuScenes offline conversion')
    ap.add_argument('dataset', choices=['nuscenes'])
    ap.add_argument('--root-path', required=True)
    ap.add_argument('--version', default='v1.0-trainval')
    ap.add_argument('--out-dir', default=None)
    ap.add_argument('--skip-pngs', action='store_true',
                    help='only (re)generate the annotation jsons')
    ap.add_argument('--device', default='cuda')
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    nuscenes_data_prep(args.root_path, args.version, args.out_dir,
                       args.skip_pngs, args.device)


if __name__ == '__main__':
    main()
