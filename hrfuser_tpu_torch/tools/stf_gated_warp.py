"""SeeingThroughFog gated -> RGB depth warping CLI.

Port of `tools/stf_gated_warp.py` (the reference's
`SeeingThroughFog/tools/ProjectionTools/Gated2RGB/run_depth_warping.py`):
for every frame of a split, the three gated slices (raw TIFFs, read by
`data/tiff.py`) are re-rendered on the card into the RGB stereo-left
frame through per-pixel stereo depth (SGM / PSMNet disparity, resized
bilinearly to 1024x1920 by `data/device_pipeline.resize_image`) and
ego-motion compensation (vehicle speed and steering heading times each
slice's capture delay), max-accumulated, truncated to uint16 and written
as grey PNGs to `gated_acc_wraped_grey/` at the reference's RGB crop
(768x1280 at (202, 280)). With `--lut8` each slice is first tone-mapped
to 8 bits on the card (`data/stf_lut.gated_raw_to_lut8`: gated LUT,
>> 2, CLAHE 2.0), and the warp is truncated to uint8 (as the JAX tool's
`astype(np.uint8)`).

    python -m hrfuser_tpu_torch.tools.stf_gated_warp --root data/dense \\
        --split splits/all.txt --depth-folder cam_stereo_sgm [--lut8] \\
        [--device cpu]

It runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp

import numpy as np
import torch

from hrfuser_tpu_torch.data import png
from hrfuser_tpu_torch.data.device_pipeline import resize_image
from hrfuser_tpu_torch.data.gated_warp import (disparity_to_depth,
                                               ego_motion_offset,
                                               inverse_depth_warp)
from hrfuser_tpu_torch.data.pipelines.loading import imread
from hrfuser_tpu_torch.data.stf_io import load_calib, load_split
from hrfuser_tpu_torch.data.stf_lut import gated_raw_to_lut8
from hrfuser_tpu_torch.tools import resolve_device

GATED_SLICES = ('gated0', 'gated1', 'gated2')
# RGB2Gatedv2 crop (CreateTFRecords/generic_tf_tools/resize.py:100-107)
CROP = (202, 970, 280, 1560)
DEPTH_HW = (1024, 1920)
# stereo-left rig constants (`image_transformer.disparity2depth_psm`)
STEREO_BASELINE = 0.202993
STEREO_FOCAL = 2355.722801


def _load_json(path, key, default=0.0):
    if osp.exists(path):
        with open(path) as f:
            return json.load(f)[key]
    return default


def _slice_delays(root: str, frame: str):
    """Per-slice capture delay vs the RGB frame, seconds
    (`run_depth_warping.py:159-166`); 0 when timestamps are absent."""
    ts_path = osp.join(root, 'timestamps.json')
    if not osp.exists(ts_path):
        return {g: 0.0 for g in GATED_SLICES}
    with open(ts_path) as f:
        data = json.load(f)

    def t(sensor):
        return int(data[sensor][frame].split('_')[1])

    rgb = t('rgb')
    return {g: (t(g) - rgb) / 1e9 for g in GATED_SLICES}


def warp_frame(root: str, frame: str, depth_folder: str,
               use_lut8: bool = False, device='cuda') -> np.ndarray:
    """Warp + accumulate one frame's gated slices: the grey image
    [768, 1280] at the RGB crop, uint16 (uint8 with `use_lut8`)."""
    device = resolve_device(device)
    k_rgb, t_velo_to_rgb = load_calib(
        root, camera_calib='calib_cam_stereo_left.json')
    k_gated, t_velo_to_gated = load_calib(
        root, camera_calib='calib_gated_bwv.json')
    # RGB optical frame -> gated optical frame (via the velodyne root)
    t_rgb_to_gated = t_velo_to_gated @ np.linalg.inv(t_velo_to_rgb)

    disp = np.load(osp.join(root, depth_folder, frame + '.npz'))['arr_0']
    if 'psmnet' in depth_folder:
        # PSMNet ran at half resolution (`run_depth_warping.py:76-79`)
        disp = 2.0 * disp
    disp = np.nan_to_num(disp, nan=float(np.nanmean(disp) or 1.0))
    depth = disparity_to_depth(torch.from_numpy(disp).to(device),
                               STEREO_FOCAL, STEREO_BASELINE)
    depth = resize_image(depth[None, :, :, None], DEPTH_HW)[0, :, :, 0]

    speed = _load_json(
        osp.join(root, 'filtered_relevant_can_data/can_body_basic',
                 frame + '.json'), 'VehSpd_Disp') / 3.6
    steer = _load_json(
        osp.join(root, 'filtered_relevant_can_data/can_body_chassis',
                 frame + '.json'), 'StWhl_Angl') / 520.0 * 30.0
    delays = _slice_delays(root, frame)

    acc = None
    for g in GATED_SLICES:
        raw = torch.from_numpy(imread(
            osp.join(root, f'{g}_raw', frame + '.tiff'),
            'unchanged').astype(np.int32)).to(device)
        img = gated_raw_to_lut8(raw) if use_lut8 else raw
        out = inverse_depth_warp(
            img, depth,
            k_gated, k_rgb, t_rgb_to_gated,
            ego_offset=ego_motion_offset(speed, steer, delays[g]))[..., 0]
        acc = out if acc is None else torch.maximum(acc, out)
    acc = acc[CROP[0]:CROP[1], CROP[2]:CROP[3]]
    if use_lut8:
        return acc.to(torch.uint8).cpu().numpy()
    return acc.to(torch.int32).cpu().numpy().astype(np.uint16)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description='STF gated -> RGB warping')
    ap.add_argument('--root', required=True)
    ap.add_argument('--split', required=True,
                    help='split txt (scene,frame per line)')
    ap.add_argument('--depth-folder', default='cam_stereo_sgm',
                    choices=['cam_stereo_sgm', 'psmnet_sweden'])
    ap.add_argument('--out-folder', default='gated_acc_wraped_grey')
    ap.add_argument('--lut8', action='store_true',
                    help='tone-map slices to 8-bit before warping')
    ap.add_argument('--device', default='cuda')
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    out_dir = osp.join(args.root, args.out_folder)
    os.makedirs(out_dir, exist_ok=True)
    frames = load_split(args.split)
    done = 0
    for frame in frames:
        out_path = osp.join(out_dir, frame + '.png')
        if osp.exists(out_path):
            continue
        img = warp_frame(args.root, frame, args.depth_folder, args.lut8,
                         device)
        png.imwrite(out_path, img)
        done += 1
        if done % 50 == 0:
            print(f'[gated_warp] {done}/{len(frames)}')
    print(f'[gated_warp] wrote {done} frames to {out_dir}')


if __name__ == '__main__':
    main()
