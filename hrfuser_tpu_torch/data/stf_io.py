"""SeeingThroughFog raw-data readers (calib, velodyne, radar), on the
host.

Port of `hrfuser_tpu/data/stf_io.py`, itself a rebuild of
`SeeingThroughFog/tools/DatasetViewer/lib/read.py`: velodyne scans are
float32 [N, 5] binaries; radar targets come from per-frame json;
calibration is a camera-intrinsics json + a TF tree json whose chain
yields the velodyne->camera extrinsic.
"""

from __future__ import annotations

import json
import os.path as osp
from typing import Dict, Tuple

import numpy as np

from hrfuser_tpu_torch.data.projection import transform_matrix


def load_velodyne_scan(path: str) -> np.ndarray:
    """[N, 5] float32 (x, y, z, intensity, ring)."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 5)


def load_radar_targets(path: str) -> np.ndarray:
    """[N, 5]: (x_sc, y_sc, 0, v_over_ground, r_dist)."""
    with open(path) as f:
        data = json.load(f)
    rows = [[t['x_sc'], t['y_sc'], 0.0, t['rVelOverGroundOdo_sc'],
             t['rDist_sc']] for t in data['targets']]
    return np.asarray(rows, np.float64).reshape(-1, 5)


CAMERA_FRAMES = {
    'calib_cam_stereo_left.json': 'cam_stereo_left_optical',
    'calib_cam_stereo_right.json': 'cam_stereo_right_optical',
    'calib_gated_bwv.json': 'bwv_cam_optical',
}


def _chain_transform(tf_tree: list, src: str, dst: str) -> np.ndarray:
    """Compose 4x4 transforms along the TF tree from `src` to `dst`.

    The STF tf tree is a list of {child_frame_id, frame_id, transform:
    {translation, rotation(quaternion x,y,z,w)}} entries; frames chain
    child -> parent up to a common root.
    """
    edges: Dict[str, Tuple[str, np.ndarray]] = {}
    for e in tf_tree:
        tr = e['transform']['translation']
        q = e['transform']['rotation']
        tm = transform_matrix(
            [tr['x'], tr['y'], tr['z']],
            [q['w'], q['x'], q['y'], q['z']])
        edges[e['child_frame_id']] = (e['frame_id'], tm)

    def to_root(frame):
        chain = np.eye(4)
        while frame in edges:
            parent, tm = edges[frame]
            chain = tm @ chain
            frame = parent
        return frame, chain

    root_s, m_s = to_root(src)
    root_d, m_d = to_root(dst)
    assert root_s == root_d, f'frames {src} and {dst} not connected'
    return np.linalg.inv(m_d) @ m_s


def load_calib(root: str, camera_calib: str = 'calib_cam_stereo_left.json',
               tf_tree: str = 'calib_tf_tree_full.json',
               velodyne_frame: str = 'lidar_hdl64_s3_roof'
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(intrinsic [3,3], T_velodyne_to_cam [4,4])."""
    with open(osp.join(root, camera_calib)) as f:
        cam = json.load(f)
    k = np.asarray(cam['P'] if 'P' in cam else cam['camera_matrix'],
                   np.float64).reshape(3, -1)[:, :3]
    with open(osp.join(root, tf_tree)) as f:
        tree = json.load(f)
    cam_frame = CAMERA_FRAMES.get(camera_calib, camera_calib)
    t = _chain_transform(tree, velodyne_frame, cam_frame)
    return k, t


def load_split(path: str) -> list:
    """Frame list from a SeeingThroughFog split file.

    Lines are `<scene>,<frame>` (e.g. `2018-02-03_21-04-07,00100`);
    returns the `<scene>_<frame>` stems used by the dataset's file
    naming (`SeeingThroughFog/splits/*.txt`).
    """
    with open(path) as f:
        return [line.strip().replace(',', '_')
                for line in f if line.strip()]


WEATHER_TEST_SPLITS = ('test_clear', 'light_fog', 'dense_fog', 'snow')


def load_weather_splits(split_dir: str) -> Dict[str, list]:
    """The 4 weather test splits (day+night merged) used by the STF
    evaluation (`kitti_detection_2d_c1248_clrg_fusion.py:89-102`)."""
    out = {}
    for name in WEATHER_TEST_SPLITS:
        frames: list = []
        for tod in ('day', 'night'):
            p = osp.join(split_dir, f'{name}_{tod}.txt')
            if osp.exists(p):
                frames.extend(load_split(p))
        out[name] = frames
    return out
