"""nuScenes 2D annotation export (extended COCO json), on the host.

Port of `hrfuser_tpu/data/nuscenes_export.py` (the reference's
`export_2d_annotation` / `get_2d_boxes` / `generate_record`,
`tools/data_converter/nuscenes_converter.py:650-960`): per-box float64
numpy, the 3D -> 2D box math from `data/projection.py`'s host helpers,
so the JSON is byte-equal to JAX's.

The `db` argument is duck-typed: any object with the nuScenes devkit's
`get(table, token)` accessor works (the real `NuScenes` instance, or a
light fake in tests). Velocity for mono3d records is taken from
`db.box_velocity(ann_token)` when available, else zeros.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from hrfuser_tpu_torch.data.projection import (box3d_corners, box3d_to_2d,
                                               quat_to_rot)

# category canonicalisation (`nuscenes_converter.py:21-40`)
NAME_MAPPING = {
    'movable_object.barrier': 'barrier',
    'vehicle.bicycle': 'bicycle',
    'vehicle.bus.bendy': 'bus',
    'vehicle.bus.rigid': 'bus',
    'vehicle.car': 'car',
    'vehicle.construction': 'construction_vehicle',
    'vehicle.motorcycle': 'motorcycle',
    'human.pedestrian.adult': 'pedestrian',
    'human.pedestrian.child': 'pedestrian',
    'human.pedestrian.construction_worker': 'pedestrian',
    'human.pedestrian.police_officer': 'pedestrian',
    'movable_object.trafficcone': 'traffic_cone',
    'vehicle.trailer': 'trailer',
    'vehicle.truck': 'truck',
}
NUS_CATEGORIES = ('car', 'truck', 'trailer', 'bus', 'construction_vehicle',
                  'bicycle', 'motorcycle', 'pedestrian', 'traffic_cone',
                  'barrier')
NUS_ATTRIBUTES = ('cycle.with_rider', 'cycle.without_rider',
                  'pedestrian.moving', 'pedestrian.standing',
                  'pedestrian.sitting_lying_down', 'vehicle.moving',
                  'vehicle.parked', 'vehicle.stopped', 'None')
DEFAULT_VISIBILITIES = ('2', '3', '4')   # reference `:684`


def _ann_to_cam(ann_rec: Dict, pose_rec: Dict, cs_rec: Dict):
    """3D annotation (global frame) -> camera frame.

    Returns (corners_cam [3, 8], center_cam [3], rot_mat_cam [3, 3]).
    """
    corners_g = box3d_corners(ann_rec['translation'], ann_rec['size'],
                              ann_rec['rotation'])
    r_ego = quat_to_rot(pose_rec['rotation'])
    r_cam = quat_to_rot(cs_rec['rotation'])
    t_ego = np.asarray(pose_rec['translation'])[:, None]
    t_cam = np.asarray(cs_rec['translation'])[:, None]
    corners_cam = r_cam.T @ (r_ego.T @ (corners_g - t_ego) - t_cam)
    center_g = np.asarray(ann_rec['translation'])[:, None]
    center_cam = (r_cam.T @ (r_ego.T @ (center_g - t_ego) - t_cam))[:, 0]
    r_ann = quat_to_rot(ann_rec['rotation'])
    rot_cam = r_cam.T @ r_ego.T @ r_ann
    return corners_cam, center_cam, rot_cam


def generate_record(ann_rec: Dict, bbox, sample_data_token: str,
                    filename: str) -> Optional[Dict]:
    """2D COCO record for one annotation (`nuscenes_converter.py:889-960`).

    Returns None for categories outside the 10 nuScenes classes.
    """
    cat = ann_rec['category_name']
    if cat not in NAME_MAPPING:
        return None
    x1, y1, x2, y2 = bbox
    name = NAME_MAPPING[cat]
    return {
        'file_name': filename,
        'image_id': sample_data_token,
        'area': (y2 - y1) * (x2 - x1),
        'category_name': name,
        'category_id': NUS_CATEGORIES.index(name),
        'bbox': [x1, y1, x2 - x1, y2 - y1],
        'iscrowd': 0,
        'visibility_token': ann_rec['visibility_token'],
    }


def get_2d_boxes(db, sample_data_token: str,
                 visibilities: Sequence[str] = DEFAULT_VISIBILITIES,
                 mono3d: bool = True) -> List[Dict]:
    """2D records for one camera keyframe (`get_2d_boxes`, `:733-864`)."""
    sd_rec = db.get('sample_data', sample_data_token)
    assert sd_rec['sensor_modality'] == 'camera'
    s_rec = db.get('sample', sd_rec['sample_token'])
    cs_rec = db.get('calibrated_sensor', sd_rec['calibrated_sensor_token'])
    pose_rec = db.get('ego_pose', sd_rec['ego_pose_token'])
    k = np.asarray(cs_rec['camera_intrinsic'])
    img_wh = (sd_rec['width'], sd_rec['height'])

    records = []
    for ann_token in s_rec['anns']:
        ann_rec = db.get('sample_annotation', ann_token)
        if ann_rec['visibility_token'] not in visibilities:
            continue
        corners_cam, center_cam, rot_cam = _ann_to_cam(ann_rec, pose_rec,
                                                       cs_rec)
        bbox = box3d_to_2d(corners_cam, k, img_wh)
        if bbox is None:
            continue
        rec = generate_record(ann_rec, bbox, sample_data_token,
                              sd_rec['filename'])
        if rec is None:
            continue
        if mono3d:
            w, l, h = ann_rec['size']
            yaw = float(np.arctan2(rot_cam[1, 0], rot_cam[0, 0]))
            if hasattr(db, 'box_velocity'):
                gv = np.asarray(db.box_velocity(ann_token),
                                np.float64)[:2]
            else:
                gv = np.zeros(2)
            gv3 = np.array([gv[0], gv[1], 0.0])
            r_ego = quat_to_rot(pose_rec['rotation'])
            r_cam = quat_to_rot(cs_rec['rotation'])
            cam_v = gv3 @ np.linalg.inv(r_ego).T @ np.linalg.inv(r_cam).T
            # lhw order + negated yaw (`:824-830`)
            rec['bbox_cam3d'] = (list(map(float, center_cam))
                                 + [float(l), float(h), float(w)]
                                 + [-yaw])
            rec['velo_cam3d'] = [float(cam_v[0]), float(cam_v[2])]
            z = center_cam[2]
            if z <= 0:
                continue
            uvz = k @ center_cam
            rec['center2d'] = [float(uvz[0] / z), float(uvz[1] / z),
                               float(z)]
            attrs = ann_rec.get('attribute_tokens', [])
            if attrs:
                attr_name = db.get('attribute', attrs[0])['name']
            else:
                attr_name = 'None'
            rec['attribute_name'] = attr_name
            rec['attribute_id'] = NUS_ATTRIBUTES.index(attr_name)
        records.append(rec)
    return records


def _strip_root(path: str, root_strip: str) -> str:
    return path.split(root_strip)[-1] if root_strip in path else path


def export_2d_annotation(db, infos: List[Dict], out_path: str,
                         mono3d: bool = True,
                         root_strip: str = 'data/nuscenes/',
                         visibilities: Sequence[str] = DEFAULT_VISIBILITIES
                         ) -> Dict:
    """Build + write the extended COCO json (`export_2d_annotation`).

    Args:
        infos: per-sample dicts with keys 'token',
            'ego2global_translation', 'ego2global_rotation', 'cams'
            ({cam: {'sample_data_token', 'data_path', 'cam_intrinsic',
            'sensor2ego_translation', 'sensor2ego_rotation', 'width',
            'height'}}), 'lidar_img' and 'radar_img' ({cam: channel-group
            entries with file_name/pixel_scale_factor/shift/
            empty_channels}).

    Returns the dict (also dumped to `out_path` as json).
    """
    coco = {
        'annotations': [], 'images': [],
        'lidar_projections': [], 'radar_projections': [],
        'categories': [{'id': i, 'name': n}
                       for i, n in enumerate(NUS_CATEGORIES)],
    }
    ann_id = 0
    for info in infos:
        for cam, cam_info in info['cams'].items():
            sd_token = cam_info['sample_data_token']
            coco['images'].append({
                'file_name': _strip_root(cam_info['data_path'], root_strip),
                'id': sd_token,
                'token': info['token'],
                'cam2ego_rotation': cam_info['sensor2ego_rotation'],
                'cam2ego_translation': cam_info['sensor2ego_translation'],
                'ego2global_rotation': info['ego2global_rotation'],
                'ego2global_translation': info['ego2global_translation'],
                'cam_intrinsic': cam_info['cam_intrinsic'],
                'width': cam_info['width'],
                'height': cam_info['height'],
            })
            for rec in get_2d_boxes(db, sd_token, visibilities, mono3d):
                rec['segmentation'] = []
                rec['id'] = ann_id
                ann_id += 1
                coco['annotations'].append(rec)

            for key, arr in (('lidar_img', 'lidar_projections'),
                             ('radar_img', 'radar_projections')):
                entry = dict(info[key][cam])
                entry['id'] = sd_token + key[0]          # 'l' / 'r' suffix
                entry['token'] = info['token']
                for group in entry:
                    if isinstance(entry[group], dict) and \
                            'file_name' in entry[group]:
                        entry[group] = dict(
                            entry[group],
                            file_name=_strip_root(
                                entry[group]['file_name'], root_strip))
                coco[arr].append(entry)

    with open(out_path, 'w') as f:
        json.dump(coco, f)
    return coco
