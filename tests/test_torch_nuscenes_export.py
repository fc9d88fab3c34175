"""The port's nuScenes annotation export and per-sample conversion
(`data/nuscenes_export.py`, `tools/create_data.py:convert_sample`)
against the JAX package on the same inputs.

The JSON must be byte-equal to JAX's: the per-box hull and clip math
stays float64 numpy on the host in both packages. The sensor images of
one sample (six cameras, LIDAR_TOP and five radars from
`tests/oracles/offline_data.py`, a sweep cut to 2,000 points) must be
bit-equal to the JAX converter's loop (`tools/create_data.py:133-187`,
replayed here with the JAX functions, since the JAX CLI needs the
devkit), in both splat modes. The cases of `tests/test_nuscenes_export.py`
are mirrored on the port.
"""

import json

import numpy as np
import pytest

from hrfuser_tpu.data import nuscenes_export as jax_export
from hrfuser_tpu.data import projection as jax_proj
from hrfuser_tpu_torch.data import nuscenes_export as export
from hrfuser_tpu_torch.data.projection import (box3d_corners, box3d_to_2d,
                                               convex_hull_2d)
from hrfuser_tpu_torch.tools import create_data
from tests.oracles.offline_data import CAMS, RADARS, nuscenes_sample
from tests.test_nuscenes_export import FakeDB


def test_hull_clip_tighter_than_minmax():
    pts = np.array([[10., -50., -50.], [10., -20., -10.], [1., 1., 1.]])
    x1, y1, x2, y2 = box3d_to_2d(pts, np.eye(3), (100, 100))
    assert abs(x1) < 1e-9 and abs(x2 - 10.0) < 1e-9
    assert abs(y2 - 10.0) < 1e-9 and abs(y1 - 5.0) < 1e-9
    assert (x1, y1, x2, y2) == jax_proj.box3d_to_2d(pts, np.eye(3),
                                                    (100, 100))


def test_box_behind_camera_none():
    pts = np.array([[0., 1.], [0., 1.], [-1., -2.]])
    assert box3d_to_2d(pts, np.eye(3), (100, 100)) is None


def test_convex_hull_basic():
    pts = np.array([[0, 0], [2, 0], [2, 2], [0, 2], [1, 1]], float)
    hull = convex_hull_2d(pts)
    assert {tuple(p) for p in hull} == {(0., 0.), (2., 0.), (2., 2.),
                                        (0., 2.)}
    np.testing.assert_array_equal(hull, jax_proj.convex_hull_2d(pts))


def test_box3d_corners_and_2d_boxes_equal_jax():
    rng = np.random.default_rng(3)
    k = np.array([[800., 0., 800.], [0., 800., 450.], [0., 0., 1.]])
    for _ in range(200):
        q = rng.normal(size=4)
        args = (rng.uniform([-30, -10, -5], [30, 10, 40]),
                rng.uniform(0.3, 8, 3), q / np.linalg.norm(q))
        corners = box3d_corners(*args)
        np.testing.assert_array_equal(corners, jax_proj.box3d_corners(*args))
        assert box3d_to_2d(corners, k, (1600, 900)) == jax_proj.box3d_to_2d(
            corners, k, (1600, 900))


def test_get_2d_boxes_fake_db():
    recs = export.get_2d_boxes(FakeDB(), 'sd1', ('2', '3', '4'), True)
    assert len(recs) == 1
    r = recs[0]
    assert r['category_name'] == 'car' and r['visibility_token'] == '4'
    x1, y1, w, h = r['bbox']
    np.testing.assert_allclose([x1, y1], [800 - 800 / 3, 450 - 800 / 3],
                               rtol=1e-6)
    np.testing.assert_allclose([x1 + w, y1 + h],
                               [800 + 800 / 3, 450 + 800 / 3], rtol=1e-6)
    assert r['center2d'][2] == 4.0 and r['attribute_name'] == 'None'
    assert recs == jax_export.get_2d_boxes(FakeDB(), 'sd1', ('2', '3', '4'),
                                           True)


def _fake_infos(db):
    cs = db.tables['calibrated_sensor']['cs1']

    def group(folder, g, empty):
        return {'file_name': f'data/nuscenes/{folder}/{g}/sd1.png',
                'pixel_scale_factor': 100.0, 'shift': 200.0,
                'empty_channels': empty}

    grid = {'width': 640, 'height': 360, 'background': 20000.0,
            'img_scale_factor': 2.5}
    return [{
        'token': 's1', 'ego2global_translation': [0., 0., 0.],
        'ego2global_rotation': [1., 0., 0., 0.],
        'cams': {'CAM_FRONT': {
            'sample_data_token': 'sd1',
            'data_path': 'data/nuscenes/samples/CAM_FRONT/img1.jpg',
            'cam_intrinsic': cs['camera_intrinsic'],
            'sensor2ego_translation': [0., 0., 0.],
            'sensor2ego_rotation': [1., 0., 0., 0.],
            'width': 1600, 'height': 900}},
        'lidar_img': {'CAM_FRONT': dict(
            grid, rih=group('lidar_samples', 'rih', None),
            xz0=group('lidar_samples', 'xz0', [2]))},
        'radar_img': {'CAM_FRONT': dict(
            grid, riv=group('radar_samples', 'riv', None),
            xz0=group('radar_samples', 'xz0', [2]))},
    }]


def test_export_json_byte_equal_and_read_by_the_dataset(tmp_path):
    db = FakeDB()
    coco = export.export_2d_annotation(db, _fake_infos(db),
                                       str(tmp_path / 'port.json'))
    jax_export.export_2d_annotation(db, _fake_infos(db),
                                    str(tmp_path / 'jax.json'))
    got = (tmp_path / 'port.json').read_bytes()
    assert got == (tmp_path / 'jax.json').read_bytes()
    blob = json.loads(got)
    assert blob == json.loads(json.dumps(coco))
    assert blob['images'][0]['file_name'] == 'samples/CAM_FRONT/img1.jpg'
    assert [a['id'] for a in blob['annotations']] == [0]
    assert blob['lidar_projections'][0]['id'] == 'sd1l'
    assert blob['radar_projections'][0]['id'] == 'sd1r'
    assert blob['lidar_projections'][0]['rih']['file_name'] == \
        'lidar_samples/rih/sd1.png'
    from hrfuser_tpu_torch.data.datasets.coco import CocoFusionDataset
    ds = CocoFusionDataset(str(tmp_path / 'port.json'),
                           classes=list(export.NUS_CATEGORIES),
                           test_mode=True)
    assert len(ds) == 1 and ds.get_ann_info(0)['bboxes'].shape == (1, 4)


def _jax_convert(db, sample, lidar, radars, mode):
    """The JAX converter's per-sample loop (`tools/create_data.py:
    133-187`) on the JAX functions: {cam: (rih, xz0, riv, rxz0)}."""
    P = jax_proj

    def to_cam(points, sensor_sd, cam_sd):
        cs = db.get('calibrated_sensor', sensor_sd['calibrated_sensor_token'])
        pose = db.get('ego_pose', sensor_sd['ego_pose_token'])
        cs_cam = db.get('calibrated_sensor',
                        cam_sd['calibrated_sensor_token'])
        pose_cam = db.get('ego_pose', cam_sd['ego_pose_token'])
        t = (P.transform_matrix(cs_cam['translation'], cs_cam['rotation'],
                                inverse=True)
             @ P.transform_matrix(pose_cam['translation'],
                                  pose_cam['rotation'], inverse=True)
             @ P.transform_matrix(pose['translation'], pose['rotation'])
             @ P.transform_matrix(cs['translation'], cs['rotation']))
        pts = np.vstack([points[:3], np.ones((1, points.shape[1]))])
        return (t @ pts)[:3]

    lidar_sd = db.get('sample_data', sample['data']['LIDAR_TOP'])
    out = {}
    for cam in CAMS:
        cam_sd = db.get('sample_data', sample['data'][cam])
        cs_cam = db.get('calibrated_sensor',
                        cam_sd['calibrated_sensor_token'])
        k = np.asarray(cs_cam['camera_intrinsic'])
        wh = (cam_sd['width'], cam_sd['height'])
        pts_cam = to_cam(lidar, lidar_sd, cam_sd)
        uv, mask = P.project_to_image(pts_cam, k, wh)
        rih, xz0 = P.splat_lidar(uv[:, mask],
                                 np.linalg.norm(pts_cam[:, mask], axis=0),
                                 lidar[3, mask], pts_cam[:, mask], mode=mode)
        parts = [[] for _ in range(6)]
        for radar in RADARS:
            r_sd = db.get('sample_data', sample['data'][radar])
            rpc = radars[radar]
            p_cam = to_cam(rpc, r_sd, cam_sd)
            top_cam = to_cam(P.radar_pillar_endpoints(rpc[:3]), r_sd, cam_sd)
            uv_r, m = P.project_to_image(p_cam, k, wh)
            uv_t, _ = P.project_to_image(top_cam, k, wh)
            for lst, v in zip(parts, (
                    uv_r[:, m], uv_t[:, m],
                    np.linalg.norm(p_cam[[0, 2]][:, m], axis=0),
                    rpc[5, m], np.linalg.norm(rpc[8:10, m], axis=0),
                    p_cam[:, m])):
                lst.append(v)
        riv, rxz0 = P.splat_radar_pillars(
            *[np.concatenate(v, -1) for v in parts], mode=mode)
        out[cam] = (rih, xz0, riv, rxz0)
    return out


@pytest.mark.parametrize('mode', ['reference', 'zbuffer'])
def test_convert_sample_bit_equal_to_jax(tmp_path, mode):
    db, lidar, radars = nuscenes_sample(seed=1, n_lidar=2000, n_radar=60)
    info, images = create_data.convert_sample(
        db, db.sample, lidar, radars, str(tmp_path), device='cpu',
        mode=mode)
    want = _jax_convert(db, db.sample, lidar, radars, mode)
    from hrfuser_tpu_torch.data.pipelines.loading import imread
    landed = 0
    for cam in CAMS:
        for key, w in zip(('rih', 'xz0', 'riv', 'rxz0'), want[cam]):
            got = images[cam][key]
            assert got.dtype == np.uint16 and got.shape == (360, 640, 3)
            np.testing.assert_array_equal(got, w, err_msg=f'{cam} {key}')
        landed += int((images[cam]['rih'][..., 0] != 20000).sum())
        # the PNGs on disk decode to the same images
        for entry, group, key in (('lidar_img', 'rih', 'rih'),
                                  ('radar_img', 'xz0', 'rxz0')):
            path = tmp_path / info[entry][cam][group]['file_name']
            np.testing.assert_array_equal(imread(str(path), 'unchanged'),
                                          images[cam][key])
    assert landed > 500             # the sweep reaches every camera
    assert info == create_data.sample_info(db, db.sample)
    assert list(info['cams']) == CAMS


def test_export_of_converted_infos_byte_equal_to_jax(tmp_path):
    db, lidar, radars = nuscenes_sample(seed=2, n_lidar=500, n_radar=20)
    info, _ = create_data.convert_sample(db, db.sample, lidar, radars,
                                         device='cpu')
    coco = export.export_2d_annotation(db, [info],
                                       str(tmp_path / 'port.json'))
    jax_export.export_2d_annotation(db, [info], str(tmp_path / 'jax.json'))
    assert (tmp_path / 'port.json').read_bytes() == \
        (tmp_path / 'jax.json').read_bytes()
    assert len(coco['images']) == 6
    assert 5 <= len(coco['annotations']) < 40     # visibility, canvas, class
    assert len(coco['lidar_projections']) == 6


def test_convert_sample_refuses_a_missing_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    db, lidar, radars = nuscenes_sample(seed=0, n_lidar=10, n_radar=2)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        create_data.convert_sample(db, db.sample, lidar, radars)
