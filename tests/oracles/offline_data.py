"""Seeded synthetic inputs of the offline converters (numpy only).

Test support for the port's offline preprocessing, shared by the CPU
tests and `chip_smoke.py` phase 11 (which loads this file by path):

- `NuScenesDB`: a devkit-shaped DB (`get(table, token)`,
  `box_velocity`) of one sample with six 1600x900 cameras at
  nuScenes-like intrinsics and extrinsics, LIDAR_TOP, five radars, ego
  poses that differ per sensor, and annotations around the car;
  `lidar_sweep` / `radar_returns` give its point clouds in the sensor
  frames, as `LidarPointCloud` / `RadarPointCloud` hold them;
- `stf_frame`: an HDL-64 scan, radar targets and an STF-like camera;
- `write_gated_frame`: a folder for the gated-warp CLI (calib jsons and
  TF tree, disparity, CAN data, timestamps, three raw gated TIFFs);
- `tiff_bytes`: an uncompressed grey TIFF in either byte order;
  `lzw_tiff_bytes` one in strips, LZW with the horizontal predictor, as
  `cv2` writes them; `lzw_decode_plain` decodes LZW one code at a time.
"""

import json
import os
import struct

import numpy as np

CAMS = ['CAM_FRONT', 'CAM_FRONT_RIGHT', 'CAM_FRONT_LEFT', 'CAM_BACK',
        'CAM_BACK_LEFT', 'CAM_BACK_RIGHT']
RADARS = ['RADAR_FRONT', 'RADAR_FRONT_LEFT', 'RADAR_FRONT_RIGHT',
          'RADAR_BACK_LEFT', 'RADAR_BACK_RIGHT']
# camera yaw about the ego z axis (degrees), focal length (pixels)
CAM_POSE = {'CAM_FRONT': (0, 1266.4), 'CAM_FRONT_RIGHT': (-55, 1260.8),
            'CAM_FRONT_LEFT': (55, 1272.6), 'CAM_BACK': (180, 809.2),
            'CAM_BACK_LEFT': (110, 1256.7), 'CAM_BACK_RIGHT': (-110, 1259.5)}
RADAR_POSE = {'RADAR_FRONT': ((3.41, 0.0, 0.5), 0),
              'RADAR_FRONT_LEFT': ((2.42, 0.8, 0.5), 90),
              'RADAR_FRONT_RIGHT': ((2.42, -0.8, 0.5), -90),
              'RADAR_BACK_LEFT': ((-0.56, 0.6, 0.5), 170),
              'RADAR_BACK_RIGHT': ((-0.56, -0.6, 0.5), -170)}
N_ANNS = 40
RAW_HW = (720, 1280)               # a raw gated slice
DISP_HW = (1024, 1920)             # the stereo disparity
CATEGORIES = ['vehicle.car', 'vehicle.truck', 'human.pedestrian.adult',
              'movable_object.barrier', 'vehicle.bicycle',
              'movable_object.trafficcone', 'animal']


def rot_to_quat(r):
    """3x3 rotation -> quaternion (w, x, y, z)."""
    w = np.sqrt(max(0.0, 1.0 + np.trace(r))) / 2.0
    if w > 1e-6:
        return [w, (r[2, 1] - r[1, 2]) / (4 * w),
                (r[0, 2] - r[2, 0]) / (4 * w), (r[1, 0] - r[0, 1]) / (4 * w)]
    x = np.sqrt(max(0.0, 1.0 + r[0, 0] - r[1, 1] - r[2, 2])) / 2.0
    return [0.0, x, (r[0, 1] + r[1, 0]) / (4 * x),
            (r[0, 2] + r[2, 0]) / (4 * x)]


def yaw_quat(deg):
    a = np.deg2rad(deg) / 2.0
    return [float(np.cos(a)), 0.0, 0.0, float(np.sin(a))]


def _rz(deg):
    a = np.deg2rad(deg)
    return np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0],
                     [0.0, 0.0, 1.0]])


# camera optical axes (x right, y down, z forward) in the ego frame
# (x forward, y left, z up)
_OPTICAL = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])


class NuScenesDB:
    """One nuScenes-like sample (see the module docstring)."""

    def __init__(self, seed=0):
        rng = np.random.default_rng(seed)
        self.tables = {k: {} for k in (
            'sample', 'sample_data', 'calibrated_sensor', 'ego_pose',
            'sample_annotation', 'attribute')}
        ego_xy = np.array([601.3, 1647.2])
        ego_yaw = 31.0
        data = {}
        for i, ch in enumerate(['LIDAR_TOP'] + CAMS + RADARS):
            # each sensor fires at its own time: the ego moved a little
            pose = {'token': f'ep_{ch}',
                    'translation': [float(ego_xy[0] + 0.05 * i),
                                    float(ego_xy[1] + 0.03 * i), 0.0],
                    'rotation': yaw_quat(ego_yaw + 0.02 * i)}
            self.tables['ego_pose'][pose['token']] = pose
            cs = {'token': f'cs_{ch}'}
            sd = {'token': f'sd_{ch}', 'sample_token': 's0',
                  'calibrated_sensor_token': cs['token'],
                  'ego_pose_token': pose['token'], 'is_key_frame': True}
            if ch == 'LIDAR_TOP':
                cs.update(translation=[0.943, 0.0, 1.841],
                          rotation=yaw_quat(-90.0))
                sd.update(sensor_modality='lidar',
                          filename='samples/LIDAR_TOP/s0.pcd.bin')
            elif ch in CAM_POSE:
                yaw, f = CAM_POSE[ch]
                r = _rz(yaw) @ _OPTICAL
                cs.update(translation=[1.5 * np.cos(np.deg2rad(yaw)) + 0.5,
                                       0.5 * np.sin(np.deg2rad(yaw)), 1.52],
                          rotation=[float(v) for v in rot_to_quat(r)],
                          camera_intrinsic=[[f, 0.0, 800.0 + 16.3 * (i % 3)],
                                            [0.0, f, 450.0 + 41.2 * (i % 2)],
                                            [0.0, 0.0, 1.0]])
                sd.update(sensor_modality='camera', width=1600, height=900,
                          filename=f'samples/{ch}/s0.jpg')
            else:
                t, yaw = RADAR_POSE[ch]
                cs.update(translation=list(t), rotation=yaw_quat(yaw))
                sd.update(sensor_modality='radar',
                          filename=f'samples/{ch}/s0.pcd')
            self.tables['calibrated_sensor'][cs['token']] = cs
            self.tables['sample_data'][sd['token']] = sd
            data[ch] = sd['token']
        attrs = ['vehicle.moving', 'vehicle.parked', 'pedestrian.moving',
                 'cycle.with_rider']
        for a in attrs:
            self.tables['attribute'][f'at_{a}'] = {'token': f'at_{a}',
                                                   'name': a}
        self.velocity = {}
        anns = []
        for j in range(N_ANNS):
            rng_m = rng.uniform(3.0, 60.0)
            az = rng.uniform(-np.pi, np.pi)
            local = np.array([rng_m * np.cos(az), rng_m * np.sin(az),
                              rng.uniform(0.3, 1.2)])
            g = _rz(ego_yaw) @ local
            tok = f'a{j}'
            self.tables['sample_annotation'][tok] = {
                'token': tok,
                'translation': [float(ego_xy[0] + g[0]),
                                float(ego_xy[1] + g[1]), float(g[2])],
                'size': [float(v) for v in rng.uniform([0.5, 0.5, 0.8],
                                                       [2.8, 10.0, 3.5])],
                'rotation': yaw_quat(float(rng.uniform(-180, 180))),
                'category_name': CATEGORIES[j % len(CATEGORIES)],
                'visibility_token': str(1 + j % 4),
                'attribute_tokens': ([f'at_{attrs[j % len(attrs)]}']
                                     if j % 3 else [])}
            self.velocity[tok] = rng.normal(0, 3, 3)
            anns.append(tok)
        self.sample = {'token': 's0', 'timestamp': 1532402927647951,
                       'scene_token': 'scene0', 'data': data, 'anns': anns}
        self.tables['sample']['s0'] = self.sample

    def get(self, table, token):
        return self.tables[table][token]

    def box_velocity(self, token):
        return self.velocity[token]


def lidar_sweep(rng, n=34720, beams=32):
    """[4, n] float32 (x, y, z, intensity) in the LIDAR_TOP frame: rings
    of a 32-beam sensor 1.84 m up hitting the ground, or walls at 5-70 m."""
    az = rng.uniform(-np.pi, np.pi, n)
    el = np.deg2rad(rng.choice(np.linspace(-30.0, 10.0, beams), n))
    ground = np.where(el < -0.02, 1.84 / np.sin(-np.minimum(el, -0.02)),
                      np.inf)
    r = np.minimum(ground, rng.uniform(5.0, 70.0, n)) + rng.normal(0, .02, n)
    pts = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                    r * np.sin(el), rng.uniform(0, 100, n)])
    return pts.astype(np.float32)


def radar_returns(rng, n=125):
    """[18, n] float32 in a radar's frame (`RadarPointCloud` rows: x, y, z
    at 0-2, RCS at 5, compensated velocity at 8-9)."""
    pts = np.zeros((18, n), np.float32)
    x = rng.uniform(1.0, 100.0, n)
    pts[0] = x
    pts[1] = x * np.tan(rng.uniform(-0.8, 0.8, n))
    pts[5] = rng.uniform(-5.0, 40.0, n)
    pts[8:10] = rng.normal(0, 5, (2, n))
    return pts


def nuscenes_sample(seed=0, n_lidar=34720, n_radar=125):
    """(db, lidar [4, N], {radar: [18, M]}) of one seeded sample."""
    rng = np.random.default_rng(seed)
    db = NuScenesDB(seed)
    return (db, lidar_sweep(rng, n_lidar),
            {r: radar_returns(rng, n_radar) for r in RADARS})


# velodyne (x forward, y left, z up) -> camera (x right, y down, z forward)
VELO_TO_CAM = np.array([[0.0, -1.0, 0.0, 0.05], [0.0, 0.0, -1.0, -0.2],
                        [1.0, 0.0, 0.0, -0.1], [0.0, 0.0, 0.0, 1.0]])


def stf_frame(rng, n_lidar=110000, n_radar=60, wh=(1280, 768)):
    """(scan [N, 5] float32, radar [M, 5] float64, K, T_velo->cam): an
    HDL-64 sweep (x, y, z, intensity, ring), radar targets (x, y, 0,
    velocity, distance) and a camera looking forward on a `wh` grid."""
    az = rng.uniform(-np.pi, np.pi, n_lidar)
    ring = rng.integers(0, 64, n_lidar)
    el = np.deg2rad(np.linspace(-24.8, 2.0, 64))[ring]
    ground = np.where(el < -0.02, 2.0 / np.sin(-np.minimum(el, -0.02)),
                      np.inf)
    r = np.minimum(ground, rng.uniform(3.0, 80.0, n_lidar))
    scan = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                     r * np.sin(el), rng.uniform(0, 1, n_lidar), ring],
                    1).astype(np.float32)
    x = rng.uniform(2.0, 90.0, n_radar)
    radar = np.stack([x, x * rng.uniform(-0.6, 0.6, n_radar),
                      np.zeros(n_radar), rng.normal(0, 4, n_radar), x], 1)
    k = np.array([[1150.0, 0.0, wh[0] / 2 + 3.7],
                  [0.0, 1150.0, wh[1] / 2 - 5.1], [0.0, 0.0, 1.0]])
    return scan, radar, k, VELO_TO_CAM


def tiff_bytes(img, order='<'):
    """An uncompressed grey TIFF of a uint8 / uint16 [H, W] image, one
    strip, in byte order '<' (II) or '>' (MM)."""
    img = np.asarray(img)
    h, w = img.shape
    bits = img.dtype.itemsize * 8
    pixels = img.astype(img.dtype.newbyteorder(order)).tobytes()
    tags = [(256, 4, w), (257, 4, h), (258, 3, bits), (259, 3, 1),
            (262, 3, 1), (273, 4, 8), (277, 3, 1), (278, 4, h),
            (279, 4, len(pixels))]
    ifd = 8 + len(pixels)
    head = (b'II' if order == '<' else b'MM') + struct.pack(
        order + 'HI', 42, ifd)
    entries = b''.join(
        struct.pack(order + 'HHI', tag, kind, 1)
        + (struct.pack(order + 'HH', value, 0) if kind == 3
           else struct.pack(order + 'I', value))
        for tag, kind, value in tags)
    return (head + pixels + struct.pack(order + 'H', len(tags)) + entries
            + struct.pack(order + 'I', 0))


def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW as libtiff writes it (MSB-first codes of 9-12 bits, a
    Clear code first and when the table fills)."""
    out, acc, nacc = bytearray(), 0, 0
    nbits = 9

    def emit(code):
        nonlocal acc, nacc
        acc, nacc = (acc << nbits) | code, nacc + nbits
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)

    def reset():
        return {bytes([i]): i for i in range(256)}, 258

    emit(256)
    table, free = reset()
    w = b''
    for b in data:
        wc = w + bytes([b])
        if wc in table:
            w = wc
            continue
        emit(table[w])
        table[wc] = free
        free += 1
        if free == 4094:
            emit(256)
            table, free = reset()
            nbits = 9
        elif free > (1 << nbits) - 1:
            nbits += 1
        w = bytes([b])
    if w:
        emit(table[w])
    emit(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def lzw_tiff_bytes(img, order='<', rows=7):
    """A TIFF of `img` in strips of `rows` rows, LZW with the horizontal
    predictor, in byte order `order`."""
    h, w = img.shape
    diff = img.astype(img.dtype.newbyteorder('='))
    diff = np.concatenate([diff[:, :1], np.diff(diff, axis=1)], 1).astype(
        img.dtype.newbyteorder(order))
    strips = [lzw_encode(diff[r:r + rows].tobytes())
              for r in range(0, h, rows)]
    offsets, pos = [], 8
    for s in strips:
        offsets.append(pos)
        pos += len(s)
    n = len(strips)
    arrays = pos
    tags = [(256, 4, 1, w), (257, 4, 1, h),
            (258, 3, 1, img.dtype.itemsize * 8), (259, 3, 1, 5),
            (262, 3, 1, 1), (273, 4, n, arrays if n > 1 else offsets[0]),
            (277, 3, 1, 1), (278, 4, 1, rows),
            (279, 4, n, arrays + 4 * n if n > 1 else len(strips[0])),
            (317, 3, 1, 2)]                  # one strip: values inline
    ifd = arrays + 8 * n
    body = (b''.join(strips) + struct.pack(order + f'{n}I', *offsets)
            + struct.pack(order + f'{n}I', *map(len, strips)))
    entries = b''.join(
        struct.pack(order + 'HHI', tag, kind, count)
        + (struct.pack(order + 'HH', value, 0) if kind == 3
           else struct.pack(order + 'I', value))
        for tag, kind, count, value in tags)
    return ((b'II' if order == '<' else b'MM')
            + struct.pack(order + 'HI', 42, ifd) + body
            + struct.pack(order + 'H', len(tags)) + entries
            + struct.pack(order + 'I', 0))


def lzw_decode_plain(data: bytes, size: int) -> bytes:
    """TIFF LZW decoded one code at a time into at most `size` bytes: the
    plain version of `data/tiff.py`'s whole-array decoder."""
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b'', b'']
    buf = data + b'\0\0\0'
    nbits, pos, end = 9, 0, len(data) * 8
    prev = b''
    while pos + nbits <= end and len(out) < size:
        i = pos >> 3
        word = (buf[i] << 16) | (buf[i + 1] << 8) | buf[i + 2]
        code = (word >> (24 - nbits - (pos & 7))) & ((1 << nbits) - 1)
        pos += nbits
        if code == 256:                                   # Clear
            del table[258:]
            nbits, prev = 9, b''
            continue
        if code == 257:                                   # end of data
            break
        if code < len(table):
            entry = table[code]
            if prev:
                table.append(prev + entry[:1])
        elif code == len(table) and prev:
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError(f'corrupt TIFF LZW data: code {code} with '
                             f'{len(table)} table entries')
        out += entry
        prev = entry
        if len(table) + 1 >= 1 << nbits and nbits < 12:
            nbits += 1
    return bytes(out[:size])


def _tf(child, parent, t, q):
    return dict(child_frame_id=child, frame_id=parent, transform=dict(
        translation=dict(x=t[0], y=t[1], z=t[2]),
        rotation=dict(w=q[0], x=q[1], y=q[2], z=q[3])))


def write_gated_frame(root, frame, rng):
    """A folder for `stf_gated_warp.warp_frame(root, frame,
    'cam_stereo_sgm')`: the stereo-left and gated calibrations (the gated
    camera 0.2 m beside the RGB camera, turned by 1 degree), a smooth
    disparity (5-60 m, a few NaNs), CAN speed and steering, slice
    timestamps, and three 10-bit raw gated slices in uncompressed TIFFs.
    Returns the three slices."""
    for sub in ('cam_stereo_sgm', 'gated0_raw', 'gated1_raw', 'gated2_raw',
                'filtered_relevant_can_data/can_body_basic',
                'filtered_relevant_can_data/can_body_chassis'):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    opt = rot_to_quat(_OPTICAL)
    turned = rot_to_quat(_rz(1.0) @ _OPTICAL)
    tree = [_tf('lidar_hdl64_s3_roof', 'base', [0.0, 0.0, 2.0],
                [1.0, 0.0, 0.0, 0.0]),
            _tf('cam_stereo_left_optical', 'base', [1.5, 0.1, 1.6], opt),
            _tf('bwv_cam_optical', 'base', [1.5, -0.1, 1.7], turned)]
    with open(os.path.join(root, 'calib_tf_tree_full.json'), 'w') as f:
        json.dump(tree, f)
    for name, f_px, wh in (
            ('calib_cam_stereo_left.json', 2355.7, (1920, 1024)),
            ('calib_gated_bwv.json', 2322.4, (1280, 720))):
        p = [[f_px, 0.0, wh[0] / 2 + 4.2, 0.0],
             [0.0, f_px, wh[1] / 2 - 3.1, 0.0], [0.0, 0.0, 1.0, 0.0]]
        with open(os.path.join(root, name), 'w') as f:
            json.dump({'P': p}, f)
    yy, xx = np.mgrid[0:DISP_HW[0], 0:DISP_HW[1]]
    depth = 12.0 + 40.0 * (0.5 + 0.5 * np.sin(xx / 150.0) * np.cos(yy / 90.0))
    disp = (2355.722801 * 0.202993 / depth).astype(np.float32)
    disp[rng.random(disp.shape) < 1e-3] = np.nan
    np.savez(os.path.join(root, 'cam_stereo_sgm', frame + '.npz'), disp)
    can = 'filtered_relevant_can_data'
    with open(os.path.join(root, can, 'can_body_basic', frame + '.json'),
              'w') as f:
        json.dump({'VehSpd_Disp': 43.2}, f)
    with open(os.path.join(root, can, 'can_body_chassis', frame + '.json'),
              'w') as f:
        json.dump({'StWhl_Angl': -35.0}, f)
    base = 1517000000000000000
    stamps = {'rgb': base, 'gated0': base + 31_000_000,
              'gated1': base + 45_000_000, 'gated2': base + 59_000_000}
    with open(os.path.join(root, 'timestamps.json'), 'w') as f:
        json.dump({s: {frame: f'{frame}_{t}'} for s, t in stamps.items()}, f)
    yy, xx = np.mgrid[0:RAW_HW[0], 0:RAW_HW[1]]
    slices = []
    for i in range(3):
        img = (300 + 200 * np.sin(xx / (40.0 + 9 * i)) * np.cos(yy / 33.0)
               + rng.normal(0, 30, RAW_HW))
        img = np.clip(img, 0, 1023).astype(np.uint16)
        with open(os.path.join(root, f'gated{i}_raw', frame + '.tiff'),
                  'wb') as f:
            f.write(tiff_bytes(img))
        slices.append(img)
    return slices
