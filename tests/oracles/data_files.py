"""Seeded synthetic dataset folders in the converters' formats.

Test support for the port's data tests: a nuScenes-style folder (COCO
json with `lidar_projections` / `radar_projections`, camera frames,
uint16 `rih` / `riv` projections quantized as `(v + 200) * 100`) and an
STF-style folder (`dense_infos_*.pkl`, camera PNGs, uint16 `yzi` / `yzv`
projections, grey gated images under `gated_acc_wraped_grey/`). PNGs are
written without filters (the PNG format's filter 0), which every decoder
reads and which keeps large frames quick to write and read.
"""

import json
import pickle
import struct
import zlib
from pathlib import Path

import numpy as np


def write_png(path, img):
    """uint8 / uint16 [H, W] or BGR [H, W, 3] -> a PNG file (filter 0)."""
    img = np.asarray(img)
    grey = img.ndim == 2
    h, w = img.shape[:2]
    depth = 16 if img.dtype == np.uint16 else 8
    px = img if grey else img[..., ::-1]                  # BGR -> RGB
    rows = np.ascontiguousarray(px).astype(
        '>u2' if depth == 16 else np.uint8).view(np.uint8).reshape(h, -1)
    data = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1).tobytes()

    def chunk(kind, body):
        return (struct.pack('>I', len(body)) + kind + body
                + struct.pack('>I', zlib.crc32(kind + body)))

    header = struct.pack('>IIBBBBB', w, h, depth, 0 if grey else 2, 0, 0, 0)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(b'\x89PNG\r\n\x1a\n' + chunk(b'IHDR', header)
                           + chunk(b'IDAT', zlib.compress(data, 1))
                           + chunk(b'IEND', b''))


def quantized(rng, hw, channels, hit=0.3):
    """uint16 projection: 0 m background, returns in [-1, 60) m on `hit`
    of the pixels, quantized as the converters do."""
    raw = np.zeros((*hw, channels), np.float32)
    mask = rng.random(hw) < hit
    raw[mask] = rng.uniform(-1, 60, (int(mask.sum()), channels))
    return ((raw + 200.0) * 100.0).astype(np.uint16)


def _boxes(rng, n, hw):
    h, w = hw
    xy = rng.uniform(0, [w * 0.8, h * 0.8], (n, 2))
    wh = rng.uniform([w * 0.05, h * 0.05], [w * 0.3, h * 0.3], (n, 2))
    return np.concatenate([xy, np.minimum(xy + wh, [w, h])], 1)


def write_nuscenes(root, n, cam_hw, grid_hw, classes, seed=0,
                   splits=('ann.json',), ext='png', writer=None):
    """`n` samples: a camera frame of `cam_hw`, lidar `rih` and radar
    `riv` projections on the model grid `grid_hw`, 2-6 boxes an image
    with visibility tokens 1-4; the same json under each name of
    `splits`. `writer(path, bgr)` writes a camera frame of type `ext`."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    images, anns, lidar, radar = [], [], [], []
    for i in range(n):
        name = f'samples/CAM_FRONT/{i:04d}.{ext}'
        cam = rng.integers(0, 256, (*cam_hw, 3)).astype(np.uint8)
        (root / name).parent.mkdir(parents=True, exist_ok=True)
        (writer or write_png)(str(root / name), cam)
        images.append(dict(file_name=name, id=f'tok{i}', width=cam_hw[1],
                           height=cam_hw[0]))
        for j, box in enumerate(_boxes(rng, int(rng.integers(2, 7)),
                                       cam_hw)):
            x0, y0, x1, y1 = (float(v) for v in box)
            anns.append(dict(image_id=f'tok{i}', id=100 * i + j,
                             bbox=[x0, y0, x1 - x0, y1 - y0],
                             category_id=int(rng.integers(len(classes))),
                             iscrowd=0, area=(x1 - x0) * (y1 - y0),
                             visibility_token=str(int(rng.integers(1, 5)))))
        for table, suffix, ch in ((lidar, 'l', 'rih'), (radar, 'r', 'riv')):
            png = f'{ch}/{i:04d}.png'
            write_png(root / png, quantized(rng, grid_hw, 3))
            table.append({'id': f'tok{i}{suffix}', ch: dict(
                file_name=png, pixel_scale_factor=100.0, shift=200.0,
                empty_channels=[])})
    coco = dict(images=images, annotations=anns,
                categories=[dict(id=k, name=c) for k, c in enumerate(classes)],
                lidar_projections=lidar, radar_projections=radar)
    for split in splits:
        (root / split).write_text(json.dumps(coco))
    return root


def write_stf(root, n, cam_hw, sensor_hw, classes, seed=0,
              splits=('dense_infos_train.pkl',)):
    """`n` STF samples: camera PNG `cam_hw`, lidar `yzi` (3 channels) and
    radar `yzv` (3, channel 0 empty) projections and a grey gated image on
    `sensor_hw`, KITTI annos of 2-6 boxes (one `DontCare`); the same
    infos under each name of `splits`."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    infos = []
    for i in range(n):
        cam = f'cam_stereo_left_lut/{i:05d}.png'
        write_png(root / cam, rng.integers(0, 256, (*cam_hw, 3)).astype(
            np.uint8))
        write_png(root / 'gated_acc_wraped_grey' / cam,
                  rng.integers(0, 256, sensor_hw).astype(np.uint8))
        proj = {}
        for key, ch in (('lidar_projections', 'yzi'),
                        ('radar_projections', 'yzv')):
            png = f'{ch}/{i:05d}.png'
            write_png(root / png, quantized(rng, sensor_hw, 3))
            proj[key] = {ch: dict(file_name=png, pixel_scale_factor=100.0,
                                  shift=200.0, empty_channels=[])}
        k = int(rng.integers(2, 7))
        names = [classes[c] for c in rng.integers(len(classes), size=k - 1)]
        names.append('DontCare')
        infos.append({'image': {'image_path': cam,
                                'image_shape': np.array(cam_hw)},
                      'annos': {'name': np.array(names),
                                'bbox': _boxes(rng, k, cam_hw).astype(
                                    np.float32),
                                'truncated': np.zeros(k),
                                'occluded': np.zeros(k)},
                      **proj})
    for split in splits:
        with open(root / split, 'wb') as f:
            pickle.dump(infos, f)
    return root
