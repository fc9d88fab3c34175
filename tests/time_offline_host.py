"""Host-clock times of the offline converters on the CPU: the JAX
package's loops against the port's `device='cpu'` path on the same
seeded inputs, and the port's TIFF / PNG codecs against `cv2` and the
one-code-at-a-time LZW decoder.

    JAX_PLATFORMS=cpu python -m tests.time_offline_host

Needs the JAX package and `cv2`, so it runs where the tests run, not on
the card's machine (`chip_smoke.py` phase 11 and `chip_profile.py
--offline` time the card there). Each line is the median, min and max
ms of a few runs:

- one nuScenes sample (`chip_smoke.py` phase 11a's, seed 0): the JAX
  converter's per-camera loop (`tests/test_torch_nuscenes_export.py:
  _jax_convert`, the loop of `tools/create_data.py`) and the port's
  `convert_sample`, both modes; the 24 PNG encodes, port and `cv2`;
- one STF frame (phase 11b's): `tools/stf_projection.project_frame`
  against the port's;
- one 720x1280 gated slice as `cv2` writes it (LZW, predictor 2): read
  by `cv2`, by `data/tiff.py`, and strip by strip by `lzw_decode_plain`;
- one gated frame (phase 11c's): `tools/stf_gated_warp.warp_frame`
  against the port's, from uncompressed and from `cv2`-written LZW
  slices.
"""

import importlib.util
import tempfile
import time
from pathlib import Path

import cv2
import numpy as np

from hrfuser_tpu_torch.data import png, tiff
from hrfuser_tpu_torch.tools import stf_gated_warp, stf_projection
from hrfuser_tpu_torch.tools.create_data import convert_sample
from tests.oracles.offline_data import (lzw_decode_plain, nuscenes_sample,
                                        stf_frame, write_gated_frame)
from tests.test_torch_nuscenes_export import _jax_convert

ROOT = Path(__file__).resolve().parents[1]


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f'jax_{name}', ROOT / 'tools' / f'{name}.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _ms(fn, runs):
    fn()                                                    # warm-up
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return f'{np.median(times):.1f} (min {min(times):.1f}, max ' \
           f'{max(times):.1f}, {runs} runs)'


def _plain_tiff(data):
    """The strips of an LZW TIFF through `lzw_decode_plain`."""
    _, tags = tiff.directory(data)
    rows, w = tags[278][0], tags[256][0]
    return [lzw_decode_plain(data[o:o + c], rows * w * 2)
            for o, c in zip(tags[273], tags[279])]


def main():
    db, lidar, radars = nuscenes_sample(seed=0)
    print('== one nuScenes sample (34,720 lidar points, 5 x 125 radar '
          'returns, 6 cameras)')
    for mode in ('reference', 'zbuffer'):
        print(f'  {mode}: JAX loop', _ms(lambda: _jax_convert(
            db, db.sample, lidar, radars, mode), 3))
        print(f'  {mode}: port, CPU', _ms(lambda: convert_sample(
            db, db.sample, lidar, radars, None, 'cpu', mode), 5))
    _, images = convert_sample(db, db.sample, lidar, radars, None, 'cpu')
    imgs = [im for cam in images.values() for im in cam.values()]
    print('  24 PNG encodes: port', _ms(
        lambda: [png.imencode(im) for im in imgs], 5), '; cv2', _ms(
        lambda: [cv2.imencode('.png', im) for im in imgs], 5))

    print('== one STF frame (110,000 points, 60 radar targets, 1280x768)')
    frame = stf_frame(np.random.default_rng(1))
    jax_stf = _tool('stf_projection')
    print('  JAX tool', _ms(lambda: jax_stf.project_frame(*frame), 3),
          '; port, CPU', _ms(lambda: stf_projection.project_frame(
              *frame, device='cpu'), 5))

    jax_warp = _tool('stf_gated_warp')
    with tempfile.TemporaryDirectory() as root:
        slices = write_gated_frame(root, 'f_00001',
                                   np.random.default_rng(2))

        def warps(label):
            print(f'  {label}: JAX tool', _ms(lambda: jax_warp.warp_frame(
                root, 'f_00001', 'cam_stereo_sgm'), 3), '; port, CPU',
                _ms(lambda: stf_gated_warp.warp_frame(
                    root, 'f_00001', 'cam_stereo_sgm', device='cpu'), 3))

        print('== one gated frame (three 720x1280 slices, 1024x1920 '
              'disparity)')
        warps('uncompressed slices')
        for i, img in enumerate(slices):
            cv2.imwrite(f'{root}/gated{i}_raw/f_00001.tiff', img)
        warps('cv2-written LZW slices')
        path = f'{root}/gated0_raw/f_00001.tiff'
        data = Path(path).read_bytes()
        assert np.array_equal(tiff.imdecode(data), slices[0])
        print(f'== one cv2-written LZW slice ({len(data)} bytes): cv2',
              _ms(lambda: cv2.imread(path, cv2.IMREAD_UNCHANGED), 5),
              '; data/tiff.py', _ms(lambda: tiff.imdecode(data), 5),
              '; one code at a time', _ms(lambda: _plain_tiff(data), 1))


if __name__ == '__main__':
    main()
