"""Writes the decoder fixtures of this folder with `cv2` (run from the
repository root where `cv2` is installed):

    python tests/data/make_decoder_fixtures.py

`camera.jpg` (48x64, quality 95), `camera.png` (8-bit BGR), `grey.png`
(8-bit grey), `sensor16.png` (16-bit, 3 channels), all seeded, and
`decoded_cv2.npz`, what `cv2.imread` gives for each (`IMREAD_COLOR` for
the cameras, `IMREAD_UNCHANGED` for the sensor, `IMREAD_GRAYSCALE` for
the grey image). The JPEG decoder's fixtures, 45x61 so that no edge
lines up with an MCU: `jpeg_<sampling>.jpg` for chroma sampling 4:4:4,
4:2:2, 4:2:0, 4:4:0 and 4:1:1, `jpeg_restart.jpg` (4:2:0, a restart
marker every 2 MCUs) and `jpeg_grey.jpg` (one component), each read in
colour into `decoded_cv2.npz` under its name. The card's machine has no
`cv2`: its tests hold the port's decoders to these arrays.
"""

from pathlib import Path

import cv2
import numpy as np

HERE = Path(__file__).resolve().parent


SAMPLING = {'444': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            '422': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            '420': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            '440': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            '411': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


def jpeg_fixtures():
    """The JPEG decoder's fixtures: {name: (parameters, image)}."""
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:45, 0:61]
    base = np.stack([xx * 4, yy * 5, (xx + yy) * 2], -1)
    camera = np.clip(base + rng.integers(0, 60, base.shape), 0,
                     255).astype(np.uint8)
    out = {f'jpeg_{k}': ([cv2.IMWRITE_JPEG_QUALITY, 85,
                          cv2.IMWRITE_JPEG_SAMPLING_FACTOR, v], camera)
           for k, v in SAMPLING.items()}
    out['jpeg_restart'] = ([cv2.IMWRITE_JPEG_RST_INTERVAL, 2], camera)
    out['jpeg_grey'] = ([cv2.IMWRITE_JPEG_QUALITY, 85], camera[..., 1])
    return out


def main():
    rng = np.random.default_rng(0)
    # smooth content, as a camera frame has, so the JPEG is not all noise
    yy, xx = np.mgrid[0:48, 0:64]
    base = np.stack([xx * 3, yy * 4, (xx + yy) * 2], -1)
    camera = np.clip(base + rng.integers(0, 40, base.shape), 0,
                     255).astype(np.uint8)
    cv2.imwrite(str(HERE / 'camera.jpg'), camera,
                [cv2.IMWRITE_JPEG_QUALITY, 95])
    cv2.imwrite(str(HERE / 'camera.png'), camera)
    cv2.imwrite(str(HERE / 'grey.png'),
                rng.integers(0, 256, (48, 64), np.uint8))
    cv2.imwrite(str(HERE / 'sensor16.png'),
                rng.integers(0, 65536, (32, 48, 3), np.uint16))
    jpegs = {}
    for name, (params, img) in jpeg_fixtures().items():
        cv2.imwrite(str(HERE / f'{name}.jpg'), img, params)
        jpegs[name] = cv2.imread(str(HERE / f'{name}.jpg'), cv2.IMREAD_COLOR)
    np.savez_compressed(
        HERE / 'decoded_cv2.npz', **jpegs,
        camera_jpg=cv2.imread(str(HERE / 'camera.jpg'), cv2.IMREAD_COLOR),
        camera_png=cv2.imread(str(HERE / 'camera.png'), cv2.IMREAD_COLOR),
        grey_png=cv2.imread(str(HERE / 'grey.png'), cv2.IMREAD_GRAYSCALE),
        sensor16_png=cv2.imread(str(HERE / 'sensor16.png'),
                                cv2.IMREAD_UNCHANGED))


if __name__ == '__main__':
    main()
