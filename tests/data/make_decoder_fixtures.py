"""Writes the decoder fixtures of this folder with `cv2` (run from the
repository root where `cv2` is installed):

    python tests/data/make_decoder_fixtures.py

`camera.jpg` (48x64, quality 95), `camera.png` (8-bit BGR), `grey.png`
(8-bit grey), `sensor16.png` (16-bit, 3 channels), all seeded, and
`decoded_cv2.npz`, what `cv2.imread` gives for each (`IMREAD_COLOR` for
the cameras, `IMREAD_UNCHANGED` for the sensor, `IMREAD_GRAYSCALE` for
the grey image). The card's machine has no `cv2`: its tests hold the
port's decoders to these arrays.
"""

from pathlib import Path

import cv2
import numpy as np

HERE = Path(__file__).resolve().parent


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
    np.savez_compressed(
        HERE / 'decoded_cv2.npz',
        camera_jpg=cv2.imread(str(HERE / 'camera.jpg'), cv2.IMREAD_COLOR),
        camera_png=cv2.imread(str(HERE / 'camera.png'), cv2.IMREAD_COLOR),
        grey_png=cv2.imread(str(HERE / 'grey.png'), cv2.IMREAD_GRAYSCALE),
        sensor16_png=cv2.imread(str(HERE / 'sensor16.png'),
                                cv2.IMREAD_UNCHANGED))


if __name__ == '__main__':
    main()
