"""Writes the TIFF fixtures of this folder with `cv2` (run from the
repository root where `cv2` is installed):

    python tests/data/make_tiff_fixtures.py

`gated16_lzw.tiff` (96x160, 10-bit values in uint16, as the STF gated
raw frames) and `grey8_lzw.tiff` (48x80 uint8), both as `cv2.imwrite`
writes them (LZW, horizontal predictor, strips), seeded, and
`decoded_tiff_cv2.npz`, what `cv2.imread(..., IMREAD_UNCHANGED)` gives
for each. The card's machine has no `cv2`: its checks hold the port's
TIFF reader to these arrays.
"""

from pathlib import Path

import cv2
import numpy as np

HERE = Path(__file__).resolve().parent


def main():
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:96, 0:160]
    gated = np.clip(300 + 200 * np.sin(xx / 11.0) * np.cos(yy / 7.0)
                    + rng.normal(0, 20, (96, 160)), 0, 1023).astype(np.uint16)
    cv2.imwrite(str(HERE / 'gated16_lzw.tiff'), gated)
    cv2.imwrite(str(HERE / 'grey8_lzw.tiff'),
                rng.integers(0, 256, (48, 80), np.uint8))
    np.savez_compressed(
        HERE / 'decoded_tiff_cv2.npz',
        **{name.replace('.', '_'): cv2.imread(str(HERE / name),
                                              cv2.IMREAD_UNCHANGED)
           for name in ('gated16_lzw.tiff', 'grey8_lzw.tiff')})


if __name__ == '__main__':
    main()
