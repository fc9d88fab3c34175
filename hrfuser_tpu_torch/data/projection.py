"""Storage format of the offline sensor projections (numpy).

Copy of `hrfuser_tpu/data/projection.py:33-41`: lidar and radar
projections are stored as uint16 PNGs, value = (raw + shift) * scale with
scale = 100 and shift = 200; the background, shift * scale, dequantizes
to 0. The projection math itself waits for the data slice of the port.
"""

from __future__ import annotations

import numpy as np

SCALE = 100.0
SHIFT = 200.0


def quantize(values: np.ndarray, scale: float = SCALE,
             shift: float = SHIFT) -> np.ndarray:
    return ((values + shift) * scale).astype(np.uint16)


def dequantize(img: np.ndarray, scale: float = SCALE,
               shift: float = SHIFT) -> np.ndarray:
    return img.astype(np.float32) / scale - shift
