"""Anchor generation (numpy, static shapes).

Copy of `hrfuser_tpu.ops.anchors.AnchorGenerator` (the reference
`mmdet/core/anchor/anchor_generator.py:131-195,318-450`): base anchors
of size `stride * scale` per aspect ratio, centred at the cell origin,
tiled row-major over each feature grid with the anchor index fastest;
and each anchor's validity flag for a padded input.
`tests/test_torch_configs.py` holds it bit-equal to the JAX original.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


class AnchorGenerator:
    def __init__(self, strides: Sequence[int],
                 ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 scales: Sequence[float] = (8,)):
        self.strides = list(strides)
        self.ratios = np.asarray(ratios, np.float32)
        self.scales = np.asarray(scales, np.float32)
        self.base_anchors = [self._base_anchors(float(s))
                             for s in self.strides]

    def _base_anchors(self, base_size: float) -> np.ndarray:
        h_ratios = np.sqrt(self.ratios)
        w_ratios = 1.0 / h_ratios
        # scale-major ordering: ratio index varies slowest
        ws = (base_size * w_ratios[:, None] * self.scales[None, :]).reshape(-1)
        hs = (base_size * h_ratios[:, None] * self.scales[None, :]).reshape(-1)
        return np.stack([-0.5 * ws, -0.5 * hs, 0.5 * ws, 0.5 * hs],
                        axis=-1).astype(np.float32)

    def grid_anchors(self, featmap_sizes: Sequence[Tuple[int, int]]
                     ) -> List[np.ndarray]:
        """Per-level [H*W*A, 4] anchors; featmap_sizes is [(H, W), ...]."""
        assert len(featmap_sizes) == len(self.strides)
        out = []
        for lvl, (fh, fw) in enumerate(featmap_sizes):
            s = self.strides[lvl]
            shift_x = np.arange(fw, dtype=np.float32) * s
            shift_y = np.arange(fh, dtype=np.float32) * s
            xx, yy = np.meshgrid(shift_x, shift_y)
            shifts = np.stack([xx, yy, xx, yy], axis=-1).reshape(-1, 4)
            anchors = shifts[:, None, :] + self.base_anchors[lvl][None, :, :]
            out.append(anchors.reshape(-1, 4))
        return out

    def valid_flags(self, featmap_sizes: Sequence[Tuple[int, int]],
                    pad_shape: Tuple[int, int]) -> List[np.ndarray]:
        """Per-level [H*W*A] bool: the anchor's grid cell lies inside
        ceil(pad_shape / stride) (`single_level_valid_flags`,
        `anchor_generator.py:392-450`)."""
        out = []
        for lvl, (fh, fw) in enumerate(featmap_sizes):
            s = self.strides[lvl]
            vx = np.arange(fw) < min(int(np.ceil(pad_shape[1] / s)), fw)
            vy = np.arange(fh) < min(int(np.ceil(pad_shape[0] / s)), fh)
            valid = (vy[:, None] & vx[None, :]).reshape(-1)
            out.append(np.repeat(valid, len(self.base_anchors[lvl])))
        return out
