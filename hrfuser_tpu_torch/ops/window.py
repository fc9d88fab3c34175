"""Window partition helpers for 7x7 local window attention.

Counterpart of `hrfuser_tpu.ops.window`: the reference's centre padding
(`mmdet/models/backbones/hrformer.py:200-236`) pads symmetrically, the
extra pixel going to the bottom/right, up to a multiple of the window,
then cuts non-overlapping row-major token windows. NHWC throughout.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def center_pad_shape(h: int, w: int, wh: int, ww: int
                     ) -> Tuple[int, int, int, int]:
    """(pad_top, pad_bottom, pad_left, pad_right) for centre padding."""
    pad_h = math.ceil(h / wh) * wh - h
    pad_w = math.ceil(w / ww) * ww - w
    return pad_h // 2, pad_h - pad_h // 2, pad_w // 2, pad_w - pad_w // 2


def window_partition(x: Tensor, ws: int) -> Tensor:
    """[B, H, W, C] -> [B * nWh * nWw, ws * ws, C], zero centre padding."""
    b, h, w, c = x.shape
    pt, pb, pl, pr = center_pad_shape(h, w, ws, ws)
    x = F.pad(x, (0, 0, pl, pr, pt, pb))
    hp, wp = h + pt + pb, w + pl + pr
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(windows: Tensor, b: int, h: int, w: int, ws: int
                   ) -> Tensor:
    """Inverse of `window_partition`, returning [B, H, W, C]."""
    pt, pb, pl, pr = center_pad_shape(h, w, ws, ws)
    hp, wp = h + pt + pb, w + pl + pr
    c = windows.shape[-1]
    x = windows.reshape(b, hp // ws, wp // ws, ws, ws, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
    return x[:, pt:pt + h, pl:pl + w, :]


def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """Token-pair -> bias-table row, [Wh*Ww, Wh*Ww] (Swin layout,
    `hrformer.py:59-82`)."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww),
                                  indexing='ij'))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel = rel.astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


def rpe_bias(table: Tensor, ws: int) -> Tensor:
    """Gather a [(2ws-1)^2, nh] bias table into [nh, ws*ws, ws*ws]."""
    idx = torch.from_numpy(relative_position_index(ws, ws)).to(table.device)
    n = ws * ws
    return table[idx.reshape(-1)].reshape(n, n, -1).permute(2, 0, 1)
