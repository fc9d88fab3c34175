"""Detection drawing and sensor heatmaps on the image's device, without
`cv2`.

Port of `hrfuser_tpu/utils/visualization.py` (the reference's
`show_result` / dataset browser surface): boxes with class / score
labels drawn on a BGR image, the pipeline's normalisation undone for
inspection, a sensor channel rendered as a `COLORMAP_TURBO` heatmap. The
functions take a numpy array or a tensor; a tensor stays on its device,
an array goes to `device` (the card unless the caller passes 'cpu'), and
every pixel is made there. They return uint8 tensors.

What `cv2` draws is reproduced pixel for pixel (`tests/test_torch_
visualization.py`):
  * `cv2.rectangle(img, p1, p2, colour, 2)` with `LINE_8` is the union of
    a 3-pixel band along each side (from corner to corner) and a plus of
    radius 1 at each corner, clipped to the image.
  * `cv2.putText(..., FONT_HERSHEY_SIMPLEX, 0.45, colour, 1, LINE_AA)`:
    `cv2` 5.0 advances the pen by whole pixels, so a label is its
    characters' coverage masks (`utils/glyphs.py`, rendered once from
    `cv2`) placed one after another, each blended as
    `dst + round((colour - dst) * a / 255)`.
  * `applyColorMap(..., COLORMAP_TURBO)` is the 256-entry table `TURBO`
    (checked against `cv2` by `tests/oracles/make_render_tables.py`).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch
from torch import Tensor

from hrfuser_tpu_torch.utils import glyphs

_PALETTE = [(56, 168, 255), (255, 112, 31), (46, 204, 113), (231, 76, 60),
            (155, 89, 182), (241, 196, 15), (52, 152, 219), (230, 126, 34),
            (26, 188, 156), (149, 165, 166)]

# COLORMAP_TURBO, entry i = the BGR colour of level i
TURBO = np.frombuffer(bytes.fromhex(
    '3b12304315324a1833511b34581e355f21366624376d2738732a39792d3a802f'
    '3b86323c8b353d91383e973b3f9c3e3fa24040a74341ac4641b14942b54b42ba'
    '4e43bf5144c35444c75644cb5945cf5c45d35e45d66146da6446dd6646e06946'
    'e36b46e66e47e97147eb7347ee7647f07847f27b47f47d46f68046f88246fa85'
    '46fb8746fc8a45fd8c45fe8f44fe9143ff9442ff9641ff9940fe9b3efe9e3dfd'
    'a03bfca33afba538faa837f8ab35f7ad33f5af31f4b22ff2b42ef0b72ceeb92a'
    'ebbc28e9be27e7c025e4c323e2c522dfc720ddc91fdacb1ed8cd1cd5d01bd2d2'
    '1ad0d41acdd519cad718c8d918c5db18c2dd18c0de18bde018bbe219b9e319b6'
    'e41ab4e61cb2e71dafe91facea20aaeb22a7ec25a4ee27a1ef2a9ef02c9bf12f'
    '98f23294f33591f4388ef53c8af63f87f74384f84680f84a7df94e7afa5276fa'
    '5573fb596ffc5d6cfc6169fd6566fd6962fe6d5ffe715cfe7559fe7956ff7d53'
    'ff8051ff844eff884bff8b49ff8f47ff9244fe9642fe9940fe9c3ffd9f3dfda1'
    '3cfca43afca739fba938fbac37faaf36f9b136f8b435f7b735f6b934f5bc34f4'
    'be34f3c134f1c334f0c634efc834edcb34eccd34ead035e9d235e7d435e5d736'
    'e4d936e2db37e0dd37dfdf37dde138dbe338d9e539d7e739d5e939d3eb3ad1ec'
    '3acfee3acdef3acbf13ac9f23ac7f43ac5f53ac3f63ac1f739bef839bcf939ba'
    'fa38b8fb37b6fb36b3fc36b1fc35aefd34acfd33a9fe32a7fe31a4fe30a1fe2f'
    '9efe2d9bfe2c99fe2b96fe2a93fe2990fe278dfd268afd2587fc2384fc2281fb'
    '217efb1f7bfa1e78f91d75f91c72f81a6ff7196cf61869f51766f41563f31460'
    'f2135df1125bf01158ef1055ed0f53ec0e50eb0d4eea0c4be80c49e70b47e50a'
    '45e40a43e20941e1083fdf083ddd073bdc0739da0637d80635d60533d40531d2'
    '052fd0042dce042bcc042aca0328c80326c50325c30223c10221be0220bc021e'
    'b9021db7011bb4011ab20118af0117ac0116a90114a70113a40112a101109e01'
    '0f9b010e98010d95010b92010a8e02098b02088802078502068102057e03047a'
), np.uint8).reshape(256, 3)


def as_image(img, device='cuda') -> Tensor:
    """`img` as a tensor: a tensor where it lies, an array on `device`."""
    if isinstance(img, Tensor):
        return img
    return torch.from_numpy(np.ascontiguousarray(img)).to(device)


def denormalize_image(img, mean, std, to_rgb: bool = True,
                      device='cuda') -> Tensor:
    """Invert the Normalize step -> uint8 BGR [H, W, 3] (float64
    arithmetic, truncated after clipping to [0, 255], as numpy does)."""
    x = as_image(img, device).to(torch.float64)
    std = torch.as_tensor(np.asarray(std, np.float64), device=x.device)
    mean = torch.as_tensor(np.asarray(mean, np.float64), device=x.device)
    out = x * std + mean
    if to_rgb:
        out = out.flip(-1)
    return out.clamp(0, 255).to(torch.uint8)


def _fill(out: Tensor, x0: int, y0: int, x1: int, y1: int,
          colour: Tensor) -> None:
    """Paint the pixels x0..x1, y0..y1 (inclusive) inside the image."""
    h, w = out.shape[:2]
    x0, y0, x1, y1 = max(x0, 0), max(y0, 0), min(x1, w - 1), min(y1, h - 1)
    if x0 <= x1 and y0 <= y1:
        out[y0:y1 + 1, x0:x1 + 1] = colour


def rectangle_(out: Tensor, p1, p2, colour: Tensor,
               thickness: int = 2) -> None:
    """`cv2.rectangle(out, p1, p2, colour, 2)` in place, `LINE_8`,
    integer corners (the thickness the JAX drawing uses, the only one
    reproduced)."""
    if thickness != 2:
        raise ValueError(f'rectangle thickness {thickness}: only 2 is '
                         f'reproduced')
    (x1, y1), (x2, y2) = p1, p2
    corners = [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]
    for (ax, ay), (bx, by) in zip(corners, corners[1:] + corners[:1]):
        if ay == by and ax != bx:                  # a 3-pixel band
            _fill(out, min(ax, bx), ay - 1, max(ax, bx), ay + 1, colour)
        elif ax == bx and ay != by:
            _fill(out, ax - 1, min(ay, by), ax + 1, max(ay, by), colour)
    for x, y in corners:                           # the corner's plus
        _fill(out, x - 1, y, x + 1, y, colour)
        _fill(out, x, y - 1, x, y + 1, colour)


@functools.cache
def _glyph_stack(device: torch.device) -> Tensor:
    """Every glyph's mask in one int32 tensor [n, hmax, wmax] on
    `device`."""
    table = glyphs.table()
    hmax = max(m.shape[0] for *_, m in table)
    wmax = max(m.shape[1] for *_, m in table)
    stack = np.zeros((len(table), hmax, wmax), np.int32)
    for i, (*_, m) in enumerate(table):
        stack[i, :m.shape[0], :m.shape[1]] = m
    return torch.from_numpy(stack).to(device)


def put_text_(out: Tensor, text: str, org, colour: Tensor) -> None:
    """`cv2.putText(out, text, org, FONT_HERSHEY_SIMPLEX, 0.45, colour, 1,
    LINE_AA)` in place: each character's coverage `a` at its pen position,
    blended as `dst + round((colour - dst) * a / 255)` (never a tie, so
    the rounding is `floor((2q + 255) / 510)` in integers)."""
    h, w = out.shape[:2]
    stack = _glyph_stack(out.device)
    col = colour.to(torch.int32)
    x, y = org
    for ch in text:
        i = glyphs.index(ch)
        advance, dx, dy, mask = glyphs.table()[i]
        gh, gw = mask.shape
        r0, c0 = y + dy, x + dx
        x += advance
        top, left = max(r0, 0), max(c0, 0)
        bottom, right = min(r0 + gh, h), min(c0 + gw, w)
        if top >= bottom or left >= right:
            continue
        a = stack[i, top - r0:bottom - r0, left - c0:right - c0, None]
        dst = out[top:bottom, left:right].to(torch.int32)
        q = (col - dst) * a
        out[top:bottom, left:right] = (
            dst + torch.div(2 * q + 255, 510, rounding_mode='floor')
        ).to(out.dtype)


def draw_detections(img, boxes, labels=None, scores=None,
                    class_names: Optional[Sequence[str]] = None,
                    score_thr: float = 0.0, thickness: int = 2,
                    device='cuda') -> Tensor:
    """Draw [N, 4] boxes (+labels/scores) on a copy of a BGR uint8 image:
    boxes with a score below `score_thr` are skipped, colours come from
    the class id modulo 10, later boxes paint over earlier ones, and the
    label sits at (x1, max(y1 - 4, 10)) on its baseline."""
    out = as_image(img, device).clone()
    boxes = np.asarray(boxes.cpu() if isinstance(boxes, Tensor) else boxes)
    labels = (None if labels is None else np.asarray(
        labels.cpu() if isinstance(labels, Tensor) else labels))
    scores = (None if scores is None else np.asarray(
        scores.cpu() if isinstance(scores, Tensor) else scores))
    for i, box in enumerate(boxes.reshape(-1, 4)):
        score = float(scores[i]) if scores is not None else None
        if score is not None and score < score_thr:
            continue
        cls = int(labels[i]) if labels is not None else 0
        colour = torch.tensor(_PALETTE[cls % len(_PALETTE)],
                              dtype=out.dtype, device=out.device)
        x1, y1, x2, y2 = [int(round(v)) for v in box]
        rectangle_(out, (x1, y1), (x2, y2), colour, thickness)
        text = ''
        if class_names is not None and labels is not None:
            text = str(class_names[cls])
        if score is not None:
            text = f'{text} {score:.2f}'.strip()
        if text:
            put_text_(out, text, (x1, max(y1 - 4, 10)), colour)
    return out


def percentiles(values: Tensor, qs: Sequence[float]) -> list:
    """numpy's default (`linear`) percentiles of a float32 vector, as
    `np.percentile(values, qs)` computes them: on the sorted values at
    virtual index (n - 1) q / 100, `a + (b - a) t` (or `b - (b - a)
    (1 - t)` for t >= 0.5) with `b - a` in float32 and the rest in float64.
    Python floats."""
    s = torch.sort(values.to(torch.float32)).values
    n = s.numel()
    out = []
    for q in qs:
        virtual = (n - 1) * (q / 100)
        lo = int(np.floor(virtual))
        if virtual >= n - 1:
            lo = n - 1
        pair = s[[lo, min(lo + 1, n - 1)]]
        a, diff = float(pair[0]), float(pair[1] - pair[0])
        t = virtual - lo if virtual < n - 1 else 0.0
        out.append(float(pair[1]) - diff * (1 - t) if t >= 0.5
                   else a + diff * t)
    return out


def sensor_image_to_heatmap(sensor_img, channel: int = 0,
                            device='cuda') -> Tensor:
    """Render one sensor-image channel [H, W, C] as a TURBO heatmap
    (uint8 BGR [H, W, 3]): the 2nd-98th percentile of the non-zero values
    stretched to [0, 1] (float64, as numpy computes it for float32 data
    and float64 percentiles), scaled by 255 and truncated."""
    ch = as_image(sensor_img, device)[..., channel].to(torch.float32)
    mask = ch != 0
    if bool(mask.any()):
        lo, hi = percentiles(ch[mask], (2, 98))
        span = torch.tensor(max(hi - lo, 1e-6), dtype=torch.float64,
                            device=ch.device)
        level = ((ch.to(torch.float64) - lo) / span).clamp(0, 1) * 255
    else:
        level = ch * 255
    turbo = torch.from_numpy(TURBO.copy()).to(ch.device)
    return turbo[level.to(torch.uint8).long()]
