"""Host pipeline steps of the eval path (numpy in, numpy out).

Port of `Resize`, `Normalize` and `Pad` of `hrfuser_tpu/data/pipelines/
transforms.py:31-135` (the reference's `mmdet/datasets/pipelines/
transforms.py`), on the same `results` dicts. They are the plain
versions that the device pipeline (`device_pipeline.py`) is held to.
The card's machine has no `cv2`: `Resize` samples as `cv2.INTER_LINEAR`
does on a float32 image, through `device_pipeline.resize_image` on a CPU
tensor.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from hrfuser_tpu_torch.data.device_pipeline import resize_image


def rescale_size(h: int, w: int, img_scale: Tuple[int, int],
                 keep_ratio: bool = True) -> Tuple[int, int, np.ndarray]:
    """(new_h, new_w, scale_factor [w_s, h_s, w_s, h_s] float32) of an
    h x w image under `img_scale` = (w, h), as `mmcv.imrescale` sizes it
    (`int(w * scale + 0.5)`)."""
    if keep_ratio:
        max_long, max_short = max(img_scale), min(img_scale)
        scale = min(max_long / max(h, w), max_short / min(h, w))
        new_w, new_h = int(w * scale + 0.5), int(h * scale + 0.5)
    else:
        new_w, new_h = img_scale
    w_scale, h_scale = new_w / w, new_h / h
    return new_h, new_w, np.array([w_scale, h_scale, w_scale, h_scale],
                                  np.float32)


class Resize:
    """Camera resize; `keep_ratio` mirrors `mmcv.imrescale`."""

    def __init__(self, img_scale: Tuple[int, int], keep_ratio: bool = True,
                 skip_keys: Sequence[str] = ()):
        self.img_scale = img_scale                 # (w, h)
        self.keep_ratio = keep_ratio
        self.skip_keys = set(skip_keys)

    def __call__(self, results: dict) -> dict:
        for key in results.get('img_fields', ['img']):
            if key in self.skip_keys:
                continue
            img = results[key]
            h, w = img.shape[:2]
            new_h, new_w, scale_factor = rescale_size(h, w, self.img_scale,
                                                      self.keep_ratio)
            x = torch.from_numpy(np.ascontiguousarray(img, np.float32))
            x = x.reshape(1, h, w, -1)
            resized = resize_image(x, (new_h, new_w))[0].numpy()
            results[key] = resized
            if key == 'img':
                results['img_shape'] = resized.shape
                results['scale_factor'] = scale_factor
        if 'gt_bboxes' in results:
            results['gt_bboxes'] = (results['gt_bboxes']
                                    * results['scale_factor'])
        return results


class Normalize:
    """Per-sensor mean/std; camera additionally converts BGR->RGB."""

    def __init__(self, mean, std, to_rgb: bool = False,
                 keys: Sequence[str] = ('img',), sensor_type: str = 'img'):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_rgb = to_rgb
        self.keys = list(keys)
        self.sensor_type = sensor_type

    def __call__(self, results: dict) -> dict:
        for key in self.keys:
            img = results[key].astype(np.float32)
            if self.to_rgb:
                img = img[..., ::-1]
            results[key] = (img - self.mean) / self.std
        tag = ('img_norm_cfg' if self.sensor_type == 'img'
               else f'{self.sensor_type}_norm_cfg')
        results[tag] = dict(mean=self.mean, std=self.std, to_rgb=self.to_rgb)
        return results


class Pad:
    """Pad every image field to a multiple of `size_divisor` (zeros)."""

    def __init__(self, size_divisor: int = 32):
        self.size_divisor = size_divisor

    def __call__(self, results: dict) -> dict:
        for key in results.get('img_fields', ['img']):
            img = results[key]
            h, w = img.shape[:2]
            ph = int(np.ceil(h / self.size_divisor)) * self.size_divisor
            pw = int(np.ceil(w / self.size_divisor)) * self.size_divisor
            out = np.zeros((ph, pw) + img.shape[2:], img.dtype)
            out[:h, :w] = img
            results[key] = out
        results['pad_shape'] = results['img'].shape
        return results
