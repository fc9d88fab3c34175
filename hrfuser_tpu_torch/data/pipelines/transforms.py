"""Geometric and photometric pipeline steps (host, numpy in, numpy out).

Port of `hrfuser_tpu/data/pipelines/transforms.py` (the reference's
`mmdet/datasets/pipelines/transforms.py`), on the same `results` dicts:
  * `Resize` (`:31-70`): keep-ratio rescale of the camera image, with
    `skip_keys` leaving sensor images on their own grid untouched;
  * `RandomFlip` (`:73-96`): flips every `img_fields` entry and the boxes;
  * `Normalize` (`:99-119`): per-sensor mean/std (+ BGR->RGB for the
    camera);
  * `Pad` (`:122-138`): pad every image field to `size_divisor`;
  * `RandomDrop` (`:141-154`): modality dropout (zero a whole stream);
  * `Crop` (`:157-216`): crop at fixed `offsets` (or random), with
    `skip_keys`, `thresh_in_frame` retention and `crop_factor` tracking;
  * `FormatBundle` (`:219-252`): gts padded to `max_gts` with `gt_valid`;
  * `Compose`.

Randomness comes from `results['rng']` (a `np.random.Generator` the
loader seeds per sample), drawn in the JAX steps' order, so a seed gives
the JAX package's crops, flips and drops. The card's machine has no
`cv2`: `Resize` samples as `cv2.INTER_LINEAR` does on a float32 image,
through `device_pipeline.resize_image` on a CPU tensor. `Resize`,
`Normalize` and `Pad` are also the plain versions the device pipeline
(`device_pipeline.py`) is held to.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from hrfuser_tpu_torch.data.device_pipeline import resize_image


def _rng(results: dict) -> np.random.Generator:
    if 'rng' not in results:
        results['rng'] = np.random.default_rng()
    return results['rng']


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


class RandomFlip:
    """Horizontal flip of all image fields and boxes."""

    def __init__(self, flip_ratio: float = 0.5):
        self.flip_ratio = flip_ratio

    def __call__(self, results: dict) -> dict:
        flip = (_rng(results).random() < self.flip_ratio
                if self.flip_ratio > 0 else False)
        results['flip'] = bool(flip)
        results['flip_direction'] = 'horizontal'
        if not flip:
            return results
        for key in results.get('img_fields', ['img']):
            results[key] = np.ascontiguousarray(results[key][:, ::-1, :])
        h, w = results['img_shape'][:2]
        for key in results.get('bbox_fields', []):
            boxes = results[key].copy()
            boxes[..., 0] = w - results[key][..., 2]
            boxes[..., 2] = w - results[key][..., 0]
            results[key] = boxes
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


class RandomDrop:
    """Modality dropout: zero whole input streams with prob p per key."""

    def __init__(self, p: Sequence[float], keys: Sequence[str]):
        if len(p) != len(keys):
            raise ValueError(f'{len(p)} drop probabilities for {len(keys)} '
                             f'keys')
        self.p = list(p)
        self.keys = list(keys)

    def __call__(self, results: dict) -> dict:
        rng = _rng(results)
        for prob, key in zip(self.p, self.keys):
            if rng.random() < prob:
                results[key] = np.zeros_like(results[key])
        return results


class Crop:
    """Crop at `offsets` (h, w), or at random offsets, keeping a box when
    at least `thresh_in_frame` of its area before any crop stays in."""

    def __init__(self, crop_size: Tuple[int, int],
                 offsets: Optional[Tuple[int, int]] = None,
                 skip_keys: Sequence[str] = (),
                 thresh_in_frame: float = 0.0,
                 bbox_clip_border: bool = True):
        self.crop_size = crop_size                 # (h, w)
        self.offsets = offsets
        self.skip_keys = set(skip_keys)
        self.thresh_in_frame = thresh_in_frame
        self.bbox_clip_border = bbox_clip_border

    def __call__(self, results: dict) -> dict:
        ch, cw = self.crop_size
        offset_h = offset_w = 0
        for key in results.get('img_fields', ['img']):
            if key in self.skip_keys:
                continue
            img = results[key]
            margin_h = max(img.shape[0] - ch, 0)
            margin_w = max(img.shape[1] - cw, 0)
            if self.offsets is not None:
                offset_h, offset_w = self.offsets
            else:
                rng = _rng(results)
                offset_h = int(rng.integers(0, margin_h + 1))
                offset_w = int(rng.integers(0, margin_w + 1))
            img = img[offset_h:offset_h + ch, offset_w:offset_w + cw, ...]
            results[key] = img
            if key == 'img':
                results['img_shape'] = img.shape
        prev = results.get('crop_factor', (0, 0))
        results['crop_factor'] = (prev[0] + offset_h, prev[1] + offset_w)

        img_shape = results['img_shape']
        for key in results.get('bbox_fields', []):
            boxes = results[key]
            if key + '_area_orig' not in results:
                results[key + '_area_orig'] = (
                    (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]))
            off = np.array([offset_w, offset_h, offset_w, offset_h],
                           np.float32)
            boxes = boxes - off
            if self.bbox_clip_border:
                boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, img_shape[1])
                boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, img_shape[0])
            area = ((boxes[:, 2] - boxes[:, 0])
                    * (boxes[:, 3] - boxes[:, 1]))
            in_frame = area / np.maximum(results[key + '_area_orig'], 1e-6)
            keep = ((boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
                    & (in_frame >= self.thresh_in_frame))
            results[key] = boxes[keep]
            results[key + '_area_orig'] = results[key + '_area_orig'][keep]
            if key == 'gt_bboxes' and 'gt_labels' in results:
                results['gt_labels'] = results['gt_labels'][keep]
        return results


class FormatBundle:
    """Final packaging: float32 contiguous HWC images and the gts padded
    to `max_gts` with a validity mask, so every batch has one shape (the
    reference's DataContainers, `pipelines/formating.py:197-237`)."""

    META_KEYS = ('filename', 'ori_filename', 'ori_shape', 'img_shape',
                 'pad_shape', 'flip', 'crop_factor', 'sample_idx')

    def __init__(self, max_gts: int = 100,
                 sensor_keys: Sequence[str] = ('img',)):
        self.max_gts = max_gts
        self.sensor_keys = list(sensor_keys)

    def __call__(self, results: dict) -> dict:
        out = {}
        for key in self.sensor_keys:
            out[key] = np.ascontiguousarray(
                results[key].astype(np.float32))
        g = self.max_gts
        boxes = np.zeros((g, 4), np.float32)
        labels = np.zeros((g,), np.int32)
        valid = np.zeros((g,), bool)
        if 'gt_bboxes' in results:
            n = min(len(results['gt_bboxes']), g)
            boxes[:n] = results['gt_bboxes'][:n]
            labels[:n] = results['gt_labels'][:n]
            valid[:n] = True
        out['gt_boxes'] = boxes
        out['gt_labels'] = labels
        out['gt_valid'] = valid
        out['img_shape'] = np.asarray(results['img_shape'][:2], np.float32)
        out['scale_factor'] = np.asarray(
            results.get('scale_factor', np.ones(4, np.float32)), np.float32)
        out['meta'] = {k: results.get(k) for k in self.META_KEYS}
        return out


class Compose:
    def __init__(self, steps):
        self.steps = list(steps)

    def __call__(self, results: dict) -> Optional[dict]:
        for s in self.steps:
            results = s(results)
            if results is None:
                return None
        return results
