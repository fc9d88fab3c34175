"""Data-loading pipeline steps (host, numpy), with no `cv2`.

Port of `hrfuser_tpu/data/pipelines/loading.py:47-200` (the reference's
`mmdet/datasets/pipelines/loading.py`), on the same `results` dicts:
  * `LoadImageFromFile`: the camera image, BGR, as float32;
  * `LoadProjectedSensorImageFile`: uint16 PNG sensor projections,
    dequantized per channel group (`v / pixel_scale_factor - shift`),
    empty channels deleted, appended to `img_fields`;
  * `LoadGatedImageFromFile` / `LoadStackedGatedImageFromFile`: the STF
    gated camera (one warped grey image, or three stacked slices);
  * `LoadAnnotations`: gt boxes and labels (+ visibilities);
  * `FilterAnnotations`: drops tiny or barely visible gts.

The card's machine has no `cv2`, so `imread` picks a decoder by the
file's extension: PNG through `data/png.py` (bit-equal to `cv2.imread`
for 8- and 16-bit grey, RGB and RGBA files), JPEG through the libjpeg
decoder of `data/native.py`. Nothing falls back to another decoder:
a file neither can read raises.
"""

from __future__ import annotations

import os.path as osp
from typing import Optional, Sequence

import numpy as np

from hrfuser_tpu_torch.data import native, png

FLAGS = ('color', 'unchanged', 'grayscale')


def imread(path: str, flag: str = 'color') -> np.ndarray:
    """What `cv2.imread(path, IMREAD_<FLAG>)` gives for the files the
    datasets hold: 'color' uint8 BGR [H, W, 3]; 'unchanged' the PNG's own
    depth, [H, W] grey or BGR [H, W, 3]; 'grayscale' uint8 [H, W] of a
    grey PNG (a colour file raises: see `data/png.py`). JPEG reads in
    'color' only."""
    if flag not in FLAGS:
        raise ValueError(f'imread flag {flag!r}: one of {FLAGS}')
    if not osp.exists(path):
        raise FileNotFoundError(path)
    lower = path.lower()
    if lower.endswith('.png'):
        with open(path, 'rb') as f:
            data = f.read()
        return png.imdecode(data, unchanged=flag == 'unchanged',
                            grayscale=flag == 'grayscale')
    if lower.endswith(('.jpg', '.jpeg')):
        if flag != 'color':
            raise ValueError(f'{path}: JPEG reads in colour only, not '
                             f'{flag!r}')
        return native.decode_jpeg_bgr(path)
    raise ValueError(f'{path}: only PNG and JPEG files are read')


class LoadImageFromFile:
    """Camera image -> float32 BGR (`to_rgb` handled by Normalize)."""

    def __init__(self, to_float32: bool = True):
        self.to_float32 = to_float32

    def __call__(self, results: dict) -> dict:
        prefix = results.get('img_prefix') or ''
        rel = results['img_info'].get('filename',
                                      results['img_info'].get('file_name'))
        fname = osp.join(prefix, rel)
        img = imread(fname)
        if self.to_float32:
            img = img.astype(np.float32)
        results['filename'] = fname
        results['ori_filename'] = rel
        results['img'] = img
        results['img_shape'] = img.shape
        results['ori_shape'] = img.shape
        results['img_fields'] = ['img']
        return results


class LoadProjectedSensorImageFile:
    """uint16 PNG sensor projection -> dequantized float32 channels."""

    def __init__(self, sensor_type: str, channels: Sequence[str] = ('rih',),
                 delete_channels: Optional[Sequence[int]] = None):
        if sensor_type not in ('lidar', 'radar'):
            raise ValueError(f'sensor_type {sensor_type!r}: lidar or radar')
        self.sensor_type = sensor_type
        self.channels = list(channels)
        self.delete_channels = list(delete_channels or [])

    def __call__(self, results: dict) -> dict:
        info = results[f'{self.sensor_type}_info']
        prefix = results.get(f'{self.sensor_type}_prefix') or ''
        parts = []
        for ch in self.channels:
            meta = info[ch]
            img = imread(osp.join(prefix, meta['file_name']),
                         'unchanged').astype(np.float32)
            for dc in sorted(meta.get('empty_channels') or [], reverse=True):
                img = np.delete(img, dc, axis=2)
            for dc in sorted(self.delete_channels, reverse=True):
                img = np.delete(img, dc, axis=2)
            img = img / meta['pixel_scale_factor'] - meta['shift']
            parts.append(img)
        img = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=2)
        key = f'{self.sensor_type}_img'
        results[key] = img
        results[f'{self.sensor_type}_ori_shape'] = img.shape
        results.setdefault('img_fields', []).append(key)
        return results


class LoadGatedImageFromFile:
    """STF gated camera: single warped-accumulation grey image."""

    def __init__(self, folder: str = 'gated_acc_wraped_grey'):
        self.folder = folder

    def __call__(self, results: dict) -> dict:
        prefix = results.get('gated_prefix') or ''
        fname = osp.join(prefix, self.folder,
                         results['img_info']['gated_name']
                         if 'gated_name' in results['img_info']
                         else results['img_info']['filename'])
        img = imread(fname, 'grayscale').astype(np.float32)[..., None]
        results['gated_img'] = img
        results['gated_ori_shape'] = img.shape
        results.setdefault('img_fields', []).append('gated_img')
        return results


class LoadStackedGatedImageFromFile:
    """STF gated camera: 3 gated slices stacked on the channel axis; a
    missing slice contributes zeros, as the reference substitutes
    `np.zeros(expected_shape)` (`loading.py:155-229`)."""

    def __init__(self,
                 folders: Sequence[str] = ('gated0_rect', 'gated1_rect',
                                           'gated2_rect'),
                 expected_shape=(720, 1280)):
        self.folders = list(folders)
        self.expected_shape = tuple(expected_shape)

    def __call__(self, results: dict) -> dict:
        prefix = results.get('gated_prefix') or ''
        name = (results['img_info'].get('gated_name')
                or results['img_info']['filename'])
        parts = []
        fnames = []
        for folder in self.folders:
            fname = osp.join(prefix, folder, name)
            fnames.append(fname)
            if osp.exists(fname):
                img = imread(fname, 'grayscale')
                if img.shape != self.expected_shape:
                    raise ValueError(
                        f'unexpected gated image shape {img.shape} '
                        f'(want {self.expected_shape}): {fname}')
            else:
                img = np.zeros(self.expected_shape, np.float32)
            parts.append(img.astype(np.float32)[..., None])
        img = np.concatenate(parts, axis=2) if len(parts) > 1 else parts[0]
        results['gated_filenames'] = fnames
        results['gated_img'] = img
        results['gated_ori_shape'] = img.shape
        results.setdefault('img_fields', []).append('gated_img')
        return results


class LoadAnnotations:
    """gt_bboxes/gt_labels (+ visibilities) from `ann_info`."""

    def __init__(self, with_bbox: bool = True, with_visibility: bool = False):
        self.with_bbox = with_bbox
        self.with_visibility = with_visibility

    def __call__(self, results: dict) -> dict:
        ann = results['ann_info']
        if self.with_bbox:
            results['gt_bboxes'] = ann['bboxes'].astype(np.float32).copy()
            results['gt_labels'] = ann['labels'].astype(np.int64).copy()
            results['bbox_fields'] = ['gt_bboxes']
        if self.with_visibility and 'visibilities' in ann:
            results['gt_visibilities'] = np.asarray(ann['visibilities'])
        return results


class FilterAnnotations:
    """Drop tiny / low-visibility gts (`loading.py:820-866`)."""

    def __init__(self, min_gt_bbox_wh=(1.0, 1.0),
                 min_visibility: Optional[int] = None):
        self.min_wh = min_gt_bbox_wh
        self.min_visibility = min_visibility

    def __call__(self, results: dict) -> dict:
        boxes = results['gt_bboxes']
        w = boxes[:, 2] - boxes[:, 0]
        h = boxes[:, 3] - boxes[:, 1]
        keep = (w > self.min_wh[0]) & (h > self.min_wh[1])
        if self.min_visibility is not None and 'gt_visibilities' in results:
            vis = results['gt_visibilities'].astype(np.int64)
            keep &= vis >= self.min_visibility
        results['gt_bboxes'] = boxes[keep]
        results['gt_labels'] = results['gt_labels'][keep]
        if 'gt_visibilities' in results:
            results['gt_visibilities'] = results['gt_visibilities'][keep]
        return results
