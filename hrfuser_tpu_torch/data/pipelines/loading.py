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

The card's machine has no `cv2`. `decode` / `imread` choose the decoder
by the first bytes, as `cv2`'s `findDecoder` does, whatever the file is
called (`image_format`):
  * JPEG (`ff d8`) through `data/jpeg.py` (entropy decoding on the host,
    the pixels on `device`; baseline, progressive and arithmetic-coded,
    grey, YCbCr, RGB, CMYK and YCCK, lossless, bit-equal to `cv2` and the
    JAX package's libjpeg decoder);
  * PNG through `data/png.py` (every colour type, bit depth and
    interlace);
  * TIFF and BigTIFF (`II*\0`, `MM\0*`, `II+\0`, `MM\0+`) through
    `data/tiff.py` (libtiff's reading as `cv2` uses it: grey, palette,
    RGB, CMYK and alpha at 1 to 64 bits, integer and float samples,
    strips and tiles, planes, LZW, Deflate, PackBits and JPEG (its pixels
    on `device`), predictors, orientation), on the host;
  * BMP / DIB (`BM`) through `data/bmp.py`, PBM / PGM / PPM (`P1`-`P6`)
    through `data/pxm.py`, PAM (`P7`) through `data/pam.py`, PFM (`PF`,
    `Pf`) through `data/pfm.py`, Sun raster (`59 a6 6a 95`) through
    `data/sunras.py` and Radiance HDR (`#?RADIANCE`, `#?RGBE`) through
    `data/hdr.py`, all on the host, with `cv2`'s conversions
    (`data/cvt.py`);
  * WebP (`RIFF....WEBP`, or a bare chunk or raw bitstream that
    libwebp's `WebPGetFeatures` takes) through `data/webp.py` (lossless
    VP8L, lossy VP8 with libwebp's fancy upsampling, ALPH alpha, the
    extended container and an animation's first frame, as `cv2`'s
    libwebp reads them), decoded on the host by `csrc/webp_decode.cpp`.
Every decoder returns what `cv2.imdecode` does in the three modes, and
raises where `cv2` returns None; `imread` also refuses what `cv2.imread`
refuses when a decoder hands back another type than the mode asks for
(a colour PFM read grey, a grey one read colour). Nothing falls back to
another decoder: bytes none of them reads raise `UnknownImage`. `imwrite`
picks the encoder by the extension, as `cv2.imwrite` does: JPEG through
`data/jpeg.py` (pixels on the image's device, bytes equal to `cv2`'s),
PNG through `data/png.py`.
"""

from __future__ import annotations

import os.path as osp
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from hrfuser_tpu_torch.data import (bmp, hdr, jpeg, pam, pfm, png, pxm,
                                    sunras, tiff, webp)

FLAGS = ('color', 'unchanged', 'grayscale')

_streams = threading.local()


def _own_stream(device: torch.device):
    """This thread's side stream on `device`: a JPEG read for the loader
    decodes there and waits for that stream alone, not for the model's
    work queued on the default stream."""
    streams = getattr(_streams, 'by_device', None)
    if streams is None:
        streams = _streams.by_device = {}
    if device not in streams:
        streams[device] = torch.cuda.Stream(device)
    return streams[device]


def read_jpeg(data: bytes, device='cuda', grey: bool = False) -> np.ndarray:
    """A JPEG byte string as uint8 BGR [H, W, 3] (grey [H, W] with
    `grey`) on the host, its pixels made on `device` (on a stream of this
    thread's own)."""
    device = torch.device(device)
    if device.type != 'cuda':
        return jpeg.decode_jpeg(data, device, grey).numpy()
    with torch.cuda.stream(_own_stream(device)):
        return jpeg.decode_jpeg(data, device, grey).cpu().numpy()


def read_tiff(data: bytes, flag: str = 'color', device='cuda',
              from_file: bool = False) -> np.ndarray:
    """A TIFF byte string as `cv2.imdecode` reads it in mode `flag` (as
    `cv2.imread` reads its file, `from_file`), on the host; the pixels of
    JPEG strips or tiles are made on `device`, on a stream of this
    thread's own."""
    device, lay = torch.device(device), tiff.layout(data)
    if device.type != 'cuda' or lay.compression != 7:
        return tiff.imdecode(data, flag, device, from_file, lay)
    with torch.cuda.stream(_own_stream(device)):
        return tiff.imdecode(data, flag, device, from_file, lay)


class UnknownImage(OSError, ValueError):
    """Bytes no decoder of the port reads: an `IOError`, and a
    `ValueError` so that the server answers 400."""


# cv2's decoders this port has, each with its signature check; a JPEG
# starts `ff d8`, a TIFF `II*\0` or `MM\0*`, a BigTIFF `II+\0` / `MM\0+`
_HOST = {'BMP': bmp, 'Radiance HDR': hdr, 'Sun raster': sunras,
         'PNM': pxm, 'PAM': pam, 'PFM': pfm, 'WebP': webp}
READS = ('JPEG', 'PNG', 'TIFF', *_HOST)


def image_format(data: bytes) -> str:
    """The format `cv2` would pick for these bytes, one of `READS`;
    `UnknownImage` for bytes none of them starts."""
    if data[:2] == b'\xff\xd8':
        return 'JPEG'
    if data[:8] == png.SIGNATURE:
        return 'PNG'
    if data[:4] in (b'II*\0', b'MM\0*', b'II+\0', b'MM\0+'):
        return 'TIFF'
    for name, module in _HOST.items():
        if module.matches(data):
            return name
    raise UnknownImage(f'unknown image signature {bytes(data[:8])!r}: not '
                       f'a {", ".join(READS[:-1])} or {READS[-1]} file')


def decode(data: bytes, flag: str = 'color', device='cuda',
           from_file: bool = False) -> np.ndarray:
    """What `cv2.imdecode(buf, IMREAD_<FLAG>)` gives for the formats of
    `READS`, chosen by the first bytes (`image_format`), as a host array
    (with `from_file`, what `cv2.imread` gives for a file of these bytes,
    which differs for a TIFF, `tiff.imdecode`, and a WebP over 64 MiB,
    `webp.imdecode`); a JPEG's pixels are
    made on `device` (`read_jpeg`), as are a JPEG TIFF's; every other
    format decodes on the host. A JPEG reads grey in
    'grayscale' mode, and in 'unchanged' mode when it has one component.
    What a decoder cannot read raises a
    `ValueError` whose text starts with the format's name (a
    `jpeg.JpegError` for JPEG)."""
    if flag not in FLAGS:
        raise ValueError(f'imread flag {flag!r}: one of {FLAGS}')
    kind = image_format(data)
    try:
        if kind == 'JPEG':
            grey = flag == 'grayscale' or (
                flag == 'unchanged' and jpeg.jpeg_shape(data)[2] == 1)
            return read_jpeg(data, device, grey)
        if kind == 'PNG':
            return png.imdecode(data, unchanged=flag == 'unchanged',
                                grayscale=flag == 'grayscale')
        if kind == 'TIFF':
            return read_tiff(data, flag, device, from_file)
        if kind == 'WebP':
            return webp.imdecode(data, flag, from_file)
        return _HOST[kind].imdecode(data, flag)
    except ValueError as e:
        _name_the_format(kind, e)


def _name_the_format(kind: str, e: ValueError):
    """Raise `e` again, its text starting with the format's name (the
    server's 400 reply)."""
    if str(e).startswith(kind):
        raise e
    raise type(e)(f'{kind}: {e}') from e


def imread(path: str, flag: str = 'color', device='cuda') -> np.ndarray:
    """What `cv2.imread(path, IMREAD_<FLAG>)` gives: 'color' uint8 BGR
    [H, W, 3]; 'unchanged' the file's own depth and channels (alpha
    kept, BGRA), [H, W] for grey; 'grayscale' uint8 [H, W]. The decoder
    is chosen by the file's first bytes, whatever its name (`decode`: a
    JPEG's pixels, and a JPEG TIFF's, made on `device`, every other format
    on the host). Where a decoder gives another type than the mode asks
    for, `cv2.imread` returns None ("Internal imread issue": a colour PFM
    read grey, a grey one read colour), and this raises `ValueError`. A
    TIFF reads as `cv2.imread` reads it from a file, which differs from
    `cv2.imdecode` on two points (`tiff.imdecode`, `from_file`)."""
    if not osp.exists(path):
        raise FileNotFoundError(path)
    with open(path, 'rb') as f:
        data = f.read()
    img = decode(data, flag, device, from_file=True)
    want = {'color': (3, 3), 'grayscale': (2, 1)}.get(flag)
    if want and (img.dtype != np.uint8 or img.ndim != want[0]
                 or (img.ndim == 3 and img.shape[2] != want[1])):
        raise ValueError(f'{path}: a {image_format(data)} file read '
                         f'{flag} decodes to {img.dtype} '
                         f'{list(img.shape)}, which cv2.imread refuses')
    return img


def imdecode(data: bytes, device='cuda') -> torch.Tensor:
    """A camera payload, any format of `READS` (chosen by its first
    bytes), as uint8 BGR [H, W, 3] on `device`, what `cv2.imdecode(buf,
    IMREAD_COLOR)` gives. A JPEG's pixels are made on `device` and stay
    there; every other format decodes on the host and is copied (a JPEG
    TIFF's strips or tiles have their pixels made on `device` first). A
    payload that decodes to anything but BGR (a grey PFM) raises
    `ValueError`."""
    kind = image_format(data)
    if kind == 'JPEG':
        try:
            return jpeg.decode_jpeg(data, device)
        except ValueError as e:
            _name_the_format('JPEG', e)
    img = decode(data, 'color', device if kind == 'TIFF' else 'cpu')
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f'a {kind} camera payload decodes '
                         f'to {img.dtype} {list(img.shape)}, not BGR '
                         f'[H, W, 3]')
    return torch.from_numpy(img).to(device)


def imwrite(path: str, img, device='cuda') -> None:
    """`cv2.imwrite(path, img)` for a .jpg / .jpeg (`jpeg.imwrite`, the
    pixels coded on a tensor's device or on `device`) or a .png
    (`png.imwrite`, on the host) file; uint8 [H, W] or BGR [H, W, 3], or
    uint16 for PNG."""
    lower = path.lower()
    if lower.endswith(('.jpg', '.jpeg')):
        jpeg.imwrite(path, img, device=device)
    elif lower.endswith('.png'):
        if isinstance(img, torch.Tensor):
            img = img.cpu().numpy()
        png.imwrite(path, img)
    else:
        raise ValueError(f'{path}: only .jpg, .jpeg and .png files are '
                         f'written')


class LoadImageFromFile:
    """Camera image -> float32 BGR (`to_rgb` handled by Normalize); a
    JPEG's pixels are made on `device`."""

    def __init__(self, to_float32: bool = True, device='cuda'):
        self.to_float32 = to_float32
        self.device = device

    def __call__(self, results: dict) -> dict:
        prefix = results.get('img_prefix') or ''
        rel = results['img_info'].get('filename',
                                      results['img_info'].get('file_name'))
        fname = osp.join(prefix, rel)
        img = imread(fname, device=self.device)
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
