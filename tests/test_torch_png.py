"""The port's PNG reader (`data/png.py`) equals `cv2.imdecode`.

PNGs written by `cv2.imencode` at every scanline filter (None, Sub, Up,
Average, Paeth, and libpng's adaptive choice among all five), read both
as `cv2.IMREAD_COLOR` and as `cv2.IMREAD_UNCHANGED` (alpha dropped), must
decode bit-equal; JPEG, palette and interlaced files raise `ValueError`.
"""

import struct

import cv2
import numpy as np
import pytest

from hrfuser_tpu_torch.data.png import imdecode

FILTERS = {'none': cv2.IMWRITE_PNG_FILTER_NONE,
           'sub': cv2.IMWRITE_PNG_FILTER_SUB,
           'up': cv2.IMWRITE_PNG_FILTER_UP,
           'avg': cv2.IMWRITE_PNG_FILTER_AVG,
           'paeth': cv2.IMWRITE_PNG_FILTER_PAETH,
           'all': cv2.IMWRITE_PNG_ALL_FILTERS}


def _image(kind):
    """Smooth gradients plus noise, so every filter has work to do."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:37, 0:53]
    base = np.stack([xx * 3, yy * 5, xx + yy], -1) + rng.integers(
        0, 20, (37, 53, 3))
    if kind == 'bgr8':
        return (base % 256).astype(np.uint8)
    if kind == 'bgr16':
        return (base * 300 + rng.integers(0, 300, base.shape)).astype(
            np.uint16)
    if kind == 'grey8':
        return (base[..., 0] % 256).astype(np.uint8)
    if kind == 'grey16':
        return (base[..., 1] * 200).astype(np.uint16)
    alpha = rng.integers(0, 256, (37, 53, 1)).astype(np.uint8)
    return np.dstack([(base % 256).astype(np.uint8), alpha])       # bgra8


def _png(img, flt='all'):
    ok, buf = cv2.imencode('.png', img, [cv2.IMWRITE_PNG_FILTER,
                                         FILTERS[flt]])
    assert ok
    return buf


@pytest.mark.parametrize('flt', sorted(FILTERS))
@pytest.mark.parametrize('kind', ['bgr8', 'bgr16', 'grey8', 'grey16',
                                  'bgra8'])
def test_decodes_like_cv2(kind, flt):
    buf = _png(_image(kind), flt)
    color = cv2.imdecode(buf, cv2.IMREAD_COLOR)
    got = imdecode(buf.tobytes())
    assert got.dtype == color.dtype and got.shape == color.shape
    np.testing.assert_array_equal(got, color)
    unchanged = cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)
    if unchanged.ndim == 3:
        unchanged = unchanged[..., :3]                  # alpha dropped
    got = imdecode(buf.tobytes(), unchanged=True)
    assert got.dtype == unchanged.dtype and got.shape == unchanged.shape
    np.testing.assert_array_equal(got, unchanged)


def test_jpeg_raises():
    ok, buf = cv2.imencode('.jpg', _image('bgr8'))
    assert ok
    with pytest.raises(ValueError, match='JPEG'):
        imdecode(buf.tobytes())


def _with_header(data: bytes, **fields) -> bytes:
    """The PNG with IHDR fields changed (the reader checks no CRC)."""
    w, h, depth, color, comp, flt, interlace = struct.unpack(
        '>IIBBBBB', data[16:29])
    vals = dict(depth=depth, color=color, interlace=interlace) | fields
    ihdr = struct.pack('>IIBBBBB', w, h, vals['depth'], vals['color'], comp,
                       flt, vals['interlace'])
    return data[:16] + ihdr + data[29:]


@pytest.mark.parametrize('fields,match', [
    (dict(interlace=1), 'interlaced'),
    (dict(color=3), 'colour type 3'),
    (dict(depth=4), 'bit depth 4')])
def test_unsupported_pngs_raise(fields, match):
    data = _png(_image('bgr8')).tobytes()
    with pytest.raises(ValueError, match=match):
        imdecode(_with_header(data, **fields))


def test_garbage_and_truncated_payloads_raise():
    data = _png(_image('bgr8')).tobytes()
    with pytest.raises(ValueError, match='not a PNG'):
        imdecode(b'GIF89a' + data)
    with pytest.raises(ValueError):
        imdecode(data[:len(data) // 2])
