"""The port's PNG reader (`data/png.py`) equals `cv2.imdecode`.

PNGs written by `cv2.imencode` at every scanline filter (None, Sub, Up,
Average, Paeth, and libpng's adaptive choice among all five), and PNGs
written here of every colour type (grey, RGB, palette, grey + alpha,
RGBA) at every bit depth the type allows (1, 2, 4, 8, 16), with and
without tRNS, plain and Adam7-interlaced, with random filter bytes, read
as `cv2.IMREAD_COLOR`, `IMREAD_UNCHANGED` (alpha kept, BGRA) and
`IMREAD_GRAYSCALE` (libpng's fixed-point RGB -> grey), must decode
bit-equal; a JPEG and invalid headers raise `ValueError`.
"""

import itertools
import struct
import zlib

import cv2
import numpy as np
import pytest

from hrfuser_tpu_torch.data.png import SIGNATURE, imdecode

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
    got = imdecode(buf.tobytes(), unchanged=True)
    assert got.dtype == unchanged.dtype and got.shape == unchanged.shape
    np.testing.assert_array_equal(got, unchanged)


def test_jpeg_raises():
    """A JPEG is not a PNG payload (`data/pipelines/loading.imdecode`
    sends JPEG bytes to the JPEG decoder)."""
    ok, buf = cv2.imencode('.jpg', _image('bgr8'))
    assert ok
    with pytest.raises(ValueError, match='not a PNG'):
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
    (dict(interlace=2), 'interlace method 2'),
    (dict(color=5), 'colour type 5'),
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


CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
TYPES = [(color, depth) for color, depths in (
    (0, (1, 2, 4, 8, 16)), (2, (8, 16)), (3, (1, 2, 4, 8)), (4, (8, 16)),
    (6, (8, 16))) for depth in depths]


def _chunk(kind, body):
    return (struct.pack('>I', len(body)) + kind + body
            + struct.pack('>I', zlib.crc32(kind + body)))


def _written(hw, color, depth, interlace, trns, seed):
    """A PNG of random samples behind random filter bytes (any bytes are
    valid filtered data), with a palette (some entries grey) and a tRNS
    chunk where asked."""
    rng = np.random.default_rng(seed)
    h, w = hw
    bits = CHANNELS[color] * depth
    passes = ([(h, w)] if not interlace else
              [(-(-(h - y0) // dy), -(-(w - x0) // dx))
               for x0, y0, dx, dy in ADAM7])
    raw = b''
    for rows, cols in passes:
        if rows > 0 and cols > 0:
            for _ in range(rows):
                raw += bytes([int(rng.integers(0, 5))]) + rng.integers(
                    0, 256, -(-cols * bits // 8)).astype(np.uint8).tobytes()
    out = SIGNATURE + _chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, depth,
                                                  color, 0, 0, interlace))
    if color == 3:
        n = min(256, int(rng.integers(1, 1 << depth)) + 1)
        pal = rng.integers(0, 256, (n, 3)).astype(np.uint8)
        pal[:n // 3] = pal[:n // 3, :1]
        out += _chunk(b'PLTE', pal.tobytes())
        if trns:
            out += _chunk(b'tRNS', rng.integers(0, 256, int(rng.integers(
                1, n + 1))).astype(np.uint8).tobytes())
    elif trns and color in (0, 2):
        out += _chunk(b'tRNS', rng.integers(
            0, 1 << min(depth, 8), CHANNELS[color]).astype('>u2').tobytes())
    return out + _chunk(b'IDAT', zlib.compress(raw)) + _chunk(b'IEND', b'')


@pytest.mark.parametrize('interlace', [0, 1])
@pytest.mark.parametrize('color,depth', TYPES)
def test_every_type_depth_and_interlace_reads_as_cv2(color, depth, interlace):
    """Each of the loader's three modes, on small and odd sizes (Adam7
    passes left empty included), with and without tRNS."""
    for i, (hw, trns) in enumerate(itertools.product(
            ((1, 1), (5, 3), (37, 53)), (False, True))):
        data = _written(hw, color, depth, interlace, trns, seed=i)
        buf = np.frombuffer(data, np.uint8)
        for flag, kw in ((cv2.IMREAD_COLOR, {}),
                         (cv2.IMREAD_UNCHANGED, dict(unchanged=True)),
                         (cv2.IMREAD_GRAYSCALE, dict(grayscale=True))):
            want = cv2.imdecode(buf, flag)
            got = imdecode(data, **kw)
            assert got.dtype == want.dtype and got.shape == want.shape, (
                hw, trns, flag)
            np.testing.assert_array_equal(got, want)


def test_alpha_is_kept_unchanged_and_dropped_in_colour():
    """cv2 keeps a PNG's alpha in `IMREAD_UNCHANGED` (BGRA), as the JAX
    native reader returns 4 channels for an RGBA file."""
    img = _image('bgra8')
    buf = _png(img)
    np.testing.assert_array_equal(imdecode(buf.tobytes(), unchanged=True),
                                  img)
    np.testing.assert_array_equal(imdecode(buf.tobytes()), img[..., :3])


def test_palette_without_plte_raises():
    data = _written((5, 3), 3, 8, 0, False, seed=0)
    start = data.index(b'PLTE') - 4
    length = struct.unpack('>I', data[start:start + 4])[0]
    with pytest.raises(ValueError, match='PLTE'):
        imdecode(data[:start] + data[start + 12 + length:])
