"""The port's `data/native.py` against the JAX package's native loader
(`hrfuser_tpu/data/native.py`, libpng and libjpeg through
`_native/loader.cpp`) on the CPU: `tests/test_native_loader.py`'s six
cases, each held to the JAX function as well as to `cv2`.

The fused sensor decode is bit-equal in float32 to the JAX library's
(compared as bit patterns): both multiply by the float32 reciprocals of
`scale` and `std` and round every step, the JAX library built without
FMA. Where the JAX library departs from `cv2` (an 8-bit PNG read as
v x 257; palette and tRNS files written past its buffer's end, so never
called here on such a file) the port follows `cv2`, as
`test_eight_bit_and_palette_pngs_read_as_cv2` shows.
"""

import cv2
import numpy as np
import pytest
import torch

from hrfuser_tpu.data import native as jax_native
from hrfuser_tpu_torch.data import native

pytestmark = pytest.mark.skipif(not jax_native.available(),
                                reason='the JAX native library needs g++, '
                                       'libpng and libjpeg')

NORMS = [(None, None), ([1., 2., 3.], [2., 3., 4.]),
         ([0.1, -2.7, 3.3], [0.3, 7., 1e-3])]


@pytest.fixture(scope='module')
def png16(tmp_path_factory):
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 65535, (40, 60, 3), np.uint16)
    path = str(tmp_path_factory.mktemp('native') / 'x.png')
    cv2.imwrite(path, raw)
    return path, raw


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def test_png16_shape(png16):
    path, _ = png16
    assert native.png16_shape(path) == jax_native.png16_shape(path) \
        == (40, 60, 3)


def test_png16_matches_cv2(png16):
    path, raw = png16
    dec = native.decode_png16(path)
    np.testing.assert_array_equal(dec, jax_native.decode_png16(path))
    np.testing.assert_array_equal(dec, cv2.imread(path,
                                                  cv2.IMREAD_UNCHANGED))
    np.testing.assert_array_equal(dec, raw)


@pytest.mark.parametrize('scale,shift', [(100.0, 200.0), (3.7, -1.1),
                                         (256.0, 0.0)])
@pytest.mark.parametrize('norm', range(len(NORMS)))
def test_fused_sensor_decode(png16, scale, shift, norm):
    path, raw = png16
    mean, std = NORMS[norm]
    fused = native.decode_sensor_png(path, scale, shift, mean, std,
                                     device='cpu')
    assert fused.dtype == torch.float32 and fused.shape == (40, 60, 3)
    want = jax_native.decode_sensor_png(path, scale, shift, mean, std)
    np.testing.assert_array_equal(_bits(fused.numpy()), _bits(want))
    # the divide form, within a few ulps of v / scale (cancelled by the
    # subtractions, scaled by 1 / std)
    manual = raw.astype(np.float32) / scale - shift
    ulps = 4 * np.spacing(np.float32(65535 / scale))
    if mean is not None:
        manual = (manual - np.float32(mean)) / np.float32(std)
        ulps /= min(std)
    np.testing.assert_allclose(fused.numpy(), manual, rtol=1e-5, atol=ulps)


def test_jpeg_matches_cv2(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (32, 48, 3), np.uint8)
    path = str(tmp_path / 'x.jpg')
    cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_QUALITY, 95])
    dec = native.decode_jpeg_bgr(path, device='cpu')
    np.testing.assert_array_equal(dec, jax_native.decode_jpeg_bgr(path))
    np.testing.assert_array_equal(dec, cv2.imread(path))


def test_threaded_batch(png16, tmp_path):
    path, _ = png16
    rng = np.random.default_rng(2)
    paths, shapes = [], []
    for i in range(5):
        p = str(tmp_path / f'{i}.png')
        cv2.imwrite(p, rng.integers(0, 65535, (20 + i, 30, 3), np.uint16))
        paths.append(p)
        shapes.append((20 + i, 30, 3))
    paths, shapes = paths + [path] * 3, shapes + [(40, 60, 3)] * 3
    means = [[float(i), 1., 2.] for i in range(len(paths))]
    stds = [[2., 3., 0.5 + i] for i in range(len(paths))]
    outs = native.decode_sensor_batch(paths, shapes, 100.0, 200.0, means,
                                      stds, num_threads=3, device='cpu')
    want = jax_native.decode_sensor_batch(paths, shapes, 100.0, 200.0,
                                          means, stds, num_threads=3)
    for p, m, s, o, w in zip(paths, means, stds, outs, want):
        single = native.decode_sensor_png(p, 100.0, 200.0, m, s,
                                          device='cpu')
        assert torch.equal(o, single)
        np.testing.assert_array_equal(_bits(o.numpy()), _bits(w))


def test_missing_file_errors(png16, tmp_path):
    with pytest.raises(IOError):
        native.png16_shape('/nonexistent/file.png')
    with pytest.raises(IOError):
        native.decode_sensor_png('/nonexistent/file.png', 1.0, 0.0,
                                 device='cpu')
    bad = tmp_path / 'bad.png'
    bad.write_bytes(b'not a png')
    path, _ = png16
    with pytest.raises(IOError, match='2 failures'):
        native.decode_sensor_batch(
            [path, '/nonexistent/file.png', str(bad), path],
            [(40, 60, 3)] * 4, 1.0, 0.0, device='cpu')
    with pytest.raises(IOError, match='1 failures'):     # another shape
        native.decode_sensor_batch([path], [(40, 61, 3)], 1.0, 0.0,
                                   device='cpu')


def test_eight_bit_and_palette_pngs_read_as_cv2(tmp_path):
    """An 8-bit PNG reads as its values (the JAX library reads v x 257); a
    palette PNG as BGR, where the JAX library reports one channel and
    writes three past its buffer (not called here)."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (12, 20, 3), np.uint8)
    path = str(tmp_path / 'x8.png')
    cv2.imwrite(path, img)
    np.testing.assert_array_equal(native.decode_png16(path), img)
    np.testing.assert_array_equal(jax_native.decode_png16(path),
                                  img.astype(np.uint16) * 257)
    got = native.decode_sensor_png(path, 2.0, 1.0, device='cpu').numpy()
    np.testing.assert_array_equal(got, img.astype(np.float32) * 0.5 - 1.0)
    from hrfuser_tpu_torch.data import png
    palette = png.imencode(img[..., 0])          # grey; then as a palette
    pal_path = tmp_path / 'pal.png'
    pal_path.write_bytes(_as_palette(palette))
    want = cv2.imread(str(pal_path), cv2.IMREAD_UNCHANGED)
    assert want.shape == (12, 20, 3)
    np.testing.assert_array_equal(native.decode_png16(str(pal_path)), want)
    assert native.png16_shape(str(pal_path)) == (12, 20, 3)


def _as_palette(grey_png: bytes) -> bytes:
    """An 8-bit grey PNG rewritten as a palette PNG of 256 grey entries:
    the same samples as indices (colour type 3, a PLTE chunk)."""
    import struct
    import zlib
    ihdr_at = 8
    n = struct.unpack('>I', grey_png[ihdr_at:ihdr_at + 4])[0]
    body = bytearray(grey_png[ihdr_at + 8:ihdr_at + 8 + n])
    body[9] = 3                                  # colour type: palette
    plte = bytes(np.repeat(np.arange(256, dtype=np.uint8), 3))

    def chunk(kind, data):
        crc = zlib.crc32(kind + data) & 0xFFFFFFFF
        return struct.pack('>I', len(data)) + kind + data + struct.pack(
            '>I', crc)

    rest = grey_png[ihdr_at + 12 + n:]
    return (grey_png[:8] + chunk(b'IHDR', bytes(body))
            + chunk(b'PLTE', plte) + rest)
