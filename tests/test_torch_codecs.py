"""The port's image codecs for the offline converters, against `cv2`:
`data/png.py:imencode` (its files decode under `cv2` to the input) and
`data/tiff.py` (bit-equal to `cv2.imread(..., IMREAD_UNCHANGED)` on
`cv2`-written LZW + horizontal-predictor files and uncompressed ones,
8- and 16-bit, little- and big-endian; anything else raises
`ValueError` naming the tag and its value)."""

import struct
from pathlib import Path

import cv2
import numpy as np
import pytest

from hrfuser_tpu_torch.data import png, tiff
from hrfuser_tpu_torch.data.pipelines.loading import imread
from tests.oracles.offline_data import (lzw_decode_plain, lzw_encode,
                                        lzw_tiff_bytes, tiff_bytes)

DATA = Path(__file__).resolve().parent / 'data'


def _image(kind, hw=(37, 53)):
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
    base = np.stack([xx * 3, yy * 5, xx + yy], -1) + rng.integers(
        0, 20, (*hw, 3))
    img = {'bgr8': base % 256, 'bgr16': base * 300 + 7,
           'grey8': base[..., 0] % 256, 'grey16': base[..., 1] * 200}[kind]
    return img.astype(np.uint16 if kind.endswith('16') else np.uint8)


@pytest.mark.parametrize('kind', ['bgr8', 'bgr16', 'grey8', 'grey16'])
def test_png_encoder_decodes_under_cv2(kind, tmp_path):
    img = _image(kind)
    data = png.imencode(img)
    got = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    assert got.dtype == img.dtype and got.shape == img.shape
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(png.imdecode(data, unchanged=True), img)
    png.imwrite(str(tmp_path / 'x.png'), img)
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / 'x.png'), cv2.IMREAD_UNCHANGED), img)


@pytest.mark.parametrize('bad', [np.zeros((4, 4), np.float32),
                                 np.zeros((4, 4, 4), np.uint8),
                                 np.zeros((4,), np.uint8)])
def test_png_encoder_refuses_other_images(bad):
    with pytest.raises(ValueError, match='PNG encodes'):
        png.imencode(bad)


def _tiff_image(dtype, hw):
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
    top = 1023 if dtype == np.uint16 else 255
    img = top / 2 + top / 3 * np.sin(xx / 9.0) + rng.normal(0, top / 30, hw)
    return np.clip(img, 0, top).astype(dtype)


@pytest.mark.parametrize('compression', [5, 1])
@pytest.mark.parametrize('dtype,hw', [(np.uint16, (96, 160)),
                                      (np.uint8, (48, 80)),
                                      (np.uint16, (3, 7))])
def test_tiff_reader_equals_cv2_on_cv2_files(dtype, hw, compression,
                                             tmp_path):
    img = _tiff_image(dtype, hw)
    path = str(tmp_path / 'x.tiff')
    assert cv2.imwrite(path, img, [cv2.IMWRITE_TIFF_COMPRESSION,
                                   compression])
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    got = tiff.imread(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(imread(path, 'unchanged'), want)


def test_tiff_reader_on_noise_with_table_resets(tmp_path):
    """Noise fills the LZW table, so the file holds Clear codes."""
    img = np.random.default_rng(2).integers(0, 65536, (64, 96)).astype(
        np.uint16)
    path = str(tmp_path / 'n.tiff')
    cv2.imwrite(path, img)
    np.testing.assert_array_equal(tiff.imread(path), img)


@pytest.mark.parametrize('order', ['<', '>'])
@pytest.mark.parametrize('dtype', [np.uint8, np.uint16])
def test_tiff_byte_orders(order, dtype, tmp_path):
    img = _tiff_image(dtype, (30, 41))
    for name, data in (('raw', tiff_bytes(img, order)),
                       ('lzw', lzw_tiff_bytes(img, order))):
        got = tiff.imdecode(data)
        assert got.dtype == np.dtype(dtype), name
        np.testing.assert_array_equal(got, img, err_msg=name)
        if order == '<':                     # cv2 agrees on what it reads
            (tmp_path / 'x.tiff').write_bytes(data)
            np.testing.assert_array_equal(
                cv2.imread(str(tmp_path / 'x.tiff'), cv2.IMREAD_UNCHANGED),
                img)


@pytest.mark.parametrize('kind', ['noise', 'constant', 'ramp'])
def test_tiff_reader_on_one_strip_of_many_table_runs(kind):
    """The whole image in one LZW strip: Clear codes mid-strip (noise),
    long runs of one byte (a code naming the entry it makes), repeats."""
    rng = np.random.default_rng(4)
    img = {'noise': rng.integers(0, 65536, (80, 120)),
           'constant': np.full((80, 120), 777),
           'ramp': np.arange(80 * 120).reshape(80, 120) % 37}[kind]
    img = img.astype(np.uint16)
    np.testing.assert_array_equal(
        tiff.imdecode(lzw_tiff_bytes(img, rows=80)), img)


@pytest.mark.parametrize('seed', range(4))
def test_lzw_decoder_equals_the_plain_one(seed):
    """On valid streams, cut ones, and random bytes, the whole-array
    decoder returns what the one-code-at-a-time decoder returns, and
    raises where it raises, with the same message."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 4 + 60 * seed, 3000).astype(np.uint8).tobytes()
    stream = lzw_encode(data)
    cases = [(stream, 3000), (stream, 1234), (stream[:len(stream) // 2],
                                              3000)]
    cases += [(rng.integers(0, 256, int(rng.integers(1, 400))).astype(
        np.uint8).tobytes(), int(rng.integers(1, 3000))) for _ in range(60)]
    raised = 0
    for body, size in cases:
        try:
            want, err = lzw_decode_plain(body, size), None
        except ValueError as e:
            want, err = None, str(e)
        if err is None:
            got = tiff._lzw_decode([body], [size])[0].tobytes()
            assert got == want
        else:
            raised += 1
            with pytest.raises(ValueError) as e:
                tiff._lzw_decode([body], [size])
            assert str(e.value) == err
    assert lzw_decode_plain(stream, 3000) == data
    assert 0 < raised < len(cases)


def test_committed_cv2_fixtures_decode_bit_equal():
    want = np.load(DATA / 'decoded_tiff_cv2.npz')
    for name in ('gated16_lzw.tiff', 'grey8_lzw.tiff'):
        ref = want[name.replace('.', '_')]
        np.testing.assert_array_equal(tiff.imread(str(DATA / name)), ref)
        np.testing.assert_array_equal(
            cv2.imread(str(DATA / name), cv2.IMREAD_UNCHANGED), ref)


def _patched(tag, value, kind=3):
    """An uncompressed TIFF with one tag's value replaced (or added)."""
    data = bytearray(tiff_bytes(np.zeros((4, 6), np.uint16)))
    ifd = struct.unpack('<I', data[4:8])[0]
    n = struct.unpack('<H', data[ifd:ifd + 2])[0]
    for i in range(n):
        pos = ifd + 2 + 12 * i
        if struct.unpack('<H', data[pos:pos + 2])[0] == tag:
            data[pos + 2:pos + 12] = struct.pack('<HIHH', kind, 1, value, 0)
            return bytes(data)
    entry = struct.pack('<HHIHH', tag, kind, 1, value, 0)
    data[ifd:ifd + 2] = struct.pack('<H', n + 1)
    end = ifd + 2 + 12 * n
    return bytes(data[:end] + entry + data[end:])


@pytest.mark.parametrize('tag,value', [(259, 7), (259, 8), (258, 32),
                                       (262, 0), (262, 2), (277, 3),
                                       (317, 3), (339, 3), (322, 16),
                                       (266, 2)])
def test_tiff_reader_refuses_other_files_naming_the_tag(tag, value):
    with pytest.raises(ValueError, match=f'tag {tag} .* = {value}'):
        tiff.imdecode(_patched(tag, value))


def test_tiff_reader_refuses_other_containers(tmp_path):
    with pytest.raises(ValueError, match='not a TIFF'):
        tiff.imdecode(b'\x89PNG\r\n\x1a\n')
    with pytest.raises(ValueError, match='BigTIFF'):
        tiff.imdecode(b'II+\x00' + bytes(12))
    colour = str(tmp_path / 'c.tiff')
    cv2.imwrite(colour, np.zeros((4, 6, 3), np.uint8))
    with pytest.raises(ValueError, match='tag 262'):
        tiff.imread(colour)
    (tmp_path / 'g.tiff').write_bytes(tiff_bytes(np.zeros((4, 6),
                                                          np.uint8)))
    with pytest.raises(ValueError, match='TIFF reads unchanged only'):
        imread(str(tmp_path / 'g.tiff'), 'color')
