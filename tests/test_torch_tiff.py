"""The port's TIFF reader (`data/tiff.py`, `tiff_codecs.py`,
`tiff_rgba.py`) equals `cv2` 5.0 (libtiff 4.7), chosen by the first bytes
(`data/pipelines/loading.py`).

Every variant `tests/oracles/tiff_files.py` writes (grey, bilevel,
palette, RGB, RGBA, CMYK; 1- to 64-bit integer and float samples; strips,
tiles, planes; none, LZW, Deflate, PackBits and JPEG; predictors 2 and 3;
FillOrder 2; BigTIFF and both byte orders; orientations; several pages)
and `cv2.imwrite`'s own TIFFs read as `cv2.imdecode` reads their bytes
and `cv2.imread` their file, in `IMREAD_COLOR`, `IMREAD_UNCHANGED` and
`IMREAD_GRAYSCALE`: dtype, shape and every value. Where `cv2` returns
None, and where the port leaves a file out, it raises `ValueError`
naming the tag and its value. One file of each family is held to the JAX
package's `_imread`, and the loaders to the JAX package's loaders.
"""

import io
import struct
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from hrfuser_tpu_torch.data import tiff, tiff_codecs, tiff_rgba
from hrfuser_tpu_torch.data.pipelines import loading

sys.path.insert(0, str(Path(__file__).resolve().parent / 'oracles'))
import tiff_files as tf  # noqa: E402

FLAGS = {'color': cv2.IMREAD_COLOR, 'unchanged': cv2.IMREAD_UNCHANGED,
         'grayscale': cv2.IMREAD_GRAYSCALE}
VARIANTS = tf.variants(np.random.default_rng(22))
REFUSED = tf.refused(np.random.default_rng(22))
cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_SILENT)


def _cv2(data: bytes, flag: str, path=None):
    if path is None:
        return cv2.imdecode(np.frombuffer(data, np.uint8), FLAGS[flag])
    return cv2.imread(str(path), FLAGS[flag])


def _same(got, want, label):
    assert got.dtype == want.dtype and got.shape == want.shape, (
        label, got.dtype, got.shape, want.dtype, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=label)


def _holds(data: bytes, path, flags=FLAGS):
    """`loading.decode` and `loading.imread` against `cv2.imdecode` and
    `cv2.imread` in each mode: equal, or both refusing."""
    path.write_bytes(data)
    for flag in flags:
        for want, read in ((_cv2(data, flag), lambda: loading.decode(
                data, flag, 'cpu')), (_cv2(data, flag, path), lambda:
                                      loading.imread(str(path), flag,
                                                     'cpu'))):
            if want is None:
                with pytest.raises(ValueError):
                    read()
            else:
                _same(read(), want, flag)


@pytest.mark.parametrize('name', sorted(VARIANTS))
def test_reads_like_cv2(name, tmp_path):
    _holds(VARIANTS[name], tmp_path / 'frame.bin')


@pytest.mark.parametrize('name', sorted(REFUSED))
def test_refuses_what_cv2_refuses(name):
    data = REFUSED[name]
    for flag in FLAGS:
        assert _cv2(data, flag) is None
        with pytest.raises(ValueError, match='TIFF'):
            loading.decode(data, flag, 'cpu')


def _pil(img, **kw) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, 'TIFF', **kw)
    return buf.getvalue()


def _left_out():
    """Files `cv2` reads and the port leaves out: (bytes, tag, value)."""
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (20, 24, 3)).astype(np.uint8)
    bits = (rgb[..., 0] > 127)
    from PIL import Image
    lab, cmyk, rgba = io.BytesIO(), io.BytesIO(), io.BytesIO()
    Image.fromarray(rgb, 'LAB').save(lab, 'TIFF')
    Image.fromarray(rgb).convert('CMYK').save(cmyk, 'TIFF',
                                              compression='tiff_jpeg')
    Image.fromarray(rgb).convert('RGBA').save(rgba, 'TIFF',
                                              compression='tiff_jpeg')
    return {
        'CCITT G3': (_pil(bits, compression='group3'), 259, 3),
        'CCITT G4': (_pil(bits, compression='group4'), 259, 4),
        'CIELab': (lab.getvalue(), 262, 8),
        'YCbCr uncompressed': (tf.tiff(rgb, photometric=6), 262, 6),
        'CMYK JPEG': (cmyk.getvalue(), 259, 7),
        'RGBA JPEG': (rgba.getvalue(), 259, 7),
        '12-bit grey': (tf.tiff(rng.integers(0, 256, (4, 9)).astype(
            np.uint8), tags=[(258, 3, 12), (256, 4, 6)]), 258, 12),
        'grey planes': (tf.tiff(rgb[..., :2], extra=[2], planar=2), 262, 1),
    }


LEFT_OUT = _left_out()


@pytest.mark.parametrize('name', sorted(LEFT_OUT))
def test_left_out_files_raise_naming_the_tag(name):
    data, tag, value = LEFT_OUT[name]
    assert any(_cv2(data, flag) is not None for flag in FLAGS)
    for flag in FLAGS:
        with pytest.raises(ValueError, match=f'tag {tag} .* = {value}'):
            tiff.imdecode(data, flag, 'cpu')


# PIL's libtiff writes: every mode it saves as TIFF, with LZW, and the
# JPEG modes
_PIL_CASES = [(m, 'tiff_lzw') for m in ('1', 'L', 'LA', 'P', 'RGB', 'RGBA',
                                        'CMYK', 'I;16', 'I', 'F')] + [
    (m, 'tiff_jpeg') for m in ('L', 'RGB', 'YCbCr')] + [
    ('RGB', 'packbits'), ('RGBA', 'tiff_deflate'), ('P', None)]


@pytest.mark.parametrize('mode,compression', _PIL_CASES)
def test_pil_written_files(mode, compression, tmp_path):
    from PIL import Image
    yy, xx = np.mgrid[0:45, 0:70]
    rgb = ((np.stack([xx * 3, yy * 5, xx + yy], -1) + np.random.default_rng(
        11).integers(0, 30, (45, 70, 3))) % 256).astype(np.uint8)
    img = (Image.fromarray(rgb[..., 0].astype(np.uint16) * 250)
           if mode == 'I;16' else Image.fromarray(rgb).convert(mode))
    buf = io.BytesIO()
    img.save(buf, 'TIFF', **({'compression': compression} if compression
                            else {}))
    _holds(buf.getvalue(), tmp_path / 'x.bin')


def _cv2_file(tmp_path, img, compression):
    path = tmp_path / 'cv2.tiff'
    assert cv2.imwrite(str(path), img, [cv2.IMWRITE_TIFF_COMPRESSION,
                                        compression])
    return path


@pytest.mark.parametrize('compression', [1, 5, 8, 32773, 32946])
@pytest.mark.parametrize('channels', [1, 3, 4])
def test_cv2_written_8_and_16_bit_files(compression, channels, tmp_path):
    rng = np.random.default_rng(channels)
    for dtype, top in ((np.uint8, 256), (np.uint16, 65536)):
        img = rng.integers(0, top, (41, 67, channels)).astype(dtype)
        img = img[..., 0] if channels == 1 else img
        path = _cv2_file(tmp_path, img, compression)
        _holds(path.read_bytes(), tmp_path / 'x.bin')


def test_cv2_written_jpeg_file(tmp_path):
    """`cv2.imwrite` writes JPEG TIFFs for grey images only (colour ones
    fail there: strips of 34 rows)."""
    yy, xx = np.mgrid[0:64, 0:80]
    img = ((xx * 3 + yy * 2) % 256).astype(np.uint8)
    path = _cv2_file(tmp_path, img, 7)
    _holds(path.read_bytes(), tmp_path / 'x.bin')
    assert not cv2.imwrite(str(tmp_path / 'c.tiff'), np.dstack([img] * 3),
                           [cv2.IMWRITE_TIFF_COMPRESSION, 7])


@pytest.mark.parametrize('dtype', [np.float32, np.float64, np.int8,
                                   np.int16, np.int32])
@pytest.mark.parametrize('channels', [1, 3, 4])
def test_cv2_written_typed_files(dtype, channels, tmp_path):
    img = np.random.default_rng(5).normal(0, 90, (23, 35, channels))
    img = (img if np.dtype(dtype).kind == 'f' else np.clip(
        img * 300, np.iinfo(dtype).min, np.iinfo(dtype).max)).astype(dtype)
    img = img[..., 0] if channels == 1 else img
    for compression in (5, 8):
        path = _cv2_file(tmp_path, img, compression)
        assert loading.imread(str(path), 'unchanged', 'cpu').dtype == dtype
        _holds(path.read_bytes(), tmp_path / 'x.bin')


# the ten cases `test_torch_codecs.py`'s refusal test held before TIFF
# read every mode: each now a file of its kind, read as cv2 reads it
_FORMERLY_REFUSED = {
    (259, 7): dict(photometric=6, compression=7, rows=16),
    (259, 8): dict(compression=8, predictor=2),
    (258, 32): dict(dtype=np.float32, compression=8, predictor=3),
    (262, 0): dict(grey=True, photometric=0, compression=5),
    (262, 2): dict(),
    (277, 3): dict(compression=32773),
    (317, 3): dict(dtype=np.float64, compression=5, predictor=3),
    (339, 3): dict(dtype=np.float32, channels=1),
    (322, 16): dict(tile=(16, 16), compression=5),
    (266, 2): dict(fill_order=2, compression=8),
}


@pytest.mark.parametrize('tag,value', sorted(_FORMERLY_REFUSED))
def test_formerly_refused_tags_read_like_cv2(tag, value, tmp_path):
    kw = dict(_FORMERLY_REFUSED[(tag, value)])
    rng = np.random.default_rng(tag)
    dtype = kw.pop('dtype', np.uint8)
    channels = 1 if kw.pop('grey', False) else kw.pop('channels', 3)
    img = (rng.normal(0, 1, (29, 45, channels)) if dtype != np.uint8
           else rng.integers(0, 256, (29, 45, channels))).astype(dtype)
    data = tf.tiff(img, **kw)
    _, tags = tiff.directory(data)
    assert tags[tag][0] == value
    _holds(data, tmp_path / 'x.bin')


def test_formerly_refused_containers_read_like_cv2(tmp_path):
    """A BigTIFF, a `cv2`-written colour TIFF through `tiff.imread`, and
    a grey TIFF read colour through `loading.imread`."""
    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 256, (19, 27, 3)).astype(np.uint8)
    _holds(tf.tiff(rgb, big=True), tmp_path / 'big.bin')
    colour = str(tmp_path / 'c.tiff')
    cv2.imwrite(colour, rgb)
    _same(tiff.imread(colour, device='cpu'), cv2.imread(colour, cv2.IMREAD_UNCHANGED),
          'colour')
    (tmp_path / 'g.tiff').write_bytes(tf.tiff(rgb[..., 0]))
    _same(loading.imread(str(tmp_path / 'g.tiff'), 'color', 'cpu'),
          cv2.imread(str(tmp_path / 'g.tiff')), 'grey read colour')


def test_planar_16_bit_read_unchanged_is_undefined():
    """`cv2` reads a planar 16-bit file's first plane as if it held every
    sample and leaves the rest of its buffer as it was: the port raises
    there, and reads the file colour and grey as `cv2` does."""
    img = np.random.default_rng(6).integers(0, 65536, (21, 33, 3)).astype(
        np.uint16)
    data = tf.tiff(img, planar=2, compression=5)
    with pytest.raises(ValueError, match='no answer is defined'):
        tiff.imdecode(data, 'unchanged', 'cpu')
    for flag in ('color', 'grayscale'):
        _same(tiff.imdecode(data, flag, 'cpu'), _cv2(data, flag), flag)


def test_imdecode_refuses_small_uncompressed_tiles_imread_reads(tmp_path):
    """`cv2.imdecode` returns None for uncompressed tiles whose bytes are
    not a multiple of 1024, read through libtiff's RGBA reader;
    `cv2.imread` reads them from a file, unless FillOrder 2 makes libtiff
    copy them too. The port's two entry points follow the two."""
    rgb = np.random.default_rng(7).integers(0, 256, (37, 53, 3)).astype(
        np.uint8)
    for tile, fill, reads in (((16, 16), 1, True), ((16, 48), 1, True),
                              ((16, 16), 2, False), ((32, 32), 2, True),
                              ((16, 64), 1, True)):
        data = tf.tiff(rgb, tile=tile, fill_order=fill)
        assert (_cv2(data, 'color') is None) == (tile[0] * tile[1] * 3
                                                 % 1024 != 0)
        path = tmp_path / 't.tiff'
        path.write_bytes(data)
        assert (_cv2(data, 'color', path) is not None) == reads
        _holds(data, path)
    data = tf.tiff(rgb.astype(np.uint16), tile=(16, 16))   # not the RGBA
    _same(tiff.imdecode(data, device='cpu'), _cv2(data, 'unchanged'),
          'raw route')


@pytest.mark.parametrize('name', ['rgb 8-bit LZW predictor 2 strips',
                                  'jpeg YCbCr strips',
                                  'grey 16-bit Deflate tiles',
                                  'rgb 8-bit BigTIFF',
                                  'palette 8-bit 16-bit map'])
def test_cut_files_raise(name):
    """A file cut anywhere before its end raises: libtiff's RGBA reader
    fills what it cannot decode and `cv2` may return the rest, the port
    does not follow it there."""
    data = VARIANTS[name]
    for at in (0, 3, 8, 40, len(data) // 3, len(data) // 2, len(data) - 9,
               len(data) - 2):
        with pytest.raises(ValueError):
            loading.decode(data[:at], 'color', 'cpu')


@pytest.mark.parametrize('name', ['grey 16-bit LZW predictor 2 big-endian',
                                  'bilevel 1-bit PackBits',
                                  'palette 4-bit tiles',
                                  'rgb 8-bit Deflate tiles',
                                  'rgba 8-bit unassociated',
                                  'cmyk 8-bit', 'float32 3 samples',
                                  'jpeg YCbCr strips'])
def test_one_file_of_each_family_reads_as_the_jax_loader(name, tmp_path):
    """The JAX package's `_imread` (`cv2.imread` for a TIFF; where `cv2`
    returns None it raises, as the port does)."""
    from hrfuser_tpu.data.pipelines.loading import _imread
    path = str(tmp_path / 'frame.tif')
    Path(path).write_bytes(VARIANTS[name])
    for flag in FLAGS:
        try:
            want = _imread(path, flag)
        except FileNotFoundError:
            with pytest.raises(ValueError):
                loading.imread(path, flag, 'cpu')
            continue
        _same(loading.imread(path, flag, 'cpu'), want, flag)


def test_loaders_read_tiff_frames_as_the_jax_loaders(tmp_path):
    """`LoadImageFromFile` on a TIFF camera frame, the projection loader on
    a 16-bit 3-sample TIFF, and both gated loaders on 16-bit grey TIFFs,
    against the JAX package's loaders on the same files."""
    from hrfuser_tpu.data.pipelines import loading as jax_loading
    rng = np.random.default_rng(8)
    rgb = rng.integers(0, 256, (48, 80, 3)).astype(np.uint8)
    (tmp_path / 'cam.tiff').write_bytes(tf.tiff(rgb, compression=5,
                                                predictor=2, rows=16))
    sensor = rng.integers(0, 65536, (48, 80, 3)).astype(np.uint16)
    (tmp_path / 'rih.tiff').write_bytes(tf.tiff(sensor, compression=8))
    for folder in ('gated', 'gated0_rect', 'gated1_rect', 'gated2_rect'):
        (tmp_path / folder).mkdir()
        (tmp_path / folder / 'g.tiff').write_bytes(tf.tiff(
            rng.integers(0, 1024, (48, 80)).astype(np.uint16) * 64,
            compression=5, predictor=2, rows=3))
    base = {'img_prefix': str(tmp_path), 'gated_prefix': str(tmp_path),
            'lidar_prefix': str(tmp_path),
            'img_info': {'filename': 'cam.tiff', 'gated_name': 'g.tiff'},
            'lidar_info': {'rih': {'file_name': 'rih.tiff',
                                   'pixel_scale_factor': 300.0,
                                   'shift': 2.0}}}
    steps = [(loading.LoadImageFromFile(device='cpu'),
              jax_loading.LoadImageFromFile(), 'img'),
             (loading.LoadProjectedSensorImageFile('lidar'),
              jax_loading.LoadProjectedSensorImageFile('lidar'), 'lidar_img'),
             (loading.LoadGatedImageFromFile('gated'),
              jax_loading.LoadGatedImageFromFile('gated'), 'gated_img'),
             (loading.LoadStackedGatedImageFromFile(expected_shape=(48, 80)),
              jax_loading.LoadStackedGatedImageFromFile(
                  expected_shape=(48, 80)), 'gated_img')]
    for port, ref, key in steps:
        got = port(dict(base, img_info=dict(base['img_info'])))[key]
        want = ref(dict(base, img_info=dict(base['img_info'])))[key]
        _same(np.asarray(got), np.asarray(want), key)


def test_the_decoder_is_chosen_by_the_first_bytes(tmp_path):
    """A TIFF named `.png` and a BigTIFF given to `loading.imdecode` (the
    server's camera decode) read as `cv2` reads them."""
    rgb = np.random.default_rng(9).integers(0, 256, (17, 23, 3)).astype(
        np.uint8)
    path = tmp_path / 'frame.png'
    path.write_bytes(tf.tiff(rgb, compression=5))
    _same(loading.imread(str(path), device='cpu'), cv2.imread(str(path)),
          'named .png')
    for data in (tf.tiff(rgb, big=True, order='>'), tf.tiff(rgb, big=True)):
        assert loading.image_format(data) == 'TIFF'
        _same(loading.imdecode(data, 'cpu').numpy(),
              _cv2(data, 'color'), 'imdecode')


def test_directory_parses_every_field_type():
    """Every TIFF field type of an added tag comes back, in both byte
    orders and in BigTIFF: numbers, text, bytes and rationals."""
    img = np.zeros((3, 5), np.uint8)
    extra = [(40000, 1, [1, 2, 3, 250]), (40001, 2, 'hello'),
             (40002, 3, [7, 65535]), (40003, 4, [2 ** 32 - 1]),
             (40004, 5, [1, 3, 2, 7]), (40005, 6, [-1, 5]),
             (40006, 7, [1, 2, 3, 4, 5]), (40007, 8, [-300]),
             (40008, 9, [-70000, 3]), (40009, 10, [-1, 3]),
             (40010, 11, [0.5, -2.25]), (40011, 12, [1e300]),
             (40012, 16, [2 ** 40])]
    for order in '<>':
        for big in (False, True):
            if not big:
                kinds = [e for e in extra if e[1] != 16]
            else:
                kinds = extra
            _, tags = tiff.directory(tf.tiff(img, order=order, big=big,
                                             tags=kinds))
            assert tags[40000] == [1, 2, 3, 250]
            assert tags[40001] == b'hello\0'
            assert tags[40002] == [7, 65535] and tags[40003] == [2 ** 32 - 1]
            assert tags[40004] == [(1, 3), (2, 7)]
            assert tags[40005] == [-1, 5] and tags[40006] == bytes(
                [1, 2, 3, 4, 5])
            assert tags[40007] == [-300] and tags[40008] == [-70000, 3]
            assert tags[40009] == [(-1, 3)] and tags[40010] == [0.5, -2.25]
            assert tags[40011] == [1e300]
            if big:
                assert tags[40012] == [2 ** 40]
    bad = bytearray(tf.tiff(img))
    ifd = struct.unpack('<I', bad[4:8])[0]
    bad[ifd + 4:ifd + 6] = struct.pack('<H', 99)       # the first entry's type
    with pytest.raises(ValueError, match='field type 99'):
        tiff.directory(bytes(bad))


def test_codecs_against_plain_versions():
    """PackBits against the oracle's encoder; predictor 2 at every width
    and predictor 3 against plain running sums."""
    rng = np.random.default_rng(10)
    for _ in range(50):
        raw = rng.integers(0, 3, int(rng.integers(0, 400))).astype(np.uint8)
        raw = np.repeat(raw, rng.integers(1, 300, raw.size)).tobytes()
        got = tiff_codecs.packbits_decode(tf.packbits(raw), len(raw))
        assert got.tobytes() == raw
    for dtype in ('<u1', '>u2', '<i4', '>i8', '<f4', '>f8'):
        dt = np.dtype(dtype)
        v = (rng.normal(0, 1e3, (3, 7, 2)) if dt.kind == 'f'
             else rng.integers(-100, 100, (3, 7, 2))).astype(dt)
        for predictor in ((2, 3) if dt.kind == 'f' else (2,)):
            raw = np.frombuffer(tf._raw(v.astype(dt.newbyteorder('=')),
                                        dt.itemsize * 8, dtype[0],
                                        predictor), np.uint8)
            got = tiff_codecs.predict(raw, predictor, 3, 7, 2, dt)
            _same(got, v.astype(dt.newbyteorder('=')), f'{dtype} {predictor}')
    assert tiff_rgba.orient(np.arange(6).reshape(2, 3), 6).tolist() == [
        [3, 0], [4, 1], [5, 2]]
