"""The port's file loading (`data/pipelines/loading.py`, `data/jpeg.py`,
`data/png.py`) against `cv2` and the JAX package, on the CPU.

Files are written with `cv2` into a temporary folder, as the JAX data
tests write theirs. Tolerances: PNG cameras, grey gated images and
16-bit sensors bit-equal to `cv2.imread` in its three modes (a colour
PNG or a JPEG read grey too); the dequantized sensors equal
to the JAX step's (the same numpy arithmetic); JPEG bit-equal to the JAX
package's native decoder and to `cv2.imread` (`tests/test_torch_jpeg.py`
holds the decoder to both over many more files). JPEGs decode their
pixels with `device='cpu'` here (the kernel's plain twin). The
committed fixtures of `tests/data/` (what `tests/test_torch_cuda.py`
reads on the card) decode to their committed `cv2` arrays here too.
"""

import hashlib
import os.path as osp
from pathlib import Path

import cv2
import numpy as np
import pytest

from hrfuser_tpu.data import native as jax_native
from hrfuser_tpu.data.pipelines import loading as jax_loading
from hrfuser_tpu_torch.data import jpeg
from hrfuser_tpu_torch.data.pipelines import loading

DATA = Path(__file__).resolve().parent / 'data'


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp('loading')
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:45, 0:80]
    smooth = np.stack([xx * 3, yy * 5, xx + yy], -1)
    out = {}

    def write(name, arr, *params):
        path = str(root / name)
        assert cv2.imwrite(path, arr, list(params))
        out[name] = (path, arr)

    write('cam.jpg', np.clip(smooth + rng.integers(0, 30, smooth.shape), 0,
                             255).astype(np.uint8),
          cv2.IMWRITE_JPEG_QUALITY, 90)
    write('cam.png', rng.integers(0, 256, (45, 80, 3), np.uint8))
    write('cam_rgba.png', rng.integers(0, 256, (45, 80, 4), np.uint8))
    write('cam16.png', rng.integers(0, 65536, (45, 80, 3), np.uint16))
    write('grey.png', rng.integers(0, 256, (45, 80), np.uint8))
    write('grey16.png', rng.integers(0, 65536, (45, 80), np.uint16))
    # sensor projections: (v + shift) * scale as uint16, 3 channels
    for name in ('rih.png', 'riv.png', 'yzv.png'):
        raw = rng.uniform(-1, 60, (20, 40, 3)).astype(np.float32)
        write(name, ((raw + 200.0) * 100.0).astype(np.uint16))
    for folder in ('gated_acc_wraped_grey', 'gated0_rect', 'gated2_rect'):
        (root / folder / 'cam').mkdir(parents=True)
        path = str(root / folder / 'cam' / '0.png')
        cv2.imwrite(path, rng.integers(0, 256, (12, 16), np.uint8))
    return root, out


FLAGS = {'color': cv2.IMREAD_COLOR, 'unchanged': cv2.IMREAD_UNCHANGED,
         'grayscale': cv2.IMREAD_GRAYSCALE}
PNG_CASES = [(name, flag) for name in ('cam.png', 'cam_rgba.png',
                                       'cam16.png', 'grey.png', 'grey16.png')
             for flag in ('color', 'unchanged', 'grayscale')]


@pytest.mark.parametrize('name,flag', PNG_CASES)
def test_png_reads_bit_equal_to_cv2(files, name, flag):
    """Alpha kept in 'unchanged' (BGRA); a colour file read as grey with
    libpng's fixed-point weights, as cv2 asks for them."""
    path, _ = files[1][name]
    want = cv2.imread(path, FLAGS[flag])
    got = loading.imread(path, flag)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_jpeg_reads_as_the_jax_native_decoder(files):
    path, img = files[1]['cam.jpg']
    got = loading.imread(path, device='cpu')
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got, jax_native.decode_jpeg_bgr(path))
    np.testing.assert_array_equal(got, cv2.imread(path))
    grey = loading.imread(path, 'grayscale', device='cpu')
    np.testing.assert_array_equal(grey, cv2.imread(path,
                                                   cv2.IMREAD_GRAYSCALE))
    np.testing.assert_array_equal(loading.imread(path, 'unchanged',
                                                 device='cpu'), got)


def test_a_file_that_is_not_a_jpeg_raises(tmp_path):
    """The entropy decoder's errors come back through its C interface as
    an `IOError`, not a crash of the process."""
    bad = tmp_path / 'bad.jpg'
    bad.write_bytes(b'\x89PNG not a JPEG' * 8)
    with pytest.raises(IOError, match='not a JPEG'):
        jpeg.jpeg_shape(bad.read_bytes())
    with pytest.raises(IOError, match='not a JPEG'):
        loading.imread(str(bad), device='cpu')


def test_a_cached_library_that_does_not_load_is_built_again(
        files, tmp_path, monkeypatch):
    """A `build/` copied from another machine may hold a library this one
    cannot load: it is rebuilt from the source."""
    monkeypatch.setattr(jpeg, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(jpeg, '_lib', None)
    path = jpeg.build()
    path.write_bytes(b'not a shared library')
    path, img = files[1]['cam.jpg']
    np.testing.assert_array_equal(loading.imread(path, device='cpu'),
                                  jax_native.decode_jpeg_bgr(path))
    assert jpeg.build().read_bytes()[:4] == b'\x7fELF'


def test_a_library_that_neither_loads_nor_builds_raises(tmp_path,
                                                         monkeypatch):
    bad = tmp_path / 'jpeg_entropy.cpp'
    bad.write_text('int broken( {\n')
    monkeypatch.setattr(jpeg, 'SOURCE', bad)
    monkeypatch.setattr(jpeg, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(jpeg, '_lib', None)
    tag = hashlib.sha256(bad.read_bytes()).hexdigest()[:16]
    (tmp_path / 'build').mkdir()
    (tmp_path / 'build' / f'libhrfuser_jpeg_{tag}.so').write_bytes(b'x')
    with pytest.raises(RuntimeError, match='error'):
        jpeg.lib()


def test_missing_and_unknown_files_raise(files, tmp_path):
    with pytest.raises(FileNotFoundError):
        loading.imread(str(tmp_path / 'none.png'))
    with pytest.raises(IOError):
        loading.imread(str(tmp_path / 'none.jpg'), device='cpu')
    bmp = tmp_path / 'x.bmp'
    bmp.write_bytes(b'BM')
    with pytest.raises(ValueError, match='BMP: the file ends inside'):
        loading.imread(str(bmp))
    gif = tmp_path / 'x.gif'
    gif.write_bytes(b'GIF89a' + bytes(20))
    with pytest.raises(ValueError, match='unknown image signature'):
        loading.imread(str(gif))
    with pytest.raises(ValueError, match='flag'):
        loading.imread(files[1]['cam.png'][0], 'anydepth')


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / 'jpeg_entropy.cpp'
    bad.write_text('int broken( {\n')
    monkeypatch.setattr(jpeg, 'SOURCE', bad)
    monkeypatch.setattr(jpeg, 'BUILD_DIR', tmp_path / 'build')
    with pytest.raises(RuntimeError, match='error'):
        jpeg.build()
    assert not list((tmp_path / 'build').glob('*.so'))


def test_committed_fixtures_decode_as_cv2():
    want = np.load(DATA / 'decoded_cv2.npz')
    np.testing.assert_array_equal(loading.imread(str(DATA / 'camera.png')),
                                  want['camera_png'])
    np.testing.assert_array_equal(
        loading.imread(str(DATA / 'grey.png'), 'grayscale'), want['grey_png'])
    np.testing.assert_array_equal(
        loading.imread(str(DATA / 'sensor16.png'), 'unchanged'),
        want['sensor16_png'])
    np.testing.assert_array_equal(
        loading.imread(str(DATA / 'camera.jpg'), device='cpu'),
        want['camera_jpg'])


def _same(a, b, path=''):
    """Equal results dicts: arrays exactly, everything else by value."""
    assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b)), path
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _same(a[k], b[k], f'{path}.{k}')
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, np.random.Generator):
        assert a.bit_generator.state == b.bit_generator.state, path
    else:
        assert a == b, path


def _results(root, filename):
    ann = dict(bboxes=np.array([[1., 2., 30., 20.], [5., 5., 5.5, 40.],
                                [10., 3., 50., 44.]], np.float32),
               labels=np.array([0, 2, 1], np.int64),
               visibilities=np.array([4, 3, 1], np.int64))
    sensor = lambda ch, empty: {ch: dict(  # noqa: E731
        file_name=f'{ch}.png', pixel_scale_factor=100.0, shift=200.0,
        empty_channels=empty)}
    return dict(img_info=dict(filename=filename), ann_info=ann,
                img_prefix=str(root), lidar_prefix=str(root),
                radar_prefix=str(root), gated_prefix=str(root),
                lidar_info={**sensor('rih', []), **sensor('yzv', [0])},
                radar_info={**sensor('riv', [2]), **sensor('yzv', [])},
                sample_idx=3)


STEPS = {
    'camera jpg': ('LoadImageFromFile', (), 'cam.jpg'),
    'camera png': ('LoadImageFromFile', (), 'cam.png'),
    'camera png uint8': ('LoadImageFromFile', (False,), 'cam.png'),
    'lidar rih': ('LoadProjectedSensorImageFile', ('lidar', ['rih']),
                  'cam.png'),
    'lidar two groups, empty channel': (
        'LoadProjectedSensorImageFile', ('lidar', ['rih', 'yzv']), 'cam.png'),
    'radar riv, empty channel': ('LoadProjectedSensorImageFile',
                                 ('radar', ['riv']), 'cam.png'),
    'radar yzv, channel 0 deleted': (
        'LoadProjectedSensorImageFile', ('radar', ['yzv'], [0]), 'cam.png'),
    'gated': ('LoadGatedImageFromFile', (), 'cam/0.png'),
    'stacked gated, one slice missing': (
        'LoadStackedGatedImageFromFile', (None, (12, 16)), 'cam/0.png'),
    'annotations': ('LoadAnnotations', (True, True), 'cam.png'),
}


@pytest.mark.parametrize('case', sorted(STEPS))
def test_loading_steps_equal_jax(files, case):
    root = files[0]
    cls, args, filename = STEPS[case]
    if cls == 'LoadStackedGatedImageFromFile':
        args = (('gated0_rect', 'gated1_rect', 'gated2_rect'), args[1])
    port = dict(device='cpu') if cls == 'LoadImageFromFile' else {}
    got = getattr(loading, cls)(*args, **port)(_results(root, filename))
    want = getattr(jax_loading, cls)(*args)(_results(root, filename))
    _same(got, want)
    key = {'LoadImageFromFile': 'img', 'LoadGatedImageFromFile': 'gated_img',
           'LoadStackedGatedImageFromFile': 'gated_img'}.get(cls)
    if key:
        assert got[key].dtype == (np.uint8 if args == (False,)
                                   else np.float32)


@pytest.mark.parametrize('min_visibility', [None, 2])
def test_filter_annotations_equals_jax(files, min_visibility):
    def run(mod):
        r = mod.LoadAnnotations(True, True)(_results(files[0], 'cam.png'))
        return mod.FilterAnnotations((1.0, 1.0), min_visibility)(r)
    got, want = run(loading), run(jax_loading)
    _same(got, want)
    assert len(got['gt_bboxes']) == (2 if min_visibility is None else 1)


def test_sensor_values_are_dequantized(files):
    path, enc = files[1]['rih.png']
    got = loading.LoadProjectedSensorImageFile('lidar', ['rih'])(
        _results(files[0], 'cam.png'))['lidar_img']
    np.testing.assert_allclose(got, enc.astype(np.float32) / 100.0 - 200.0,
                               atol=1e-6)
    assert osp.exists(path)
