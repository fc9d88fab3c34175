"""The port's small raster readers equal `cv2` 5.0, chosen by the first
bytes (`data/pipelines/loading.py`).

Every variant `tests/oracles/raster_files.py` writes (PBM / PGM / PPM raw
and ASCII, 8 and 16 bits; PAM of each tuple type; PFM in both byte
orders; BMP of every depth, palette, RLE4 / RLE8 coding, bit fields,
header and row order; Sun raster of every depth and map; Radiance HDR
flat, new-style and old-style runs) reads as `cv2.imdecode` reads its
bytes and `cv2.imread` its file, in `IMREAD_COLOR`, `IMREAD_UNCHANGED`
and `IMREAD_GRAYSCALE`, bit for bit (float32 equal for PFM / HDR).
Where `cv2` returns None (the refused variants, cut files, a colour PFM
read grey through `imread`), the port raises. One file of each family
is also held to the JAX package's `_imread`. PAM's alpha tuple types
read colour or grey make `cv2` leave pixels unwritten or write past the
image (`data/pam.py`): where its answer is defined it is taken in a
child process, elsewhere the port raises.
"""

import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from hrfuser_tpu_torch.data import cvt, pam, png
from hrfuser_tpu_torch.data.pipelines import loading

sys.path.insert(0, str(Path(__file__).resolve().parent / 'oracles'))
import raster_files as rf  # noqa: E402

FLAGS = {'color': cv2.IMREAD_COLOR, 'unchanged': cv2.IMREAD_UNCHANGED,
         'grayscale': cv2.IMREAD_GRAYSCALE}
VARIANTS = rf.variants(np.random.default_rng(21))
REFUSED = rf.refused(np.random.default_rng(21))
# cv2 leaves pixels unwritten or writes past the image: test_pam_alpha
_ALPHA = ('pam grayscale_alpha', 'pam rgb_alpha')


def _cv2(data: bytes, flag: str, path=None):
    try:
        if path is None:
            return cv2.imdecode(np.frombuffer(data, np.uint8), FLAGS[flag])
        return cv2.imread(str(path), FLAGS[flag])
    except cv2.error:                      # an image size cv2 refuses
        return None


def _same(got, want, label):
    assert got.dtype == want.dtype and got.shape == want.shape, label
    np.testing.assert_array_equal(got, want, err_msg=label)


def _holds(data: bytes, flag: str, path):
    """`loading.decode` and `loading.imread` against `cv2.imdecode` and
    `cv2.imread`: equal, or both refusing."""
    path.write_bytes(data)
    for want, read in ((_cv2(data, flag), lambda: loading.decode(
            data, flag, 'cpu')), (_cv2(data, flag, path), lambda:
                                  loading.imread(str(path), flag, 'cpu'))):
        if want is None:
            with pytest.raises(ValueError):
                read()
        else:
            _same(read(), want, flag)


@pytest.mark.parametrize('name', sorted(VARIANTS))
def test_reads_like_cv2(name, tmp_path):
    for flag in FLAGS:
        if name.startswith(_ALPHA) and flag != 'unchanged':
            continue
        _holds(VARIANTS[name], flag, tmp_path / 'frame.bin')


@pytest.mark.parametrize('name', sorted(REFUSED))
def test_refuses_what_cv2_refuses(name):
    data = REFUSED[name]
    for flag in FLAGS:
        assert _cv2(data, flag) is None
        with pytest.raises(ValueError):
            loading.decode(data, flag, 'cpu')


# one variant of each family, cut short at a few places
_CUT = ['pbm raw', 'pgm ascii maxval 100', 'ppm raw 16-bit', 'pam rgb',
        'pfm colour big-endian', 'bmp 8-bit rle8', 'bmp 4-bit rle4',
        'bmp 32-bit v5 rgba masks', 'ras 8-bit colour map', 'hdr rle',
        'hdr flat']


@pytest.mark.parametrize('name', _CUT)
def test_cut_files_read_as_cv2_reads_them(name, tmp_path):
    data = VARIANTS[name]
    for at in (1, 2, 3, 11, len(data) // 3, len(data) - 2, len(data) - 1):
        for flag in FLAGS:
            _holds(data[:at], flag, tmp_path / 'cut.bin')


def test_a_colour_pfm_read_grey_and_a_grey_one_read_colour(tmp_path):
    """`cv2`'s PFM reader converts depth and never channels:
    `cv2.imdecode` hands back the file's channels, `cv2.imread` refuses
    them ("Internal imread issue"); the port's entry points do the same,
    and a camera payload must be BGR."""
    img = np.random.default_rng(0).uniform(-1, 300, (5, 7, 3)).astype(
        np.float32)
    for data, flag in ((rf.pfm(img), 'grayscale'),
                       (rf.pfm(img[..., 0]), 'color')):
        path = tmp_path / 'x.pfm'
        path.write_bytes(data)
        assert _cv2(data, flag, path) is None
        with pytest.raises(ValueError, match='cv2.imread refuses'):
            loading.imread(str(path), flag, 'cpu')
        _same(loading.decode(data, flag, 'cpu'), _cv2(data, flag), flag)
    with pytest.raises(ValueError, match='not BGR'):
        loading.imdecode(rf.pfm(img[..., 0]), 'cpu')


def test_pfm_saturates_as_cv2_does():
    """Halves round to even, values past 255 or below 0 clip, and NaN,
    infinities and values past the int32 range read 0."""
    img = np.array([[0.5, 1.5, 2.5, -0.5, 255.5, 254.5, 300., -3.],
                    [np.nan, np.inf, -np.inf, 1e30, -1e30, 2.2e9, 127.5,
                     -2.2e9]], np.float32)
    for scale in (-1.0, 1.0, -3.0):
        data = rf.pfm(img, scale)
        for flag in FLAGS:
            got = loading.decode(data, flag, 'cpu')
            want = _cv2(data, flag)
            assert got.shape == want.shape
            np.testing.assert_array_equal(got, want)


def _child_decode(data: bytes, flag: str, tmp_path):
    """`cv2.imdecode` in a child process (it may write past its image)."""
    src, out = tmp_path / 'in.pam', tmp_path / 'out.npy'
    src.write_bytes(data)
    code = (f'import cv2, numpy as np; np.save({str(out)!r}, cv2.imdecode('
            f'np.fromfile({str(src)!r}, np.uint8), {FLAGS[flag]}))')
    subprocess.run([sys.executable, '-c', code], check=False, timeout=120)
    return np.load(out)


@pytest.mark.parametrize('tupltype,bits,width,flag', [
    ('GRAYSCALE_ALPHA', 8, 53, 'grayscale'),
    ('GRAYSCALE_ALPHA', 16, 5, 'grayscale'),
    ('RGB_ALPHA', 8, 9, 'grayscale'),
    ('RGB_ALPHA', 16, 6, 'grayscale'),
    ('GRAYSCALE_ALPHA', 8, 1, 'color'),
    ('RGB_ALPHA', 16, 1, 'color')])
def test_pam_alpha_where_cv2_defines_it(tupltype, bits, width, flag,
                                        tmp_path):
    """Grey: `cv2` writes pixel x // 3's first sample at x, 3 bytes a
    source pixel, past the row (and past the image on the last row);
    colour: the first ceil(W / depth) pixels, all of a 1-pixel row."""
    depth = pam.TUPLTYPES[tupltype]
    samples = np.random.default_rng(width).integers(
        0, 1 << bits, (4, width, depth)).astype(
        np.uint8 if bits == 8 else np.uint16)
    data = rf.pam(samples, tupltype, (1 << bits) - 1)
    _same(pam.imdecode(data, flag), _child_decode(data, flag, tmp_path),
          flag)


@pytest.mark.parametrize('tupltype,width,flag', [
    ('GRAYSCALE_ALPHA', 2, 'color'), ('RGB_ALPHA', 53, 'color'),
    ('RGB_ALPHA', 53, 'grayscale'), ('RGB_ALPHA', 8, 'grayscale')])
def test_pam_alpha_where_cv2_leaves_pixels_unwritten(tupltype, width, flag):
    samples = np.zeros((3, width, pam.TUPLTYPES[tupltype]), np.uint8)
    with pytest.raises(ValueError, match='undefined'):
        loading.decode(rf.pam(samples, tupltype), flag, 'cpu')


def test_conversions_equal_cv2_over_every_triple():
    """`data/cvt.py`'s grey conversions, each where `cv2` makes it, over
    all 2^24 BGR triples: a 24-bit BMP and a PPM read grey (14-bit fixed
    point, the PPM's red first), a 32-bit v5 BMP with its bit fields
    (float32, truncated), and `cv2.cvtColor`."""
    v = np.arange(1 << 24, dtype=np.uint32)
    bgr = np.stack([v & 255, (v >> 8) & 255, v >> 16], -1).astype(
        np.uint8).reshape(4096, 4096, 3)
    want = cvt.bgr_to_grey(bgr)
    np.testing.assert_array_equal(_cv2(rf.bmp(bgr), 'grayscale'), want)
    np.testing.assert_array_equal(_cv2(rf.pnm(bgr), 'grayscale'), want)
    bgra = np.dstack([bgr, bgr[..., :1]])
    data = rf.bmp(bgra, 32, compression='bitfields', header='v5',
                  masks=(0xff0000, 0xff00, 0xff, 0xff000000))
    np.testing.assert_array_equal(_cv2(data, 'grayscale'),
                                  cvt.bgr_to_grey_float(bgr))
    np.testing.assert_array_equal(cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY),
                                  cvt.bgr_to_grey_cvtcolor(bgr))


@pytest.mark.parametrize('name', ['pbm raw', 'pgm raw 16-bit', 'ppm ascii',
                                  'pam rgb', 'pfm colour little-endian',
                                  'bmp 8-bit rle8', 'ras 24-bit', 'hdr rle'])
def test_one_file_of_each_family_reads_as_the_jax_loader(name, tmp_path):
    """The JAX package's `_imread` (its native reader first, `cv2.imread`
    for these files; where `cv2` returns None it raises, as the port
    does)."""
    from hrfuser_tpu.data.pipelines.loading import _imread
    path = str(tmp_path / 'frame.img')
    Path(path).write_bytes(VARIANTS[name])
    for flag in FLAGS:
        try:
            want = _imread(path, flag)
        except FileNotFoundError:
            with pytest.raises(ValueError):
                loading.imread(path, flag, 'cpu')
            continue
        _same(loading.imread(path, flag, 'cpu'), want, flag)


def test_the_decoder_is_chosen_by_the_first_bytes(tmp_path):
    """A PNG named `.bin`, a BMP named `.png`, a PPM and a BMP given to
    `loading.imdecode` (the server's camera decode); bytes nothing reads
    raise `UnknownImage`, naming their signature."""
    img = np.random.default_rng(2).integers(0, 256, (37, 53, 3)).astype(
        np.uint8)
    (tmp_path / 'frame.bin').write_bytes(png.imencode(img))
    (tmp_path / 'frame.png').write_bytes(rf.bmp(img))
    for name in ('frame.bin', 'frame.png'):
        path = str(tmp_path / name)
        _same(loading.imread(path, device='cpu'), cv2.imread(path), name)
        _same(loading.imread(path, device='cpu'), img, name)
    for data in (rf.pnm(img), rf.bmp(img), rf.sunras(img, 24)):
        got = loading.imdecode(data, 'cpu')
        assert isinstance(got, torch.Tensor)
        _same(got.numpy(), cv2.imdecode(np.frombuffer(data, np.uint8),
                                        cv2.IMREAD_COLOR), 'imdecode')
    assert [loading.image_format(VARIANTS[n]) for n in (
        'pbm raw', 'pam rgb', 'pfm grey big-endian', 'bmp 24-bit',
        'ras 8-bit', 'hdr flat')] == ['PNM', 'PAM', 'PFM', 'BMP',
                                      'Sun raster', 'Radiance HDR']
    for data in (b'GIF89a' + bytes(20), b'', b'P8\n1 1\n'):
        with pytest.raises(loading.UnknownImage,
                           match='unknown image signature'):
            loading.decode(data, 'color', 'cpu')
    with pytest.raises(FileNotFoundError):
        loading.imread(str(tmp_path / 'none.bmp'))
