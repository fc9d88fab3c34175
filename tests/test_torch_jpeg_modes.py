"""The port's JPEG decoder in the modes beyond baseline: progressive and
arithmetic-coded streams, libjpeg's block smoothing of incomplete
progressive files, 4-component CMYK and YCCK frames, and grey reads.

References, as the JAX package's readers use them:
  * a complete file is held bit for bit to both the JAX package's native
    decoder (`hrfuser_tpu/data/native.py:decode_jpeg_bgr`, the system's
    libjpeg-turbo 2.1) and `cv2.imdecode` (its bundled libjpeg-turbo);
  * an incomplete progressive file (cut after a scan, or inside one) is
    held to the native decoder, the JAX loader's first choice: the two
    libraries smooth such files differently, so `cv2`'s gap is printed,
    not asserted;
  * a CMYK or YCCK file, which the native decoder refuses (the JAX
    loader then falls through to `cv2`), is held to `cv2`;
  * a grey read (`IMREAD_GRAYSCALE`, `IMREAD_UNCHANGED` of a grey file)
    is held to `cv2`, which alone reads JPEG that way in the JAX package.

Files come from three writers: `cv2` (progressive with optimised
tables and long EOB runs), a transcoder compiled here against the
system's libjpeg (`tests/oracles/jpeg_transcode.c`: the coefficients of
a `cv2` baseline file rewritten progressive, arithmetic-coded or both;
CMYK and YCCK compressed from pixels; its cases skip where it does not
build), and the oracle encoder (`tests/oracles/jpeg_encoder.py`), whose
progressive, arithmetic and 4-component streams carry the coefficients
of its baseline stream and so must give the baseline's pixels.
"""

import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from hrfuser_tpu.data import native as jax_native
from hrfuser_tpu_torch.data import jpeg
from hrfuser_tpu_torch.data.pipelines import loading

sys.path.insert(0, str(Path(__file__).resolve().parent / 'oracles'))
import jpeg_encoder as enc  # noqa: E402

SAMPLING = {'444': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            '422': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            '420': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            '440': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            '411': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
FACTORS = {'444': (1, 1), '422': (2, 1), '420': (2, 2), '440': (1, 2),
           '411': (4, 1)}
TRANSCODER = Path(__file__).resolve().parent / 'oracles' / 'jpeg_transcode.c'
MODES = {'progressive': dict(progressive=True),
         'arithmetic': dict(arithmetic=True),
         'arithmetic progressive': dict(arithmetic=True, progressive=True)}
SOF = {'progressive': 0xC2, 'arithmetic': 0xC9,
       'arithmetic progressive': 0xCA}


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def transcoder(tmp_path_factory):
    """The libjpeg transcoder, built here; its cases skip without it."""
    out = tmp_path_factory.mktemp('transcoder') / 'jpeg_transcode'
    try:
        proc = subprocess.run(['cc', '-O2', str(TRANSCODER), '-o', str(out),
                               '-ljpeg'], capture_output=True, text=True)
    except FileNotFoundError:
        pytest.skip('no C compiler to build the libjpeg transcoder')
    if proc.returncode:
        pytest.skip(f'the libjpeg transcoder does not build: {proc.stderr}')

    def run(data, *args):
        proc = subprocess.run([str(out), *map(str, args)], input=data,
                              capture_output=True)
        assert proc.returncode == 0, proc.stderr
        return proc.stdout
    return run


def _camera(hw, seed=0):
    """Smooth content with noise, as a camera frame has."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
    base = np.stack([xx * 200 / max(hw[1], 1), yy * 200 / max(hw[0], 1),
                     (xx + yy) * 100 / max(sum(hw), 1)], -1)
    return np.clip(base + rng.integers(0, 60, base.shape), 0,
                   255).astype(np.uint8)


def _cv2_jpeg(img, *params):
    ok, buf = cv2.imencode('.jpg', img, list(params))
    assert ok
    return buf.tobytes()


def _native(data, tmp_path):
    path = tmp_path / 'native.jpg'
    path.write_bytes(data)
    return jax_native.decode_jpeg_bgr(str(path))


def _cv2(data, flag=cv2.IMREAD_COLOR):
    return cv2.imdecode(np.frombuffer(data, np.uint8), flag)


def _held(data, tmp_path, native=True, cv2_too=True):
    """The port's CPU decode of `data`, bit-equal to the native decoder
    and / or `cv2.imdecode`."""
    got = jpeg.decode_jpeg(data, 'cpu').numpy()
    if native:
        np.testing.assert_array_equal(got, _native(data, tmp_path))
    if cv2_too:
        np.testing.assert_array_equal(got, _cv2(data))
    return got


def _as_native(data, tmp_path):
    """The port refuses what the native decoder refuses and decodes the
    rest to its pixels."""
    try:
        want = _native(data, tmp_path)
    except IOError:
        with pytest.raises(IOError):
            jpeg.decode_jpeg(data, 'cpu')
        return 'refused'
    np.testing.assert_array_equal(jpeg.decode_jpeg(data, 'cpu').numpy(),
                                  want)
    return 'decoded'


def _sof(data):
    """The frame marker's code."""
    for i in range(2, len(data) - 1):
        if data[i] == 0xFF and 0xC0 <= data[i + 1] <= 0xCF and \
                data[i + 1] not in (0xC4, 0xC8, 0xCC):
            return data[i + 1]
    raise AssertionError('no frame header')


def _scan_starts(data):
    """Offsets of the SOS markers."""
    out, i = [], data.find(b'\xff\xda')
    while i >= 0:
        out.append(i)
        i = data.find(b'\xff\xda', i + 2)
    return out


# -- cv2's own progressive files ----------------------------------------------

CV2_PROGRESSIVE = {
    **{f'{s} {h}x{w}': ((h, w), s, 75, []) for s in SAMPLING
       for h, w in ((7, 9), (37, 53))},
    '420 48x64 optimised': ((48, 64), '420', 90, [
        cv2.IMWRITE_JPEG_OPTIMIZE, 1]),
    '420 restart 1': ((37, 53), '420', 90, [cv2.IMWRITE_JPEG_RST_INTERVAL,
                                             1]),
    '422 restart 3': ((48, 64), '422', 90, [cv2.IMWRITE_JPEG_RST_INTERVAL,
                                             3]),
    'grey 37x53': ((37, 53), 'grey', 75, []),
    '420 901x1601': ((901, 1601), '420', 90, []),
}


@pytest.mark.parametrize('case', sorted(CV2_PROGRESSIVE))
def test_cv2_progressive_files_decode_bit_equal(case, tmp_path):
    hw, sampling, quality, extra = CV2_PROGRESSIVE[case]
    grey = sampling == 'grey'
    img = _camera(hw)
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_PROGRESSIVE, 1, *extra]
    if grey:
        img = img[..., 1]
    else:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    data = _cv2_jpeg(img, *params)
    assert _sof(data) == 0xC2
    assert _held(data, tmp_path).shape == (*hw, 3)


# -- libjpeg transcodes: the same coefficients, other codings -----------------

@pytest.mark.parametrize('restart', [0, 1, 3])
@pytest.mark.parametrize('sampling', sorted(SAMPLING))
@pytest.mark.parametrize('mode', sorted(MODES))
def test_libjpeg_transcodes_decode_as_their_baseline(mode, sampling, restart,
                                                     transcoder, tmp_path):
    img = _camera((37, 53), seed=1)
    base = _cv2_jpeg(img, cv2.IMWRITE_JPEG_QUALITY, 90,
                     cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling])
    args = {'progressive': 'progressive', 'arithmetic': 'arith',
            'arithmetic progressive': 'arith-progressive'}[mode]
    data = transcoder(base, args, restart)
    assert _sof(data) == SOF[mode]
    np.testing.assert_array_equal(_held(data, tmp_path),
                                  _held(base, tmp_path))
    _, got = jpeg.decode_coefficients(data)
    np.testing.assert_array_equal(got, jpeg.decode_coefficients(base)[1])


@pytest.mark.parametrize('mode', sorted(MODES))
def test_a_901x1601_transcode_decodes_bit_equal(mode, transcoder, tmp_path):
    base = _cv2_jpeg(_camera((901, 1601), seed=5), cv2.IMWRITE_JPEG_QUALITY,
                     90)
    args = {'progressive': 'progressive', 'arithmetic': 'arith',
            'arithmetic progressive': 'arith-progressive'}[mode]
    data = transcoder(base, args, 7)
    np.testing.assert_array_equal(_held(data, tmp_path), _cv2(base))


# -- the oracle encoder's streams ------------------------------------------

HW = (37, 53)
ORACLE = {
    **{f'{m} {s}': (m, s, {}) for m in MODES for s in FACTORS},
    'progressive one DC scan a component, restart 2': (
        'progressive', '420', dict(interleaved=False, restart=2)),
    'progressive restart 1': ('progressive', '422', dict(restart=1)),
    'progressive restart 3': ('progressive', '411', dict(restart=3)),
    'arithmetic restart 1': ('arithmetic', '420', dict(restart=1)),
    'arithmetic restart 3': ('arithmetic', '444', dict(restart=3)),
    'arithmetic progressive restart 3': ('arithmetic progressive', '420',
                                         dict(restart=3)),
    'arithmetic conditioning DAC': ('arithmetic', '420', dict(
        dac={0: (2, 5), 1: (0, 3), 16: 2, 17: 12})),
    'arithmetic progressive conditioning DAC': (
        'arithmetic progressive', '422', dict(dac={0: (1, 1), 1: (3, 9),
                                                   16: 1, 17: 30})),
}


@pytest.mark.parametrize('case', sorted(ORACLE))
def test_oracle_streams_decode_as_their_baseline(case, tmp_path):
    """The oracle writes the coefficients of its baseline stream in the
    mode: every reader gives the baseline's pixels, and the entropy
    decoder the very coefficients."""
    mode, sampling, opts = ORACLE[case]
    factors = FACTORS[sampling]
    coefs, quant = enc.image_coefficients(_camera(HW, seed=2), 90, factors)
    data = enc.encode(coefs, quant, HW, factors, **MODES[mode], **opts)
    base = enc.encode(coefs, quant, HW, factors)
    assert _sof(data) == SOF[mode]
    np.testing.assert_array_equal(_held(data, tmp_path), _cv2(base))
    frame, out = jpeg.decode_coefficients(data)
    blocks, _ = jpeg.split(torch.from_numpy(out), frame)
    for i, (want, got) in enumerate(zip(coefs, blocks)):
        # the blocks that hold image samples: a progressive AC scan codes
        # no MCU padding
        rows, cols = (-(-n // 8) for n in frame.sampled(i))
        np.testing.assert_array_equal(got.numpy()[:rows, :cols],
                                      want[:rows, :cols])


@pytest.mark.parametrize('mode', ['baseline', *sorted(MODES)])
def test_oracle_grey_streams_decode_bit_equal(mode, tmp_path):
    coefs, quant = enc.image_coefficients(_camera(HW, seed=3)[..., 0], 75)
    data = enc.encode(coefs, quant, HW, restart=2, **MODES.get(mode, {}))
    got = _held(data, tmp_path)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data, 'cpu', grey=True),
                                  got[..., 0])


# -- four components -------------------------------------------------------

def _cmyk(hw, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
    base = np.stack([xx * 255 / max(hw[1], 1), yy * 255 / max(hw[0], 1),
                     (xx + yy) * 128 / max(sum(hw), 1),
                     255 - xx * 255 / max(hw[1], 1)], -1)
    return np.clip(base + rng.integers(-30, 30, base.shape), 0,
                   255).astype(np.uint8)


@pytest.mark.parametrize('mode', ['baseline', *sorted(MODES)])
@pytest.mark.parametrize('space', ['CMYK', 'YCCK'])
@pytest.mark.parametrize('sampling', ['444', '420'])
def test_oracle_cmyk_and_ycck_decode_as_cv2(space, mode, sampling, tmp_path):
    """cv2 reads 4-component files (libjpeg's YCCK -> CMYK, then its own
    CMYK -> BGR); the native decoder refuses them, so the JAX loader's
    answer is cv2's."""
    factors = FACTORS[sampling]
    ycck = space == 'YCCK'
    coefs, quant = enc.image_coefficients(_cmyk(HW), 90, factors, ycck=ycck)
    data = enc.encode(coefs, quant, HW, factors, jfif=False,
                      adobe=2 if ycck else 0, restart=3,
                      **MODES.get(mode, {}))
    base = enc.encode(coefs, quant, HW, factors, jfif=False,
                      adobe=2 if ycck else 0)
    assert jpeg.frame_info(data).colour == (jpeg.YCCK if ycck else jpeg.CMYK)
    assert jpeg.jpeg_shape(data) == (*HW, 4)
    with pytest.raises(IOError):
        _native(data, tmp_path)
    got = _held(data, tmp_path, native=False)
    np.testing.assert_array_equal(got, _cv2(base))
    np.testing.assert_array_equal(jpeg.decode_jpeg(data, 'cpu', grey=True),
                                  _cv2(data, cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize('space', ['cmyk', 'ycck'])
def test_libjpeg_cmyk_and_ycck_decode_as_cv2(space, transcoder, tmp_path):
    """libjpeg's own 4-component files (Adobe marker, its sampling: YCCK
    takes Y and K at 2x2) in each coding."""
    hw = (45, 61)
    data = transcoder(_cmyk(hw, 4).tobytes(), space, hw[1], hw[0], 90)
    assert jpeg.frame_info(data).colour == (jpeg.YCCK if space == 'ycck'
                                            else jpeg.CMYK)
    want = _cv2(data)
    for coded in (data, transcoder(data, 'progressive'),
                  transcoder(data, 'arith', 2),
                  transcoder(data, 'arith-progressive')):
        np.testing.assert_array_equal(_held(coded, tmp_path, native=False),
                                      want)
        np.testing.assert_array_equal(
            jpeg.decode_jpeg(coded, 'cpu', grey=True),
            _cv2(coded, cv2.IMREAD_GRAYSCALE))


# -- incomplete progressive files: block smoothing ---------------------------

def _progressive_files(transcoder, hw, sampling, seed):
    img = _camera(hw, seed)
    params = [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
              SAMPLING[sampling]]
    base = _cv2_jpeg(img, *params)
    return {'cv2': _cv2_jpeg(img, *params, cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
            'libjpeg': transcoder(base, 'progressive'),
            'libjpeg restart 2': transcoder(base, 'progressive', 2),
            'libjpeg arithmetic': transcoder(base, 'arith-progressive')}


@pytest.mark.parametrize('sampling', sorted(SAMPLING))
def test_files_cut_after_each_scan_smooth_as_the_native_decoder(
        sampling, transcoder, tmp_path):
    """A progressive file cut after scan k (an EOI added) leaves
    coefficients 1-9 imprecise: libjpeg estimates them from the DC
    values around each block (and the DC too while no AC data has come).
    cv2's libjpeg-turbo smooths differently; its gap is printed."""
    gaps = []
    for name, data in _progressive_files(transcoder, (48, 64), sampling,
                                         7).items():
        starts = _scan_starts(data)
        for k in range(1, len(starts)):
            cut = data[:starts[k]] + b'\xff\xd9'
            got = _held(cut, tmp_path, cv2_too=False)
            gap = np.abs(got.astype(int) - _cv2(cut).astype(int))
            gaps.append(f'{name} after scan {k}: {(gap > 0).mean():.1%} '
                        f'differ, up to {gap.max()}')
        np.testing.assert_array_equal(_held(data, tmp_path),
                                      _cv2(data))      # complete: no gap
    print('cv2 vs the native decoder on cut files: ' + '; '.join(gaps))


@pytest.mark.parametrize('frac', [0.2, 0.5, 0.8])
@pytest.mark.parametrize('sampling', ['420', '444', '411'])
def test_files_cut_inside_a_scan_decode_as_the_native_decoder(
        sampling, frac, transcoder, tmp_path):
    """Cut inside scan k: the rows the scan reached take its smoothing
    parameters, the rest those of the scans before it; blocks after the
    cut keep what earlier scans gave them."""
    files = _progressive_files(transcoder, (64, 96), sampling, 8)
    outcomes = []
    for data in files.values():
        starts = _scan_starts(data) + [len(data)]
        for k in range(len(starts) - 1):
            cut = data[:starts[k] + int((starts[k + 1] - starts[k]) * frac)]
            outcomes.append(_as_native(cut, tmp_path))
    assert outcomes.count('decoded') > len(outcomes) // 2


def test_smoothing_estimates_coefficients_1_to_9_only(transcoder):
    """Smoothing changes only coefficients left imprecise: a complete
    file's are its baseline sibling's; a file cut after its DC scan gets
    estimates at zigzag 1-9 (no AC data was sent) and nothing beyond."""
    base = _cv2_jpeg(_camera((37, 53), 9), cv2.IMWRITE_JPEG_QUALITY, 90)
    data = transcoder(base, 'progressive')
    np.testing.assert_array_equal(jpeg.decode_coefficients(data)[1],
                                  jpeg.decode_coefficients(base)[1])
    cut = data[:_scan_starts(data)[1]] + b'\xff\xd9'
    frame, out = jpeg.decode_coefficients(cut)
    blocks, _ = jpeg.split(torch.from_numpy(out), frame)
    zigzag = torch.as_tensor(jpeg.ZIGZAG)
    for b in blocks:
        zz = b[..., zigzag]
        assert (zz[..., 1:10] != 0).any()
        assert not (zz[..., 10:] != 0).any()


# -- damaged streams ---------------------------------------------------------

@pytest.mark.parametrize('mode', sorted(MODES))
@pytest.mark.parametrize('seed', range(2))
def test_damaged_files_decode_or_fail_as_the_native_decoder(
        mode, seed, transcoder, tmp_path):
    """A few bytes of a transcoded file overwritten, mostly in the
    entropy data: the port refuses what the native decoder refuses and
    decodes the rest to its pixels, bit for bit."""
    rng = np.random.default_rng(seed + 10 * len(mode))
    img = rng.integers(0, 256, (40, 56, 3)).astype(np.uint8)
    args = {'progressive': 'progressive', 'arithmetic': 'arith',
            'arithmetic progressive': 'arith-progressive'}[mode]
    outcomes = []
    for _ in range(30):
        base = _cv2_jpeg(img, cv2.IMWRITE_JPEG_QUALITY,
                         int(rng.integers(5, 100)))
        restart = int(rng.integers(1, 4)) if rng.random() < 0.5 else 0
        data = bytearray(transcoder(base, args, restart))
        sos = data.index(b'\xff\xda')
        for _ in range(int(rng.integers(1, 6))):
            lo = sos + 14 if rng.random() < 0.8 else 2
            data[int(rng.integers(lo, len(data) - 2))] = int(
                rng.integers(0, 256))
        outcomes.append(_as_native(bytes(data), tmp_path))
    assert 'decoded' in outcomes


@pytest.mark.parametrize('mode', ['arithmetic', 'arithmetic progressive'])
def test_arithmetic_streams_cut_short_decode_as_the_native_decoder(
        mode, tmp_path):
    """After its data the arithmetic decoder reads zero bytes (it does
    not stop); an overflow ends the restart interval's coefficients."""
    factors = (2, 2)
    coefs, quant = enc.image_coefficients(_camera((48, 64), 11), 90, factors)
    data = enc.encode(coefs, quant, (48, 64), factors, restart=2,
                      **MODES[mode])
    start = _scan_starts(data)[0]
    for frac in (0.1, 0.4, 0.7, 0.95):
        _held(data[:start + int((len(data) - start) * frac)], tmp_path,
              cv2_too=False)


# -- grey reads and the loader's modes ----------------------------------------

@pytest.mark.parametrize('kind', ['YCbCr 420', 'YCbCr 444', 'grey', 'RGB',
                                  'RGB subsampled', 'YCbCr luma 1x1'])
def test_grey_reads_as_cv2(kind, tmp_path):
    """`IMREAD_GRAYSCALE`: the luma of a YCbCr or grey file (its chroma is
    not decoded), `rgb_gray_convert` of an RGB one; `IMREAD_UNCHANGED`
    reads a grey file grey and the rest as BGR."""
    img = _camera((37, 53), seed=12)
    if kind.startswith('YCbCr 4'):
        data = _cv2_jpeg(img, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                         SAMPLING[kind[-3:]])
    elif kind == 'grey':
        data = _cv2_jpeg(img[..., 0])
    else:
        factors = {'RGB': [(1, 1)] * 3,
                   'RGB subsampled': [(2, 2), (1, 1), (1, 1)],
                   'YCbCr luma 1x1': [(1, 1), (2, 2), (1, 1)]}[kind]
        coefs, quant = enc.image_coefficients(img, 90, factors)
        rgb = kind.startswith('RGB')
        data = enc.encode(coefs, quant, (37, 53), factors, jfif=not rgb,
                          ids=b'RGB' if rgb else None)
    grey = jpeg.decode_jpeg(data, 'cpu', grey=True).numpy()
    np.testing.assert_array_equal(grey, _cv2(data, cv2.IMREAD_GRAYSCALE))
    path = tmp_path / 'x.jpg'
    path.write_bytes(data)
    np.testing.assert_array_equal(loading.imread(str(path), 'grayscale',
                                                 'cpu'), grey)
    unchanged = loading.imread(str(path), 'unchanged', 'cpu')
    np.testing.assert_array_equal(unchanged,
                                  _cv2(data, cv2.IMREAD_UNCHANGED))
    np.testing.assert_array_equal(loading.decode(data, 'grayscale', 'cpu'),
                                  grey)


def test_the_grey_twin_decodes_luma_alone():
    """A grey read of a YCbCr file needs no chroma: the twin gives the
    same luma with the chroma blocks zeroed."""
    data = _cv2_jpeg(_camera((37, 53), 13), cv2.IMWRITE_JPEG_QUALITY, 90)
    frame, out = jpeg.decode_coefficients(data)
    coefs = torch.from_numpy(out)
    bare = coefs.clone()
    blocks, _ = jpeg.split(bare, frame)
    for b in blocks[1:]:
        b.zero_()
    before = jpeg.pixels.launches
    torch.testing.assert_close(jpeg.pixels(coefs, frame, grey=True),
                               jpeg.pixels_plain(bare, frame, grey=True),
                               rtol=0, atol=0)
    assert jpeg.pixels.launches == before
    with pytest.raises(ValueError, match='device'):
        jpeg.pixels(coefs.to('meta'), frame, grey=True)


@pytest.mark.parametrize('mode', sorted(MODES))
def test_loading_routes_every_mode(mode, tmp_path):
    """`imread`, `decode` and `imdecode` read each coding as `cv2` does."""
    coefs, quant = enc.image_coefficients(_camera((37, 53), 14), 90, (2, 2))
    data = enc.encode(coefs, quant, (37, 53), (2, 2), **MODES[mode])
    path = tmp_path / 'x.jpeg'
    path.write_bytes(data)
    want = _cv2(data)
    np.testing.assert_array_equal(loading.imread(str(path), device='cpu'),
                                  want)
    np.testing.assert_array_equal(loading.decode(data, 'color', 'cpu'), want)
    np.testing.assert_array_equal(loading.imdecode(data, 'cpu').numpy(), want)
    np.testing.assert_array_equal(
        loading.decode(data, 'unchanged', 'cpu'),
        _cv2(data, cv2.IMREAD_UNCHANGED))
