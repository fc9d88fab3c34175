"""The port's JPEG decoder (`data/jpeg.py`: the host entropy decoder
`csrc/jpeg_entropy.cpp` and the pixel kernel's plain twin) on the CPU.

Every decode is held bit-equal (`assert_array_equal`) to the JAX
package's native decoder (`hrfuser_tpu/data/native.py:decode_jpeg_bgr`,
the system's libjpeg-turbo) and to `cv2.imdecode` (its bundled
libjpeg-turbo), on `cv2`-written files over chroma sampling, quality,
size, restart intervals, optimised Huffman tables and grey, and on
streams of arbitrary seeded coefficients written by the test oracle
encoder (`tests/oracles/jpeg_encoder.py`), many of whose inverse DCTs
leave the sample range and overflow libjpeg-turbo's 16-bit SIMD lanes.
Files cut short are held to the native decoder, which decodes them with
a warning (`cv2.imdecode` refuses them). Modes the decoder refuses raise
naming the mode.
"""

import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from hrfuser_tpu.data import native as jax_native
from hrfuser_tpu_torch.data import jpeg, png
from hrfuser_tpu_torch.data.pipelines import loading

sys.path.insert(0, str(Path(__file__).resolve().parent / 'oracles'))
import jpeg_encoder as enc  # noqa: E402

SAMPLING = {'444': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            '422': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            '420': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            '440': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            '411': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
# luma's (h, v) for the oracle encoder
FACTORS = {'444': (1, 1), '422': (2, 1), '420': (2, 2), '440': (1, 2),
           '411': (4, 1)}


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _camera(hw, seed=0, grey=False):
    """Smooth content with noise, as a camera frame has."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
    base = np.stack([xx * 200 / max(hw[1], 1), yy * 200 / max(hw[0], 1),
                     (xx + yy) * 100 / max(sum(hw), 1)], -1)
    img = np.clip(base + rng.integers(0, 60, base.shape), 0,
                  255).astype(np.uint8)
    return img[..., 1] if grey else img


def _cv2_jpeg(img, *params):
    ok, buf = cv2.imencode('.jpg', img, list(params))
    assert ok
    return buf.tobytes()


def _native(data, tmp_path):
    path = tmp_path / 'native.jpg'
    path.write_bytes(data)
    return jax_native.decode_jpeg_bgr(str(path))


def _held(data, tmp_path, cv2_too=True):
    """The port's CPU decode of `data`, bit-equal to the native decoder
    (and to `cv2.imdecode`)."""
    got = jpeg.decode_jpeg(data, 'cpu')
    assert got.dtype == torch.uint8 and got.device.type == 'cpu'
    got = got.numpy()
    np.testing.assert_array_equal(got, _native(data, tmp_path))
    if cv2_too:
        np.testing.assert_array_equal(
            got, cv2.imdecode(np.frombuffer(data, np.uint8),
                              cv2.IMREAD_COLOR))
    return got


CV2_CASES = {
    **{f'{s} {h}x{w}': ((h, w), s, 75, [])
       for s in SAMPLING for h, w in ((1, 1), (7, 9), (37, 53), (48, 64))},
    **{f'420 q{q}': ((37, 53), '420', q, []) for q in (5, 50, 75, 95, 100)},
    '420 901x1601': ((901, 1601), '420', 90, []),
    '444 901x1601 q100': ((901, 1601), '444', 100, []),
    '420 restart 1': ((37, 53), '420', 90, [cv2.IMWRITE_JPEG_RST_INTERVAL,
                                             1]),
    '422 restart 3': ((48, 64), '422', 90, [cv2.IMWRITE_JPEG_RST_INTERVAL,
                                             3]),
    '420 optimised': ((37, 53), '420', 90, [cv2.IMWRITE_JPEG_OPTIMIZE, 1]),
    '444 optimised restart 2': ((37, 53), '444', 90, [
        cv2.IMWRITE_JPEG_OPTIMIZE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, 2]),
    'grey 37x53': ((37, 53), 'grey', 75, []),
    'grey 7x9 restart 1': ((7, 9), 'grey', 75, [
        cv2.IMWRITE_JPEG_RST_INTERVAL, 1]),
}


@pytest.mark.parametrize('case', sorted(CV2_CASES))
def test_cv2_files_decode_bit_equal(case, tmp_path):
    hw, sampling, quality, extra = CV2_CASES[case]
    grey = sampling == 'grey'
    img = _camera(hw, grey=grey)
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, *extra]
    if not grey:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    data = _cv2_jpeg(img, *params)
    got = _held(data, tmp_path)
    assert got.shape == (*hw, 3)
    assert jpeg.jpeg_shape(data) == (*hw, 1 if grey else 3)
    if not grey:
        h, v = FACTORS[sampling]
        assert jpeg.frame_info(data).comps[0][:2] == (h, v)


# where the cut falls, as a fraction of the entropy-coded data
CUT = (0.02, 0.3, 0.6, 0.95)


@pytest.mark.parametrize('restart', [0, 3])
@pytest.mark.parametrize('frac', CUT)
def test_cut_files_decode_as_the_native_decoder(frac, restart, tmp_path):
    """libjpeg reads a stream that stops early with a warning: the block
    where the data ran out decodes from zero bits, the rest of the image
    from zero coefficients (flat grey)."""
    params = [cv2.IMWRITE_JPEG_QUALITY, 90]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    data = _cv2_jpeg(_camera((120, 200), seed=2), *params)
    start = data.index(b'\xff\xda')
    cut = data[:start + int((len(data) - start) * frac)]
    got = _held(cut, tmp_path, cv2_too=False)
    assert (got[-1, -1] == 128).all()           # the last MCU: all zero


def test_a_cut_before_the_image_data_raises(tmp_path):
    data = _cv2_jpeg(_camera((37, 53)), cv2.IMWRITE_JPEG_QUALITY, 90)
    cut = data[:200]
    with pytest.raises(IOError):
        _native(cut, tmp_path)
    with pytest.raises(IOError, match='truncated'):
        jpeg.decode_jpeg(cut, 'cpu')


def _refused(mode):
    """A stream in a mode the decoder refuses."""
    if mode == 'progressive':
        return _cv2_jpeg(_camera((37, 53)), cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    coefs, quant = enc.image_coefficients(_camera((16, 16)), 90, (1, 1))
    ncomp = {'2-component': 2, '4-component': 4}.get(mode, 3)
    while len(coefs) < ncomp:
        coefs, quant = coefs + coefs[1:2], quant + quant[1:2]
    data = bytearray(enc.encode(coefs[:ncomp], quant[:ncomp], (16, 16),
                                [(1, 1)] * ncomp))
    sof = data.index(b'\xff\xc0')
    marker = {'lossless': 0xC3, 'arithmetic-coded': 0xC9,
              'arithmetic-coded progressive': 0xCA,
              'hierarchical': 0xC5}.get(mode)
    if marker:
        data[sof + 1] = marker
    if mode == '12-bit':
        data[sof + 4] = 12
    return bytes(data)


@pytest.mark.parametrize('mode', ['progressive', 'lossless',
                                  'arithmetic-coded',
                                  'arithmetic-coded progressive',
                                  'hierarchical', '12-bit', '2-component',
                                  '4-component'])
def test_refused_modes_raise_naming_the_mode(mode):
    data = _refused(mode)
    with pytest.raises(jpeg.JpegError, match=mode):
        jpeg.decode_jpeg(data, 'cpu')
    with pytest.raises(IOError, match=mode):
        jpeg.jpeg_shape(data)


@pytest.mark.parametrize('data', [b'', b'\x89PNG not a JPEG' * 8,
                                  b'\xff\xd8\xff\xd9',
                                  b'\xff\xd8' + bytes(range(256)) * 4])
def test_garbage_raises_ioerror(data, tmp_path):
    with pytest.raises(IOError):
        jpeg.decode_jpeg(data, 'cpu')
    if data:
        with pytest.raises(IOError):
            _native(data, tmp_path)


def _fuzz(seed, sampling, ncomp=3, qmax=255, amax=1023, dmax=1023):
    """Seeded arbitrary coefficients on each component's block grid (the
    padding blocks a one-component scan skips left zero), quantisation
    tables and sampling factors."""
    rng = np.random.default_rng(seed)
    factors = enc._sampling(ncomp, FACTORS[sampling])
    grids = enc.block_grid(HW, factors)
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    coefs = []
    for (hs, v), g in zip(factors, grids):
        c = rng.integers(-amax, amax + 1, (*g, 64))
        c *= rng.random((*g, 64)) < rng.uniform(0.05, 0.5)
        c[..., 0] = rng.integers(-dmax, dmax + 1, g)
        c[rng.random(g) < 0.25, 8:] = 0        # rows 1-7 zero: a shortcut
        c[rng.random(g) < 0.1, 1:] = 0         # DC only
        rows = -(-(-(-HW[0] * v // vmax)) // 8)
        cols = -(-(-(-HW[1] * hs // hmax)) // 8)
        c[rows:] = 0
        c[:, cols:] = 0
        coefs.append(c)
    quant = [rng.integers(1, qmax + 1, 64) for _ in range(ncomp)]
    return coefs, quant, factors


HW = (37, 53)
# name: (seed, sampling, components, quantisation and coefficient range,
#        encoder options)
FUZZ = {
    **{f'{s} wide {seed}': (seed, s, 3, (255, 1023), {})
       for seed, s in enumerate(SAMPLING)},
    **{f'{s} moderate': (10, s, 3, (16, 200), {}) for s in SAMPLING},
    '420 restart 2': (20, '420', 3, (255, 1023), dict(restart=2)),
    '422 one scan a component, restart 5': (
        21, '422', 3, (255, 1023), dict(interleaved=False, restart=5)),
    '440 16-bit tables, SOF1': (22, '440', 3, (255, 1023),
                                dict(quant16=True, sof=0xC1)),
    '444 RGB (no JFIF, ids R G B)': (23, '444', 3, (64, 400),
                                     dict(jfif=False, ids=b'RGB')),
    'grey wide': (24, '444', 1, (255, 1023), {}),
    'grey moderate, restart 1': (25, '444', 1, (16, 200), dict(restart=1)),
}


@pytest.mark.parametrize('case', sorted(FUZZ))
def test_fuzzed_coefficients_decode_as_the_native_decoder(case, tmp_path):
    seed, sampling, ncomp, (qmax, amax), opts = FUZZ[case]
    coefs, quant, factors = _fuzz(seed, sampling, ncomp, qmax, amax)
    data = enc.encode(coefs, quant, HW, factors, **opts)
    _held(data, tmp_path)


def test_16_bit_quantisation_values_wrap_as_int16(tmp_path):
    """libjpeg keeps quantisation values as int16 (ISLOW_MULT_TYPE), so a
    16-bit table's values above 32767 act as negative ones."""
    coefs, quant, factors = _fuzz(30, '420', 3, 255, 300)
    quant[0][:32] += 40000
    data = enc.encode(coefs, quant, HW, factors, quant16=True)
    _held(data, tmp_path)
    _, out = jpeg.decode_coefficients(data)
    q = out[-3 * 64:].reshape(3, 64)
    np.testing.assert_array_equal(q[0], quant[0].astype(np.uint16).view(
        np.int16))


@pytest.mark.parametrize('interleaved', [True, False])
@pytest.mark.parametrize('restart', [0, 2])
def test_entropy_decoder_returns_the_encoded_coefficients(interleaved,
                                                          restart):
    coefs, quant, factors = _fuzz(40 + restart, '420', 3, 255, 1023)
    data = enc.encode(coefs, quant, HW, factors, restart=restart,
                      interleaved=interleaved)
    frame, out = jpeg.decode_coefficients(data)
    assert frame.comps == tuple((h, v, *g) for (h, v), g in
                                zip(factors, enc.block_grid(HW, factors)))
    blocks, q = jpeg.split(torch.from_numpy(out), frame)
    for want, got in zip(coefs, blocks):
        np.testing.assert_array_equal(got.numpy(), want)
    for want, got in zip(quant, q):
        np.testing.assert_array_equal(got.numpy(), want)


def test_the_committed_fixtures_decode_as_cv2():
    """What `tests/test_torch_cuda.py` holds the kernel to on the card."""
    want = np.load(Path(__file__).resolve().parent / 'data'
                   / 'decoded_cv2.npz')
    names = [k for k in want.files if k.startswith('jpeg_')]
    assert len(names) == 7
    for name in names + ['camera_jpg']:
        path = Path(__file__).resolve().parent / 'data' / (
            name.replace('camera_jpg', 'camera') + '.jpg')
        np.testing.assert_array_equal(
            jpeg.decode_jpeg(path.read_bytes(), 'cpu').numpy(), want[name])


def test_the_wrapper_takes_the_twin_for_cpu_tensors_only():
    data = _cv2_jpeg(_camera((37, 53)), cv2.IMWRITE_JPEG_QUALITY, 90)
    frame, out = jpeg.decode_coefficients(data)
    before = jpeg.pixels.launches
    cpu = jpeg.pixels(torch.from_numpy(out), frame)
    assert jpeg.pixels.launches == before
    torch.testing.assert_close(
        cpu, jpeg.pixels_plain(torch.from_numpy(out), frame), rtol=0, atol=0)
    with pytest.raises(ValueError, match='device'):
        jpeg.pixels(torch.from_numpy(out).to('meta'), frame)


def test_imdecode_picks_the_decoder_by_the_first_bytes(tmp_path):
    img = _camera((37, 53))
    data = _cv2_jpeg(img, cv2.IMWRITE_JPEG_QUALITY, 90)
    got = loading.imdecode(data, 'cpu')
    assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), _native(data, tmp_path))
    pngb = png.imencode(img)
    np.testing.assert_array_equal(loading.imdecode(pngb, 'cpu').numpy(),
                                  img)
    with pytest.raises(ValueError, match='not a JPEG or PNG'):
        loading.imdecode(b'GIF89a' + bytes(20), 'cpu')
    with pytest.raises(ValueError, match='progressive'):
        loading.imdecode(_refused('progressive'), 'cpu')


def test_imread_reads_jpeg_on_the_given_device(tmp_path):
    img = _camera((45, 80), seed=3)
    path = tmp_path / 'cam.jpg'
    assert cv2.imwrite(str(path), img, [cv2.IMWRITE_JPEG_QUALITY, 90])
    got = loading.imread(str(path), device='cpu')
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, cv2.imread(str(path)))
    np.testing.assert_array_equal(loading.read_jpeg(path.read_bytes(), 'cpu'),
                                  got)


def _segments_without(data, marker):
    """`data` with every marker segment of type `marker` before the
    first scan taken out."""
    out, pos = bytearray(data[:2]), 2
    while data[pos + 1] != 0xDA:
        length = int.from_bytes(data[pos + 2:pos + 4], 'big')
        if data[pos + 1] != marker:
            out += data[pos:pos + 2 + length]
        pos += 2 + length
    return bytes(out + data[pos:])


def test_a_stream_without_huffman_tables_takes_the_standard_ones(tmp_path):
    """Motion-JPEG frames carry no DHT: libjpeg-turbo decodes them with
    the standard tables of Annex K.3, which `cv2` also writes."""
    data = _cv2_jpeg(_camera((37, 53)), cv2.IMWRITE_JPEG_QUALITY, 90)
    bare = _segments_without(data, 0xC4)
    assert b'\xff\xc4' not in bare[:bare.index(b'\xff\xda')]
    np.testing.assert_array_equal(_held(bare, tmp_path, cv2_too=False),
                                  _held(data, tmp_path))


@pytest.mark.parametrize('seed', range(4))
def test_damaged_files_decode_or_fail_as_the_native_decoder(seed, tmp_path):
    """A few bytes of a `cv2` file overwritten, mostly in the entropy
    data: the port refuses what the native decoder refuses and decodes
    the rest to its pixels, bit for bit."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (40, 56, 3)).astype(np.uint8)
    outcomes = []
    for _ in range(40):
        params = [cv2.IMWRITE_JPEG_QUALITY, int(rng.integers(5, 100))]
        if rng.random() < 0.5:
            params += [cv2.IMWRITE_JPEG_RST_INTERVAL,
                       int(rng.integers(1, 4))]
        data = bytearray(_cv2_jpeg(img, *params))
        sos = data.index(b'\xff\xda')
        for _ in range(int(rng.integers(1, 6))):
            lo = sos + 14 if rng.random() < 0.8 else 2
            data[int(rng.integers(lo, len(data) - 2))] = int(
                rng.integers(0, 256))
        data = bytes(data)
        try:
            want = _native(data, tmp_path)
        except IOError:
            with pytest.raises(IOError):
                jpeg.decode_jpeg(data, 'cpu')
            outcomes.append('refused')
            continue
        np.testing.assert_array_equal(jpeg.decode_jpeg(data, 'cpu').numpy(),
                                      want)
        outcomes.append('decoded')
    assert 'decoded' in outcomes
