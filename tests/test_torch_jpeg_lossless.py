"""Lossless JPEG (SOF3) in the port, held to `cv2` on the CPU.

The JAX package reads a lossless frame through `cv2` only: its loader's
native reader (the system's libjpeg-turbo 2.1) refuses SOF3 and
`hrfuser_tpu/data/pipelines/loading.py:_imread` falls through to
`cv2.imread`; its server decodes payloads with `cv2.imdecode`
(`tools/serve.py`). `cv2` bundles libjpeg-turbo 3, whose lossless decoder
converts no colour, so what it returns depends on the frame and the read
mode. Every row of that chart is a case here, written by the test oracle
(`tests/oracles/jpeg_encoder.py:encode_lossless`), and each decodes in
the port (`data/jpeg.py`: `csrc/jpeg_entropy.cpp` rebuilds the samples,
the pixel kernel's plain twin converts them) bit-equal to `cv2.imdecode`
in its three modes, or raises `JpegError` where `cv2` returns None:

  * 1 component, precision 2-8, predictors 1-7, point transform Pt:
    read grey and unchanged (the samples << Pt), refused in colour;
  * 3 components with no marker, ids 1-3, 'RGB' or any others, or an
    Adobe transform 0: RGB, read as BGR in colour and unchanged, refused
    grey; with JFIF or another Adobe transform (YCbCr): refused;
  * 4 components: CMYK, read in all three modes (`cv2`'s own CMYK
    conversion); with an Adobe transform other than 0 (YCCK): refused;
  * 2 components, precision 1 or above 8, a restart interval that is not
    whole MCU rows, invalid scan parameters, no Huffman table, and the
    arithmetic-coded lossless frame (SOF11): refused.

Sampling factors other than 1x1 read as `cv2` reads them (samples
repeated: libjpeg does no fancy upsampling in lossless mode), as do
non-interleaved scans, restart intervals, and differences of any value
(category 16, sums that wrap at 16 bits, samples kept to 8 bits after the
shift). Files are held to the JAX `_imread`, and `LoadImageFromFile` to
the JAX step. Cut files read as `cv2.imread` reads them (its source
supplies an EOI and the decoder goes on from zero bits); `cv2.imdecode`
refuses any stream without its EOI, and the port reads a payload as it
reads a file, so cut payloads are held here with their EOI kept.
"""

import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from hrfuser_tpu.data.pipelines import loading as jax_loading
from hrfuser_tpu_torch.data import jpeg
from hrfuser_tpu_torch.data.pipelines import loading

sys.path.insert(0, str(Path(__file__).resolve().parent / 'oracles'))
import jpeg_encoder as enc  # noqa: E402

H, W = 37, 53
MODES = {'color': cv2.IMREAD_COLOR, 'unchanged': cv2.IMREAD_UNCHANGED,
         'grayscale': cv2.IMREAD_GRAYSCALE}
_RNG = np.random.default_rng(20)
IMG = _RNG.integers(0, 256, (H, W, 4)).astype(np.uint8)
GREY, RGB = IMG[..., 0], IMG[..., :3]


def _fuzz(ncomp, shape=(H, W)):
    """Differences of any value a stream carries, 32768 (category 16) and
    -32767 among them."""
    rng = np.random.default_rng(ncomp)
    out = []
    for _ in range(ncomp):
        d = rng.integers(-32767, 32769, shape)
        d[0, 3], d[2, 2] = 32768, -32767
        out.append(d)
    return out


def _bad_scan(ss, se, ah, al):
    data = bytearray(enc.encode_lossless(GREY))
    at = data.index(b'\xff\xda') + 7
    data[at:at + 3] = bytes([ss, se, ah * 16 + al])
    return bytes(data)


def _arithmetic():
    """A SOF11 stream: a constant image at the initial predictor, so every
    difference is 0, one QM-coded decision in the first bin."""
    const = np.full((H, W), 128, np.uint8)
    head = enc.encode_lossless(const, sof=0xCB, dht=False)
    head = head[:head.index(b'\xff\xda') + 10]
    return head + enc.qm_encode([0] * (H * W)) + b'\xff\xd9'


# name -> the stream (each a row of the chart in the module docstring)
CASES = {
    **{f'grey predictor {p}': (lambda p=p: enc.encode_lossless(
        GREY, predictor=p)) for p in range(1, 8)},
    'grey Pt 1': lambda: enc.encode_lossless(GREY, predictor=4, pt=1),
    'grey Pt 3': lambda: enc.encode_lossless(GREY, predictor=7, pt=3),
    'grey Pt 7': lambda: enc.encode_lossless(GREY, predictor=5, pt=7),
    'grey precision 7': lambda: enc.encode_lossless(GREY >> 1, precision=7,
                                                    predictor=5),
    'grey precision 2 Pt 1': lambda: enc.encode_lossless(
        GREY >> 6, precision=2, predictor=6, pt=1),
    'grey restart 3 rows': lambda: enc.encode_lossless(
        GREY, predictor=2, restart=3 * W),
    'grey factors 1x2 restart 3 rows': lambda: enc.encode_lossless(
        GREY, predictor=4, sampling=[(1, 2)], restart=3 * W),
    'grey factors 2x2': lambda: enc.encode_lossless(GREY, predictor=3,
                                                    sampling=[(2, 2)]),
    'grey differences fuzzed': lambda: enc.encode_lossless(
        np.zeros((H, W), np.uint8), predictor=5, pt=2, diffs=_fuzz(1)),
    'rgb ids 1-3': lambda: enc.encode_lossless(RGB[..., ::-1], predictor=7),
    'rgb ids RGB': lambda: enc.encode_lossless(RGB, predictor=1,
                                               ids=b'RGB'),
    'rgb ids 5-7': lambda: enc.encode_lossless(RGB, predictor=6,
                                               ids=[5, 6, 7]),
    'rgb adobe 0': lambda: enc.encode_lossless(RGB, predictor=4,
                                               marker='adobe0'),
    'rgb restart 5 rows': lambda: enc.encode_lossless(
        RGB, predictor=5, restart=5 * W),
    'rgb non-interleaved restart': lambda: enc.encode_lossless(
        RGB, predictor=3, interleaved=False, restart=2 * W),
    'rgb first 2x2': lambda: enc.encode_lossless(
        RGB, predictor=6, sampling=[(2, 2), (1, 1), (1, 1)]),
    'rgb mixed factors': lambda: enc.encode_lossless(
        RGB, predictor=7, sampling=[(2, 2), (1, 2), (2, 1)], restart=27),
    'rgb mixed factors non-interleaved': lambda: enc.encode_lossless(
        RGB, predictor=2, sampling=[(1, 1), (2, 2), (2, 2)],
        interleaved=False),
    'rgb differences fuzzed': lambda: enc.encode_lossless(
        np.zeros((H, W, 3), np.uint8), predictor=4, pt=1, diffs=_fuzz(3)),
    'cmyk': lambda: enc.encode_lossless(IMG, predictor=7, restart=2 * W),
    'cmyk adobe 0': lambda: enc.encode_lossless(IMG, predictor=1,
                                                marker='adobe0'),
    # refused by cv2 in every mode
    'rgb jfif': lambda: enc.encode_lossless(RGB, marker='jfif'),
    'rgb adobe 1': lambda: enc.encode_lossless(RGB, marker='adobe1'),
    'rgb adobe 2': lambda: enc.encode_lossless(RGB, marker='adobe2'),
    'ycck adobe 2': lambda: enc.encode_lossless(IMG, marker='adobe2'),
    '2 components': lambda: enc.encode_lossless(IMG[..., :2]),
    'precision 1': lambda: enc.encode_lossless(GREY >> 7, precision=1),
    'precision 12': lambda: enc.encode_lossless(GREY.astype(int) << 4,
                                                precision=12),
    'precision 16': lambda: enc.encode_lossless(GREY.astype(int) << 8,
                                                precision=16),
    'restart not whole rows': lambda: enc.encode_lossless(GREY, restart=5),
    'no Huffman table': lambda: enc.encode_lossless(
        GREY >> 4, table=enc.DC_LUMA, dht=False),
    'predictor 0': lambda: _bad_scan(0, 0, 0, 0),
    'predictor 8': lambda: _bad_scan(8, 0, 0, 0),
    'Se 1': lambda: _bad_scan(1, 1, 0, 0),
    'Ah 1': lambda: _bad_scan(1, 0, 1, 0),
    'Pt 8 at precision 8': lambda: _bad_scan(1, 0, 0, 8),
    'arithmetic-coded (SOF11)': _arithmetic,
}


def _cv2(data, mode):
    return cv2.imdecode(np.frombuffer(data, np.uint8), MODES[mode])


def _port(read, *args):
    """The port's result, or the error it raised (None if it is a
    `JpegError`, as `cv2` answers None)."""
    try:
        return read(*args)
    except jpeg.JpegError:
        return None


def _same(got, want):
    if want is None or got is None:
        return got is None and want is None
    return got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize('name', sorted(CASES))
def test_reads_as_cv2_imdecode_in_its_three_modes(name):
    data = CASES[name]()
    read = [m for m in MODES if _cv2(data, m) is not None]
    for mode in MODES:
        want = _cv2(data, mode)
        got = _port(loading.decode, data, mode, 'cpu')
        assert _same(got, want), (mode, None if got is None else got.shape,
                                  None if want is None else want.shape)
    # the chart: what cv2 reads of each kind of frame
    if name.startswith('grey'):
        assert read == ['unchanged', 'grayscale']
    elif name.startswith('rgb') and 'adobe 1' not in name \
            and 'adobe 2' not in name and 'jfif' not in name:
        assert read == ['color', 'unchanged']
    elif name.startswith('cmyk'):
        assert read == list(MODES)
    else:
        assert read == []


def test_samples_are_the_image_shifted_by_pt():
    """A frame's samples come back exactly, point transform applied; a
    colour frame stored R, G, B comes back BGR."""
    for pt in (0, 2):
        got = jpeg.decode_jpeg(enc.encode_lossless(GREY, predictor=7, pt=pt),
                               'cpu', grey=True)
        np.testing.assert_array_equal(got.numpy(), (GREY >> pt) << pt)
    got = jpeg.decode_jpeg(enc.encode_lossless(RGB[..., ::-1]), 'cpu')
    np.testing.assert_array_equal(got.numpy(), RGB)


def test_frame_reports_the_lossless_case():
    frame = jpeg.frame_info(enc.encode_lossless(GREY >> 2, precision=6,
                                                pt=3, predictor=2))
    assert frame.lossless and (frame.precision, frame.pt) == (6, 3)
    assert frame.comps == ((1, 1, 5, 7),)         # 8x8 tiles of 37x53
    frame = jpeg.frame_info(enc.encode_lossless(
        IMG, sampling=[(2, 2), (1, 1), (1, 1), (2, 2)]))
    assert frame.colour == jpeg.CMYK and frame.comps == ((1, 1, 5, 7),) * 4
    assert jpeg.jpeg_shape(enc.encode_lossless(RGB)) == (H, W, 3)
    base = jpeg.frame_info(enc.encode(*enc.image_coefficients(RGB, 90),
                                      (H, W)))
    assert not base.lossless and (base.precision, base.pt) == (8, 0)


def test_each_half_refuses_the_other_kind_of_frame():
    with pytest.raises(jpeg.JpegError, match='samples'):
        jpeg.decode_coefficients(enc.encode_lossless(RGB))
    with pytest.raises(jpeg.JpegError, match='not a lossless frame'):
        jpeg.decode_samples(enc.encode(*enc.image_coefficients(RGB, 90),
                                       (H, W)))


@pytest.mark.parametrize('grey,data', [
    (False, enc.encode_lossless(RGB, predictor=3)),
    (False, enc.encode_lossless(IMG, predictor=6)),
    (True, enc.encode_lossless(IMG, predictor=6)),
    (True, enc.encode_lossless(GREY, predictor=1))])
def test_colour_step_on_a_cpu_tensor_is_its_twin(grey, data):
    frame, planes = jpeg.decode_samples(data)
    t = torch.from_numpy(planes)
    assert torch.equal(jpeg.lossless_pixels(t, frame, grey),
                       jpeg.lossless_pixels_plain(t, frame, grey))


FILE_CASES = ['grey predictor 4', 'grey Pt 3', 'rgb ids 1-3',
              'rgb first 2x2', 'cmyk', 'rgb jfif', '2 components']


@pytest.mark.parametrize('name', FILE_CASES)
def test_files_read_as_the_jax_loader_reads_them(name, tmp_path):
    """`loading.imread` equals the JAX `_imread` (its native reader
    refuses SOF3, then `cv2.imread`) in the three modes; both raise where
    `cv2` reads nothing."""
    path = str(tmp_path / 'x.jpg')
    with open(path, 'wb') as f:
        f.write(CASES[name]())
    for mode in MODES:
        try:
            want = jax_loading._imread(path, mode)
        except FileNotFoundError:
            want = None
        assert _same(_port(loading.imread, path, mode, 'cpu'), want), mode


def test_load_image_from_file_reads_a_lossless_camera(tmp_path):
    """The camera step reads a lossless RGB frame as the JAX step does."""
    from hrfuser_tpu.data.pipelines.loading import \
        LoadImageFromFile as JaxLoad
    cam = np.random.default_rng(5).integers(0, 256, (48, 80, 3)).astype(
        np.uint8)
    (tmp_path / 'cam.jpg').write_bytes(enc.encode_lossless(
        cam[..., ::-1], predictor=7, restart=80 * 4))
    results = {'img_prefix': str(tmp_path),
               'img_info': {'filename': 'cam.jpg'}}
    got = loading.LoadImageFromFile(device='cpu')(dict(results))
    want = JaxLoad()(dict(results))
    assert got['img'].dtype == want['img'].dtype == np.float32
    np.testing.assert_array_equal(got['img'], want['img'])
    np.testing.assert_array_equal(got['img'], cam)
    assert got['img_shape'] == want['img_shape']


def _sos_end(data):
    at = data.index(b'\xff\xda')
    return at + 2 + int.from_bytes(data[at + 2:at + 4], 'big')


DAMAGED = {
    'grey': lambda: enc.encode_lossless(GREY, predictor=4, pt=1),
    'rgb restart': lambda: enc.encode_lossless(RGB, predictor=7,
                                               restart=2 * W),
    'grey factors 1x2 restart': lambda: enc.encode_lossless(
        GREY, predictor=2, sampling=[(1, 2)], restart=W),
    'cmyk': lambda: enc.encode_lossless(IMG, predictor=1),
    'rgb non-interleaved': lambda: enc.encode_lossless(
        RGB, predictor=2, interleaved=False),
    # a one-pass frame, then a scan of another frame's first component
    'rgb then another scan': lambda: enc.encode_lossless(
        RGB, predictor=1)[:-2] + _later_scans(),
}


def _later_scans():
    data = enc.encode_lossless(RGB[..., ::-1], predictor=2,
                               interleaved=False)
    return data[data.index(b'\xff\xda'):]


def _damaged(data):
    """name -> a cut or damaged copy of a stream."""
    start = _sos_end(data)
    n = len(data) - 2 - start
    out = {f'cut at {f}': data[:start + int(n * f)]
           for f in (0.0, 0.01, 0.3, 0.77, 0.999)}
    out['no EOI'] = data[:-2]
    flipped = bytearray(data)
    flipped[start + n // 3] ^= 0x5A
    flipped[start + n // 2] ^= 0x33
    out['flipped bytes'] = bytes(flipped)
    out['a reserved marker after the data'] = (
        data[:-2] + b'\xff\x33\x00\x04ab\xff\xd9')
    if b'\xff\xd1' in data:
        r = data.index(b'\xff\xd1')
        out['RST1 dropped'] = data[:r] + data[r + 2:]
        out['RST1 as RST4'] = data[:r] + b'\xff\xd4' + data[r + 2:]
        out['interval 1 short'] = data[:r - 7] + data[r:]
    scans = [i for i in range(len(data) - 1) if data[i:i + 2] == b'\xff\xda']
    if len(scans) == 3:
        out['ends before scan 2'] = data[:scans[1]]
        out['cut inside scan 3'] = data[:scans[2] + 40]
    return out


@pytest.mark.parametrize('name', sorted(DAMAGED))
def test_cut_and_damaged_files_read_as_cv2_imread(name, tmp_path):
    """Cut files (the decoder goes on from zero bits to the end of that
    MCU row, then every row restarts prediction from zero differences),
    flipped bytes and restart markers missing or out of order read as
    `cv2.imread` reads them; a file that ends before some component's
    first scan is refused, as there. A first scan that holds every
    component is the whole frame (libjpeg decodes it in one pass, and
    `cv2` keeps its rows whatever follows: a later scan, a reserved
    marker), while a frame of several scans is read whole before any row
    comes out, so a reserved marker anywhere refuses it. With its EOI
    kept, a cut payload reads as `cv2.imdecode` reads it."""
    path = str(tmp_path / 'x.jpg')
    for label, data in _damaged(DAMAGED[name]()).items():
        with open(path, 'wb') as f:
            f.write(data)
        for mode in MODES:
            want = cv2.imread(path, MODES[mode])
            got = _port(loading.imread, path, mode, 'cpu')
            assert _same(got, want), (label, mode)
            if label.startswith('cut at'):
                payload = data + b'\xff\xd9'
                assert _same(_port(loading.decode, payload, mode, 'cpu'),
                             _cv2(payload, mode)), (label, mode)
