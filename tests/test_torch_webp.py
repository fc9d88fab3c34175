"""The port's WebP reader (`hrfuser_tpu_torch/data/webp.py`,
`csrc/webp_decode.cpp`) against `cv2` 5.0's libwebp, on the CPU.

Every read is held bit for bit to `cv2.imdecode` in 'color', 'unchanged'
and 'grayscale', and a file's to the JAX package's loader
(`hrfuser_tpu.data.pipelines.loading._imread`, which reads WebP through
`cv2.imread`); wherever `cv2` returns None the port raises a ValueError
whose text starts with `WebP`. The files: `cv2` and PIL encodes (lossy at
several qualities and methods, lossless, with alpha and
`alpha_quality`, animated), the numpy oracle's real encodes and its
fuzzed syntax (`tests/oracles/webp_files.py`) at 1x1, 1xN, Nx1 and sizes
off the 16-pixel grid, hand-made containers, bare chunks and raw
bitstreams, and cut and bit-flipped files.
"""

import hashlib
import io
import struct
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from hrfuser_tpu.data.pipelines.loading import _imread as jax_imread
from hrfuser_tpu_torch.data import webp
from hrfuser_tpu_torch.data.pipelines import loading

sys.path.insert(0, str(Path(__file__).resolve().parent / 'oracles'))
import webp_files as wf  # noqa: E402

cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_SILENT)
MODES = {'color': cv2.IMREAD_COLOR, 'unchanged': cv2.IMREAD_UNCHANGED,
         'grayscale': cv2.IMREAD_GRAYSCALE}
SIZES = [(1, 1), (1, 17), (17, 1), (33, 49)]


def _cv2(data: bytes, flag: str):
    try:
        return cv2.imdecode(np.frombuffer(data, np.uint8), MODES[flag])
    except cv2.error:           # sizes past validateInputImageSize
        return None


def _port(data: bytes, flag: str):
    try:
        return webp.imdecode(data, flag)
    except ValueError as e:
        assert str(e).startswith('WebP'), e
        return None


def assert_reads_as_cv2(data: bytes, flags=tuple(MODES)) -> int:
    """Each mode equal to cv2's, or refused where cv2 returns None;
    returns how many modes decoded."""
    n = 0
    for flag in flags:
        want, got = _cv2(data, flag), _port(data, flag)
        if want is None:
            assert got is None, (flag, got.shape)
            continue
        assert got is not None, flag
        assert got.dtype == want.dtype and got.shape == want.shape, flag
        np.testing.assert_array_equal(got, want, err_msg=flag)
        n += 1
    return n


def _image(h, w, channels=3, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 3 + yy, yy * 5, (xx + yy) * 2, xx * 255 // max(
        w - 1, 1)][:channels], -1)
    noise = rng.integers(-20, 20, base.shape)
    noise[..., 3:] = 0
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def _cv2_webp(img, quality):
    return cv2.imencode('.webp', img, [cv2.IMWRITE_WEBP_QUALITY,
                                       quality])[1].tobytes()


def _pil_webp(img, **kw):
    mode = 'RGBA' if img.shape[2] == 4 else 'RGB'
    order = [2, 1, 0, 3][:img.shape[2]]
    out = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(img[..., order]), mode).save(
        out, 'WEBP', **kw)
    return out.getvalue()


def _pil_animation(frames, **kw):
    ims = [Image.fromarray(np.ascontiguousarray(f[..., [2, 1, 0, 3][
        :f.shape[2]]]), 'RGBA' if f.shape[2] == 4 else 'RGB')
        for f in frames]
    out = io.BytesIO()
    ims[0].save(out, 'WEBP', save_all=True, append_images=ims[1:], **kw)
    return out.getvalue()


ENCODES = {
    'cv2 lossy q1': lambda im: _cv2_webp(im, 1),
    'cv2 lossy q50': lambda im: _cv2_webp(im, 50),
    'cv2 lossy q90': lambda im: _cv2_webp(im, 90),
    'cv2 lossy q100': lambda im: _cv2_webp(im, 100),
    'cv2 lossless': lambda im: _cv2_webp(im, 101),
    'pil lossy method 0': lambda im: _pil_webp(im, quality=30, method=0),
    'pil lossy method 6': lambda im: _pil_webp(im, quality=70, method=6),
    'pil lossless method 0': lambda im: _pil_webp(im, lossless=True,
                                                  method=0),
    'pil lossless method 6': lambda im: _pil_webp(im, lossless=True,
                                                  method=6, quality=100),
}
ALPHA_ENCODES = {
    'pil alpha_quality 0': lambda im: _pil_webp(im, quality=60,
                                                alpha_quality=0),
    'pil alpha_quality 50 method 6': lambda im: _pil_webp(
        im, quality=40, alpha_quality=50, method=6),
    'pil alpha_quality 100': lambda im: _pil_webp(im, quality=80,
                                                  alpha_quality=100),
    'pil lossless exact': lambda im: _pil_webp(im, lossless=True,
                                               exact=True),
}


@pytest.mark.parametrize('channels', [3, 4])
@pytest.mark.parametrize('name', sorted(ENCODES))
def test_library_encodes_read_as_cv2(name, channels):
    for h, w in SIZES:
        data = ENCODES[name](_image(h, w, channels))
        # cv2 takes no file under 32 bytes (a 1x1 lossless one can be)
        assert assert_reads_as_cv2(data) == 3 * (len(data) >= 32), (h, w)


@pytest.mark.parametrize('name', sorted(ALPHA_ENCODES))
def test_alpha_encodes_read_as_cv2(name):
    for h, w in SIZES:
        data = ALPHA_ENCODES[name](_image(h, w, 4))
        assert assert_reads_as_cv2(data) == 3 * (len(data) >= 32), (h, w)


@pytest.mark.parametrize('name', ['cv2 lossy q50', 'cv2 lossless'])
def test_files_read_as_the_jax_loader(name, tmp_path):
    """`loading.imread` of a .webp file equals the JAX package's
    `_imread` (cv2.imread) in each mode."""
    for channels in (3, 4):
        path = tmp_path / f'x{channels}.webp'
        path.write_bytes(ENCODES[name](_image(33, 49, channels)))
        for flag in MODES:
            np.testing.assert_array_equal(
                loading.imread(str(path), flag, device='cpu'),
                jax_imread(str(path), flag))


def test_the_format_is_named_by_its_first_bytes(tmp_path):
    data = _cv2_webp(_image(9, 11), 101)
    assert loading.image_format(data) == 'WebP' and 'WebP' in loading.READS
    path = tmp_path / 'frame.png'          # the name does not matter
    path.write_bytes(data)
    np.testing.assert_array_equal(loading.imread(str(path), device='cpu'),
                                  jax_imread(str(path)))
    got = loading.imdecode(data, device='cpu')
    np.testing.assert_array_equal(got.numpy(), _cv2(data, 'color'))
    for bad in (data[:31], data[:60]):
        with pytest.raises(ValueError, match='^WebP'):
            loading.decode(bad, 'color', 'cpu')


def test_imread_refuses_a_file_over_64_mib_as_cv2(tmp_path):
    """`cv2.imread` refuses a WebP file over 64 MiB (trailing bytes
    count); `cv2.imdecode` reads the same bytes."""
    data = _cv2_webp(_image(5, 7), 101)
    for size in (webp.MAX_FILE_SIZE, webp.MAX_FILE_SIZE + 1):
        path = tmp_path / 'big.webp'
        big = data + bytes(size - len(data))
        path.write_bytes(big)
        want = cv2.imread(str(path))
        if want is None:
            with pytest.raises(ValueError, match='^WebP'):
                loading.imread(str(path), device='cpu')
        else:
            np.testing.assert_array_equal(
                loading.imread(str(path), device='cpu'), want)
        np.testing.assert_array_equal(loading.decode(big, 'color', 'cpu'),
                                      _cv2(big, 'color'))
    assert want is None


@pytest.mark.parametrize('blend', [0, 1, 2, 3])
@pytest.mark.parametrize('lossless', [False, True])
def test_an_animation_reads_its_first_frame_on_the_canvas(lossless, blend):
    """The first frame at its ANMF offset on a transparent black canvas,
    whatever its dispose and blend bits and the background colour say;
    the canvas keeps alpha in 'unchanged' when VP8X says alpha."""
    frames = []
    for k, (h, w, x, y) in enumerate([(20, 14, 6, 10), (30, 30, 0, 0),
                                      (5, 7, 2, 4)]):
        img = _image(h, w, 4, seed=k)
        frames.append((_chunks(img, lossless), w, h, x, y,
                       blend if k == 0 else 0))
    for flags in (0x02, 0x12):
        data = wf.animation((40, 36), frames, flags=flags,
                            background=0x80ff0000 + blend)
        assert assert_reads_as_cv2(data) == 3
        got = _port(data, 'unchanged')
        assert got.shape == (36, 40, 4 if flags & 0x10 else 3)
        assert not got[:10].any()                   # above the frame


def _chunks(img, lossless):
    """The bitstream chunks (ALPH and VP8, or VP8L) of a still file."""
    data = _cv2_webp(img, 101 if lossless else 60)
    out, pos = b'', 12
    while pos < len(data):
        n = struct.unpack_from('<I', data, pos + 4)[0]
        if data[pos:pos + 4] != b'VP8X':
            out += data[pos:pos + 8 + n + (n & 1)]
        pos += 8 + n + (n & 1)
    return out


def test_pil_animations_read_as_cv2():
    for channels in (3, 4):
        frames = [_image(40, 30, channels, seed=k) for k in range(3)]
        for kw in ({}, {'lossless': True}, {'quality': 40},
                   {'background': (10, 20, 30, 40)}):
            assert assert_reads_as_cv2(_pil_animation(frames, **kw)) == 3


def test_damaged_animations_refuse_as_cv2():
    """libwebp's demuxer checks the whole file (no partial data, frames
    inside the canvas, ANIM before ANMF); a damaged later frame is never
    decoded, a damaged first one refuses the file."""
    img = _image(20, 14)
    one = (_chunks(img, False), 14, 20, 6, 10, 0)
    data = wf.animation((40, 36), [one, (_chunks(img, False), 14, 20, 0, 0,
                                         0)])
    cases = [data[:cut] for cut in range(20, len(data), 37)]
    cases.append(wf.animation((18, 20), [one]))          # outside
    cases.append(wf.animation((40, 36), [one], flags=0x03))   # reserved
    later = bytearray(data)
    later[-40] ^= 0xff
    first = bytearray(data)
    first[data.find(b'VP8 ') + 8 + 3] ^= 0xff
    cases += [bytes(later), bytes(first)]
    for case in cases:
        assert_reads_as_cv2(case)
    assert assert_reads_as_cv2(bytes(later)) == 3
    assert assert_reads_as_cv2(bytes(first)) == 0


@pytest.mark.parametrize('hw', SIZES + [(16, 16), (23, 70)])
def test_oracle_lossless_is_exact(hw):
    for channels in (3, 4):
        img = _image(*hw, channels)
        data = wf.lossless(img)
        assert assert_reads_as_cv2(data) == 3
        np.testing.assert_array_equal(_port(data, 'unchanged'), img)


@pytest.mark.parametrize('hw', SIZES + [(16, 16), (40, 75)])
def test_oracle_lossy_reads_as_cv2(hw):
    data = wf.container(wf.lossy(_image(*hw), q=30), False)
    assert assert_reads_as_cv2(data) == 3


@pytest.mark.parametrize('method', [0, 1])
@pytest.mark.parametrize('filt', [0, 1, 2, 3])
def test_alpha_methods_and_filters(method, filt):
    """ALPH raw or VP8L-coded, each unfiltering; the pre-processing bit
    changes no pixel; the alpha plane comes back exact."""
    h, w = 21, 35
    vp8 = wf.lossy(_image(h, w), q=50)
    alpha = _image(h, w, 4, seed=3)[..., 3] ^ (np.arange(w) * 37 % 256
                                                ).astype(np.uint8)
    for pre in (0, 1):
        data = wf.with_alpha(vp8, w, h, wf.alph(alpha, method, filt, pre))
        assert assert_reads_as_cv2(data) == 3
        np.testing.assert_array_equal(_port(data, 'unchanged')[..., 3],
                                      alpha)


@pytest.mark.parametrize('seed', range(12))
def test_fuzzed_syntax_reads_as_cv2(seed):
    rng = np.random.default_rng(100 + seed)
    for h, w in [(1, 1), (1, 23), (19, 1), (17, 33), (40, 21)]:
        data, bgra = wf.fuzz_lossless(rng, h, w, alpha=rng.random() < 0.7)
        assert assert_reads_as_cv2(data) == 3
        np.testing.assert_array_equal(
            _port(data, 'unchanged')[..., :3], bgra[..., :3])
        vp8 = wf.fuzz_lossy(rng, h, w)
        assert assert_reads_as_cv2(wf.container(vp8, False)) == 3
        alpha = rng.integers(0, 256, (h, w)).astype(np.uint8)
        payload = wf.alph(alpha, int(rng.integers(0, 2)),
                          int(rng.integers(0, 4)), 0, rng)
        data = wf.with_alpha(vp8, w, h, payload)
        assert assert_reads_as_cv2(data) == 3
        np.testing.assert_array_equal(_port(data, 'unchanged')[..., 3],
                                      alpha)


def test_large_coefficients_as_libwebp_x86():
    """Coefficients near the token alphabet's top (cat6, up to 2114 times
    the largest quantiser, wrapping in int16): the full inverse DCT runs
    in 16-bit lanes as libwebp's x86 build runs it, where the C form of
    the same sums would differ."""
    rng = np.random.default_rng(9)
    for _ in range(6):
        frame = wf.VP8Frame(32, 16, base_q=int(rng.integers(100, 128)))
        row = []
        for x in range(2):
            mb = wf.MB()
            mb.is_i4x4 = x == 0
            mb.imodes = [int(v) for v in rng.integers(0, 10, 16)]
            for b in range(16):
                picks = rng.choice(16, 6, replace=False)
                mb.y[b, picks] = rng.integers(-2114, 2115, 6)
            if not mb.is_i4x4:
                mb.y[:, 0] = 0
                mb.y2[rng.choice(16, 3, replace=False)] = rng.integers(
                    -300, 300, 3)
            mb.u[:, :4] = rng.integers(-2114, 2115, (4, 4))
            row.append(mb)
        assert assert_reads_as_cv2(wf.container(frame.bitstream([row]),
                                                False)) == 3


@pytest.mark.parametrize('seed, flip', [(167, 1), (722, 23), (1494, 6),
                                        (1570, 15), (1666, 27)])
def test_damaged_streams_decode_by_libwebps_x86_reader(seed, flip):
    """Bit-flipped token partitions that push the boolean decoder's value
    past its range (found by a search over fuzzed files): they decode as
    libwebp's x86 reader does, with its 56-bit loads and its sign read
    (VP8GetSigned), not as a byte-at-a-time reader or a sign read through
    GetBit would."""
    rng = np.random.default_rng(seed)
    data = wf.container(wf.fuzz_lossy(rng, 17, 33), False)
    for _ in range(flip + 1):
        bad = bytearray(data)
        bad[int(rng.integers(20, len(bad)))] ^= 1 << int(rng.integers(0, 8))
    assert_reads_as_cv2(bytes(bad))


def _sources():
    rng = np.random.default_rng(7)
    img3, img4 = _image(19, 27), _image(19, 27, 4)
    vp8 = wf.fuzz_lossy(rng, 19, 27)
    return {
        'cv2 lossy': _cv2_webp(img3, 40),
        'cv2 lossless': _cv2_webp(img4, 101),
        'pil alpha': _pil_webp(img4, quality=50, alpha_quality=60),
        'fuzz lossless': wf.fuzz_lossless(rng, 19, 27)[0],
        'fuzz lossy': wf.container(vp8, False),
        'fuzz alpha raw': wf.with_alpha(vp8, 27, 19, wf.alph(
            img4[..., 3], 0, 3)),
        'fuzz alpha coded': wf.with_alpha(vp8, 27, 19, wf.alph(
            img4[..., 3], 1, 2, 0, rng)),
        'bare lossy chunk': wf.chunk(b'VP8 ', vp8),
        'raw lossless': wf.lossless(img3)[20:],
    }


@pytest.mark.parametrize('name', sorted(_sources()))
def test_cut_and_flipped_files_refuse_exactly_where_cv2_does(name):
    """Every cut length, and 250 files with 1-3 flipped bits: the port
    raises where cv2 returns None and is bit-equal elsewhere. (libwebp
    decodes some cut VP8 files, reading its zero padding, and the first
    frame of files whose damage lies in data it never reads.)"""
    data = _sources()[name]
    rng = np.random.default_rng(len(data))
    for cut in range(1, len(data)):
        assert_reads_as_cv2(data[:cut], ('unchanged',))
    for _ in range(250):
        bad = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            bad[int(rng.integers(0, len(bad)))] ^= 1 << int(
                rng.integers(0, 8))
        assert_reads_as_cv2(bytes(bad), ('unchanged', 'color'))


def test_container_rules_as_libwebp():
    """RIFF size past the end refused, bytes after it read; the VP8X
    alpha flag decides the channels (an ALPH without it is decoded and
    dropped, a damaged one still refuses the file); unknown and metadata
    chunks skipped; the last ALPH kept; a canvas other than the frame
    refused; reserved ALPH bits refused."""
    h, w = 13, 22
    img = _image(h, w)
    vp8 = wf.lossy(img, q=40)
    alpha = _image(h, w, 4)[..., 3]
    good = wf.alph(alpha, 1, 1)
    raw = wf.alph(alpha, 0, 0)
    meta = [wf.chunk(b'ICCP', b'x' * 5), wf.chunk(b'EXIF', b'ex'),
            wf.chunk(b'XMP ', b'<x/>'), wf.chunk(b'ZZZZ', b'123')]
    still = wf.container(vp8, False)
    cases = {
        'riff past end': still[:4] + struct.pack('<I', len(still)) +
        still[8:],
        'trailing junk': still + b'junk' * 9,
        'vp8x alpha': wf.with_alpha(vp8, w, h, good),
        'no alpha flag': wf.with_alpha(vp8, w, h, good, flags=0),
        'no alpha flag, damaged': wf.with_alpha(vp8, w, h, good[:6],
                                                flags=0),
        'alpha flag, no ALPH': wf.riff(wf.vp8x(w, h, 0x10)
                                       + wf.chunk(b'VP8 ', vp8)),
        'metadata chunks': wf.with_alpha(vp8, w, h, good, flags=0x3c,
                                         extra=meta),
        'two ALPH': wf.with_alpha(vp8, w, h, raw,
                                  extra=[wf.chunk(b'ALPH', good[:3])]),
        'canvas differs': wf.with_alpha(vp8, w + 1, h, good),
        'reserved bits': wf.with_alpha(vp8, w, h, bytes([good[0] | 0xc0])
                                       + good[1:]),
        'short raw alpha': wf.with_alpha(vp8, w, h, raw[:-1]),
        'odd chunk padding': wf.with_alpha(vp8 + b'\0', w, h, good),
    }
    decoded = {name: assert_reads_as_cv2(data)
               for name, data in cases.items()}
    assert decoded['riff past end'] == 0 and decoded['trailing junk'] == 3
    assert decoded['no alpha flag'] == 3 and decoded['canvas differs'] == 0
    assert _port(cases['no alpha flag'], 'unchanged').shape == (h, w, 3)
    assert _port(cases['alpha flag, no ALPH'], 'unchanged')[..., 3].min() \
        == 255


def test_bare_chunks_and_raw_bitstreams_read_as_cv2():
    """What `cv2` reads with no RIFF container, its signature check being
    libwebp's `WebPGetFeatures` over 32 bytes: a bare VP8L or VP8 chunk, a
    raw VP8L bitstream, a raw VP8 one whose first partition ends inside
    those bytes; with an ALPH chunk first, or a longer first partition,
    `cv2` finds no decoder. Each is named WebP by its first bytes where
    `cv2` reads it."""
    cases = {}
    for h, w in [(3, 5), (19, 27)]:
        for lossless in (False, True):
            for c in (3, 4):
                bare = _chunks(_image(h, w, c), lossless)
                kind = f'{h}x{w} {"VP8L" if lossless else "VP8"} {c}'
                cases[f'{kind} chunk'], cases[f'{kind} raw'] = bare, bare[8:]
        cases[f'{h}x{w} oracle VP8 raw'] = wf.lossy(_image(h, w), q=60)
    decoded = {name: assert_reads_as_cv2(data)
               for name, data in cases.items()}
    for name in ('19x27 VP8L 3 chunk', '19x27 VP8L 4 raw', '19x27 VP8 3 chunk',
                 '19x27 oracle VP8 raw'):
        assert decoded[name] == 3, name
    for name in ('19x27 VP8 4 chunk', '19x27 VP8 3 raw', '3x5 oracle VP8 raw'):
        assert decoded[name] == 0, name
    for name, data in cases.items():
        if decoded[name]:
            assert loading.image_format(data) == 'WebP', name
            np.testing.assert_array_equal(
                loading.decode(data, 'color', 'cpu'), _cv2(data, 'color'))


def test_pinned_camera_digests_match_cv2():
    """`webp_files.PINNED`, which `chip_smoke.py` phase 21 holds the
    card's machine's decode to, is cv2's decode of the oracle's camera
    frame (lossy, and lossy with alpha in the three modes)."""
    frames = wf.camera_frames(wf.camera(0), with_lossless=False)
    got = {'lossy color': _cv2(frames['lossy'], 'color')}
    for flag in MODES:
        got[f'lossy_alpha {flag}'] = _cv2(frames['lossy_alpha'], flag)
    digests = {k: hashlib.sha256(np.ascontiguousarray(v).tobytes())
               .hexdigest() for k, v in got.items()}
    assert digests == wf.PINNED
    for k, v in got.items():
        kind, flag = k.split()
        np.testing.assert_array_equal(_port(frames[kind], flag), v)


def test_a_decoder_that_does_not_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / 'webp_decode.cpp'
    bad.write_text('int broken( {\n')
    monkeypatch.setattr(webp, 'SOURCE', bad)
    monkeypatch.setattr(webp, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(webp, '_lib', None)
    with pytest.raises(RuntimeError, match='WebP decoder'):
        webp.imdecode(_cv2_webp(_image(4, 4), 101))
