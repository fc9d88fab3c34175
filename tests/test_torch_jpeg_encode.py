"""The port's JPEG writer (`data/jpeg.py:imencode` / `imwrite`, its pixel
stage in torch and `csrc/jpeg_entropy.cpp:hrf_jpeg_encode_scan`) against
`cv2.imencode('.jpg')` with its defaults, on the CPU.

Every stream is held byte-equal to `cv2`'s, for colour (4:2:0) and grey
images at sizes that are not multiples of 16 (so edge replication and
the MCU grid's dummy blocks are exercised), flat, noisy and saturated;
the port's own decoder reads each stream back equal to `cv2.imdecode`.
"""

import cv2
import numpy as np
import pytest
import torch

from hrfuser_tpu_torch.data import jpeg
from hrfuser_tpu_torch.data.pipelines import loading


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _image(kind, hw, seed=0):
    rng = np.random.default_rng(seed)
    h, w = hw
    if kind == 'flat':
        return np.full((h, w, 3), (30, 140, 220), np.uint8)
    if kind == 'noise':
        return rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    if kind == 'saturated':        # 0 and 255 regions beside noise
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        img[:h // 2] = 0
        img[h // 2:, :w // 2] = 255
        return img
    if kind == 'camera':           # smooth gradients with noise
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([xx * 200 / w, yy * 200 / h, (xx + yy) * 100 /
                         (h + w)], -1)
        return np.clip(base + rng.integers(0, 60, base.shape), 0,
                       255).astype(np.uint8)
    raise ValueError(kind)


CASES = [(hw, kind, grey) for hw in ((1, 1), (7, 9), (37, 53), (16, 16),
                                     (17, 8), (24, 40))
         for kind in ('flat', 'noise', 'saturated', 'camera')
         for grey in (False, True)]


@pytest.mark.parametrize('hw,kind,grey', CASES)
def test_bytes_equal_cv2(hw, kind, grey):
    img = _image(kind, hw)
    img = img[..., 1].copy() if grey else img
    want = cv2.imencode('.jpg', img)[1].tobytes()
    got = jpeg.imencode(img, device='cpu')
    assert got == want
    decoded = jpeg.decode_jpeg(got, 'cpu').numpy()
    ref = cv2.imdecode(np.frombuffer(want, np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(decoded, ref)


@pytest.mark.parametrize('grey', [False, True])
def test_a_full_camera_frame_equals_cv2(grey, tmp_path):
    """One 900x1600 nuScenes-sized frame through `imwrite`."""
    img = _image('camera', (900, 1600), seed=3)
    img = img[..., 0].copy() if grey else img
    path = str(tmp_path / 'frame.jpg')
    loading.imwrite(path, torch.from_numpy(img))
    with open(path, 'rb') as f:
        got = f.read()
    assert got == cv2.imencode('.jpg', img)[1].tobytes()
    np.testing.assert_array_equal(loading.imread(path, device='cpu'),
                                  cv2.imread(path))


def test_quality_tables_start_as_cv2s():
    luma, chroma = jpeg.quality_tables()
    assert luma[[0, 1, 2]].tolist() == [2, 1, 1]
    assert chroma.max() == 10


def test_imwrite_picks_the_encoder_by_extension(tmp_path):
    img = _image('noise', (12, 20))
    for ext in ('jpg', 'JPEG', 'png'):
        path = str(tmp_path / f'x.{ext}')
        loading.imwrite(path, img, device='cpu')
        want = cv2.imencode('.jpg' if ext != 'png' else '.png', img)[1]
        got = open(path, 'rb').read()
        if ext == 'png':          # equal pixels (zlib settings differ)
            np.testing.assert_array_equal(cv2.imread(path), img)
        else:
            assert got == want.tobytes()
    with pytest.raises(ValueError, match='only .jpg'):
        loading.imwrite(str(tmp_path / 'x.bmp'), img, device='cpu')


@pytest.mark.parametrize('bad', [np.zeros((4, 4), np.uint16),
                                 np.zeros((4, 4, 2), np.uint8),
                                 np.zeros((0, 4), np.uint8)])
def test_refuses_what_it_cannot_encode(bad):
    with pytest.raises(ValueError):
        jpeg.imencode(bad, device='cpu')


def test_entropy_coder_refuses_out_of_range_coefficients():
    blocks = np.zeros((1, 64), np.int16)
    blocks[0, 5] = 2000                       # an AC value beyond 1023
    with pytest.raises(jpeg.JpegError, match='out of range'):
        jpeg.encode_scan(blocks, (0,))


def test_writer_defaults_to_the_card():
    import inspect
    for fn in (jpeg.imencode, jpeg.imwrite, loading.imwrite):
        assert inspect.signature(fn).parameters['device'].default == 'cuda'
