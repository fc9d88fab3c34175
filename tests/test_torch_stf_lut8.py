"""The port's 8-bit STF LUT images (`data/stf_lut.py`) against the JAX
package's `hrfuser_tpu/data/stf_lut.py` and the `cv2` routines it calls,
on the CPU, all bit-equal: CLAHE (clip 2.0 and 0.5, sizes divisible and
not divisible by the 8x8 tiles, flat and low-contrast images), the GB
Bayer demosaic on uint16, BGR -> Lab and Lab -> BGR over all 2^24 uint8
triples, `gated_raw_to_lut8` (one 720x1280 frame) and `raw_to_lut8`
(daytime and nighttime).
"""

import cv2
import numpy as np
import pytest
import torch

from hrfuser_tpu.data import stf_lut as J
from hrfuser_tpu_torch.data import stf_lut as P


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grey(kind, hw, seed=0):
    rng = np.random.default_rng(seed)
    if kind == 'noise':
        return rng.integers(0, 256, hw).astype(np.uint8)
    if kind == 'low':                     # low contrast
        return rng.integers(100, 108, hw).astype(np.uint8)
    if kind == 'flat':
        return np.full(hw, 77, np.uint8)
    if kind == 'gradient':
        yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
        return ((xx * 3 + yy) % 256).astype(np.uint8)
    raise ValueError(kind)


@pytest.mark.parametrize('clip', [2.0, 0.5])
@pytest.mark.parametrize('hw', [(64, 96), (67, 93), (64, 93), (67, 96),
                                (9, 11), (200, 41)])
@pytest.mark.parametrize('kind', ['noise', 'low', 'flat', 'gradient'])
def test_clahe_equals_cv2(clip, hw, kind):
    img = _grey(kind, hw)
    want = cv2.createCLAHE(clip, (8, 8)).apply(img)
    got = P.clahe(img, clip, device='cpu')
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('hw', [(3, 3), (8, 10), (9, 11), (64, 93),
                                (101, 64)])
def test_bayer_demosaic_equals_cv2(hw):
    raw = np.random.default_rng(1).integers(0, 65536, hw).astype(np.uint16)
    want = cv2.cvtColor(raw, cv2.COLOR_BAYER_GB2BGR)
    np.testing.assert_array_equal(P.bayer_gb_to_bgr(raw, 'cpu').numpy(),
                                  want)
    # int16 tensors carry uint16 bits
    bits = torch.from_numpy(raw.view(np.int16))
    np.testing.assert_array_equal(P.bayer_gb_to_bgr(bits).numpy(), want)


@pytest.mark.parametrize('code,fn', [(cv2.COLOR_BGR2LAB, P.bgr_to_lab),
                                     (cv2.COLOR_LAB2BGR, P.lab_to_bgr)],
                         ids=['bgr_to_lab', 'lab_to_bgr'])
def test_lab_equals_cv2_on_every_triple(code, fn):
    every = np.stack(np.meshgrid(np.arange(256), np.arange(256),
                                 np.arange(256), indexing='ij'),
                     -1).astype(np.uint8).reshape(4096, 4096, 3)
    for part in np.split(every, 4):
        np.testing.assert_array_equal(fn(part, 'cpu').numpy(),
                                      cv2.cvtColor(part, code))


def test_gated_lut8_equals_jax_on_a_full_frame():
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0:720, 0:1280]
    raw = np.clip(300 + 200 * np.sin(xx / 40.0) * np.cos(yy / 33.0)
                  + rng.normal(0, 30, (720, 1280)), 0, 1023).astype(
                      np.uint16)
    got = P.gated_raw_to_lut8(raw, device='cpu')
    assert got.dtype == torch.uint8 and got.shape == (720, 1280)
    np.testing.assert_array_equal(got.numpy(), J.gated_raw_to_lut8(raw))


@pytest.mark.parametrize('daytime', [True, False])
def test_raw_lut8_equals_jax(daytime):
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:96, 0:136]
    raw = np.clip(1800 + 1500 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
                  + rng.normal(0, 200, (96, 136)), 0, 3967).astype(np.uint16)
    got = P.raw_to_lut8(raw, daytime, device='cpu')
    assert got.dtype == torch.uint8 and got.shape == (96, 136, 3)
    np.testing.assert_array_equal(got.numpy(), J.raw_to_lut8(raw, daytime))


def test_values_outside_a_table_raise():
    with pytest.raises(ValueError, match='index a table'):
        P.gated_raw_to_lut8(np.full((16, 16), 1024, np.uint16), 'cpu')
    with pytest.raises(ValueError, match='index a table'):
        P.raw_to_lut8(np.full((16, 16), 3968, np.uint16), True, 'cpu')


def test_lut8_defaults_to_the_card():
    import inspect
    for fn in (P.clahe, P.bayer_gb_to_bgr, P.bgr_to_lab, P.lab_to_bgr,
               P.gated_raw_to_lut8, P.raw_to_lut8):
        assert inspect.signature(fn).parameters['device'].default == 'cuda'


@pytest.mark.parametrize('fn', [P.clahe, P.bgr_to_lab, P.lab_to_bgr])
def test_byte_routines_refuse_other_types(fn):
    args = (2.0,) if fn is P.clahe else ()
    with pytest.raises(ValueError, match='takes uint8'):
        fn(np.zeros((16, 16, 3) if fn is not P.clahe else (16, 16),
                    np.int32), *args, device='cpu')
