"""The port's preprocessing vs the JAX package's, on the CPU.

`hrfuser_tpu_torch.data.device_pipeline` against
`hrfuser_tpu.data.device_pipeline` (un-jitted, float32) and the CPU
pipeline (`Normalize` / `Pad`, as `tests/test_device_pipeline.py` builds
it); the port's `Resize` (`interpolate`) against the JAX `Resize`
(`cv2.INTER_LINEAR` on float32) and its nearest resize against
`cv2.INTER_NEAREST`; the copied tables against the originals.

Tolerances: elementwise steps are the same float32 operations, so they
are held bit-equal or to 1e-6; bilinear resizing samples like cv2 but
weighs in another order, 2e-3 on 0-255 values (1e-5 of the range);
after normalisation 1e-4.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrfuser_tpu.data import norms as jax_norms
from hrfuser_tpu.data import device_pipeline as jdp
from hrfuser_tpu.data import projection as jax_projection
from hrfuser_tpu.data.pipelines.transforms import Normalize as JaxNormalize
from hrfuser_tpu.data.pipelines.transforms import Pad as JaxPad
from hrfuser_tpu.data.pipelines.transforms import Resize as JaxResize
from hrfuser_tpu_torch.data import device_pipeline as dp
from hrfuser_tpu_torch.data import norms, projection, transforms

RESIZE_ATOL = 2e-3
NORM_ATOL = 1e-4


def test_norm_tables_equal_jax():
    assert norms.NUS == jax_norms.NUS
    assert norms.STF == jax_norms.STF


def test_quantize_and_dequantize_equal_jax():
    rng = np.random.default_rng(0)
    vals = rng.uniform(-199.0, 455.0, (4, 5, 3)).astype(np.float32)
    q = projection.quantize(vals)
    np.testing.assert_array_equal(q, jax_projection.quantize(vals))
    np.testing.assert_array_equal(projection.dequantize(q),
                                  jax_projection.dequantize(q))
    assert (projection.SCALE, projection.SHIFT) == (jax_projection.SCALE,
                                                    jax_projection.SHIFT)


@pytest.mark.parametrize('dtype', ['uint8', 'float32'])
def test_normalize_image_matches_jax(dtype):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (2, 30, 40, 3)).astype(dtype)
    got = dp.normalize_image(torch.from_numpy(img), **norms.NUS['img'])
    want = jdp.normalize_image(jnp.asarray(img), **jax_norms.NUS['img'])
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('form', ['uint16', 'int16 bits', 'int32', 'numpy'])
def test_dequantize_sensor_matches_jax(form):
    """Every representation of uint16 values on the device dequantizes
    bit-equal to the JAX function and to `projection.dequantize`,
    values above 32767 included."""
    rng = np.random.default_rng(2)
    raw = rng.integers(0, 65536, (2, 9, 11, 3)).astype(np.uint16)
    raw[0, 0, 0] = (0, 32768, 65535)
    x = {'uint16': lambda: torch.from_numpy(raw),
         'int16 bits': lambda: torch.from_numpy(raw.view(np.int16)),
         'int32': lambda: torch.from_numpy(raw.astype(np.int32)),
         'numpy': lambda: dp.to_device(raw, 'cpu')}[form]()
    got = dp.dequantize_sensor(x).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jdp.dequantize_sensor(jnp.asarray(raw))))
    np.testing.assert_array_equal(got, projection.dequantize(raw))


def test_normalize_sensor_matches_jax():
    rng = np.random.default_rng(3)
    raw = rng.normal(0, 20, (2, 8, 8, 3)).astype(np.float32)
    t = norms.NUS['radar']
    got = dp.normalize_sensor(torch.from_numpy(raw), t['mean'], t['std'])
    want = jdp.normalize_sensor(jnp.asarray(raw), t['mean'], t['std'])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('hw', [(30, 40), (32, 64), (360, 540)])
def test_pad_to_divisor_matches_jax(hw):
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (1, *hw, 3)).astype(np.float32)
    got = dp.pad_to_divisor(torch.from_numpy(x), 32).numpy()
    want = np.asarray(jdp.pad_to_divisor(jnp.asarray(x), 32))
    cpu = JaxPad(32)(dict(img=x[0].copy(), img_fields=['img']))['img']
    assert got.shape == want.shape == (1, *cpu.shape)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], cpu)


@pytest.mark.parametrize('modalities', [('lidar',), ('lidar', 'radar')])
def test_full_preprocess_matches_jax_and_cpu_pipeline(modalities):
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (2, 36, 44, 3), np.uint8)
    mods = [rng.integers(0, 65536, (2, 36, 44, 3)).astype(np.uint16)
            for _ in modalities]
    pre = dp.make_device_preprocess('nuscenes', modalities)
    out_img, out_mods = pre(torch.from_numpy(img),
                            [dp.to_device(m, 'cpu') for m in mods])
    j_img, j_mods = jdp.make_device_preprocess('nuscenes', modalities)(
        jnp.asarray(img), [jnp.asarray(m) for m in mods])
    assert out_img.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(out_img.numpy(), np.asarray(j_img), atol=1e-6)
    for got, want in zip(out_mods, j_mods):
        assert got.shape == (2, 64, 64, 3) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    for b in range(2):                          # the CPU pipeline per image
        res = dict(img=img[b].astype(np.float32), img_fields=['img'])
        for name, m in zip(modalities, mods):
            res[f'{name}_img'] = jax_projection.dequantize(m[b])
            res['img_fields'].append(f'{name}_img')
            res = JaxNormalize(**jax_norms.NUS[name], keys=[f'{name}_img'],
                               sensor_type=name)(res)
        res = JaxPad(32)(JaxNormalize(**jax_norms.NUS['img'],
                                      keys=['img'])(res))
        np.testing.assert_allclose(out_img[b].numpy(), res['img'],
                                   atol=NORM_ATOL)
        for name, got in zip(modalities, out_mods):
            np.testing.assert_allclose(got[b].numpy(), res[f'{name}_img'],
                                       atol=NORM_ATOL)


def test_float_sensor_streams_are_taken_as_dequantized():
    rng = np.random.default_rng(6)
    raw = rng.integers(0, 65536, (1, 8, 8, 3)).astype(np.uint16)
    pre = dp.make_device_preprocess('nuscenes', ('lidar',))
    img = torch.zeros((1, 8, 8, 3), dtype=torch.uint8)
    _, (from_u16,) = pre(img, [dp.to_device(raw, 'cpu')])
    _, (from_f32,) = pre(img, [torch.from_numpy(
        projection.dequantize(raw))])
    torch.testing.assert_close(from_u16, from_f32, rtol=0, atol=0)


@pytest.mark.parametrize('hw', [(900, 1600), (60, 90), (37, 53)])
def test_resize_matches_jax_resize(hw):
    """900x1600 -> 360x640 (x0.4, nuScenes' camera), the tiny test's
    60x90 -> 360x540 (x6) and a ragged size, against cv2."""
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (*hw, 3)).astype(np.float32)
    got = transforms.Resize((640, 360))(dict(img=img.copy(),
                                             img_fields=['img']))
    want = JaxResize((640, 360))(dict(img=img.copy(), img_fields=['img']))
    assert got['img_shape'] == want['img_shape']
    np.testing.assert_array_equal(got['scale_factor'], want['scale_factor'])
    assert got['scale_factor'].dtype == np.float32
    np.testing.assert_allclose(got['img'], want['img'], atol=RESIZE_ATOL)


@pytest.mark.parametrize('src,dst', [((60, 90), (360, 540)),
                                     ((360, 640), (384, 683)),
                                     ((37, 53), (20, 71))])
def test_nearest_resize_matches_cv2(src, dst):
    rng = np.random.default_rng(8)
    x = rng.integers(0, 65536, (*src, 3)).astype(np.uint16)
    want = cv2.resize(x, dst[::-1], interpolation=cv2.INTER_NEAREST)
    got = dp.resize_image(dp.to_device(x, 'cpu')[None], dst, 'nearest')[0]
    assert got.dtype == torch.int16                # the uint16 bits, kept
    np.testing.assert_array_equal(got.numpy().view(np.uint16), want)


def test_resize_device_call_matches_transform():
    """`resize_image` on a uint8 batch equals `Resize` on each image."""
    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (2, 60, 90, 3)).astype(np.uint8)
    got = dp.resize_image(torch.from_numpy(img), (360, 540))
    assert got.dtype == torch.float32
    for b in range(2):
        want = transforms.Resize((640, 360))(dict(
            img=img[b].astype(np.float32), img_fields=['img']))['img']
        np.testing.assert_array_equal(got[b].numpy(), want)


def test_modality_drop_zeroes_whole_streams_and_repeats():
    streams = [torch.ones((64, 4, 4, 2)), torch.ones((64, 4, 4, 2))]

    def drop(seed, p):
        return dp.modality_drop(torch.Generator().manual_seed(seed),
                                streams, p)

    out = drop(0, [0.5, 0.5])
    for o in out:
        per_sample = o.reshape(64, -1)
        assert bool((per_sample.amin(1) == per_sample.amax(1)).all())
        assert 0 < int(per_sample[:, 0].sum()) < 64
    assert not torch.equal(out[0], out[1])      # streams drop independently
    for a, b in zip(out, drop(0, [0.5, 0.5])):
        assert torch.equal(a, b)
    assert all(bool((o == 1).all()) for o in drop(1, [0.0, 0.0]))
    assert all(bool((o == 0).all()) for o in drop(1, [1.0, 1.0]))


@pytest.mark.parametrize('gated_dtype', [np.uint8, np.uint16, np.float32])
def test_stf_preprocess_normalizes_each_stream_with_its_table(gated_dtype):
    """STF camera + lidar (3 channels) + radar (2) + gated (1): the
    camera and the uint16 projections as the JAX device pipeline
    preprocesses them; the gated image as the JAX loader reads it (a grey
    image cast to float, `loading.py:114`) and its `Normalize` with the
    STF gated table. Any integer depth of the gated image is taken as
    intensities, never dequantized."""
    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (2, 36, 44, 3), np.uint8)
    lidar = rng.integers(19000, 26000, (2, 36, 44, 3)).astype(np.uint16)
    radar = rng.integers(19000, 26000, (2, 36, 44, 2)).astype(np.uint16)
    high = 255 if gated_dtype == np.uint8 else 1024
    gated = rng.integers(0, high, (2, 36, 44, 1)).astype(gated_dtype)
    pre = dp.make_device_preprocess('stf', ('lidar', 'radar', 'gated'))
    out_img, out_mods = pre(torch.from_numpy(img),
                            [dp.to_device(m, 'cpu')
                             for m in (lidar, radar, gated)])
    j_img, (j_lidar, j_radar) = jdp.make_device_preprocess(
        'stf', ('lidar', 'radar'))(jnp.asarray(img),
                                   [jnp.asarray(lidar), jnp.asarray(radar)])
    np.testing.assert_allclose(out_img.numpy(), np.asarray(j_img), atol=1e-6)
    assert [tuple(m.shape[1:]) for m in out_mods] == [(64, 64, 3),
                                                      (64, 64, 2),
                                                      (64, 64, 1)]
    for got, want in zip(out_mods, (j_lidar, j_radar)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    for b in range(2):
        res = dict(gated_img=gated[b].astype(np.float32),
                   img_fields=['gated_img'])
        res = JaxNormalize(**jax_norms.STF['gated'], keys=['gated_img'],
                           sensor_type='gated')(res)
        np.testing.assert_allclose(out_mods[2][b, :36, :44].numpy(),
                                   res['gated_img'], atol=1e-6)
    assert not out_mods[2][:, 36:].any() and not out_mods[2][:, :, 44:].any()
