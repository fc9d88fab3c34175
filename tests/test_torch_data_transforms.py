"""The port's pipeline steps (`data/pipelines/transforms.py`) and
`build_pipeline` against the JAX package's, on the CPU.

Every random step draws from `results['rng']`; the same seeds give the
same draws on both sides. Tolerances: boxes, labels, `gt_valid`, crops,
flips and drops exact; a resized image within 2e-3 of `cv2.INTER_LINEAR`
on 0-255 values (the port samples through `interpolate`, see
`tests/test_torch_device_pipeline.py`), which `Normalize` divides by its
std.
"""

import numpy as np
import pytest

from hrfuser_tpu.configs import get_config as jax_get_config
from hrfuser_tpu.data.loader import build_pipeline as jax_build_pipeline
from hrfuser_tpu.data.pipelines import transforms as jt
from hrfuser_tpu_torch.configs import get_experiment
from hrfuser_tpu_torch.data.loader import build_pipeline
from hrfuser_tpu_torch.data.pipelines import transforms as pt

RESIZE_ATOL = 2e-3
NUS = 'cascade_rcnn_hrfuser_t_1x_nus_r640_l_r_fusion'
STF = 'cascade_rcnn_hrfuser_t_1x_stf_r1248_4mod'


def _results(seed, hw=(90, 160)):
    rng = np.random.default_rng(seed)
    h, w = hw
    xy = rng.uniform(0, [w - 30, h - 20], (6, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 40, (6, 2))], 1)
    return dict(
        img=rng.uniform(0, 255, (h, w, 3)).astype(np.float32),
        lidar_img=rng.normal(0, 1, (h, w, 3)).astype(np.float32),
        gated_img=rng.normal(0, 1, (h, w, 1)).astype(np.float32),
        img_fields=['img', 'lidar_img', 'gated_img'],
        img_shape=(h, w, 3), ori_shape=(h, w, 3), filename='x.png',
        ori_filename='x.png', sample_idx=seed,
        gt_bboxes=boxes.astype(np.float32),
        gt_labels=rng.integers(0, 3, 6).astype(np.int64),
        bbox_fields=['gt_bboxes'], rng=np.random.default_rng(seed + 100))


def _check(got, want, atol=None):
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        a, b = got[k], want[k]
        if isinstance(b, np.ndarray):
            assert a.shape == b.shape and a.dtype == b.dtype, k
            if atol is not None and k in atol:
                np.testing.assert_allclose(a, b, atol=atol[k], rtol=0,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(a, b, err_msg=k)
        elif isinstance(b, np.random.Generator):
            assert a.bit_generator.state == b.bit_generator.state, k
        elif isinstance(b, dict):
            _check(a, b, atol)
        else:
            assert a == b, k


def _both(make, seed, **kw):
    return (make(pt)(_results(seed, **kw)), make(jt)(_results(seed, **kw)))


@pytest.mark.parametrize('ratio', [0.0, 0.5, 1.0])
def test_random_flip_equals_jax(ratio):
    flips = 0
    for seed in range(6):
        got, want = _both(lambda m: m.RandomFlip(ratio), seed)
        _check(got, want)
        flips += got['flip']
    assert flips == {0.0: 0, 1.0: 6}.get(ratio, flips)
    assert ratio != 0.5 or 0 < flips < 6


def test_random_drop_equals_jax():
    dropped = 0
    for seed in range(8):
        got, want = _both(lambda m: m.RandomDrop(
            [0.3, 0.3, 0.3], ['img', 'lidar_img', 'gated_img']), seed)
        _check(got, want)
        dropped += sum(not got[k].any() for k in ('img', 'lidar_img',
                                                   'gated_img'))
    assert 0 < dropped < 24
    with pytest.raises(ValueError, match='2 drop probabilities'):
        pt.RandomDrop([0.2, 0.2], ['img'])


CROPS = {
    # the STF crops of `build_pipeline` on a 1024x1920 frame
    'stf first': dict(crop_size=(768, 1280), offsets=(202, 280),
                      skip_keys=['lidar_img', 'gated_img']),
    'stf second': dict(crop_size=(384, 1248), offsets=(192, 16),
                       thresh_in_frame=0.1),
    'random offsets': dict(crop_size=(300, 500), thresh_in_frame=0.3),
    'no clip': dict(crop_size=(400, 600), offsets=(100, 200),
                    bbox_clip_border=False),
}


@pytest.mark.parametrize('case', sorted(CROPS))
def test_crop_equals_jax(case):
    for seed in range(3):
        def make(m):
            return m.Compose([m.Crop(**CROPS['stf first']),
                              m.Crop(**CROPS[case])])
        got, want = _both(make, seed, hw=(1024, 1920))
        _check(got, want)
        assert got['crop_factor'] == want['crop_factor']


def test_resize_equals_jax_within_the_resize_tolerance():
    for img_scale, keep in (((64, 36), True), ((1280, 768), False)):
        got, want = _both(lambda m: m.Resize(img_scale, keep,
                                              skip_keys=['gated_img']), 0)
        _check(got, want, atol={'img': RESIZE_ATOL,
                                'lidar_img': RESIZE_ATOL / 10})
        assert got['img_shape'] == want['img_shape']


def test_format_bundle_equals_jax():
    for max_gts in (4, 100):
        got, want = _both(lambda m: m.FormatBundle(
            max_gts, ['img', 'lidar_img']), 0)
        _check(got, want)
        assert got['gt_valid'].sum() == min(max_gts, 6)
        assert got['gt_labels'].dtype == np.int32


def _describe(pipeline):
    """Each step's class and arguments, arrays as lists, sets sorted."""
    out = []
    for step in pipeline.steps:
        args = {}
        for k, v in vars(step).items():
            if isinstance(v, np.ndarray):
                v = v.tolist()
            elif isinstance(v, set):
                v = sorted(v)
            args[k] = v
        out.append((type(step).__name__, args))
    return out


@pytest.mark.parametrize('name', [NUS, STF, 'tiny_camera_test'])
@pytest.mark.parametrize('train', [True, False])
def test_build_pipeline_equals_jax(name, train):
    got = _describe(build_pipeline(get_experiment(name).data, train, 50))
    want = _describe(jax_build_pipeline(jax_get_config(name).data, train,
                                        50))
    assert got == want
    names = [n for n, _ in got]
    assert ('RandomFlip' in names) == train
    assert ('Crop' in names) == (name == STF)
