"""`inference_detector` of the port vs the JAX package's, on the CPU.

`tiny_fusion_test` with the same weights on both sides (the JAX
variables tree, numpy-filled, carried over by `state_dict_from_jax`), a
raw 60x90 BGR uint8 image that both resize to 360x540 (padded 384x544),
as `tests/test_inference_api.py` feeds it, with two 60x90 sensor images
that both bring to that grid by nearest neighbour. The JAX `Detector`'s
jitted predict is replaced by the un-jitted one (its jit compile is what
makes `tests/test_inference_api.py` slow), and its RoI pooling runs in
f32 as the port's does (`gather_bf16=False`).

Tolerances: the model inputs after preprocessing 1e-4 (the resize
differs from cv2 by at most 2e-3 on 0-255 values). Detections: valid
count and labels exact; boxes 0.15 px in the 360x540 model frame and
scores 5e-3, the cascade-decode tolerances of
`tests/test_full_model_parity.py` and `tests/test_torch_slice.py` (boxes
are compared in the original frame, so 0.15 is divided by the x6 scale
factor). At 384x544 the random-weight head moves scores by up to 1.5e-3
on identical inputs, so the final scores are held to the decode's
tolerance, not to the 1e-4 the 64x96 slice meets.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrfuser_tpu.apis.inference import Detector as JaxDetector
from hrfuser_tpu.apis.inference import \
    inference_detector as jax_inference_detector
from hrfuser_tpu.configs import get_config as jax_get_config
from hrfuser_tpu.data.projection import dequantize
from hrfuser_tpu.models import CascadeRCNN as JaxCascadeRCNN
from hrfuser_tpu.models import predict as jax_predict
from hrfuser_tpu_torch import inference_detector, init_detector
from hrfuser_tpu_torch.apis.inference import (detections_of,
                                              preprocess_request,
                                              request_to_device)
from hrfuser_tpu_torch.utils.jax_weights import state_dict_from_jax
from tests.oracles.random_variables import random_variables

NAME = 'tiny_fusion_test'
RAW_HW = (60, 90)


class _Pair:
    def __init__(self):
        jcfg = jax_get_config(NAME)
        model = dataclasses.replace(jcfg.model, roi=dataclasses.replace(
            jcfg.model.roi, gather_bf16=False))
        jcfg = dataclasses.replace(jcfg, model=model)
        module = JaxCascadeRCNN(model)
        zeros = jnp.zeros((1, 384, 544, 3), jnp.float32)
        variables = random_variables(module, zeros, [zeros, zeros], False,
                                     seed=5)
        self.jax = JaxDetector(jcfg, module, variables)
        self.last_inputs = None                # what JAX's predict was fed

        def recorded(variables, img, mods, shapes, sfs):
            self.last_inputs = (img, mods, shapes, sfs)
            return jax_predict(module, variables, img, mods, shapes, sfs)

        self.jax._predict = recorded
        self.port = init_detector(NAME, 'cpu')
        self.port.model.load_state_dict(
            state_dict_from_jax(variables, self.port.cfg), strict=True)
        rng = np.random.default_rng(0)
        self.img = rng.integers(0, 256, (*RAW_HW, 3)).astype(np.uint8)
        # uint16 projections: zero background, returns on 30 % of the
        # pixels with values in [-1, 10)
        self.u16 = []
        for _ in range(2):
            m = np.full((*RAW_HW, 3), 20000, np.uint16)
            hit = rng.random(RAW_HW) < 0.3
            m[hit] = rng.integers(19900, 21000, (int(hit.sum()), 3))
            self.u16.append(m)
        self.mods = [dequantize(m) for m in self.u16]

    @functools.cached_property
    def fused(self):
        out = jax_inference_detector(self.jax, self.img, self.mods)
        self.fused_inputs = self.last_inputs
        return out

    @functools.cached_property
    def camera_only(self):
        return jax_inference_detector(self.jax, self.img)


@pytest.fixture(scope='module')
def pair():
    return _Pair()


def _same_detections(got, want, box_px=0.15, score=5e-3, scale=6.0):
    assert set(got) == {'boxes', 'scores', 'labels'}
    assert len(want['labels']) > 0
    assert len(got['labels']) == len(want['labels'])
    np.testing.assert_array_equal(got['labels'], want['labels'])
    np.testing.assert_allclose(got['boxes'], want['boxes'],
                               atol=box_px / scale, rtol=0)
    np.testing.assert_allclose(got['scores'], want['scores'], atol=score,
                               rtol=0)


def test_preprocessed_inputs_match_jax_pipeline(pair):
    pair.fused                                  # records JAX's inputs
    j_img, j_mods, j_shape, j_sf = pair.fused_inputs
    img, mods = request_to_device(pair.port, pair.img, pair.u16)
    img, mods, shapes, sfs = preprocess_request(pair.port, img, mods)
    assert tuple(img.shape) == (1, 384, 544, 3) == j_img.shape
    np.testing.assert_allclose(img.numpy(), np.asarray(j_img), atol=1e-4)
    for got, want in zip(mods, j_mods):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_array_equal(shapes.numpy(), np.asarray(j_shape))
    np.testing.assert_array_equal(sfs.numpy(), np.asarray(j_sf))


def test_detections_match_jax_on_its_preprocessed_inputs(pair):
    pair.fused
    j_img, j_mods, j_shape, j_sf = pair.fused_inputs
    got = detections_of(pair.port(np.array(j_img),
                                  [np.array(m) for m in j_mods],
                                  np.array(j_shape), np.array(j_sf)))
    _same_detections(got, pair.fused)


@pytest.mark.parametrize('sensor', ['float32', 'uint16'])
def test_inference_detector_matches_jax(pair, sensor):
    mods = pair.mods if sensor == 'float32' else pair.u16
    got = inference_detector(pair.port, pair.img, mods)
    _same_detections(got, pair.fused)
    assert got['boxes'][:, 2].max() <= RAW_HW[1] + 1e-3   # original frame
    assert got['boxes'][:, 3].max() <= RAW_HW[0] + 1e-3


def test_camera_only_matches_jax(pair):
    got = inference_detector(pair.port, pair.img)
    _same_detections(got, pair.camera_only)
    assert np.isfinite(got['boxes']).all()
