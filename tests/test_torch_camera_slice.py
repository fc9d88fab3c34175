"""The camera-only eval slice vs the JAX detector on `tiny_camera_test`.

`HRFormerBackbone` (no modality streams, no fusion banks), HRFPN, RPN,
proposals and the cascade: JAX variables -> bridge -> port, both packages
on the same 64x96 batch-1 inputs at f32 on the CPU, compared stage by
stage at the tolerances of `tests/oracles/slice_pair.py`.
"""

import pytest
import torch

from hrfuser_tpu.configs import get_config as jax_get_config
from hrfuser_tpu_torch.configs import get_config
from tests.oracles.slice_pair import (SlicePair, check_backbone,
                                     check_decode, check_detections,
                                     check_neck_and_rpn, check_proposals)

NAME = 'tiny_camera_test'
HW = (64, 96)


@pytest.fixture(scope='module')
def s():
    return SlicePair(jax_get_config(NAME).model, get_config(NAME), HW)


@pytest.mark.parametrize('branch', range(4))
def test_backbone_branches_match_jax(s, branch):
    check_backbone(s, branch)


@pytest.mark.parametrize('lvl', range(5))
def test_neck_and_rpn_maps_match_jax(s, lvl):
    check_neck_and_rpn(s, lvl)


def test_proposals_match_jax(s):
    check_proposals(s)


def test_decode_cascade_matches_jax_on_identical_proposals(s):
    check_decode(s)


def test_predict_detections_match_jax(s):
    check_detections(s)


def test_camera_only_model_refuses_modality_inputs(s):
    img = torch.from_numpy(s.img)
    with pytest.raises(ValueError, match='camera-only'):
        s.model.forward_features(img, [img])
