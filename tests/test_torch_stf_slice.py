"""The STF-shaped fusion slice vs the JAX detector: three modalities.

`tiny_fusion_test`'s widths with `num_modalities=3` and
`mod_in_channels=(3, 2, 1)` (camera + lidar + radar + gated, as
`cascade_rcnn_hrfuser_t_1x_stf_r1248_4mod`), the config built on both
sides from the same arguments. At 64x160 the stride-32 map is 2x5 and the
neck's pooled stride-64 level 1x2 (160 / 64 floored), odd widths as at
r1248 (12x39, 6x19). The modality stems take 2 and 1 input channels, the
modality stages run three streams and every fusion block queries three.
Checks and tolerances: `tests/oracles/slice_pair.py`'s, except the final
scores (see `test_predict_detections_match_jax`).
"""

import dataclasses

import pytest

from hrfuser_tpu.configs import presets as jax_presets
from hrfuser_tpu_torch.configs import presets
from tests.oracles.slice_pair import (SlicePair, check_backbone,
                                     check_decode, check_detections,
                                     check_neck_and_rpn, check_proposals)

ARGS = dict(channels=(8, 16, 24, 32), heads=(1, 2, 2, 4), num_modalities=3,
            mod_in_channels=(3, 2, 1))
HW = (64, 160)


def _jax_cfg():
    """`tiny_fusion_test`'s model half (`hrfuser_tpu/configs/presets.py:
    238-252`) over the three-modality backbone."""
    model = jax_presets.detector(jax_presets.hrfuser_backbone(**ARGS),
                                 num_classes=4)
    return dataclasses.replace(
        model,
        roi=dataclasses.replace(model.roi, fc_out_channels=64,
                                max_per_img=20),
        rpn_test=dataclasses.replace(model.rpn_test, nms_pre=200,
                                     max_per_img=100),
        neck_out_channels=32)


@pytest.fixture(scope='module')
def s():
    return SlicePair(_jax_cfg(), presets._tiny(presets.hrfuser_backbone(
        **ARGS)), HW)


def _kept(port, ref):
    """`ref` restricted to the fields the port's config carries."""
    if isinstance(port, dict):
        return {k: _kept(v, ref[k]) for k, v in port.items()}
    return ref


def test_configs_agree_on_the_three_modalities(s):
    port = dataclasses.asdict(s.model.cfg)
    assert port == _kept(port, dataclasses.asdict(s.jcfg)
                         | {'roi': dataclasses.asdict(s.jcfg.roi)})
    assert s.model.cfg.backbone.num_fused_modalities == 3
    assert [c.in_channels for c in s.model.backbone.conv_a] == [3, 2, 1]


@pytest.mark.parametrize('branch', range(4))
def test_backbone_branches_match_jax(s, branch):
    check_backbone(s, branch)


@pytest.mark.parametrize('lvl', range(5))
def test_neck_and_rpn_maps_match_jax(s, lvl):
    check_neck_and_rpn(s, lvl)


def test_odd_width_pyramid(s):
    feats = s.features[0][0]
    assert [tuple(f.shape[1:3]) for f in feats] == [
        (16, 40), (8, 20), (4, 10), (2, 5), (1, 2)]


def test_proposals_match_jax(s):
    check_proposals(s)


def test_decode_cascade_matches_jax_on_identical_proposals(s):
    check_decode(s)


def test_predict_detections_match_jax(s):
    # each package decodes its own proposals, which differ by up to 1e-3
    # px; one final score then moves by 1.2e-3 while the cascade on
    # identical proposals agrees to 3e-5 (the decode test), so scores are
    # held to the decode's 5e-3, as in `test_torch_inference_api.py`
    check_detections(s, score_tol=5e-3)
