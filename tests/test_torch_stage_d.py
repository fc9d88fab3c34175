"""The pre-neck fusion stage D vs the JAX package.

A reference-style `extra` dict at `tiny_fusion_test`'s widths with a
`LidarStageD` (stage C's dict) and a `ModFusionD` (fusion C's dict):
both packages' `backbone_cfg_from_extra` parse it into equal configs,
and the detector built on it gives equal backbone outputs (stage D,
transition D, fusion bank D and the ReLU after it), neck and RPN maps
on the same 64x96 batch-1 inputs at f32 on the CPU, at the tolerances of
`tests/oracles/slice_pair.py`. The port runs stage D's HRFormer blocks
as one block chain where JAX runs them one by one; the math is the same.
"""

import dataclasses

import pytest

from hrfuser_tpu.configs import get_config as jax_get_config
from hrfuser_tpu.models import backbone_cfg_from_extra as jax_from_extra
from hrfuser_tpu_torch.configs import get_config
from hrfuser_tpu_torch.models import backbone_cfg_from_extra
from tests.oracles.slice_pair import (SlicePair, check_backbone,
                                     check_neck_and_rpn)

HW = (64, 96)
CHANNELS, HEADS = (8, 16, 24, 32), (1, 2, 2, 4)
# the TPU routing knobs the port does not carry
KNOBS = {'remat', 'cf_layout', 'chain_kernel'}


def _stage(branches, modules, block='HRFORMERBLOCK'):
    return dict(num_modules=modules, num_branches=branches, block=block,
                num_blocks=(2,) * branches,
                num_channels=CHANNELS[:branches],
                num_heads=HEADS[:branches], window_sizes=(7,) * branches,
                mlp_ratios=(4,) * branches)


def _fusion(branches):
    return dict(num_branches=branches, num_channels=CHANNELS[:branches],
                num_heads=HEADS[:branches], window_sizes=(7,) * branches,
                mlp_ratios=(4,) * branches, drop_path=0.2,
                proj_drop_rate=0.1)


def _extra():
    bottleneck = dict(num_modules=1, num_branches=1, block='BOTTLENECK',
                      num_blocks=(2,), num_channels=(64,))
    lidar_c = _stage(1, 3)
    return dict(stage1=bottleneck, stage2=_stage(2, 1),
                stage3=_stage(3, 3), stage4=_stage(4, 2),
                LidarStageA=bottleneck, LidarStageB=_stage(1, 1),
                LidarStageC=lidar_c, LidarStageD=dict(lidar_c),
                ModFusionA=_fusion(2), ModFusionB=_fusion(3),
                ModFusionC=_fusion(4), ModFusionD=_fusion(4))


ARGS = dict(num_fused_modalities=2, mod_in_channels=(3, 3),
            drop_path_rate=0.1)


def test_extra_dict_parses_to_the_jax_config():
    port = backbone_cfg_from_extra(_extra(), **ARGS)
    ref = jax_from_extra(_extra(), **ARGS)
    assert port.pre_neck_fusion and ref.pre_neck_fusion
    want = dataclasses.asdict(ref)
    assert set(want) - set(dataclasses.asdict(port)) == KNOBS
    for k in KNOBS:
        del want[k]
    assert dataclasses.asdict(port) == want
    # stage D takes stage 4's drop-path rates, as B and C take 2's and 3's
    assert port.stage_d.drop_path_rates == port.stage4.drop_path_rates
    assert port.stage_d.block == 'HRFORMER'


@pytest.fixture(scope='module')
def s():
    extra = _extra()
    jcfg = jax_get_config('tiny_fusion_test').model
    jcfg = dataclasses.replace(
        jcfg, backbone=jax_from_extra(extra, num_fused_modalities=2,
                                      mod_in_channels=(3, 3)))
    cfg = get_config('tiny_fusion_test')
    cfg = dataclasses.replace(
        cfg, backbone=backbone_cfg_from_extra(extra, num_fused_modalities=2,
                                              mod_in_channels=(3, 3)))
    return SlicePair(jcfg, cfg, HW)


@pytest.mark.parametrize('branch', range(4))
def test_stage_d_backbone_branches_match_jax(s, branch):
    check_backbone(s, branch)


@pytest.mark.parametrize('lvl', range(5))
def test_stage_d_neck_and_rpn_maps_match_jax(s, lvl):
    check_neck_and_rpn(s, lvl)


def test_stage_d_modules_are_built(s):
    bb = s.model.backbone
    assert len(bb.fusion_d) == 4 and len(bb.stage_d) == 2
    assert len(bb.transition_d[0]) == 4
