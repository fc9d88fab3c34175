"""The weight bridge: JAX variables <-> port state dict (reference names).

`state_dict_from_jax` must be the exact inverse of
`hrfuser_tpu.utils.pth_convert.convert_state_dict`, and the port's
parameter names must be the reference's, as the eager oracle
`tests/oracles/torch_hrfuser.py` spells them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrfuser_tpu.configs import get_config as jax_get_config
from hrfuser_tpu.layers.attention import HRFormerBlock as JaxBlock
from hrfuser_tpu.layers.attention import HRFuserFusionBlock as JaxFusion
from hrfuser_tpu.models import CascadeRCNN as JaxCascadeRCNN
from hrfuser_tpu.utils.pth_convert import convert_state_dict
from hrfuser_tpu_torch.configs import get_config
from hrfuser_tpu_torch.layers.attention import (HRFormerBlock,
                                                HRFuserFusionBlock)
from hrfuser_tpu_torch.models.detectors.cascade_rcnn import CascadeRCNN
from hrfuser_tpu_torch.utils.jax_weights import (fusion_block_state_dict,
                                                 hrformer_block_state_dict,
                                                 state_dict_from_jax)
from tests.oracles.random_variables import random_variables
from tests.oracles.torch_hrfuser import TorchHRFuserDetector

NAME = 'tiny_fusion_test'


def _flat(tree):
    return {'/'.join(str(getattr(k, 'key', k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope='module')
def jax_variables():
    cfg = jax_get_config(NAME).model
    x = jnp.zeros((1, 64, 96, 3), jnp.float32)
    return random_variables(JaxCascadeRCNN(cfg), x, [x, x], False, seed=1)


def test_bridge_round_trip_is_exact(jax_variables):
    """JAX tree -> state_dict_from_jax -> load_state_dict(strict) ->
    convert_state_dict -> the same JAX tree, leaf for leaf. The converter
    also emits a full ConvNorm beside each stage-2 conv-only transition
    (it cannot know which forward a config uses): those extras are the
    one allowed difference."""
    jcfg = jax_get_config(NAME).model
    model = CascadeRCNN(get_config(NAME))
    model.load_state_dict(state_dict_from_jax(jax_variables, model.cfg),
                          strict=True)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = convert_state_dict(sd, jcfg)
    for coll in ('params', 'batch_stats'):
        want, got = _flat(jax_variables[coll]), _flat(back[coll])
        assert set(want) <= set(got), set(want) - set(got)
        extra = set(got) - set(want)
        assert all('/transition' in k for k in extra), extra
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    # randomized running statistics made it through
    bn = _flat(jax_variables['batch_stats'])
    assert any(np.abs(v - 1.0).max() > 0.1 for k, v in bn.items()
               if k.endswith('var'))


def test_parameter_names_are_the_reference_names():
    cfg = get_config(NAME)
    ours = CascadeRCNN(cfg).state_dict()
    oracle_cfg = dataclasses.replace(
        jax_get_config(NAME).model, neck_out_channels=cfg.neck_out_channels)
    ref = TorchHRFuserDetector(oracle_cfg).state_dict()
    assert set(ours) == set(ref)
    for k, v in ref.items():
        assert tuple(ours[k].shape) == tuple(v.shape), k


def test_main_config_builds_with_reference_names():
    """Full-width HRFuser-T (no forward): the state dict has the shapes
    the converter maps, so a reference checkpoint loads."""
    name = 'cascade_rcnn_hrfuser_t_1x_nus_r640_l_r_fusion'
    model = CascadeRCNN(get_config(name))
    sd = model.state_dict()
    conv = convert_state_dict({k: v.numpy() for k, v in sd.items()},
                              jax_get_config(name).model)
    assert len(_flat(conv['params'])) > 1000
    assert sd['backbone.stage4.1.branches.3.1.attn.attn.qkv.weight'].shape \
        == (432, 144)
    assert sd['roi_head.bbox_head.2.shared_fcs.0.weight'].shape \
        == (1024, 256 * 49)
    assert torch.equal(sd['backbone.transition1.0.1.running_var'],
                       torch.ones(18))


def test_hrfuser_b_loads_strict_from_jax_variables():
    """Full-width HRFuser-B: the JAX variables tree (shapes by
    `jax.eval_shape`, nothing compiled) carries over and loads strictly."""
    name = 'cascade_rcnn_hrfuser_b_1x_nus_r640_l_r_fusion'
    x = jnp.zeros((1, 64, 96, 3), jnp.float32)
    v = random_variables(JaxCascadeRCNN(jax_get_config(name).model), x,
                         [x, x], False, seed=2)
    model = CascadeRCNN(get_config(name))
    sd = state_dict_from_jax(v, model.cfg)
    model.load_state_dict(sd, strict=True)
    assert sd['backbone.stage4.1.branches.3.1.attn.attn.qkv.weight'].shape \
        == (3 * 624, 624)
    assert sd['backbone.stage_c.1.3.branches.0.1.ffn.layers.0.weight'] \
        .shape == (312, 78, 1, 1)
    np.testing.assert_array_equal(
        sd['backbone.fusion_c.3.attn.1.attn.q_proj.weight'].numpy(),
        np.asarray(v['params']['backbone']['fusion_c']['branch3']['attn_1']
                   ['q_proj']['kernel']).T)


@pytest.mark.parametrize('m', [None, 2, 3])
def test_block_bridges_load_strict(m):
    """`hrformer_block_state_dict` / `fusion_block_state_dict`: one flax
    block's variables -> the port block, strictly, leaf for leaf."""
    x = jnp.zeros((1, 7, 7, 12), jnp.float32)
    if m is None:
        v = random_variables(JaxBlock(num_heads=2), x, False, seed=5)
        sd, port = hrformer_block_state_dict(v), HRFormerBlock(12, 2)
        kernel = v['params']['attn']['qkv']['kernel']
        key = 'attn.attn.qkv.weight'
    else:
        v = random_variables(JaxFusion(num_heads=2, num_modalities=m), x,
                             [x] * m, False, seed=m)
        sd, port = fusion_block_state_dict(v, m), HRFuserFusionBlock(12, 2, m)
        kernel = v['params'][f'attn_{m - 1}']['v_proj']['kernel']
        key = f'attn.{m - 1}.attn.v_proj.weight'
    port.load_state_dict(sd, strict=True)
    np.testing.assert_array_equal(sd[key].numpy(), np.asarray(kernel).T)
    var = v['batch_stats']['ffn']['norm2']['bn']['var']
    np.testing.assert_array_equal(sd['ffn.layers.4.running_var'].numpy(),
                                  np.asarray(var))


STF_TINY = dict(channels=(8, 16, 24, 32), heads=(1, 2, 2, 4),
                num_modalities=3, mod_in_channels=(3, 2, 1))
# modules only a fusion backbone has
MODALITY_KEYS = ('conv_a', 'norm_a', 'conv_b', 'norm_b', 'layer_a',
                 'transition_a', 'transition_b', 'transition_c', 'stage_b',
                 'stage_c', 'fusion_a', 'fusion_b', 'fusion_c')


TINY_NAMES = {'camera': 'tiny_camera_test', 'hrnet': 'tiny_hrnet_fusion_test'}


def _tiny_pair(kind):
    """(JAX model cfg, port model cfg): `tiny_camera_test`,
    `tiny_hrnet_fusion_test`, or `tiny_fusion_test`'s widths with three
    modalities (3 / 2 / 1 input channels), built from the same arguments
    on both sides."""
    from hrfuser_tpu.configs import presets as jax_presets
    from hrfuser_tpu_torch.configs import presets
    if kind in TINY_NAMES:
        return (jax_get_config(TINY_NAMES[kind]).model,
                get_config(TINY_NAMES[kind]))
    jcfg = jax_get_config('tiny_fusion_test').model
    jcfg = dataclasses.replace(
        jcfg, backbone=jax_presets.hrfuser_backbone(**STF_TINY))
    return jcfg, presets._tiny(presets.hrfuser_backbone(**STF_TINY))


@pytest.mark.parametrize('kind', ['camera', 'three_modalities', 'hrnet'])
def test_bridge_round_trip_is_exact_for_new_trees(kind):
    """As `test_bridge_round_trip_is_exact`, for the camera-only tree (no
    `stem_mod*`, `layer_a*`, modality stages or fusion banks), the
    three-modality tree and the HRNet-based tree (BASIC residual
    branches, conv fuse paths)."""
    jcfg, cfg = _tiny_pair(kind)
    x = jnp.zeros((1, 64, 96, 3), jnp.float32)
    mods = ([jnp.zeros((1, 64, 96, c), jnp.float32)
             for c in cfg.backbone.mod_in_channels] or None)
    variables = random_variables(JaxCascadeRCNN(jcfg), x, mods, False,
                                 seed=4)
    model = CascadeRCNN(cfg)
    model.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    back = convert_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, jcfg)
    for coll in ('params', 'batch_stats'):
        want, got = _flat(variables[coll]), _flat(back[coll])
        extra = set(got) - set(want)
        assert set(want) <= set(got), set(want) - set(got)
        assert all('/transition' in k for k in extra), extra
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    names = _flat(variables['params'])
    if kind == 'camera':
        assert not any(k.split('/')[1].startswith(('stem_mod', 'layer_a'))
                       for k in names)
    elif kind == 'hrnet':
        assert ('backbone/stage4/module0/branch3/block0/conv2/conv/kernel'
                in names)
        assert 'backbone/stage_c/mod1/module0/branch0/block0/conv1/conv/' \
            'kernel' in names
        assert 'backbone/stage4/module0/fuse3_0/step2/conv/kernel' in names
        assert model.backbone.stage4[0].fuse_layers[3][0][2][0].stride \
            == (2, 2)
    else:
        assert 'backbone/stem_mod2/conv1/conv/kernel' in names
        assert model.backbone.conv_a[2].weight.shape == (64, 1, 3, 3)


def test_hrnet_names_are_the_reference_names():
    """The HRNet-based tree's names and shapes are the reference's, as
    the oracle (BASIC branches, `nn.Upsample` in the up fuse paths)
    spells them."""
    name = 'tiny_hrnet_fusion_test'
    cfg = get_config(name)
    ours = CascadeRCNN(cfg).state_dict()
    oracle_cfg = dataclasses.replace(
        jax_get_config(name).model, neck_out_channels=cfg.neck_out_channels)
    ref = TorchHRFuserDetector(oracle_cfg).state_dict()
    assert set(ours) == set(ref)
    for k, v in ref.items():
        assert tuple(ours[k].shape) == tuple(v.shape), k


def test_hrnet_w18_loads_strict_from_jax_variables():
    """Full-width HRNet-W18 HRFuser: the JAX variables tree (shapes by
    `jax.eval_shape`) carries over and loads strictly."""
    name = 'cascade_rcnn_hrfuser_hrnet_w18_1x_nus_r640_l_r_fusion'
    x = jnp.zeros((1, 64, 96, 3), jnp.float32)
    v = random_variables(JaxCascadeRCNN(jax_get_config(name).model), x,
                         [x, x], False, seed=8)
    model = CascadeRCNN(get_config(name))
    sd = state_dict_from_jax(v, model.cfg)
    model.load_state_dict(sd, strict=True)
    assert sd['backbone.stage3.3.branches.2.3.conv2.weight'].shape \
        == (72, 72, 3, 3)
    assert sd['backbone.stage4.2.fuse_layers.0.3.0.weight'].shape \
        == (18, 144, 1, 1)
    assert sd['backbone.layer_a.1.3.conv3.weight'].shape == (256, 64, 1, 1)


def test_camera_only_names_are_the_reference_trunk():
    """HRFormer's parameter names are HRFuser's camera trunk's
    (the reference oracle builds fusion models only)."""
    ours = CascadeRCNN(get_config('tiny_camera_test')).state_dict()
    cfg = get_config(NAME)
    oracle_cfg = dataclasses.replace(
        jax_get_config(NAME).model, neck_out_channels=cfg.neck_out_channels)
    ref = {k: v for k, v in TorchHRFuserDetector(oracle_cfg).state_dict()
           .items() if k.split('.')[1] not in MODALITY_KEYS}
    assert set(ours) == set(ref)
    for k, v in ref.items():
        assert tuple(ours[k].shape) == tuple(v.shape), k


def test_stf_4mod_loads_strict_from_jax_variables():
    """Full-width STF HRFuser-T: three streams with 3 / 2 / 1 input
    channels carry over and load strictly."""
    name = 'cascade_rcnn_hrfuser_t_1x_stf_r1248_4mod'
    x = jnp.zeros((1, 64, 96, 3), jnp.float32)
    cfg = get_config(name)
    mods = [jnp.zeros((1, 64, 96, c), jnp.float32) for c in (3, 2, 1)]
    v = random_variables(JaxCascadeRCNN(jax_get_config(name).model), x,
                         mods, False, seed=6)
    model = CascadeRCNN(cfg)
    sd = state_dict_from_jax(v, cfg)
    model.load_state_dict(sd, strict=True)
    assert sd['backbone.conv_a.2.weight'].shape == (64, 1, 3, 3)
    assert sd['backbone.fusion_c.3.attn.2.attn.q_proj.weight'].shape \
        == (144, 144)
