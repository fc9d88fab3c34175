"""The port's config, data config and anchor copies equal the JAX
originals.

`hrfuser_tpu_torch` cannot import `hrfuser_tpu` (it pulls in jax), so it
carries its own config dataclasses, name lookup (`_bn` aliases, `.py`
paths) and anchor generator. Every field the port keeps must equal the
JAX config's; the fields it leaves out must be exactly the TPU routing
knobs listed here.
"""

import dataclasses

import numpy as np
import pytest

from hrfuser_tpu.configs import get_config as jax_get_config
from hrfuser_tpu.configs import list_configs as jax_list_configs
from hrfuser_tpu.ops.anchors import AnchorGenerator as JaxAnchors
from hrfuser_tpu_torch.configs import (get_config, get_experiment,
                                       list_configs)

NAMES = ['cascade_rcnn_hrfuser_t_1x_nus_r640_l_r_fusion',
         'cascade_rcnn_hrfuser_b_1x_nus_r640_l_r_fusion', 'tiny_fusion_test',
         'tiny_camera_test', 'cascade_rcnn_hrformer_t_1x_nus_r640',
         'cascade_rcnn_hrformer_b_1x_nus_r640',
         'cascade_rcnn_hrfuser_t_1x_stf_r1248_4mod',
         'cascade_rcnn_hrformer_t_1x_stf_c1248',
         'cascade_rcnn_hrfuser_hrnet_w18_1x_nus_r640_l_r_fusion',
         'tiny_hrnet_fusion_test']
# the JAX config the port leaves out (the multichip dry-run model,
# ROADMAP §1 "Multi-GPU"), with its `_bn` alias
NOT_PORTED = {'micro_fusion_dryrun'}

# TPU routing knobs and the adaptive RoIAlign grid, which the port does
# not carry
OMITTED = {
    'backbone.remat', 'backbone.cf_layout', 'backbone.chain_kernel',
    'roi.pool_method_eval', 'roi.pallas_variant', 'roi.max_grid',
}
OMITTED_IN_STAGES = set()
OMITTED_IN_FUSIONS = set()


def _compare(port, ref, path, omitted):
    if isinstance(port, dict):
        assert isinstance(ref, dict), path
        extra = set(port) - set(ref)
        assert not extra, f'{path}: fields not in the JAX config: {extra}'
        for key in set(ref) - set(port):
            omitted.add(f'{path}.{key}'.lstrip('.'))
        for key in port:
            _compare(port[key], ref[key], f'{path}.{key}', omitted)
    else:
        assert port == ref, f'{path}: port {port!r} != jax {ref!r}'


@pytest.mark.parametrize('name', NAMES)
def test_config_fields_equal_jax(name):
    port = dataclasses.asdict(get_config(name))
    ref = dataclasses.asdict(jax_get_config(name).model)
    omitted = set()
    _compare(port, ref, '', omitted)
    stage_fields = {o.rsplit('.', 1)[1] for o in omitted
                    if o.startswith('backbone.stage')
                    and o.count('.') == 2}
    fusion_fields = {o.rsplit('.', 1)[1] for o in omitted
                     if o.startswith('backbone.fusion_')
                     and o.count('.') == 2}
    top = {o for o in omitted if o.count('.') <= 1}
    assert top == OMITTED
    assert stage_fields == OMITTED_IN_STAGES
    assert fusion_fields == OMITTED_IN_FUSIONS
    assert get_config(name).is_fusion == jax_get_config(name).model.is_fusion


@pytest.mark.parametrize('name', NAMES)
def test_data_config_equals_jax(name):
    exp = get_experiment(name)
    assert exp.name == name
    assert exp.model == get_config(name)
    assert (dataclasses.asdict(exp.data)
            == dataclasses.asdict(jax_get_config(name).data))


@pytest.mark.parametrize('name', NAMES)
def test_schedule_and_optimizer_equal_jax(name):
    exp, ref = get_experiment(name), jax_get_config(name)
    assert (dataclasses.asdict(exp.schedule)
            == dataclasses.asdict(ref.schedule))
    assert dataclasses.asdict(exp.optim) == dataclasses.asdict(ref.optim)


@pytest.mark.parametrize('name', NAMES)
def test_unknown_name_raises(name):
    with pytest.raises(KeyError):
        get_config(name + '_nope')
    with pytest.raises(KeyError):
        get_experiment(name + '_nope')


@pytest.mark.parametrize('name', NAMES)
@pytest.mark.parametrize('form', ['{}_bn', 'configs/hrfuser/{}.py',
                                  'configs/hrformer/{}_bn.py'])
def test_aliases_and_paths_resolve_as_in_jax(name, form):
    asked = form.format(name)
    ref = jax_get_config(asked)
    exp = get_experiment(asked)
    assert exp.name == ref.name
    assert exp.model == get_config(asked) == get_config(name)
    assert (dataclasses.asdict(exp.data)
            == dataclasses.asdict(jax_get_config(name).data))


def test_list_configs_is_jax_minus_the_unported():
    unported = NOT_PORTED | {n + '_bn' for n in NOT_PORTED}
    assert unported <= set(jax_list_configs())
    assert list_configs() == sorted(set(jax_list_configs()) - unported)
    for name in list_configs():
        assert get_experiment(name).name == name


def test_anchors_bit_equal_jax_at_r640():
    cfg = get_config('cascade_rcnn_hrfuser_t_1x_nus_r640_l_r_fusion')
    sizes = [(384 // s, 640 // s) for s in cfg.anchor_strides]
    ours = cfg.anchor_generator().grid_anchors(sizes)
    ref = JaxAnchors(strides=list(cfg.anchor_strides),
                     ratios=list(cfg.anchor_ratios),
                     scales=list(cfg.anchor_scales)).grid_anchors(sizes)
    assert len(ours) == len(ref) == 5
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_anchors_bit_equal_jax_at_r1248():
    """The STF grid: the neck pools the stride-4 map (96x312) by 2^l,
    floored, so the odd widths 39 and 19 reach the anchor grid."""
    cfg = get_config('cascade_rcnn_hrfuser_t_1x_stf_r1248_4mod')
    sizes = [(384 // s, 1248 // s) for s in cfg.anchor_strides]
    assert sizes[3:] == [(12, 39), (6, 19)]
    ours = cfg.anchor_generator().grid_anchors(sizes)
    ref = JaxAnchors(strides=list(cfg.anchor_strides),
                     ratios=list(cfg.anchor_ratios),
                     scales=list(cfg.anchor_scales)).grid_anchors(sizes)
    for a, b in zip(ours, ref, strict=True):
        np.testing.assert_array_equal(a, b)
