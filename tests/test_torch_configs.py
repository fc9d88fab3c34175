"""The port's config, data config and anchor copies equal the JAX
originals.

`hrfuser_tpu_torch` cannot import `hrfuser_tpu` (it pulls in jax), so it
carries its own config dataclasses and anchor generator. Every field the
port keeps must equal the JAX config's; the fields it leaves out must be
exactly the TPU routing knobs and training-only fields listed here.
"""

import dataclasses

import numpy as np
import pytest

from hrfuser_tpu.configs import get_config as jax_get_config
from hrfuser_tpu.ops.anchors import AnchorGenerator as JaxAnchors
from hrfuser_tpu_torch.configs import get_config, get_experiment

NAMES = ['cascade_rcnn_hrfuser_t_1x_nus_r640_l_r_fusion',
         'cascade_rcnn_hrfuser_b_1x_nus_r640_l_r_fusion', 'tiny_fusion_test']

# TPU routing knobs and training-only fields the port does not carry
OMITTED = {
    'backbone.remat', 'backbone.cf_layout', 'backbone.chain_kernel',
    'backbone.drop_path_rate', 'backbone.stage_d', 'backbone.fusion_d',
    'roi.stage_loss_weights', 'roi.pool_method', 'roi.pool_method_eval',
    'roi.pallas_variant', 'roi.gather_bf16', 'roi.max_grid',
}
OMITTED_IN_STAGES = {'drop_path_rates'}
OMITTED_IN_FUSIONS = {'drop_path', 'proj_drop_rate'}


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


@pytest.mark.parametrize('name', NAMES)
def test_data_config_equals_jax(name):
    exp = get_experiment(name)
    assert exp.name == name
    assert exp.model == get_config(name)
    assert (dataclasses.asdict(exp.data)
            == dataclasses.asdict(jax_get_config(name).data))


@pytest.mark.parametrize('name', NAMES)
def test_unknown_name_raises(name):
    with pytest.raises(KeyError):
        get_config(name + '_nope')
    with pytest.raises(KeyError):
        get_experiment(name + '_nope')


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
