"""The port's FLOP count against a count of the JAX package's jaxprs.

`tests/oracles/jaxpr_flops.py` counts the products of a JAX function
(`dot_general`, `conv_general_dilated`, and the JAX package's
`DepthwiseConv3x3`, 9 shifted multiply-adds, as the grouped convolution
it computes). The port counts with `torch.utils.flop_counter` and the
formulas `hrfuser_tpu_torch/ops/flops.py` registers on its ops.

  * Per op, exact: the formulas of `hrfuser::window_attention` (self and
    cross, both flax layouts) and `hrfuser::cross_ffn`, called through the
    registered ops under `FlopCounterMode`, equal the count of the flax
    module each stands for, at a padded (12x20) and an unpadded (14x21)
    map. Kernel C counts its taps, which the gather RoIAlign does not
    contract: both counts are stated below.
  * Whole eval forward (`apis/flops.count_flops`), exact after two named
    corrections, on `tiny_fusion_test` and `tiny_camera_test` at 64x96:
      - the resize: JAX's `bilinear_resize` (`jax.image.resize`)
        interpolates with contractions; the port's `F.interpolate`
        counts 0;
      - the RoIAlign: the gather RoIAlign's `_bin_reduce` einsum is taken
        out and kernel C's formula put in its place, once per cascade
        stage.
    XLA's own `cost_analysis()['flops']` of the lowered JAX program is
    printed beside them for information: it counts elementwise work too.
  * `params` equals JAX's count of `variables['params']` leaves, and the
    `get_flops` CLI's `--json` keys are the JAX tool's.

Weights come from `tests/oracles/random_variables.py` through
`state_dict_from_jax` (a count does not depend on them).
"""

import ast
import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from hrfuser_tpu.configs import get_config as jax_get_config
from hrfuser_tpu.layers.attention import (CrossFFN as JaxCrossFFN,
                                          LocalWindowSelfAttention,
                                          MultiWindowCrossAttention)
from hrfuser_tpu.models import CascadeRCNN as JaxCascadeRCNN
from hrfuser_tpu.models import predict as jax_predict
from hrfuser_tpu.ops.roi_align import multilevel_roi_align as jax_roi_align
from hrfuser_tpu_torch.apis.flops import count_flops, count_params
from hrfuser_tpu_torch.configs import get_config
from hrfuser_tpu_torch.layers.attention import HRFormerBlock
from hrfuser_tpu_torch.models.detectors.cascade_rcnn import CascadeRCNN
from hrfuser_tpu_torch.ops import chain, roi_align
from hrfuser_tpu_torch.ops.flops import (cross_ffn_flops, roi_align_flops,
                                        window_attention_flops)
from hrfuser_tpu_torch.tools import get_flops
from hrfuser_tpu_torch.utils.jax_weights import state_dict_from_jax
from tests.oracles import jaxpr_flops
from tests.oracles.card_checks import expected_launches
from tests.oracles.random_variables import random_variables
from tests.oracles.threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
HW = (64, 96)
C, HEADS = 16, 2
MAPS = [(2, 12, 20), (2, 14, 21)]          # padded to 14x21; unpadded
STRIDES = [4, 8, 16, 32]
# count_flops' entries -> card_checks' launch names
LAUNCH_NAMES = {'window_self_attention': 'window_attention_self',
                'window_cross_attention': 'window_attention_cross',
                'cross_ffn': 'cross_ffn',
                'multilevel_roi_align': 'roi_align'}


def _op_flops(fn, *args):
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


@pytest.fixture(scope='module')
def folded():
    """A port block's eval weights at width C (only shapes matter)."""
    return HRFormerBlock(C, HEADS).eval().folded()


def _jax_count(module, *inputs, **static):
    variables = random_variables(module, *inputs, **static)
    counts = jaxpr_flops.count(
        lambda v, *a: module.apply(v, *a, **static), variables, *inputs)
    return sum(counts.values())


@pytest.mark.parametrize('layout', ['nhwc', 'cf'])
@pytest.mark.parametrize('mode', ['self', 'cross'])
@pytest.mark.parametrize('shape', MAPS, ids=['padded', 'unpadded'])
def test_window_attention_formula_is_the_flax_count(shape, mode, layout,
                                                    folded):
    """T C (8 C + 196), T the map padded to whole 7x7 windows as the flax
    block pads it, equals the flax module's count (self: LSA, fused qkv;
    cross: MWCA, q from one map, k and v from the other)."""
    b, h, w = shape
    rng = np.random.default_rng(0)
    x, z = (rng.normal(0, 1, (b, h, w, C)).astype(np.float32)
            for _ in range(2))
    jx = [jnp.asarray(a if layout == 'nhwc' else a.transpose(0, 3, 1, 2))
          for a in (x, z)]
    if mode == 'self':
        want = _jax_count(LocalWindowSelfAttention(HEADS, layout=layout),
                          jx[0])
    else:
        want = _jax_count(MultiWindowCrossAttention(HEADS, layout=layout),
                          *jx)
    tx, tz = torch.from_numpy(x), torch.from_numpy(z)
    got = _op_flops(lambda: chain.window_attention(
        tx, None if mode == 'self' else tz, None, None, folded['attn'],
        HEADS, f'window_{mode}_attention', ln=False))
    assert got == want == window_attention_flops((b, h, w, C))


@pytest.mark.parametrize('shape', MAPS, ids=['padded', 'unpadded'])
def test_cross_ffn_formula_is_the_flax_count(shape, folded):
    """16 P C^2 + 72 P C: fc1 and fc2 (1x1 convs) and the depthwise 3x3,
    which JAX computes as 9 shifted multiply-adds (counted by the oracle
    as the grouped convolution it is)."""
    x = np.random.default_rng(0).normal(0, 1, (*shape, C)).astype(
        np.float32)
    want = _jax_count(JaxCrossFFN(4 * C, C), jnp.asarray(x), train=False)
    got = _op_flops(chain.ffn, torch.from_numpy(x), folded['ffn'],
                    'cross_ffn')
    p = int(np.prod(shape))
    assert got == want == cross_ffn_flops((*shape, C), 4 * C)
    assert got == 16 * p * C * C + 72 * p * C


def _pyramid(rng, b):
    return [rng.normal(0, 1, (b, HW[0] // s, HW[1] // s, C)).astype(
        np.float32) for s in STRIDES]


def test_roi_align_counts_stated_both_ways():
    """Kernel C counts a multiply-add per channel for each of the 4
    bilinear taps of each of a RoI's 196 samples: 1568 C a RoI. The JAX
    gather RoIAlign computes the taps' products elementwise, which the
    oracle does not count; its contractions are `_bin_reduce`'s: the
    outer product of the two 2-sample weight vectors (8 a RoI) and the
    weighted sum of each bin's 4 samples (392 C a RoI), a quarter of
    kernel C's count in all."""
    rng = np.random.default_rng(0)
    n = 37
    feats = _pyramid(rng, 1)
    xy = rng.uniform(0, 60, (n, 2))
    rois = np.concatenate([xy, xy + rng.uniform(4, 40, (n, 2))],
                          1).astype(np.float32)
    counts = jaxpr_flops.count(
        lambda f, r: jax_roi_align(f, r, STRIDES),
        [jnp.asarray(f[0]) for f in feats], jnp.asarray(rois))
    assert set(counts) == {'hrfuser_tpu/ops/roi_align.py:_bin_reduce'}
    assert sum(counts.values()) == 392 * n * C + 8 * n
    got = _op_flops(roi_align.multilevel_roi_align,
                    [torch.from_numpy(f) for f in feats],
                    torch.from_numpy(rois)[None], STRIDES)
    assert got == roi_align_flops((1, n, 4), C) == 1568 * n * C


@pytest.fixture(scope='module', params=['tiny_fusion_test',
                                        'tiny_camera_test'])
def pair(request):
    """(config name, JAX model, JAX variables, port model, inputs)."""
    name = request.param
    jcfg = jax_get_config(name).model
    jdet = JaxCascadeRCNN(jcfg)
    bb = jcfg.backbone
    rng = np.random.default_rng(0)
    img = rng.normal(0, 1, (1, *HW, 3)).astype(np.float32)
    mods = [rng.normal(0, 1, (1, *HW, c)).astype(np.float32)
            for c in bb.mod_in_channels[:bb.num_fused_modalities]]
    jmods = [jnp.asarray(m) for m in mods] or None
    variables = random_variables(jdet, jnp.asarray(img), jmods, False,
                                 seed=5)
    model = CascadeRCNN(get_config(name)).eval()
    model.load_state_dict(state_dict_from_jax(variables, model.cfg),
                          strict=True)
    return name, jdet, variables, model, img, mods


def test_eval_forward_is_the_jaxpr_count(pair):
    """`count_flops` of `predict` equals the oracle's count of JAX's CPU
    `predict` less the resize contractions, with kernel C's formula in
    place of the gather einsum; the op calls are one forward's launches
    (`card_checks.expected_launches`) and NMS counts 0."""
    name, jdet, variables, model, img, mods = pair
    jmods = [jnp.asarray(m) for m in mods] or None
    counts, traced = jaxpr_flops.trace(functools.partial(jax_predict, jdet),
                                       variables, jnp.asarray(img), jmods)
    got = count_flops(model, torch.from_numpy(img),
                      [torch.from_numpy(m) for m in mods])
    cfg = model.cfg
    kernel_c = roi_align_flops((1, cfg.rpn_test.max_per_img, 4),
                               cfg.neck_out_channels) * cfg.roi.num_stages
    resize = jaxpr_flops.origin(counts, 'common.py:bilinear_resize')
    gather = jaxpr_flops.origin(counts, 'roi_align.py:_bin_reduce')
    jax_total = sum(counts.values())
    xla = traced.lower().cost_analysis()['flops']
    print(f'{name}: port {got["flops"]}, JAX products {jax_total} (resize '
          f'{resize}, gather RoIAlign {gather}, kernel C {kernel_c}), '
          f'XLA cost_analysis {xla:.0f} (elementwise work included)')
    assert resize > 0 and gather > 0
    assert got['flops'] == jax_total - resize - gather + kernel_c
    by_op = got['by_op']
    assert by_op['hrfuser.roi_align']['flops'] == kernel_c
    assert by_op['hrfuser.greedy_keep']['flops'] == 0
    assert all(v['flops'] > 0 for k, v in by_op.items()
               if k != 'hrfuser.greedy_keep')
    want, _ = expected_launches(cfg)
    launches = {LAUNCH_NAMES[k]: n for k, n in got['entries'].items()}
    assert launches == {k: n for k, n in want.items() if n}


def test_params_are_the_jax_count(pair):
    _, _, variables, model, _, _ = pair
    want = sum(int(np.prod(x.shape))
               for x in jax.tree_util.tree_leaves(variables['params']))
    assert count_params(model) == want


def _jax_json_keys():
    """The keys of the JAX tool's `out` dict (`tools/get_flops.py`)."""
    tree = ast.parse((ROOT / 'tools' / 'get_flops.py').read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and [getattr(t, 'id', None) for t in node.targets]
                == ['out']):
            return [k.value for k in node.value.keys]
    raise AssertionError('no `out` dict in tools/get_flops.py')


def test_get_flops_cli_writes_the_jax_keys(capsys):
    get_flops.main(['tiny_fusion_test', '--img-hw', *map(str, HW),
                    '--batch', '2', '--json', '--device', 'cpu'])
    out = json.loads(capsys.readouterr().out)
    assert list(out) == _jax_json_keys()
    model = CascadeRCNN(get_config('tiny_fusion_test')).eval()
    img = torch.zeros((2, *HW, 3))
    want = count_flops(model, img, [torch.zeros((2, *HW, 3))] * 2)['flops']
    assert out['gflops_total'] == want / 1e9
    assert out['gflops_per_image'] == want / 1e9 / 2
    assert out['params'] == count_params(model)
    assert out['mode'] == 'inference'
    assert out['input'] == '2x64x96x3 (+2 modalities)'
    assert out['gbytes_accessed'] is None
    assert out['arithmetic_intensity_flop_per_byte'] is None


def test_get_flops_cli_text_and_default_size(capsys, monkeypatch):
    """Without `--img-hw` the size is `img_scale` rounded up to /32 (the
    config's scale cut here, so the CPU forward stays small); the text
    lines are the JAX tool's."""
    import dataclasses

    from hrfuser_tpu_torch.apis import inference
    real = inference.get_experiment

    def small(name):
        exp = real(name)
        return dataclasses.replace(exp, data=dataclasses.replace(
            exp.data, img_scale=(90, 50)))
    monkeypatch.setattr(inference, 'get_experiment', small)
    get_flops.main(['tiny_camera_test', '--device', 'cpu'])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == 'config:    tiny_camera_test'
    assert lines[1] == ('mode:      inference   input: 1x64x96x3 '
                        '(+0 modalities)')
    assert lines[2].startswith('params:    ') and lines[2].endswith(' M')
    assert lines[3].startswith('FLOPs:     ') and 'GFLOPs/image' in lines[3]
    assert lines[4] == 'HBM bytes: (not reported by this backend)'


def test_get_flops_defaults_to_the_card():
    assert get_flops.parse_args(['x']).device == 'cuda'
