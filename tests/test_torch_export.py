"""Model export on the CPU: the registered ops and `torch.export` of
`predict` (`hrfuser_tpu_torch/apis/export.py`,
`hrfuser_tpu_torch/tools/export_model.py`).

- `torch.library.opcheck` holds each `hrfuser::` op's CPU implementation
  (the kernels' plain twins; NMS's keep loop) to its fake implementation
  in float32 and bfloat16: schema, fake shapes, dtypes and strides, and
  a dynamic-shape trace.
- `tiny_fusion_test`, `tiny_camera_test` and `tiny_hrnet_fusion_test` at
  64x96, with weights carried over from a JAX variables tree
  (`tests/oracles/slice_pair.py`): exported, saved, loaded, the loaded
  program bit-equal to eager `predict` and within `slice_pair`'s
  detection tolerances (1e-2 px + 1e-3 relative, scores 1e-4) of the
  JAX detector un-jitted; its graph calls the kernels' ops as often as
  one forward launches them, and holds no raw parameter.
- the CLI end to end with `--device cpu --verify`; `cached` raising under
  the tracer with nothing stored; no launch counted on the CPU.
- `slow`: the JAX package's own StableHLO export (`tools/export_model.py`,
  run unedited, from a checkpoint of the same JAX variables) against the
  port's program (its jit of `predict` takes minutes on the CPU).
"""

import collections
import importlib.util
import os
import sys

import jax.numpy as jnp
import pytest
import torch
from torch import nn

from hrfuser_tpu.configs import get_config as jax_get_config
from hrfuser_tpu_torch.apis.export import export_predict, input_shapes
from hrfuser_tpu_torch.apis.inference import Detector
from hrfuser_tpu_torch.configs import get_config, get_experiment
from hrfuser_tpu_torch.layers.common import conv_bn
from hrfuser_tpu_torch.models.detectors.cascade_rcnn import (CascadeRCNN,
                                                             predict)
from hrfuser_tpu_torch.ops import chain
from hrfuser_tpu_torch.tools import export_model
from tests.oracles.card_checks import expected_launches
from tests.oracles.op_cases import LABELS, op_case
from tests.oracles.slice_pair import (SlicePair, assert_detections_close,
                                     check_detections)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ['tiny_fusion_test', 'tiny_camera_test', 'tiny_hrnet_fusion_test']
HW = (64, 96)
DTYPES = [torch.float32, torch.bfloat16]
ENTRIES = {'window_self_attention': 'window_attention_self',
           'window_cross_attention': 'window_attention_cross',
           'cross_ffn': 'cross_ffn', 'multilevel_roi_align': 'roi_align'}


def _counts():
    return {k: fn.launches for k, fn in chain.COUNTERS.items()}


# ---------------------------------------------------------------------------
# the ops against their fake implementations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('label', LABELS)
def test_op_matches_its_fake(label, dtype):
    """Each op's CPU implementation against its fake one; its output
    keeps the activations' dtype (a bool mask for the keep loop), shape
    and contiguous layout."""
    op, args = op_case(label, 'cpu', dtype)
    torch.library.opcheck(op, args)
    out = op(*args)
    if label.startswith('keep'):
        assert out.dtype == torch.bool and out.shape == args[1].shape
        assert not (out & ~args[1]).any()
    else:
        assert out.dtype == dtype and out.is_contiguous()
        want = ((2, 5, 49, 8) if label.startswith('C')
                else tuple(args[0].shape))
        assert tuple(out.shape) == want


def test_cached_raises_under_the_tracer_with_nothing_stored():
    class ConvBN(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv, self.bn = nn.Conv2d(3, 4, 3, padding=1), \
                nn.BatchNorm2d(4)

        def forward(self, x):
            return conv_bn(x, self.conv, self.bn)

    m, x = ConvBN().eval(), torch.zeros((1, 8, 8, 3))
    with pytest.raises(RuntimeError, match='run the model once eagerly'):
        torch.export.export(m, (x,), strict=False)
    with torch.no_grad():
        want = m(x)                      # stores the fold
        program = torch.export.export(m, (x,), strict=False)
    assert torch.equal(program.module()(x), want)


# ---------------------------------------------------------------------------
# export of predict
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module', params=NAMES)
def exported(request, tmp_path_factory):
    """One export per config: JAX weights carried over, exported on the
    CPU, saved and loaded back; the counts before and after."""
    name = request.param
    s = SlicePair(jax_get_config(name).model, get_config(name), HW)
    det = Detector(s.model, get_experiment(name).data, torch.device('cpu'))
    before = _counts()
    program = export_predict(det, 1, HW)
    path = tmp_path_factory.mktemp(name) / 'model.pt2'
    torch.export.save(program, path)
    loaded = torch.export.load(path)
    with torch.no_grad():
        got = loaded.module()(torch.from_numpy(s.img), *s._tmods())
        want = predict(s.model, torch.from_numpy(s.img), s._tmods())
    return dict(s=s, det=det, program=program, loaded=loaded, got=got,
                want=want, counts=(before, _counts()))


def test_loaded_program_is_bit_equal_to_eager_predict(exported):
    got, want = exported['got'], exported['want']
    assert type(got).__name__ == 'Detections'
    assert exported['want'].valid.any()
    for k in got._fields:
        assert getattr(got, k).dtype == getattr(want, k).dtype, k
        assert torch.equal(getattr(got, k), getattr(want, k)), k


def test_loaded_program_matches_jax(exported):
    run = exported['loaded'].module()
    check_detections(exported['s'], run=run)


def test_program_calls_the_registered_ops_as_a_forward_launches(exported):
    """Each kernel op node carries the entry it counts under; one forward
    of the config launches as many (`card_checks.expected_launches`).
    NMS's keep loop runs twice: the RPN's proposals and the detections."""
    graph = exported['loaded'].graph
    ops = collections.Counter()
    for node in graph.nodes:
        if node.op == 'call_function' and 'hrfuser' in str(node.target):
            name = str(node.target).split('.')[1]
            ops[ENTRIES.get(node.args[-1], name)] += 1
    want, _ = expected_launches(exported['s'].model.cfg)
    assert {k: ops[k] for k in want} == want
    assert ops['greedy_keep'] == 2
    assert set(ops) <= set(want) | {'greedy_keep'}


def test_program_holds_folded_constants_and_no_raw_parameter(exported):
    program = exported['program']
    assert not program.state_dict
    assert program.constants
    assert all(not isinstance(t, torch.Tensor) or not t.requires_grad
               for t in program.constants.values())


def test_export_and_the_loaded_program_count_no_launch_on_the_cpu(exported):
    before, after = exported['counts']
    assert before == after
    with torch.no_grad():
        exported['loaded'].module()(
            *[torch.zeros(s) for s in input_shapes(exported['det'], 1, HW)])
    assert _counts() == after


def test_cli_exports_and_verifies_on_the_cpu(tmp_path, capsys):
    out = tmp_path / 't.pt2'
    export_model.main(['tiny_fusion_test', '--device', 'cpu', '--out',
                       str(out), '--img-hw', *map(str, HW), '--verify'])
    text = capsys.readouterr().out
    assert out.stat().st_size > 0
    assert 'device=cpu' in text and 'verify ok' in text
    assert ("largest difference: {'boxes': 0.0, 'scores': 0.0, "
            "'labels': 0.0, 'valid': 0.0}") in text


def test_export_refuses_a_training_model():
    det = Detector(CascadeRCNN(get_config('tiny_camera_test')).train(),
                   get_experiment('tiny_camera_test').data,
                   torch.device('cpu'))
    with pytest.raises(ValueError, match='training mode'):
        export_predict(det, 1, HW)


# ---------------------------------------------------------------------------
# the JAX package's StableHLO artifact against the port's program
# ---------------------------------------------------------------------------

def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        'jax_export_model', os.path.join(ROOT, 'tools', 'export_model.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.slow
def test_jax_stablehlo_artifact_matches_the_port_program(tmp_path,
                                                         monkeypatch):
    """`tools/export_model.py` (unedited) exports `tiny_fusion_test` from
    an orbax checkpoint of `slice_pair`'s JAX variables, under the slice
    tests' config (`gather_bf16=False`: both packages pool in float32);
    the port exports the same weights. Both artifacts, loaded back, run
    `slice_pair`'s inputs: detections at its tolerances, scores at 1e-3
    (XLA's jit reorders the JAX side's float32 sums: 1.8e-4 measured
    here, where the port holds 1e-4 against un-jitted JAX)."""
    import dataclasses

    import orbax.checkpoint as ocp

    import hrfuser_tpu.configs
    from jax import export as jexport
    name = 'tiny_fusion_test'
    s = SlicePair(jax_get_config(name).model, get_config(name), HW)
    ckpt = str(tmp_path / 'ckpt')
    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(ckpt, {k: s.variables[k]
                          for k in ('params', 'batch_stats')})
    cfg = dataclasses.replace(jax_get_config(name), model=s.jcfg)
    monkeypatch.setattr(hrfuser_tpu.configs, 'get_config', lambda _: cfg)
    blob = tmp_path / 'model.stablehlo'
    monkeypatch.setattr(sys, 'argv', [
        'export_model.py', name, '--checkpoint', ckpt, '--out', str(blob),
        '--img-hw', *map(str, HW), '--verify'])
    _jax_tool().main()
    want = jexport.deserialize(bytearray(blob.read_bytes())).call(
        jnp.asarray(s.img), *[jnp.asarray(m) for m in s.mods])
    det = Detector(s.model, get_experiment(name).data, torch.device('cpu'))
    torch.export.save(export_predict(det, 1, HW), tmp_path / 'model.pt2')
    port = torch.export.load(tmp_path / 'model.pt2').module()
    with torch.no_grad():
        got = port(torch.from_numpy(s.img), *s._tmods())
    assert_detections_close(got, want, s.jcfg.roi.max_per_img,
                            score_tol=1e-3)
