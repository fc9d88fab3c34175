"""`print_config` and `publish_model` of the port against the JAX tools.

  * `hrfuser_tpu_torch.tools.print_config` prints, byte for byte, what
    `tools/print_config.py` prints for every name `list_configs()` gives,
    as text and as `--json`, and the same `--list`.
  * `hrfuser_tpu_torch.tools.publish_model` on a port checkpoint whose
    `state_dict` is `state_dict_from_jax` of random `tiny_fusion_test`
    variables, with an AdamW state, a step and trainer counters, keeps
    what `tools/publish_model.py` keeps of an orbax checkpoint of the
    same variables: the published `state_dict` is `state_dict_from_jax`
    of the JAX tool's published tree, bit for bit. The file holds no
    optimizer, its name ends in the digest of its tensors, it loads with
    `load_weights`, and a changed weight changes the digest.

The JAX tools are loaded by path (`tools/` has no `__init__.py`).
"""

import contextlib
import importlib.util
import io
import os
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from hrfuser_tpu.configs import get_config as jax_get_config
from hrfuser_tpu.models import CascadeRCNN as JaxCascadeRCNN
from hrfuser_tpu_torch.apis.train import make_optimizer
from hrfuser_tpu_torch.configs import get_experiment, list_configs
from hrfuser_tpu_torch.models.detectors.cascade_rcnn import CascadeRCNN
from hrfuser_tpu_torch.tools import print_config, publish_model
from hrfuser_tpu_torch.utils.checkpoint import load_weights, save_checkpoint
from hrfuser_tpu_torch.utils.jax_weights import state_dict_from_jax
from tests.oracles.random_variables import random_variables
from tests.oracles.threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAME = 'tiny_fusion_test'


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f'jax_{name}', ROOT / 'tools' / f'{name}.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


@pytest.fixture(scope='module')
def jax_print_config():
    tool = _jax_tool('print_config')

    def run(argv):
        saved = sys.argv
        sys.argv = ['print_config.py', *argv]
        try:
            return _stdout(tool.main)
        finally:
            sys.argv = saved
    return run


@pytest.mark.parametrize('flags', [[], ['--json']], ids=['text', 'json'])
def test_print_config_is_the_jax_tools_for_every_name(flags,
                                                      jax_print_config):
    names = list_configs()
    assert len(names) == 22
    for name in names:
        assert (_stdout(print_config.main, [name, *flags])
                == jax_print_config([name, *flags])), name


def test_print_config_lists_the_jax_names(jax_print_config):
    want = jax_print_config(['--list'])
    assert _stdout(print_config.main, ['--list']) == want
    assert _stdout(print_config.main, []) == want == jax_print_config([])


def test_print_config_adds_only_the_jax_routing_knobs():
    """Every field the port's config has is in the tree as it is; the
    JAX-only knobs come on top."""
    tree = print_config.to_tree(get_experiment(NAME))
    assert tree['seed'] == 0 and tree['name'] == NAME
    bb = tree['model']['backbone']
    assert (bb['remat'], bb['cf_layout'], bb['chain_kernel']) == (
        False, 'auto', 'auto')
    roi = tree['model']['roi']
    assert (roi['max_grid'], roi['pool_method_eval'],
            roi['pallas_variant']) == (4, 'pallas', 'v7')
    assert roi['max_per_img'] == get_experiment(NAME).model.roi.max_per_img


@pytest.fixture(scope='module')
def variables():
    det = JaxCascadeRCNN(jax_get_config(NAME).model)
    img = jnp.zeros((1, 64, 96, 3))
    return random_variables(det, img, [img, img], False, seed=2)


def _port_checkpoint(tmp_path, sd, cfg):
    """A trainer's checkpoint: `sd`, an AdamW state after one step (taken
    on a copy, so `sd` is what is saved), a step, meta and counters."""
    model = CascadeRCNN(cfg)
    model.load_state_dict(sd)
    opt = make_optimizer(model, get_experiment(NAME).optim)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    return save_checkpoint(str(tmp_path / 'work'), 7, sd, opt,
                           meta={'config': NAME},
                           extra={'applied': 7, 'notfinite_count': 0})


def test_publish_model_keeps_what_the_jax_tool_keeps(tmp_path, variables,
                                                     capsys):
    cfg = get_experiment(NAME).model
    # the JAX tool on an orbax training checkpoint of the variables
    jax_ckpt = str(tmp_path / 'jax' / 'step_7')
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(jax_ckpt, {
        'params': variables['params'],
        'batch_stats': variables['batch_stats'],
        'opt_state': {'count': np.asarray(7),
                      'mu': np.ones((3, 4), np.float32)},
        'step': np.asarray(7)})
    ckptr.wait_until_finished()
    saved = sys.argv
    sys.argv = ['publish_model.py', jax_ckpt, str(tmp_path / 'jax' / 'rel')]
    try:
        out = _stdout(_jax_tool('publish_model').main)
    finally:
        sys.argv = saved
    jax_out = out.split('[publish] ')[1].strip()
    with ocp.PyTreeCheckpointer() as loader:
        released = loader.restore(jax_out)
    assert set(released) == {'params', 'batch_stats'}

    sd = state_dict_from_jax(variables, cfg)
    ckpt = _port_checkpoint(tmp_path, sd, cfg)
    assert 'optimizer' in torch.load(ckpt, weights_only=True)
    publish_model.main([ckpt, str(tmp_path / 'rel')])
    path = capsys.readouterr().out.split('[publish] ')[1].strip()
    payload = torch.load(path, weights_only=True)
    assert set(payload) == {'state_dict', 'meta'}
    got, want = payload['state_dict'], state_dict_from_jax(released, cfg)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k

    digest = publish_model.digest(got)
    assert path == os.path.abspath(f'{tmp_path / "rel"}-{digest}.pth')
    assert len(digest) == 8 and int(digest, 16) >= 0
    model = load_weights(path, CascadeRCNN(cfg))
    assert all(torch.equal(v, got[k]) for k, v in model.state_dict().items())

    changed = dict(got)
    k = next(iter(changed))
    changed[k] = changed[k].clone()
    changed[k].view(-1)[0] += 1e-3
    assert publish_model.digest(changed) != digest
