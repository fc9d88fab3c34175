"""The port's LR schedule, no-decay groups, AdamW and non-finite skips vs
the JAX package's `apis/train.py` and optax.

- LR at warmup, boundary and late counts vs `make_lr_schedule`, rtol
  1e-7 (both compute in float32);
- the no-decay parameter set vs `_decay_mask`'s masked leaves, carried to
  port names through `state_dict_from_jax` (equal sets);
- AdamW steps vs `optax.adamw` with the same mask on a toy tree, 1e-6;
- `apply_if_finite` vs `optax.apply_if_finite(max_consecutive_errors=25)`
  on the toy tree: a NaN step skipped without advancing the schedule,
  and the 26th NaN step in a row applied (NaN params on both sides).
"""

# before any test runs: `tests/test_stf_io.py` puts `tools/` (which holds
# a `profile.py`) first on `sys.path`, and torch imports `cProfile`, and
# through it `profile`, when it builds its first optimizer
import cProfile  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from hrfuser_tpu.apis.train import _decay_mask
from hrfuser_tpu.apis.train import make_lr_schedule as jax_schedule
from hrfuser_tpu.apis.train import make_optimizer as jax_make_optimizer
from hrfuser_tpu.configs import get_config as jax_get_config
from hrfuser_tpu.models import CascadeRCNN as JaxCascadeRCNN
from hrfuser_tpu_torch.apis.train import (TrainState, apply_gradients,
                                          decay_groups, make_lr_schedule,
                                          make_optimizer)
from hrfuser_tpu_torch.configs import OptimCfg, ScheduleCfg, get_experiment
from hrfuser_tpu_torch.utils.jax_weights import state_dict_from_jax
from tests.oracles.random_variables import random_variables


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """One intra-op thread: the tensors are small, and the test workers
    run side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('name', [
    'tiny_fusion_test', 'cascade_rcnn_hrfuser_t_1x_nus_r640_l_r_fusion',
    'cascade_rcnn_hrfuser_t_1x_stf_r1248_4mod'])
def test_lr_schedule_matches_jax(name):
    exp, ref = get_experiment(name), jax_get_config(name)
    ours = make_lr_schedule(exp.optim, exp.schedule, 100)
    want = jax_schedule(ref.optim, ref.schedule, 100)
    steps = [0, 1, 2, 250, 499, 500, 501, 799, 800, 801, 850, 1099, 1100,
             1150, 3999, 4000, 5000, 100000]
    for s in steps:
        np.testing.assert_allclose(ours(s), float(want(jnp.asarray(s))),
                                   rtol=1e-7, err_msg=f'count {s}')
    assert ours(0) == pytest.approx(
        exp.optim.lr * exp.schedule.warmup_ratio, rel=1e-4)
    assert ours(exp.schedule.warmup_iters) == pytest.approx(exp.optim.lr,
                                                             rel=1e-6)


def test_lr_schedule_values_of_the_jax_test():
    s = make_lr_schedule(OptimCfg(lr=3e-4),
                         ScheduleCfg(warmup_iters=500, warmup_ratio=1e-3,
                                     lr_steps=(8, 11)), steps_per_epoch=100)
    for count, lr in ((0, 3e-7), (500, 3e-4), (850, 3e-5), (1150, 3e-6)):
        assert abs(s(count) - lr) < 1e-9


@pytest.mark.parametrize('name', ['tiny_fusion_test', 'tiny_camera_test'])
def test_no_decay_set_equals_jax_mask(name):
    from hrfuser_tpu_torch.models.detectors.cascade_rcnn import CascadeRCNN
    exp = get_experiment(name)
    jdet = JaxCascadeRCNN(jax_get_config(name).model)
    bb = exp.model.backbone
    img = jnp.zeros((1, 64, 96, 3))
    mods = [jnp.zeros((1, 64, 96, c))
            for c in bb.mod_in_channels[:bb.num_fused_modalities]] or None
    variables = random_variables(jdet, img, mods, False)
    mask = _decay_mask(variables['params'], exp.optim.no_decay_keys)
    flags = jax.tree_util.tree_map(lambda m, p: np.full(p.shape, float(m)),
                                   mask, variables['params'])
    decayed = state_dict_from_jax({'params': flags,
                                   'batch_stats': variables['batch_stats']},
                                  exp.model)
    model = CascadeRCNN(exp.model)
    params = dict(model.named_parameters())
    # the parameters JAX has: all but the BN of the HRFuser stage-2
    # transition's conv, which the bridge fills with identity values
    port_only = {n for n in params if n.startswith('backbone.transition1.0.1.')
                 and bb.num_fused_modalities}
    want_nd = {n for n in params if n not in port_only
               and not decayed[n].bool().all()}
    assert all(decayed[n].bool().all() or not decayed[n].bool().any()
               for n in params if n not in port_only)
    decay, no_decay = decay_groups(model, exp.optim.no_decay_keys)
    assert set(no_decay) - port_only == want_nd
    assert set(decay) | set(no_decay) == set(params)
    assert len(want_nd) > 50


class Toy(nn.Module):
    """A decayed conv-like weight, a bias and a LayerNorm."""

    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(3, 4)
        self.norm = nn.LayerNorm(4)


def _toy(seed=0):
    m = Toy()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    return m


def _tree(m):
    return {k: jnp.array(v.detach().numpy()) for k, v in
            m.named_parameters()}


OPTIM = OptimCfg(lr=1e-2)
SCHED = ScheduleCfg(warmup_iters=3, warmup_ratio=0.1, lr_steps=(1,))


def _grad_seq(n, seed=1):
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in _toy().named_parameters()}
    return [{k: rng.normal(0, 1, s).astype(np.float32)
             for k, s in shapes.items()} for _ in range(n)]


def _run_both(grads):
    """Feed `grads` to the port's step and to optax's; return both
    parameter trees after each step and the port's state."""
    model = _toy()
    state = TrainState(model, make_optimizer(model, OPTIM),
                       make_lr_schedule(OPTIM, SCHED, 5))
    params = _tree(model)
    tx = jax_make_optimizer(OPTIM, SCHED, 5, params)
    opt_state = tx.init(params)
    out = []
    for g in grads:
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(g[k].copy())
        apply_gradients(state)
        upd, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   opt_state, params)
        params = optax.apply_updates(params, upd)
        out.append(({k: v.detach().numpy().copy()
                     for k, v in model.named_parameters()},
                    {k: np.asarray(v) for k, v in params.items()}))
    return out, state, opt_state


def test_adamw_steps_match_optax():
    out, state, _ = _run_both(_grad_seq(8))
    assert state.applied == 8 and state.step == 8
    for ours, want in out:
        for k in want:
            np.testing.assert_allclose(ours[k], want[k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)


def test_nonfinite_step_is_skipped_and_holds_the_schedule():
    grads = _grad_seq(4)
    grads[1] = {k: np.full_like(v, np.nan if k == 'fc.bias' else 1.0)
                for k, v in grads[1].items()}
    out, state, opt_state = _run_both(grads)
    np.testing.assert_array_equal(out[1][0]['fc.weight'],
                                  out[0][0]['fc.weight'])
    assert (state.step, state.applied, state.total_notfinite) == (4, 3, 1)
    assert int(opt_state.total_notfinite) == 1
    # the schedule counted applied updates only, as optax's inner count
    assert int(opt_state.inner_state[-1].count) == state.applied
    for ours, want in out:
        for k in want:
            np.testing.assert_allclose(ours[k], want[k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)


def test_gives_up_after_25_nonfinite_steps_in_a_row():
    nan = {k: np.full_like(v, np.nan) for k, v in _grad_seq(1)[0].items()}
    out, state, opt_state = _run_both([_grad_seq(1)[0]] + [nan] * 26)
    assert state.notfinite_count == 26 == int(opt_state.notfinite_count)
    assert state.applied == 2                       # the first and the 26th
    assert np.isfinite(out[25][0]['fc.weight']).all()
    assert np.isnan(out[26][0]['fc.weight']).all()
    assert np.isnan(out[26][1]['fc.weight']).all()
    np.testing.assert_allclose(out[25][0]['fc.weight'],
                               out[25][1]['fc.weight'], rtol=1e-6)
