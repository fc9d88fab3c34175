"""The data-parallel train step (`parallel/api.py`) against the
one-process step on the joined batch, and against JAX's sharded step.

Two `gloo` ranks on the CPU (spawned, one intra-op thread each, a
deadline of `DEADLINE_S`) take 2 images each of a joined batch of 4 at
64x96; rank 1's two images have no valid GT (a `gt_valid` row all
false), so per-rank loss factors or a per-rank clamp would show. Drop
path and `proj_drop` are off; the sampler keys are JAX's split chain for
the joined batch (`JaxDraws`), recorded from the one-process run and
replayed by each rank at its images' global indices. Weights are the
port's seeded init (`tiny_fusion_test`, `tiny_hrnet_fusion_test`).

The trunk runs in float64 (the model and batch cast; LayerNorm, the
heads and the bf16 RoI gather stay float32 by design). In float32 a
1e-7 change of one RPN score, which another batch layout gives (the
per-rank batch sums BN's statistics in another order), can swap a
proposal at the top-k / NMS cut; the sampler's per-position keys then
pick other RoIs, and the step moves by O(1e-2). In float64 that does
not happen, so the comparison is of the arithmetic. Measured (one
thread a process): the 2-rank step against one process on the joined
batch 1.0e-7 (losses, relative), 1.2e-7 (all gradients together,
relative L2), 1.9e-7 (worst single gradient, norm floored at 1e-3 of
the largest), 5.0e-15 (BN running statistics, relative to 1 + |max|),
the same as one process against itself on the batch's rows in another
order (1.0e-7, 1.7e-7, 2.9e-7, 1.7e-15); with four threads a process,
where the CPU's float32 kernels block a batch of 2 and one of 4
differently, up to 7.2e-6, 4.0e-4, 1.6e-3 and 4.4e-15. The bars, about
ten times the four-thread figures: losses 1e-4, gradients 4e-3 together
and 1e-2 each, statistics 1e-10, and params after one AdamW step within
2 x lr (and 1e-6 relative: a near-zero gradient of opposite sign moves
a param +lr on one side and -lr on the other). With SyncBN or the
global loss factors knocked out, the same comparison misses by O(1)
(gradients 0.93-1.17 together, losses 0.12-1.32).

The BN running statistics end bit-identical on the two ranks, and a
world of one rank is the plain `train_step` bit for bit. `slow`: the
float32 2-rank step against JAX's `make_sharded_train_step` on a
2-device virtual CPU mesh, from the same JAX weights: the RPN losses at
PR 7's 1e-4 and the BN running statistics at its 3e-5 (both fixed
before any proposal is cut), params within 2 x lr; the cascade's losses
within 1e-2 and its accuracies within 2 of 128 RoIs, because JAX's own
sharded step moves that far from its one-device step on this batch
(2-device against 1-device, measured: s0.loss_cls 1.9e-3, s2.loss_cls
3.0e-3, the total 9.2e-4, s2.acc one RoI of 128; the RPN losses 1e-6):
a proposal swapped at the cut.
"""

# before any test runs: `tests/test_stf_io.py` puts `tools/` (which holds
# a `profile.py`) first on `sys.path`, and torch imports `cProfile`, and
# through it `profile`, when it builds its first optimizer
import cProfile  # noqa: F401
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrfuser_tpu.apis.train import create_train_state as jax_create_state
from hrfuser_tpu.configs import get_config as jax_get_config
from hrfuser_tpu.core.targets import RCNN_TRAIN_CFGS as JAX_RCNN_CFGS
from hrfuser_tpu.models import CascadeRCNN as JaxCascadeRCNN
from hrfuser_tpu.parallel.api import make_sharded_train_step as jax_sharded
from hrfuser_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from hrfuser_tpu_torch.configs.presets import without_drops
from hrfuser_tpu_torch.layers import common
from hrfuser_tpu_torch.models.detectors.cascade_rcnn import CascadeRCNN
from hrfuser_tpu_torch.parallel.mesh import run_ranks
from hrfuser_tpu_torch.utils.jax_weights import state_dict_from_jax
from tests.oracles import parallel_ranks as pr
from tests.oracles.random_variables import random_variables
from tests.oracles.rank_path import stdlib_profile_path  # noqa: F401
from tests.test_torch_train_slice import JaxDraws

B, H, W = 4, 64, 96
DEADLINE_S = 240
LOSS_RTOL, GRAD_ALL, GRAD_EACH, STATS_TOL = 1e-4, 4e-3, 1e-2, 1e-10
F64 = dict(dtype=torch.float64)


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _one_process(name):
    """The joined batch (float64), the one-process step on it and its
    draws."""
    batch = pr.in_float64(pr.joined_batch())
    draws = pr.RecordingDraws(JaxDraws(jax.random.PRNGKey(7), B))
    return batch, pr.one_process_step(name, batch, draws,
                                      dtype=torch.float64), draws.table


@pytest.mark.parametrize('name', ['tiny_fusion_test',
                                  'tiny_hrnet_fusion_test'])
def test_two_ranks_equal_the_joined_batch(name):
    batch, want, table = _one_process(name)
    ranks = run_ranks(pr.sharded_train_rank, 2,
                      (name, [batch], [table], F64), timeout_s=DEADLINE_S)
    lr = 3e-4
    for got in ranks:
        m = pr.mismatch(got, want)
        assert m['losses'] < LOSS_RTOL and m['acc'] < LOSS_RTOL, m
        assert m['together'] < GRAD_ALL and m['each'] < GRAD_EACH, m
        assert m['stats'] < STATS_TOL, m
        assert m['params'] <= 2 * lr, m
        assert got['history'][0] == got['losses']
    a, b = (r['stats'] for r in ranks)
    assert all(np.array_equal(a[n], b[n]) for n in a)
    assert ranks[0]['losses'] == ranks[1]['losses']
    pa, pb = (r['params'] for r in ranks)
    assert all(np.array_equal(pa[n], pb[n]) for n in pa)


@pytest.mark.parametrize('knock_out', ['sync_bn', 'loss_factors'])
def test_the_check_fails_with_a_part_knocked_out(knock_out):
    name = 'tiny_fusion_test'
    batch, want, table = _one_process(name)
    ranks = run_ranks(pr.sharded_train_rank, 2,
                      (name, [batch], [table], dict(F64, knock_out=knock_out)),
                      timeout_s=DEADLINE_S)
    m = pr.mismatch(ranks[0], want)
    assert m['together'] > 10 * GRAD_ALL, m
    assert m['losses'] > 10 * LOSS_RTOL, m
    if knock_out == 'sync_bn':
        assert m['stats'] > 100 * STATS_TOL, m


def test_world_of_one_is_the_plain_step():
    name = 'tiny_fusion_test'
    batch, want, table = _one_process(name)
    (got,) = run_ranks(pr.sharded_train_rank, 1,
                       (name, [batch], [table], F64), timeout_s=DEADLINE_S)
    assert got['losses'] == want['losses']
    for part in ('grads', 'params', 'stats'):
        assert set(got[part]) == set(want[part])
        for n, v in want[part].items():
            np.testing.assert_array_equal(got[part][n], v, err_msg=n)


@pytest.mark.parametrize('name', ['tiny_fusion_test', 'tiny_hrnet_fusion_test',
                                  'micro_fusion_dryrun'])
def test_every_train_batch_norm_goes_through_batch_norm_train(
        name, monkeypatch):
    """SyncBN lives in `batch_norm_train`: every BatchNorm the train
    forward runs must reach it (the HRFormer and modality stems, HRNet,
    CrossFFN's `run_seq`, transitions and fuse paths)."""
    from hrfuser_tpu_torch.configs import get_experiment
    exp = get_experiment(name)
    model = CascadeRCNN(without_drops(exp.model)).train()
    seen, real = set(), common.batch_norm_train

    def spy(x, bn):
        seen.add(id(bn))
        return real(x, bn)

    monkeypatch.setattr(common, 'batch_norm_train', spy)
    calls, functional = [], torch.nn.functional.batch_norm

    def counted(*a, **k):
        calls.append(1)
        return functional(*a, **k)

    monkeypatch.setattr(torch.nn.functional, 'batch_norm', counted)
    batch = pr.joined_batch(mod_channels=exp.model.backbone.mod_in_channels)
    with torch.no_grad():
        model.forward_features(torch.from_numpy(batch['img'][:2]),
                               [torch.from_numpy(m[:2])
                                for m in batch['mod_imgs']])
    bns = {id(m): n for n, m in model.named_modules()
           if isinstance(m, torch.nn.BatchNorm2d)}
    # the BN beside the stage-2 transition's conv, which the forward skips
    # (`transition1[0]`; `tests/test_torch_train_slice.py:PORT_ONLY`)
    assert sorted(bns[i] for i in set(bns) - seen) == [
        'backbone.transition1.0.1']
    assert len(calls) == len(seen)          # no BN outside the spy


def _jax_pair(name):
    jcfg = jax_get_config(name)
    model = without_drops(jcfg.model)
    model = dataclasses.replace(model, roi=dataclasses.replace(
        model.roi, gather_bf16=False))
    det = JaxCascadeRCNN(model)
    x = jnp.zeros((1, H, W, 3), jnp.float32)
    variables = random_variables(det, x, [x, x], False, seed=5)
    return jcfg, det, variables


@pytest.mark.slow
def test_two_ranks_equal_jax_sharded_step():
    name = 'tiny_fusion_test'
    jcfg, det, variables = _jax_pair(name)
    from hrfuser_tpu_torch.configs import get_experiment
    cfg = get_experiment(name).model
    sched = dataclasses.replace(jcfg.schedule, warmup_iters=0,
                                warmup_ratio=1.0)
    state, tx = jax_create_state(det, variables, jcfg.optim, sched, 100)
    mesh = make_mesh(2)
    caps = tuple(dataclasses.replace(c, num=32) for c in JAX_RCNN_CFGS)
    step = jax_sharded(det, tx, mesh, rpn_proposal_cfg=pr.PROPOSALS,
                       rcnn_train_cfgs=caps)
    batch = pr.joined_batch()
    jbatch = shard_batch(mesh, {k: ([jnp.asarray(m) for m in v]
                                    if isinstance(v, list) else jnp.asarray(v))
                                for k, v in batch.items()})
    rng = jax.random.PRNGKey(7)
    new, metrics = step(replicate(mesh, state), jbatch,
                        replicate(mesh, rng))
    # the step folds its count into the key before splitting it
    draws = pr.RecordingDraws(JaxDraws(jax.random.fold_in(rng, 0), B))
    sd = {k: v.numpy() for k, v in state_dict_from_jax(variables,
                                                       cfg).items()}
    pr.one_process_step(name, batch, draws, state_dict=sd)   # records keys
    ranks = run_ranks(pr.sharded_train_rank, 2,
                      (name, [batch], [draws.table],
                       dict(state_dict=sd, f32_pool=True)),
                      timeout_s=DEADLINE_S)
    got = ranks[0]
    for k, v in metrics.items():
        if k.startswith('loss_rpn'):          # before any proposal is cut
            np.testing.assert_allclose(got['losses'][k], float(v), rtol=1e-4,
                                       atol=1e-7, err_msg=k)
        elif k.endswith('acc'):               # one RoI in 128 may flip
            assert abs(got['losses'][k] - float(v)) <= 2 / 128, k
        else:
            np.testing.assert_allclose(got['losses'][k], float(v), rtol=1e-2,
                                       err_msg=k)
    want = {k: np.asarray(v) for k, v in state_dict_from_jax(
        {'params': jax.device_get(new.params),
         'batch_stats': jax.device_get(new.batch_stats)}, cfg).items()}
    for n, v in got['stats'].items():
        np.testing.assert_allclose(v, want[n], rtol=3e-5, atol=3e-5,
                                   err_msg=n)
    for n, v in got['params'].items():
        if n in want:
            np.testing.assert_allclose(v, want[n], rtol=1e-6, atol=2 * 3e-4,
                                       err_msg=n)
