"""`backbone.remat` (`tools.train --remat`): each HRModule and fusion block
of a training step rematerialised in the backward
(`layers/common.remat`, `torch.utils.checkpoint`), against the plain step.

The JAX package wraps the same modules in `nn.remat`
(`hrfuser_tpu/models/backbones/hr_modules.py:250-252`, `hrfuser.py:
75-76`), which changes no number. Here, on `tiny_fusion_test` (drop path
0.1 / 0.2 added to stage 2's blocks; the fusion blocks' drop path 0.2
and `proj_drop` 0.1 live) and `tiny_hrnet_fusion_test`, one step from the
same weights, batch and generator: the losses, every gradient, the
params after AdamW and the BN running statistics equal the plain step's
bit for bit; BatchNorm counts one update (`num_batches_tracked`); the
drop masks the recompute draws are the forward's; the generator ends
where the plain step leaves it. Two knock-outs show the checks see what
remat must get right: a generator state taken after the forward instead
of before (other masks in the recompute: the gradients move) and a
recompute that updates the running statistics again (they move, and
count two). Then two `gloo` ranks through `parallel/api.py` (SyncBN: the
recompute still all-reduces the batch statistics) equal the same two
ranks without remat.
"""

import contextlib
import dataclasses
import functools

import numpy as np
import pytest
import torch

from hrfuser_tpu_torch.apis.inference import init_weights_
from hrfuser_tpu_torch.apis.train import create_train_state, train_step
from hrfuser_tpu_torch.configs import get_experiment
from hrfuser_tpu_torch.core.samplers import Draws
from hrfuser_tpu_torch.layers import common
from hrfuser_tpu_torch.models.backbones import hr_modules
from hrfuser_tpu_torch.models.detectors.cascade_rcnn import CascadeRCNN
from hrfuser_tpu_torch.parallel.mesh import run_ranks
from tests.oracles import parallel_ranks as pr
from tests.oracles.rank_path import stdlib_profile_path  # noqa: F401
from tests.oracles.threads import one_torch_thread  # noqa: F401

NAMES = ['tiny_fusion_test', 'tiny_hrnet_fusion_test']


def _state(name, remat):
    exp = get_experiment(name)
    bb = exp.model.backbone
    if bb.stage2.block == 'HRFORMER':
        bb = dataclasses.replace(bb, stage2=dataclasses.replace(
            bb.stage2, drop_path_rates=(0.1, 0.2)))
    model = CascadeRCNN(dataclasses.replace(
        exp.model, backbone=dataclasses.replace(bb, remat=remat)))
    init_weights_(model, torch.Generator().manual_seed(0))
    sched = dataclasses.replace(exp.schedule, warmup_iters=0,
                                warmup_ratio=1.0)
    return create_train_state(model, exp.optim, sched, 100)


def _step(name, remat):
    """One step: its `step_result`, the BN update counts, the generator's
    state after it, the drop draws in order and HRModule forward calls."""
    state = _state(name, remat)
    gen = torch.Generator().manual_seed(3)
    draws, calls = [], [0]
    real_uniform, real_forward = common._uniform, hr_modules.HRModule.forward

    def uniform(shape, like):
        draws.append(real_uniform(shape, like).clone())
        return draws[-1]

    def forward(self, xs):
        calls[0] += 1
        return real_forward(self, xs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common, '_uniform', uniform)
        mp.setattr(hr_modules.HRModule, 'forward', forward)
        losses = train_step(state, pr.joined_batch(b=2, empty=()),
                            draws=Draws(gen), **pr.TRAIN_CAPS)
    tracked = {int(b) for n, b in state.model.named_buffers()
               if n.endswith('num_batches_tracked')}
    return dict(pr.step_result(state, losses), tracked=tracked,
                gen=gen.get_state(), draws=draws, calls=calls[0])


@functools.cache
def _plain_step(name):
    return _step(name, False)


def _equal(a, b):
    assert a['losses'] == b['losses']
    for part in ('grads', 'params', 'stats'):
        assert set(a[part]) == set(b[part])
        for n, v in a[part].items():
            np.testing.assert_array_equal(b[part][n], v, err_msg=n)


@pytest.mark.parametrize('name', NAMES)
def test_remat_step_equals_the_plain_step(name):
    plain, remat = _plain_step(name), _step(name, True)
    _equal(plain, remat)
    assert plain['tracked'] == remat['tracked'] == {0, 1}
    assert torch.equal(plain['gen'], remat['gen'])
    # every module ran again in the backward, drawing the same masks
    assert remat['calls'] == 2 * plain['calls'] > 0
    n = len(plain['draws'])
    assert n > 0 and len(remat['draws']) > n
    for a, b in zip(plain['draws'], remat['draws'][:n]):
        assert torch.equal(a, b)
    for d in remat['draws'][n:]:
        assert any(d.shape == s.shape and torch.equal(d, s)
                   for s in plain['draws'])


@contextlib.contextmanager
def _late_snapshot(self):
    yield
    self.state = self.generator.get_state()


@contextlib.contextmanager
def _recompute_updating_statistics(self):
    g = self.generator
    later = g.get_state()
    token = common._GENERATOR.set(g)
    g.set_state(self.state)
    try:
        yield
    finally:
        g.set_state(later)
        common._GENERATOR.reset(token)


@pytest.mark.parametrize('knock_out', ['late_snapshot', 'statistics_twice'])
def test_the_checks_see_a_broken_remat(knock_out, monkeypatch):
    plain = _plain_step('tiny_fusion_test')
    if knock_out == 'late_snapshot':
        monkeypatch.setattr(common._Replay, 'forward', _late_snapshot)
    else:
        monkeypatch.setattr(common._Replay, 'recompute',
                            _recompute_updating_statistics)
    broken = _step('tiny_fusion_test', True)
    m = pr.mismatch(broken, plain)
    if knock_out == 'late_snapshot':
        assert m['together'] > 1e-2, m
    else:
        assert m['stats'] > 1e-4, m
        assert broken['tracked'] == {0, 1, 2}


def test_two_ranks_with_remat_equal_two_ranks_without():
    """SyncBN under remat: the recompute all-reduces the batch statistics
    again (the ranks' collectives stay matched) and updates nothing."""
    ranks = run_ranks(pr.remat_pair_rank, 2,
                      ('tiny_fusion_test', pr.joined_batch()), timeout_s=240)
    for got in ranks:
        _equal(got[False], got[True])
        assert got[False]['tracked'] == got[True]['tracked'] == {0, 1}
    a, b = (r[True]['stats'] for r in ranks)
    assert all(np.array_equal(a[n], b[n]) for n in a)
