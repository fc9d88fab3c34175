"""Data-parallel train step and predict.

Counterpart of `hrfuser_tpu/parallel/api.py`. JAX jits the one-device
step over a batch-sharded mesh, so its step is exactly the step on the
joined batch. The port gets the same from explicit collectives: N ranks
with B / N images each compute the step that one process computes on
the joined batch of B (within the float32 spread of another batch
layout):
  * BatchNorm takes the joined batch's statistics (`sync_batch_norm`);
  * every loss divides by its factor summed over the ranks, and the
    sampler keys are those of the joined batch's images
    (`forward_train(..., group)`, `KeyedDraws`);
  * the gradients are summed over the ranks in one all-reduce of a flat
    buffer (a sum, not a mean: each rank's loss is already its share of
    the joined batch's), so `apply_gradients` decides alike everywhere.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from hrfuser_tpu_torch.apis.train import (TrainState, apply_gradients,
                                          batch_to)
from hrfuser_tpu_torch.core.samplers import Draws, KeyedDraws
from hrfuser_tpu_torch.core.targets import AssignSampleCfg
from hrfuser_tpu_torch.layers.common import sync_batch_norm
from hrfuser_tpu_torch.models.detectors.train_loss import forward_train
from hrfuser_tpu_torch.models.roi_heads.cascade_roi_head import Detections
from hrfuser_tpu_torch.parallel.mesh import (Group, gather, local_rows,
                                             sum_over_ranks)

Tensor = torch.Tensor


def broadcast_weights(model: torch.nn.Module, group: Group) -> None:
    """Rank 0's parameters and buffers on every rank."""
    if group.world_size > 1:
        for t in itertools.chain(model.parameters(), model.buffers()):
            dist.broadcast(t.data, 0)


def sum_gradients(params: Sequence[Tensor], group: Group) -> Tensor:
    """Sum every parameter's gradient over the ranks in one all-reduce of
    a flat buffer (a missing gradient counts as zeros); each `.grad`
    becomes a view of the buffer, which is returned."""
    flat = torch.cat([torch.zeros(p.numel(), dtype=p.dtype, device=p.device)
                      if p.grad is None else p.grad.reshape(-1)
                      for p in params])
    dist.all_reduce(flat)
    offset = 0
    for p in params:
        p.grad = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()
    return flat


def make_sharded_train_step(
        state: TrainState, group: Group, seed: int = 0,
        rpn_proposal_cfg: Optional[dict] = None,
        rcnn_train_cfgs: Optional[Sequence[AssignSampleCfg]] = None):
    """A train step over `group`: `step(batch, draws=None)` takes this
    rank's rows of the joined batch (numpy arrays or tensors) and returns
    the joined batch's loss dict, detached and the same on every rank.

    Rank 0's weights are broadcast once, here. By default each step's
    sampler keys are `KeyedDraws` from a key drawn from `seed` alike on
    every rank; dropout and drop path draw from a generator seeded from
    (`seed`, rank). `draws` replaces both (keyed by the joined batch's
    image index). The caps override the reference's as in `train_step`.
    """
    model = state.model
    broadcast_weights(model, group)
    params = [p for g in state.optimizer.param_groups for p in g['params']]
    keys = torch.Generator().manual_seed(seed)
    drop = torch.Generator(group.device).manual_seed(
        seed * 1_000_003 + group.rank)

    def step(batch: Dict, draws: Optional[Draws] = None) -> Dict[str, Tensor]:
        if draws is None:
            draws = KeyedDraws(int(torch.randint(2**62, (), generator=keys)),
                               drop)
        state.optimizer.zero_grad(set_to_none=True)
        with sync_batch_norm(group):
            losses = forward_train(model, batch_to(batch, group.device),
                                   draws, rpn_proposal_cfg, rcnn_train_cfgs,
                                   group)
        losses['loss'].backward()
        sum_gradients(params, group)
        apply_gradients(state)
        shares = [k for k in losses if not k.endswith('acc')]
        summed = sum_over_ranks(torch.stack(
            [losses[k].detach() for k in shares]), group)
        out = {k: v.detach() for k, v in losses.items()}
        out.update(zip(shares, summed.unbind()))
        return out

    return step


def make_sharded_predict(detector, group: Group):
    """Predict over a joined batch: the batch is padded to a multiple of
    the world size by repeating its last row (as JAX pads it), each rank
    runs its rows, and every rank gets the joined batch's `Detections`
    as host numpy arrays, the padding dropped."""

    def predict(img, mod_imgs=None, img_shapes=None, scale_factors=None
                ) -> Detections:
        b = len(img)
        idx = np.concatenate([np.arange(b),
                              np.full(-b % group.world_size, b - 1)])

        def mine(x):
            if x is None:
                return None
            x = x[torch.as_tensor(idx)] if torch.is_tensor(x) else \
                np.asarray(x)[idx]
            return local_rows(x, group)

        out = detector(mine(img), [mine(m) for m in mod_imgs or []] or None,
                       mine(img_shapes), mine(scale_factors))
        return Detections(*(a[:b] for a in gather(out, group)))

    return predict

