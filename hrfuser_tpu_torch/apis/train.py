"""Training API: LR schedule, AdamW with no-decay groups, train state and
step.

Counterpart of `hrfuser_tpu/apis/train.py` (the reference
`train_detector` mechanics, `mmdet/apis/train.py:71-203`): AdamW
(`optax.adamw`'s betas, eps 1e-8 and decoupled weight decay) without
decay on norms and RPE tables, step LR with linear warmup, and
`optax.apply_if_finite(max_consecutive_errors=25)`: a step whose
gradients hold a non-finite value is skipped, unless it is past the 25th
such step in a row. As in optax, where the schedule's count lives in
the inner optimizer state, a skipped step does not advance the LR
schedule (nor Adam's bias correction).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from hrfuser_tpu_torch.configs import OptimCfg, ScheduleCfg
from hrfuser_tpu_torch.core.samplers import Draws
from hrfuser_tpu_torch.core.targets import AssignSampleCfg
from hrfuser_tpu_torch.models.detectors.train_loss import forward_train

Tensor = torch.Tensor

MAX_CONSECUTIVE_ERRORS = 25


def make_lr_schedule(optim: OptimCfg, sched: ScheduleCfg,
                     steps_per_epoch: int) -> Callable[[int], float]:
    """LR at an applied-update count: x0.1 at each of `lr_steps` epochs,
    and the linear warmup lr * (1 - (1 - ratio) * (1 - t / warmup)) over
    the first `warmup_iters` (`configs/_base_/schedules/schedule_1x.py`),
    in float32 operation by operation as the JAX schedule computes it."""
    boundaries = [s * steps_per_epoch for s in sched.lr_steps]
    f32 = np.float32

    def schedule(count: int) -> float:
        factor = f32(1.0)
        for b in boundaries:
            factor = factor * f32(0.1) if count >= b else factor
        t = f32(min(count, sched.warmup_iters))
        warm = f32(1.0) - f32(1.0 - sched.warmup_ratio) * (
            f32(1.0) - t / f32(max(sched.warmup_iters, 1)))
        return float(f32(optim.lr) * factor * warm)

    return schedule


def _no_decay(name: str, module: nn.Module, keys: Sequence[str]) -> bool:
    """The JAX `_decay_mask` rule on the port's names: a key found in the
    parameter's path, where BatchNorm modules are named `bn` / `norm` and
    LayerNorms `norm*` in the JAX tree."""
    path = [name.lower()]
    if isinstance(module, nn.BatchNorm2d):
        path += ['norm', 'bn']
    elif isinstance(module, nn.LayerNorm):
        path += ['norm']
    return any(k in p for p in path for k in keys)


def decay_groups(model: nn.Module, no_decay_keys: Sequence[str]
                 ) -> Tuple[List[str], List[str]]:
    """(decayed, not decayed) parameter names of `model`."""
    decay, no_decay = [], []
    for mname, module in model.named_modules():
        for pname, _ in module.named_parameters(recurse=False):
            name = f'{mname}.{pname}' if mname else pname
            (no_decay if _no_decay(name, module, no_decay_keys)
             else decay).append(name)
    return decay, no_decay


def make_optimizer(model: nn.Module, optim: OptimCfg) -> torch.optim.AdamW:
    decay, no_decay = decay_groups(model, optim.no_decay_keys)
    params = dict(model.named_parameters())
    groups = [{'params': [params[n] for n in decay],
               'weight_decay': optim.weight_decay},
              {'params': [params[n] for n in no_decay], 'weight_decay': 0.0}]
    return torch.optim.AdamW(groups, lr=optim.lr, betas=tuple(optim.betas),
                             eps=1e-8)


@dataclasses.dataclass
class TrainState:
    """The model and optimizer with the step counters: `step` counts every
    step, `applied` the updates applied (the schedule's count), and
    `notfinite_count` / `total_notfinite` the skipped steps in a row and
    in all, as `optax.ApplyIfFiniteState` does."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0
    applied: int = 0
    notfinite_count: int = 0
    total_notfinite: int = 0

    COUNTERS = ('step', 'applied', 'notfinite_count', 'total_notfinite')

    def counters(self) -> Dict[str, int]:
        return {k: getattr(self, k) for k in self.COUNTERS}

    def load_counters(self, counters: Dict[str, int]) -> None:
        for k in self.COUNTERS:
            setattr(self, k, int(counters[k]))


def create_train_state(model: nn.Module, optim: OptimCfg,
                       sched: ScheduleCfg, steps_per_epoch: int
                       ) -> TrainState:
    """Put `model` in training mode and wrap it with its AdamW."""
    model.train()
    return TrainState(model, make_optimizer(model, optim),
                      make_lr_schedule(optim, sched, steps_per_epoch))


# what `forward_train` reads of a batch
STEP_KEYS = ('img', 'mod_imgs', 'gt_boxes', 'gt_labels', 'gt_valid',
             'img_shapes')


def batch_to(batch: Dict, device) -> Dict:
    """The arrays a train step reads (`STEP_KEYS`; numpy arrays or
    tensors, `mod_imgs` a list of them) as tensors on `device`. The rest
    of a loader batch (`metas`, `num_real`, `scale_factors`) stays on the
    host, out of the result."""
    def move(x):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                               else x).to(device)
    out = {}
    for k in STEP_KEYS:
        v = batch.get(k)
        if v is not None:
            out[k] = [move(m) for m in v] if k == 'mod_imgs' else move(v)
    return out


def _all_finite(grads: List[Tensor]) -> bool:
    return bool(torch.cat([g.reshape(-1) for g in grads]).isfinite().all())


def apply_gradients(state: TrainState) -> bool:
    """One AdamW update from the parameters' `.grad`, unless a gradient
    holds a non-finite value and fewer than 26 steps in a row did
    (`optax.apply_if_finite`); counts the step. Returns whether the update
    was applied."""
    opt = state.optimizer
    params = [p for g in opt.param_groups for p in g['params']]
    for p in params:               # optax updates every leaf, zero or not
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    finite = _all_finite([p.grad for p in params])
    state.notfinite_count = 0 if finite else state.notfinite_count + 1
    state.total_notfinite += 0 if finite else 1
    apply = finite or state.notfinite_count > MAX_CONSECUTIVE_ERRORS
    if apply:
        lr = state.schedule(state.applied)
        for g in opt.param_groups:
            g['lr'] = lr
        opt.step()
        state.applied += 1
    state.step += 1
    return apply


def train_step(state: TrainState, batch: Dict,
               generator: Optional[torch.Generator] = None,
               rpn_proposal_cfg: Optional[dict] = None,
               rcnn_train_cfgs: Optional[Sequence[AssignSampleCfg]] = None,
               draws: Optional[Draws] = None) -> Dict[str, Tensor]:
    """Loss, gradients and `apply_gradients`; returns the loss dict,
    detached. The sampler keys and drop draws come from `draws`, by
    default drawn from `generator`."""
    model = state.model
    state.optimizer.zero_grad(set_to_none=True)
    losses = forward_train(model, batch_to(batch, next(
        model.parameters()).device), draws or Draws(generator),
        rpn_proposal_cfg, rcnn_train_cfgs)
    losses['loss'].backward()
    apply_gradients(state)
    return {k: v.detach() for k, v in losses.items()}
