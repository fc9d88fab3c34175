"""Checkpoint save/load (`torch.save`) + metadata.

Port of `hrfuser_tpu/utils/checkpoint.py:22-93` (the mmcv
CheckpointHook/resume semantics) with the JAX package's on-disk layout:

    ckpt_dir/step_{N}.pth         {'state_dict', 'optimizer' (optional),
                                   'step', 'meta', 'extra' (optional)}
    ckpt_dir/step_{N}.meta.json   the meta dict, when there is one
    ckpt_dir/latest               'step_{N}', the newest checkpoint

`load_weights` restores weights only (`load_from`), `load_state`
weights, optimizer state and step (`resume_from`); `checkpoint_extra`
reads the `extra` dict a trainer saved beside them (its step counters).
Files are read with `torch.load(weights_only=True)`, which refuses
pickled objects other than tensors and plain containers; such a file
raises with the loader's reason and is never loaded unsafely. An orbax
(JAX) checkpoint needs orbax, which the port does not use.
"""

from __future__ import annotations

import json
import logging
import os
import os.path as osp
import pickle
from typing import Dict, Optional, Union

import torch
from torch import nn

log = logging.getLogger(__name__)


def _cpu_state(state: Union[nn.Module, Dict[str, torch.Tensor]]):
    sd = state.state_dict() if isinstance(state, nn.Module) else state
    return {k: v.detach().cpu() for k, v in sd.items()}


def save_checkpoint(ckpt_dir: str, step: int,
                    state: Union[nn.Module, Dict[str, torch.Tensor]],
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    meta: Optional[Dict] = None,
                    extra: Optional[Dict] = None) -> str:
    """Write `step_{step}.pth` (weights on the CPU) and point `latest` at
    it; returns its path. `extra` is a dict of plain values."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = osp.join(osp.abspath(ckpt_dir), f'step_{step}.pth')
    payload = {'state_dict': _cpu_state(state), 'step': int(step),
               'meta': meta or {}}
    if optimizer is not None:
        payload['optimizer'] = optimizer.state_dict()
    if extra is not None:
        payload['extra'] = extra
    torch.save(payload, path)
    if meta:
        with open(osp.join(ckpt_dir, f'step_{step}.meta.json'), 'w') as f:
            json.dump(meta, f)
    with open(osp.join(ckpt_dir, 'latest'), 'w') as f:
        f.write(f'step_{step}')
    return path


def _resolve(ckpt_path: str) -> str:
    """A checkpoint directory -> the `.pth` its `latest` names."""
    if osp.isfile(osp.join(ckpt_path, 'latest')):
        with open(osp.join(ckpt_path, 'latest')) as f:
            return osp.join(ckpt_path, f.read().strip() + '.pth')
    return ckpt_path


def _read(ckpt_path: str) -> dict:
    path = osp.abspath(_resolve(ckpt_path))
    try:
        return torch.load(path, map_location='cpu', weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(
            f'{path}: the safe loader (weights_only=True) refuses this '
            f'file: {e}') from e


def _state_dict_of(obj) -> Dict[str, torch.Tensor]:
    """The weights of a port checkpoint, a reference mmdet `.pth`
    (`{'state_dict': ..., 'meta': ...}`) or a bare state dict."""
    sd = obj.get('state_dict', obj) if isinstance(obj, dict) else None
    if not isinstance(sd, dict) or not all(
            isinstance(v, torch.Tensor) for v in sd.values()):
        raise ValueError('checkpoint holds no state dict of tensors')
    return sd


def _apply(sd: Dict[str, torch.Tensor], model: nn.Module,
           ckpt_path: str) -> None:
    want = model.state_dict()
    missing = [k for k in want if k not in sd]
    if missing:
        raise ValueError(
            f'checkpoint at {ckpt_path} is missing {len(missing)} keys '
            f'the model needs, e.g. {missing[:3]}')
    bad = [(k, tuple(sd[k].shape), tuple(v.shape)) for k, v in want.items()
           if sd[k].shape != v.shape]
    if bad:
        k, got, need = bad[0]
        raise ValueError(f'checkpoint at {ckpt_path}: {len(bad)} keys '
                         f'differ in shape, e.g. {k}: {got} != {need}')
    extra = len(sd) - len(want)
    if extra:
        log.warning('checkpoint at %s: dropped %d keys the model does not '
                    'use', ckpt_path, extra)
    model.load_state_dict({k: sd[k] for k in want})


def read_weights(ckpt_path: str) -> Dict[str, torch.Tensor]:
    """The state dict a checkpoint file (or directory) holds: a port
    checkpoint's, a reference mmdet `.pth`'s or a bare one, on the CPU."""
    return _state_dict_of(_read(ckpt_path))


def load_weights(ckpt_path: str, model: nn.Module) -> nn.Module:
    """Weights-only warm start of `model`, in place.

    Extra keys are dropped (a converted reference checkpoint may carry
    weights the port's forward does not use), and how many is logged. A
    key the model needs that the file lacks, or a shape that differs,
    raises `ValueError`.
    """
    _apply(read_weights(ckpt_path), model, ckpt_path)
    return model


def load_state(ckpt_path: str, model: nn.Module,
               optimizer: Optional[torch.optim.Optimizer] = None) -> int:
    """Full resume: weights into `model`, optimizer state into
    `optimizer`; returns the step."""
    obj = _read(ckpt_path)
    _apply(_state_dict_of(obj), model, ckpt_path)
    if optimizer is not None:
        if 'optimizer' not in obj:
            raise ValueError(f'checkpoint at {ckpt_path} has no optimizer '
                             f'state')
        optimizer.load_state_dict(obj['optimizer'])
    return int(obj['step'])


def checkpoint_extra(ckpt_path: str) -> Dict:
    """The `extra` dict saved with a checkpoint ({} if none)."""
    return _read(ckpt_path).get('extra', {})
