"""Data-parallel dry run: one sharded train step and one sharded predict.

Counterpart of `__graft_entry__.py:dryrun_multichip(n)`: the
`micro_fusion_dryrun` model (every train-step path at the smallest
widths), one image a rank at 64x96, the JAX dry run's caps (64
proposals, 32 RoIs a stage) and its batch (N(0, 1) images and sensor
streams from seed 0, two fixed boxes an image). Weights are drawn from
seed 0 as `init_detector` draws them. Each rank checks a finite loss and
the joined batch's detections (`boxes.shape[0] == n`, finite scores);
rank 0 prints its progress as the JAX dry run does.

    python -m hrfuser_tpu_torch.parallel.dryrun --ranks 2
    python -m hrfuser_tpu_torch.parallel.dryrun --ranks 2 --device cuda:0 \\
        --backend gloo          # two ranks sharing one card
    python -m hrfuser_tpu_torch.parallel.dryrun --ranks 2 --device cpu

The default, `cuda`, puts rank r on `cuda:r` (`nccl`) and needs a card
a rank: with fewer it raises before any rank starts, and never falls
back to the CPU. `cuda:k` puts every rank on card k, which only `gloo`
accepts; `--device cpu` spawns `gloo` ranks on the CPU.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from hrfuser_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT_S, run_ranks

CONFIG = 'micro_fusion_dryrun'
H, W = 64, 96
PROPOSALS = dict(nms_pre=64, max_per_img=64, nms_iou=0.7, min_bbox_size=0.0)


def dryrun_batch(b: int) -> dict:
    """The JAX dry run's batch of `b` images."""
    rng = np.random.default_rng(0)
    return dict(
        img=rng.normal(0, 1, (b, H, W, 3)).astype(np.float32),
        mod_imgs=[rng.normal(0, 1, (b, H, W, 3)).astype(np.float32)
                  for _ in range(2)],
        gt_boxes=np.tile(np.asarray([[[10., 10., 50., 40.],
                                      [30., 20., 80., 60.]]], np.float32),
                         (b, 1, 1)),
        gt_labels=np.tile(np.asarray([[1, 2]], np.int32), (b, 1)),
        gt_valid=np.ones((b, 2), bool))


def dryrun_rank(rank, world_size, address, device='cuda', backend=None):
    """One rank of the dry run; returns (loss, joined boxes' shape)."""
    from hrfuser_tpu_torch.apis.inference import Detector, init_weights_
    from hrfuser_tpu_torch.apis.train import create_train_state
    from hrfuser_tpu_torch.configs import get_experiment
    from hrfuser_tpu_torch.core.targets import AssignSampleCfg
    from hrfuser_tpu_torch.models.detectors.cascade_rcnn import CascadeRCNN
    from hrfuser_tpu_torch.parallel.api import (make_sharded_predict,
                                                make_sharded_train_step)
    from hrfuser_tpu_torch.parallel.mesh import process_group, shard_rows
    t0 = time.time()

    def mark(what):
        if rank == 0:
            print(f'[dryrun +{time.time() - t0:6.1f}s] {what}', flush=True)

    if torch.device(device).type == 'cpu':
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    with process_group(device, backend, rank, world_size,
                       address=address) as group:
        mark(f'{world_size}-rank group up ({group.backend} on '
             f'{group.device})')
        exp = get_experiment(CONFIG)
        model = CascadeRCNN(exp.model)
        init_weights_(model, torch.Generator().manual_seed(0))
        state = create_train_state(model.to(group.device), exp.optim,
                                   exp.schedule, steps_per_epoch=100)
        step = make_sharded_train_step(
            state, group, seed=0, rpn_proposal_cfg=PROPOSALS,
            rcnn_train_cfgs=tuple(
                AssignSampleCfg(thr, thr, thr, False, 32, 0.25, True)
                for thr in (0.5, 0.6, 0.7)))
        b = world_size                       # one sample a rank
        batch = dryrun_batch(b)
        mark('weights broadcast; train step')
        loss = float(step(shard_rows(batch, group))['loss'])
        mark('train step executed')
        if not np.isfinite(loss):
            raise RuntimeError(f'non-finite loss {loss}')
        predict = make_sharded_predict(
            Detector(model.eval(), exp.data, group.device), group)
        with torch.no_grad():
            dets = predict(batch['img'], batch['mod_imgs'],
                           np.tile(np.asarray([[H, W]], np.float32), (b, 1)),
                           np.ones((b, 4), np.float32))
        mark('predict executed')
        if dets.boxes.shape[0] != b or not np.isfinite(dets.scores).all():
            raise RuntimeError(f'predict gave boxes {dets.boxes.shape}, '
                               f'finite scores '
                               f'{bool(np.isfinite(dets.scores).all())}')
        if rank == 0:
            print(f'dryrun({world_size}): ok, loss={loss:.4f}, eval '
                  f'boxes={tuple(dets.boxes.shape)}', flush=True)
        return loss, tuple(dets.boxes.shape)


def check_cards(n: int, device) -> None:
    """Raise unless `device` can hold `n` ranks: `cuda` needs `n` cards
    (rank r on `cuda:r`), `cuda:k` needs card k."""
    device = torch.device(device)
    if device.type != 'cuda':
        return
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    need = n if device.index is None else device.index + 1
    if have < need:
        raise RuntimeError(
            f'dry run on {device} with {n} ranks needs {need} CUDA '
            f'device(s), {have} available; for ranks sharing one card pass '
            f'--device cuda:0 --backend gloo, for the CPU --device cpu')


def dryrun(n: int, device='cuda', backend=None,
           timeout_s: float = DEFAULT_TIMEOUT_S):
    """The dry run on `n` spawned ranks; rank 0's (loss, boxes' shape)."""
    check_cards(n, device)
    return run_ranks(dryrun_rank, n, (device, backend), timeout_s)[0]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--ranks', type=int, default=2)
    p.add_argument('--device', default='cuda')
    p.add_argument('--backend', default=None, choices=['nccl', 'gloo'])
    args = p.parse_args(argv)
    return dryrun(args.ranks, args.device, args.backend)


if __name__ == '__main__':
    main()
