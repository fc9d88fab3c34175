"""Training CLI.

Port of `tools/train.py` (the reference `tools/train.py`): a config name
builds the model (seeded random weights, or `--load-from` weights) and
trains it with the config's AdamW and LR schedule, logging every
`--log-interval` steps to `<work-dir>/train.log.json`, saving a
checkpoint (weights, optimizer and step counters) every
`--ckpt-interval-epochs` epochs and at the end; `--resume-from`
continues from one.

Dataset mode (`tools/train.py:138-210`): `--data-root` holds the train
split the converters write, `nuscenes_infos_train_mono3d.coco.json`
(nuScenes) or `dense_infos_train.pkl` (STF), and the files it names.
`DetDataLoader(train=True, seed=--seed)` gives the batches (flip, crops
and modality drop live), an epoch is `len(loader)` steps, and the LR
schedule's step boundaries count in those epochs.
`--eval-interval-epochs N` runs `run_inference` + `evaluate` on the val
split (`nuscenes_infos_val_mono3d.coco.json`, `dense_infos_val.pkl`)
with the weights of that moment every N epochs and appends the metrics
to the log (`mode: val`), as the JAX CLI's EvalHook does.

`--synthetic` cycles a pool of seeded batches (`synthetic_batches`, a
copy of `tools/train.py:65-96`), 100 steps an epoch; `--overfit-check`
trains on one of them and fails unless the mean of the last quarter of
the logged losses falls below 0.7 of the first.

    python -m hrfuser_tpu_torch.tools.train \\
        cascade_rcnn_hrfuser_t_1x_nus_r640_l_r_fusion \\
        --data-root data/nuscenes [--eval-interval-epochs 1]
    python -m hrfuser_tpu_torch.tools.train \\
        cascade_rcnn_hrfuser_t_1x_nus_r640_l_r_fusion --synthetic \\
        --max-iters 40 --overfit-check --log-interval 1
    python -m hrfuser_tpu_torch.tools.train tiny_fusion_test --synthetic \\
        --max-iters 4 --device cpu

It runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

SYNTHETIC_STEPS_PER_EPOCH = 100  # a synthetic "epoch", as in the JAX CLI


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Train a detector')
    p.add_argument('config', help='config name or path')
    p.add_argument('--data-root', default='')
    p.add_argument('--synthetic', action='store_true',
                   help='seeded random data (no dataset)')
    p.add_argument('--overfit-check', action='store_true',
                   help='with --synthetic: train on one fixed batch and '
                        'exit 1 unless the loss falls')
    p.add_argument('--max-iters', type=int, default=None)
    p.add_argument('--samples-per-device', type=int, default=None,
                   help="override the schedule's samples_per_device")
    p.add_argument('--img-hw', type=int, nargs=2, default=None,
                   help='override input H W (synthetic mode)')
    p.add_argument('--work-dir', default=None)
    p.add_argument('--load-from', default=None)
    p.add_argument('--resume-from', default=None)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--log-interval', type=int, default=50)
    p.add_argument('--ckpt-interval-epochs', type=int, default=1)
    p.add_argument('--eval-interval-epochs', type=int, default=0,
                   help='run val evaluation every N epochs (0 = off), '
                        'the EvalHook equivalent')
    p.add_argument('--device', default='cuda')
    return p.parse_args(argv)


def synthetic_batches(exp, batch_size, hw=None, pool: int = 4):
    """Cycle a pool of seeded batches: N(0, 1) images and sensor streams
    and two fixed gt boxes an image (`tools/train.py:65-96`)."""
    nmod = exp.model.backbone.num_fused_modalities
    if hw is None:
        w, h = exp.data.img_scale
        h, w = (h + 31) // 32 * 32, (w + 31) // 32 * 32
    else:
        h, w = hw
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(pool):
        batch = dict(
            img=rng.normal(0, 1, (batch_size, h, w, 3)).astype(np.float32),
            gt_boxes=np.tile(np.asarray(
                [[[10., 10., 100., 80.], [50., 30., 200., 160.]]],
                np.float32), (batch_size, 1, 1)),
            gt_labels=np.tile(np.asarray([[0, 1]], np.int32),
                              (batch_size, 1)),
            gt_valid=np.ones((batch_size, 2), bool))
        if nmod:
            batch['mod_imgs'] = [
                rng.normal(0, 1, (batch_size, h, w, c)).astype(np.float32)
                for c in exp.model.backbone.mod_in_channels]
        batches.append(batch)
    i = 0
    while True:
        yield dict(batches[i % pool])
        i += 1


def overfit_ratio(losses):
    """Mean of the last quarter of `losses` over the first."""
    tail = losses[-max(1, len(losses) // 4):]
    return float(np.mean(tail)) / losses[0]


def _dataset_batches(loader):
    """The loader's batches, epoch after epoch."""
    while True:
        yield from loader


def _evaluate(exp, model, args, batch_size, device):
    """Val metrics of `model`'s current weights (eval mode, float32,
    through the kernels on the card); leaves it in training mode."""
    from hrfuser_tpu_torch.apis.inference import Detector
    from hrfuser_tpu_torch.apis.test import evaluate, run_inference
    from hrfuser_tpu_torch.data.datasets import build_dataset
    from hrfuser_tpu_torch.data.loader import DetDataLoader
    val = build_dataset(exp.data, args.data_root, 'val')
    loader = DetDataLoader(val, exp.data, batch_size, train=False,
                           device=device)
    model.eval()
    try:
        results = run_inference(Detector(model, exp.data, device), loader)
    finally:
        model.train()
    return evaluate(exp, results, val)


def main(argv=None):
    args = parse_args(argv)
    from hrfuser_tpu_torch.apis.inference import init_weights_
    from hrfuser_tpu_torch.apis.train import create_train_state, train_step
    from hrfuser_tpu_torch.configs import get_experiment
    from hrfuser_tpu_torch.models.detectors.cascade_rcnn import CascadeRCNN
    from hrfuser_tpu_torch.utils.checkpoint import (checkpoint_extra,
                                                    load_state, load_weights,
                                                    save_checkpoint)

    exp = get_experiment(args.config)
    if args.samples_per_device:
        exp = dataclasses.replace(exp, schedule=dataclasses.replace(
            exp.schedule, samples_per_device=args.samples_per_device))
    work_dir = args.work_dir or os.path.join('work_dirs', exp.name)
    os.makedirs(work_dir, exist_ok=True)
    device = torch.device(args.device)
    batch_size = exp.schedule.samples_per_device
    print(f'[train] {exp.name} on {device}: batch {batch_size}')

    if args.synthetic:
        steps_per_epoch = SYNTHETIC_STEPS_PER_EPOCH
        batches = synthetic_batches(
            exp, batch_size, tuple(args.img_hw) if args.img_hw else None,
            pool=1 if args.overfit_check else 4)
    else:
        from hrfuser_tpu_torch.data.datasets import build_dataset
        from hrfuser_tpu_torch.data.loader import DetDataLoader
        dataset = build_dataset(exp.data, args.data_root, 'train')
        loader = DetDataLoader(dataset, exp.data, batch_size, train=True,
                               seed=args.seed, device=device)
        steps_per_epoch = len(loader)
        if not steps_per_epoch:
            raise SystemExit(f'[train] {len(dataset)} training images make '
                             f'no batch of {batch_size}')
        batches = _dataset_batches(loader)
        print(f'[train] {len(dataset)} images, {steps_per_epoch} steps an '
              f'epoch')

    model = CascadeRCNN(exp.model)
    init_weights_(model, torch.Generator().manual_seed(args.seed))
    if args.load_from:
        load_weights(args.load_from, model)
    model.to(device)
    print(f'[train] {sum(p.numel() for p in model.parameters()) / 1e6:.1f}M '
          f'params')
    state = create_train_state(model, exp.optim, exp.schedule,
                               steps_per_epoch)
    if args.resume_from:
        load_state(args.resume_from, model, state.optimizer)
        state.load_counters(checkpoint_extra(args.resume_from))
        print(f'[train] resumed at step {state.step}')
    gen = torch.Generator(device).manual_seed(args.seed + state.step)
    total = args.max_iters or steps_per_epoch * exp.schedule.max_epochs
    meta = dict(config=exp.name, classes=list(exp.data.classes))
    log_path = os.path.join(work_dir, 'train.log.json')

    def log_json(record):
        with open(log_path, 'a') as f:
            f.write(json.dumps(record) + '\n')

    def save():
        save_checkpoint(work_dir, state.step, model, state.optimizer, meta,
                        extra=state.counters())

    ckpt_every = steps_per_epoch * args.ckpt_interval_epochs
    eval_every = steps_per_epoch * args.eval_interval_epochs
    loss_history, t_log, n_log = [], time.perf_counter(), 0
    while state.step < total:
        metrics = train_step(state, next(batches), gen)
        n_log += 1
        if state.step % args.log_interval == 0 or state.step == total:
            m = {k: float(v) for k, v in metrics.items()}
            loss_history.append(m['loss'])
            dt, t_log = time.perf_counter() - t_log, time.perf_counter()
            ips = n_log * batch_size / max(dt, 1e-6)
            n_log = 0
            print(f'[iter {state.step}/{total}] {ips:.1f} img/s '
                  + ' '.join(f'{k}={v:.4f}' for k, v in sorted(m.items())))
            log_json(dict(mode='train', iter=state.step,
                          imgs_per_sec=round(ips, 2), **m))
            if not np.isfinite(m['loss']):
                raise RuntimeError(f'non-finite loss at iter {state.step}: '
                                   f'{m["loss"]}')
        if ckpt_every and state.step % ckpt_every == 0 and state.step < total:
            save()
            print(f'[ckpt] saved step {state.step} -> {work_dir}')
        if (eval_every and not args.synthetic
                and state.step % eval_every == 0):
            val = _evaluate(exp, model, args, batch_size, device)
            print('[eval]', ' '.join(f'{k}={v:.4f}'
                                     for k, v in sorted(val.items())))
            log_json(dict(mode='val', iter=state.step, **val))
            t_log = time.perf_counter()
    batches.close()                 # stops the loader's prefetch thread
    save()
    print(f'[done] {state.step} iters; checkpoint in {work_dir}')

    if args.overfit_check:
        if len(loss_history) < 2:
            raise SystemExit('[overfit-check] needs >= 2 logged losses '
                             '(lower --log-interval or raise --max-iters)')
        ratio = overfit_ratio(loss_history)
        ok = ratio < 0.7
        print(f'[overfit-check] first={loss_history[0]:.4f} '
              f'ratio={ratio:.3f} -> {"PASS" if ok else "FAIL"}')
        if not ok:
            raise SystemExit(1)


if __name__ == '__main__':
    main()
