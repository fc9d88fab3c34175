"""Evaluation CLI.

Port of `tools/test.py` (the reference `tools/test.py`): config +
checkpoint -> batched inference over the test split -> metrics.

Dataset mode (`tools/test.py:98-140`): `--data-root` holds the split the
converters write, `nuscenes_infos_val_mono3d.coco.json` (nuScenes) or
the four weather splits `dense_infos_{test_clear,light_fog,dense_fog,
snow}.pkl` (STF), and the files they name. `DetDataLoader(train=False)`
feeds `run_inference`; `--eval` picks `bbox` (COCO mAP for nuScenes,
KITTI 2D AP on the eval crop for STF) and / or `proposal_fast` (AR@N).

`--synthetic` (`tools/test.py:64-96`): seeded N(0, 1) inputs at the
config's padded grid (384x640 for nuScenes, 384x1248 for STF), with one
stream per modality at its own channel count (none for a camera-only
config), drive the detector end to end without a dataset; one warm-up
call, then one timed call.

    python -m hrfuser_tpu_torch.tools.test \\
        cascade_rcnn_hrfuser_t_1x_nus_r640_l_r_fusion \\
        --checkpoint work_dirs/.../latest --data-root data/nuscenes \\
        --batch-size 8 --dtype bf16 [--eval bbox,proposal_fast] [--out m.json]
    python -m hrfuser_tpu_torch.tools.test \\
        cascade_rcnn_hrfuser_t_1x_nus_r640_l_r_fusion --synthetic \\
        --batch-size 8 --dtype bf16
    python -m hrfuser_tpu_torch.tools.test tiny_camera_test --synthetic \\
        --device cpu

    torchrun --nproc-per-node 8 -m hrfuser_tpu_torch.tools.test \\
        cascade_rcnn_hrfuser_t_1x_nus_r640_l_r_fusion \\
        --checkpoint work_dirs/.../latest --data-root data/nuscenes

Both run on the card unless `--device cpu` is given. Under `torchrun`
each rank joins the data-parallel group (`nccl` on the card, `gloo` with
`--device cpu`): over a dataset each rank loads and predicts its rows of
every batch, the batch defaults to the world size (`tools/test.py:112`
in JAX), and every rank evaluates the collected results; `--synthetic`
runs `parallel.api.make_sharded_predict` on the joined batch. Rank 0
alone prints the metrics and writes `--out`.

`--show-dir DIR` (`tools/test.py:141-165`): after evaluation each
result's original image (`meta['filename']`, under the dataset's
`img_prefix` or `--data-root`) is read again, its detections scoring at
least `--show-score-thr` are drawn on it on the card
(`utils/visualization.draw_detections`), and it is written under its
own basename, a JPEG for nuScenes' `.jpg` frames and a PNG for STF's
(`data/pipelines/loading.imwrite`, the JPEG's pixels coded on the card).
A result without a filename or with an unreadable file is skipped.
Under `torchrun` rank 0 alone writes: every rank holds every result.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

DTYPES = {'f32': torch.float32, 'bf16': torch.bfloat16}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Test a detector')
    p.add_argument('config')
    p.add_argument('--checkpoint', default=None)
    p.add_argument('--data-root', default='')
    p.add_argument('--batch-size', type=int, default=None,
                   help='the global batch: default 2 with --synthetic, the '
                        'world size (1 without torchrun) over a dataset')
    p.add_argument('--synthetic', action='store_true')
    p.add_argument('--img-hw', type=int, nargs=2, default=None,
                   help='override input H W (synthetic mode)')
    p.add_argument('--dtype', choices=sorted(DTYPES), default='f32')
    p.add_argument('--device', default='cuda')
    p.add_argument('--out', default=None, help='dump metrics json')
    p.add_argument('--eval', default='bbox', dest='eval_metrics',
                   help='comma-separated metrics: bbox and/or '
                        'proposal_fast (reference --eval; '
                        '`mmdet/datasets/coco.py:331-351,485-486`)')
    p.add_argument('--show-dir', default=None,
                   help='render detections onto the original images and '
                        'write them here (reference --show-dir)')
    p.add_argument('--show-score-thr', type=float, default=0.3)
    return p.parse_args(argv)


def show_results(results, dataset, classes, show_dir: str, data_root: str,
                 score_thr: float = 0.3, device='cuda') -> int:
    """Draw each result's detections on its original image and write it
    to `show_dir` under the image's basename; returns the count written
    (the JAX CLI's `--show-dir` loop)."""
    import os
    import os.path as osp

    from hrfuser_tpu_torch.data.pipelines.loading import imread, imwrite
    from hrfuser_tpu_torch.utils.visualization import draw_detections

    os.makedirs(show_dir, exist_ok=True)
    prefix = getattr(dataset, 'img_prefix', data_root)
    drawn = 0
    for r in results:
        fname = (r['meta'] or {}).get('filename')
        if not fname:
            continue
        path = fname if osp.isabs(fname) else osp.join(prefix, fname)
        try:
            img = imread(path, 'color', device=device)
        except (OSError, ValueError):
            continue
        vis = draw_detections(img, r['boxes'], r['labels'], r['scores'],
                              class_names=classes, score_thr=score_thr,
                              device=device)
        imwrite(osp.join(show_dir, osp.basename(fname)), vis, device=device)
        drawn += 1
    return drawn


def evaluate_dataset(args, group=None):
    """Dataset mode: run the test split through the detector (each rank
    of `group` on its rows) and score it; returns the metrics."""
    from hrfuser_tpu_torch.apis.inference import init_detector
    from hrfuser_tpu_torch.apis.test import (evaluate,
                                             evaluate_proposal_recall,
                                             run_inference)
    from hrfuser_tpu_torch.configs import get_experiment
    from hrfuser_tpu_torch.data.datasets import build_dataset
    from hrfuser_tpu_torch.data.loader import DetDataLoader

    rank, world = (0, 1) if group is None else (group.rank,
                                                group.world_size)
    say = print if rank == 0 else (lambda *a, **k: None)
    device = args.device if group is None else group.device
    exp = get_experiment(args.config)
    dataset = build_dataset(exp.data, args.data_root, 'test')
    loader = DetDataLoader(dataset, exp.data, args.batch_size or world,
                           train=False, device=device, rank=rank,
                           world_size=world)
    if not args.checkpoint:
        say('[warn] no --checkpoint: evaluating random weights')
    det = init_detector(args.config, device, seed=0,
                        dtype=DTYPES[args.dtype], checkpoint=args.checkpoint)
    t0 = time.perf_counter()
    results = run_inference(det, loader, group=group)
    dt = time.perf_counter() - t0
    say(f'[test] {len(results)} images in {dt:.1f} s '
        f'({len(results) / dt:.1f} img/s, loading included)')
    wanted = [m.strip() for m in args.eval_metrics.split(',') if m.strip()]
    metrics = {}
    if 'bbox' in wanted:
        metrics.update(evaluate(exp, results, dataset))
    if 'proposal_fast' in wanted:
        metrics.update(evaluate_proposal_recall(results, dataset))
    for k, v in metrics.items():
        say(f'{k}: {v:.4f}')
    if args.out and rank == 0:
        with open(args.out, 'w') as f:
            json.dump(metrics, f, indent=2)
    if args.show_dir and rank == 0:
        n = show_results(results, dataset, exp.data.classes, args.show_dir,
                         args.data_root, args.show_score_thr, device)
        say(f'[show] wrote {n} visualizations to {args.show_dir}')
    return metrics


def main(argv=None):
    args = parse_args(argv)
    from hrfuser_tpu_torch.parallel.mesh import (launched_with_ranks,
                                                 process_group)
    run = synthetic if args.synthetic else evaluate_dataset
    if not launched_with_ranks():
        return run(args)
    with process_group(args.device) as group:
        return run(args, group)


def synthetic(args, group=None):
    """Synthetic mode: one warm-up call and one timed call on seeded
    inputs (over `group`, the joined batch through
    `make_sharded_predict`)."""
    from hrfuser_tpu_torch.apis.inference import init_detector
    from hrfuser_tpu_torch.parallel.api import make_sharded_predict

    lead = group is None or group.rank == 0
    say = print if lead else (lambda *a, **k: None)
    device = args.device if group is None else group.device
    det = init_detector(args.config, device, seed=0,
                        dtype=DTYPES[args.dtype], checkpoint=args.checkpoint)
    predict = det if group is None else make_sharded_predict(det, group)
    if args.img_hw:
        h, w = args.img_hw
    else:
        w, h = det.data.img_scale
        div = det.data.pad_divisor
        h, w = -(-h // div) * div, -(-w // div) * div
    b = args.batch_size or 2
    rng = np.random.default_rng(0)
    img = rng.normal(0, 1, (b, h, w, 3)).astype(np.float32)
    mods = [rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
            for c in det.cfg.backbone.mod_in_channels]

    def call():
        out = predict(img, mods)
        if det.device.type == 'cuda':
            torch.cuda.synchronize(det.device)
        return out

    t0 = time.perf_counter()
    call()
    say(f'[synthetic] warm-up {time.perf_counter() - t0:.1f}s')
    t0 = time.perf_counter()
    out = call()
    dt = time.perf_counter() - t0
    nvalid = int(out.valid.sum())
    say(f'[synthetic] {b} imgs in {dt * 1e3:.1f} ms '
        f'({b / dt:.1f} img/s); {nvalid} detections')
    if args.out and lead:
        with open(args.out, 'w') as f:
            json.dump({'synthetic_img_per_s': round(b / dt, 2),
                       'num_detections': nvalid}, f, indent=2)


if __name__ == '__main__':
    main()
