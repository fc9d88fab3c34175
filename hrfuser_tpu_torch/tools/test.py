"""Evaluation CLI, synthetic mode.

Port of the `--synthetic` mode of `tools/test.py:64-96`: seeded N(0, 1)
inputs at the config's padded size drive the detector end to end without
a dataset; one warm-up call, then one timed call.

    python -m hrfuser_tpu_torch.tools.test \\
        cascade_rcnn_hrfuser_t_1x_nus_r640_l_r_fusion --synthetic \\
        --batch-size 8 --dtype bf16 [--checkpoint CKPT] [--out m.json]
    python -m hrfuser_tpu_torch.tools.test tiny_fusion_test --synthetic \\
        --device cpu

Evaluation over a dataset needs the dataset classes and the loader, which
come with the data slice of the port (ROADMAP §1).
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
    p.add_argument('--batch-size', type=int, default=2)
    p.add_argument('--synthetic', action='store_true')
    p.add_argument('--img-hw', type=int, nargs=2, default=None,
                   help='override input H W (synthetic mode)')
    p.add_argument('--dtype', choices=sorted(DTYPES), default='f32')
    p.add_argument('--device', default='cuda')
    p.add_argument('--out', default=None, help='dump metrics json')
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if not args.synthetic:
        raise SystemExit(
            'evaluation over a dataset is not ported yet: the datasets, '
            'the loader and image decoding come with the data slice '
            '(ROADMAP §1); run with --synthetic')
    from hrfuser_tpu_torch.apis.inference import init_detector

    det = init_detector(args.config, args.device, seed=0,
                        dtype=DTYPES[args.dtype], checkpoint=args.checkpoint)
    if args.img_hw:
        h, w = args.img_hw
    else:
        w, h = det.data.img_scale
        div = det.data.pad_divisor
        h, w = -(-h // div) * div, -(-w // div) * div
    b = args.batch_size
    rng = np.random.default_rng(0)
    img = rng.normal(0, 1, (b, h, w, 3)).astype(np.float32)
    mods = [rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
            for c in det.cfg.backbone.mod_in_channels]

    def call():
        out = det(img, mods)
        if det.device.type == 'cuda':
            torch.cuda.synchronize(det.device)
        return out

    t0 = time.perf_counter()
    call()
    print(f'[synthetic] warm-up {time.perf_counter() - t0:.1f}s')
    t0 = time.perf_counter()
    out = call()
    dt = time.perf_counter() - t0
    nvalid = int(out.valid.sum())
    print(f'[synthetic] {b} imgs in {dt * 1e3:.1f} ms '
          f'({b / dt:.1f} img/s); {nvalid} detections')
    if args.out:
        with open(args.out, 'w') as f:
            json.dump({'synthetic_img_per_s': round(b / dt, 2),
                       'num_detections': nvalid}, f, indent=2)


if __name__ == '__main__':
    main()
