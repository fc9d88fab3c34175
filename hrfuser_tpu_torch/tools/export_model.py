"""Model export CLI: `predict` as a saved `torch.export` program (`.pt2`).

Port of `tools/export_model.py` (the JAX package's deployment path in
place of the reference's ONNX / TensorRT export, which writes a StableHLO
artifact): config (+ checkpoint) -> `apis/export.export_predict` ->
`torch.export.save`. Inputs are `(img, *mod_imgs)`, float32 NHWC at a
static batch and size (`--img-hw`, default the config's `img_scale`
rounded up to /32); weights are baked in as constants.

    python -m hrfuser_tpu_torch.tools.export_model \\
        cascade_rcnn_hrfuser_t_1x_nus_r640_l_r_fusion \\
        [--checkpoint CKPT] [--batch 8] [--dtype bf16] --out model.pt2 \\
        [--verify]
    python -m hrfuser_tpu_torch.tools.export_model tiny_fusion_test \\
        --device cpu --out /tmp/t.pt2 --verify

It runs on the card unless `--device cpu` is given, and the program
runs on the device it was exported on. `--verify` loads the file back
on that device, runs it on zeros (every output finite, as the JAX tool
checks) and prints the largest difference between the loaded program and
eager `predict` on seeded inputs. Loading the file elsewhere needs
`import hrfuser_tpu_torch` first: the program calls the port's
registered `hrfuser::*` ops.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from hrfuser_tpu_torch.tools.test import DTYPES


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Export predict as a '
                                            'torch.export program')
    p.add_argument('config')
    p.add_argument('--checkpoint', default=None)
    p.add_argument('--batch', type=int, default=1)
    p.add_argument('--img-hw', type=int, nargs=2, default=None)
    p.add_argument('--out', required=True)
    p.add_argument('--verify', action='store_true',
                   help='load the file back and run it on zeros, then '
                        'against eager predict on seeded inputs')
    p.add_argument('--dtype', choices=sorted(DTYPES), default='f32')
    p.add_argument('--device', default='cuda')
    return p.parse_args(argv)


def verify(path: str, detector, shapes) -> dict:
    """Load `path` on the detector's device, run it on zeros (all outputs
    finite, or raise), and return each `Detections` field's largest
    absolute difference from eager `predict` on seeded N(0, 1) inputs."""
    from hrfuser_tpu_torch.apis.export import PredictModule, predict_inputs
    program = torch.export.load(path).module()
    with torch.no_grad():
        out = program(*predict_inputs(detector, shapes))
        if not all(bool(torch.isfinite(t.float()).all()) for t in out):
            raise RuntimeError(f'{path}: non-finite outputs on zeros')
        print(f'[export] verify ok: outputs '
              f'{[tuple(t.shape) for t in out]} finite on zeros')
        xs = predict_inputs(detector, shapes,
                            torch.Generator().manual_seed(0))
        got, want = program(*xs), PredictModule(detector)(*xs)
    return {k: (getattr(got, k).float() - getattr(want, k).float())
            .abs().max().item() for k in got._fields}


def main(argv=None):
    args = parse_args(argv)
    from hrfuser_tpu_torch.apis.export import (default_img_hw,
                                               export_predict, input_shapes)
    from hrfuser_tpu_torch.apis.inference import init_detector
    from hrfuser_tpu_torch.tools import resolve_device

    det = init_detector(args.config, resolve_device(args.device),
                        dtype=DTYPES[args.dtype], checkpoint=args.checkpoint)
    img_hw = tuple(args.img_hw) if args.img_hw else default_img_hw(det.data)
    t0 = time.perf_counter()
    program = export_predict(det, args.batch, img_hw)
    t1 = time.perf_counter()
    torch.export.save(program, args.out)
    print(f'[export] {args.out}: {os.path.getsize(args.out) / 1e6:.1f} MB, '
          f'device={det.device}, dtype={args.dtype}, inputs '
          f'{input_shapes(det, args.batch, img_hw)}; traced in '
          f'{t1 - t0:.1f} s, saved in {time.perf_counter() - t1:.1f} s')
    if args.verify:
        diffs = verify(args.out, det, input_shapes(det, args.batch, img_hw))
        print(f'[export] loaded program vs eager predict on seeded inputs, '
              f'largest difference: {diffs}')


if __name__ == '__main__':
    main()
