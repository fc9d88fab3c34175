"""FLOP accounting for a config's forward or train step.

Port of `tools/get_flops.py`, the reference's FLOPs path (the
`forward_dummy` hook, `mmdet/models/detectors/two_stage.py:86-105`). The
JAX tool reads XLA's `cost_analysis()` of the compiled program; here
`apis/flops.count_flops` runs the model once under
`torch.utils.flop_counter.FlopCounterMode` and counts the products: the
matmuls and convolutions (with their backward for `--train`), and
kernels A, B and C through their ops' formulas (`ops/flops.py`: the
model's arithmetic, not the kernels' padded tiles). Elementwise work
(norms, activations, softmax, interpolation, pooling) counts nothing.
XLA's count includes it, so the two totals differ by design. Bytes moved
are not counted (`gbytes_accessed` is null).

`params` counts the `nn.Parameter` elements the forward reads
(`apis/flops.count_params`), the JAX tool's count of
`variables['params']` leaves: BN statistics are buffers, not counted.

`--train` counts `forward_train` and its backward on a batch with one gt
box an image, as the JAX tool builds it. The port's train route is
float32 (with `--bf16` too); the count does not depend on the dtype.

    python -m hrfuser_tpu_torch.tools.get_flops \\
        cascade_rcnn_hrfuser_t_1x_nus_r640_l_r_fusion \\
        [--batch 1] [--img-hw 384 640] [--train] [--bf16] [--json]
    python -m hrfuser_tpu_torch.tools.get_flops tiny_fusion_test \\
        --img-hw 64 96 --device cpu

It runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json

import torch

from hrfuser_tpu_torch.apis.flops import count_flops, count_params
from hrfuser_tpu_torch.apis.inference import init_detector
from hrfuser_tpu_torch.tools import resolve_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('config')
    ap.add_argument('--batch', type=int, default=1)
    ap.add_argument('--img-hw', type=int, nargs=2, default=None)
    ap.add_argument('--train', action='store_true',
                    help='cost of forward_train and its backward instead '
                         'of inference')
    ap.add_argument('--bf16', action='store_true')
    ap.add_argument('--json', action='store_true', help='machine output')
    ap.add_argument('--device', default='cuda')
    return ap.parse_args(argv)


def measure(args) -> dict:
    """The JAX tool's output dict for parsed `args`."""
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.bf16 and not args.train else torch.float32
    det = init_detector(args.config, device, seed=0, dtype=dtype)
    cfg, data = det.cfg, det.data
    if args.img_hw:
        h, w = args.img_hw
    else:
        w, h = data.img_scale
        h, w = (h + 31) // 32 * 32, (w + 31) // 32 * 32
    nmod = cfg.backbone.num_fused_modalities
    b = args.batch
    img = torch.zeros((b, h, w, 3), dtype=dtype, device=device)
    mods = [torch.zeros((b, h, w, c), dtype=dtype, device=device)
            for c in cfg.backbone.mod_in_channels[:nmod]]
    flops = count_flops(det.model, img, mods, train=args.train)['flops']
    return {
        'config': args.config,
        'mode': 'train_step' if args.train else 'inference',
        'input': f'{b}x{h}x{w}x3 (+{nmod} modalities)',
        'params': count_params(det.model),
        'gflops_total': flops / 1e9,
        'gflops_per_image': flops / 1e9 / b,
        'gbytes_accessed': None,
        'arithmetic_intensity_flop_per_byte': None,
    }


def main(argv=None):
    args = parse_args(argv)
    out = measure(args)
    if args.json:
        print(json.dumps(out))
        return
    print(f"config:    {out['config']}")
    print(f"mode:      {out['mode']}   input: {out['input']}")
    print(f"params:    {out['params'] / 1e6:.2f} M")
    print(f"FLOPs:     {out['gflops_per_image']:.2f} GFLOPs/image "
          f"({out['gflops_total']:.2f} total)")
    print('HBM bytes: (not reported by this backend)')


if __name__ == '__main__':
    main()
