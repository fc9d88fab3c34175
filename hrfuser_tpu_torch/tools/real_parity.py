"""Real-data accuracy parity in one command: a reference `.pth` -> eval ->
metrics.

Port of `tools/run_real_parity.sh`. The port loads a reference mmdet
`.pth` as it is (its modules carry the reference's parameter names,
`utils/checkpoint.py`), so there is no convert step: the file's tensors
are counted, then `tools.test --checkpoint --data-root --eval
bbox,proposal_fast --out` scores the test split and the metrics are
printed beside the line to compare them with. `<data_root>` is what the
reference's `tools/create_data.py` and `export_2d_annotation` produce
(README, "Datasets").

`--dry-run` rehearses the chain without weights or data: it writes a fake
mmdet-layout `.pth` (`{'meta': ..., 'state_dict': ...}`) of
`tiny_fusion_test` from the port's own seeded model, reads it back, and
runs `tools.test --synthetic --checkpoint` on it at 64x96, failing unless
the metrics are finite.

    python -m hrfuser_tpu_torch.tools.real_parity <ckpt.pth> <data_root> \\
        [config] [out_dir] [--device cuda]
    python -m hrfuser_tpu_torch.tools.real_parity --dry-run [--device cpu]

It runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile

CONFIG_DEFAULT = 'cascade_rcnn_hrfuser_t_1x_nus_r640_l_r_fusion'
DRY_CONFIG = 'tiny_fusion_test'
DRY_HW = (64, 96)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Real-data accuracy parity')
    p.add_argument('checkpoint', nargs='?', help='reference .pth')
    p.add_argument('data_root', nargs='?')
    p.add_argument('config', nargs='?', default=CONFIG_DEFAULT)
    p.add_argument('out_dir', nargs='?', default=None)
    p.add_argument('--dry-run', action='store_true',
                   help='synthetic rehearsal of the chain (no weights, '
                        'no data)')
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)
    if not args.dry_run and not (args.checkpoint and args.data_root):
        p.error('need <ckpt.pth> <data_root> (or --dry-run)')
    return args


def count_tensors(ckpt_path: str) -> int:
    """Tensors in the checkpoint's state dict, read as `init_detector`
    reads it."""
    from hrfuser_tpu_torch.utils.checkpoint import read_weights
    return len(read_weights(ckpt_path))


def write_fake_pth(path: str, config: str = DRY_CONFIG, seed: int = 0
                   ) -> int:
    """A reference-layout `.pth` of `config`'s seeded model; returns its
    tensor count."""
    import torch

    from hrfuser_tpu_torch.apis.inference import init_weights_
    from hrfuser_tpu_torch.configs import get_experiment
    from hrfuser_tpu_torch.models.detectors.cascade_rcnn import CascadeRCNN
    exp = get_experiment(config)
    model = CascadeRCNN(exp.model)
    init_weights_(model, torch.Generator().manual_seed(seed))
    sd = model.state_dict()
    torch.save({'meta': {'CLASSES': list(exp.data.classes)},
                'state_dict': sd}, path)
    return len(sd)


def _finite(metrics: dict) -> bool:
    return all(isinstance(v, (int, float)) and math.isfinite(v)
               for v in metrics.values())


def dry_run(device: str) -> dict:
    from hrfuser_tpu_torch.tools import test
    print('[parity --dry-run] synthetic .pth -> eval rehearsal')
    with tempfile.TemporaryDirectory() as tmp:
        pth, out = os.path.join(tmp, 'fake.pth'), os.path.join(
            tmp, 'metrics.json')
        n = write_fake_pth(pth)
        print(f'wrote {pth}: {n} tensors; read back {count_tensors(pth)}')
        test.main([DRY_CONFIG, '--synthetic', '--checkpoint', pth,
                   '--img-hw', *map(str, DRY_HW), '--device', device,
                   '--out', out])
        with open(out) as f:
            metrics = json.load(f)
    print(json.dumps(metrics, indent=2))
    if not _finite(metrics):
        raise SystemExit(f'[parity --dry-run] non-finite metrics: {metrics}')
    print('[parity --dry-run] OK')
    return metrics


def parity(args) -> dict:
    from hrfuser_tpu_torch.tools import test
    out_dir = args.out_dir or os.path.join('work_dirs',
                                           f'parity_{args.config}')
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, 'metrics.json')
    print(f'[parity 1/3] {args.checkpoint}: '
          f'{count_tensors(args.checkpoint)} tensors (read as they are, no '
          f'convert step)')
    print(f'[parity 2/3] evaluating on {args.data_root}')
    test.main([args.config, '--checkpoint', args.checkpoint, '--data-root',
               args.data_root, '--eval', 'bbox,proposal_fast', '--out', out,
               '--device', args.device])
    with open(out) as f:
        metrics = json.load(f)
    print(f'[parity 3/3] results ({out}):')
    print(json.dumps(metrics, indent=2))
    print(f'Compare bbox_mAP against the reference model-zoo row for '
          f'{args.config}')
    print('(reference README; BASELINE.md gate: |delta mAP| <= 0.1).')
    return metrics


def main(argv=None):
    args = parse_args(argv)
    return dry_run(args.device) if args.dry_run else parity(args)


if __name__ == '__main__':
    main()
