"""Strip a training checkpoint to release weights.

Port of `tools/publish_model.py` (the reference's
`tools/model_converters/publish_model.py`). Reads a port checkpoint (a
`step_{N}.pth`, or a checkpoint directory's `latest`; `utils/checkpoint`),
keeps its `state_dict` (parameters and BatchNorm buffers) and `meta`,
drops `optimizer`, `step` and `extra`, and writes
`{out_prefix}-{digest}.pth`, which `load_weights` (and
`init_detector(checkpoint=...)`) load.

`digest` is the first 8 hex digits of the sha256 of the kept tensors'
bytes in `state_dict` order, as the JAX tool hashes its `params` and
`batch_stats` leaves. It cannot equal the JAX tool's digest for the same
weights: the layouts differ (OIHW against HWIO convolution kernels,
[out, in] against [in, out] dense kernels, the reference's parameter
order against the flax tree's), so the bytes do.

    python -m hrfuser_tpu_torch.tools.publish_model \\
        work_dirs/<cfg>/step_1234.pth out/<name>
"""

from __future__ import annotations

import argparse
import hashlib
import os.path as osp
from typing import Dict

import torch

from hrfuser_tpu_torch.utils.checkpoint import _read, _state_dict_of


def digest(state_dict: Dict[str, torch.Tensor]) -> str:
    """First 8 hex digits of the sha256 of the tensors' bytes, in order."""
    hasher = hashlib.sha256()
    for t in state_dict.values():
        hasher.update(t.detach().cpu().contiguous().reshape(-1)
                      .view(torch.uint8).numpy().tobytes())
    return hasher.hexdigest()[:8]


def publish(in_ckpt: str, out_prefix: str) -> str:
    """Write the release file of `in_ckpt`; returns its path."""
    payload = _read(in_ckpt)
    sd = _state_dict_of(payload)
    out = osp.abspath(f'{out_prefix}-{digest(sd)}.pth')
    kept = {'state_dict': sd}
    if isinstance(payload.get('meta'), dict):
        kept['meta'] = payload['meta']
    torch.save(kept, out)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('in_ckpt')
    ap.add_argument('out_prefix')
    args = ap.parse_args(argv)
    print(f'[publish] {publish(args.in_ckpt, args.out_prefix)}')


if __name__ == '__main__':
    main()
