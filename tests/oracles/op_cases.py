"""Small arguments for each registered `hrfuser::` op, on any device.

Test support for `torch.library.opcheck` (the op's implementation on
that device against its fake one): kernel A in its four modes (self,
cross with a residual and z, a centre-padded slab, pre-normed windows),
kernel B, kernel C over four levels (2x2, adaptive with `max_grid` 4,
unaligned at a static 3x3), and NMS's keep loop below and above
one block (`ops/nms.BLOCK`). Torch only: `chip_smoke.py` and
`tests/test_torch_cuda.py` load it by path on the card's machine.
"""

import torch

from hrfuser_tpu_torch.layers.attention import (HRFormerBlock,
                                                HRFuserFusionBlock)
from hrfuser_tpu_torch.ops import chain, nms, roi_align

LABELS = ('A self', 'A cross', 'A padded', 'A windows', 'B', 'C',
          'keep 40', 'keep 300', 'C adaptive', 'C unaligned')
C, HEADS = 16, 2


def _randn(g, shape, device, dtype):
    return torch.randn(shape, generator=g).to(device, dtype)


def _attention(mode, g, device, dtype):
    if mode == 'cross':
        p = HRFuserFusionBlock(C, HEADS, 1).eval().to(device).folded()
        p = p['attn'][0]
    else:
        p = HRFormerBlock(C, HEADS).eval().to(device).folded()['attn']
    shape = {'self': (2, 9, 11, C), 'cross': (2, 9, 11, C),
             'padded': (2, 14, 14, C), 'windows': (6, 7, 7, C)}[mode]
    q, kv, res = (_randn(g, shape, device, dtype) for _ in range(3))
    acts, lns, pad = {
        'self': ((q, None, q, None), (p['lnq'], None), (0, 0)),
        'cross': ((q, kv, res, kv), (p['lnq'], p['lnkv']), (0, 0)),
        'padded': ((q, kv, res, kv), (p['lnq'], p['lnkv']), (9, 11)),
        'windows': ((q, kv, None, None), (None, None), (0, 0))}[mode]
    weights = [p[k] for k in ('wqkv', 'bqkv', 'wo', 'bo', 'bias', 'wqkv_p',
                              'wo_p')]
    return (*acts, *lns, *weights, HEADS, *pad, 'window_self_attention')


def op_case(label, device, dtype):
    """(op, args) of case `label` (one of `LABELS`) with activations (or
    boxes) in `dtype` on `device`."""
    g = torch.Generator().manual_seed(LABELS.index(label))
    if label.startswith('A '):
        return chain.window_attention_op, _attention(label[2:], g, device,
                                                     dtype)
    if label == 'B':
        p = HRFormerBlock(C, HEADS).eval().to(device).folded()['ffn']
        x = _randn(g, (2, 5, 6, C), device, dtype)
        return chain.cross_ffn_op, (x, *(p[k] for k in chain._FFN_KEYS),
                                    'cross_ffn')
    if label.startswith('C'):
        grid = {'C': (2, True), 'C adaptive': (0, True),
                'C unaligned': (3, False)}[label]
        feats = [_randn(g, (2, 32 // s, 48 // s, 8), device, dtype)
                 for s in (1, 2, 4, 8)]
        xy = torch.rand((2, 5, 2), generator=g) * 100
        rois = torch.cat([xy, xy + torch.rand((2, 5, 2), generator=g) * 90],
                         -1).to(device)
        return roi_align.roi_align_op, (feats, rois, [4, 8, 16, 32], 7,
                                        grid[0], 56, 4, grid[1],
                                        'multilevel_roi_align')
    n = int(label.split()[1])
    xy = torch.rand((2, n, 2), generator=g) * 50
    boxes = torch.cat([xy, xy + 5 + torch.rand((2, n, 2), generator=g) * 20],
                      -1).to(device, dtype)
    valid = (torch.rand((2, n), generator=g) > 0.2).to(device)
    return nms.greedy_keep, (boxes, valid, 0.5, 100)
