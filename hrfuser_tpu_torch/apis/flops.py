"""FLOPs of a forward (`predict`) or of a train step's forward and backward.

Counted by `torch.utils.flop_counter.FlopCounterMode`: the matmuls and
convolutions (and their backward) the aten ops run, and kernels A, B and
C through the formulas `ops/flops.py` registers on `hrfuser::
window_attention`, `cross_ffn` and `roi_align` (`greedy_keep`, NMS, counts
0). Elementwise work (norms, activations, softmax, the resize's
interpolation, pooling) counts nothing; XLA's `cost_analysis`, which the
JAX package's `tools/get_flops.py` reads, counts it too, so the two totals
differ by design. `tests/test_torch_flops.py` holds the count to a walk
of the JAX package's jaxpr that counts products only.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, conv_flop_count

from hrfuser_tpu_torch.core.samplers import Draws
from hrfuser_tpu_torch.models.detectors.cascade_rcnn import predict
from hrfuser_tpu_torch.models.detectors.train_loss import forward_train
from hrfuser_tpu_torch.ops import flops as _formulas  # noqa: F401

Tensor = torch.Tensor


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, bias, stride,
                        padding, dilation, transposed, output_padding, groups,
                        output_mask, out_shape, **kwargs) -> int:
    """`torch.utils.flop_counter`'s `convolution_backward` count with the
    weight gradient of a grouped convolution divided by its groups: the
    library's counts every input channel against every output channel,
    `groups` times the work (C times for a depthwise conv)."""
    if transposed:
        raise NotImplementedError('count_flops: transposed convolutions')

    def t(shape):
        return [shape[1], shape[0], *shape[2:]]
    flops = 0
    if output_mask[0]:                  # conv_transpose(grad_out, weight)
        flops += conv_flop_count(grad_out_shape, w_shape, out_shape[0], True)
    if output_mask[1]:                  # conv(input, grad_out), per group
        flops += conv_flop_count(t(x_shape), t(grad_out_shape),
                                 t(out_shape[1])) // groups
    return flops


_CUSTOM = {torch.ops.aten.convolution_backward: _conv_backward_flop}


class _Calls(TorchDispatchMode):
    """Counts the calls of every op that has a FLOP formula in
    `registry`, and the calls of each `hrfuser::` op by its counter entry
    (its last argument: the wrapper whose `launches` a CUDA call
    bumps)."""

    def __init__(self, registry):
        super().__init__()
        self.registry = registry
        self.calls: Counter = Counter()
        self.entries: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        packet = func._overloadpacket
        if packet in self.registry:
            name = str(packet)
            self.calls[name] += 1
            if name.startswith('hrfuser.') and isinstance(args[-1], str):
                self.entries[args[-1]] += 1
        return func(*args, **(kwargs or {}))


def count_params(model) -> int:
    """Elements of the `nn.Parameter`s the forward reads (BN statistics
    are buffers, so excluded): all but the HRFuser stage-2 transition's
    unread BatchNorms (`HRFuserBackbone.unused_parameters`). This is the
    JAX package's count of `variables['params']` leaves."""
    unused = getattr(model.backbone, 'unused_parameters', list)()
    return (sum(p.numel() for p in model.parameters())
            - sum(p.numel() for p in unused))


def _train_batch(img: Tensor, mod_imgs: Sequence[Tensor]) -> Dict:
    """One gt box an image, as `tools/get_flops.py:76-83` builds it."""
    b, dev = img.shape[0], img.device
    batch = dict(
        img=img,
        gt_boxes=torch.tensor([[[10., 10., 100., 80.]]],
                              device=dev).expand(b, 1, 4).contiguous(),
        gt_labels=torch.zeros((b, 1), dtype=torch.long, device=dev),
        gt_valid=torch.ones((b, 1), dtype=torch.bool, device=dev))
    if mod_imgs:
        batch['mod_imgs'] = list(mod_imgs)
    return batch


def count_flops(model, img: Tensor, mod_imgs: Optional[Sequence[Tensor]],
                train: bool = False) -> Dict:
    """FLOPs of `predict(model, img, mod_imgs)` (in `img`'s dtype, the
    kernels launched on a CUDA device), or with `train=True` of
    `forward_train` plus `backward` on a batch with one gt box an image
    (the model in training mode for the call, no kernel launched; the
    gradients are cleared afterwards).

    Returns `flops` (FlopCounterMode's total), `by_op` ({op: {'calls',
    'flops'}} for every op with a formula that ran) and `entries` (calls
    of the `hrfuser::` ops by counter entry, to hold against the launch
    counters).
    """
    mods = list(mod_imgs or [])
    counter = FlopCounterMode(display=False, custom_mapping=_CUSTOM)
    calls = _Calls(counter.flop_registry)
    if train:
        was_training = model.training
        model.train()
        gen = torch.Generator(img.device).manual_seed(0)
        try:
            with counter, calls:
                losses = forward_train(model, _train_batch(img, mods),
                                       Draws(gen))
                losses['loss'].backward()
        finally:
            model.zero_grad(set_to_none=True)
            model.train(was_training)
    else:
        with torch.no_grad(), counter, calls:
            predict(model, img, mods)
    flops = {str(k): v
             for k, v in counter.get_flop_counts()['Global'].items()}
    by_op = {k: {'calls': calls.calls[k], 'flops': flops.get(k, 0)}
             for k in sorted(calls.calls)}
    return {'flops': counter.get_total_flops(), 'by_op': by_op,
            'entries': dict(calls.entries)}
