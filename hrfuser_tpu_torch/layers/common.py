"""Basic building blocks on NHWC tensors.

Counterpart of `hrfuser_tpu.layers.common`. Feature maps are NHWC
`[B, H, W, C]` as in the JAX package; torch convolutions see them through
a permuted view (NCHW shape, channels-last memory), so no copy is made.
Modules keep the reference (mmdet) parameter names, so a reference
`.pth` loads with `load_state_dict`. Parameters stay float32; the
activations' dtype picks the compute dtype.

Each helper has two routes, picked by the module's `training` flag. Eval
runs each conv with its BatchNorm folded in (running statistics, eps
1e-5), cached per dtype. Training runs the live parameters, so gradients
reach them, and BatchNorm normalizes with the batch statistics and
updates its running statistics as flax's `nn.BatchNorm` does
(`hrfuser_tpu/layers/common.py:33-55`): momentum 0.1 and the biased batch
variance. `DropPath` and `Dropout` draw from the generator that
`train_generator` installs.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor


def cached(owner: nn.Module, tag, fn: Callable, tensors: Sequence[Tensor]):
    """`fn()` memoised on `owner` under `tag`.

    Recomputed when any of `tensors` moves, is replaced or is modified in
    place (`load_state_dict` copies in place, which bumps the version).
    """
    key = tuple((t.device, t.dtype, t.data_ptr(), t._version)
                for t in tensors)
    store = owner.__dict__.setdefault('_cached', {})
    hit = store.get(tag)
    if hit is None or hit[0] != key:
        with torch.no_grad():
            hit = store[tag] = (key, fn())
    return hit[1]


_GENERATOR = contextvars.ContextVar('train_generator', default=None)


@contextlib.contextmanager
def train_generator(generator: torch.Generator):
    """Make `generator` the source of `DropPath` / `Dropout` draws."""
    token = _GENERATOR.set(generator)
    try:
        yield generator
    finally:
        _GENERATOR.reset(token)


def _uniform(shape, like: Tensor) -> Tensor:
    """U[0, 1) of `shape` on `like`'s device, drawn from the installed
    generator on its own device."""
    g = _GENERATOR.get()
    if g is None:
        raise RuntimeError('a training forward with drop path or dropout '
                           'needs a generator: wrap it in train_generator()')
    return torch.rand(shape, generator=g, device=g.device).to(like.device)


class DropPath(nn.Module):
    """Per-sample stochastic depth (mmcv `DropPath`,
    `hrfuser_tpu/layers/common.py:229-241`): in training, each sample is
    kept with probability 1 - rate and scaled by 1 / (1 - rate)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: Tensor) -> Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = _uniform((x.shape[0],) + (1,) * (x.dim() - 1), x) < keep
        return x * mask.to(x.dtype) / keep


class Dropout(nn.Module):
    """Elementwise dropout with flax's `nn.Dropout` semantics (each element
    kept with probability 1 - rate and scaled by 1 / (1 - rate))."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: Tensor) -> Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        return torch.where(_uniform(x.shape, x) < keep, x / keep,
                           torch.zeros_like(x))


def layer_norm(x: Tensor, weight: Tensor, bias: Tensor,
               eps: float = 1e-6) -> Tensor:
    """LayerNorm over the last dim in float32, zero-variance guarded.

    Forward-identical to `F.layer_norm` (a constant row maps to `bias`);
    mirrors `hrfuser_tpu/layers/common.py:224`. Returns float32.
    """
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    centered = xf - mean
    var = (centered * centered).mean(-1, keepdim=True)
    inv = torch.where(var > 0, torch.rsqrt(var + eps), torch.zeros_like(var))
    return centered * inv * weight + bias


class LayerNorm(nn.LayerNorm):
    """`nn.LayerNorm` (reference names) with the zero-variance guard."""

    def forward(self, x: Tensor) -> Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps).to(x.dtype)


def fold_bn(bn: nn.BatchNorm2d) -> Tuple[Tensor, Tensor]:
    """Eval BN as per-channel (scale, shift), float32."""
    scale = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    return scale, bn.bias.float() - bn.running_mean.float() * scale


def _bn_tensors(bn: nn.BatchNorm2d):
    return [bn.weight, bn.bias, bn.running_mean, bn.running_var]


def batch_norm_train(x: Tensor, bn: nn.BatchNorm2d) -> Tensor:
    """Training BatchNorm of an NCHW `x` with its batch statistics; the
    running statistics take the biased batch variance, as flax's do
    (`nn.BatchNorm2d` would take the unbiased one)."""
    n = x.numel() // x.shape[1]
    batch_mean = torch.zeros_like(bn.running_mean)
    batch_var = torch.zeros_like(bn.running_var)
    # momentum 1 leaves the batch mean and unbiased variance in the temps
    y = F.batch_norm(x, batch_mean, batch_var, bn.weight.to(x.dtype),
                     bn.bias.to(x.dtype), True, 1.0, bn.eps)
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1 - m).add_(batch_mean, alpha=m)
        bn.running_var.mul_(1 - m).add_(batch_var, alpha=m * (n - 1) / n)
        bn.num_batches_tracked.add_(1)
    return y


def conv_bn(x: Tensor, conv: nn.Conv2d, bn: Optional[nn.BatchNorm2d] = None,
            relu: bool = False) -> Tensor:
    """Conv (+ BN) (+ ReLU) on an NHWC tensor: eval folds the BN into the
    conv (cached), training runs the live weights and `batch_norm_train`."""
    if conv.training:
        w = conv.weight.to(x.dtype)
        b = None if conv.bias is None else conv.bias.to(x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, b, conv.stride, conv.padding,
                     conv.dilation, conv.groups)
        if bn is not None:
            y = batch_norm_train(y, bn)
        y = y.permute(0, 2, 3, 1)
        return F.relu(y) if relu else y

    def fold():
        w = conv.weight.float()
        b = (conv.bias.float() if conv.bias is not None
             else torch.zeros(w.shape[0], device=w.device))
        if bn is not None:
            s, t = fold_bn(bn)
            w = w * s[:, None, None, None]
            b = b * s + t
        return w.to(x.dtype), b.to(x.dtype)

    deps = [conv.weight] + ([conv.bias] if conv.bias is not None else [])
    deps += _bn_tensors(bn) if bn is not None else []
    w, b = cached(conv, ('conv_bn', x.dtype), fold, deps)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, conv.stride, conv.padding,
                 conv.dilation, conv.groups).permute(0, 2, 3, 1)
    return F.relu(y) if relu else y


def run_seq(seq: nn.Module, x: Tensor) -> Tensor:
    """Run a reference-style Sequential of Conv2d[+BatchNorm2d], ReLU,
    GELU and nested Sequentials on an NHWC tensor."""
    mods = list(seq) if isinstance(seq, nn.Sequential) else [seq]
    i = 0
    while i < len(mods):
        m = mods[i]
        if isinstance(m, nn.Conv2d):
            bn = mods[i + 1] if (i + 1 < len(mods) and isinstance(
                mods[i + 1], nn.BatchNorm2d)) else None
            x = conv_bn(x, m, bn)
            i += 2 if bn is not None else 1
            continue
        if isinstance(m, nn.ReLU):
            x = F.relu(x)
        elif isinstance(m, nn.GELU):
            x = F.gelu(x)
        elif isinstance(m, nn.Sequential):
            x = run_seq(m, x)
        elif not isinstance(m, nn.Identity):
            raise TypeError(f'run_seq: unsupported module {type(m).__name__}')
        i += 1
    return x


def linear(x: Tensor, fc: nn.Linear) -> Tensor:
    """`fc(x)` with the weights cast to the activations' dtype (cached in
    eval)."""
    if fc.training:
        return F.linear(x, fc.weight.to(x.dtype), fc.bias.to(x.dtype))
    w, b = cached(fc, ('linear', x.dtype),
                  lambda: (fc.weight.to(x.dtype), fc.bias.to(x.dtype)),
                  [fc.weight, fc.bias])
    return F.linear(x, w, b)


def conv3x3(cin: int, cout: int, stride: int = 1, groups: int = 1
            ) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, groups=groups,
                     bias=False)


class BasicBlock(nn.Module):
    """ResNet BasicBlock (`hrfuser_tpu/layers/common.py:244-268`),
    expansion 1: 3x3 -> BN -> ReLU -> 3x3 -> BN, residual (+ a 1x1
    downsample on a width change), ReLU."""
    expansion = 1

    def __init__(self, cin: int, planes: int):
        super().__init__()
        self.conv1 = conv3x3(cin, planes)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = conv3x3(planes, planes)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = (nn.Sequential(nn.Conv2d(cin, planes, 1, bias=False),
                                         nn.BatchNorm2d(planes))
                           if cin != planes else None)

    def forward(self, x: Tensor) -> Tensor:
        idt = x if self.downsample is None else run_seq(self.downsample, x)
        out = conv_bn(x, self.conv1, self.bn1, relu=True)
        out = conv_bn(out, self.conv2, self.bn2)
        return F.relu(out + idt)


class Bottleneck(nn.Module):
    """ResNet Bottleneck (pytorch style: stride on the 3x3), expansion 4."""
    expansion = 4

    def __init__(self, cin: int, planes: int):
        super().__init__()
        cout = planes * self.expansion
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = conv3x3(planes, planes)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        self.downsample = (nn.Sequential(nn.Conv2d(cin, cout, 1, bias=False),
                                         nn.BatchNorm2d(cout))
                           if cin != cout else None)

    def forward(self, x: Tensor) -> Tensor:
        idt = x if self.downsample is None else run_seq(self.downsample, x)
        out = conv_bn(x, self.conv1, self.bn1, relu=True)
        out = conv_bn(out, self.conv2, self.bn2, relu=True)
        out = conv_bn(out, self.conv3, self.bn3)
        return F.relu(out + idt)


BLOCKS = {'BASIC': BasicBlock, 'BOTTLENECK': Bottleneck}


def res_layer(block: str, cin: int, planes: int, num_blocks: int
              ) -> nn.Sequential:
    """A run of `block` ('BASIC' or 'BOTTLENECK') residual blocks, the
    first downsampling on a width change (`HRNet._make_layer`,
    `hrfuser_tpu/layers/common.py:299-321`), NHWC in and out."""
    cls = BLOCKS[block]
    blocks = [cls(cin, planes)]
    blocks += [cls(planes * cls.expansion, planes)
               for _ in range(1, num_blocks)]
    return nn.Sequential(*blocks)


def nearest_up(x: Tensor, factor: int) -> Tensor:
    """Integer nearest-neighbour upsampling of an NHWC tensor (torch
    `Upsample(mode='nearest')`): a broadcast view and one copy."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None].expand(b, h, factor, w, factor, c) \
        .reshape(b, h * factor, w * factor, c)


def bilinear_resize(x: Tensor, out_hw: Tuple[int, int]) -> Tensor:
    """Bilinear resize of an NHWC tensor with half-pixel centres
    (`align_corners=False`), as `jax.image.resize` does: antialiased
    when a side shrinks (its default), which torch's `antialias=True`
    matches; that one runs in float32 (the CPU has no bf16 kernel of
    it)."""
    shrink = out_hw[0] < x.shape[1] or out_hw[1] < x.shape[2]
    y = F.interpolate((x.float() if shrink else x).permute(0, 3, 1, 2),
                      size=tuple(out_hw), mode='bilinear',
                      align_corners=False, antialias=shrink)
    return y.permute(0, 2, 3, 1).to(x.dtype)
