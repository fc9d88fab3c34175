"""Detection losses (CE, SmoothL1) with explicit weights and avg factors.

Counterpart of `hrfuser_tpu.core.losses` (the reference
`mmdet/models/losses/cross_entropy_loss.py`, `smooth_l1_loss.py`,
`accuracy.py`): weighted sums over fixed-size tensors divided by an
`avg_factor` clamped at 1, so padded or unsampled rows carry zero weight.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _avg(total: Tensor, avg_factor) -> Tensor:
    return total / torch.clamp(torch.as_tensor(avg_factor, dtype=total.dtype,
                                               device=total.device), min=1.0)


def sigmoid_bce(logits: Tensor, targets: Tensor, weights: Tensor,
                avg_factor) -> Tensor:
    """Binary CE with logits (RPN classification, `use_sigmoid=True`)."""
    loss = (logits.clamp(min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))
    return _avg((loss * weights).sum(), avg_factor)


def softmax_ce(logits: Tensor, labels: Tensor, weights: Tensor,
               avg_factor) -> Tensor:
    """Multi-class CE (RCNN classification); labels [N] int, weights [N]."""
    ll = F.log_softmax(logits, -1).gather(-1, labels[:, None].long())[:, 0]
    return -_avg((ll * weights).sum(), avg_factor)


def smooth_l1(pred: Tensor, target: Tensor, weights: Tensor, avg_factor,
              beta: float = 1.0) -> Tensor:
    """Huber / SmoothL1 with elementwise weights [..., 4]."""
    diff = (pred - target).abs()
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)
    return _avg((loss * weights).sum(), avg_factor)


def accuracy_parts(logits: Tensor, labels: Tensor, weights: Tensor):
    """The weighted top-1 accuracy's numerator and denominator (each sums
    over the ranks of a data-parallel step)."""
    correct = (logits.argmax(-1) == labels).float()
    return (correct * weights).sum(), weights.sum()


def accuracy(logits: Tensor, labels: Tensor, weights: Tensor) -> Tensor:
    """Weighted top-1 accuracy (a logged metric, not a loss)."""
    num, den = accuracy_parts(logits, labels, weights)
    return num / den.clamp(min=1.0)
