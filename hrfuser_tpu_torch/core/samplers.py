"""Random positive / negative sampler with fixed quotas, and the source of
a train step's random draws.

Counterpart of `hrfuser_tpu.core.samplers` (the reference
`RandomSampler`, `mmdet/core/bbox/samplers/random_sampler.py`): up to
`num * pos_fraction` positives, the rest of `num` negatives, each chosen
uniformly without replacement by ranking a uniform key per candidate
(a stable double argsort, as `jnp.argsort` sorts). The keys come from a
`Draws`; its default draws from a `torch.Generator`, and a test can
replay the JAX package's own draws instead.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

Tensor = torch.Tensor


class Draws:
    """A train step's randomness: the sampler's uniform keys and the
    generator of dropout and drop path.

    `uniforms(site, image, n, device)` gives the (positive, negative) keys
    of one `random_sample` call: `site` is 'rpn' or the cascade stage
    index, `image` the image in the batch. The keys are drawn on the
    generator's device and moved to `device`, so draws made on the CPU
    give the same step on every device. A data-parallel rank passes the
    image's index in the joined batch (`KeyedDraws`).
    """

    def __init__(self, generator: Optional[torch.Generator] = None):
        self.generator = generator or torch.Generator()

    def uniforms(self, site, image: int, n: int, device
                 ) -> Tuple[Tensor, Tensor]:
        g = self.generator
        u = torch.rand(2, n, generator=g, device=g.device).to(device)
        return u[0], u[1]


class KeyedDraws(Draws):
    """Draws whose sampler keys depend only on (`key`, site, image): a
    data-parallel rank that passes its images' global indices gets the
    keys the joined batch's images get, so no two ranks' images share
    keys, and the ranks need not draw in step. Dropout and drop path
    draw from `generator` (each rank's own)."""

    def __init__(self, key: int, generator: Optional[torch.Generator] = None):
        super().__init__(generator)
        self.key = int(key)

    def uniforms(self, site, image: int, n: int, device
                 ) -> Tuple[Tensor, Tensor]:
        site = 0 if site == 'rpn' else site + 1
        seed = ((self.key * 1_000_003 + site) * 1_000_003 + image) % 2**63
        u = torch.rand(2, n, generator=torch.Generator().manual_seed(seed))
        return u[0].to(device), u[1].to(device)


class SampleResult(NamedTuple):
    pos_mask: Tensor      # [N] bool, sampled positives
    neg_mask: Tensor      # [N] bool, sampled negatives
    num_pos: Tensor       # scalar int32
    num_neg: Tensor       # scalar int32


def _rank(cand: Tensor, keys: Tensor) -> Tensor:
    keys = torch.where(cand, keys, torch.full_like(keys, float('inf')))
    order = torch.argsort(keys, stable=True)
    return torch.argsort(order, stable=True)


def random_sample(uniforms: Tuple[Tensor, Tensor], pos_cand: Tensor,
                  neg_cand: Tensor, num: int, pos_fraction: float
                  ) -> SampleResult:
    """Sampled masks from the mutually exclusive [N] candidate masks;
    `uniforms` is the (positive, negative) pair of [N] keys."""
    u_pos, u_neg = uniforms
    n_pos = pos_cand.sum().clamp(max=int(num * pos_fraction))
    pos_sel = pos_cand & (_rank(pos_cand, u_pos) < n_pos)
    n_neg = torch.minimum(neg_cand.sum(), num - n_pos)
    neg_sel = neg_cand & (_rank(neg_cand, u_neg) < n_neg)
    return SampleResult(pos_sel, neg_sel, n_pos.int(), n_neg.int())


def select_fixed(sample: SampleResult, num: int
                 ) -> Tuple[Tensor, Tensor, Tensor]:
    """`num` fixed indices of the sampled rows, positives first.

    Returns (indices [num] int32, is_pos [num] bool, valid [num] bool);
    unfilled slots point at index 0 with valid False.
    """
    pos, neg = sample.pos_mask, sample.neg_mask
    n = pos.shape[0]
    key = torch.where(pos, 0, torch.where(neg, 1, 2))
    order = torch.argsort(key, stable=True)
    pad_valid = torch.arange(num, device=pos.device) < n
    if n < num:
        order = torch.cat([order, order.new_zeros(num - n)])
    idx = order[:num]
    sel = (pos | neg)[idx] & pad_valid
    is_pos = pos[idx] & sel
    idx = torch.where(sel, idx, torch.zeros_like(idx))
    return idx.int(), is_pos, sel
