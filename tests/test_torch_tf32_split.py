"""The float32 kernel plans' split-TF32 arithmetic, on the CPU.

Kernels A and B multiply float32 on tensor cores ('tf32x3' plans): every
operand x is split as hi + lo, each a TF32 value (`cvt.rna.tf32.f32`:
round to nearest, ties away from zero), and a product is formed as
lo_a.hi_b + hi_a.lo_b + hi_a.hi_b (`csrc/common.cuh:split_tf32`,
`mma_split`). `hrfuser_tpu_torch.ops.chain.split_tf32` /
`split_tf32_matmul` mirror that in PyTorch. Here the mirror is held to
its definition, and the plain twins with every product routed through it
(an emulation of the plans' arithmetic) are held to the JAX package's
float32 flax blocks at the bar the card holds the kernels to their twins
(1e-4); one-pass TF32 products miss that bar.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrfuser_tpu.layers.attention import HRFormerBlock as JaxBlock
from hrfuser_tpu.layers.attention import HRFuserFusionBlock as JaxFusion
from hrfuser_tpu_torch.layers.attention import (HRFormerBlock,
                                                HRFuserFusionBlock)
from hrfuser_tpu_torch.ops import chain
from hrfuser_tpu_torch.utils.jax_weights import (fusion_block_state_dict,
                                                 hrformer_block_state_dict)
from tests.oracles.random_variables import random_variables

BAR = 1e-4            # the card's bar for the 'tf32x3' plans vs the twins
MLP = 4               # the presets' mlp ratio
H, W = 13, 17         # ragged: centre padding on both axes


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize('scale', [1.0, 1e-30, 1e30])
def test_split_parts_are_tf32_and_sum_to_x(scale):
    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, 100_000).astype(np.float32)) * scale
    hi, lo = chain.split_tf32(x)
    assert int((_bits(hi) & 0x1FFF).abs().max()) == 0
    assert int((_bits(lo) & 0x1FFF).abs().max()) == 0
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max().item()
    assert rel <= 2.0 ** -22
    # hi alone keeps about 2^-11: the second term is what float32 needs
    assert ((hi.double() - x.double()).abs()
            / x.double().abs()).max().item() > 2.0 ** -14


def test_split_rounds_ties_away_from_zero():
    # 1 + 2^-11 lies halfway between the TF32 values 1 and 1 + 2^-10,
    # 1 + 3 * 2^-11 between 1 + 2^-10 and 1 + 2^-9
    half = torch.tensor([0x3F801000, 0x3F800FFF, 0x3F803000],
                        dtype=torch.int32).view(torch.float32)
    for sign in (1.0, -1.0):
        hi, lo = chain.split_tf32(sign * half)
        want = sign * torch.tensor([1 + 2 ** -10, 1.0, 1 + 2 ** -9])
        assert torch.equal(hi, want)
        assert torch.equal(lo, chain.split_tf32(sign * half - hi)[0])


def test_split_matmul_is_float32_accurate():
    rng = np.random.default_rng(1)
    a = rng.normal(0, 1, (49, 312)).astype(np.float32)
    b = rng.normal(0, 312 ** -0.5, (312, 120)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    split = chain.split_tf32_matmul(ta, tb).double().numpy()
    plain = (ta @ tb).double().numpy()
    one = (chain.split_tf32(ta)[0] @ chain.split_tf32(tb)[0]).double().numpy()
    err = {k: np.abs(v - exact).max()
           for k, v in (('split', split), ('plain', plain), ('one', one))}
    assert err['split'] <= 4 * err['plain']
    assert err['one'] > 30 * err['split']


def _one_pass(a, b):
    return chain.split_tf32(a)[0] @ chain.split_tf32(b)[0]


def _emulated_block(blk, x, heads, matmul):
    p = blk.folded()
    y = chain.window_attention_plain(x, x, p['attn'], heads, matmul=matmul)
    return chain.cross_ffn_plain(y, p['ffn'], matmul=matmul)


def _emulated_fusion(fus, x, zs, heads, matmul):
    p = fus.folded()
    out = x
    for z, pk in zip(zs, p['attn'], strict=True):
        out = chain.window_attention_plain(out, x, pk, heads, kv_src=z, z=z,
                                           matmul=matmul)
    return chain.cross_ffn_plain(out, p['ffn'], matmul=matmul)


def _miss(got, ref):
    """Largest excess over the bar's allclose limit (> 0: misses it)."""
    return float((np.abs(got - ref) - (BAR + BAR * np.abs(ref))).max())


@pytest.mark.parametrize('c,heads', [(18, 1), (78, 2)])
def test_split_emulated_hrformer_block_matches_flax(c, heads):
    rng = np.random.default_rng(c)
    x = rng.normal(0, 1, (2, H, W, c)).astype(np.float32)
    jblk = JaxBlock(num_heads=heads, window_size=7, mlp_ratio=MLP)
    v = random_variables(jblk, jnp.asarray(x), False, seed=c)
    ref = np.asarray(jblk.apply(v, jnp.asarray(x), False))
    blk = HRFormerBlock(c, heads, 7, MLP)
    blk.load_state_dict(hrformer_block_state_dict(v), strict=True)
    blk.eval()
    tx = torch.from_numpy(x)
    got = _emulated_block(blk, tx, heads, chain.split_tf32_matmul).numpy()
    np.testing.assert_allclose(got, ref, atol=BAR, rtol=BAR)
    assert _miss(_emulated_block(blk, tx, heads, _one_pass).numpy(), ref) > 0


@pytest.mark.parametrize('c,heads', [(18, 1), (78, 2)])
def test_split_emulated_fusion_block_matches_flax(c, heads):
    rng = np.random.default_rng(c + 1)
    x, z0, z1 = (rng.normal(0, 1, (2, H, W, c)).astype(np.float32)
                 for _ in range(3))
    jfus = JaxFusion(num_heads=heads, num_modalities=2, window_size=7,
                     mlp_ratio=MLP)
    jx, jm = jnp.asarray(x), [jnp.asarray(z0), jnp.asarray(z1)]
    v = random_variables(jfus, jx, jm, False, seed=c + 1)
    ref = np.asarray(jfus.apply(v, jx, jm, False))
    fus = HRFuserFusionBlock(c, heads, 2, 7, MLP)
    fus.load_state_dict(fusion_block_state_dict(v, 2), strict=True)
    fus.eval()
    tx, tz = torch.from_numpy(x), [torch.from_numpy(z0), torch.from_numpy(z1)]
    got = _emulated_fusion(fus, tx, tz, heads,
                           chain.split_tf32_matmul).numpy()
    np.testing.assert_allclose(got, ref, atol=BAR, rtol=BAR)
    assert _miss(_emulated_fusion(fus, tx, tz, heads, _one_pass).numpy(),
                 ref) > 0
