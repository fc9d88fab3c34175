"""Kernel A and B weights packed for the tensor-core plan, on the CPU.

Folding (`ops/chain.py`) packs the projection weights once as bf16,
transposed to [N][K] and zero-padded (head dim to a multiple of 16, K and
N to multiples of 64): `wqkv_p`, `wo_p`, `w1_p`, `w2_p`. These tests hold
the packed tensors to the folded float32 weights they come from, check
that the padding is zero and inert in a product, and that the cached
`folded()` re-packs after an in-place parameter change.
"""

import numpy as np
import pytest
import torch

from hrfuser_tpu_torch.layers.attention import (HRFormerBlock,
                                                HRFuserFusionBlock)
from hrfuser_tpu_torch.ops import block, chain, window_attention

WIDTHS = [(8, 2), (18, 1), (78, 2), (624, 16)]     # (C, heads): d 4 .. 39


def _random(module, seed):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.from_numpy(rng.normal(0, 0.5, p.shape)
                                     .astype(np.float32)))
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_var.copy_(torch.from_numpy(
                    rng.uniform(0.5, 2.0, m.num_features).astype(np.float32)))
    return module.eval()


def _attn_of(kind, c, heads):
    if kind == 'hrformer':
        blk = _random(HRFormerBlock(c, heads), c)
        return blk, [blk.folded()['attn']], blk.folded()['ffn']
    blk = _random(HRFuserFusionBlock(c, heads, 2), c + 1)
    return blk, blk.folded()['attn'], blk.folded()['ffn']


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _unpack_attention(p, num_heads):
    """The float32 [C, 3C] Wqkv and [C, C] Wo that `chain.pack_attention`'s
    bf16 tensors hold (its inverse, up to the bf16 rounding)."""
    c = p['wo'].shape[0]
    d = c // num_heads
    dp = -(-d // 16) * 16
    heads = p['wqkv_p'].float().reshape(num_heads, 3, dp, -1)[:, :, :d, :c]
    wqkv = heads.transpose(0, 1).reshape(3 * c, c).t()
    return wqkv, p['wo_p'].float()[:c, :c].t()


@pytest.mark.parametrize('kind', ['hrformer', 'fusion'])
@pytest.mark.parametrize('c,heads', WIDTHS)
def test_packed_attention_unpacks_to_the_folded_weights(kind, c, heads):
    _, attns, _ = _attn_of(kind, c, heads)
    d = c // heads
    dp, kp = -(-d // 16) * 16, -(-c // 64) * 64
    for p in attns:
        assert p['wqkv_p'].dtype == p['wo_p'].dtype == torch.bfloat16
        assert tuple(p['wqkv_p'].shape) == (heads * 3 * dp, kp)
        assert tuple(p['wo_p'].shape) == (kp, kp)
        wqkv, wo = _unpack_attention(p, heads)
        assert torch.equal(wqkv, _bf16(p['wqkv']))     # bf16 rounding only
        assert torch.equal(wo, _bf16(p['wo']))
        rows = p['wqkv_p'].float().reshape(heads, 3, dp, kp)
        assert not rows[:, :, d:].any() and not rows[..., c:].any()
        assert not p['wo_p'][c:].any() and not p['wo_p'][:, c:].any()


@pytest.mark.parametrize('c,heads', WIDTHS)
def test_head_padding_is_inert_in_the_product(c, heads):
    """Zero-padded x [49, KP] times a head's packed rows gives that
    head's q | k | v of the unpadded weights, and zeros in the pad."""
    _, (p,), _ = _attn_of('hrformer', c, heads)
    d = c // heads
    dp, kp = -(-d // 16) * 16, -(-c // 64) * 64
    rng = np.random.default_rng(c)
    x = _bf16(torch.from_numpy(rng.normal(0, 1, (49, c)).astype(np.float32)))
    xp = torch.zeros((49, kp))
    xp[:, :c] = x
    full = xp @ p['wqkv_p'].float().t()            # [49, heads * 3 * dp]
    want = x @ _bf16(p['wqkv'])                    # [49, 3C]
    for h in range(heads):
        for part in range(3):
            got = full[:, (3 * h + part) * dp:(3 * h + part + 1) * dp]
            ref = want[:, part * c + h * d:part * c + (h + 1) * d]
            torch.testing.assert_close(got[:, :d], ref, atol=1e-4,
                                       rtol=1e-5)
            assert not got[:, d:].any()


@pytest.mark.parametrize('c,heads', WIDTHS)
def test_packed_cross_ffn_unpacks_to_the_folded_weights(c, heads):
    _, _, f = _attn_of('hrformer', c, heads)
    ch = 4 * c
    cp, chp = -(-c // 64) * 64, -(-ch // 64) * 64
    assert tuple(f['w1_p'].shape) == (chp, cp)
    assert tuple(f['w2_p'].shape) == (cp, chp)
    assert f['w1_p'].dtype == f['w2_p'].dtype == torch.bfloat16
    assert torch.equal(f['w1_p'][:ch, :c].float().t(), _bf16(f['w1']))
    assert torch.equal(f['w2_p'][:c, :ch].float().t(), _bf16(f['w2']))
    for t, (r, k) in ((f['w1_p'], (ch, c)), (f['w2_p'], (c, ch))):
        assert not t[r:].any() and not t[:, k:].any()


@pytest.mark.parametrize('kind', ['hrformer', 'fusion'])
def test_folded_repacks_after_in_place_change(kind):
    blk, attns, ffn = _attn_of(kind, 18, 2)
    first = blk.folded()
    assert blk.folded() is first                   # cached
    wq_p = attns[0]['wqkv_p'].clone()
    w1_p = ffn['w1_p'].clone()
    with torch.no_grad():
        for prm in blk.parameters():
            prm.mul_(2.0)
    again = blk.folded()
    assert again is not first
    attn = again['attn'] if kind == 'hrformer' else again['attn'][0]
    assert not torch.equal(attn['wqkv_p'], wq_p)
    assert not torch.equal(again['ffn']['w1_p'], w1_p)
    assert torch.equal(_unpack_attention(attn, 2)[0],
                       _bf16(attn['wqkv']))
    assert torch.equal(again['ffn']['w1_p'][:72, :18].float().t(),
                       _bf16(again['ffn']['w1']))


def test_kernel_entries_pack_through_the_same_code():
    """`ops/block.py` and `ops/window_attention.py` fold per-head and
    per-projection weights; both carry the packed tensors."""
    c, heads = 78, 2
    d = c // heads
    rng = np.random.default_rng(5)

    def t(*shape):
        return torch.from_numpy(rng.normal(0, 0.3, shape).astype(np.float32))

    mats = [t(c, c) for _ in range(4)]
    vecs = [t(c) for _ in range(4)]
    p = window_attention._fold(*mats, *vecs, t(heads, 49, 49), heads)
    assert torch.equal(_unpack_attention(p, heads)[0],
                       _bf16(p['wqkv']))
    ln = torch.stack([torch.ones(c), torch.zeros(c)])
    ws = [t(heads, c, d), t(heads, 1, d), t(heads, c, d), t(heads, 1, d),
          t(heads, c, d), t(heads, 1, d), t(heads, d, c), t(c)]
    bias_full = block.build_attn_bias(t(169, heads), heads, 7, 14,
                                      torch.float32)
    q = block._fold_heads(*ws, ln, ln, bias_full, 7, 14)
    wqkv, wo = _unpack_attention(q, heads)
    assert torch.equal(wqkv, _bf16(q['wqkv']))
    assert torch.equal(wo, _bf16(q['wo']))


def test_check_params_refuses_wrong_or_missing_packed_weights():
    """The launchers check the packed weights' dtype and shape; a folded
    dict without them is refused with a ValueError naming the key."""
    p = chain.pack_cross_ffn(dict(w1=torch.zeros(8, 32),
                                  w2=torch.zeros(32, 8)))
    with pytest.raises(ValueError, match="'w1_p'"):
        chain._check_params(dict(p, w1_p=p['w1_p'].float()),
                            {'w1_p': (64, 64)}, torch.device('cpu'))
    with pytest.raises(ValueError, match="'w9_p' missing"):
        chain._check_params(p, {'w9_p': (64, 64)}, torch.device('cpu'))
    chain._check_params(p, {'w1_p': (64, 64), 'w2_p': (64, 64)},
                        torch.device('cpu'))
