"""Port block-level ops (`hrfuser_tpu_torch.ops.block`) vs the JAX package.

The fast tier holds the entries (on the CPU: the plain twins of kernels A
and B) to the flax `HRFormerBlock` / `HRFuserFusionBlock`, as
`tests/test_pallas_block.py` holds the Pallas kernels, with the weights
carried over by the block bridge (`utils/jax_weights.py`), and the slab
entry `fused_window_attention` to a JAX composition of the same function
in every add_kv x self/cross combination. The `slow` tier adds the Pallas
kernels of `hrfuser_tpu.ops.pallas_block` in interpret mode. All float32,
at JAX's own tolerance 2e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrfuser_tpu.layers.attention import HRFormerBlock as JaxBlock
from hrfuser_tpu.layers.attention import HRFuserFusionBlock as JaxFusion
from hrfuser_tpu.layers.attention import _window_attention
from hrfuser_tpu.ops import pallas_block as jax_block
from hrfuser_tpu.ops.window import (center_pad_shape, relative_position_index,
                                    window_partition, window_reverse)
from hrfuser_tpu_torch.layers.attention import (HRFormerBlock,
                                                HRFuserFusionBlock)
from hrfuser_tpu_torch.ops import block
from hrfuser_tpu_torch.utils.jax_weights import (fusion_block_state_dict,
                                                 hrformer_block_state_dict)
from tests.oracles.random_variables import random_variables

TOL = 2e-4
# (H, W, C, heads): `tests/test_pallas_block.py:33`, HRFuser-B's widest
# branch and a ragged HRFuser-B branch-0 width
SHAPES = [(20, 26, 18, 1), (13, 12, 36, 2), (12, 20, 144, 8),
          (12, 20, 624, 16), (13, 12, 78, 2)]


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _port_block(v, c, heads):
    blk = HRFormerBlock(c, heads)
    blk.load_state_dict(hrformer_block_state_dict(v), strict=True)
    return blk.eval()


def _port_fusion(v, c, heads, m):
    blk = HRFuserFusionBlock(c, heads, m)
    blk.load_state_dict(fusion_block_state_dict(v, m), strict=True)
    return blk.eval()


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize('wp,heads', [(21, 2), (14, 1)])
def test_build_attn_bias_matches_jax(wp, heads):
    table = np.random.default_rng(wp).normal(0, 1, (169, heads))
    want = jax_block.build_attn_bias(jnp.asarray(table, jnp.float32), heads,
                                     7, wp, jnp.float32)
    got = block.build_attn_bias(_t(table), heads, 7, wp, torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('h,w,c,heads', SHAPES)
def test_hrformer_block_matches_flax(h, w, c, heads):
    rng = np.random.default_rng(h * 100 + c)
    x = rng.normal(0, 1, (2, h, w, c)).astype(np.float32)
    jblk = JaxBlock(num_heads=heads, window_size=7)
    v = random_variables(jblk, jnp.asarray(x), False, seed=c)
    want = jblk.apply(v, jnp.asarray(x), False)
    got = block.fused_hrformer_block(_t(x), _port_block(v, c, heads),
                                     num_heads=heads, window=7)
    _close(got, want)


@pytest.mark.parametrize('h,w,c,heads', [SHAPES[0], SHAPES[3], SHAPES[4]])
def test_fusion_block_matches_flax(h, w, c, heads):
    rng = np.random.default_rng(7 + c)
    x, z0, z1 = (rng.normal(0, 1, (2, h, w, c)).astype(np.float32)
                 for _ in range(3))
    jblk = JaxFusion(num_heads=heads, num_modalities=2, window_size=7)
    jm = [jnp.asarray(z0), jnp.asarray(z1)]
    v = random_variables(jblk, jnp.asarray(x), jm, False, seed=c + 1)
    want = jblk.apply(v, jnp.asarray(x), jm, False)
    got = block.fused_fusion_block(_t(x), [_t(z0), _t(z1)],
                                   _port_fusion(v, c, heads, 2),
                                   num_heads=heads, window=7)
    _close(got, want)


def test_ffn_zero_input_stays_finite():
    """Exactly-zero streams (RandomDrop) hit the LN zero-variance guard."""
    h, w, c, heads = 13, 12, 36, 2
    x = np.zeros((1, h, w, c), np.float32)
    jblk = JaxBlock(num_heads=heads, window_size=7)
    v = random_variables(jblk, jnp.ones((1, h, w, c)), False, seed=3)
    want = jblk.apply(v, jnp.asarray(x), False)
    got = block.fused_hrformer_block(_t(x), _port_block(v, c, heads),
                                     num_heads=heads)
    assert torch.isfinite(got).all()
    _close(got, want)


# ---------------------------------------------------------------------------
# the slab entry in every add_kv x self/cross combination
# ---------------------------------------------------------------------------

def _slab_case(mode, h=13, w=12, c=36, heads=2, seed=0):
    """Padded slabs, per-head weights and LNs; `mode`: 'self' (xkv is xq,
    one LN), 'self_ln2' (xkv is xq, a second LN), 'cross'."""
    rng = np.random.default_rng(seed)
    d = c // heads
    pt, pb, pl, pr = center_pad_shape(h, w, 7, 7)

    def slab():
        x = np.zeros((2, h + pt + pb, w + pl + pr, c), np.float32)
        x[:, pt:pt + h, pl:pl + w] = rng.normal(0, 1, (2, h, w, c))
        return x

    xq, res = slab(), slab()
    xkv = xq if mode != 'cross' else slab()
    ws = dict(
        wq=rng.normal(0, c ** -0.5, (heads, c, d)),
        bq=rng.normal(0, 0.1, (heads, 1, d)),
        wk=rng.normal(0, c ** -0.5, (heads, c, d)),
        bk=rng.normal(0, 0.1, (heads, 1, d)),
        wv=rng.normal(0, c ** -0.5, (heads, c, d)),
        bv=rng.normal(0, 0.1, (heads, 1, d)),
        wo=rng.normal(0, c ** -0.5, (heads, d, c)),
        bo=rng.normal(0, 0.1, (c,)))
    ws = {k: a.astype(np.float32) for k, a in ws.items()}
    lnq = np.stack([1 + rng.normal(0, 0.1, c), rng.normal(0, 0.1, c)])
    lnkv = lnq if mode == 'self' else np.stack(
        [1 + rng.normal(0, 0.1, c), rng.normal(0, 0.1, c)])
    table = rng.normal(0, 0.5, (169, heads)).astype(np.float32)
    return dict(xq=xq, xkv=xkv, res=res, ws=ws, lnq=lnq.astype(np.float32),
                lnkv=lnkv.astype(np.float32), table=table, heads=heads,
                pads=(pt, pl), hw=(h, w))


def _jax_slab_reference(case, add_kv):
    """The slab function composed from JAX ops: LN, the JAX package's
    centre-padded window partition and window attention."""
    (pt, pl), (h, w) = case['pads'], case['hw']
    heads, ws = case['heads'], case['ws']
    c = ws['bo'].shape[0]

    def ln(x, p):
        mu = x.mean(-1, keepdims=True)
        var = ((x - mu) ** 2).mean(-1, keepdims=True)
        inv = jnp.where(var > 0, 1 / jnp.sqrt(var + 1e-6), 0.0)
        return (x - mu) * inv * p[0] + p[1]

    def full(k):                                  # [h, C, d] -> [C, C]
        return jnp.asarray(ws[k]).transpose(1, 0, 2).reshape(c, c)

    real = (slice(None), slice(pt, pt + h), slice(pl, pl + w))
    qw = window_partition(ln(jnp.asarray(case['xq'][real]), case['lnq']),
                          7, 7)
    kw = window_partition(ln(jnp.asarray(case['xkv'][real]), case['lnkv']),
                          7, 7)
    q = qw @ full('wq') + ws['bq'].reshape(-1)
    k = kw @ full('wk') + ws['bk'].reshape(-1)
    v = kw @ full('wv') + ws['bv'].reshape(-1)
    idx = relative_position_index(7, 7).reshape(-1)
    bias = jnp.asarray(case['table'])[idx].reshape(49, 49, heads)
    o = _window_attention(q, k, v, heads, bias.transpose(2, 0, 1),
                          (c // heads) ** -0.5)
    o = o @ jnp.asarray(ws['wo']).reshape(c, c) + ws['bo']
    y = np.asarray(window_reverse(o, 2, h, w, 7, 7))
    out = case['res'] + (case['xkv'] if add_kv else 0)
    out = out.copy()
    out[real] += y
    return out


def _port_slab(case, add_kv):
    wp = case['xq'].shape[2]
    bias_full = block.build_attn_bias(_t(case['table']), case['heads'], 7,
                                      wp, torch.float32)
    xq = _t(case['xq'])
    xkv = xq if case['xkv'] is case['xq'] else _t(case['xkv'])
    lnq = _t(case['lnq'])
    lnkv = lnq if case['lnkv'] is case['lnq'] else _t(case['lnkv'])
    w = {k: _t(a) for k, a in case['ws'].items()}
    return block.fused_window_attention(
        xq, xkv, _t(case['res']), w['wq'], w['bq'], w['wk'], w['bk'],
        w['wv'], w['bv'], w['wo'], w['bo'], lnq, lnkv, bias_full,
        num_heads=case['heads'], window=7, pads=case['pads'], hw=case['hw'],
        add_kv=add_kv)


@pytest.mark.parametrize('add_kv', [False, True])
@pytest.mark.parametrize('mode', ['self', 'self_ln2', 'cross'])
def test_fused_window_attention_combinations(mode, add_kv):
    case = _slab_case(mode)
    got = _port_slab(case, add_kv)
    np.testing.assert_allclose(got.numpy(), _jax_slab_reference(case, add_kv),
                               rtol=TOL, atol=TOL)


def test_slab_entry_rejects_other_padding():
    case = _slab_case('self')
    case['pads'] = (0, 0)
    with pytest.raises(ValueError, match='centre padding'):
        _port_slab(case, False)


def test_cpu_entries_take_the_twins_and_count_no_launch():
    rng = np.random.default_rng(0)
    blk = HRFormerBlock(8, 2).eval()
    fus = HRFuserFusionBlock(8, 2, 2).eval()
    x, z0, z1 = (torch.from_numpy(rng.normal(0, 1, (1, 9, 11, 8))
                                  .astype(np.float32)) for _ in range(3))
    counts = (block.fused_window_attention.launches,
              block.fused_cross_ffn.launches)
    with torch.no_grad():
        torch.testing.assert_close(
            block.fused_hrformer_block(x, blk, num_heads=2), blk(x))
        torch.testing.assert_close(
            block.fused_fusion_block(x, [z0, z1], fus, num_heads=2),
            fus(x, [z0, z1]))
        y = x + blk.attn(blk.norm1(x))
        torch.testing.assert_close(
            block.fused_cross_ffn(y, blk.ffn, blk.norm2), blk(x))
    assert counts == (block.fused_window_attention.launches,
                      block.fused_cross_ffn.launches)
    with pytest.raises(ValueError, match='heads'):
        block.fused_hrformer_block(x, blk, num_heads=1)


# ---------------------------------------------------------------------------
# slow: the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize('h,w,c,heads', SHAPES)
def test_block_entries_match_pallas_interpret(h, w, c, heads):
    rng = np.random.default_rng(c)
    x, z0, z1 = (rng.normal(0, 1, (2, h, w, c)).astype(np.float32)
                 for _ in range(3))
    jx, jm = jnp.asarray(x), [jnp.asarray(z0), jnp.asarray(z1)]
    v = random_variables(JaxBlock(num_heads=heads, window_size=7), jx, False,
                         seed=c)
    want = jax_block.fused_hrformer_block(jx, v, num_heads=heads, window=7,
                                          interpret=True)
    got = block.fused_hrformer_block(_t(x), _port_block(v, c, heads),
                                     num_heads=heads)
    _close(got, want)
    fv = random_variables(JaxFusion(num_heads=heads, num_modalities=2,
                                    window_size=7), jx, jm, False, seed=c + 1)
    want = jax_block.fused_fusion_block(jx, jm, fv, num_heads=heads,
                                        window=7, interpret=True)
    got = block.fused_fusion_block(_t(x), [_t(z0), _t(z1)],
                                   _port_fusion(fv, c, heads, 2),
                                   num_heads=heads)
    _close(got, want)


@pytest.mark.slow
@pytest.mark.parametrize('add_kv', [False, True])
@pytest.mark.parametrize('mode', ['self', 'self_ln2', 'cross'])
def test_fused_window_attention_matches_pallas_interpret(mode, add_kv):
    case = _slab_case(mode)
    wp = case['xq'].shape[2]
    bias_full = jax_block.build_attn_bias(jnp.asarray(case['table']),
                                          case['heads'], 7, wp, jnp.float32)
    ws = {k: jnp.asarray(a) for k, a in case['ws'].items()}
    want = jax_block.fused_window_attention(
        jnp.asarray(case['xq']), jnp.asarray(case['xkv']),
        jnp.asarray(case['res']), ws['wq'], ws['bq'], ws['wk'], ws['bk'],
        ws['wv'], ws['bv'], ws['wo'], ws['bo'], jnp.asarray(case['lnq']),
        jnp.asarray(case['lnkv']), bias_full, num_heads=case['heads'],
        window=7, pads=case['pads'], hw=case['hw'], add_kv=add_kv,
        interpret=True)
    _close(_port_slab(case, add_kv), want)
