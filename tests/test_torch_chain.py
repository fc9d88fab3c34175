"""Port block chains vs the JAX package's flax blocks, f32 on CPU.

`hrfuser_tpu_torch.ops.chain.hrformer_chain` / `fusion_chain` (on CPU:
the plain twins of kernels A and B, with eval-folded weights) and the
port's eager `HRFormerBlock` / `HRFuserFusionBlock` modules must match
the flax `HRFormerBlock` chain and `HRFuserFusionBlock` on the same numpy
inputs, with the weights carried over by the bridge
(`utils/jax_weights.py`). On the CPU the JAX package runs these blocks
through flax (`resolve_chain('auto')` is off-TPU false), which is what is
compared here; the `slow` cases add the Pallas kernels in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from hrfuser_tpu.layers.attention import HRFormerBlock as JaxBlock
from hrfuser_tpu.layers.attention import HRFuserFusionBlock as JaxFusion
from hrfuser_tpu_torch.layers.attention import (HRFormerBlock,
                                                HRFuserFusionBlock)
from hrfuser_tpu_torch.ops import chain
from hrfuser_tpu_torch.utils.jax_weights import (fusion_block_state_dict,
                                                 hrformer_block_state_dict)
from tests.oracles.random_variables import random_variables

ATOL = RTOL = 1e-4
MLP = 2


class _JaxChain(nn.Module):
    n_blocks: int
    num_heads: int

    @nn.compact
    def __call__(self, x):
        for i in range(self.n_blocks):
            x = JaxBlock(num_heads=self.num_heads, window_size=7,
                         mlp_ratio=MLP, name=f'b{i}')(x, False)
        return x


def _port_blocks(variables, n_blocks, c, heads):
    sd = {}
    for i in range(n_blocks):
        block_vars = {k: variables[k][f'b{i}']
                      for k in ('params', 'batch_stats')}
        sd.update({f'{i}.{k}': v for k, v in
                   hrformer_block_state_dict(block_vars).items()})
    seq = torch.nn.Sequential(*[HRFormerBlock(c, heads, 7, MLP)
                                for _ in range(n_blocks)])
    seq.load_state_dict(sd, strict=True)
    return seq.eval()


def _port_fusion(variables, c, heads, m):
    blk = HRFuserFusionBlock(c, heads, m, 7, MLP)
    blk.load_state_dict(fusion_block_state_dict(variables, m), strict=True)
    return blk.eval()


def _inputs(rng, n, shape):
    return [rng.normal(0, 1, shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize('h,w,c,heads,n_blocks,n_streams', [
    (13, 17, 8, 1, 2, 1),        # ragged: centre padding on both axes
    (13, 17, 8, 2, 2, 1),        # 2 heads
    (14, 21, 6, 2, 1, 1),        # exact windows, odd head dim 3
    (13, 17, 8, 1, 2, 2),        # 2 streams stacked on the batch
    (9, 23, 12, 2, 3, 2),
])
def test_hrformer_chain_matches_flax(h, w, c, heads, n_blocks, n_streams):
    rng = np.random.default_rng(h * w + n_streams)
    xs = _inputs(rng, n_streams, (2, h, w, c))
    jax_chain = _JaxChain(n_blocks, heads)
    refs, blocks, eager = [], [], []
    for s, x in enumerate(xs):
        v = random_variables(jax_chain, jnp.asarray(x), seed=10 + s)
        refs.append(np.asarray(jax_chain.apply(v, jnp.asarray(x))))
        port = _port_blocks(v, n_blocks, c, heads)
        blocks += [blk.folded() for blk in port]
        with torch.no_grad():
            eager.append(port(torch.from_numpy(x)).numpy())
    got = chain.hrformer_chain(torch.from_numpy(np.concatenate(xs)), blocks,
                               heads, n_streams=n_streams).numpy()
    np.testing.assert_allclose(got, np.concatenate(refs), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(np.concatenate(eager), np.concatenate(refs),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize('m,heads', [(2, 1), (3, 1), (2, 2)])
def test_fusion_chain_matches_flax(m, heads):
    h, w, c = 13, 17, 8
    rng = np.random.default_rng(m * 10 + heads)
    x, *mods = _inputs(rng, m + 1, (2, h, w, c))
    blk = JaxFusion(num_heads=heads, num_modalities=m, window_size=7,
                    mlp_ratio=MLP)
    jx, jm = jnp.asarray(x), [jnp.asarray(z) for z in mods]
    v = random_variables(blk, jx, jm, False, seed=m)
    ref = np.asarray(blk.apply(v, jx, jm, False))
    port = _port_fusion(v, c, heads, m)
    tx, tm = torch.from_numpy(x), [torch.from_numpy(z) for z in mods]
    got = chain.fusion_chain(tx, tm, port.folded(), heads).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    with torch.no_grad():
        np.testing.assert_allclose(port(tx, tm).numpy(), ref, atol=ATOL,
                                   rtol=RTOL)


def test_cpu_wrappers_take_the_plain_twin_and_count_no_launch():
    rng = np.random.default_rng(0)
    blk = HRFormerBlock(8, 2, 7, MLP).eval()
    fus = HRFuserFusionBlock(8, 2, 2, 7, MLP).eval()
    x, z0, z1 = (torch.from_numpy(a) for a in _inputs(rng, 3, (1, 9, 11, 8)))
    counts = (chain.window_self_attention.launches,
              chain.window_cross_attention.launches, chain.cross_ffn.launches)
    p = blk.folded()
    got = chain.window_self_attention(x, p['attn'], 2)
    want = chain.window_attention_plain(x, x, p['attn'], 2)
    assert torch.equal(got, want)
    assert torch.equal(chain.cross_ffn(x, p['ffn']),
                       chain.cross_ffn_plain(x, p['ffn']))
    chain.fusion_chain(x, [z0, z1], fus.folded(), 2)
    assert counts == (chain.window_self_attention.launches,
                      chain.window_cross_attention.launches,
                      chain.cross_ffn.launches)


def test_wrappers_reject_other_devices():
    blk = HRFormerBlock(8, 1, 7, MLP).eval()
    x = torch.empty((1, 7, 7, 8), device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        chain.window_self_attention(x, blk.folded()['attn'], 1)
    with pytest.raises(ValueError, match='unsupported device'):
        chain.cross_ffn(x, blk.folded()['ffn'])


def test_folded_weights_follow_load_state_dict():
    blk = HRFormerBlock(8, 1, 7, MLP).eval()
    first = blk.folded()
    assert blk.folded() is first                 # cached
    sd = {k: v + 1 if v.is_floating_point() else v
          for k, v in blk.state_dict().items()}
    blk.load_state_dict(sd)
    again = blk.folded()
    assert again is not first
    assert not torch.equal(again['attn']['wqkv'], first['attn']['wqkv'])


@pytest.mark.slow
def test_chains_match_pallas_interpret():
    """The JAX Pallas chain kernels, interpreted, agree with the port at
    the tolerance `tests/test_pallas_chain.py` holds them to flax."""
    from hrfuser_tpu.ops.pallas_chain import fusion_chain, hrformer_chain
    h, w, c, heads = 14, 21, 6, 1
    rng = np.random.default_rng(7)
    x, z0, z1 = _inputs(rng, 3, (2, h, w, c))
    jax_chain = _JaxChain(2, heads)
    v = random_variables(jax_chain, jnp.asarray(x), seed=3)
    cf = lambda a: jnp.asarray(a).transpose(0, 3, 1, 2)
    ref = hrformer_chain(cf(x), [{'params': v['params'][f'b{i}'],
                                  'batch_stats': v['batch_stats'][f'b{i}']}
                                 for i in range(2)],
                         num_heads=heads, interpret=True)
    port = _port_blocks(v, 2, c, heads)
    got = chain.hrformer_chain(torch.from_numpy(x),
                               [b.folded() for b in port], heads)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(ref).transpose(0, 2, 3, 1),
                               atol=2e-2, rtol=2e-2)

    blk = JaxFusion(num_heads=heads, num_modalities=2, window_size=7,
                    mlp_ratio=MLP)
    jm = [jnp.asarray(z0), jnp.asarray(z1)]
    fv = random_variables(blk, jnp.asarray(x), jm, False, seed=4)
    ref = fusion_chain(cf(x), [cf(z0), cf(z1)], fv, num_heads=heads,
                       interpret=True)
    fport = _port_fusion(fv, c, heads, 2)
    got = chain.fusion_chain(torch.from_numpy(x),
                             [torch.from_numpy(z0), torch.from_numpy(z1)],
                             fport.folded(), heads)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(ref).transpose(0, 2, 3, 1),
                               atol=2e-2, rtol=2e-2)
