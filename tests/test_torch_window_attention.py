"""Port `ops.window_attention.fused_window_attention` vs the JAX package.

The fast tier holds the port (on the CPU: its plain twin) to the pure-XLA
reference `_reference` of `tests/test_pallas_attention.py` at JAX's two
cases plus HRFuser-B's widest branch (C = 624, 16 heads); the `slow` tier
to `hrfuser_tpu.ops.pallas_attention.fused_window_attention` in interpret
mode. Float32, at JAX's tolerance 2e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrfuser_tpu_torch.ops import window_attention
from tests.test_pallas_attention import _reference

TOL = 2e-4
# (mode, windows, C, heads, zero vectors and bias): JAX's two cases, C=624
CASES = [('self', 10, 32, 2, False), ('cross', 7, 16, 1, True),
         ('cross', 3, 624, 16, False), ('self', 2, 624, 16, False)]


def _case(mode, w, c, h, zeros, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (w, 49, c)).astype(np.float32)
    y = x if mode == 'self' else rng.normal(0, 1, (w, 49, c)).astype(
        np.float32)
    mats = [rng.normal(0, 0.1, (c, c)).astype(np.float32) for _ in range(4)]
    if zeros:
        vecs = [np.zeros(c, np.float32) for _ in range(4)]
        bias = np.zeros((h, 49, 49), np.float32)
    else:
        vecs = [rng.normal(0, 0.1, c).astype(np.float32) for _ in range(4)]
        bias = rng.normal(0, 0.5, (h, 49, 49)).astype(np.float32)
    return x, y, mats, vecs, bias


def _port(x, y, mats, vecs, bias, h):
    t = torch.from_numpy
    tx = t(x)
    ty = tx if y is x else t(y)
    return window_attention.fused_window_attention(
        tx, ty, *map(t, mats), *map(t, vecs), t(bias), h,
        block_windows=4, interpret=True)


@pytest.mark.parametrize('mode,w,c,h,zeros', CASES)
def test_matches_reference(mode, w, c, h, zeros):
    x, y, mats, vecs, bias = _case(mode, w, c, h, zeros)
    want = _reference(jnp.asarray(x), jnp.asarray(y),
                      *map(jnp.asarray, mats), *map(jnp.asarray, vecs),
                      jnp.asarray(bias), h)
    got = _port(x, y, mats, vecs, bias, h)
    assert got.shape == (w, 49, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_other_window_sizes_raise_naming_the_limit():
    x, y, mats, vecs, bias = _case('self', 2, 16, 1, False)
    t = torch.from_numpy
    with pytest.raises(ValueError, match='N = 49'):
        window_attention.fused_window_attention(
            t(x[:, :36]), t(y[:, :36]), *map(t, mats), *map(t, vecs),
            t(bias[:, :36, :36]), 1)


def test_cpu_keeps_dtype_and_counts_no_launch():
    x, y, mats, vecs, bias = _case('cross', 3, 16, 2, False)
    t = torch.from_numpy
    before = window_attention.fused_window_attention.launches
    out = window_attention.fused_window_attention(
        t(x).bfloat16(), t(y).bfloat16(), *map(t, mats), *map(t, vecs),
        t(bias), 2)
    assert out.dtype == torch.bfloat16
    assert window_attention.fused_window_attention.launches == before


@pytest.mark.slow
@pytest.mark.parametrize('mode,w,c,h,zeros', CASES)
def test_matches_pallas_interpret(mode, w, c, h, zeros):
    from hrfuser_tpu.ops.pallas_attention import fused_window_attention
    x, y, mats, vecs, bias = _case(mode, w, c, h, zeros)
    want = fused_window_attention(
        jnp.asarray(x), jnp.asarray(y), *map(jnp.asarray, mats),
        *map(jnp.asarray, vecs), jnp.asarray(bias), num_heads=h,
        block_windows=4, interpret=True)
    got = _port(x, y, mats, vecs, bias, h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
