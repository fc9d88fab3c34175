"""FLOPs of a JAX function, counted on its jaxpr: products only.

Test support for `tests/test_torch_flops.py`, the oracle of the port's
FLOP count (`hrfuser_tpu_torch/apis/flops.py`). It walks a jaxpr and
every sub-jaxpr (`pjit`, `custom_jvp_call`, `custom_vjp_call`,
`checkpoint`, ...; a `scan` body times its length) and counts:

  * `2 * batch * M * N * K` for each `dot_general`;
  * `2 * output elements * (input channels / groups) * kernel taps` for
    each `conv_general_dilated`, grouped convolutions included; for one
    with a dilated input (the input gradient of a strided convolution),
    `2 * input elements * (output channels / groups) * kernel taps`, the
    products that are not with the zeros the dilation inserts;
  * the JAX package's `DepthwiseConv3x3` (`hrfuser_tpu/layers/common.py`),
    which computes a depthwise 3x3 convolution as 9 shifted multiply-adds
    (elementwise, so no eqn above), as the grouped convolution it is:
    `2 * 9` an output element. It is recorded when the module is called
    while the function is traced (`flax.linen.intercept_methods`), so it
    counts the forward only: the backward of a traced gradient goes
    through elementwise transposes, which nothing here counts.

Elementwise work is not counted. A product inside a `while` or `cond`
body raises: its count would depend on the data.

Each count is keyed by where it comes from: the innermost frame outside
JAX (`file:function`, the file relative to the repository when it is in
it), so a test can name and take out the contractions one package does
and the other does not.
"""

from __future__ import annotations

import os
from collections import Counter

import jax
import numpy as np
from flax import linen as nn
from jax._src import source_info_util
from jax.extend import core as jcore

from hrfuser_tpu.layers.common import DepthwiseConv3x3

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEPTHWISE = 'hrfuser_tpu/layers/common.py:DepthwiseConv3x3'


def _where(eqn) -> str:
    frame = source_info_util.user_frame(eqn.source_info.traceback)
    if frame is None:
        return '?'
    path = os.path.relpath(frame.file_name, ROOT)
    if path.startswith('..'):
        path = frame.file_name
    return f'{path}:{frame.function_name}'


def _dot_flops(eqn) -> int:
    (lc, _), _ = eqn.params['dimension_numbers']
    lhs = eqn.invars[0].aval.shape
    k = int(np.prod([lhs[i] for i in lc], dtype=np.int64))
    return 2 * int(np.prod(eqn.outvars[0].aval.shape, dtype=np.int64)) * k


def _conv_flops(eqn) -> int:
    lhs, rhs = eqn.invars[0].aval.shape, eqn.invars[1].aval.shape
    dn = eqn.params['dimension_numbers']
    spec = dn.rhs_spec                   # (out, in, spatial...)
    taps = int(np.prod([rhs[i] for i in spec[2:]], dtype=np.int64))
    groups = eqn.params['feature_group_count']
    if any(d > 1 for d in eqn.params['lhs_dilation']):
        # a transposed convolution (the input gradient of a strided one):
        # each input element meets each tap once; counted over the output,
        # the zeros the dilation inserts would count too
        lhs_elems = int(np.prod(lhs, dtype=np.int64))
        return 2 * lhs_elems * (rhs[spec[0]] // groups) * taps
    out = int(np.prod(eqn.outvars[0].aval.shape, dtype=np.int64))
    return 2 * out * rhs[spec[1]] * taps


def _subs(eqn):
    for v in eqn.params.values():
        for x in v if isinstance(v, (list, tuple)) else (v,):
            if isinstance(x, jcore.ClosedJaxpr):
                yield x.jaxpr
            elif isinstance(x, jcore.Jaxpr):
                yield x


def walk(jaxpr, counts: Counter, times: int = 1,
         data_dependent: bool = False) -> Counter:
    """Add the products of `jaxpr` (a `Jaxpr`), `times` over, to
    `counts`."""
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        flops = (_dot_flops(eqn) if name == 'dot_general' else
                 _conv_flops(eqn) if name == 'conv_general_dilated' else 0)
        if flops:
            if data_dependent:
                raise ValueError(f'{name} at {_where(eqn)} runs a number of '
                                 f'times that depends on the data')
            counts[_where(eqn)] += times * flops
        n = eqn.params['length'] if name == 'scan' else 1
        for sub in _subs(eqn):
            walk(sub, counts, times * n,
                 data_dependent or name in ('while', 'cond'))
    return counts


def trace(fn, *args):
    """(products of `fn(*args)` by origin, the `jax.stages.Traced` of
    `jax.jit(fn)`, which `.lower()` gives XLA's own cost analysis);
    `sum(counts.values())` is the total (see the module docstring)."""
    counts: Counter = Counter()

    def depthwise(next_fun, a, kw, context):
        out = next_fun(*a, **kw)
        if (isinstance(context.module, DepthwiseConv3x3)
                and context.method_name == '__call__'):
            counts[DEPTHWISE] += 2 * 9 * int(np.prod(out.shape))
        return out

    with nn.intercept_methods(depthwise):
        traced = jax.jit(fn).trace(*args)
    return walk(traced.jaxpr.jaxpr, counts), traced


def count(fn, *args) -> Counter:
    """The products of `fn(*args)` by origin."""
    return trace(fn, *args)[0]


def origin(counts: Counter, fragment: str) -> int:
    """The FLOPs of the origins whose key contains `fragment`."""
    return sum(v for k, v in counts.items() if fragment in k)
