"""Random JAX variables for a flax module, drawn with numpy.

Test support for the PyTorch port's parity tests: `jax.eval_shape` gives
the exact `{'params', 'batch_stats'}` tree that `module.init` would build
(seconds, where an eager `init` of the tiny detector takes about a
minute on CPU), and every leaf is filled from a numpy seed. Unlike a
fresh init, biases, LayerNorm affines, RPE tables and BatchNorm running
statistics are all non-trivial, so every weight folding is exercised.
"""

import jax
import numpy as np


def _leaf(rng, name, shape):
    if name == 'kernel':
        fan_in = int(np.prod(shape[:-1])) or 1
        return rng.normal(0.0, 1.0 / np.sqrt(fan_in), shape)
    if name == 'scale':
        return 1.0 + rng.normal(0.0, 0.1, shape)
    if name == 'var':
        return rng.uniform(0.5, 2.0, shape)
    if name == 'mean':
        return rng.normal(0.0, 0.3, shape)
    if name == 'relative_position_bias_table':
        return rng.normal(0.0, 0.5, shape)
    return rng.normal(0.0, 0.1, shape)               # biases


def random_variables(module, *args, seed=0, **kwargs):
    """Variables of `module.init(key, *args, **kwargs)`, numpy-filled."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = str(getattr(path[-1], 'key', path[-1]))
        return _leaf(rng, name, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))
