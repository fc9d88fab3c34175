"""The port's train-step FLOP count against a count of the JAX package's
train-step jaxpr (`tests/oracles/jaxpr_flops.py`: products only).

`count_flops(train=True)` of `tiny_fusion_test` (forward_train and its
backward, batch 1 at 64x96, one gt box) against JAX's `make_train_step`
on the same batch (its AdamW update has no product). The count is exact
after two named corrections, measured; uncorrected the two totals differ
by 0.42 %, under the 5 % the count may miss by:
  * the depthwise 3x3 convolutions' backward: JAX computes them as 9
    shifted multiply-adds (`DepthwiseConv3x3`), whose gradients are
    elementwise and count nothing; the port's `convolution_backward`
    counts the input and the weight gradient, each its forward's count;
  * the resize: JAX's `bilinear_resize` contracts, forward and backward;
    the port's `F.interpolate` and its gradient count 0.
The one-hot RoIAlign of both training routes contracts alike and needs
no correction. No gradient differs: neither side takes one for the
inputs or for the proposals (stopped in both).

Marked `slow`: JAX's trace of its train step alone takes 60-130 s on the
CPU, more than the tier-1 run can give the new tool tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrfuser_tpu.apis.train import create_train_state, make_train_step
from hrfuser_tpu.configs import get_config as jax_get_config
from hrfuser_tpu.models import CascadeRCNN as JaxCascadeRCNN
from hrfuser_tpu_torch.apis.flops import count_flops
from hrfuser_tpu_torch.configs import get_config
from hrfuser_tpu_torch.models.detectors.cascade_rcnn import CascadeRCNN
from hrfuser_tpu_torch.utils.jax_weights import state_dict_from_jax
from tests.oracles import jaxpr_flops
from tests.oracles.random_variables import random_variables
from tests.oracles.threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.slow

NAME, HW, B = 'tiny_fusion_test', (64, 96), 1
TOLERANCE = 0.05


def test_train_step_is_the_jaxpr_count():
    exp = jax_get_config(NAME)
    jdet = JaxCascadeRCNN(exp.model)
    bb = exp.model.backbone
    rng = np.random.default_rng(0)
    img = rng.normal(0, 1, (B, *HW, 3)).astype(np.float32)
    mods = [rng.normal(0, 1, (B, *HW, c)).astype(np.float32)
            for c in bb.mod_in_channels[:bb.num_fused_modalities]]
    jmods = [jnp.asarray(m) for m in mods]
    variables = random_variables(jdet, jnp.asarray(img), jmods, False,
                                 seed=5)
    state, tx = create_train_state(jdet, variables, exp.optim, exp.schedule,
                                   steps_per_epoch=100)
    batch = dict(
        img=jnp.asarray(img), mod_imgs=jmods,
        gt_boxes=jnp.tile(jnp.asarray([[[10., 10., 100., 80.]]],
                                      jnp.float32), (B, 1, 1)),
        gt_labels=jnp.zeros((B, 1), jnp.int32),
        gt_valid=jnp.ones((B, 1), bool))
    counts = jaxpr_flops.count(make_train_step(jdet, tx), state, batch,
                               jax.random.PRNGKey(0))

    model = CascadeRCNN(get_config(NAME)).eval()
    model.load_state_dict(state_dict_from_jax(variables, model.cfg),
                          strict=True)
    got = count_flops(model, torch.from_numpy(img),
                      [torch.from_numpy(m) for m in mods], train=True)
    assert not model.training and all(p.grad is None
                                      for p in model.parameters())

    jax_total = sum(counts.values())
    depthwise = counts[jaxpr_flops.DEPTHWISE]
    resize = jaxpr_flops.origin(counts, 'common.py:bilinear_resize')
    rel = got['flops'] / jax_total - 1
    print(f'port {got["flops"]}, JAX products {jax_total} ({rel:+.2%}): '
          f'depthwise forward {depthwise}, resize {resize}')
    assert depthwise > 0 and resize > 0
    assert abs(rel) < TOLERANCE
    assert got['flops'] == jax_total + 2 * depthwise - resize
    assert got['entries'] == {}         # the train route launches no kernel
