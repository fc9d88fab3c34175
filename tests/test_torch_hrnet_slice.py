"""The HRNet-based HRFuser slice vs the JAX detector on
`tiny_hrnet_fusion_test`, and its conv modules vs their flax twins.

The slice: a BASIC-block camera trunk and modality streams, nearest
upsample conv fuse paths and the MWCA fusion banks, then HRFPN, RPN,
proposals and the cascade. JAX variables -> bridge -> port, both packages
on the same 64x96 batch-1 inputs at f32 on the CPU, compared stage by
stage at the tolerances of `tests/oracles/slice_pair.py`.

The modules, each at 1e-5 against its flax module on random variables:
`BasicBlock` (with and without its downsample, eval and training, the
running statistics too), an up fuse path to sizes that are and are not
an integer multiple of its input (nearest, then the antialiased bilinear
fallback `jax.image.resize` takes when a side shrinks), a two-step down
fuse path, and a whole three-branch conv `HRModule` on odd map sizes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrfuser_tpu.configs import get_config as jax_get_config
from hrfuser_tpu.layers.common import BasicBlock as JaxBasicBlock
from hrfuser_tpu.models.backbones.hr_config import StageCfg as JaxStageCfg
from hrfuser_tpu.models.backbones.hr_modules import FuseDownConv
from hrfuser_tpu.models.backbones.hr_modules import FuseUp as JaxFuseUp
from hrfuser_tpu.models.backbones.hr_modules import HRModule as JaxHRModule
from hrfuser_tpu_torch.configs import get_config
from hrfuser_tpu_torch.layers.common import BasicBlock, run_seq
from hrfuser_tpu_torch.models.backbones.hr_config import StageCfg
from hrfuser_tpu_torch.models.backbones.hr_modules import (FuseUp, HRModule,
                                                           fuse_down)
from hrfuser_tpu_torch.utils.jax_weights import _Emitter
from tests.oracles.random_variables import random_variables
from tests.oracles.slice_pair import (SlicePair, check_backbone,
                                     check_decode, check_detections,
                                     check_neck_and_rpn, check_proposals)

NAME = 'tiny_hrnet_fusion_test'
HW = (64, 96)
TOL = 1e-5


@pytest.fixture(scope='module')
def s():
    return SlicePair(jax_get_config(NAME).model, get_config(NAME), HW)


@pytest.mark.parametrize('branch', range(4))
def test_backbone_branches_match_jax(s, branch):
    check_backbone(s, branch)


@pytest.mark.parametrize('lvl', range(5))
def test_neck_and_rpn_maps_match_jax(s, lvl):
    check_neck_and_rpn(s, lvl)


def test_proposals_match_jax(s):
    check_proposals(s)


def test_decode_cascade_matches_jax_on_identical_proposals(s):
    check_decode(s)


def test_predict_detections_match_jax(s):
    check_detections(s)


def test_trunk_and_streams_are_conv_blocks(s):
    """The camera stages and modality stages B / C hold BASIC blocks
    only; the fusion banks are the model's only transformer blocks."""
    bb = s.model.backbone
    kinds = {type(m).__name__ for name in ('stage2', 'stage3', 'stage4',
                                           'stage_b', 'stage_c')
             for m in getattr(bb, name).modules()}
    assert 'BasicBlock' in kinds and 'HRFormerBlock' not in kinds
    assert not hasattr(bb, 'stage_d')


def _port_sd(variables, emit):
    """A flax module's variables by port name (`emit` on an `_Emitter`
    with the empty prefix)."""
    e = _Emitter(variables)
    emit(e)
    return {k.lstrip('.'): v for k, v in e.sd.items()}


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('cin', [8, 12], ids=['identity', 'downsample'])
def test_basic_block_matches_flax(cin, train):
    x = _x((2, 9, 11, cin))
    blk = JaxBasicBlock(planes=8, with_downsample=cin != 8)
    v = random_variables(blk, jnp.asarray(x), train, seed=1)
    if train:
        want, upd = blk.apply(v, jnp.asarray(x), True,
                              mutable=['batch_stats'])
    else:
        want = blk.apply(v, jnp.asarray(x), False)
    port = BasicBlock(cin, 8)
    port.load_state_dict(_port_sd(v, lambda e: [
        e.convnorm(f'conv{j}', f'bn{j}', (f'conv{j}',)) for j in (1, 2)]
        + ([e.convnorm('downsample.0', 'downsample.1', ('downsample',))]
           if cin != 8 else [])), strict=False)
    port.train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    if train:
        stats = _port_sd({'params': v['params'], **upd}, lambda e: [
            e.bn(f'bn{j}', (f'conv{j}', 'norm')) for j in (1, 2)])
        sd = port.state_dict()
        for k in stats:
            if k.endswith(('running_mean', 'running_var')):
                np.testing.assert_allclose(sd[k].numpy(), stats[k].numpy(),
                                           atol=TOL, rtol=TOL, err_msg=k)


@pytest.mark.parametrize('out_hw', [(6, 8), (5, 7), (5, 8)])
def test_up_fuse_path_matches_flax(out_hw):
    """3x4 -> nearest x2 -> 6x8, then to `out_hw`: (6, 8) is the integer
    multiple, (5, 7) and (5, 8) take the bilinear fallback."""
    x = _x((1, 3, 4, 16))
    up = JaxFuseUp(out_ch=8, mode='nearest', factor=2)
    v = random_variables(up, jnp.asarray(x), out_hw, False, seed=2)
    want = up.apply(v, jnp.asarray(x), out_hw, False)
    port = FuseUp(16, 8, 2, nearest=True).eval()
    port.load_state_dict(_port_sd(v, lambda e: e.convnorm('0', '1',
                                                          ('proj',))))
    with torch.no_grad():
        got = port(torch.from_numpy(x), out_hw)
    assert tuple(got.shape) == (1, *out_hw, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize('out_hw', [(6, 8), (5, 7)])
def test_up_fuse_path_runs_in_bf16(out_hw):
    """bf16 through the integer path and the bilinear fallback (whose
    antialiased resize runs in float32: the CPU has no bf16 kernel of
    it): bf16 out, within 2e-2 of the float32 path's largest value."""
    torch.manual_seed(0)
    port = FuseUp(16, 8, 2, nearest=True).eval()
    x = torch.from_numpy(_x((1, 3, 4, 16)))
    with torch.no_grad():
        want = port(x, out_hw)
        got = port(x.bfloat16(), out_hw)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert (got.float() - want).abs().max() <= 2e-2 * want.abs().max()


def test_down_fuse_path_matches_flax():
    """Two stride-2 3x3 + BN steps, ReLU between them, from 9x13 to 3x4."""
    x = _x((1, 9, 13, 8))
    down = FuseDownConv(in_ch=8, out_ch=24, steps=2)
    v = random_variables(down, jnp.asarray(x), False, seed=3)
    want = down.apply(v, jnp.asarray(x), False)
    port = fuse_down(8, 24, 2, former=False).eval()
    port.load_state_dict(_port_sd(v, lambda e: [
        e.convnorm(f'{k}.0', f'{k}.1', (f'step{k}',)) for k in (0, 1)]))
    with torch.no_grad():
        got = run_seq(port, torch.from_numpy(x))
    assert tuple(got.shape) == (1, 3, 4, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_conv_hr_module_on_odd_sizes_matches_flax():
    """Three BASIC branches at 9x13 / 5x7 / 3x4: every up path but none
    of the integer ones takes the fallback, the down paths stride into
    the odd sizes."""
    args = dict(num_modules=1, num_branches=3, block='BASIC',
                num_blocks=(2, 1, 1), num_channels=(8, 16, 24))
    xs = [_x((1, 9, 13, 8), 4), _x((1, 5, 7, 16), 5), _x((1, 3, 4, 24), 6)]
    jmod = JaxHRModule(JaxStageCfg(**args), in_channels=(8, 16, 24))
    v = random_variables(jmod, [jnp.asarray(x) for x in xs], False, seed=7)
    want = jmod.apply(v, [jnp.asarray(x) for x in xs], False)
    stage = StageCfg(**args)
    port = HRModule(stage).eval()
    port.load_state_dict(_port_sd(v, lambda e: e.hr_module('', (), stage)),
                         strict=True)
    with torch.no_grad():
        got = port([torch.from_numpy(x) for x in xs])
    for a, b in zip(got, want, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL,
                                   rtol=TOL)
