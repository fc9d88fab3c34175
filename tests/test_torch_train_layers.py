"""The port's training layers vs the JAX package's, f32 on the CPU.

- BatchNorm in training vs the flax `BatchNorm` (`hrfuser_tpu/layers/
  common.py:33-55`): output and updated running statistics at 1e-5;
  `nn.BatchNorm2d`'s own update (unbiased variance) would miss by
  n / (n - 1);
- `DropPath` and `Dropout`: keep rate, 1 / keep scaling, eval identity,
  draws only from the installed generator;
- train-mode HRFormer and fusion blocks (drop rates 0) vs flax's with
  `train=True`: output at 1e-4, every parameter's and the input's
  gradient within relative L2 1e-3 (the norm floored at 1e-3 of the
  largest gradient norm: a bias ahead of a training BatchNorm has an
  analytically zero gradient, float noise in both packages), running
  statistics at 1e-5;
- the camera front of HRFuser (stem, Bottleneck stage 1, the stage-2
  transition's conv-only quirk) in training vs flax's: outputs at 1e-4,
  every gradient within relative L2 1e-3;
- the one-hot RoIAlign (training pool) vs JAX's one-hot and gather pools
  and the port's plain gather twin: f32 at 1e-5 (gradients within
  relative L2 1e-5), bf16 operands vs JAX's bf16 one-hot at 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from hrfuser_tpu.layers.attention import HRFormerBlock as JaxBlock
from hrfuser_tpu.layers.attention import HRFuserFusionBlock as JaxFusion
from hrfuser_tpu.layers.common import BatchNorm as JaxBatchNorm
from hrfuser_tpu.ops.roi_align import \
    multilevel_roi_align as jax_gather_pool
from hrfuser_tpu.ops.roi_align import \
    multilevel_roi_align_onehot as jax_onehot_pool
from hrfuser_tpu_torch.layers.attention import (HRFormerBlock,
                                                HRFuserFusionBlock)
from hrfuser_tpu_torch.layers.common import (DropPath, Dropout,
                                             batch_norm_train,
                                             train_generator)
from hrfuser_tpu_torch.ops.roi_align import (multilevel_roi_align_onehot,
                                             multilevel_roi_align_plain)
from hrfuser_tpu_torch.utils.jax_weights import (fusion_block_state_dict,
                                                 hrformer_block_state_dict)
from tests.oracles.random_variables import random_variables

STATS_TOL, BLOCK_TOL, GRAD_REL = 1e-5, 1e-4, 1e-3


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """One intra-op thread: the tensors are small, and the test workers
    run side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def rel_l2(got, want, floor=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), floor)


def grad_floor(want_grads):
    """1e-3 of the largest gradient norm among `want_grads`."""
    return 1e-3 * max(np.linalg.norm(np.asarray(w)) for w in want_grads)


@pytest.mark.parametrize('shape', [(2, 5, 6, 8), (3, 1, 2, 16)])
def test_batch_norm_train_matches_flax(shape):
    rng = np.random.default_rng(0)
    c = shape[-1]
    x = (rng.normal(0, 2, shape) + rng.normal(0, 3, c)).astype(np.float32)
    v = {'params': {'bn': {'scale': rng.uniform(0.5, 1.5, c),
                           'bias': rng.normal(0, 0.3, c)}},
         'batch_stats': {'bn': {'mean': rng.normal(0, 0.3, c),
                                'var': rng.uniform(0.5, 2.0, c)}}}
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), v)
    want, upd = JaxBatchNorm().apply(v, jnp.asarray(x), True,
                                     mutable=['batch_stats'])
    bn = nn.BatchNorm2d(c)
    with torch.no_grad():
        bn.weight.copy_(_t(v['params']['bn']['scale']))
        bn.bias.copy_(_t(v['params']['bn']['bias']))
        bn.running_mean.copy_(_t(v['batch_stats']['bn']['mean']))
        bn.running_var.copy_(_t(v['batch_stats']['bn']['var']))
    torch_bn = nn.BatchNorm2d(c).train()
    torch_bn.load_state_dict(bn.state_dict())
    got = batch_norm_train(_t(x).permute(0, 3, 1, 2), bn).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=STATS_TOL, atol=STATS_TOL)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(upd['batch_stats']['bn']['mean']),
                               rtol=STATS_TOL, atol=STATS_TOL)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(upd['batch_stats']['bn']['var']),
                               rtol=STATS_TOL, atol=STATS_TOL)
    assert int(bn.num_batches_tracked) == 1
    torch_bn(_t(x).permute(0, 3, 1, 2))          # the trap: unbiased var
    assert not np.allclose(torch_bn.running_var.numpy(),
                           bn.running_var.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('cls', [DropPath, Dropout])
def test_drop_keep_rate_scaling_and_eval_identity(cls):
    x = torch.ones(4000, 3, 2, 2)
    m = cls(0.25).train()
    with pytest.raises(RuntimeError, match='generator'):
        m(x)
    with train_generator(torch.Generator().manual_seed(0)):
        y = m(x)
    with train_generator(torch.Generator().manual_seed(0)):
        assert torch.equal(m(x), y)              # the generator decides
    kept = y != 0
    assert torch.all(y[kept] == 1 / 0.75)
    assert abs(kept.float().mean().item() - 0.75) < 0.02
    if cls is DropPath:                          # whole samples at once
        assert torch.all(kept.all((1, 2, 3)) | (~kept).all((1, 2, 3)))
    assert cls(0.0).train()(x) is x              # no draw at rate 0
    assert m.eval()(x) is x


C, HEADS, HW = 16, 2, (9, 11)                    # centre-padded to 14x14


def _block_inputs(n_mods, seed=0):
    rng = np.random.default_rng(seed)
    shape = (2, *HW, C)
    x = rng.normal(0, 1, shape).astype(np.float32)
    mods = [rng.normal(0, 1, shape).astype(np.float32)
            for _ in range(n_mods)]
    cot = rng.normal(0, 1, shape).astype(np.float32)
    return x, mods, cot


def _check_block(jblk, port, args, cot, n_in):
    """Forward, running stats and gradients of a train-mode block."""
    variables = random_variables(jblk, *args, True, seed=3)
    stats = variables['batch_stats']

    def loss(params, *xs):
        out, upd = jblk.apply({'params': params, 'batch_stats': stats},
                              *xs, True, mutable=['batch_stats'])
        return jnp.sum(out * cot), (out, upd)

    jargs = [jnp.asarray(a) if not isinstance(a, list)
             else [jnp.asarray(m) for m in a] for a in args]
    (_, (want, upd)), grads = jax.value_and_grad(
        loss, argnums=tuple(range(n_in + 1)), has_aux=True)(
        variables['params'], *jargs)
    blk, sd_fn = port
    blk.load_state_dict(sd_fn(variables), strict=True)
    blk.train()
    targs = [_t(a).requires_grad_() if not isinstance(a, list)
             else [_t(m).requires_grad_() for m in a] for a in args]
    out = blk(*targs)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=BLOCK_TOL, atol=BLOCK_TOL)
    (out * _t(cot)).sum().backward()
    want_g = sd_fn({'params': grads[0], 'batch_stats': stats})
    params = dict(blk.named_parameters())
    floor = grad_floor(want_g[n] for n in params)
    for n, p in params.items():
        assert rel_l2(p.grad.numpy(), want_g[n], floor) < GRAD_REL, n
    got_in = [targs[0].grad] + [m.grad for m in (targs[1] if n_in > 1
                                                  else [])]
    want_in = [grads[1]] + (list(grads[2]) if n_in > 1 else [])
    for g, w in zip(got_in, want_in):
        assert rel_l2(g.numpy(), w) < GRAD_REL
    want_stats = sd_fn({'params': variables['params'],
                        'batch_stats': upd['batch_stats']})
    sd = blk.state_dict()
    for k in want_stats:
        if k.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(sd[k].numpy(), want_stats[k],
                                       rtol=STATS_TOL, atol=STATS_TOL,
                                       err_msg=k)


def test_hrformer_block_train_matches_flax():
    x, _, cot = _block_inputs(0)
    jblk = JaxBlock(num_heads=HEADS, window_size=7, mlp_ratio=4)
    _check_block(jblk, (HRFormerBlock(C, HEADS, 7, 4),
                        hrformer_block_state_dict), [x], cot, 1)


def test_fusion_block_train_matches_flax():
    x, mods, cot = _block_inputs(2, seed=1)
    jblk = JaxFusion(num_heads=HEADS, num_modalities=2, window_size=7,
                     mlp_ratio=4)
    _check_block(jblk, (HRFuserFusionBlock(C, HEADS, 2, 7, 4),
                        lambda v: fusion_block_state_dict(v, 2)),
                 [x, mods], cot, 2)


def test_camera_front_gradients_match_jax():
    from flax import linen as fnn
    from hrfuser_tpu.configs import get_config as jax_get_config
    from hrfuser_tpu.layers.common import ResLayer
    from hrfuser_tpu.models.backbones.hr_modules import Transition
    from hrfuser_tpu.models.backbones.hrformer import Stem
    from hrfuser_tpu_torch.configs import get_config
    from hrfuser_tpu_torch.models.backbones.hrformer import stem
    from hrfuser_tpu_torch.models.backbones.hrfuser import HRFuserBackbone
    from hrfuser_tpu_torch.utils.jax_weights import _Emitter
    jb = jax_get_config('tiny_fusion_test').model.backbone
    bb_cfg = get_config('tiny_fusion_test').backbone

    class Front(fnn.Module):
        @fnn.compact
        def __call__(self, x, train):
            x = Stem(name='stem')(x, train)
            x = ResLayer(jb.stage1.block, jb.stage1.num_channels[0],
                         jb.stage1.num_blocks[0], 64, name='layer1')(x, train)
            return Transition((jb.stage1.out_channels[0],),
                              jb.stage2.out_channels,
                              conv_only_on_existing=True,
                              name='transition1')([x], train)

    def port_names(variables):
        e = _Emitter(variables)
        e.convnorm('conv1', 'bn1', ('stem', 'conv1'))
        e.convnorm('conv2', 'bn2', ('stem', 'conv2'))
        e.res_layer('layer1', ('layer1',), bb_cfg.stage1.num_blocks[0])
        e.transition('transition1', ('transition1',),
                     bb_cfg.stage1.out_channels, bb_cfg.stage2.out_channels)
        return e.sd

    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 64, 96, 3)).astype(np.float32)
    front = Front()
    v = random_variables(front, jnp.asarray(x), True, seed=5)
    outs = front.apply(v, jnp.asarray(x), True, mutable=['batch_stats'])[0]
    cots = [rng.normal(0, 1, o.shape).astype(np.float32) for o in outs]

    def loss(p):
        o = front.apply({'params': p, 'batch_stats': v['batch_stats']},
                        jnp.asarray(x), True, mutable=['batch_stats'])[0]
        return sum(jnp.sum(a * c) for a, c in zip(o, cots))

    want = port_names({'params': jax.grad(loss)(v['params']),
                       'batch_stats': v['batch_stats']})
    bb = HRFuserBackbone(bb_cfg).train()
    bb.load_state_dict(port_names(v), strict=False)
    got = bb.transition1([bb.layer1(stem(_t(x), bb.conv1, bb.bn1, bb.conv2,
                                         bb.bn2))],
                         conv_only_on_existing=True)
    for a, b in zip(got, outs):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=BLOCK_TOL, atol=BLOCK_TOL)
    sum((a * _t(c)).sum() for a, c in zip(got, cots)).backward()
    names = [n for n, p in bb.named_parameters()
             if p.grad is not None and n in want]
    assert len(names) == 31
    for n in names:
        p = bb.get_parameter(n)
        assert rel_l2(p.grad.numpy(), want[n]) < GRAD_REL, n


STRIDES = (4, 8, 16, 32)


def _pool_inputs(seed=0, b=2, n=40, c=8, hw=(64, 96)):
    rng = np.random.default_rng(seed)
    feats = [rng.normal(0, 1, (b, hw[0] // s, hw[1] // s, c))
             .astype(np.float32) for s in STRIDES]
    xy = rng.uniform(-20, 90, (b, n, 2))
    wh = np.exp(rng.uniform(np.log(2), np.log(120), (b, n, 2)))
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    rois[:, 0] = [0., 0., 0., 0.]                 # a padded slot
    return feats, rois


def _jax_pool(fn, feats, rois, **kw):
    return np.stack([np.asarray(fn([jnp.asarray(f[i]) for f in feats],
                                   jnp.asarray(rois[i]), list(STRIDES),
                                   out_size=7, sample_num=2, **kw))
                     for i in range(rois.shape[0])])


@pytest.mark.parametrize('seed', [0, 1])
def test_onehot_pool_matches_jax_onehot_and_gather_f32(seed):
    feats, rois = _pool_inputs(seed)
    tfeats = [_t(f).requires_grad_() for f in feats]
    got = multilevel_roi_align_onehot(tfeats, _t(rois), STRIDES,
                                      bf16_operands=False)
    b, n = rois.shape[:2]
    onehot = _jax_pool(jax_onehot_pool, feats,
                       rois, compute_dtype=jnp.float32)
    gather = _jax_pool(jax_gather_pool, feats, rois)
    plain = multilevel_roi_align_plain([_t(f) for f in feats], _t(rois),
                                       STRIDES)
    for want in (onehot.reshape(b, n, 49, -1), gather.reshape(b, n, 49, -1),
                 plain.numpy()):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-5)
    cot = np.random.default_rng(9).normal(0, 1, got.shape).astype(np.float32)
    (got * _t(cot)).sum().backward()

    def loss(fs):
        out = jnp.stack([jax_onehot_pool(
            [f[i] for f in fs], jnp.asarray(rois[i]), list(STRIDES),
            compute_dtype=jnp.float32) for i in range(b)])
        return jnp.sum(out.reshape(cot.shape) * cot)

    want_g = jax.grad(loss)([jnp.asarray(f) for f in feats])
    for g, w in zip(tfeats, want_g):
        assert rel_l2(g.grad.numpy(), w) < 1e-5


def test_onehot_pool_bf16_operands_match_jax_bf16():
    feats, rois = _pool_inputs(2)
    got = multilevel_roi_align_onehot([_t(f) for f in feats], _t(rois),
                                      STRIDES, bf16_operands=True)
    want = _jax_pool(jax_onehot_pool, feats, rois,
                     compute_dtype=jnp.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.reshape(got.shape),
                               rtol=1e-2, atol=1e-2)
