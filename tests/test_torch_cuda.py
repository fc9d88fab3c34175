"""Hand-written CUDA kernels vs their plain PyTorch twins, on the card;
the serving path (preprocessing, `inference_detector`, checkpoints), the
image decoders and a loader batch on it.

Marked `cuda`: each test skips where `torch.cuda.is_available()` is
False (this file imports no JAX, so it also runs where JAX is absent):

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda

Tolerances: float32 with TF32 off 1e-3; bfloat16 0.05, as the Pallas
kernel tests use. For float32 both sides compute in float32 and round
once. For bfloat16 kernels A and B take their tensor-core plan ('mma'),
which rounds the operands to bf16 where the TPU kernels do (LN output,
q/k/v, probabilities, head outputs, the GELU'd hidden maps) and
accumulates in float32; the twins stay float32.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from hrfuser_tpu_torch import inference_detector, init_detector
from hrfuser_tpu_torch.data.device_pipeline import (make_device_preprocess,
                                                    resize_image, to_device)
from hrfuser_tpu_torch.layers.attention import (HRFormerBlock,
                                                HRFuserFusionBlock)
from hrfuser_tpu_torch.ops import block, chain, roi_align, window_attention
from hrfuser_tpu_torch.utils.checkpoint import save_checkpoint

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-3, torch.bfloat16: 0.05}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _randomized(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            scale = p[0].numel() ** -0.5 if p.dim() > 1 else 0.1
            p.copy_(torch.randn(p.shape, generator=g) * scale)
        for m in module.modules():
            if isinstance(m, (torch.nn.LayerNorm, torch.nn.BatchNorm2d)):
                m.weight.add_(1.0)
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.3, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
    return module.eval()


def _close(got, want, dt):
    assert got.dtype == want.dtype == dt
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dt],
                               rtol=TOL[dt])


SHAPES = [(13, 17, 8, 2), (7, 7, 18, 1), (96, 160, 18, 1), (12, 20, 144, 8),
          (25, 40, 72, 4), (13, 17, 36, 2),
          # HRFuser-B widths, head dim 39 (padded to 48 by the 'mma' plans);
          # float32: kernel A resident up to C = 156, streamed at 312 and
          # 624, kernel B chunked at 312 and 624
          (13, 12, 78, 2), (48, 80, 156, 4), (24, 40, 312, 8),
          (12, 20, 624, 16),
          # ragged 4x8 tiles and split fc2 columns at the widest C
          (13, 17, 624, 16),
          # the STF r1248 maps (HRFuser-T widths): widths 312 / 156 / 78 /
          # 39 leave kernel B's 8-wide tiles 0 / 4 / 6 / 7 columns over and
          # pad to 315 / 161 / 84 / 42 for kernel A's windows
          (96, 312, 18, 1), (48, 156, 36, 2), (24, 78, 72, 4),
          (12, 39, 144, 8)]


@pytest.mark.parametrize('dt', DTYPES)
@pytest.mark.parametrize('h,w,c,heads', SHAPES)
def test_self_attention_and_ffn_match_twins(dev, h, w, c, heads, dt):
    blk = _randomized(HRFormerBlock(c, heads), h * w).to(dev)
    p = blk.folded()
    x = torch.randn((2, h, w, c), device=dev).to(dt)
    n_attn = chain.window_self_attention.launches
    n_ffn = chain.cross_ffn.launches
    _close(chain.window_self_attention(x, p['attn'], heads),
           chain.window_attention_plain(x, x, p['attn'], heads), dt)
    _close(chain.cross_ffn(x, p['ffn']), chain.cross_ffn_plain(x, p['ffn']),
           dt)
    assert chain.window_self_attention.launches == n_attn + 1
    assert chain.cross_ffn.launches == n_ffn + 1


@pytest.mark.parametrize('dt', DTYPES)
@pytest.mark.parametrize('h,w,c,heads,m', [(13, 17, 8, 2, 3),
                                           (96, 160, 18, 1, 2),
                                           (12, 20, 144, 8, 2),
                                           (12, 20, 624, 16, 2),
                                           # STF: three modalities, r1248
                                           (96, 312, 18, 1, 3),
                                           (48, 156, 36, 2, 3),
                                           (24, 78, 72, 4, 3),
                                           (12, 39, 144, 8, 3)])
def test_fusion_chain_matches_eager_block(dev, h, w, c, heads, m, dt):
    fus = _randomized(HRFuserFusionBlock(c, heads, m), c + m).to(dev)
    x = torch.randn((2, h, w, c), device=dev)
    zs = [torch.randn((2, h, w, c), device=dev) for _ in range(m)]
    before = chain.window_cross_attention.launches
    got = chain.fusion_chain(x.to(dt), [z.to(dt) for z in zs],
                             fus.folded(), heads)
    assert chain.window_cross_attention.launches == before + m
    with torch.no_grad():
        want = fus(x, zs)
    tol = TOL[dt]
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize('dt', DTYPES)
def test_roi_align_matches_twin_on_edge_rois(dev, dt):
    g = torch.Generator().manual_seed(0)
    h, w = 72, 200                      # stride-32 level width 7: not /8
    feats = [torch.randn((2, -(-h // s), -(-w // s), 32), generator=g)
             .to(dev, dt) for s in (4, 8, 16, 32)]
    xy = torch.rand((2, 300, 2), generator=g) * torch.tensor([w, h]) - 10
    wh = torch.rand((2, 300, 2), generator=g) * torch.tensor([w, h])
    rois = torch.cat([xy, xy + wh], -1)
    rois[:, :10] = 0.0
    rois[:, 10] = torch.tensor([0., 10., w, 13.])
    rois[:, 11] = torch.tensor([-50., -40., -3., -1.])
    rois[:, 12] = torch.tensor([w + 3., h + 3., w + 90., h + 70.])
    rois = rois.to(dev).contiguous()
    before = roi_align.multilevel_roi_align.launches
    got = roi_align.multilevel_roi_align(feats, rois, (4, 8, 16, 32))
    assert roi_align.multilevel_roi_align.launches == before + 1
    _close(got, roi_align.multilevel_roi_align_plain(feats, rois,
                                                     (4, 8, 16, 32)), dt)


def _rois_on_level(g, b, n, h, w, level):
    """[b, n, 4] RoIs inside an h x w image: mixed sizes (level None), or
    every one on FPN level 0 (sides 4-110 px) or 3 (about the whole
    384 x 640 image)."""
    if level is None:
        xy = torch.rand((b, n, 2), generator=g) * torch.tensor([w, h]) - 10
        wh = torch.rand((b, n, 2), generator=g) ** 2 * torch.tensor([w, h])
        return torch.cat([xy, xy + wh + 1], -1)
    lo, hi = {0: ([4., 4.], [110., 110.]),
              3: ([530., 380.], [640., 384.])}[level]
    lo, hi = torch.tensor(lo), torch.tensor(hi)
    wh = lo + torch.rand((b, n, 2), generator=g) * (hi - lo)
    xy = torch.rand((b, n, 2), generator=g) * (torch.tensor([w, h]) - wh)
    return torch.cat([xy, xy + wh], -1)


@pytest.mark.parametrize('dt', DTYPES)
@pytest.mark.parametrize('level', [None, 0, 3])
@pytest.mark.parametrize('c', [32, 256])
def test_roi_align_matches_twin_by_width_and_level(dev, c, level, dt):
    """C = 32 (tiny_fusion_test; 8 RoIs a block group in bf16) and 256
    (every config), on mixed and on skewed batches; 2 x 301 RoIs is not
    a multiple of the bf16 C = 32 group."""
    g = torch.Generator().manual_seed(c + (level or 0))
    h, w = 384, 640
    feats = [torch.randn((2, h // s, w // s, c), generator=g).to(dev, dt)
             for s in (4, 8, 16, 32)]
    rois = _rois_on_level(g, 2, 301, h, w, level).to(dev).contiguous()
    if level is not None:
        assert bool((roi_align.map_roi_levels(rois, 4) == level).all())
    before = roi_align.multilevel_roi_align.launches
    got = roi_align.multilevel_roi_align(feats, rois, (4, 8, 16, 32))
    assert roi_align.multilevel_roi_align.launches == before + 1
    _close(got, roi_align.multilevel_roi_align_plain(feats, rois,
                                                     (4, 8, 16, 32)), dt)


@pytest.mark.parametrize('dt', DTYPES)
def test_roi_align_matches_twin_on_the_r1248_pyramid(dev, dt):
    """The STF pyramid 96x312 ... 12x39 (odd stride-32 width), C = 256,
    2 x 1000 RoIs over the whole 384x1248 frame."""
    g = torch.Generator().manual_seed(1248)
    h, w = 384, 1248
    feats = [torch.randn((2, h // s, w // s, 256), generator=g).to(dev, dt)
             for s in (4, 8, 16, 32)]
    assert feats[3].shape[1:3] == (12, 39)
    rois = _rois_on_level(g, 2, 1000, h, w, None).to(dev).contiguous()
    _close(roi_align.multilevel_roi_align(feats, rois, (4, 8, 16, 32)),
           roi_align.multilevel_roi_align_plain(feats, rois, (4, 8, 16, 32)),
           dt)


def test_roi_align_raises_where_it_cannot_load_16_byte_vectors(dev):
    rois = torch.tensor([[[0., 0., 50., 50.]]], device=dev)

    def feats(c, dt):
        return [torch.zeros((1, 32 // 2 ** i, 32 // 2 ** i, c), device=dev,
                            dtype=dt) for i in range(4)]

    before = roi_align.multilevel_roi_align.launches
    with pytest.raises(ValueError, match='C % 8'):
        roi_align.multilevel_roi_align(feats(12, torch.bfloat16), rois,
                                       (4, 8, 16, 32))
    with pytest.raises(ValueError, match='C % 4'):
        roi_align.multilevel_roi_align(feats(6, torch.float32), rois,
                                       (4, 8, 16, 32))
    # level 0 starts one bf16 element past a 16-byte boundary
    lv = feats(32, torch.bfloat16)
    flat = torch.zeros(lv[0].numel() + 1, device=dev, dtype=torch.bfloat16)
    lv[0] = flat[1:].view(lv[0].shape)
    with pytest.raises(ValueError, match='16-byte boundary'):
        roi_align.multilevel_roi_align(lv, rois, (4, 8, 16, 32))
    assert roi_align.multilevel_roi_align.launches == before


@pytest.mark.parametrize('dt', DTYPES)
@pytest.mark.parametrize('w,c,heads,cross', [(40, 78, 2, False),
                                             (40, 78, 2, True),
                                             (40, 156, 4, True),
                                             (12, 624, 16, True)])
def test_windows_mode_matches_twin(dev, w, c, heads, cross, dt):
    g = torch.Generator().manual_seed(c)
    x = torch.randn((w, 49, c), generator=g).to(dev, dt)
    y = torch.randn((w, 49, c), generator=g).to(dev, dt) if cross else x
    mats = [(torch.randn((c, c), generator=g) * c ** -0.5).to(dev)
            for _ in range(4)]
    vecs = [(torch.randn(c, generator=g) * 0.1).to(dev) for _ in range(4)]
    bias = (torch.randn((heads, 49, 49), generator=g) * 0.5).to(dev)
    before = window_attention.fused_window_attention.launches
    got = window_attention.fused_window_attention(x, y, *mats, *vecs, bias,
                                                  heads)
    assert window_attention.fused_window_attention.launches == before + 1
    _close(got, window_attention.fused_window_attention_plain(
        x, y, *mats, *vecs, bias, heads), dt)


@pytest.mark.parametrize('dt', DTYPES)
@pytest.mark.parametrize('h,w,c,heads', [(20, 26, 18, 1), (12, 20, 624, 16)])
def test_block_entries_match_eager_blocks(dev, h, w, c, heads, dt):
    blk = _randomized(HRFormerBlock(c, heads), c).to(dev)
    fus = _randomized(HRFuserFusionBlock(c, heads, 2), c + 1).to(dev)
    x = torch.randn((2, h, w, c), device=dev)
    zs = [torch.randn((2, h, w, c), device=dev) for _ in range(2)]
    n_attn = block.fused_window_attention.launches
    n_ffn = block.fused_cross_ffn.launches
    got = block.fused_hrformer_block(x.to(dt), blk, num_heads=heads)
    got_f = block.fused_fusion_block(x.to(dt), [z.to(dt) for z in zs], fus,
                                     num_heads=heads)
    assert block.fused_window_attention.launches == n_attn + 3
    assert block.fused_cross_ffn.launches == n_ffn + 2
    tol = TOL[dt]
    with torch.no_grad():
        torch.testing.assert_close(got.float(), blk(x), atol=tol, rtol=tol)
        torch.testing.assert_close(got_f.float(), fus(x, zs), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize('add_kv', [False, True])
@pytest.mark.parametrize('mode', ['self', 'self_ln2', 'cross'])
def test_slab_attention_combinations_match_twin(dev, mode, add_kv):
    g = torch.Generator().manual_seed(len(mode) * 2 + int(add_kv))
    cross = mode == 'cross'
    h, w, c, heads = 13, 12, 78, 2
    d = c // heads
    hp, wp = 14, 14
    xq, res, zkv = (torch.randn((2, hp, wp, c), generator=g).to(dev)
                    for _ in range(3))
    xkv = zkv if cross else xq
    ws = [(torch.randn(s, generator=g) * 0.1).to(dev) for s in (
        (heads, c, d), (heads, 1, d), (heads, c, d), (heads, 1, d),
        (heads, c, d), (heads, 1, d), (heads, d, c), (c,))]
    lnq = torch.stack([torch.ones(c), torch.zeros(c)]).to(dev)
    lnkv = lnq if mode == 'self' else lnq + 0.1
    table = torch.randn((169, heads), generator=g).to(dev)
    bias_full = block.build_attn_bias(table, heads, 7, wp, torch.float32)
    kw = dict(num_heads=heads, window=7, pads=(0, 1), hw=(h, w),
              add_kv=add_kv)
    got = block.fused_window_attention(xq, xkv, res, *ws, lnq, lnkv,
                                       bias_full, **kw)
    p = block._fold_heads(*ws, lnq, lnkv, bias_full, 7, wp)
    want = block._slab_attention_plain(xq, xkv, res, p, heads, (0, 1),
                                       (h, w), add_kv)
    _close(got, want, torch.float32)


@pytest.mark.parametrize('dt', DTYPES)
@pytest.mark.parametrize('variant', ['v4', 'v7', 'v8'])
def test_pallas_entry_matches_twin(dev, variant, dt):
    g = torch.Generator().manual_seed(3)
    h, w = 96, 160
    feats = [torch.randn((h // s, w // s, 256), generator=g).to(dev, dt)
             for s in (4, 8, 16, 32)]
    xy = torch.rand((200, 2), generator=g) * torch.tensor([w * 4, h * 4])
    wh = torch.rand((200, 2), generator=g) ** 2 * torch.tensor([w * 4, h * 4])
    rois = torch.cat([xy, xy + wh], -1)
    rois[:12] = torch.tensor([5., 40., 620., 52.])     # oversize slivers
    rois = rois.to(dev)
    before = roi_align.multilevel_roi_align_pallas.launches
    got = roi_align.multilevel_roi_align_pallas(feats, rois, variant=variant,
                                                flat_out=True)
    assert roi_align.multilevel_roi_align_pallas.launches == before + 1
    want = roi_align.multilevel_roi_align_plain(
        [f[None] for f in feats], rois[None], (4, 8, 16, 32))[0]
    want = want.reshape(200, 7, 7, 256).transpose(1, 2).reshape(200, 49, 256)
    _close(got, want, dt)


def test_shapes_without_a_plan_raise_with_their_bytes(dev):
    with pytest.raises(ValueError, match='B of shared memory'):
        chain.attention_plan(2496, 64, True)
    with pytest.raises(ValueError, match='B of shared memory'):
        chain.ffn_plan(2048, 8192)
    assert chain.attention_plan(624, 16, True) == ('streamed', 156, 217168)
    assert chain.attention_plan(144, 8, True)[0] == 'resident'
    assert chain.ffn_plan(624, 2496)[:3] == ('scalar', 2, 278)
    # bf16 widths beyond the 'mma' plan fall to the scalar plan's limits
    with pytest.raises(ValueError, match='B of shared memory'):
        chain.attention_plan(2496, 64, True, torch.bfloat16)
    with pytest.raises(ValueError, match='B of shared memory'):
        chain.ffn_plan(2048, 8192, torch.bfloat16)


@pytest.mark.parametrize('c,heads', [(18, 1), (36, 2), (72, 4), (144, 8),
                                     (78, 2), (156, 4), (312, 8),
                                     (624, 16)])
def test_plans_by_dtype(dev, c, heads):
    """bfloat16 takes the tensor-core plans at every HRFuser-T and
    HRFuser-B width; float32 keeps the CUDA-core plans."""
    for cross in (False, True):
        kind, _, nbytes = chain.attention_plan(c, heads, cross,
                                               torch.bfloat16)
        assert kind == 'mma' and nbytes <= chain.SMEM_MAX
        assert chain.attention_plan(c, heads, cross)[0] in ('resident',
                                                            'streamed')
    kind, th, kh, nbytes = chain.ffn_plan(c, 4 * c, torch.bfloat16)
    assert (kind, th, kh) == ('mma', 8 if c <= 192 else 4, 64)
    assert nbytes <= chain.SMEM_MAX
    assert chain.ffn_plan(c, 4 * c)[0] == 'scalar'


def test_wrappers_raise_instead_of_falling_back(dev):
    blk = HRFormerBlock(8, 1).eval().to(dev)
    p = blk.folded()
    x = torch.randn((1, 14, 14, 8), device=dev)
    with pytest.raises(ValueError):
        chain.window_self_attention(x.half(), p['attn'], 1)
    with pytest.raises(ValueError):
        chain.cross_ffn(x.transpose(1, 2), p['ffn'])
    with pytest.raises(ValueError):
        chain.window_self_attention(x, blk.cpu().folded()['attn'], 1)
    # the bf16 'mma' plans refuse float32 or missing packed weights
    p = blk.to(dev).folded()
    xb = x.bfloat16()
    with pytest.raises(ValueError, match='wqkv_p'):
        chain.window_self_attention(
            xb, dict(p['attn'], wqkv_p=p['attn']['wqkv_p'].float()), 1)
    with pytest.raises(ValueError, match='w2_p'):
        chain.cross_ffn(xb, {k: v for k, v in p['ffn'].items()
                             if k != 'w2_p'})


def test_device_preprocess_matches_cpu(dev):
    """Resize (bilinear camera, nearest sensors), dequantize, normalize
    and pad on the card vs the CPU, uint16 moved as its int16 bits."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (2, 90, 160, 3)).astype(np.uint8)
    mods = [rng.integers(0, 65536, (2, 18, 32, 3)).astype(np.uint16)
            for _ in range(2)]
    pre = make_device_preprocess('nuscenes', ('lidar', 'radar'))

    def run(device):
        x = resize_image(to_device(img, device), (36, 64))
        ms = [resize_image(to_device(m, device), (36, 64), 'nearest')
              for m in mods]
        return pre(x, ms)

    (gi, gm), (ci, cm) = run(dev), run('cpu')
    assert gi.shape == ci.shape == (2, 64, 64, 3)
    torch.testing.assert_close(gi.cpu(), ci, atol=1e-4, rtol=0)
    for g, c in zip(gm, cm):
        torch.testing.assert_close(g.cpu(), c, atol=1e-4, rtol=0)


def _launch_counters():
    return {'window_attention_self': chain.window_self_attention,
            'window_attention_cross': chain.window_cross_attention,
            'cross_ffn': chain.cross_ffn,
            'roi_align': roi_align.multilevel_roi_align}


def test_inference_detector_on_the_card(dev):
    """`tiny_fusion_test` from a raw 60x90 request: every kernel of the
    path launches once per block (per stage for RoIAlign), boxes land in
    the original frame."""
    det = init_detector('tiny_fusion_test', dev, seed=0)
    bb = det.cfg.backbone
    blocks = sum(s.num_modules * sum(s.num_blocks)
                 for s in (bb.stage2, bb.stage3, bb.stage4))
    blocks += bb.num_fused_modalities * sum(
        s.num_modules * s.num_blocks[0] for s in (bb.stage_b, bb.stage_c))
    fusions = sum(f.num_branches
                  for f in (bb.fusion_a, bb.fusion_b, bb.fusion_c))
    want = {'window_attention_self': blocks,
            'window_attention_cross': fusions * bb.num_fused_modalities,
            'cross_ffn': blocks + fusions,
            'roi_align': det.cfg.roi.num_stages}
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (60, 90, 3)).astype(np.uint8)
    mods = [rng.integers(19900, 21000, (60, 90, 3)).astype(np.uint16)
            for _ in range(2)]
    for request in ((img, mods), (img,)):
        counters = _launch_counters()
        for fn in counters.values():
            fn.launches = 0
        out = inference_detector(det, *request)
        assert {k: fn.launches for k, fn in counters.items()} == want
        assert np.isfinite(out['boxes']).all()
        assert (out['boxes'] >= 0).all()
        assert (out['boxes'][:, [0, 2]] <= 90 + 1e-3).all()
        assert (out['boxes'][:, [1, 3]] <= 60 + 1e-3).all()


def test_checkpoint_round_trip_on_the_card(dev, tmp_path):
    src = init_detector('tiny_fusion_test', dev, seed=0)
    save_checkpoint(str(tmp_path), 1, src.model)
    det = init_detector('tiny_fusion_test', dev, seed=1,
                        checkpoint=str(tmp_path))
    a, b = src.model.state_dict(), det.model.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert b[k].device.type == 'cuda' and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize('name,hw', [
    ('cascade_rcnn_hrformer_t_1x_nus_r640', (128, 192)),
    ('cascade_rcnn_hrfuser_t_1x_stf_r1248_4mod', (192, 608))])
def test_new_configs_forward_matches_cpu_twins(dev, name, hw):
    """Camera-only HRFormer-T and STF HRFuser-T (3 / 2 / 1 input
    channels; 192x608 keeps r1248's odd stride-32 width) at batch 1,
    float32: the kernels on the card vs the plain twins on the CPU, neck
    features at `chip_smoke.py` phase 5's tolerance."""
    gpu = init_detector(name, dev, seed=0)
    cpu = init_detector(name, 'cpu', seed=0)
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.normal(0, 1, (1, *hw, 3)).astype(np.float32))
    mods = [torch.from_numpy(rng.normal(0, 1, (1, *hw, c)).astype(np.float32))
            for c in gpu.cfg.backbone.mod_in_channels]
    with torch.no_grad():
        fg = gpu.model.forward_features(img.to(dev),
                                        [m.to(dev) for m in mods])[0]
        fc = cpu.model.forward_features(img, mods)[0]
    for a, b in zip(fg, fc, strict=True):
        torch.testing.assert_close(a.cpu(), b, atol=5e-3, rtol=1e-3)


def _train_run(name, device, hw):
    """One train step of `name` (drop rates 0, the full lr, random weights
    drawn on the CPU from seed 0) on `device`: losses, gradients and
    params after."""
    import dataclasses
    from hrfuser_tpu_torch.apis.inference import init_weights_
    from hrfuser_tpu_torch.apis.train import (apply_gradients, batch_to,
                                              create_train_state)
    from hrfuser_tpu_torch.configs import get_experiment
    from hrfuser_tpu_torch.configs.presets import without_drops
    from hrfuser_tpu_torch.core.samplers import Draws
    from hrfuser_tpu_torch.models.detectors.cascade_rcnn import CascadeRCNN
    from hrfuser_tpu_torch.models.detectors.train_loss import forward_train
    from hrfuser_tpu_torch.tools.train import synthetic_batches
    exp = get_experiment(name)
    model = CascadeRCNN(without_drops(exp.model))
    init_weights_(model, torch.Generator().manual_seed(0))
    state = create_train_state(
        model.to(device), exp.optim,
        dataclasses.replace(exp.schedule, warmup_iters=0, warmup_ratio=1.0),
        100)
    batch = batch_to(next(synthetic_batches(exp, 2, hw, pool=1)), device)
    losses = forward_train(model, batch,
                           Draws(torch.Generator().manual_seed(3)))
    losses['loss'].backward()
    grads = {n: p.grad.cpu().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    apply_gradients(state)
    return ({k: float(v.detach()) for k, v in losses.items()}, grads,
            {n: p.detach().cpu() for n, p in model.named_parameters()},
            state.schedule(0))


def test_train_step_on_the_card_matches_cpu(dev):
    """HRFuser-T at 128x192, batch 2, lr 3e-4: the card's train step vs the
    CPU's on the same weights, batch and sampler draws (drawn on the CPU),
    at `chip_smoke.py` phase 8b's float32 bars: every loss term at rtol
    1e-3 (an accuracy within 3 of the 1,024 sampled RoIs), all gradients
    together within relative L2 2e-2 and each within 1e-1 (the norm
    floored at 1e-3 of the largest), params after the step within 2 x lr.
    No kernel wrapper launches in training."""
    name = 'cascade_rcnn_hrfuser_t_1x_nus_r640_l_r_fusion'
    wrappers = (chain.window_self_attention, chain.window_cross_attention,
                chain.cross_ffn, roi_align.multilevel_roi_align)
    for fn in wrappers:
        fn.launches = 0
    lg, gg, pg, lr = _train_run(name, dev, (128, 192))
    assert not any(fn.launches for fn in wrappers)
    lc, gc, pc, _ = _train_run(name, 'cpu', (128, 192))
    for k in lc:
        tol = dict(abs=3 / 1024) if k.endswith('acc') else dict(rel=1e-3)
        assert lg[k] == pytest.approx(lc[k], **tol), k
    assert gg.keys() == gc.keys()
    whole = (torch.cat([(gg[n] - gc[n]).flatten() for n in gc]).norm()
             / torch.cat([gc[n].flatten() for n in gc]).norm())
    assert whole < 2e-2
    floor = 1e-3 * max(g.norm().item() for g in gc.values())
    for n in gc:
        rel = (gg[n] - gc[n]).norm().item() / max(gc[n].norm().item(), floor)
        assert rel < 1e-1, (n, rel)
    for n in pc:                 # and float32's rounding of the param
        assert ((pg[n] - pc[n]).abs() - 1e-6 * pc[n].abs()).max() <= 2 * lr, n


DATA = Path(__file__).resolve().parent / 'data'


def _data_files():
    """`tests/oracles/data_files.py`, loaded by path: `tests.oracles`
    does not import on the card's machine under `--noconftest`."""
    import importlib.util
    path = Path(__file__).resolve().parent / 'oracles' / 'data_files.py'
    spec = importlib.util.spec_from_file_location('data_files', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_decoders_read_the_committed_fixtures(dev):
    """On the card's machine: PNG through `data/png.py` bit-equal to the
    committed `cv2` decodes; JPEG through the libjpeg decoder within a
    mean |diff| of 0.5 of `cv2`'s, or, where libjpeg's headers are
    missing (the card's machine has none), refused with the compiler's
    message, never read another way."""
    from hrfuser_tpu_torch.data import native
    from hrfuser_tpu_torch.data.pipelines.loading import imread
    want = np.load(DATA / 'decoded_cv2.npz')
    for name, flag, key in (('camera.png', 'color', 'camera_png'),
                            ('grey.png', 'grayscale', 'grey_png'),
                            ('sensor16.png', 'unchanged', 'sensor16_png')):
        got = imread(str(DATA / name), flag)
        assert got.dtype == want[key].dtype
        np.testing.assert_array_equal(got, want[key])
    try:
        native.lib()
    except RuntimeError as e:
        assert 'libjpeg' in str(e)
        with pytest.raises(RuntimeError, match='libjpeg'):
            imread(str(DATA / 'camera.jpg'))
    else:
        jpg = imread(str(DATA / 'camera.jpg')).astype(int)
        assert np.abs(jpg - want['camera_jpg']).mean() < 0.5


def test_a_loader_batch_through_the_bf16_detector(dev, tmp_path):
    """A `DetDataLoader` test batch (PNG camera frames, uint16
    projections) through `tiny_fusion_test` in bf16 on the card: every
    kernel launches once per block (per stage for RoIAlign), the boxes
    are finite and inside the 100x176 frame."""
    import dataclasses

    from hrfuser_tpu_torch.apis.test import run_inference
    from hrfuser_tpu_torch.data.datasets.coco import CocoFusionDataset
    from hrfuser_tpu_torch.data.loader import DetDataLoader
    write_nuscenes = _data_files().write_nuscenes
    det = init_detector('tiny_fusion_test', dev, seed=0,
                        dtype=torch.bfloat16)
    det.data = dataclasses.replace(det.data, img_scale=(96, 54),
                                   classes=det.data.classes[:4])
    write_nuscenes(tmp_path, 2, (100, 176), (54, 95), det.data.classes)
    loader = DetDataLoader(CocoFusionDataset(
        'ann.json', det.data.classes, data_root=str(tmp_path),
        test_mode=True), det.data, 2, train=False)
    bb = det.cfg.backbone
    blocks = sum(s.num_modules * sum(s.num_blocks)
                 for s in (bb.stage2, bb.stage3, bb.stage4))
    blocks += bb.num_fused_modalities * sum(
        s.num_modules * s.num_blocks[0] for s in (bb.stage_b, bb.stage_c))
    fusions = sum(f.num_branches
                  for f in (bb.fusion_a, bb.fusion_b, bb.fusion_c))
    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    results = run_inference(det, loader, progress=False)
    assert {k: fn.launches for k, fn in counters.items()} == {
        'window_attention_self': blocks,
        'window_attention_cross': fusions * bb.num_fused_modalities,
        'cross_ffn': blocks + fusions, 'roi_align': det.cfg.roi.num_stages}
    assert len(results) == 2
    for r in results:
        assert np.isfinite(r['boxes']).all() and (r['boxes'] >= 0).all()
        assert (r['boxes'][:, [0, 2]] <= 176 + 1e-3).all()
        assert (r['boxes'][:, [1, 3]] <= 100 + 1e-3).all()
