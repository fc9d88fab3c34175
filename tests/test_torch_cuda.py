"""Hand-written CUDA kernels vs their plain PyTorch twins, on the card;
the serving path (preprocessing, `inference_detector`, checkpoints), the
HRNet-based configs and flip TTA (launch counts, card vs CPU), the image
decoders (lossless frames through the colour launch alone) and a loader
batch on it, and the native loader's sensor decode.

Marked `cuda`: each test skips where `torch.cuda.is_available()` is
False (this file imports no JAX, so it also runs where JAX is absent):

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda

Tolerances: float32 with TF32 off 1e-3; bfloat16 0.05, as the Pallas
kernel tests use. For float32 kernels A and B take their tensor-core
plan 'tf32x3' (split TF32: every product as three TF32 products, to
float32's accuracy, rounding nothing), held here to 1e-3 with the rest of
float32 and to 1e-4 by `test_float32_plans_match_twins_at_1e_4` (one-pass
TF32 would miss that bar); the twins compute in float32. For bfloat16
kernels A and B take their tensor-core plan ('mma'), which rounds the
operands to bf16 where the TPU kernels do (LN output, q/k/v,
probabilities, head outputs, the GELU'd hidden maps) and accumulates in
float32; the twins stay float32.
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
          # HRFuser-B widths, head dim 39 (padded to 48 by the 'mma' plans,
          # to 40 by the 'tf32x3' plans)
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


# (sample_num, max_grid, aligned) of kernel C's general plan
GRID_MODES = [(0, 4, True), (0, 8, True), (1, 4, True), (3, 4, True),
              (4, 4, True), (2, 4, False), (0, 4, False)]


def _grid_rois(g, b, n, h, w):
    """Mixed RoIs, the first of each image replaced by
    `card_checks.grid_rois()` (grids 1-4, capped, integer-boundary bins)."""
    rois = _rois_on_level(g, b, n, h, w, None)
    extra = torch.from_numpy(_oracle('card_checks').grid_rois())
    rois[:, :len(extra)] = extra
    return rois


@pytest.mark.parametrize('dt', DTYPES)
@pytest.mark.parametrize('mode', GRID_MODES)
@pytest.mark.parametrize('c', [32, 256])
def test_roi_align_general_plan_matches_twin(dev, c, mode, dt):
    """Kernel C's general plan (adaptive `sample_num=0` up to `max_grid`,
    static grids, unaligned) against the twin; one counted launch of the
    plan, none of the 2x2 one."""
    sample_num, max_grid, aligned = mode
    g = torch.Generator().manual_seed(c + sample_num)
    h, w = 384, 640
    feats = [torch.randn((2, h // s, w // s, c), generator=g).to(dev, dt)
             for s in (4, 8, 16, 32)]
    rois = _grid_rois(g, 2, 301, h, w).to(dev).contiguous()
    before = dict(roi_align.PLAN_LAUNCHES)
    n = roi_align.multilevel_roi_align.launches
    got = roi_align.multilevel_roi_align(feats, rois, (4, 8, 16, 32), 7,
                                         sample_num, 56, max_grid, aligned)
    assert roi_align.multilevel_roi_align.launches == n + 1
    assert roi_align.PLAN_LAUNCHES == dict(before, grid=before['grid'] + 1)
    _close(got, roi_align.multilevel_roi_align_plain(
        feats, rois, (4, 8, 16, 32), 7, sample_num, 56, max_grid, aligned),
        dt)


@pytest.mark.parametrize('dt', DTYPES)
@pytest.mark.parametrize('mode', GRID_MODES)
@pytest.mark.parametrize('c', [32, 64, 256])
def test_roi_align_general_plan_on_edge_rois(dev, c, mode, dt):
    """The general plan's merged tables on `roi_align.edge_rois()` and
    `card_checks.grid_rois()` in both images: every sample of an axis in
    one edge column or row (all seven bins on one pixel), the corner
    pixel, outside, zero-size, capped slivers, integer-boundary bins;
    C = 32 and 64 put several bin rows, and RoIs, in a warp. One counted
    launch of the plan."""
    sample_num, max_grid, aligned = mode
    g = torch.Generator().manual_seed(c + 7 * sample_num + max_grid)
    h, w = 384, 640
    feats = [torch.randn((2, h // s, w // s, c), generator=g).to(dev, dt)
             for s in (4, 8, 16, 32)]
    rois = torch.cat([roi_align.edge_rois(h, w),
                      torch.from_numpy(_oracle('card_checks').grid_rois())])
    rois = rois.expand(2, -1, -1).to(dev).contiguous()
    before = dict(roi_align.PLAN_LAUNCHES)
    n = roi_align.multilevel_roi_align.launches
    got = roi_align.multilevel_roi_align(feats, rois, (4, 8, 16, 32), 7,
                                         sample_num, 56, max_grid, aligned)
    assert roi_align.multilevel_roi_align.launches == n + 1
    assert roi_align.PLAN_LAUNCHES == dict(before, grid=before['grid'] + 1)
    _close(got, roi_align.multilevel_roi_align_plain(
        feats, rois, (4, 8, 16, 32), 7, sample_num, 56, max_grid, aligned),
        dt)


@pytest.mark.parametrize('variant', roi_align.VARIANTS)
def test_pallas_entry_takes_any_static_grid_on_the_card(dev, variant):
    g = torch.Generator().manual_seed(3)
    feats = [torch.randn((96 // s, 160 // s, 256), generator=g).to(dev)
             for s in (1, 2, 4, 8)]
    rois = _grid_rois(g, 1, 200, 384, 640)[0].to(dev).contiguous()
    got = roi_align.multilevel_roi_align_pallas(feats, rois, sample_num=3,
                                                variant=variant)
    want = roi_align.multilevel_roi_align_plain(
        [f[None] for f in feats], rois[None], (4, 8, 16, 32), sample_num=3)
    _close(got, want[0].reshape(got.shape), torch.float32)


def test_general_plan_without_room_raises_with_its_bytes(dev):
    """A grid bound whose RoI tables do not fit a block's shared memory
    raises, naming the bytes, and launches nothing."""
    feats = [torch.zeros((1, 32 // 2 ** i, 32 // 2 ** i, 8), device=dev,
                         dtype=torch.bfloat16) for i in range(4)]
    rois = torch.tensor([[[0., 0., 50., 50.]]], device=dev)
    need = roi_align.plan_bytes(8, torch.bfloat16, 64)
    assert need > 232448
    before = roi_align.multilevel_roi_align.launches
    with pytest.raises(ValueError, match=f'{need} bytes'):
        roi_align.multilevel_roi_align(feats, rois, (4, 8, 16, 32),
                                       sample_num=0, max_grid=64)
    assert roi_align.multilevel_roi_align.launches == before


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
    want = chain.window_attention_plain(res, xq, p, heads, kv_src=xkv,
                                        z=xkv if add_kv else None,
                                        padded_hw=(h, w))
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
    # float32 has only the 'tf32x3' plan: head dims above 64 raise with the
    # bytes that plan would need, on the host and before any launch
    for c, heads in ((2496, 16), (512, 4), (256, 2)):
        with pytest.raises(ValueError,
                           match='B of shared memory.*head dims up to 64'):
            chain.attention_plan(c, heads, True)
    blk = _randomized(HRFormerBlock(256, 2), 256).to(dev)
    x = torch.randn((1, 7, 7, 256), device=dev)
    with pytest.raises(ValueError, match='head dims up to 64, not 128'):
        chain.window_self_attention(x, blk.folded()['attn'], 2)
    assert chain.attention_plan(2496, 64, True)[0] == 'tf32x3'
    # kernel B's float32 plan streams C: its shared memory does not grow
    assert chain.ffn_plan(2048, 8192) == chain.ffn_plan(624, 2496)
    assert chain.ffn_plan(2048, 8192)[:3] == ('tf32x3', 4, 32)
    # bf16 widths beyond the 'mma' plan fall to the scalar plan's limits
    with pytest.raises(ValueError, match='B of shared memory'):
        chain.attention_plan(2496, 64, True, torch.bfloat16)
    with pytest.raises(ValueError, match='B of shared memory'):
        chain.ffn_plan(2048, 8192, torch.bfloat16)


@pytest.mark.parametrize('c,heads', [(18, 1), (36, 2), (72, 4), (144, 8),
                                     (78, 2), (156, 4), (312, 8),
                                     (624, 16)])
def test_plans_by_dtype(dev, c, heads):
    """Both dtypes take the tensor-core plans at every HRFuser-T and
    HRFuser-B width: bfloat16 'mma', float32 'tf32x3' (split TF32)."""
    for dt, plan in ((torch.bfloat16, 'mma'), (torch.float32, 'tf32x3')):
        for cross in (False, True):
            kind, _, nbytes = chain.attention_plan(c, heads, cross, dt)
            assert kind == plan and nbytes <= chain.SMEM_MAX
        kind, th, kh, nbytes = chain.ffn_plan(c, 4 * c, dt)
        assert (kind, th, kh) == (plan, 8 if c <= 192 else 4,
                                  64 if plan == 'mma' else 32)
        assert nbytes <= chain.SMEM_MAX


F32_BAR = 1e-4        # the 'tf32x3' plans against the float32 twins


@pytest.mark.parametrize('h,w,c,heads', [
    (96, 160, 18, 1), (12, 20, 144, 8),             # HRFuser-T 18 and 144
    # C <= 72 with a block's every head: the Wo product in the attention
    # launch (two heads; four heads and two column tiles of Wo)
    (48, 156, 36, 2), (96, 160, 72, 4),
    (13, 12, 78, 2), (48, 80, 156, 4), (24, 40, 312, 8),
    (12, 20, 624, 16)])                              # HRFuser-B, d = 39
def test_float32_plans_match_twins_at_1e_4(dev, h, w, c, heads):
    """Kernel A self, cross (two modalities) and windows mode and kernel
    B on the float32 'tf32x3' plan, within 1e-4 of the float32 twins."""
    g = torch.Generator().manual_seed(c)
    blk = _randomized(HRFormerBlock(c, heads), c).to(dev)
    fus = _randomized(HRFuserFusionBlock(c, heads, 2), c + 2).to(dev)
    p, pf = blk.folded(), fus.folded()
    x, z0, z1 = (torch.randn((2, h, w, c), generator=g).to(dev)
                 for _ in range(3))
    for cross in (False, True):
        assert chain.attention_plan(c, heads, cross)[0] == 'tf32x3'
    assert chain.ffn_plan(c, 4 * c)[0] == 'tf32x3'

    def close(got, want):
        torch.testing.assert_close(got, want, atol=F32_BAR, rtol=F32_BAR)

    close(chain.window_self_attention(x, p['attn'], heads),
          chain.window_attention_plain(x, x, p['attn'], heads))
    got = want = x
    for z, pk in zip((z0, z1), pf['attn']):
        got = chain.window_cross_attention(got, x, z, pk, heads)
        want = chain.window_attention_plain(want, x, pk, heads, kv_src=z,
                                            z=z)
    close(got, want)
    close(chain.cross_ffn(x, p['ffn']), chain.cross_ffn_plain(x, p['ffn']))
    xw = torch.randn((7, 49, c), generator=g).to(dev)
    yw = torch.randn((7, 49, c), generator=g).to(dev)
    mats = [(torch.randn((c, c), generator=g) * c ** -0.5).to(dev)
            for _ in range(4)]
    vecs = [(torch.randn(c, generator=g) * 0.1).to(dev) for _ in range(4)]
    bias = (torch.randn((heads, 49, 49), generator=g) * 0.5).to(dev)
    close(window_attention.fused_window_attention(xw, yw, *mats, *vecs,
                                                  bias, heads),
          window_attention.fused_window_attention_plain(xw, yw, *mats,
                                                        *vecs, bias, heads))


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


def _oracle(name):
    """`tests/oracles/<name>.py`, loaded by path: `tests.oracles` does not
    import on the card's machine under `--noconftest`."""
    import importlib.util
    path = Path(__file__).resolve().parent / 'oracles' / f'{name}.py'
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _one_forward(cfg):
    """Each kernel's launches in one forward (`card_checks`, as
    `chip_smoke.py` counts them)."""
    return _oracle('card_checks').expected_launches(cfg)[0]


def test_inference_detector_on_the_card(dev):
    """`tiny_fusion_test` from a raw 60x90 request: every kernel of the
    path launches once per block (per stage for RoIAlign), boxes land in
    the original frame."""
    det = init_detector('tiny_fusion_test', dev, seed=0)
    want = _one_forward(det.cfg)
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


def _counted(fn):
    counters = _launch_counters()
    for c in counters.values():
        c.launches = 0
    with torch.no_grad():
        out = fn()
    return out, {k: c.launches for k, c in counters.items()}


def test_hrnet_launches_only_the_fusion_kernels(dev):
    """`tiny_hrnet_fusion_test` at 64x96: the BASIC trunk and streams run
    no kernel, so a forward launches A cross 18, B 9 (nine fusion blocks,
    two modalities) and C 3, and A self never."""
    det = init_detector('tiny_hrnet_fusion_test', dev, seed=0)
    rng = np.random.default_rng(0)
    img = rng.normal(0, 1, (2, 64, 96, 3)).astype(np.float32)
    mods = [rng.normal(0, 1, (2, 64, 96, 3)).astype(np.float32)
            for _ in range(2)]
    out, counts = _counted(lambda: det(img, mods))
    assert counts == _one_forward(det.cfg) == {
        'window_attention_self': 0, 'window_attention_cross': 18,
        'cross_ffn': 9, 'roi_align': 3}
    assert out.boxes.isfinite().all()


def _calibrated_pair(name, hw):
    """`name` with weights from `card_checks.calibrate` on a seeded batch-1
    float32 input at `hw`, on the card and (copied) on the CPU, and that
    input."""
    gpu = init_detector(name, 'cuda', seed=0)
    cpu = init_detector(name, 'cpu', seed=0)
    rng = np.random.default_rng(1)
    img = torch.from_numpy(rng.normal(0, 1, (1, *hw, 3)).astype(np.float32))
    mods = [torch.from_numpy(rng.normal(0, 1, (1, *hw, c)).astype(
        np.float32)) for c in gpu.cfg.backbone.mod_in_channels]
    _oracle('card_checks').calibrate(gpu.model, img.cuda(),
                                     [m.cuda() for m in mods])
    cpu.model.load_state_dict(gpu.model.state_dict())
    return gpu, cpu, img, mods


@pytest.mark.parametrize('fn_name', ['predict_tta_flip',
                                     'predict_aug_test_flip'])
def test_flip_tta_on_the_card_matches_cpu(dev, fn_name):
    """`tiny_fusion_test` at 64x96, batch 2, float32: launches exactly
    twice one forward's (two `predict`s, or two forwards and one cascade
    decode per view); then at batch 1 with calibrated weights each view's
    RPN proposals and the fused detections match the CPU's, each
    device's path whole (`chip_smoke.py` phase 10d)."""
    from hrfuser_tpu_torch import models
    fn = getattr(models, fn_name)
    gpu = init_detector('tiny_fusion_test', dev, seed=0)
    rng = np.random.default_rng(1)
    img = torch.from_numpy(rng.normal(0, 1, (2, 64, 96, 3)).astype(
        np.float32))
    mods = [torch.from_numpy(rng.normal(0, 1, (2, 64, 96, 3)).astype(
        np.float32)) for _ in range(2)]
    _, counts = _counted(lambda: fn(gpu.model, img.to(dev),
                                    [m.to(dev) for m in mods]))
    checks = _oracle('card_checks')
    assert counts == checks.tta_launches(gpu.cfg, fn_name)
    gpu, cpu, img, mods = _calibrated_pair('tiny_fusion_test', (64, 96))
    checks.same_runs(fn, gpu.model, cpu.model, img, mods, gpu.cfg, fn_name)


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


def test_hrnet_forward_matches_cpu(dev):
    """HRNet-W18 HRFuser at 128x192, batch 1, float32, weights from
    `card_checks.calibrate` (at BN's initial statistics its conv trunk's
    maps grow to an RMS of thousands): neck features at phase 5's
    tolerance, then `predict`'s proposals and detections, each device's
    path whole (`chip_smoke.py` phase 10b)."""
    from hrfuser_tpu_torch.models import predict
    gpu, cpu, img, mods = _calibrated_pair(
        'cascade_rcnn_hrfuser_hrnet_w18_1x_nus_r640_l_r_fusion', (128, 192))
    with torch.no_grad():
        fg = gpu.model.forward_features(img.to(dev),
                                        [m.to(dev) for m in mods])[0]
        fc = cpu.model.forward_features(img, mods)[0]
    for a, b in zip(fg, fc, strict=True):
        torch.testing.assert_close(a.cpu(), b, atol=5e-3, rtol=1e-3)
    _oracle('card_checks').same_runs(predict, gpu.model, cpu.model, img,
                                     mods, gpu.cfg, 'predict')


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


def test_decoders_read_the_committed_fixtures(dev):
    """On the card's machine: PNG through `data/png.py`, JPEG through
    `data/jpeg.py` (the host's Huffman decoding, the pixel kernel on the
    card), both bit-equal to the committed `cv2` decodes."""
    from hrfuser_tpu_torch.data import jpeg
    from hrfuser_tpu_torch.data.pipelines.loading import imread
    want = np.load(DATA / 'decoded_cv2.npz')
    for name, flag, key in (('camera.png', 'color', 'camera_png'),
                            ('grey.png', 'grayscale', 'grey_png'),
                            ('sensor16.png', 'unchanged', 'sensor16_png')):
        got = imread(str(DATA / name), flag)
        assert got.dtype == want[key].dtype
        np.testing.assert_array_equal(got, want[key])
    before = jpeg.pixels.launches
    for key in JPEG_FIXTURES:
        name = 'camera.jpg' if key == 'camera_jpg' else f'{key}.jpg'
        np.testing.assert_array_equal(imread(str(DATA / name)), want[key])
    assert jpeg.pixels.launches - before == 2 * len(JPEG_FIXTURES)


JPEG_FIXTURES = ['camera_jpg', 'jpeg_444', 'jpeg_422', 'jpeg_420',
                 'jpeg_440', 'jpeg_411', 'jpeg_restart', 'jpeg_grey']


def _jpeg_streams():
    """name -> JPEG bytes: the committed fixtures, seeded streams of
    arbitrary coefficients (16-bit overflow included) from the oracle
    encoder, and a 900x1600 4:2:0 frame."""
    enc = _oracle('jpeg_encoder')
    out = {k: (DATA / ('camera.jpg' if k == 'camera_jpg' else f'{k}.jpg')
               ).read_bytes() for k in JPEG_FIXTURES}
    rng = np.random.default_rng(0)
    for name, factors in (('fuzz 420', (2, 2)), ('fuzz 440', (1, 2)),
                          ('fuzz 411', (4, 1))):
        grids = enc.block_grid((37, 53), enc._sampling(3, factors))
        coefs = [rng.integers(-1023, 1024, (*g, 64))
                 * (rng.random((*g, 64)) < 0.3) for g in grids]
        for c in coefs:
            c[rng.random(c.shape[:2]) < 0.25, 8:] = 0
        quant = [rng.integers(1, 256, 64) for _ in grids]
        out[name] = enc.encode(coefs, quant, (37, 53), factors, restart=2)
    yy, xx = np.mgrid[0:900, 0:1600]
    frame = np.clip(np.stack([xx / 8, yy / 4, (xx + yy) / 10], -1)
                    + rng.integers(0, 60, (900, 1600, 3)), 0, 255)
    out['900x1600 420'] = enc.encode(
        *enc.image_coefficients(frame.astype(np.uint8), 90), (900, 1600))
    return out


@pytest.mark.parametrize('name', ['fixtures', 'fuzz', 'frame'])
def test_jpeg_kernel_matches_its_twin(dev, name):
    """The pixel kernel (two launches) equals `pixels_plain` on the same
    coefficients on the card, bit for bit."""
    from hrfuser_tpu_torch.data import jpeg
    streams = {k: v for k, v in _jpeg_streams().items()
               if (name == 'fixtures' and k in JPEG_FIXTURES)
               or (name == 'fuzz' and k.startswith('fuzz'))
               or (name == 'frame' and k.startswith('900'))}
    assert streams
    for key, data in streams.items():
        frame, coefs = jpeg.decode_coefficients(data)
        c = torch.from_numpy(coefs).to(dev)
        before = jpeg.pixels.launches
        got = jpeg.pixels(c, frame)
        assert jpeg.pixels.launches - before == 2
        torch.cuda.synchronize()
        assert got.device.type == 'cuda' and got.dtype == torch.uint8
        want = jpeg.pixels_plain(c, frame)
        assert torch.equal(got, want), (key, (got != want).sum().item())
        assert torch.equal(got.cpu(), jpeg.pixels_plain(c.cpu(), frame))


def _mode_streams():
    """name -> (JPEG bytes, grey read): 4-component CMYK and YCCK frames,
    grey reads of YCbCr (luma full size, and luma 1x1 beside 2x2
    chroma), RGB and CMYK files, from the oracle encoder."""
    enc = _oracle('jpeg_encoder')
    rng = np.random.default_rng(1)
    bgr = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    cmyk = rng.integers(0, 256, (37, 53, 4)).astype(np.uint8)
    out = {}
    for label, ycck in (('cmyk', False), ('ycck', True)):
        data = enc.encode(*enc.image_coefficients(cmyk, 90, (2, 2),
                                                  ycck=ycck), (37, 53),
                          (2, 2), jfif=False, adobe=2 if ycck else 0)
        out[label] = (data, False)
        out[f'grey {label}'] = (data, True)
    out['grey ycbcr'] = (enc.encode(*enc.image_coefficients(bgr, 90),
                                    (37, 53)), True)
    odd = [(1, 1), (2, 2), (1, 1)]
    out['grey ycbcr luma 1x1'] = (enc.encode(
        *enc.image_coefficients(bgr, 90, odd), (37, 53), odd), True)
    rgb = [(1, 1)] * 3
    out['grey rgb'] = (enc.encode(*enc.image_coefficients(bgr, 90, rgb),
                                  (37, 53), rgb, jfif=False, ids=b'RGB'),
                       True)
    return out


@pytest.mark.parametrize('name', ['cmyk', 'ycck', 'grey cmyk', 'grey ycck',
                                  'grey ycbcr', 'grey ycbcr luma 1x1',
                                  'grey rgb'])
def test_jpeg_kernel_colour_modes_match_the_twin(dev, name):
    """4-component frames and grey reads: the kernel equals
    `pixels_plain` bit for bit; a grey read of a YCbCr file with full-size
    luma takes launch 1 alone."""
    from hrfuser_tpu_torch.data import jpeg
    data, grey = _mode_streams()[name]
    frame, coefs = jpeg.decode_coefficients(data)
    c = torch.from_numpy(coefs).to(dev)
    before = jpeg.pixels.launches
    got = jpeg.pixels(c, frame, grey=grey)
    torch.cuda.synchronize()
    one = name == 'grey ycbcr'
    assert jpeg.pixels.launches - before == (1 if one else 2)
    assert torch.equal(got.cpu(), jpeg.pixels_plain(c.cpu(), frame, grey))


@pytest.mark.parametrize('coding', ['progressive', 'arithmetic',
                                    'arithmetic progressive'])
def test_jpeg_codings_decode_on_the_card_as_baseline(dev, coding):
    """The same coefficients progressive or arithmetic-coded decode on
    the card to the baseline frame's pixels."""
    from hrfuser_tpu_torch.data import jpeg
    enc = _oracle('jpeg_encoder')
    bgr = np.random.default_rng(2).integers(0, 256, (45, 61, 3)).astype(
        np.uint8)
    coefs, quant = enc.image_coefficients(bgr, 90)
    base = jpeg.decode_jpeg(enc.encode(coefs, quant, (45, 61)), dev)
    got = jpeg.decode_jpeg(enc.encode(
        coefs, quant, (45, 61), progressive='progressive' in coding,
        arithmetic='arithmetic' in coding, restart=2), dev)
    assert torch.equal(got, base)


def test_jpeg_kernel_refuses_what_it_cannot_take(dev):
    from hrfuser_tpu_torch.data import jpeg
    frame, coefs = jpeg.decode_coefficients(
        (DATA / 'jpeg_420.jpg').read_bytes())
    c = torch.from_numpy(coefs).to(dev)
    with pytest.raises(ValueError, match='int16'):
        jpeg.pixels(c.to(torch.int32), frame)
    with pytest.raises(ValueError, match='int16'):
        jpeg.pixels(c[:-64], frame)


def _lossless_streams():
    """name -> (lossless JPEG bytes, grey read) from the oracle encoder."""
    enc = _oracle('jpeg_encoder')
    img = np.random.default_rng(3).integers(0, 256, (37, 53, 4)).astype(
        np.uint8)
    return {
        'rgb': (enc.encode_lossless(img[..., :3], predictor=7,
                                    restart=53 * 2), False),
        'rgb subsampled': (enc.encode_lossless(
            img[..., :3], predictor=4, sampling=[(2, 2), (1, 1), (1, 1)]),
            False),
        'cmyk': (enc.encode_lossless(img, predictor=5, pt=1), False),
        'grey cmyk': (enc.encode_lossless(img, predictor=5, pt=1), True),
        'grey': (enc.encode_lossless(img[..., 0], predictor=2), True)}


@pytest.mark.parametrize('name', ['rgb', 'rgb subsampled', 'cmyk',
                                  'grey cmyk', 'grey'])
def test_jpeg_colour_launch_on_lossless_frames_matches_the_twin(dev, name):
    """A lossless frame's samples (rebuilt on the host) through the colour
    launch alone: bit-equal to `lossless_pixels_plain`, one launch a
    colour frame, none for a 1-component one, never launch 1; and
    `decode_jpeg` on the card equals it on the CPU."""
    from hrfuser_tpu_torch.data import jpeg
    data, grey = _lossless_streams()[name]
    frame, planes = jpeg.decode_samples(data)
    t = torch.from_numpy(planes).to(dev)
    before, idct = jpeg.pixels.launches, jpeg.pixels.idct_launches
    got = jpeg.lossless_pixels(t, frame, grey)
    torch.cuda.synchronize()
    assert jpeg.pixels.launches - before == (0 if name == 'grey' else 1)
    assert jpeg.pixels.idct_launches == idct
    assert torch.equal(got.cpu(), jpeg.lossless_pixels_plain(
        torch.from_numpy(planes), frame, grey))
    assert torch.equal(jpeg.decode_jpeg(data, dev, grey).cpu(),
                       jpeg.decode_jpeg(data, 'cpu', grey))
    with pytest.raises(ValueError, match='uint8'):
        jpeg.lossless_pixels(t[:-1], frame, grey)


def test_native_sensor_decode_on_the_card_matches_cpu(dev, tmp_path):
    """`data/native.py`: the fused sensor decode on the card is bit-equal
    to the CPU's, single and batched."""
    from hrfuser_tpu_torch.data import native, png
    rng = np.random.default_rng(4)
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f'{i}.png'))
        png.imwrite(paths[-1], rng.integers(0, 65535, (36, 64, 3)).astype(
            np.uint16))
    mean, std = [0.5, -1.0, 2.0], [3.0, 0.7, 1e-2]
    for p in paths:
        got = native.decode_sensor_png(p, 100.0, 200.0, mean, std, dev)
        assert got.device.type == 'cuda'
        assert torch.equal(got.cpu(), native.decode_sensor_png(
            p, 100.0, 200.0, mean, std, 'cpu'))
    card = native.decode_sensor_batch(paths, [(36, 64, 3)] * 3, 100.0,
                                      200.0, [mean] * 3, [std] * 3,
                                      num_threads=2, device=dev)
    cpu = native.decode_sensor_batch(paths, [(36, 64, 3)] * 3, 100.0, 200.0,
                                     [mean] * 3, [std] * 3, device='cpu')
    assert all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu))


def test_loader_jpeg_reads_on_its_own_stream(dev):
    """`imread` of a JPEG on the card decodes on the reading thread's own
    stream (not the default one, which holds queued work here) and reads
    what `cv2` reads."""
    import threading

    from hrfuser_tpu_torch.data.pipelines import loading
    want = np.load(DATA / 'decoded_cv2.npz')['jpeg_420']
    got = {}

    def read():
        got['img'] = loading.imread(str(DATA / 'jpeg_420.jpg'))
        got['stream'] = loading._own_stream(torch.device(dev))

    busy = torch.randn(4096, 4096, device=dev)
    for _ in range(20):                         # queued on the default one
        busy = busy @ busy / 64
    t = threading.Thread(target=read)
    t.start()
    t.join()
    np.testing.assert_array_equal(got['img'], want)
    assert got['stream'] != torch.cuda.default_stream(dev)
    torch.cuda.synchronize()


def test_a_loader_batch_through_the_bf16_detector(dev, tmp_path):
    """A `DetDataLoader` test batch (PNG camera frames, uint16
    projections) through `tiny_fusion_test` in bf16 on the card: every
    kernel launches once per block (per stage for RoIAlign), the boxes
    are finite and inside the 100x176 frame."""
    import dataclasses

    from hrfuser_tpu_torch.apis.test import run_inference
    from hrfuser_tpu_torch.data.datasets.coco import CocoFusionDataset
    from hrfuser_tpu_torch.data.loader import DetDataLoader
    write_nuscenes = _oracle('data_files').write_nuscenes
    det = init_detector('tiny_fusion_test', dev, seed=0,
                        dtype=torch.bfloat16)
    det.data = dataclasses.replace(det.data, img_scale=(96, 54),
                                   classes=det.data.classes[:4])
    write_nuscenes(tmp_path, 2, (100, 176), (54, 95), det.data.classes)
    loader = DetDataLoader(CocoFusionDataset(
        'ann.json', det.data.classes, data_root=str(tmp_path),
        test_mode=True), det.data, 2, train=False)
    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    results = run_inference(det, loader, progress=False)
    assert ({k: fn.launches for k, fn in counters.items()}
            == _one_forward(det.cfg))
    assert len(results) == 2
    for r in results:
        assert np.isfinite(r['boxes']).all() and (r['boxes'] >= 0).all()
        assert (r['boxes'][:, [0, 2]] <= 176 + 1e-3).all()
        assert (r['boxes'][:, [1, 3]] <= 100 + 1e-3).all()


def _crowded(rng, n, w, h, scale=2.5):
    """Full-resolution pixels, a quarter of them on 24 target pixels and
    a quarter exactly on half target pixels."""
    uv = np.stack([rng.uniform(0, w * scale, n), rng.uniform(0, h * scale, n)])
    k = n // 4
    uv[:, :k] = np.stack([rng.integers(0, 6, k),
                          rng.integers(0, 4, k)]) * scale
    uv[:, k:2 * k] = (rng.integers(0, min(w, h), (2, k)) + 0.5) * scale
    return uv


@pytest.mark.parametrize('mode', ['reference', 'zbuffer'])
def test_offline_splats_on_the_card_match_cpu(dev, mode):
    """`splat_lidar`, `splat_radar_pillars` (one image, and three in one
    pass), `stf_splat` on the card: bit-equal to the CPU (the winners
    come from `scatter_reduce`, not from repeated-index writes)."""
    from hrfuser_tpu_torch.data import projection as P
    rng = np.random.default_rng(0)
    w, h, n = 160, 96, 4000
    uv = _crowded(rng, n, w, h)
    d = rng.uniform(1, 80, n)
    d[:500] = np.round(d[:500])
    top = uv.copy()
    top[1] -= rng.uniform(-20, 150, n)
    cols = [torch.from_numpy(a) for a in (
        uv, top, d, rng.uniform(0, 255, n).astype(np.float32),
        rng.uniform(0, 20, n).astype(np.float32), rng.normal(0, 10, (3, n)))]
    coords = torch.from_numpy(np.stack([rng.integers(0, w, n),
                                        rng.integers(0, h, n)], 1) % [w, 7])
    vals = torch.from_numpy(rng.normal(0, 20, (n, 3)))
    image = torch.from_numpy(rng.integers(0, 3, n))

    def run(device):
        c = [x.to(device) for x in cols]
        out = []
        for kw in ({}, dict(image=image.to(device), n_images=3)):
            out += [*P.splat_lidar(c[0], c[2], c[3], c[5], (w, h), 2.5,
                                   mode, **kw)]
            kw = {k: v[:600] if k == 'image' else v for k, v in kw.items()}
            out += [*P.splat_radar_pillars(
                c[0][:, :600], c[1][:, :600], c[2][:600], c[3][:600],
                c[4][:600], c[5][:, :600], (w, h), 2.5, mode, **kw)]
        out += [P.stf_splat(coords.to(device), vals.to(device), (w, h),
                            radar, mode) for radar in (False, True)]
        return [o.cpu() for o in out]

    for g, c in zip(run(dev), run('cpu')):
        assert torch.equal(g, c)


@pytest.mark.parametrize('mode', ['reference', 'zbuffer'])
def test_offline_converters_on_the_card_match_cpu(dev, mode):
    """`create_data.convert_sample` (six cameras, five radars) and
    `stf_projection.project_frame` bit-equal card vs CPU."""
    from hrfuser_tpu_torch.tools import create_data, stf_projection
    offline = _oracle('offline_data')
    db, lidar, radars = offline.nuscenes_sample(seed=1, n_lidar=4000,
                                                n_radar=60)
    _, got = create_data.convert_sample(db, db.sample, lidar, radars,
                                        device=dev, mode=mode)
    _, want = create_data.convert_sample(db, db.sample, lidar, radars,
                                         device='cpu', mode=mode)
    for cam in want:
        for key in want[cam]:
            np.testing.assert_array_equal(got[cam][key], want[cam][key])
    frame = offline.stf_frame(np.random.default_rng(2), 20000, 60)
    for g, c in zip(stf_projection.project_frame(*frame, mode=mode,
                                                 device=dev),
                    stf_projection.project_frame(*frame, mode=mode,
                                                 device='cpu')):
        np.testing.assert_array_equal(g, c)


def test_warps_on_the_card_match_cpu(dev):
    """`depth_warp`, `inverse_depth_warp` (float64 on both devices) and
    `homography_warp` bit-equal card vs CPU; `homography_from_points`
    (the same CPU-drawn hypotheses) within 1e-9."""
    from hrfuser_tpu_torch.data import gated_warp as G
    from hrfuser_tpu_torch.data.projection import transform_matrix
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.uniform(0, 1023, (72, 128)).astype(np.float32))
    depth = torch.from_numpy(rng.uniform(4, 60, (96, 160)).astype(np.float32))
    k1 = np.array([[110., 0, 64], [0, 110., 36], [0, 0, 1]])
    k2 = np.array([[130., 0, 80], [0, 130., 48], [0, 0, 1]])
    t = transform_matrix([0.2, -0.1, 0.05], [0.999, 0.02, -0.03, 0.01])
    off = G.ego_motion_offset(12.0, 7.0, 0.045)
    m = np.array([[1.05, 0.03, -3.3], [-0.02, 0.97, 2.1], [1e-4, -2e-4, 1.]])
    u16 = (img * 50).to(torch.int32)

    def run(device):
        out = G.depth_warp(img.to(device), depth.to(device)[:72, :128], k1,
                           k2, t, (160, 96))
        return [x.cpu() for x in (
            *out, G.inverse_depth_warp(img.to(device), depth.to(device), k1,
                                       k2, t, off),
            G.homography_warp(img.to(device), m, (140, 80)),
            G.homography_warp(u16.to(device), m, (140, 80)))]

    for g, c in zip(run(dev), run('cpu')):
        assert torch.equal(g, c)
    src = rng.uniform(0, 200, (50, 2))
    q = m @ np.vstack([src.T, np.ones(50)])
    dst = (q[:2] / q[2]).T
    dst[:10] += 60.0
    h_gpu = G.homography_from_points(torch.from_numpy(src).to(dev),
                                     torch.from_numpy(dst).to(dev))
    h_cpu = G.homography_from_points(src, dst)
    assert h_gpu.device.type == dev.type
    torch.testing.assert_close(h_gpu.cpu(), h_cpu, atol=1e-9, rtol=0)


def test_tiff_reader_reads_the_committed_cv2_fixtures(dev):
    """On the card's machine (no `cv2`): the committed `cv2`-written LZW
    TIFFs decode bit-equal to their committed `cv2` decodes."""
    from hrfuser_tpu_torch.data import tiff
    want = np.load(DATA / 'decoded_tiff_cv2.npz')
    for name in ('gated16_lzw.tiff', 'grey8_lzw.tiff'):
        got = tiff.imread(str(DATA / name))
        ref = want[name.replace('.', '_')]
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


def test_jpeg_tiff_pixels_are_made_on_the_card(dev):
    """A JPEG-compressed TIFF (YCbCr tiles, RGB strips, grey tiles; from
    `tests/oracles/tiff_files.py`) read through `loading.decode` for the
    card equals its CPU read in the three modes, with exactly 2 JPEG
    kernel launches a strip or tile (1 for grey: its full-size luma plane
    is the image)."""
    import sys
    sys.path.insert(0, str(Path(__file__).resolve().parent / 'oracles'))
    import tiff_files as tf
    from hrfuser_tpu_torch.data import jpeg, tiff
    from hrfuser_tpu_torch.data.pipelines import loading
    rng = np.random.default_rng(22)
    rgb = rng.integers(0, 256, (70, 90, 3)).astype(np.uint8)
    for data in (tf.tiff(rgb, photometric=6, compression=7, tile=(32, 48)),
                 tf.tiff(rgb, photometric=2, compression=7, rows=16),
                 tf.tiff(rgb[..., 0], compression=7, tile=(16, 16))):
        lay = tiff.layout(data)
        per = 1 if lay.photometric == 1 else 2
        for flag in ('color', 'unchanged', 'grayscale'):
            jpeg.pixels.launches = 0
            got = loading.decode(data, flag, dev)
            assert jpeg.pixels.launches == per * len(lay.offsets)
            want = loading.decode(data, flag, 'cpu')
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)


def _parallel_ranks():
    """`tests/oracles/parallel_ranks.py` as a top-level module: the ranks
    `run_ranks` spawns import its functions by name, and inherit
    `sys.path`."""
    import sys
    oracles = str(Path(__file__).resolve().parent / 'oracles')
    if oracles not in sys.path:
        sys.path.insert(0, oracles)
    import parallel_ranks
    return parallel_ranks


PARALLEL_HW = (128, 192)
HRFUSER_T = 'cascade_rcnn_hrfuser_t_1x_nus_r640_l_r_fusion'


def test_sharded_step_world_of_one_on_nccl_is_train_step(dev):
    """`make_sharded_train_step` in a world of one rank on `nccl` against
    `train_step` on the card: HRFuser-T at 128x192, batch 2, drop rates
    0, the reference caps, the same draws, lr 3e-4. Losses at rtol 1e-3,
    params after the step within 2 x lr, BN statistics 1e-4 (relative to
    1 + |max|), gradients together 2e-2; no eval kernel launches."""
    pr = _parallel_ranks()
    from hrfuser_tpu_torch.core.samplers import KeyedDraws
    from hrfuser_tpu_torch.parallel.mesh import run_ranks
    batch = pr.joined_batch(2, PARALLEL_HW, empty=())
    draws = pr.RecordingDraws(KeyedDraws(0))
    want = pr.one_process_step(HRFUSER_T, batch, draws, dev, caps={})
    torch.cuda.empty_cache()
    (got,) = run_ranks(pr.sharded_train_rank, 1, (
        HRFUSER_T, [batch], [draws.table], dict(device='cuda', caps={})),
        timeout_s=600)
    m = pr.mismatch(got, want)
    assert m['losses'] < 1e-3 and m['acc'] <= 3 / 1024, m
    assert m['together'] < 2e-2 and m['stats'] < 1e-4, m
    assert m['params'] <= 2 * 3e-4, m
    assert got['launches'] == 0


def test_two_ranks_sharing_the_card_on_gloo_equal_the_joined_batch(dev):
    """Two `gloo` ranks on `cuda:0` (CUDA tensors), 2 images each of a
    joined batch of 4 at 128x192 whose last two have no valid GT, against
    one process on the joined batch: HRFuser-T with a float64 trunk (in
    float32 a batch layout's 1e-7 can swap a proposal at the top-k / NMS
    cut), `chip_smoke.py` phase 12b's bars: losses rtol 1e-3, gradients
    2e-2 together and 1e-1 each, params 2 x lr; the ranks' BN running
    statistics bit-identical."""
    pr = _parallel_ranks()
    from hrfuser_tpu_torch.core.samplers import KeyedDraws
    from hrfuser_tpu_torch.parallel.mesh import run_ranks
    batch = pr.in_float64(pr.joined_batch(4, PARALLEL_HW, empty=(2, 3)))
    draws = pr.RecordingDraws(KeyedDraws(1))
    want = pr.one_process_step(HRFUSER_T, batch, draws, dev, caps={},
                               dtype=torch.float64)
    torch.cuda.empty_cache()
    ranks = run_ranks(pr.sharded_train_rank, 2, (
        HRFUSER_T, [batch], [draws.table],
        dict(device='cuda:0', backend='gloo', caps={},
             dtype=torch.float64)), timeout_s=600)
    for r in ranks:
        m = pr.mismatch(r, want)
        assert m['losses'] < 1e-3 and m['acc'] <= 3 / 2048, m
        assert m['together'] < 2e-2 and m['each'] < 1e-1, m
        assert m['params'] <= 2 * 3e-4, m
    a, b = (r['stats'] for r in ranks)
    assert all(np.array_equal(a[n], b[n]) for n in a)


def test_nccl_refuses_two_ranks_on_one_gpu(dev):
    """Two ranks on `cuda:0` under `nccl` raise (NCCL refuses a duplicate
    GPU); `gloo` takes them."""
    pr = _parallel_ranks()
    from hrfuser_tpu_torch.parallel.mesh import run_ranks
    with pytest.raises(RuntimeError, match='duplicate GPU'):
        run_ranks(pr.join_rank, 2, ('cuda:0', 'nccl'), timeout_s=300)
    got = run_ranks(pr.join_rank, 2, ('cuda:0', 'gloo'), timeout_s=300)
    assert got == [(0, 'cuda:0', 'gloo'), (1, 'cuda:0', 'gloo')]


@pytest.mark.parametrize('dt', DTYPES)
def test_ops_match_their_fakes_on_the_card(dev, dt):
    """`torch.library.opcheck` of each `hrfuser::` op's CUDA
    implementation (kernels A, B, C; NMS's keep loop) against its fake
    one, at `tests/oracles/op_cases.py`'s small shapes."""
    cases = _oracle('op_cases')
    for label in cases.LABELS:
        op, args = cases.op_case(label, dev, dt)
        torch.library.opcheck(op, args)


def test_exported_program_runs_on_the_card(dev, tmp_path):
    """`tiny_fusion_test` exported on the card (bf16, batch 2, 64x96),
    saved and loaded: a forward of the loaded program launches each
    kernel as one eager forward does, and its detections equal eager
    `predict`'s on the same inputs."""
    from hrfuser_tpu_torch.apis.export import (PredictModule,
                                               export_predict, input_shapes,
                                               predict_inputs)
    det = init_detector('tiny_fusion_test', dev, seed=0,
                        dtype=torch.bfloat16)
    torch.export.save(export_predict(det, 2, (64, 96)), tmp_path / 'm.pt2')
    run = torch.export.load(tmp_path / 'm.pt2').module()
    xs = predict_inputs(det, input_shapes(det, 2, (64, 96)),
                        torch.Generator().manual_seed(0))
    got, counts = _counted(lambda: run(*xs))
    want, eager_counts = _counted(lambda: PredictModule(det)(*xs))
    assert counts == eager_counts == _one_forward(det.cfg)
    assert torch.equal(got.labels, want.labels)
    assert torch.equal(got.valid, want.valid)
    torch.testing.assert_close(got.boxes, want.boxes, atol=1e-2, rtol=1e-3)
    torch.testing.assert_close(got.scores, want.scores, atol=5e-3, rtol=0)


def test_flop_count_calls_are_the_launches(dev):
    """`apis/flops.count_flops` of a bf16 forward on the card (the kernels
    launch under `FlopCounterMode`): each kernel op's calls equal that
    forward's launch counters, its FLOPs the formula of `ops/flops.py`
    summed over its calls at their shapes, and no op of the path counts
    0 (`chip_smoke.py` phase 14a at full width)."""
    from hrfuser_tpu_torch.apis.flops import count_flops
    det = init_detector('tiny_fusion_test', dev, seed=0,
                        dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    img, *mods = (torch.from_numpy(rng.normal(0, 1, (2, 64, 96, 3)).astype(
        np.float32)).to(dev, torch.bfloat16) for _ in range(3))
    checks = _oracle('card_checks')
    with checks.kernel_op_flops() as rec:
        (got, counts) = _counted(lambda: count_flops(det.model, img, mods))
    assert counts == _one_forward(det.cfg)
    by_op = got['by_op']
    for op, (calls, flops) in rec.items():
        assert by_op[op] == {'calls': calls, 'flops': flops}, op
        assert flops > 0
    assert (by_op['hrfuser.window_attention']['calls']
            == counts['window_attention_self']
            + counts['window_attention_cross'])
    assert by_op['hrfuser.cross_ffn']['calls'] == counts['cross_ffn']
    assert by_op['hrfuser.roi_align']['calls'] == counts['roi_align']
    assert by_op['hrfuser.greedy_keep']['flops'] == 0


def test_renderings_on_the_card_equal_the_cpu(dev):
    """The drawing, heatmap, JPEG writer and 8-bit LUT images: card vs
    CPU bit for bit on seeded inputs."""
    from hrfuser_tpu_torch.data import jpeg, stf_lut
    from hrfuser_tpu_torch.utils import visualization as vis
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (90, 160, 3)).astype(np.uint8)
    boxes = rng.uniform(-10, 170, (12, 4)).astype(np.float32)
    kw = dict(labels=rng.integers(0, 12, 12), scores=rng.random(12),
              class_names=[f'c{i}' for i in range(12)], score_thr=0.2)
    drawn = vis.draw_detections(img, boxes, device=dev, **kw)
    assert drawn.device.type == 'cuda'
    np.testing.assert_array_equal(
        drawn.cpu().numpy(),
        vis.draw_detections(img, boxes, device='cpu', **kw).numpy())
    sensor = rng.normal(0, 2, (90, 160, 3)).astype(np.float32)
    sensor[rng.random((90, 160)) < 0.5] = 0
    np.testing.assert_array_equal(
        vis.sensor_image_to_heatmap(sensor, device=dev).cpu().numpy(),
        vis.sensor_image_to_heatmap(sensor, device='cpu').numpy())
    assert jpeg.imencode(drawn) == jpeg.imencode(drawn.cpu(), device='cpu')
    gated = rng.integers(0, 1024, (77, 131)).astype(np.uint16)
    np.testing.assert_array_equal(
        stf_lut.gated_raw_to_lut8(gated, dev).cpu().numpy(),
        stf_lut.gated_raw_to_lut8(gated, 'cpu').numpy())
    raw = rng.integers(0, 3968, (64, 96)).astype(np.uint16)
    np.testing.assert_array_equal(
        stf_lut.raw_to_lut8(raw, False, dev).cpu().numpy(),
        stf_lut.raw_to_lut8(raw, False, 'cpu').numpy())
