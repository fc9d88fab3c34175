"""Hand-written CUDA kernels vs their plain PyTorch twins, on the card.

Marked `cuda`: each test skips where `torch.cuda.is_available()` is
False (this file imports no JAX, so it also runs where JAX is absent):

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda

Tolerances: float32 with TF32 off 1e-3; bfloat16 0.05, as the Pallas
kernel tests use. Both sides compute in float32 and round once, so the
bfloat16 gap is about one output rounding.
"""

import pytest
import torch

from hrfuser_tpu_torch.layers.attention import (HRFormerBlock,
                                                HRFuserFusionBlock)
from hrfuser_tpu_torch.ops import block, chain, roi_align, window_attention

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
          (25, 40, 72, 4),
          # HRFuser-B widths, head dim 39: kernel A resident up to C = 312,
          # streamed at 624; kernel B chunked at 312 and 624
          (13, 12, 78, 2), (24, 40, 312, 8), (12, 20, 624, 16)]


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
                                           (12, 20, 624, 16, 2)])
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


@pytest.mark.parametrize('dt', DTYPES)
@pytest.mark.parametrize('w,c,heads,cross', [(40, 78, 2, False),
                                             (40, 78, 2, True),
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
@pytest.mark.parametrize('variant', ['v4', 'v8'])
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
    assert chain.ffn_plan(624, 2496)[:2] == (2, 278)


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
