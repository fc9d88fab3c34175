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
from hrfuser_tpu_torch.ops import chain, roi_align

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
          (25, 40, 72, 4)]


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
                                           (12, 20, 144, 8, 2)])
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
