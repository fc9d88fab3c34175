"""Kernel C's general plan in Python, on the CPU.

The general plan (`csrc/roi_align.cu`, `roi_align_grid_kernel`) pools
RoIAlign in its separable form: per RoI, axis and bin, the distinct
pixels the bin's samples touch, each with the float32 sum of the
samples' bilinear weights on it times 1 / count and the axis's `inside`
mask, merged in sample order by the kernel's rule (a zero weight
dropped, a pixel equal to one of the list's last two entries added to
it); a bin is a weighted sum over its rows, then over its columns.
`hrfuser_tpu_torch.ops.roi_align.grid_strips` builds those tables by the
kernel's rule and `multilevel_roi_align_strips` applies them. Here the
tables are held to their definition (a brute-force sum of every tap),
and the pool through them to the plain twin and to the JAX package's
gather `multilevel_roi_align` at 1e-5 (float32; the sums run in another
order), in every mode `chip_smoke.py` phase 16a runs, on the edge RoIs
of `roi_align.edge_rois()` and the grid and integer-boundary RoIs of
`card_checks.grid_rois()`.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrfuser_tpu.ops.roi_align import multilevel_roi_align as jax_pool
from hrfuser_tpu_torch.ops import roi_align
from tests.oracles.card_checks import grid_rois

STRIDES = (4, 8, 16, 32)
H, W = 384, 640
# (sample_num, max_grid, aligned): `chip_smoke.py` ROI_MODES
MODES = [(0, 4, True), (0, 8, True), (1, 4, True), (3, 4, True),
         (4, 4, True), (2, 4, False), (0, 4, False)]
MODE_IDS = [f'{"adaptive" if s == 0 else f"static{s}"}-max{g}-'
            f'{"aligned" if a else "unaligned"}' for s, g, a in MODES]


def _case(h=H, w=W, c=8, n_random=16, seed=19):
    """Two images of `h` x `w` (levels at strides 4-32), C = `c` float32;
    each image's RoIs: the edge RoIs, the grid RoIs, then random ones."""
    rng = np.random.default_rng(seed)
    feats = [rng.normal(0, 1, (2, h // s, w // s, c)).astype(np.float32)
             for s in STRIDES]
    fixed = np.concatenate([roi_align.edge_rois(h, w).numpy(),
                            grid_rois()])
    rois = []
    for _ in range(2):
        xy = rng.uniform(-20, [w, h], (n_random, 2))
        wh = rng.uniform(0, 1, (n_random, 2)) ** 2 * [w, h] + 1
        rois.append(np.concatenate([fixed, np.concatenate(
            [xy, xy + wh], -1).astype(np.float32)]))
    return feats, np.stack(rois)


def _jax(feats, rois, mode):
    sample_num, max_grid, aligned = mode
    return np.stack([np.asarray(jax_pool(
        [jnp.asarray(f[i]) for f in feats], jnp.asarray(rois[i]),
        list(STRIDES), sample_num=sample_num, max_grid=max_grid,
        aligned=aligned, gather_dtype=None)).reshape(rois.shape[1], 49, -1)
        for i in range(rois.shape[0])])


@pytest.mark.parametrize('mode', MODES, ids=MODE_IDS)
def test_strips_pool_matches_twin_and_jax(mode):
    sample_num, max_grid, aligned = mode
    feats, rois = _case()
    tfeats = [torch.from_numpy(f) for f in feats]
    trois = torch.from_numpy(rois)
    got = roi_align.multilevel_roi_align_strips(
        tfeats, trois, STRIDES, 7, sample_num, 56, max_grid, aligned)
    twin = roi_align.multilevel_roi_align_plain(
        tfeats, trois, STRIDES, 7, sample_num, 56, max_grid, aligned)
    assert got.dtype == torch.float32 and got.shape == twin.shape
    np.testing.assert_allclose(got.numpy(), twin.numpy(), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), _jax(feats, rois, mode),
                               atol=1e-5, rtol=0)


def _brute(rois, hw, mode):
    """Per RoI and axis, each bin's {pixel: summed weight} (float64) over
    every tap with a non-zero weight, from the twin's own sampling."""
    sample_num, max_grid, aligned = mode
    lvl = roi_align.map_roi_levels(rois, 4)
    scale = torch.tensor([1.0 / s for s in STRIDES])[lvl]
    xs, ys, wx, wy = roi_align._sample_coords(rois, scale, 7, sample_num,
                                              aligned, max_grid)
    grid = wx.shape[-1]
    out = []
    for i in range(rois.shape[0]):
        h, w = hw[int(lvl[i])]
        axes = []
        for coord, wgt, size in ((xs[i], wx[i], w), (ys[i], wy[i], h)):
            lo, hi, wl, wh = roi_align._bilinear(coord[None],
                                                 torch.tensor([size]))
            bins = []
            for p in range(7):
                d = {}
                for g in range(grid):
                    k = p * grid + g
                    for pix, wt in ((lo[0, k], wl[0, k]), (hi[0, k],
                                                           wh[0, k])):
                        v = float(wt) * float(wgt[g])
                        if v:
                            d[int(pix)] = d.get(int(pix), 0.0) + v
                bins.append(d)
            axes.append(bins)
        out.append(axes)
    return out, wx, wy


@pytest.mark.parametrize('mode', MODES, ids=MODE_IDS)
def test_strip_tables_follow_the_kernel_rule(mode):
    """Each bin's list is sorted, holds each pixel once, at most 2 x count
    entries (the 2G slots the kernel reserves), positive weights equal to
    the brute-force sums, together at most 1; an adaptive
    bin of at most `max_grid` pixels (samples at most a pixel apart)
    touches at most count + 1 pixels."""
    sample_num, max_grid, aligned = mode
    _, rois = _case()
    hw = [(H // s, W // s) for s in STRIDES]
    trois = torch.from_numpy(rois[0])
    tables = roi_align.grid_strips(trois, hw, STRIDES, 7, sample_num, 56,
                                   max_grid, aligned)
    brute, wx, wy = _brute(trois, hw, mode)
    offset = 0.5 if aligned else 0.0
    for r, (lvl, xs, ys) in enumerate(tables):
        s = 1.0 / STRIDES[lvl]
        for a, (bins, cnt_w) in enumerate(((xs, wx[r]), (ys, wy[r]))):
            cnt = int((cnt_w > 0).sum())
            v1, v2 = float(trois[r, a]), float(trois[r, a + 2])
            extent = (v2 * s - offset) - (v1 * s - offset)
            if not aligned:
                extent = max(extent, 1.0)
            for p, ents in enumerate(bins):
                pix = [e[0] for e in ents]
                assert pix == sorted(set(pix))
                assert len(ents) <= 2 * cnt <= 2 * (sample_num or max_grid)
                assert all(e[1].dtype == np.float32 and e[1] > 0
                           for e in ents)
                want = brute[r][a][p]
                assert set(pix) == set(want)
                for e in ents:
                    assert abs(float(e[1]) - want[e[0]]) <= 1e-6
                if sample_num == 0 and extent / 7 <= max_grid:
                    assert len(ents) <= cnt + 1
                assert sum(float(e[1]) for e in ents) <= 1 + 1e-6


def test_edge_rois_take_their_branches():
    """Adaptive, aligned, max_grid 4: the edge RoIs' tables hold what
    their names say (levels of the 384 x 640 image: 96 x 160 ... 12 x
    20)."""
    rois = roi_align.edge_rois(H, W)
    hw = [(H // s, W // s) for s in STRIDES]
    t = roi_align.grid_strips(rois, hw, STRIDES, 7, 0, 56, 4, True)

    def only(bins, pixel):
        return all([e[0] for e in ents] == [pixel]
                   and math.isclose(float(ents[0][1]), 1.0, rel_tol=1e-6)
                   for ents in bins)

    assert t[0][0] == 0 and only(t[0][1], 159)          # last column
    assert only(t[1][2], 95)                            # last row
    assert only(t[2][1], 159) and only(t[2][2], 95)     # the corner
    assert only(t[3][1], 0)                             # column 0
    # past the corner, on level 3 (20 columns): bin 1's last samples
    # clamp to column 19, bins 2-6 lie outside
    lvl, xs, ys = t[4]
    assert lvl == 3
    assert [e[0] for e in xs[1]] == [18, 19]
    assert all(not ents for ents in xs[2:])
    for r in (5, 6):                                    # outside
        assert all(not ents for ents in t[r][1] + t[r][2])
    # zero-size: one sample a bin, on a pixel at the origin (its hi at
    # weight 0), between two inside
    assert all(len(ents) == 1 for ents in t[8][1] + t[8][2])
    assert all(len(ents) == 2 for ents in t[9][1] + t[9][2])
    # the full-width sliver: 640 / 4 / 7 = 22.9 px bins capped at 4
    # samples, 5.7 px apart: 4 pairs of neighbours, no pair touching
    for ents in t[10][1]:
        gaps = np.diff([e[0] for e in ents])
        assert len(ents) == 8
        assert (gaps[::2] == 1).all() and (gaps[1::2] >= 2).all()
    out = roi_align.multilevel_roi_align_strips(
        [torch.ones((1, h, w, 4)) for h, w in hw], rois[None], STRIDES,
        sample_num=0)[0]
    assert float(out[5:7].abs().max()) == 0.0
    # an all-ones map pools to each bin's inside share of its weight
    assert torch.allclose(out[0], torch.ones_like(out[0]))


def test_strips_on_an_odd_pyramid_match_twin():
    """A 96 x 224 image: levels 24 x 56 ... 3 x 7 (the stride-32 width 7,
    not a multiple of 8), adaptive and static 3."""
    feats, rois = _case(96, 224, c=4, n_random=24, seed=7)
    tfeats = [torch.from_numpy(f) for f in feats]
    trois = torch.from_numpy(rois)
    for mode in ((0, 4, True), (3, 4, True), (0, 4, False)):
        got = roi_align.multilevel_roi_align_strips(tfeats, trois, STRIDES,
                                                    7, mode[0], 56, mode[1],
                                                    mode[2])
        twin = roi_align.multilevel_roi_align_plain(tfeats, trois, STRIDES,
                                                    7, mode[0], 56, mode[1],
                                                    mode[2])
        np.testing.assert_allclose(got.numpy(), twin.numpy(), atol=1e-5,
                                   rtol=0)
