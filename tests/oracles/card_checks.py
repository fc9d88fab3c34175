"""Checks shared by `chip_smoke.py` and `tests/test_torch_cuda.py`.

Each kernel's launches in one forward of a config (and in one flip-TTA
call), a matcher of detections or RPN proposals computed on two devices,
a recorder of the RPN proposals a call makes, random weights calibrated
on an input so that these comparisons see real detections, a
recorder of the kernel ops' calls with each call's FLOPs, and RoIs that
take each branch of RoIAlign's adaptive grid.
Imports torch and numpy only, and is loaded by path (`tests.oracles`
imports JAX, which the card's machine lacks).

Tolerances are `slice_pair.py`'s: proposals as the decode on identical
proposals, boxes 0.15 px (1e-3 relative) and scores 5e-3 (`DECODE_TOL`);
final detections boxes 1e-2 px (1e-3 relative) and scores 5e-3, as
`test_torch_stf_slice.py` sets (`DETECTION_TOL`).
"""

import contextlib

import numpy as np
import torch

DECODE_TOL = dict(box=0.15, rel=1e-3, score=5e-3)
DETECTION_TOL = dict(box=1e-2, rel=1e-3, score=5e-3)


def expected_launches(cfg):
    """Each kernel's launches in one forward of `cfg`, and how they were
    counted: A self and B once per HRFormer block of a stream (camera
    stages 2-4; each modality's stages B, C and D), counting HRFORMER
    stages only (a BASIC stage is cuDNN convolutions); A cross once per
    modality of each fusion block and B once per fusion block (banks
    A-D); C once per cascade stage."""
    bb = cfg.backbone
    nm = bb.num_fused_modalities

    def blocks(stage):
        if stage is None or stage.block != 'HRFORMER':
            return 0
        return stage.num_modules * sum(stage.num_blocks)

    camera = [blocks(s) for s in (bb.stage2, bb.stage3, bb.stage4)]
    streams = [blocks(s) for s in (bb.stage_b, bb.stage_c, bb.stage_d)]
    banks = [f.num_branches for f in (bb.fusion_a, bb.fusion_b, bb.fusion_c,
                                      bb.fusion_d) if f is not None]
    hr_blocks = sum(camera) + nm * sum(streams)
    fusion_blocks = sum(banks) if nm else 0
    how = (f'{hr_blocks} HRFormer blocks (camera stages 2-4 {camera} + '
           f'{nm} modalities x stages B-D {streams}), {fusion_blocks} '
           f'fusion blocks (banks {banks}) x {nm} modalities, '
           f'{cfg.roi.num_stages} cascade stages')
    return {'window_attention_self': hr_blocks,
            'window_attention_cross': fusion_blocks * nm,
            'cross_ffn': hr_blocks + fusion_blocks,
            'roi_align': cfg.roi.num_stages}, how


# `hrfuser::` kernel op -> its FLOPs from its arguments
# (`hrfuser_tpu_torch/ops/flops.py`'s formulas, applied call by call)
def _kernel_formulas():
    from hrfuser_tpu_torch.ops import flops
    return {
        'hrfuser.window_attention': lambda a: flops.window_attention_flops(
            a[0].shape, a[10].shape[-1]),
        'hrfuser.cross_ffn': lambda a: flops.cross_ffn_flops(
            a[0].shape, a[2].shape[1]),
        'hrfuser.roi_align': lambda a: flops.roi_align_flops(
            a[1].shape, a[0][0].shape[-1], a[3], a[4], a[6])}


@contextlib.contextmanager
def kernel_op_flops():
    """Records each `hrfuser::` kernel op call made inside: yields
    {op: [calls, FLOPs]}, each call's FLOPs from the formula of
    `ops/flops.py` at that call's shapes (independent of the formulas'
    registration with `torch.utils.flop_counter`)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    formulas, seen = _kernel_formulas(), {}

    class Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = str(func._overloadpacket)
            if name in formulas:
                rec = seen.setdefault(name, [0, 0])
                rec[0] += 1
                rec[1] += formulas[name](args)
            return out
    with Recorder():
        yield seen


def tta_launches(cfg, fn_name):
    """Launches of one flip-TTA call: `predict_tta_flip` runs `predict`
    twice; `predict_aug_test_flip` runs two forwards (A and B) and
    decodes the merged proposals once per view (C: 2 x the stages)."""
    one, _ = expected_launches(cfg)
    want = {k: 2 * n for k, n in one.items()}
    if fn_name == 'predict_aug_test_flip':
        want['roi_align'] = 2 * cfg.roi.num_stages
    return want


def _side(boxes, scores, valid, labels, i):
    v = valid[i].cpu().numpy()
    lab = (np.zeros(int(v.sum()), np.int64) if labels is None
           else labels[i].cpu().numpy()[v])
    return (boxes[i].float().cpu().numpy()[v],
            scores[i].float().cpu().numpy()[v], lab)


def match(got, want, tol, cut, label, edges=()):
    """Two devices' (boxes, scores, labels) of one image, in any order:
    each has a partner of its label on the other side within `tol`
    (boxes `box` px + `rel` relative, scores `score`). One whose score
    lies below `cut` + `tol['score']`, or within `tol['score']` of one of
    `edges`, may lack one: float32's differences move it across that
    cut. Returns the worst errors and the count of those without one."""
    worst_box = worst_score = 0.0
    at_cut = 0
    edges = np.asarray(edges, np.float64).ravel()
    sides = (got, want)
    for (b1, s1, l1), (b2, s2, l2) in (sides, sides[::-1]):
        for box, sc, lb in zip(b1, s1, l1):
            near = np.abs(b2 - box)
            cand = ((l2 == lb) & (np.abs(s2 - sc) <= tol['score'])
                    & (near <= tol['box'] + tol['rel'] * np.abs(box)).all(1))
            if cand.any():
                i = np.flatnonzero(cand)[np.argmin(near[cand].max(1))]
                worst_box = max(worst_box, float(near[i].max()))
                worst_score = max(worst_score, float(abs(s2[i] - sc)))
            elif (sc < cut + tol['score']
                  or (np.abs(edges - sc) <= tol['score']).any()):
                at_cut += 1
            else:
                same = l2 == lb
                off = near[same].max(1).min() if same.any() else None
                raise AssertionError(
                    f'{label}: one (label {lb}, score {sc:.4f}, box '
                    f'{np.round(box, 2).tolist()}) has no partner on the '
                    f'other device ({int(same.sum())} of its label there, '
                    f'the nearest {off} px off; cut at {cut:.4f})')
    return dict(got=len(got[1]), want=len(want[1]), box=worst_box,
                score=worst_score, at_cut=at_cut)


def _cut(sides, floor, full):
    """The score below which an entry may be missing on one side:
    `floor`, or the last kept score of a list that is `full`."""
    for _, sc, _ in sides:
        if len(sc) == full:
            floor = max(floor, float(sc.min()))
    return floor


def same_detections(got, want, cfg, label, image=0):
    """`Detections` of `image` on two devices at `DETECTION_TOL`; the cut
    is the score threshold, or the last kept score of a full list."""
    sides = [_side(d.boxes, d.scores, d.valid, d.labels, image)
             for d in (got, want)]
    cut = _cut(sides, cfg.roi.score_thr, cfg.roi.max_per_img)
    return match(*sides, DETECTION_TOL, cut, label)


def same_proposals(got, want, cfg, label, image=0):
    """Two devices' records (from `recorded_proposals`) of one call's RPN
    proposals of `image`, at `DECODE_TOL`. The cuts: the last kept score
    of a full list (`rpn_test.max_per_img`), and each level's `nms_pre`-th
    score on either device (proposals are NMS-ed per level, so a level's
    cut is not the list's)."""
    sides = [_side(p.boxes, p.scores, p.valid, None, image)
             for p, _ in (got, want)]
    cut = _cut(sides, -np.inf, cfg.rpn_test.max_per_img)
    edges = [c[image].cpu().numpy() for _, c in (got, want)]
    return match(*sides, DECODE_TOL, cut, label, edges)


@contextlib.contextmanager
def recorded_proposals():
    """Inside `with`, every `rpn_proposals` call of `predict` and of the
    flip-TTA functions is recorded, in order, into the yielded list as
    (proposals, [B, levels] `nms_pre`-th sigmoid score of each level that
    has more anchors); the calls themselves are unchanged."""
    from hrfuser_tpu_torch.models.detectors import cascade_rcnn, tta
    real, calls = cascade_rcnn.rpn_proposals, []

    def record(cfg, feats, cls_scores, bbox_preds, img_shapes):
        out = real(cfg, feats, cls_scores, bbox_preds, img_shapes)
        k = cfg.rpn_test.nms_pre
        cuts = [torch.sigmoid(s.reshape(s.shape[0], -1).float())
                .topk(k, 1).values[:, -1] for s in cls_scores
                if s[0].numel() > k]
        b = img_shapes.shape[0]
        calls.append((out, torch.stack(cuts, 1) if cuts
                      else torch.empty(b, 0)))
        return out

    modules = (cascade_rcnn, tta)
    for m in modules:
        m.rpn_proposals = record
    try:
        yield calls
    finally:
        for m in modules:
            m.rpn_proposals = real


def same_runs(fn, gpu_model, cpu_model, img, mod_imgs, cfg, label):
    """`fn(model, img, mod_imgs)` (a `predict`-like call returning
    `Detections`) on the card and on the CPU with nothing shared: each
    `rpn_proposals` call's proposals of image 0 matched by
    `same_proposals`, the detections by `same_detections`. Returns
    (what, worst errors) a comparison; raises where one fails or no
    detection is left to compare."""
    out = []
    with torch.no_grad():
        with recorded_proposals() as pg:
            got = fn(gpu_model, img.cuda(), [m.cuda() for m in mod_imgs])
        with recorded_proposals() as pc:
            want = fn(cpu_model, img.cpu(), [m.cpu() for m in mod_imgs])
    for i, (a, b) in enumerate(zip(pg, pc, strict=True)):
        what = f'{label}, RPN call {i} proposals'
        out.append((what, same_proposals(a, b, cfg, what)))
    what = f'{label} detections'
    out.append((what, same_detections(got, want, cfg, what)))
    if not out[-1][1]['got']:
        raise AssertionError(f'{label}: no detection to compare')
    return out


def calibrate(model, img, mod_imgs):
    """Random weights that behave as a trained network's do, for checks
    that compare outputs: every BatchNorm's running statistics set to its
    input's batch statistics on one forward of (`img`, `mod_imgs`) (drop
    rates 0), and the regression layers (`rpn_reg`, each stage's
    `fc_reg`) scaled by 0.1; `model` is left in eval mode.

    At BN's initial statistics HRNet-W18's residual trunk grows its maps
    to an RMS of thousands, and every score saturates; regression layers
    drawn at 1/sqrt(fan_in) decode boxes many times their anchors' size,
    clipped to thin strips at the image border, whose RoI features swing
    with a float32 rounding. Scaled by 0.1 the deltas stay near the order
    a trained head gives (mmdet draws these layers at std 0.01 and
    1e-3)."""
    from hrfuser_tpu_torch.layers.common import DropPath, Dropout
    bns = [m for m in model.modules()
           if isinstance(m, torch.nn.BatchNorm2d)]
    drops = [m for m in model.modules() if isinstance(m, (DropPath, Dropout))]
    momenta, rates = [m.momentum for m in bns], [m.rate for m in drops]
    for m in bns:
        m.momentum = 1.0
    for m in drops:
        m.rate = 0.0
    model.train()
    try:
        with torch.no_grad():
            model.forward_features(img, mod_imgs)
            for name, p in model.named_parameters():
                if name.split('.')[-2] in ('rpn_reg', 'fc_reg'):
                    p.mul_(0.1)
    finally:
        for m, v in zip(bns, momenta):
            m.momentum = v
        for m, v in zip(drops, rates):
            m.rate = v
        model.eval()


def boundary_rois():
    """Level-0 RoIs whose bins are exactly 2 and 3 pixels at stride 4
    (sides of 56 and 84 px), each with its far edges one float32 ulp
    below, on and above: `ceil(bin)`, the adaptive RoIAlign's grid, steps
    from 2 to 3 (3 to 4) between the last two. [6, 4] float32."""
    out = []
    for x1, y1, side in ((4., 6., 56.), (8., 2., 84.)):
        for step in (-np.inf, None, np.inf):
            x2, y2 = np.float32(x1 + side), np.float32(y1 + side)
            if step is not None:
                x2, y2 = np.nextafter(x2, step), np.nextafter(y2, step)
            out.append([x1, y1, x2, y2])
    return np.array(out, np.float32)


def grid_rois():
    """RoIs that take each branch of the adaptive grid: level-0 squares
    whose bins take grids 1, 2, 3 and 4 (sides 14-98 px, bins 0.5-3.5
    px), a sliver capped at `max_grid` 4 but not 8 (6 px bins), a tall
    thin one (grids 1 x 3), then `boundary_rois()`. [12, 4] float32."""
    squares = [[100., 100., 100. + side, 100. + side]
               for side in (14., 42., 70., 98.)]
    slivers = [[200., 50., 368., 58.], [10., 300., 15., 380.]]
    return np.concatenate([np.array(squares + slivers, np.float32),
                           boundary_rois()])
