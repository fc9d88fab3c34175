"""bf16-vs-float32 detection drift through the full detector.

Port of `tools/numerics_drift.py`. The accuracy bar is "mAP within 0.1"
of the reference (BASELINE.md) and the serving entries offer bf16
(`tools.serve` / `tools.test --dtype bf16`), so the risk to bound is how
far bf16 compute moves boxes, scores and ranks from float32 on the SAME
weights.

Method: seeded batches (`default_rng(100 + i)`, N(0, 1) images and
sensor streams) through `predict` twice, float32 and bfloat16: one model
and one set of float32 weights under two `Detector`s. The weights the
kernels read are folded and cached per block (`layers/common.cached`);
the convolution, linear and head folds are keyed by the activations'
dtype, and `check_folds` holds every stored fold to its key's dtype after
the runs, so no fold of one dtype serves the other. The float32 run is
float32: TF32 is off for matmuls and cuDNN during it and restored after
(`float32_matmuls`); cuDNN's default would make its convolutions TF32.

Detections are matched pairwise per image in score rank (`drift_stats`,
the JAX tool's loop): the top `min(topk, valid32, valid16)` of each run,
greedy identity match by IoU >= 0.7 and the same label. Reported over all
images (`report_lines`, the JAX tool's lines):
  * max / p99 / median box-corner delta (pixels) of matched detections;
  * max / p99 / median score delta;
  * rank churn: the share of the top-K without a match;
  * valid-count delta (NMS boundary effects).

Random weights give near-uniform scores whose NMS survivors are
tie-broken by rounding, so their rank churn is near 1 by construction;
confident detections are the regime the mAP bar lives in.
`--overfit-steps N` first trains the weights on one fixed synthetic batch
(`tools/train.synthetic_batches(exp, batch, hw, pool=1)`, `train_step`),
then measures on that batch only, as the JAX tool does. It departs from
the JAX tool's overfit in three ways. The port's train route is float32;
the JAX tool trains with its bf16-compute detector (float32 master
weights). Drop path and `proj_drop` are off: HRFuser-T r640 weights
trained with them on the H100 kept 1 to 28 matched detections on their
own batch of 4, too few to report. The lr is the config's from the first
step: the schedule's 500-step linear warmup would hold a short overfit
near lr x 0.001. The measurement, float32 vs bf16 `predict` on the same
weights, is the same.

    python -m hrfuser_tpu_torch.tools.numerics_drift \\
        [--config cascade_rcnn_hrfuser_t_1x_nus_r640_l_r_fusion] \\
        [--batches 4] [--batch 4] [--hw 384 640] [--topk 50] \\
        [--overfit-steps N] [--device cuda]

It runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from hrfuser_tpu_torch.apis.inference import Detector, init_detector
from hrfuser_tpu_torch.tools import resolve_device

IOU_MATCH = 0.7


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--config',
                    default='cascade_rcnn_hrfuser_t_1x_nus_r640_l_r_fusion')
    ap.add_argument('--batches', type=int, default=4)
    ap.add_argument('--batch', type=int, default=4)
    ap.add_argument('--hw', type=int, nargs=2, default=(384, 640))
    ap.add_argument('--topk', type=int, default=50)
    ap.add_argument('--overfit-steps', type=int, default=0,
                    help='first overfit the model on one fixed synthetic '
                         'GT batch for N steps (float32 train step), then '
                         'measure drift on THAT batch')
    ap.add_argument('--device', default='cuda')
    return ap.parse_args(argv)


@contextlib.contextmanager
def float32_matmuls():
    """TF32 off for CUDA matmuls and cuDNN inside, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def check_folds(model: torch.nn.Module) -> int:
    """Raise if a fold cached under a dtype (`layers/common.cached` tags
    such as `('linear', torch.bfloat16)`) holds a tensor of another;
    returns the number of such folds."""
    checked = 0
    for name, m in model.named_modules():
        for tag, (_, value) in m.__dict__.get('_cached', {}).items():
            dtypes = [t for t in (tag if isinstance(tag, tuple) else ())
                      if isinstance(t, torch.dtype)]
            if not dtypes:
                continue
            leaves = value if isinstance(value, (tuple, list)) else [value]
            bad = [t.dtype for t in leaves if t.dtype != dtypes[0]]
            if bad:
                raise AssertionError(f'{name}: fold {tag} holds {bad[0]}')
            checked += 1
    return checked


def to_numpy(dets):
    """`Detections` of tensors as `Detections` of numpy arrays."""
    return type(dets)(*(t.detach().float().cpu().numpy()
                        if t.is_floating_point() else t.cpu().numpy()
                        for t in dets))


def eval_batches(det: Detector, batches: int, batch: int,
                 hw: Tuple[int, int]) -> List[Tuple[np.ndarray, list]]:
    """The JAX tool's seeded eval batches: `default_rng(100 + i)`."""
    bb = det.cfg.backbone
    out = []
    for bi in range(batches):
        r = np.random.default_rng(100 + bi)
        img = r.normal(0., 1., (batch, *hw, 3)).astype(np.float32)
        mods = [r.normal(0., 1., (batch, *hw, c)).astype(np.float32)
                for c in bb.mod_in_channels[:bb.num_fused_modalities]]
        out.append((img, mods))
    return out


def overfit(det: Detector, config: str, steps: int, batch: int,
            hw: Tuple[int, int], log=print) -> Tuple[np.ndarray, list]:
    """Train `det.model`'s weights `steps` float32 steps on one synthetic
    batch, without drop path or `proj_drop` and at the full lr from the
    first step; returns that batch's (img, mods). The model is left in
    eval mode with the trained weights."""
    from hrfuser_tpu_torch.apis.train import create_train_state, train_step
    from hrfuser_tpu_torch.configs import get_experiment
    from hrfuser_tpu_torch.configs.presets import without_drops
    from hrfuser_tpu_torch.models.detectors.cascade_rcnn import CascadeRCNN
    from hrfuser_tpu_torch.tools.train import synthetic_batches
    exp = get_experiment(config)
    data = next(synthetic_batches(exp, batch, hw, pool=1))
    model = CascadeRCNN(without_drops(exp.model)).to(det.device)
    model.load_state_dict(det.model.state_dict())
    # with warmup_iters 0 alone the schedule would stay at lr x
    # warmup_ratio
    sched = dataclasses.replace(exp.schedule, warmup_iters=0,
                                warmup_ratio=1.0)
    state = create_train_state(model, exp.optim, sched, 1000)
    gen = torch.Generator(det.device).manual_seed(7)
    for i in range(steps):
        m = train_step(state, data, gen)
        if (i + 1) % 50 == 0 or i == 0:
            log(f'[overfit {i + 1}/{steps}] loss={float(m["loss"]):.4f}')
    det.model.load_state_dict(model.state_dict())
    det.model.eval()
    return data['img'], list(data.get('mod_imgs', []))


def detector_pair(config: str, device, seed: int = 0
                  ) -> Tuple[Detector, Detector]:
    """One model (float32 weights from `seed`) under a float32 and a
    bfloat16 `Detector`."""
    det32 = init_detector(config, device, seed=seed)
    det16 = Detector(det32.model, det32.data, det32.device, torch.bfloat16)
    return det32, det16


def predict_pair(det32: Detector, det16: Detector, img, mods):
    """(float32, bfloat16) detections of one batch, as numpy."""
    with float32_matmuls():
        d32 = det32(img, mods)
    return to_numpy(d32), to_numpy(det16(img, mods))


def _iou_matrix(a, b):
    """[N,4] x [M,4] -> [N,M] IoU (numpy, xyxy)."""
    area_a = np.maximum(a[:, 2] - a[:, 0], 0) * np.maximum(
        a[:, 3] - a[:, 1], 0)
    area_b = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(
        b[:, 3] - b[:, 1], 0)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter,
                              1e-9)


def drift_stats(pairs: Sequence[Tuple[object, object]], topk: int) -> Dict:
    """The drift of (float32, bf16) detection pairs, one pair a batch
    (numpy `boxes` [B, M, 4], `scores`, `labels`, `valid` [B, M]): the
    matched detections' box and score deltas, each image's rank churn
    and valid-count delta (the JAX tool's loop, `:139-166`)."""
    box_deltas, score_deltas, churns, cnt_deltas = [], [], [], []
    for d32, d16 in pairs:
        for i in range(len(d32.valid)):
            v32 = d32.valid[i].astype(bool)
            v16 = d16.valid[i].astype(bool)
            cnt_deltas.append(int(v16.sum()) - int(v32.sum()))
            k = min(topk, int(v32.sum()), int(v16.sum()))
            if k == 0:
                continue
            b32 = d32.boxes[i][v32][:k].astype(np.float64)
            b16 = d16.boxes[i][v16][:k].astype(np.float64)
            s32 = d32.scores[i][v32][:k].astype(np.float64)
            s16 = d16.scores[i][v16][:k].astype(np.float64)
            l32 = d32.labels[i][v32][:k]
            l16 = d16.labels[i][v16][:k]
            iou = _iou_matrix(b32, b16)
            iou[l32[:, None] != l16[None, :]] = 0.
            matched = 0
            used = np.zeros(k, bool)
            for a in range(k):
                j = int(np.argmax(np.where(used, -1., iou[a])))
                if iou[a, j] >= IOU_MATCH and not used[j]:
                    used[j] = True
                    matched += 1
                    box_deltas.append(np.abs(b32[a] - b16[j]).max())
                    score_deltas.append(abs(s32[a] - s16[j]))
            churns.append(1.0 - matched / k)
    return dict(box_deltas=np.asarray(box_deltas),
                score_deltas=np.asarray(score_deltas),
                churns=np.asarray(churns), count_deltas=np.asarray(cnt_deltas))


def _reduce(fn, x) -> float:
    return float(fn(x)) if len(x) else float('nan')


def _p99(x):
    return np.percentile(x, 99)


def summary(stats: Dict) -> Dict[str, float]:
    """The reported numbers of `drift_stats` (NaN where there is nothing
    to reduce: no match, or no image with a detection in both runs)."""
    bd, sd = stats['box_deltas'], stats['score_deltas']
    ch, cd = stats['churns'], stats['count_deltas']
    return {
        'matched': len(bd),
        'box_max': _reduce(np.max, bd), 'box_p99': _reduce(_p99, bd),
        'box_median': _reduce(np.median, bd),
        'score_max': _reduce(np.max, sd), 'score_p99': _reduce(_p99, sd),
        'score_median': _reduce(np.median, sd),
        'churn_mean': _reduce(np.mean, ch), 'churn_max': _reduce(np.max, ch),
        'count_delta_mean': _reduce(np.mean, cd),
        'count_delta_absmax': int(np.max(np.abs(cd))) if len(cd) else 0}


def report_lines(stats: Dict, config: str, batches: int, batch: int,
                 hw: Sequence[int], topk: int) -> List[str]:
    """The JAX tool's printed lines (`:168-181`)."""
    s = summary(stats)
    h, w = hw
    lines = [f'config={config} batches={batches}x{batch} hw={h}x{w} '
             f'topk={topk}',
             f'matched detections: {s["matched"]}']
    if s['matched']:
        lines += [f'box corner delta px : max={s["box_max"]:.4f} '
                  f'p99={s["box_p99"]:.4f} median={s["box_median"]:.4f}',
                  f'score delta         : max={s["score_max"]:.5f} '
                  f'p99={s["score_p99"]:.5f} '
                  f'median={s["score_median"]:.5f}']
    lines += [f'rank churn @top{topk}: mean={s["churn_mean"]:.4f} '
              f'max={s["churn_max"]:.4f}',
              f'valid-count delta   : mean={s["count_delta_mean"]:+.2f} '
              f'max|.|={s["count_delta_absmax"]}']
    return lines


def main(argv=None):
    args = parse_args(argv)
    h, w = args.hw
    det32, det16 = detector_pair(args.config, resolve_device(args.device))
    if args.overfit_steps:
        batches = [overfit(det32, args.config, args.overfit_steps,
                           args.batch, (h, w),
                           log=lambda s: print(s, flush=True))]
    else:
        batches = eval_batches(det32, args.batches, args.batch, (h, w))
    pairs = [predict_pair(det32, det16, img, mods) for img, mods in batches]
    check_folds(det32.model)
    for line in report_lines(drift_stats(pairs, args.topk), args.config,
                             args.batches, args.batch, (h, w), args.topk):
        print(line)


if __name__ == '__main__':
    main()
