"""`hrfuser_tpu_torch/tools/numerics_drift.py` against the JAX tool.

The statistics: `tools/numerics_drift.py`'s `main` (loaded by path:
`tools/` has no `__init__.py`) runs on `tiny_fusion_test` at 64x96 with
`hrfuser_tpu.models.predict` replaced by a stub that returns seeded
float32 and bf16 `Detections`, and `CascadeRCNN` by a stub whose `init`
builds nothing (the statistics do not read the model; the tool's own
`jax.jit` calls run the stubs eagerly). Its printed lines equal, string
for string, the port's `report_lines(drift_stats(...))` on the same
detections. The pairs hold jittered boxes and scores, a swapped label,
swapped ranks, unequal valid counts and an image with no valid
detection, at the default top-K and at a top-K below the valid counts.

The port's `main` then runs end to end on the CPU at tiny size with
`--overfit-steps 2`, and the fold cache is held per dtype.
"""

import importlib.util
import pathlib
import sys
import types

import jax
import numpy as np
import pytest
import torch

import hrfuser_tpu.models as jax_models
from hrfuser_tpu.models.roi_heads.cascade_roi_head import Detections
from hrfuser_tpu_torch.tools import numerics_drift
from tests.oracles.threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAME, HW, BATCHES, BATCH, M = 'tiny_fusion_test', (64, 96), 2, 3, 20


def _pairs(seed=0):
    """(float32, bf16) `Detections` of numpy arrays, one pair a batch."""
    rng = np.random.default_rng(seed)
    pairs = []
    for bi in range(BATCHES):
        d32 = Detections(np.zeros((BATCH, M, 4), np.float32),
                         np.zeros((BATCH, M), np.float32),
                         np.full((BATCH, M), -1, np.int32),
                         np.zeros((BATCH, M), bool))
        d16 = Detections(*(a.copy() for a in d32))
        for i in range(BATCH):
            n32 = 0 if (bi, i) == (1, 1) else int(rng.integers(6, M))
            n16 = 0 if n32 == 0 else min(M, n32 + (-2, 0, 1)[i])
            xy = rng.uniform(0, 70, (M, 2))
            boxes = np.concatenate([xy, xy + rng.uniform(4, 30, (M, 2))], 1)
            scores = np.sort(rng.uniform(0.05, 1.0, M))[::-1]
            labels = rng.integers(0, 4, M)
            jitter = boxes + rng.normal(0, 0.4, boxes.shape)
            noisy = scores + rng.normal(0, 0.004, M)
            lab16 = labels.copy()
            lab16[2] = (lab16[2] + 1) % 4          # a swapped label
            order = np.arange(M)
            order[[3, 4]] = order[[4, 3]]          # two swapped ranks
            for d, b, s, lab, n in ((d32, boxes, scores, labels, n32),
                                    (d16, jitter[order], noisy[order],
                                     lab16[order], n16)):
                d.boxes[i, :n] = b[:n]
                d.scores[i, :n] = s[:n]
                d.labels[i, :n] = lab[:n]
                d.valid[i, :n] = True
        pairs.append((d32, d16))
    return pairs


class _StubDetector:
    """Stands in for the JAX `CascadeRCNN`: records its dtype; `init`
    builds nothing."""

    def __init__(self, cfg, dtype=None):
        self.dtype = dtype

    def init(self, *args, **kwargs):
        return {'params': {}}


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        'jax_numerics_drift', ROOT / 'tools' / 'numerics_drift.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    # its jax.jit calls run the stubs eagerly
    module.jax = types.SimpleNamespace(jit=lambda fn, **kw: fn,
                                       tree_util=jax.tree_util,
                                       random=jax.random)
    return module


@pytest.mark.parametrize('topk', [50, 4])
def test_statistics_print_the_jax_tools_lines(topk, monkeypatch, capsys):
    pairs = _pairs()
    served = {None: iter(p[0] for p in pairs),
              'bf16': iter(p[1] for p in pairs)}

    def predict(det, variables, img, mods):
        assert img.shape == (BATCH, *HW, 3) and len(mods) == 2
        return next(served[None if det.dtype is None else 'bf16'])

    monkeypatch.setattr(jax_models, 'CascadeRCNN', _StubDetector)
    monkeypatch.setattr(jax_models, 'predict', predict)
    monkeypatch.setattr(sys, 'argv', [
        'numerics_drift.py', '--config', NAME, '--batches', str(BATCHES),
        '--batch', str(BATCH), '--hw', *map(str, HW), '--topk', str(topk)])
    _jax_tool().main()
    want = capsys.readouterr().out.splitlines()

    stats = numerics_drift.drift_stats(pairs, topk)
    got = numerics_drift.report_lines(stats, NAME, BATCHES, BATCH, HW, topk)
    assert got == want
    assert len(want) == 6 and stats['count_deltas'].tolist().count(0) < 6
    s = numerics_drift.summary(stats)
    assert 0 < s['churn_mean'] < 1 and s['matched'] > 0


def test_port_main_runs_end_to_end_on_the_cpu(capsys):
    numerics_drift.main(['--config', NAME, '--hw', *map(str, HW),
                         '--batch', '1', '--overfit-steps', '2',
                         '--device', 'cpu'])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith('[overfit 1/2] loss=')
    assert lines[1] == f'config={NAME} batches=4x1 hw=64x96 topk=50'
    assert lines[2].startswith('matched detections: ')
    assert lines[-2].startswith('rank churn @top50: mean=')
    assert lines[-1].startswith('valid-count delta   : mean=')
    assert 'nan' not in ' '.join(lines[1:])


def test_each_dtype_gets_its_own_folds():
    """After a float32 and a bf16 call on one model every dtype-keyed fold
    holds its dtype, and both dtypes have folds; TF32 flags come back."""
    det32, det16 = numerics_drift.detector_pair(NAME, 'cpu')
    (img, mods), = numerics_drift.eval_batches(det32, 1, 1, HW)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    d32, d16 = numerics_drift.predict_pair(det32, det16, img, mods)
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == flags
    assert d32.boxes.dtype == d16.boxes.dtype == np.float32
    assert numerics_drift.check_folds(det32.model) > 0
    dtypes = {t for m in det32.model.modules()
              for tag in m.__dict__.get('_cached', {})
              for t in (tag if isinstance(tag, tuple) else ())
              if isinstance(t, torch.dtype)}
    assert dtypes == {torch.float32, torch.bfloat16}
    fc = det32.model.roi_head.bbox_head[0].fc_cls
    key, (w, b) = fc.__dict__['_cached'][('linear', torch.bfloat16)]
    fc.__dict__['_cached'][('linear', torch.bfloat16)] = (key,
                                                          (w.float(), b))
    with pytest.raises(AssertionError, match='fold'):
        numerics_drift.check_folds(det32.model)


def test_numerics_drift_defaults_to_the_card():
    args = numerics_drift.parse_args([])
    assert args.device == 'cuda'
    assert (args.config, args.batches, args.batch, tuple(args.hw), args.topk,
            args.overfit_steps) == (
        'cascade_rcnn_hrfuser_t_1x_nus_r640_l_r_fusion', 4, 4, (384, 640),
        50, 0)
