"""`tests/oracles/card_checks.py`, the checks `chip_smoke.py` and
`tests/test_torch_cuda.py` share, on the CPU: the launch formula of each
config family, weight calibration, the matcher of two devices'
detections and the recorder of RPN proposals. Loaded by path, as both
users load it.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from hrfuser_tpu_torch import init_detector
from hrfuser_tpu_torch.configs import get_config
from hrfuser_tpu_torch.models import predict, predict_tta_flip
from hrfuser_tpu_torch.models.detectors import cascade_rcnn, tta
from hrfuser_tpu_torch.models.roi_heads.cascade_roi_head import Detections


def _load():
    path = Path(__file__).resolve().parent / 'oracles' / 'card_checks.py'
    spec = importlib.util.spec_from_file_location('card_checks', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


checks = _load()


@pytest.mark.parametrize('name,want', [
    ('cascade_rcnn_hrfuser_hrnet_w18_1x_nus_r640_l_r_fusion', (0, 18, 9, 3)),
    ('cascade_rcnn_hrfuser_t_1x_nus_r640_l_r_fusion', (54, 18, 63, 3)),
    ('cascade_rcnn_hrformer_t_1x_nus_r640', (38, 0, 38, 3))])
def test_launches_per_forward(name, want):
    """HRNet-W18: no HRFormer block, nine fusion blocks on two
    modalities; HRFuser-T and camera-only HRFormer-T as `chip_smoke.py`
    counted them on the card."""
    got, _ = checks.expected_launches(get_config(name))
    assert tuple(got.values()) == want


def _pair(seed=0):
    det = init_detector('tiny_hrnet_fusion_test', 'cpu', seed=seed)
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.normal(0, 1, (2, 64, 96, 3)).astype(
        np.float32))
    mods = [torch.from_numpy(rng.normal(0, 1, (2, 64, 96, 3)).astype(
        np.float32)) for _ in range(2)]
    return det, img, mods


def test_calibrate_sets_batch_statistics_and_scales_regression():
    """After `calibrate`, the eval forward (BN folded, running statistics)
    equals the training forward (batch statistics) on the same input, and
    `rpn_reg` / `fc_reg` are 0.1 of their draw; drop rates are back."""
    det, img, mods = _pair()
    model = det.model
    before = {k: v.clone() for k, v in model.state_dict().items()}
    drops = [m.rate for m in model.modules() if hasattr(m, 'rate')]
    checks.calibrate(model, img, mods)
    assert not model.training
    assert [m.rate for m in model.modules() if hasattr(m, 'rate')] == drops
    after = model.state_dict()
    for k, v in after.items():
        if k.split('.')[-2] in ('rpn_reg', 'fc_reg'):
            torch.testing.assert_close(v, 0.1 * before[k])
    with torch.no_grad():
        evals = model.forward_features(img, mods)[0]
        for m in model.modules():
            if hasattr(m, 'rate'):
                m.rate = 0.0
        model.train()
        trains = model.forward_features(img, mods)[0]
    for a, b in zip(evals, trains, strict=True):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def _dets(boxes, scores, labels):
    n = len(scores)
    return Detections(torch.tensor([boxes], dtype=torch.float32),
                      torch.tensor([scores]), torch.tensor([labels]),
                      torch.ones(1, n, dtype=torch.bool))


def test_same_detections_matches_in_any_order_and_spots_a_moved_box():
    cfg = get_config('tiny_hrnet_fusion_test')
    boxes = [[0., 0., 10., 10.], [5., 5., 30., 40.], [50., 8., 60., 20.]]
    a = _dets(boxes, [0.9, 0.5, 0.2], [1, 2, 1])
    b = _dets(boxes[::-1], [0.2, 0.5, 0.9], [1, 2, 1])
    r = checks.same_detections(a, b, cfg, 'shuffled')
    assert (r['got'], r['want'], r['box'], r['at_cut']) == (3, 3, 0.0, 0)
    moved = _dets([[0., 0., 10., 10.], [5., 5., 30.5, 40.],
                   [50., 8., 60., 20.]], [0.9, 0.5, 0.2], [1, 2, 1])
    with pytest.raises(AssertionError, match='no partner'):
        checks.same_detections(a, moved, cfg, 'moved')
    relabelled = _dets(boxes, [0.9, 0.5, 0.2], [1, 3, 1])
    with pytest.raises(AssertionError, match='no partner'):
        checks.same_detections(a, relabelled, cfg, 'relabelled')
    near_thr = cfg.roi.score_thr + 1e-3
    c = _dets(boxes + [[70., 0., 80., 9.]], [0.9, 0.5, 0.2, near_thr],
              [1, 2, 1, 0])
    assert checks.same_detections(c, a, cfg, 'at the cut')['at_cut'] == 1


def test_recorded_proposals_sees_every_rpn_call_and_restores():
    """One call a `predict`, two a `predict_tta_flip`; the records equal
    what the detectors use, and the module functions are put back."""
    det, img, mods = _pair()
    checks.calibrate(det.model, img, mods)
    real = cascade_rcnn.rpn_proposals
    with torch.no_grad(), checks.recorded_proposals() as calls:
        predict(det.model, img, mods)
        predict_tta_flip(det.model, img, mods)
    assert cascade_rcnn.rpn_proposals is real and tta.rpn_proposals is real
    assert len(calls) == 3
    props, cuts = calls[0]
    assert props.boxes.shape == (2, det.cfg.rpn_test.max_per_img, 4)
    assert cuts.shape[0] == 2
    r = checks.same_proposals(calls[0], calls[1], det.cfg, 'same input')
    assert r['got'] == r['want'] == int(props.valid[0].sum())
    assert (r['box'], r['score'], r['at_cut']) == (0.0, 0.0, 0)


def test_same_runs_of_one_device_agree():
    """`same_runs` with the CPU model on both sides (the card's side
    moved by `.cuda()`, here the identity): every comparison exact."""
    det, img, mods = _pair()
    checks.calibrate(det.model, img[:1], [m[:1] for m in mods])
    orig = torch.Tensor.cuda
    torch.Tensor.cuda = lambda self, *a, **k: self
    try:
        out = checks.same_runs(predict, det.model, det.model, img[:1],
                               [m[:1] for m in mods], det.cfg, 'predict')
    finally:
        torch.Tensor.cuda = orig
    assert [w for w, _ in out] == ['predict, RPN call 0 proposals',
                                   'predict detections']
    assert all(r['box'] == 0.0 and r['at_cut'] == 0 for _, r in out)
