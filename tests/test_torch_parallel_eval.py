"""Sharded evaluation: `run_inference` over a group, the CLIs under a
`torchrun`-style launch, and the data-parallel dry run.

Two `gloo` ranks on the CPU (spawned, one intra-op thread each, a
deadline of `DEADLINE_S`) over a 7-image nuScenes-style folder
(`tests/oracles/data_files.py`, 100x176 camera PNGs; `tiny_fusion_test`
with its `img_scale` cut to (96, 54) and its 4 classes, so the model runs
at 64x96), global batch 4, so the last batch is ragged (rank 0 holds
images 4 and 5, rank 1 image 6 and a pad). The weights: `init_detector`'s
seed 0 with the heads' last layers scaled by 0.01, as
`tests/test_torch_data_cli.py` does, so boxes and scores are not
saturated. The one-process `run_inference`, which
`tests/test_torch_apis_test.py` and `tests/test_torch_data_cli.py` hold
to JAX, is the reference: every image comes back once, in dataset
order, on every rank, with the same detections (labels exact, boxes
within 1e-4 px and scores within 1e-5: the same arithmetic at another
batch size), and each rank loads only its own samples.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from hrfuser_tpu_torch import get_experiment, init_detector
from hrfuser_tpu_torch.apis.test import run_inference
from hrfuser_tpu_torch.data.datasets.coco import CocoFusionDataset
from hrfuser_tpu_torch.data.loader import DetDataLoader
from hrfuser_tpu_torch.parallel.dryrun import dryrun
from hrfuser_tpu_torch.parallel.mesh import run_ranks
from hrfuser_tpu_torch.utils.checkpoint import save_checkpoint
from tests.oracles import parallel_ranks as pr
from tests.oracles.data_files import write_nuscenes

NAME = 'tiny_fusion_test'
SCALE = (96, 54)
VAL = 'nuscenes_infos_val_mono3d.coco.json'
SPLITS = ('nuscenes_infos_train_mono3d.coco.json', VAL)
HEADS = ('rpn_cls', 'rpn_reg', 'fc_cls', 'fc_reg')
DEADLINE_S = 240
PATCH = dict(img_scale=SCALE,
             classes=get_experiment(NAME).data.classes[:4])


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    """The folder (val and train splits) and a checkpoint in it."""
    root = tmp_path_factory.mktemp('nus')
    write_nuscenes(root, 7, (100, 176), (54, 95), PATCH['classes'], seed=3,
                   splits=SPLITS)
    det = init_detector(NAME, 'cpu', seed=0)
    with torch.no_grad():
        for n, p in det.model.named_parameters():
            if any(k in n for k in HEADS):
                p.mul_(0.01)
    save_checkpoint(str(root / 'ckpt'), 0, det.model)
    return str(root)


@pytest.fixture(scope='module')
def one_process(root):
    det = init_detector(NAME, 'cpu', seed=0, checkpoint=f'{root}/ckpt')
    det.data = dataclasses.replace(det.data, **PATCH)
    ds = CocoFusionDataset(VAL, det.data.classes, data_root=root,
                           test_mode=True)
    return run_inference(det, DetDataLoader(ds, det.data, 4, train=False,
                                            device='cpu'), progress=False)


def _same(got, want):
    assert [r['meta'] for r in got] == [r['meta'] for r in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a['labels'], b['labels'])
        np.testing.assert_allclose(a['boxes'], b['boxes'], rtol=0, atol=1e-4)
        np.testing.assert_allclose(a['scores'], b['scores'], rtol=0,
                                   atol=1e-5)


def test_two_rank_run_inference_equals_one_process(root, one_process):
    assert len(one_process) == 7
    assert sum(len(r['labels']) for r in one_process) > 0
    ranks = run_ranks(pr.sharded_eval_rank, 2,
                      (NAME, root, 4, 'cpu', None, 'f32', f'{root}/ckpt',
                       PATCH), timeout_s=DEADLINE_S)
    for r in ranks:
        _same(r['results'], one_process)
    # each rank loaded only its rows of each batch of 4, each image once
    assert ranks[0]['loaded'] == [0, 1, 4, 5]
    assert ranks[1]['loaded'] == [2, 3, 6]
    assert [r['batches'] for r in ranks] == [2, 2]


def test_clis_under_a_two_rank_launch(root, one_process, tmp_path):
    """`tools.test` over the val split and `tools.train` (one step an
    epoch: 7 images make one global batch of 2 x 2) with the sharded eval
    hook, as `torchrun --nproc-per-node 2` starts them on the CPU: the
    metrics equal the one-process CLI's, and rank 0 alone writes."""
    from hrfuser_tpu_torch.tools import test as test_cli
    out = tmp_path / 'm.json'
    argv = [NAME, '--device', 'cpu', '--data-root', root, '--checkpoint',
            f'{root}/ckpt', '--batch-size', '4', '--out', str(out),
            '--eval', 'bbox,proposal_fast']
    ranks = run_ranks(pr.cli_rank, 2, ('test', argv, SCALE),
                      timeout_s=DEADLINE_S)
    (m0, w0), (m1, w1) = ranks
    assert m0.keys() == m1.keys()
    np.testing.assert_array_equal(list(m0.values()), list(m1.values()))
    assert w0 == [str(out)] and w1 == []
    assert json.loads(out.read_text()).keys() == m0.keys()

    exp = get_experiment(NAME)
    small = dataclasses.replace(exp, data=dataclasses.replace(exp.data,
                                                              **PATCH))
    # the one-process CLI's metrics come from the same results
    from hrfuser_tpu_torch.apis.test import evaluate, evaluate_proposal_recall
    ds = CocoFusionDataset(VAL, small.data.classes, data_root=root,
                           test_mode=True)
    want = evaluate(small, one_process, ds)
    want.update(evaluate_proposal_recall(one_process, ds))
    np.testing.assert_allclose([m0[k] for k in want], list(want.values()),
                               rtol=0, atol=1e-6)

    work = tmp_path / 'work'
    argv = [NAME, '--device', 'cpu', '--data-root', root, '--work-dir',
            str(work), '--max-iters', '2', '--eval-interval-epochs', '1',
            '--log-interval', '1']
    ranks = run_ranks(pr.cli_rank, 2, ('train', argv, SCALE),
                      timeout_s=DEADLINE_S)
    (_, w0), (_, w1) = ranks
    assert w1 == [] and w0
    assert all(p.startswith(str(work)) for p in w0)
    lines = [json.loads(x) for x in
             (work / 'train.log.json').read_text().splitlines()]
    assert [(x['mode'], x['iter']) for x in lines] == [
        ('train', 1), ('val', 1), ('train', 2), ('val', 2)]
    assert all(np.isfinite(x['loss']) for x in lines if x['mode'] == 'train')
    assert {'latest', 'step_1.pth', 'step_2.pth'} <= set(os.listdir(work))


def test_two_rank_dryrun():
    loss, shape = dryrun(2, device='cpu', timeout_s=DEADLINE_S)
    assert np.isfinite(loss)
    assert shape == (2, 8, 4)


def test_dryrun_defaults_to_the_card(monkeypatch):
    """Left at its default the dry run asks for a card a rank; with none
    it raises before spawning, naming the shared-card route, and never
    runs its ranks on the CPU."""
    import inspect

    from hrfuser_tpu_torch.parallel import dryrun as module
    for fn in (module.dryrun, module.dryrun_rank):
        assert inspect.signature(fn).parameters['device'].default == 'cuda'
    spawned = []
    monkeypatch.setattr(module, 'run_ranks',
                        lambda *a, **k: spawned.append(a))
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='--device cuda:0 --backend gloo'):
        module.dryrun(2)
    with pytest.raises(RuntimeError, match='--device cuda:0 --backend gloo'):
        module.main(['--ranks', '2'])
    assert spawned == []
