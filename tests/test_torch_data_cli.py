"""The dataset modes of `python -m hrfuser_tpu_torch.tools.test` and
`tools.train`, on the CPU, against the JAX package.

`tiny_fusion_test` (its 4 classes) over a 4-image nuScenes-style folder
(`tests/oracles/data_files.py`: 100x176 PNG camera frames, uint16
projections on the 54x95 grid), the config's `img_scale` cut to
(96, 54) so the model runs at 64x96. The same weights on both sides:
the JAX variables tree, numpy-filled, carried over by
`state_dict_from_jax` and read by the test CLI from a checkpoint. The
JAX side is the JAX `run_inference` over the JAX loader, un-jitted and on
one device, with RoI pooling in f32 as the port's.

Tolerances: detections valid count and labels exact; boxes within the
cascade-decode tolerances of `tests/test_torch_inference_api.py` (0.15 px
in the model frame, 0.15 / 0.54 in the original one) and scores within
5e-3 of JAX's. The heads' last layers (`rpn_cls`, `rpn_reg`, each stage's
`fc_cls` and `fc_reg`) are scaled by 0.01, the order of mmdet's own
initialization of them (std 0.01 and 0.001): filled at 1/sqrt(fan_in)
like the rest, they push every box onto a zero-area clip at the image
border and every score to 1, which compares nothing. Metrics equal to
JAX's `evaluate` of its own detections, key for key.
Training: 3 steps with the eval hook at the end of the 2-step epoch,
finite losses, checkpoints, `train.log.json` lines, and a resume that
continues the step count.
"""

# before any test runs: `tests/test_stf_io.py` puts `tools/` (which holds
# a `profile.py`) first on `sys.path`, and torch imports `cProfile`, and
# through it `profile`, when it builds its first optimizer
import cProfile  # noqa: F401
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hrfuser_tpu_torch.apis.inference as port_inference
import hrfuser_tpu_torch.apis.test as port_test
import hrfuser_tpu_torch.configs as port_configs
from hrfuser_tpu.apis import test as jax_test
from hrfuser_tpu.configs import get_config as jax_get_config
from hrfuser_tpu.data.datasets.coco import CocoFusionDataset as JaxCoco
from hrfuser_tpu.data.loader import DetDataLoader as JaxLoader
from hrfuser_tpu.models import CascadeRCNN as JaxCascadeRCNN
from hrfuser_tpu_torch.tools import test as test_cli
from hrfuser_tpu_torch.tools import train as train_cli
from hrfuser_tpu_torch.utils.checkpoint import save_checkpoint
from hrfuser_tpu_torch.utils.jax_weights import state_dict_from_jax
from tests.oracles.data_files import write_nuscenes
from tests.oracles.random_variables import random_variables

NAME = 'tiny_fusion_test'
SCALE = (96, 54)                     # (w, h): 100x176 -> 54x95, pad 64x96
SPLITS = ('nuscenes_infos_train_mono3d.coco.json',
          'nuscenes_infos_val_mono3d.coco.json')
BOX_TOL, SCORE_TOL = 0.15, 5e-3
HEADS = ('rpn_head/rpn_cls', 'rpn_head/rpn_reg',
         *(f'roi_head/bbox_head{i}/fc_{k}' for i in range(3)
           for k in ('cls', 'reg')))


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small(data):
    """The config's data half on the 64x96 grid, the model's 4 classes."""
    return dataclasses.replace(data, img_scale=SCALE, classes=data.classes[:4])


@pytest.fixture
def small_grid(monkeypatch):
    """Both CLIs and `init_detector` see `tiny_fusion_test` at 64x96."""
    real = port_configs.get_experiment

    def get_experiment(name):
        exp = real(name)
        return dataclasses.replace(exp, data=_small(exp.data))

    monkeypatch.setattr(port_configs, 'get_experiment', get_experiment)
    monkeypatch.setattr(port_inference, 'get_experiment', get_experiment)


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    classes = port_configs.get_experiment(NAME).data.classes[:4]
    return str(write_nuscenes(tmp_path_factory.mktemp('nus'), 4, (100, 176),
                              (54, 95), classes, seed=1, splits=SPLITS))


@pytest.fixture(scope='module')
def weights(tmp_path_factory):
    """(JAX module, variables, checkpoint dir of the same weights)."""
    jcfg = jax_get_config(NAME)
    model = dataclasses.replace(jcfg.model, roi=dataclasses.replace(
        jcfg.model.roi, gather_bf16=False))
    module = JaxCascadeRCNN(model)
    x = jnp.zeros((1, 64, 96, 3), jnp.float32)
    variables = random_variables(module, x, [x, x], False, seed=2)
    params = variables['params']
    for path in HEADS:
        layer = params
        for key in path.split('/'):
            layer = layer[key]
        for key in layer:
            layer[key] = layer[key] * 0.01
    ckpt = tmp_path_factory.mktemp('ckpt')
    save_checkpoint(str(ckpt), 0, state_dict_from_jax(
        variables, port_configs.get_experiment(NAME).model))
    return module, variables, str(ckpt)


def _jax_results(root, module, variables, monkeypatch):
    data = _small(jax_get_config(NAME).data)
    dataset = JaxCoco(SPLITS[1], data.classes, data_root=root,
                      test_mode=True)
    loader = JaxLoader(dataset, data, 2, train=False)
    # un-jitted (its jit compile dominates a CPU run), on one device
    monkeypatch.setattr(jax_test.jax, 'jit', lambda f, **_: f)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ('data',))
    return (jax_test.run_inference(module, variables, loader,
                                   progress=False, mesh=mesh), dataset)


def test_test_cli_matches_jax_run_inference(root, weights, small_grid,
                                            monkeypatch, tmp_path):
    module, variables, ckpt = weights
    seen = []

    def recorded(*args, **kw):
        seen.append(real(*args, **kw))
        return seen[-1]

    real = port_test.run_inference
    monkeypatch.setattr(port_test, 'run_inference', recorded)
    out = tmp_path / 'm.json'
    metrics = test_cli.main([NAME, '--device', 'cpu', '--data-root', root,
                             '--checkpoint', ckpt, '--batch-size', '2',
                             '--eval', 'bbox,proposal_fast',
                             '--out', str(out)])
    monkeypatch.setattr(port_test, 'run_inference', real)
    np.testing.assert_equal(json.loads(out.read_text()), metrics)
    (got,) = seen
    want, jax_ds = _jax_results(root, module, variables, monkeypatch)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a['meta'] == b['meta']
        np.testing.assert_array_equal(a['labels'], b['labels'])
        # the original frame's pixels: 100x176 frames resized by 0.54
        np.testing.assert_allclose(a['boxes'], b['boxes'], rtol=0,
                                   atol=BOX_TOL / 0.54)
        np.testing.assert_allclose(a['scores'], b['scores'], rtol=0,
                                   atol=SCORE_TOL)
    jcfg = dataclasses.replace(jax_get_config(NAME),
                               data=_small(jax_get_config(NAME).data))
    jm = jax_test.evaluate(jcfg, want, jax_ds)
    jm.update(jax_test.evaluate_proposal_recall(want, jax_ds))
    assert set(metrics) == set(jm)
    np.testing.assert_allclose([metrics[k] for k in jm], list(jm.values()),
                               rtol=0, atol=1e-6)
    # the 100x176 frames hold no box of COCO's medium or large sizes: those
    # bins are NaN on both sides
    nan = {k for k, v in jm.items() if not np.isfinite(v)}
    assert nan <= {'mAP_m', 'mAP_l'}
    assert {k for k, v in metrics.items() if not np.isfinite(v)} == nan
    # boxes of every size and scores short of 1: the comparison holds
    # something
    boxes = np.concatenate([r['boxes'] for r in got])
    scores = np.concatenate([r['scores'] for r in got])
    assert len(boxes) >= 40
    assert np.median(np.minimum(boxes[:, 2] - boxes[:, 0],
                                boxes[:, 3] - boxes[:, 1])) > 4
    assert 0.05 < scores.max() < 0.99


def _log(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_train_cli_dataset_mode_trains_evaluates_and_resumes(
        root, small_grid, tmp_path, capsys):
    wd = tmp_path / 'run'
    args = [NAME, '--device', 'cpu', '--data-root', root, '--work-dir',
            str(wd), '--log-interval', '1', '--samples-per-device', '2',
            '--eval-interval-epochs', '1']
    train_cli.main(args + ['--max-iters', '3'])
    assert '2 steps an epoch' in capsys.readouterr().out
    log = _log(wd / 'train.log.json')
    assert [(r['mode'], r['iter']) for r in log] == [
        ('train', 1), ('train', 2), ('val', 2), ('train', 3)]
    assert all(np.isfinite(r['loss']) for r in log if r['mode'] == 'train')
    val = log[2]
    assert {'mAP', 'mAP_50', 'mAP_75'} <= set(val)
    assert np.isfinite(val['mAP']) and np.isfinite(val['mAP_50'])
    assert (wd / 'step_2.pth').exists() and (wd / 'step_3.pth').exists()
    assert (wd / 'latest').read_text() == 'step_3'

    train_cli.main(args + ['--max-iters', '4', '--resume-from', str(wd)])
    assert 'resumed at step 3' in capsys.readouterr().out
    assert [(r['mode'], r['iter']) for r in _log(wd / 'train.log.json')][
        4:] == [('train', 4), ('val', 4)]
    ckpt = torch.load(wd / 'step_4.pth', weights_only=True)
    assert ckpt['extra']['step'] == 4 == ckpt['step']
