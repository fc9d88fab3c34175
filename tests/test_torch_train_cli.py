"""`python -m hrfuser_tpu_torch.tools.train` on the CPU, tiny config.

A 4-step synthetic run writes its `train.log.json` lines (the JAX CLI's
keys) and a checkpoint with the optimizer and the step counters;
`--resume-from` continues at step 4 with its weights, optimizer state
and counters; dataset mode names the split it reads; the batches
are the JAX CLI's `synthetic_batches`, value for value.
"""

# before any test runs: `tests/test_stf_io.py` puts `tools/` (which holds
# a `profile.py`) first on `sys.path`, and torch imports `cProfile`, and
# through it `profile`, when it builds its first optimizer
import cProfile  # noqa: F401
import json

import numpy as np
import pytest
import torch

from hrfuser_tpu_torch.configs import get_experiment
from hrfuser_tpu_torch.tools import train as train_cli

NAME = 'tiny_fusion_test'
ARGS = [NAME, '--synthetic', '--device', 'cpu', '--img-hw', '64', '96',
        '--log-interval', '2']


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """One intra-op thread: the tensors are small, and the test workers
    run side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _log(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_train_cli_logs_checkpoints_and_resumes(tmp_path, capsys):
    wd = tmp_path / 'run'
    train_cli.main(ARGS + ['--max-iters', '4', '--work-dir', str(wd)])
    log = _log(wd / 'train.log.json')
    assert [r['iter'] for r in log] == [2, 4]
    for r in log:
        assert r['mode'] == 'train' and r['imgs_per_sec'] > 0
        assert {'loss', 'loss_rpn_cls', 'loss_rpn_bbox', 's0.loss_cls',
                's2.loss_bbox', 's1.acc'} <= set(r)
        assert np.isfinite(r['loss'])
    assert (wd / 'latest').read_text() == 'step_4'
    ckpt = torch.load(wd / 'step_4.pth', weights_only=True)
    assert ckpt['step'] == 4 and ckpt['extra']['applied'] == 4
    assert ckpt['optimizer']['state']        # AdamW moments saved

    train_cli.main(ARGS + ['--max-iters', '5', '--work-dir', str(wd),
                           '--resume-from', str(wd)])
    assert 'resumed at step 4' in capsys.readouterr().out
    assert [r['iter'] for r in _log(wd / 'train.log.json')] == [2, 4, 5]
    resumed = torch.load(wd / 'step_5.pth', weights_only=True)
    assert resumed['extra']['step'] == 5 == resumed['step']
    w = 'roi_head.bbox_head.0.fc_cls.weight'
    assert not torch.equal(resumed['state_dict'][w], ckpt['state_dict'][w])


def test_dataset_mode_names_the_data_slice(tmp_path):
    """Dataset mode reads the train split under `--data-root`; a root
    without it names the file it wants."""
    with pytest.raises(FileNotFoundError,
                       match='nuscenes_infos_train_mono3d.coco.json'):
        train_cli.main([NAME, '--device', 'cpu', '--data-root',
                        str(tmp_path), '--work-dir', str(tmp_path / 'w')])


def test_synthetic_batches_equal_the_jax_cli():
    from tools.train import synthetic_batches as jax_batches
    from hrfuser_tpu.configs import get_config as jax_get_config
    ours = train_cli.synthetic_batches(get_experiment(NAME), 2, (64, 96))
    want = jax_batches(jax_get_config(NAME), 2, (64, 96))
    for _ in range(5):
        a, b = next(ours), next(want)
        assert set(a) == set(b)
        for k in a:
            for x, y in zip(*(v if isinstance(v, list) else [v]
                              for v in (a[k], b[k]))):
                np.testing.assert_array_equal(x, y)
