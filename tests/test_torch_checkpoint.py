"""Checkpoint I/O of the port (`hrfuser_tpu_torch/utils/checkpoint.py`).

The JAX package's layout (`step_{N}` + `step_{N}.meta.json` + `latest`)
with `torch.save`; weights round-trip bit-equal, a reference-style
`{'state_dict', 'meta'}` file and a bare state dict load, extra keys are
dropped and counted, missing and mis-shaped keys raise, and a file the
safe loader refuses raises with its reason.
"""

# before any test runs: `tests/test_stf_io.py` puts `tools/` (which holds
# a `profile.py`) first on `sys.path`, and torch imports `cProfile`, and
# through it `profile`, when it builds its first optimizer
import cProfile  # noqa: F401
import json
import logging
import os

import numpy as np
import pytest
import torch
from torch import nn

from hrfuser_tpu_torch import init_detector
from hrfuser_tpu_torch.utils.checkpoint import (load_state, load_weights,
                                                save_checkpoint)


def _net(seed):
    torch.manual_seed(seed)
    return nn.Sequential(nn.Conv2d(3, 4, 3), nn.BatchNorm2d(4),
                         nn.Flatten(), nn.Linear(4, 2))


def _equal(a: nn.Module, b: nn.Module) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k])
                                          for k in sa)


def test_round_trip_layout_and_meta(tmp_path):
    src = _net(0)
    src[1].running_mean.normal_()
    meta = {'config': 'tiny_fusion_test', 'classes': ['car', 'truck']}
    path = save_checkpoint(str(tmp_path), 7, src, meta=meta)
    assert path == os.path.join(str(tmp_path), 'step_7.pth')
    assert (tmp_path / 'latest').read_text() == 'step_7'
    assert json.loads((tmp_path / 'step_7.meta.json').read_text()) == meta
    obj = torch.load(path, weights_only=True)
    assert set(obj) == {'state_dict', 'step', 'meta'}
    assert obj['step'] == 7 and obj['meta'] == meta
    dst = _net(1)
    assert not _equal(src, dst)
    assert load_weights(str(tmp_path), dst) is dst
    assert _equal(src, dst)


def test_no_meta_writes_no_json(tmp_path):
    save_checkpoint(str(tmp_path), 1, _net(0))
    assert sorted(os.listdir(tmp_path)) == ['latest', 'step_1.pth']


def test_latest_follows_the_newest_step_and_state_resumes(tmp_path):
    first, second = _net(0), _net(1)
    opt = torch.optim.AdamW(second.parameters(), lr=1e-3)
    second(torch.randn(2, 3, 3, 3)).sum().backward()
    opt.step()
    save_checkpoint(str(tmp_path), 1, first)
    save_checkpoint(str(tmp_path), 2, second, optimizer=opt)
    model = _net(2)
    opt2 = torch.optim.AdamW(model.parameters(), lr=1e-3)
    assert load_state(str(tmp_path), model, opt2) == 2
    assert _equal(model, second)
    for a, b in zip(opt.state_dict()['state'].values(),
                    opt2.state_dict()['state'].values()):
        assert torch.equal(a['exp_avg'], b['exp_avg'])
    assert load_state(str(tmp_path / 'step_1.pth'), model) == 1
    assert _equal(model, first)
    with pytest.raises(ValueError, match='no optimizer'):
        load_state(str(tmp_path / 'step_1.pth'), model, opt2)


def test_reference_style_file_with_extra_keys_loads(tmp_path, caplog):
    src = _net(0)
    sd = dict(src.state_dict())
    sd['neck.unused.weight'] = torch.zeros(3)
    sd['roi_head.unused.bias'] = torch.zeros(2)
    path = str(tmp_path / 'hrfuser_t.pth')
    torch.save({'state_dict': sd, 'meta': {'mmdet_version': '2.x',
                                           'epoch': 12}}, path)
    dst = _net(1)
    with caplog.at_level(logging.WARNING):
        load_weights(path, dst)
    assert _equal(src, dst)
    assert 'dropped 2 keys' in caplog.text


def test_bare_state_dict_loads(tmp_path):
    src = _net(0)
    path = str(tmp_path / 'bare.pth')
    torch.save(src.state_dict(), path)
    dst = _net(1)
    load_weights(path, dst)
    assert _equal(src, dst)


def test_missing_keys_raise_naming_them(tmp_path):
    sd = dict(_net(0).state_dict())
    for k in ('0.weight', '3.bias'):
        del sd[k]
    path = str(tmp_path / 'short.pth')
    torch.save({'state_dict': sd}, path)
    with pytest.raises(ValueError, match=r"missing 2 keys.*0\.weight"):
        load_weights(path, _net(1))


def test_mis_shaped_keys_raise(tmp_path):
    sd = dict(_net(0).state_dict())
    sd['3.weight'] = torch.zeros(5, 4)
    path = str(tmp_path / 'bad.pth')
    torch.save(sd, path)
    with pytest.raises(ValueError, match=r'3\.weight: \(5, 4\) != \(2, 4\)'):
        load_weights(path, _net(1))


def test_unsafe_file_raises_with_the_loader_reason(tmp_path):
    path = str(tmp_path / 'pickled.pth')
    torch.save({'state_dict': _net(0).state_dict(),
                'meta': {'palette': np.array(['a', 'b'], dtype=object)}},
               path)
    with pytest.raises(ValueError, match='weights_only=True'):
        load_weights(path, _net(1))


def test_init_detector_loads_a_checkpoint(tmp_path):
    src = init_detector('tiny_fusion_test', 'cpu', seed=0)
    save_checkpoint(str(tmp_path), 3, src.model)
    det = init_detector('tiny_fusion_test', 'cpu', seed=1,
                        checkpoint=str(tmp_path))
    assert _equal(src.model, det.model)
    assert not _equal(src.model,
                      init_detector('tiny_fusion_test', 'cpu', seed=1).model)
