"""`tools.real_parity`, the port of `tools/run_real_parity.sh`.

The CPU dry run (a fake mmdet-layout `.pth` of the port's seeded
`tiny_fusion_test`, read back, `tools.test --synthetic --checkpoint` on
it) exits 0 with finite metrics. The real-data chain passes the JAX
script's arguments to `tools.test` and prints its metrics and the line
to compare them with. A reference `.pth` (the eager oracle
`tests/oracles/torch_hrfuser.py`'s `TorchHRFuserDetector`, reference
parameter names) loads into the port as it is, through
`utils/checkpoint.py`, with every weight bit-equal to what the JAX
package's convert step makes of the same file (`convert_state_dict`),
carried back by `state_dict_from_jax`: the port's missing convert step
loses nothing.
"""

import json
import math

import numpy as np
import torch

from hrfuser_tpu.configs import get_config as jax_get_config
from hrfuser_tpu.utils.pth_convert import convert_state_dict
from hrfuser_tpu_torch.configs import get_config
from hrfuser_tpu_torch.models.detectors.cascade_rcnn import CascadeRCNN
from hrfuser_tpu_torch.tools import real_parity
from hrfuser_tpu_torch.utils.checkpoint import load_weights
from hrfuser_tpu_torch.utils.jax_weights import state_dict_from_jax
from tests.oracles.threads import one_torch_thread  # noqa: F401
from tests.oracles.torch_hrfuser import TorchHRFuserDetector

NAME = 'tiny_fusion_test'


def test_dry_run_exits_with_finite_metrics(capsys):
    metrics = real_parity.main(['--dry-run', '--device', 'cpu'])
    assert set(metrics) == {'synthetic_img_per_s', 'num_detections'}
    assert all(math.isfinite(v) for v in metrics.values())
    out = capsys.readouterr().out
    assert '[parity --dry-run] OK' in out
    n = len(CascadeRCNN(get_config(NAME)).state_dict())
    assert f'{n} tensors; read back {n}' in out


def test_real_data_chain_runs_the_test_cli_as_the_script_does(
        tmp_path, monkeypatch, capsys):
    pth = tmp_path / 'ref.pth'
    n = real_parity.write_fake_pth(str(pth))
    seen = []

    def fake_test_main(argv):
        seen.append(argv)
        with open(argv[argv.index('--out') + 1], 'w') as f:
            json.dump({'bbox_mAP': 0.25, 'AR@100': 0.5}, f)

    monkeypatch.setattr('hrfuser_tpu_torch.tools.test.main', fake_test_main)
    out_dir = tmp_path / 'out'
    metrics = real_parity.main([str(pth), 'data/nuscenes', NAME,
                                str(out_dir), '--device', 'cpu'])
    assert metrics == {'bbox_mAP': 0.25, 'AR@100': 0.5}
    assert seen == [[NAME, '--checkpoint', str(pth), '--data-root',
                     'data/nuscenes', '--eval', 'bbox,proposal_fast',
                     '--out', str(out_dir / 'metrics.json'), '--device',
                     'cpu']]
    out = capsys.readouterr().out
    assert f'{n} tensors' in out and 'bbox_mAP' in out
    assert 'Compare bbox_mAP against the reference model-zoo row' in out


def test_reference_pth_loads_as_the_jax_convert_step_reads_it(tmp_path):
    torch.manual_seed(0)
    ref = TorchHRFuserDetector(jax_get_config(NAME).model).eval()
    sd = ref.state_dict()
    path = tmp_path / 'ref.pth'
    torch.save({'meta': {}, 'state_dict': sd}, path)
    model = load_weights(str(path), CascadeRCNN(get_config(NAME)))
    jax_tree = convert_state_dict({k: v.numpy() for k, v in sd.items()},
                                  jax_get_config(NAME).model)
    want = state_dict_from_jax(jax_tree, model.cfg)
    got = model.state_dict()
    assert set(want) <= set(got)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=k)
    # the weights the forward reads are all in the converted tree
    unused = {k for p in model.backbone.unused_parameters()
              for k, q in model.named_parameters() if q is p}
    assert set(got) - set(want) <= unused | {
        k for k in got if k.endswith('num_batches_tracked')}
