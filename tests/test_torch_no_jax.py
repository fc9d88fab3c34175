"""`hrfuser_tpu_torch` never imports JAX, flax, orbax, the JAX package
or `cv2` (the card's machine has neither JAX nor `cv2`).

Checked in a fresh interpreter (this test process has JAX loaded by
`tests/conftest.py`) that runs the tiny fusion and camera-only slices,
`inference_detector`, `run_inference`, a training step and a
`DetDataLoader` over PNG files end to end on the CPU and imports the
KITTI evaluation, and statically over every module
of the package and the scripts that drive it on the card. Its entry
point runs on the card unless asked for the CPU.
"""

import ast
import inspect
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / 'hrfuser_tpu_torch'
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'hrfuser_tpu', 'cv2')
SCRIPTS = [ROOT / 'chip_smoke.py', ROOT / 'chip_profile.py']

_SCRIPT = """
import sys
import numpy as np
from hrfuser_tpu_torch import init_detector
det = init_detector('tiny_fusion_test', 'cpu', seed=0)
rng = np.random.default_rng(0)
img = rng.normal(0, 1, (1, 64, 96, 3)).astype(np.float32)
mods = [rng.normal(0, 1, (1, 64, 96, 3)).astype(np.float32)
        for _ in range(2)]
out = det(img, mods)
assert tuple(out.boxes.shape) == (1, 20, 4), out.boxes.shape
assert bool(out.boxes.isfinite().all())
import dataclasses
from hrfuser_tpu_torch import inference_detector
from hrfuser_tpu_torch.apis.test import run_inference
det.data = dataclasses.replace(det.data, img_scale=(96, 64))  # small grid
raw = rng.integers(0, 256, (60, 90, 3)).astype(np.uint8)
u16 = [rng.integers(19900, 21000, (60, 90, 3)).astype(np.uint16)
       for _ in range(2)]
dets = inference_detector(det, raw, u16)
assert dets['boxes'].shape[1:] == (4,) and np.isfinite(dets['boxes']).all()
batch = dict(img=rng.integers(0, 256, (1, 64, 96, 3)).astype(np.uint8),
             mod_imgs=[rng.integers(19900, 21000, (1, 64, 96, 3)).astype(
                 np.uint16) for _ in range(2)],
             img_shapes=np.array([[64, 96]], np.float32),
             scale_factors=np.ones((1, 4), np.float32), metas=[None])
assert len(run_inference(det, [batch], progress=False)) == 1
cam = init_detector('tiny_camera_test', 'cpu', seed=0)
assert tuple(cam(img, None).boxes.shape) == (1, 20, 4)
import hrfuser_tpu_torch.data.datasets.kitti2d
import hrfuser_tpu_torch.evaluation.kitti_eval
import torch
from hrfuser_tpu_torch.apis.train import create_train_state, train_step
from hrfuser_tpu_torch.configs import get_experiment
from hrfuser_tpu_torch.models.detectors.cascade_rcnn import CascadeRCNN
from hrfuser_tpu_torch.tools.train import synthetic_batches
exp = get_experiment('tiny_fusion_test')
state = create_train_state(CascadeRCNN(exp.model), exp.optim, exp.schedule,
                           100)
m = train_step(state, next(synthetic_batches(exp, 2, (64, 96))),
               torch.Generator().manual_seed(0))
assert bool(m['loss'].isfinite()) and state.applied == 1
import tempfile
from hrfuser_tpu_torch.data.datasets.coco import CocoFusionDataset
from hrfuser_tpu_torch.data.loader import DetDataLoader
from tests.oracles.data_files import write_nuscenes
with tempfile.TemporaryDirectory() as root:
    data = dataclasses.replace(exp.data, img_scale=(96, 54),
                               classes=exp.data.classes[:4])
    write_nuscenes(root, 3, (100, 176), (54, 95), data.classes)
    ds = CocoFusionDataset('ann.json', data.classes, data_root=root)
    loader = DetDataLoader(ds, data, 2, train=True)
    batch = next(iter(loader))
    assert batch['img'].shape == (2, 64, 96, 3), batch['img'].shape
    m = train_step(state, batch, torch.Generator().manual_seed(0))
    assert bool(m['loss'].isfinite()) and state.applied == 2
bad = sorted(m for m in sys.modules if m.split('.')[0] in {forbidden})
assert not bad, bad
print('ok')
"""


def test_tiny_slice_runs_without_jax_in_a_fresh_process():
    env = {**os.environ, 'PYTHONPATH': ''}
    proc = subprocess.run(
        [sys.executable, '-c', _SCRIPT.format(forbidden=set(FORBIDDEN))],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith('ok')


def test_no_module_of_the_package_imports_jax():
    offenders = []
    for path in [*PKG.rglob('*.py'), *SCRIPTS]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or '']
            else:
                continue
            offenders += [f'{path.relative_to(ROOT)}: {n}' for n in names
                          if n.split('.')[0] in FORBIDDEN]
    assert offenders == []


def test_init_detector_defaults_to_the_card():
    from hrfuser_tpu_torch import init_detector
    device = inspect.signature(init_detector).parameters['device'].default
    assert device == 'cuda'
