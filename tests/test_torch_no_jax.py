"""`hrfuser_tpu_torch` never imports JAX, flax, orbax, the JAX package
or `cv2` (the card's machine has neither JAX nor `cv2`).

Checked in a fresh interpreter (this test process has JAX loaded by
`tests/conftest.py`) that runs the tiny fusion and camera-only slices,
`inference_detector`, `run_inference`, a training step, a JPEG decode
(`data/jpeg.py`, the pixel kernel's twin) and a `DetDataLoader` over PNG
and over JPEG files end to end on the CPU, a one-rank
`gloo` sharded train step and a sharded `run_inference`, the offline
converters (one nuScenes sample on a fake DB, an STF frame, the inverse
depth warp) on the CPU, the renderings (detections drawn with labels, a
heatmap, a JPEG written, an 8-bit gated LUT image), and imports the KITTI
evaluation, the model tools (FLOP count, drift, `print_config`,
`publish_model`), `tools.browse_dataset`, `tools.real_parity` and
`tools.train --remat`'s argument, and statically over every
module of the package and the scripts that drive it on the card. The
one exception is `tests/oracles/make_render_tables.py`, which renders
the glyph and colour-map tables from `cv2` in the sandbox (it may import
`cv2`, and nothing else forbidden). Its entry points run on the card
unless asked for the CPU.
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
SCRIPTS = [ROOT / 'chip_smoke.py', ROOT / 'chip_profile.py',
           ROOT / 'tests' / 'oracles' / 'card_checks.py',
           ROOT / 'tests' / 'oracles' / 'offline_data.py',
           ROOT / 'tests' / 'oracles' / 'jpeg_encoder.py',
           ROOT / 'tests' / 'oracles' / 'parallel_ranks.py',
           ROOT / 'tests' / 'oracles' / 'make_render_tables.py']
# what a script may import although the package may not
ALLOWED = {ROOT / 'tests' / 'oracles' / 'make_render_tables.py': {'cv2'}}

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
from hrfuser_tpu_torch.apis.flops import count_params
from hrfuser_tpu_torch.tools import (get_flops, numerics_drift, print_config,
                                     publish_model)
assert count_params(det.model) > 0
assert print_config.to_tree(exp)['model']['roi']['max_grid'] == 4
import tempfile
from hrfuser_tpu_torch.data.datasets.coco import CocoFusionDataset
from hrfuser_tpu_torch.data.loader import DetDataLoader
from tests.oracles.data_files import write_nuscenes
with tempfile.TemporaryDirectory() as root:
    data = dataclasses.replace(exp.data, img_scale=(96, 54),
                               classes=exp.data.classes[:4])
    write_nuscenes(root, 3, (100, 176), (54, 95), data.classes)
    ds = CocoFusionDataset('ann.json', data.classes, data_root=root)
    loader = DetDataLoader(ds, data, 2, train=True, device='cpu')
    batch = next(iter(loader))
    assert batch['img'].shape == (2, 64, 96, 3), batch['img'].shape
    m = train_step(state, batch, torch.Generator().manual_seed(0))
    assert bool(m['loss'].isfinite()) and state.applied == 2
from hrfuser_tpu_torch.data import jpeg
from tests.oracles.jpeg_encoder import encode, image_coefficients
def write_jpeg(path, bgr):
    with open(path, 'wb') as f:
        f.write(encode(*image_coefficients(bgr, 90), bgr.shape[:2]))
with tempfile.TemporaryDirectory() as root:
    write_nuscenes(root, 2, (100, 176), (54, 95), data.classes, ext='jpg',
                   writer=write_jpeg)
    ds = CocoFusionDataset('ann.json', data.classes, data_root=root)
    batch = next(iter(DetDataLoader(ds, data, 2, train=False,
                                    device='cpu')))
    assert batch['img'].shape == (2, 64, 96, 3), batch['img'].shape
    with open(root + '/samples/CAM_FRONT/0000.jpg', 'rb') as f:
        assert jpeg.decode_jpeg(f.read(), 'cpu').shape == (100, 176, 3)
from hrfuser_tpu_torch.parallel.api import make_sharded_train_step
from hrfuser_tpu_torch.parallel.mesh import free_store, process_group
store, address = free_store(1)
with process_group('cpu', rank=0, world_size=1, address=address) as group:
    state = create_train_state(CascadeRCNN(exp.model), exp.optim,
                               exp.schedule, 100)
    step = make_sharded_train_step(state, group)
    m = step(next(synthetic_batches(exp, 2, (64, 96))))
    assert bool(m['loss'].isfinite()) and state.applied == 1
    with tempfile.TemporaryDirectory() as root:
        write_nuscenes(root, 3, (100, 176), (54, 95), data.classes)
        ds = CocoFusionDataset('ann.json', data.classes, data_root=root,
                               test_mode=True)
        loader = DetDataLoader(ds, data, 2, train=False, device='cpu',
                               rank=0, world_size=1)
        det.data = data
        got = run_inference(det, loader, progress=False, group=group)
        assert len(got) == 3, len(got)
from hrfuser_tpu_torch.data.gated_warp import inverse_depth_warp
from hrfuser_tpu_torch.tools import create_data, stf_projection
from tests.oracles.offline_data import nuscenes_sample, stf_frame
db, lidar, radars = nuscenes_sample(seed=0, n_lidar=500, n_radar=10)
info, imgs = create_data.convert_sample(db, db.sample, lidar, radars,
                                        device='cpu')
assert imgs['CAM_FRONT']['rih'].shape == (360, 640, 3), info
yzi, yzv = stf_projection.project_frame(*stf_frame(rng, 2000, 10),
                                        device='cpu')
assert yzi.shape == yzv.shape == (768, 1280, 3)
k = np.array([[20.0, 0, 16], [0, 20.0, 12], [0, 0, 1]])
warped = inverse_depth_warp(torch.rand(24, 32), torch.full((24, 32), 5.0),
                            k, k, np.eye(4))
assert warped.shape == (24, 32, 1) and bool(warped.isfinite().all())
from hrfuser_tpu_torch.data.jpeg import decode_jpeg, imencode
from hrfuser_tpu_torch.data.stf_lut import gated_raw_to_lut8
from hrfuser_tpu_torch.tools import browse_dataset
from hrfuser_tpu_torch.utils.visualization import (draw_detections,
                                                   sensor_image_to_heatmap)
vis = draw_detections(raw, np.array([[5.0, 12.0, 40.0, 50.0]]), [1], [0.9],
                      class_names=['car', 'truck'], device='cpu')
assert vis.shape == raw.shape and bool((vis.numpy() != raw).any())
heat = sensor_image_to_heatmap(u16[0], device='cpu')
assert heat.shape == (60, 90, 3)
data = imencode(vis, device='cpu')
assert decode_jpeg(data, 'cpu').shape == (60, 90, 3)
grey = gated_raw_to_lut8(rng.integers(0, 1024, (40, 72)).astype(np.uint16),
                         device='cpu')
assert grey.shape == (40, 72) and grey.dtype == torch.uint8
from hrfuser_tpu_torch.tools import real_parity
from hrfuser_tpu_torch.tools import train as train_tool
assert train_tool.parse_args(['tiny_fusion_test', '--remat']).remat
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
                          if n.split('.')[0] in FORBIDDEN
                          and n.split('.')[0] not in ALLOWED.get(path, ())]
    assert offenders == []


def test_init_detector_defaults_to_the_card():
    from hrfuser_tpu_torch import init_detector
    device = inspect.signature(init_detector).parameters['device'].default
    assert device == 'cuda'


def test_image_loading_defaults_to_the_card():
    from hrfuser_tpu_torch.data import jpeg
    from hrfuser_tpu_torch.data.loader import DetDataLoader, build_pipeline
    from hrfuser_tpu_torch.data.pipelines import loading
    for fn in (jpeg.decode_jpeg, loading.imread, loading.imdecode,
               loading.read_jpeg, loading.LoadImageFromFile, build_pipeline,
               DetDataLoader):
        assert inspect.signature(fn).parameters['device'].default == 'cuda'


def test_real_parity_defaults_to_the_card():
    from hrfuser_tpu_torch.tools import real_parity
    assert real_parity.parse_args(['--dry-run']).device == 'cuda'
    assert real_parity.parse_args(['a.pth', 'data']).device == 'cuda'


def test_offline_converters_default_to_the_card():
    from hrfuser_tpu_torch.tools import (create_data, stf_gated_warp,
                                         stf_projection)
    for fn in (create_data.convert_sample, stf_projection.project_frame,
               stf_gated_warp.warp_frame):
        assert inspect.signature(fn).parameters['device'].default == 'cuda'
    for tool, argv in ((create_data, ['nuscenes', '--root-path', 'r']),
                       (stf_projection, ['--root', 'r', '--calib-root', 'c',
                                         '--split', 's']),
                       (stf_gated_warp, ['--root', 'r', '--split', 's'])):
        assert tool.parse_args(argv).device == 'cuda'
