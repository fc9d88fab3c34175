"""The rendering CLIs on the CPU against the JAX package: `tools.test
--show-dir` (`tools/test.py:141-165`) and `tools.browse_dataset`
(`tools/browse_dataset.py`).

`--show-dir`: `tiny_fusion_test` (random weights, its 4 classes, the grid
cut to 64x96 as in `tests/test_torch_data_cli.py`) over a 3-image
nuScenes folder of `cv2` JPEG frames writes one JPEG per image under the
frame's basename. Each file decodes, outside the labels' text boxes
(the `getTextSize` box grown by 2 px), to what `cv2.imencode` of JAX's
`draw_detections` on the same results decodes to; the bytes are equal
too, since the labels are drawn exactly.

`browse_dataset`: the port's CLI and the JAX CLI (`main`, loaded by
path) over the same nuScenes and STF folders write the same
`sample_{i}.jpg` composites, compared decoded with the text boxes
masked, and byte for byte. The camera frames are written at the size
the train pipeline resizes them to (nuScenes 54x96 at `img_scale` (96,
54); STF's 1024x1920 frame cropped to 384x1248), so no resize, which
differs between the two packages by up to 2e-3 of a level
(`tests/test_torch_data_loader.py`), enters the composite.
"""

import dataclasses
import importlib.util
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import hrfuser_tpu.configs as jax_configs
import hrfuser_tpu_torch.apis.inference as port_inference
import hrfuser_tpu_torch.configs as port_configs
from hrfuser_tpu.utils import visualization as J
from hrfuser_tpu_torch.data import norms
from hrfuser_tpu_torch.data.datasets import build_dataset
from hrfuser_tpu_torch.data.loader import build_pipeline
from hrfuser_tpu_torch.tools import browse_dataset
from hrfuser_tpu_torch.tools import test as test_cli
from tests.oracles.data_files import write_nuscenes, write_stf

ROOT = Path(__file__).resolve().parents[1]
NUS, STF = 'tiny_fusion_test', 'cascade_rcnn_hrfuser_t_1x_stf_r1248_4mod'
NUS_SCALE = (96, 54)
SPLITS = ('nuscenes_infos_train_mono3d.coco.json',
          'nuscenes_infos_val_mono3d.coco.json')


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jpeg(path, bgr):
    assert cv2.imwrite(path, bgr, [cv2.IMWRITE_JPEG_QUALITY, 90])


def _small(data):
    if data.dataset == 'stf':
        return data
    return dataclasses.replace(data, img_scale=NUS_SCALE,
                               classes=data.classes[:4])


@pytest.fixture
def small_configs(monkeypatch):
    """Both packages see the nuScenes config at (96, 54), 4 classes."""
    port_real, jax_real = port_configs.get_experiment, jax_configs.get_config

    def port(name):
        exp = port_real(name)
        return dataclasses.replace(exp, data=_small(exp.data))

    def jax(name):
        cfg = jax_real(name)
        return dataclasses.replace(cfg, data=_small(cfg.data))

    monkeypatch.setattr(port_configs, 'get_experiment', port)
    monkeypatch.setattr(port_inference, 'get_experiment', port)
    monkeypatch.setattr(jax_configs, 'get_config', jax)


def _text_mask(hw, boxes, labels, scores, names, thr):
    """Each drawn label's getTextSize box grown by 2 px."""
    mask = np.zeros(hw, bool)
    for i, box in enumerate(boxes):
        score = None if scores is None else float(scores[i])
        if score is not None and score < thr:
            continue
        text = str(names[int(labels[i])]) if labels is not None else ''
        if score is not None:
            text = f'{text} {score:.2f}'.strip()
        x = int(round(float(box[0])))
        y = max(int(round(float(box[1]))) - 4, 10)
        (tw, th), base = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX,
                                         0.45, 1)
        mask[max(y - th - 2, 0):max(y + base + 2, 0),
             max(x - 2, 0):max(x + tw + 2, 0)] = True
    return mask


def _decoded(data: bytes) -> np.ndarray:
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


def test_show_dir_writes_what_jax_draws(small_configs, monkeypatch,
                                        tmp_path):
    classes = port_configs.get_experiment(NUS).data.classes
    root = write_nuscenes(tmp_path / 'nus', 3, (100, 176), (54, 95),
                          classes, seed=4, splits=SPLITS, ext='jpg',
                          writer=_jpeg)
    seen = []
    real = test_cli.show_results

    def recorded(results, dataset, *args, **kw):
        seen.append(results)
        return real(results, dataset, *args, **kw)

    monkeypatch.setattr(test_cli, 'show_results', recorded)
    show = tmp_path / 'show'
    test_cli.main([NUS, '--device', 'cpu', '--data-root', str(root),
                   '--batch-size', '2', '--show-dir', str(show),
                   '--show-score-thr', '0.0'])
    (results,) = seen
    assert sorted(p.name for p in show.iterdir()) == [
        f'{i:04d}.jpg' for i in range(3)]
    drawn = 0
    for r in results:
        fname = r['meta']['filename']
        want = J.draw_detections(cv2.imread(fname), r['boxes'], r['labels'],
                                 r['scores'], class_names=classes,
                                 score_thr=0.0)
        want_bytes = cv2.imencode('.jpg', want)[1].tobytes()
        got_bytes = (show / Path(fname).name).read_bytes()
        text = _text_mask(want.shape[:2], r['boxes'], r['labels'],
                          r['scores'], classes, 0.0)
        got, ref = _decoded(got_bytes), _decoded(want_bytes)
        np.testing.assert_array_equal(got[~text], ref[~text])
        assert got_bytes == want_bytes
        drawn += len(r['boxes'])
    assert drawn >= 3


def test_show_results_skips_what_it_cannot_read(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (20, 30, 3)).astype(
        np.uint8)
    cv2.imwrite(str(tmp_path / 'a.png'), img)
    (tmp_path / 'bad.jpg').write_bytes(b'not a jpeg')
    empty = dict(boxes=np.zeros((0, 4), np.float32),
                 labels=np.zeros(0, np.int64), scores=np.zeros(0, np.float32))
    results = [dict(empty, meta={'filename': 'a.png'}),
               dict(empty, meta=None),
               dict(empty, meta={'filename': 'missing.png'}),
               dict(empty, meta={'filename': str(tmp_path / 'bad.jpg')})]

    class Dataset:
        img_prefix = str(tmp_path)

    out = tmp_path / 'show'
    n = test_cli.show_results(results, Dataset(), ['car'], str(out), '',
                              device='cpu')
    assert n == 1 and [p.name for p in out.iterdir()] == ['a.png']
    np.testing.assert_array_equal(cv2.imread(str(out / 'a.png')), img)


def _jax_browse():
    spec = importlib.util.spec_from_file_location(
        'jax_browse_dataset', ROOT / 'tools' / 'browse_dataset.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize('family', ['nus', 'stf'])
def test_browse_writes_the_jax_composites(family, small_configs,
                                          monkeypatch, tmp_path):
    name = NUS if family == 'nus' else STF
    data = port_configs.get_experiment(name).data
    if family == 'nus':
        root = write_nuscenes(tmp_path / 'data', 3, (54, 96), (54, 96),
                              data.classes, seed=5, splits=SPLITS[:1])
    else:
        root = write_stf(tmp_path / 'data', 2, (1024, 1920), (576, 1264),
                         data.classes, seed=5)
    num = 3 if family == 'nus' else 2
    jax_out, port_out = tmp_path / 'jax', tmp_path / 'port'
    monkeypatch.setattr(sys, 'argv', ['browse_dataset.py', name,
                                      '--data-root', str(root), '--out-dir',
                                      str(jax_out), '--num', str(num)])
    _jax_browse().main()
    written = browse_dataset.main([name, '--data-root', str(root),
                                   '--out-dir', str(port_out), '--num',
                                   str(num), '--device', 'cpu'])
    assert [Path(p).name for p in written] == [
        f'sample_{i}.jpg' for i in range(num)]
    dataset = build_dataset(data, str(root), 'train')
    pipe = build_pipeline(data, train=True, device='cpu')
    boxes_drawn = 0
    for i in range(num):
        res = dataset.sample(i)
        res['rng'] = np.random.default_rng(i)
        out = pipe(res)
        v = out['gt_valid']
        want_bytes = (jax_out / f'sample_{i}.jpg').read_bytes()
        got_bytes = (port_out / f'sample_{i}.jpg').read_bytes()
        got, want = _decoded(got_bytes), _decoded(want_bytes)
        assert got.shape == want.shape
        text = np.zeros(got.shape[:2], bool)
        hw = out['img'].shape[:2]
        text[:hw[0], :hw[1]] = _text_mask(hw, out['gt_boxes'][v],
                                          out['gt_labels'][v], None,
                                          data.classes, 0.0)
        np.testing.assert_array_equal(got[~text], want[~text])
        assert got_bytes == want_bytes
        boxes_drawn += int(v.sum())
        # the composite the port encoded is the one it returns
        norm = norms.STF if family == 'stf' else norms.NUS
        comp = browse_dataset.composite(out, data, norm, 'cpu').numpy()
        assert cv2.imencode('.jpg', comp)[1].tobytes() == got_bytes
    assert boxes_drawn >= 2


def test_browse_defaults_to_the_card():
    assert browse_dataset.parse_args(['c', '--data-root', 'r']).device == \
        'cuda'
