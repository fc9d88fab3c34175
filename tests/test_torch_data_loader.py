"""The port's `DetDataLoader` against the JAX package's, on the CPU.

Seeded synthetic folders in the converters' formats
(`tests/oracles/data_files.py`): nuScenes with JPEG camera frames
(decoded by the port's JPEG decoder with `device='cpu'`) of
100x176 brought to a 54x95 grid (`img_scale` (96, 54), a downsampling
resize by 0.54) and STF at its real sizes (1024x1920 camera PNGs, both
crops, the 384x1248 frame). Over two epochs, prefetch on and off, train
and test: the order, the flips, crops and modality drops, the boxes,
labels, `gt_valid`, `num_real` and metas equal; sensor streams equal;
camera images within `Resize`'s 2e-3 on 0-255 values, divided by the
smallest std of `Normalize`. Then: a short last batch repeats its last
sample, an error while loading reaches the iterating thread, an
iteration left early stops the prefetch thread, and a loader batch takes
a train step on the CPU.
"""

# before any test runs: `tests/test_stf_io.py` puts `tools/` (which holds
# a `profile.py`) first on `sys.path`, and torch imports `cProfile`, and
# through it `profile`, when it builds its first optimizer
import cProfile  # noqa: F401
import dataclasses
import threading

import cv2
import numpy as np
import pytest
import torch

from hrfuser_tpu.configs import get_config as jax_get_config
from hrfuser_tpu.data.datasets.coco import CocoFusionDataset as JaxCoco
from hrfuser_tpu.data.datasets.kitti2d import Kitti2DDataset as JaxKitti
from hrfuser_tpu.data.loader import DetDataLoader as JaxLoader
from hrfuser_tpu_torch.configs import get_experiment
from hrfuser_tpu_torch.data import norms
from hrfuser_tpu_torch.data.datasets.coco import CocoFusionDataset
from hrfuser_tpu_torch.data.datasets.kitti2d import Kitti2DDataset
from hrfuser_tpu_torch.data.loader import DetDataLoader
from tests.oracles.data_files import write_nuscenes, write_stf

RESIZE_ATOL = 2e-3
NUS = 'tiny_fusion_test'
STF = 'cascade_rcnn_hrfuser_t_1x_stf_r1248_4mod'
NUS_SCALE = (96, 54)                 # (w, h): 100x176 -> 54x95, pad 64x96


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jpeg(path, bgr):
    assert cv2.imwrite(path, bgr, [cv2.IMWRITE_JPEG_QUALITY, 90])


@pytest.fixture(scope='module')
def folders(tmp_path_factory):
    classes = get_experiment(NUS).data.classes
    nus = write_nuscenes(tmp_path_factory.mktemp('nus'), 5, (100, 176),
                         (54, 95), classes, ext='jpg', writer=_jpeg)
    stf = write_stf(tmp_path_factory.mktemp('stf'), 3, (1024, 1920),
                    (576, 1264), get_experiment(STF).data.classes,
                    splits=('dense_infos_train.pkl',))
    return dict(nus=str(nus), stf=str(stf))


def _pair(folders, family, train, prefetch, batch=2, seed=3):
    """(port loader, JAX loader) over the same files, config and seed."""
    if family == 'nus':
        # the tiny model's 4 classes; boxes of the other 6 are dropped
        exp = get_experiment(NUS)
        classes = exp.data.classes[:exp.model.roi.num_classes]
        pdata = dataclasses.replace(exp.data, img_scale=NUS_SCALE,
                                    classes=classes)
        jdata = dataclasses.replace(jax_get_config(NUS).data,
                                    img_scale=NUS_SCALE, classes=classes)
        kw = dict(data_root=folders['nus'], test_mode=not train)
        pds = CocoFusionDataset('ann.json', pdata.classes, **kw)
        jds = JaxCoco('ann.json', jdata.classes, **kw)
    else:
        pdata, jdata = get_experiment(STF).data, jax_get_config(STF).data
        kw = dict(data_root=folders['stf'], test_mode=not train)
        pds = Kitti2DDataset('dense_infos_train.pkl', pdata.classes, **kw)
        jds = JaxKitti('dense_infos_train.pkl', jdata.classes, **kw)
    return (DetDataLoader(pds, pdata, batch, train, seed=seed,
                          prefetch=prefetch, device='cpu'),
            JaxLoader(jds, jdata, batch, train, seed=seed, prefetch=prefetch))


def _same_batch(got, want, img_atol):
    assert set(got) == set(want)
    np.testing.assert_allclose(got['img'], want['img'], atol=img_atol, rtol=0)
    assert len(got.get('mod_imgs', [])) == len(want.get('mod_imgs', []))
    for a, b in zip(got.get('mod_imgs', []), want.get('mod_imgs', [])):
        np.testing.assert_array_equal(a, b)
    for k in ('gt_boxes', 'gt_labels', 'gt_valid', 'img_shapes',
              'scale_factors', 'num_real'):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got['metas'] == want['metas']


@pytest.mark.parametrize('prefetch', [0, 2])
@pytest.mark.parametrize('train', [True, False], ids=['train', 'test'])
@pytest.mark.parametrize('family', ['nus', 'stf'])
def test_batches_equal_jax_over_two_epochs(folders, family, train,
                                           prefetch):
    port, jax_loader = _pair(folders, family, train, prefetch)
    table = norms.STF if family == 'stf' else norms.NUS
    img_atol = RESIZE_ATOL / min(table['img']['std'])
    assert len(port) == len(jax_loader)
    flips, drops = [], []
    for epoch in range(2):
        got, want = list(port), list(jax_loader)
        assert len(got) == len(want) == len(port)
        for a, b in zip(got, want):
            _same_batch(a, b, img_atol)
            flips += [m['flip'] for m in a['metas']]
            drops += [not x.any() for m in [a['img'], *a.get('mod_imgs', [])]
                      for x in m]                   # per sample and stream
        assert port.epoch == jax_loader.epoch == epoch + 1
    if train:                     # the draws are live on both sides
        assert any(flips) and not all(flips)
        assert any(drops)


def test_short_last_batch_repeats_its_last_sample(folders):
    port, _ = _pair(folders, 'nus', train=False, prefetch=2)
    batches = list(port)
    assert [int(b['num_real']) for b in batches] == [2, 2, 1]
    last = batches[-1]
    np.testing.assert_array_equal(last['img'][0], last['img'][1])
    assert last['metas'][0] == last['metas'][1]
    assert [m['sample_idx'] for b in batches
            for m in b['metas'][:int(b['num_real'])]] == list(range(5))


def test_a_loading_error_reaches_the_iterating_thread(folders, tmp_path):
    port, _ = _pair(folders, 'nus', train=False, prefetch=2)
    port.dataset.img_prefix = str(tmp_path)             # no files there
    with pytest.raises(FileNotFoundError):
        list(port)
    assert port.epoch == 0
    assert not [t for t in threading.enumerate()
                if t.name == 'DetDataLoader']


def test_leaving_an_iteration_early_stops_the_prefetch_thread(folders):
    port, _ = _pair(folders, 'nus', train=True, prefetch=1)
    it = iter(port)
    next(it)
    it.close()
    assert not [t for t in threading.enumerate()
                if t.name == 'DetDataLoader']
    assert port.epoch == 0                      # the epoch did not end


def test_a_loader_batch_takes_a_train_step(folders):
    """`batch_to` moves the arrays the step reads and leaves `metas` /
    `num_real` on the host; int32 labels from the loader train as the
    synthetic batches' do."""
    from hrfuser_tpu_torch.apis.train import (batch_to, create_train_state,
                                              train_step)
    from hrfuser_tpu_torch.models.detectors.cascade_rcnn import CascadeRCNN
    port, _ = _pair(folders, 'nus', train=True, prefetch=0)
    batch = next(iter(port))
    moved = batch_to(batch, 'cpu')
    assert set(moved) == {'img', 'mod_imgs', 'gt_boxes', 'gt_labels',
                          'gt_valid', 'img_shapes'}
    assert moved['gt_labels'].dtype == torch.int32
    exp = get_experiment(NUS)
    torch.manual_seed(0)
    state = create_train_state(CascadeRCNN(exp.model), exp.optim,
                               exp.schedule, len(port))
    metrics = train_step(state, batch, torch.Generator().manual_seed(0))
    assert bool(metrics['loss'].isfinite()) and state.applied == 1
    assert float(metrics['loss_rpn_cls']) > 0
