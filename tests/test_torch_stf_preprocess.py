"""The port's STF readers (`data/stf_io.py`), LUTs (`data/stf_lut.py`)
and projection CLI (`tools/stf_projection.py`) against the JAX package
on the same seeded inputs.

`project_frame` must be bit-equal to `tools/stf_projection.py`'s in both
modes, on a scan with many points a pixel (HDL-64 at 2,000 points onto
a 160x96 grid). The cases of `tests/test_stf_io.py` and
`tests/test_stf_lut.py` are mirrored on the port.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from hrfuser_tpu.data import stf_io as jax_io
from hrfuser_tpu.data import stf_lut as jax_lut
from hrfuser_tpu_torch.data import stf_io, stf_lut
from hrfuser_tpu_torch.data.pipelines.loading import imread
from hrfuser_tpu_torch.data.projection import dequantize
from hrfuser_tpu_torch.tools import stf_projection
from tests.oracles.offline_data import stf_frame

ROOT = Path(__file__).resolve().parents[1]


def _jax_tool():
    """`tools/stf_projection.py` (a script, not a module of a package)."""
    spec = importlib.util.spec_from_file_location(
        'jax_stf_projection', ROOT / 'tools' / 'stf_projection.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize('mode', ['reference', 'zbuffer'])
def test_project_frame_bit_equal_to_the_jax_tool(mode):
    rng = np.random.default_rng(0)
    scan, radar, k, t = stf_frame(rng, 2000, 60, (160, 96))
    k = k * [[0.125], [0.125], [1.0]]        # the camera on a 160x96 grid
    want = _jax_tool().project_frame(scan, radar, k, t, (160, 96), mode)
    got = stf_projection.project_frame(scan, radar, k, t, (160, 96), mode,
                                       device='cpu')
    for g, w in zip(got, want):
        assert g.dtype == np.uint16 and g.shape == (96, 160, 3)
        np.testing.assert_array_equal(g, w)
    assert (want[0][..., 1] != 20000).sum() > 150
    assert (want[1][..., 1] != 20000).any()


def test_project_frame_smoke():
    """`tests/test_stf_io.py::test_project_frame_smoke` on the port."""
    rng = np.random.default_rng(0)
    scan = np.zeros((50, 5), np.float32)
    scan[:, 0] = rng.uniform(5, 40, 50)
    scan[:, 1] = rng.uniform(-5, 5, 50)
    scan[:, 2] = rng.uniform(-1, 2, 50)
    scan[:, 3] = rng.uniform(0, 1, 50)
    radar = np.zeros((3, 5))
    radar[:, 0] = [10.0, 20.0, 30.0]
    radar[:, 3] = [1.0, -2.0, 0.5]
    t = np.array([[0., -1., 0., 0.], [0., 0., -1., 0.], [1., 0., 0., 0.],
                  [0., 0., 0., 1.]])
    k = np.array([[500., 0., 640.], [0., 500., 384.], [0., 0., 1.]])
    yzi, yzv = stf_projection.project_frame(scan, radar, k, t,
                                            device='cpu')
    assert yzi.shape == (768, 1280, 3)
    assert (dequantize(yzi) != 0).any()
    deqr = dequantize(yzv)
    cols = np.unique(np.nonzero(deqr[:, :, 1])[1])
    assert len(cols)
    for c in cols:
        assert (deqr[:, c, 1] != 0).all()
    empty = stf_projection.project_frame(scan, np.zeros((0, 5)), k, t,
                                         device='cpu')[1]
    assert (empty == 20000).all()


def _tf_entry(child, parent, t, q):
    return dict(child_frame_id=child, frame_id=parent, transform=dict(
        translation=dict(x=t[0], y=t[1], z=t[2]),
        rotation=dict(w=q[0], x=q[1], y=q[2], z=q[3])))


def _calib_folder(root):
    cam = dict(P=[[100.0, 0, 32, 0], [0, 100.0, 24, 0], [0, 0, 1, 0]])
    (root / 'calib_cam_stereo_left.json').write_text(json.dumps(cam))
    q = [np.cos(0.2), 0.1, np.sin(0.2) * 0.9, 0.05]
    tree = [_tf_entry('lidar_hdl64_s3_roof', 'base', [0, 0, 2.0], q),
            _tf_entry('mid', 'base', [1.0, 0.2, 1.0], [1.0, 0, 0, 0]),
            _tf_entry('cam_stereo_left_optical', 'mid', [0.3, 0, 0.5],
                      [0.5, -0.5, 0.5, -0.5])]
    (root / 'calib_tf_tree_full.json').write_text(json.dumps(tree))
    return tree


def test_main_writes_the_projections(tmp_path):
    """The CLI end to end on the CPU: calib, split, scans and radar json
    in, uint16 PNGs out that decode to `project_frame`'s images."""
    _calib_folder(tmp_path)
    rng = np.random.default_rng(5)
    scan, radar, _, _ = stf_frame(rng, 3000, 8, (160, 96))
    (tmp_path / 'lidar_hdl64_strongest').mkdir()
    (tmp_path / 'radar_targets').mkdir()
    scan.tofile(tmp_path / 'lidar_hdl64_strongest' / 'a_00001.bin')
    (tmp_path / 'radar_targets' / 'a_00001.json').write_text(json.dumps(
        {'targets': [dict(x_sc=float(r[0]), y_sc=float(r[1]),
                          rVelOverGroundOdo_sc=float(r[3]),
                          rDist_sc=float(r[4])) for r in radar]}))
    (tmp_path / 'split.txt').write_text('a,00001\n')
    stf_projection.main(['--root', str(tmp_path), '--calib-root',
                         str(tmp_path), '--split', str(tmp_path / 'split.txt'),
                         '--device', 'cpu'])
    k, t = stf_io.load_calib(str(tmp_path))
    want = stf_projection.project_frame(
        scan, stf_io.load_radar_targets(
            str(tmp_path / 'radar_targets' / 'a_00001.json')), k, t,
        device='cpu')
    for sub, w in zip(('lidar_projections/yzi', 'radar_projections/yzv'),
                      want):
        got = imread(str(tmp_path / sub / 'a_00001.png'), 'unchanged')
        np.testing.assert_array_equal(got, w)


def test_project_frame_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        stf_projection.project_frame(np.zeros((1, 5), np.float32),
                                     np.zeros((0, 5)), np.eye(3), np.eye(4))


# stf_io: the cases of tests/test_stf_io.py, and equality with JAX

def test_velodyne_roundtrip(tmp_path):
    scan = np.random.default_rng(0).normal(0, 1, (100, 5)).astype(np.float32)
    scan.tofile(tmp_path / 's.bin')
    out = stf_io.load_velodyne_scan(str(tmp_path / 's.bin'))
    np.testing.assert_array_equal(out, scan)


def test_radar_targets(tmp_path):
    data = dict(targets=[
        dict(x_sc=1.0, y_sc=2.0, rVelOverGroundOdo_sc=3.0, rDist_sc=4.0),
        dict(x_sc=-1.0, y_sc=0.5, rVelOverGroundOdo_sc=0.0, rDist_sc=9.0)])
    (tmp_path / 'r.json').write_text(json.dumps(data))
    out = stf_io.load_radar_targets(str(tmp_path / 'r.json'))
    assert out.shape == (2, 5) and out.dtype == np.float64
    np.testing.assert_allclose(out[0], [1.0, 2.0, 0.0, 3.0, 4.0])


def test_chain_transform():
    q_id = [1.0, 0, 0, 0]
    tree = [_tf_entry('lidar', 'base', [0, 0, 2.0], q_id),
            _tf_entry('cam', 'base', [1.0, 0, 1.5], q_id)]
    p = stf_io._chain_transform(tree, 'lidar', 'cam') @ [0., 0., 0., 1.]
    np.testing.assert_allclose(p[:3], [-1.0, 0.0, 0.5], atol=1e-12)


def test_load_calib_equals_jax(tmp_path):
    tree = _calib_folder(tmp_path)
    k, t = stf_io.load_calib(str(tmp_path))
    kj, tj = jax_io.load_calib(str(tmp_path))
    np.testing.assert_array_equal(k, kj)
    np.testing.assert_array_equal(t, tj)
    assert k.shape == (3, 3) and k[0, 0] == 100.0
    np.testing.assert_array_equal(
        stf_io._chain_transform(tree, 'mid', 'lidar_hdl64_s3_roof'),
        jax_io._chain_transform(tree, 'mid', 'lidar_hdl64_s3_roof'))


def test_split_loader(tmp_path):
    (tmp_path / 'dense_fog_day.txt').write_text(
        '2018-02-03_21-04-07,00100\n2018-02-03_21-04-07,00200\n')
    (tmp_path / 'dense_fog_night.txt').write_text(
        '2018-10-29_16-34-16,00050\n')
    frames = stf_io.load_split(str(tmp_path / 'dense_fog_day.txt'))
    assert frames == ['2018-02-03_21-04-07_00100',
                      '2018-02-03_21-04-07_00200']
    ws = stf_io.load_weather_splits(str(tmp_path))
    assert ws == jax_io.load_weather_splits(str(tmp_path))
    assert ws['dense_fog'][-1] == '2018-10-29_16-34-16_00050'
    assert ws['snow'] == []


# stf_lut: the cases of tests/test_stf_lut.py, and equality with JAX

def test_luts_equal_jax():
    got, want = stf_lut.luts(), jax_lut.luts()
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == np.uint16
        np.testing.assert_array_equal(got[name], want[name])
    lut = got['decompand']
    assert len(lut) == 3968 and lut[0] == 0 and lut[1023] == 1023
    assert lut[-1] == 65472
    for bits, name in ((16, 'daytime'), (16, 'nighttime'), (10, 'gated')):
        assert got[name].shape == (2 ** bits,)
        assert (np.diff(got[name].astype(np.int64)) >= 0).all()


@pytest.mark.parametrize('dtype', [np.int16, np.int32, np.int64])
def test_decompand_image_equals_jax(dtype):
    raw = np.random.default_rng(1).integers(0, 3968, (48, 80))
    got = stf_lut.decompand_image(torch.from_numpy(raw.astype(dtype)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  jax_lut.decompand_image(raw))


def test_decompand_image_refuses_values_off_the_lut():
    with pytest.raises(ValueError, match='12-bit LUT'):
        stf_lut.decompand_image(torch.tensor([[0, 3968]]))
    with pytest.raises(ValueError, match='12-bit LUT'):
        stf_lut.decompand_image(torch.tensor([[-1, 5]]))


def test_lut8_images_raise_naming_the_roadmap_item():
    """The roadmap item ("The 8-bit LUT renderings") is done: the two
    functions that raised now return JAX's images (the full comparison
    is `tests/test_torch_stf_lut8.py`)."""
    raw = np.random.default_rng(2).integers(0, 1024, (12, 20)).astype(
        np.uint16)
    np.testing.assert_array_equal(
        stf_lut.raw_to_lut8(raw, True, device='cpu').numpy(),
        jax_lut.raw_to_lut8(raw, True))
    np.testing.assert_array_equal(
        stf_lut.gated_raw_to_lut8(raw, device='cpu').numpy(),
        jax_lut.gated_raw_to_lut8(raw))
    assert not hasattr(stf_lut, 'LUT8_NOT_PORTED')
