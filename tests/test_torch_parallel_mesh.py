"""`parallel/mesh.py`: groups, row sharding, collection, and the
rank-sharded `DetDataLoader`.

Two `gloo` ranks on the CPU (spawned by `run_ranks`, one intra-op
thread each, a deadline of `DEADLINE_S`): `collect_results` returns
every rank's list in rank order on every rank, `local_rows` / `gather`
cut and rejoin rows, the differentiable sum sends the summed gradient to
every rank. In one process, `collect_results` and `local_rows` are the
identity, as JAX's `hrfuser_tpu.parallel.mesh` functions are; a world of
one rank is a valid group; a rank asked for CUDA where there is none, or
`nccl` on the CPU, raises. The rank-sharded loader: over a 7-image
folder, the ranks' batches joined are the one-process loader's, row for
row, over two train epochs (batch 4 of 2 a rank), and in test mode (a
ragged last batch) each rank reads only its own samples.
"""

import numpy as np
import pytest
import torch

from hrfuser_tpu.parallel import mesh as jax_mesh
from hrfuser_tpu_torch.configs import get_experiment
from hrfuser_tpu_torch.data.datasets.coco import CocoFusionDataset
from hrfuser_tpu_torch.data.loader import DetDataLoader
from hrfuser_tpu_torch.parallel import mesh
from tests.oracles import parallel_ranks
from tests.oracles.data_files import write_nuscenes
from tests.oracles.rank_path import stdlib_profile_path  # noqa: F401

DEADLINE_S = 240
SCALE = (96, 54)                     # (w, h): 100x176 -> 54x95, pad 64x96


def _cpu_group(rank, world):
    return mesh.Group(rank, world, torch.device('cpu'), 'gloo')


def test_two_ranks_collect_cut_and_join():
    ranks = mesh.run_ranks(parallel_ranks.mesh_rank, 2,
                           timeout_s=DEADLINE_S)
    x = np.arange(12.).reshape(6, 2)
    for rank, r in enumerate(ranks):
        # rank order, the whole list on every rank, ragged lists kept
        assert r['collected'] == ['0-0', '1-0', '1-1']
        np.testing.assert_array_equal(r['rows'], x[3 * rank:3 * rank + 3])
        np.testing.assert_array_equal(r['joined']['rows'], x)
        np.testing.assert_array_equal(r['joined']['pair'][0], x[[0, 3]])
        assert r['total'] == 3.0
        assert r['grad'] == 3.0


def test_world_of_one_is_a_group():
    (r,) = mesh.run_ranks(parallel_ranks.mesh_rank, 1, timeout_s=DEADLINE_S)
    assert r['collected'] == ['0-0']
    np.testing.assert_array_equal(r['joined']['rows'], r['rows'])
    assert r['total'] == 1.0 and r['grad'] == 1.0


@pytest.mark.parametrize('group', [None, _cpu_group(0, 1)])
def test_single_process_identity_as_jax(group):
    results = [dict(boxes=np.ones((2, 4)), meta={'id': i}) for i in range(3)]
    assert mesh.collect_results(results, group) is results
    assert jax_mesh.collect_results(results) is results
    x = np.arange(10.).reshape(5, 2)
    want = jax_mesh.local_rows(x)
    got = x if group is None else mesh.local_rows(x, group)
    np.testing.assert_array_equal(got, want)


def test_no_fallback_from_cuda_or_to_gloo(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        with mesh.process_group('cuda', rank=0, world_size=1,
                                address='tcp://127.0.0.1:1'):
            pass
    with pytest.raises(ValueError, match='nccl runs on CUDA'):
        with mesh.process_group('cpu', 'nccl', rank=0, world_size=1,
                                address='tcp://127.0.0.1:1'):
            pass


def test_shard_rows_cuts_every_key():
    rng = np.random.default_rng(0)
    batch = dict(img=rng.normal(size=(4, 2, 2, 3)),
                 mod_imgs=[rng.normal(size=(4, 2, 2, 3)) for _ in range(2)],
                 gt_valid=np.ones((4, 3), bool), metas=list('abcd'),
                 num_real=np.int32(3))
    parts = [mesh.shard_rows(batch, _cpu_group(r, 2)) for r in range(2)]
    np.testing.assert_array_equal(
        np.concatenate([p['img'] for p in parts]), batch['img'])
    for k in range(2):
        np.testing.assert_array_equal(
            np.concatenate([p['mod_imgs'][k] for p in parts]),
            batch['mod_imgs'][k])
    assert parts[0]['metas'] == ['a', 'b'] and parts[1]['metas'] == ['c', 'd']
    assert [int(p['num_real']) for p in parts] == [2, 1]
    with pytest.raises(ValueError, match='do not split'):
        mesh.shard_rows(batch, _cpu_group(0, 3))


@pytest.fixture(scope='module')
def folder(tmp_path_factory):
    data = get_experiment('tiny_fusion_test').data
    classes = data.classes[:4]
    root = write_nuscenes(tmp_path_factory.mktemp('nus'), 7, (100, 176),
                          (54, 95), classes, seed=3)
    import dataclasses
    return str(root), dataclasses.replace(data, img_scale=SCALE,
                                          classes=classes)


class _Counted(CocoFusionDataset):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.loaded = []

    def sample(self, idx):
        self.loaded.append(int(idx))
        return super().sample(idx)


def _loader(folder, train, rank=0, world=1):
    root, data = folder
    ds = _Counted('ann.json', data.classes, data_root=root, test_mode=not train)
    return ds, DetDataLoader(ds, data, 4, train=train, seed=5, device='cpu',
                             rank=rank, world_size=world)


KEYS = ('img', 'gt_boxes', 'gt_labels', 'gt_valid', 'img_shapes',
        'scale_factors')


def _rows(batch):
    """The dataset indices of a batch's real rows."""
    return [m['sample_idx'] for m in batch['metas'][:int(batch['num_real'])]]


def test_rank_loaders_join_to_the_one_process_batches(folder):
    _, one = _loader(folder, train=True)
    ranks = [_loader(folder, True, r, 2)[1] for r in range(2)]
    for epoch in range(2):
        want = list(one)
        got = [list(r) for r in ranks]
        assert len(want) == len(got[0]) == len(got[1]) == 1
        for w, parts in zip(want, zip(*got)):
            for k in KEYS:
                np.testing.assert_array_equal(
                    np.concatenate([p[k] for p in parts]), w[k], err_msg=k)
            for m in range(2):
                np.testing.assert_array_equal(
                    np.concatenate([p['mod_imgs'][m] for p in parts]),
                    w['mod_imgs'][m])
            assert sum((p['metas'] for p in parts), []) == w['metas']
            for r, p in enumerate(parts):    # shard_rows cuts the same rows
                cut = mesh.shard_rows(w, _cpu_group(r, 2))
                np.testing.assert_array_equal(cut['img'], p['img'])
    assert one.epoch == ranks[0].epoch == ranks[1].epoch == 2


def test_rank_loaders_read_only_their_own_samples(folder):
    _, one = _loader(folder, train=False)
    want = list(one)
    assert [int(b['num_real']) for b in want] == [4, 3]
    for rank, mine in ((0, [0, 1, 4, 5]), (1, [2, 3, 6])):
        ds, loader = _loader(folder, False, rank, 2)
        got = list(loader)
        assert len(loader) == len(got) == 2
        assert sorted(ds.loaded) == mine
        assert [i for b in got for i in _rows(b)] == mine
        for b, w in zip(got, want):
            real = int(b['num_real'])
            rows = [_rows(w).index(i) for i in _rows(b)]
            np.testing.assert_array_equal(b['img'][:real], w['img'][rows])
            assert len(b['img']) == 2         # padded with its own last row
            for i in range(real, 2):
                np.testing.assert_array_equal(b['img'][i], b['img'][real - 1])


def test_a_rank_without_rows_in_the_last_batch_skips_it(folder):
    root, data = folder
    ds = CocoFusionDataset('ann.json', data.classes, data_root=root,
                           test_mode=True)
    # 7 images, batch 6 over 3 ranks: the last batch holds image 6 only
    lens = [len(DetDataLoader(ds, data, 6, train=False, device='cpu',
                              rank=r, world_size=3)) for r in range(3)]
    assert lens == [2, 1, 1]
    with pytest.raises(ValueError):
        DetDataLoader(ds, data, 4, train=False, device='cpu', rank=0,
                      world_size=3)
