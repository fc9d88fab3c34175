"""Rank bodies of the data-parallel checks (torch and numpy only).

`parallel.mesh.run_ranks` starts each function here in a spawned
process, so they are importable by name: as `tests.oracles.parallel_ranks`
in the CPU tests, and by path (`tests/oracles` on `sys.path`) where
`tests.oracles` does not import (`chip_smoke.py`,
`tests/test_torch_cuda.py` on the card). Each takes `(rank, world_size,
address, ...)`, joins the group at `address` and returns numpy results.

`TRAIN_CAPS`: the caps of the tiny train checks (200 / 100 proposals,
32 RoIs a stage, as `tests/test_torch_train_slice.py`).
"""

import dataclasses
import os

import numpy as np
import torch

from hrfuser_tpu_torch.core.samplers import Draws
from hrfuser_tpu_torch.core.targets import RCNN_TRAIN_CFGS

PROPOSALS = dict(nms_pre=200, max_per_img=100, nms_iou=0.7,
                 min_bbox_size=0.0)
TRAIN_CAPS = dict(rpn_proposal_cfg=PROPOSALS,
                  rcnn_train_cfgs=tuple(dataclasses.replace(c, num=32)
                                        for c in RCNN_TRAIN_CFGS))


def joined_batch(b=4, hw=(64, 96), mod_channels=(3, 3), empty=(2, 3),
                 seed=11):
    """A joined train batch of `b` seeded N(0, 1) images and sensor
    streams with three boxes an image (its second-to-last one not valid
    on odd images), where the images `empty` have no valid GT at all (a
    rank whose images are all of them samples only negatives)."""
    rng = np.random.default_rng(seed)
    h, w = hw
    base = np.asarray([[10., 10., 40., 30.], [30., 20., 80., 60.],
                       [5., 30., 60., 62.]], np.float32)
    valid = np.ones((b, 3), bool)
    valid[1::2, 2] = False
    valid[list(empty)] = False
    batch = dict(
        img=rng.normal(0, 1, (b, h, w, 3)).astype(np.float32),
        gt_boxes=np.stack([base * (h / 64) + 3 * i for i in range(b)]),
        gt_labels=(np.arange(3 * b, dtype=np.int32).reshape(b, 3) * 7) % 4,
        gt_valid=valid)
    batch['mod_imgs'] = [rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
                         for c in mod_channels]
    return batch


def in_float64(batch):
    """`batch` with its float arrays in float64 (a float64 trunk)."""
    return {k: [m.astype(np.float64) for m in v] if k == 'mod_imgs'
            else v.astype(np.float64) if v.dtype == np.float32 else v
            for k, v in batch.items()}


class TableDraws(Draws):
    """Sampler keys from a table {(site, image): (positive, negative)}
    of numpy arrays, keyed by the image's index in the joined batch (a
    picklable replay of another run's draws)."""

    def __init__(self, table):
        super().__init__(torch.Generator().manual_seed(0))
        self.table = table

    def uniforms(self, site, image, n, device):
        pos, neg = self.table[(site, image)]
        assert len(pos) == n, (site, image, len(pos), n)
        return (torch.from_numpy(pos).to(device),
                torch.from_numpy(neg).to(device))


class RecordingDraws(Draws):
    """`inner`'s draws, each kept in `table` for a `TableDraws`."""

    def __init__(self, inner):
        super().__init__(inner.generator)
        self.inner, self.table = inner, {}

    def uniforms(self, site, image, n, device):
        pos, neg = self.inner.uniforms(site, image, n, device)
        self.table[(site, image)] = (pos.cpu().numpy().copy(),
                                     neg.cpu().numpy().copy())
        return pos, neg


def train_setup(name, seed, device, state_dict=None, warmup=False,
                f32_pool=False, dtype=torch.float32, drops=False,
                remat=False):
    """`name`'s model with drop path and `proj_drop` off (live with
    `drops`) and its `TrainState` on `device`: weights from `state_dict`
    (numpy) or drawn from `seed`; the full lr from the first step unless
    `warmup`; the one-hot RoI pool in float32 with `f32_pool` (as the JAX
    checks run it); `backbone.remat` with `remat`."""
    from hrfuser_tpu_torch.apis.inference import init_weights_
    from hrfuser_tpu_torch.apis.train import create_train_state
    from hrfuser_tpu_torch.configs import get_experiment
    from hrfuser_tpu_torch.configs.presets import without_drops
    from hrfuser_tpu_torch.models.detectors.cascade_rcnn import CascadeRCNN
    exp = get_experiment(name)
    model_cfg = exp.model if drops else without_drops(exp.model)
    if remat:
        model_cfg = dataclasses.replace(model_cfg, backbone=dataclasses.replace(
            model_cfg.backbone, remat=True))
    if f32_pool:
        model_cfg = dataclasses.replace(model_cfg, roi=dataclasses.replace(
            model_cfg.roi, gather_bf16=False))
    exp = dataclasses.replace(exp, model=model_cfg)
    sched = exp.schedule if warmup else dataclasses.replace(
        exp.schedule, warmup_iters=0, warmup_ratio=1.0)
    model = CascadeRCNN(exp.model)
    if state_dict is None:
        init_weights_(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                               for k, v in state_dict.items()})
    return create_train_state(model.to(device, dtype), exp.optim, sched,
                              100)


def bn_stats(model):
    return {n: b.detach().cpu().numpy().copy()
            for n, b in model.named_buffers()
            if n.endswith(('running_mean', 'running_var'))}


def step_result(state, losses):
    """Losses, the gradients the step applied, the params after it and
    the BN running statistics, as numpy."""
    model = state.model
    return dict(
        losses={k: float(v) for k, v in losses.items()},
        grads={n: p.grad.detach().cpu().numpy().copy()
               for n, p in model.named_parameters() if p.grad is not None},
        params={n: p.detach().cpu().numpy().copy()
                for n, p in model.named_parameters()},
        stats=bn_stats(model))


def _knock_out(what):
    """Switch one part of the sharded step off, to show the checks see
    it: 'sync_bn' (each rank's own BN statistics) or 'loss_factors'
    (each rank's own loss factors)."""
    import contextlib

    from hrfuser_tpu_torch.models.detectors import train_loss
    from hrfuser_tpu_torch.parallel import api
    if what == 'sync_bn':
        api.sync_batch_norm = lambda group: contextlib.nullcontext()
    elif what == 'loss_factors':
        train_loss._global_sums = lambda group, *v: [x.float() for x in v]
    elif what is not None:
        raise ValueError(what)


def sharded_train_rank(rank, world_size, address, name, batches, tables,
                       opts=None):
    """Sharded steps of `name`, one a batch of `batches` (joined batches,
    dicts of numpy arrays), each rank on its rows, with the draws of
    `tables` (one a step, keyed by the joined batch's image). `opts`:
    `device` ('cpu'), `backend`, `state_dict` (numpy weights; else drawn
    from seed 0), `knock_out`, `threads` (1), `f32_pool`, `caps`
    (`TRAIN_CAPS`; {} for the reference's), `dtype`. Returns the last step's `step_result`,
    each step's losses and ms (host clock, the card synchronised), the
    gradient all-reduce's ms and buffer size, and the eval kernels'
    launches (a train step launches none)."""
    import time

    from hrfuser_tpu_torch.ops import chain, roi_align
    from hrfuser_tpu_torch.parallel import api
    from hrfuser_tpu_torch.parallel.mesh import process_group, shard_rows
    opts = dict(opts or {})
    torch.set_num_threads(opts.get('threads', 1))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _knock_out(opts.get('knock_out'))
    reduce_ms, buffer_mb, real_sum = [], [], api.sum_gradients

    def timed_sum(params, group):
        sync()
        t0 = time.perf_counter()
        flat = real_sum(params, group)
        sync()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
        buffer_mb.append(flat.numel() * flat.element_size() / 2**20)
        return flat

    api.sum_gradients = timed_sum
    with process_group(opts.get('device', 'cpu'), opts.get('backend'), rank,
                       world_size, address=address) as group:
        state = train_setup(name, 0, group.device, opts.get('state_dict'),
                            f32_pool=opts.get('f32_pool', False),
                            dtype=opts.get('dtype', torch.float32))
        step = api.make_sharded_train_step(state, group, 0,
                                           **opts.get('caps', TRAIN_CAPS))
        history, ms = [], []
        for b, table in zip(batches, tables):
            sync()
            t0 = time.perf_counter()
            losses = step(shard_rows(b, group), TableDraws(table))
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            history.append({k: float(v) for k, v in losses.items()})
        kernels = (chain.window_self_attention, chain.window_cross_attention,
                   chain.cross_ffn, roi_align.multilevel_roi_align)
        return dict(step_result(state, losses), history=history, ms=ms,
                    reduce_ms=reduce_ms, buffer_mb=buffer_mb[-1],
                    launches=sum(fn.launches for fn in kernels),
                    rank=group.rank)


def remat_pair_rank(rank, world_size, address, name, batch):
    """One sharded step of `name` (drop path and `proj_drop` live) without
    and with `backbone.remat`, from the same weights, batch and seeds:
    {remat: `step_result` and the set of BN `num_batches_tracked`}."""
    from hrfuser_tpu_torch.parallel import api
    from hrfuser_tpu_torch.parallel.mesh import process_group, shard_rows
    torch.set_num_threads(1)
    out = {}
    with process_group('cpu', None, rank, world_size,
                       address=address) as group:
        for remat in (False, True):
            state = train_setup(name, 0, group.device, drops=True,
                                remat=remat)
            step = api.make_sharded_train_step(state, group, 0, **TRAIN_CAPS)
            losses = step(shard_rows(batch, group))
            out[remat] = dict(step_result(state, losses), tracked={
                int(b) for n, b in state.model.named_buffers()
                if n.endswith('num_batches_tracked')})
    return out


def mismatch(got, want, floor_share=1e-3):
    """A step's figures against another run's: the worst loss (relative;
    accuracies apart, absolute), all gradients together and the worst one
    (relative L2, norms floored at `floor_share` of the largest), the BN
    running statistics (relative to 1 + |max|) and the params (beyond
    1e-6 of their size)."""
    lw, lg = want['losses'], got['losses']
    losses = max(abs(lg[k] - v) / max(abs(v), 1e-6) for k, v in lw.items()
                 if not k.endswith('acc'))
    acc = max(abs(lg[k] - v) for k, v in lw.items() if k.endswith('acc'))
    gw, gg = want['grads'], got['grads']
    if set(gg) != set(gw):
        raise AssertionError('the runs differ in which params get grads')
    together = float(np.sqrt(sum(((gg[n] - gw[n]) ** 2).sum() for n in gw)
                             / sum((gw[n] ** 2).sum() for n in gw)))
    floor = floor_share * max(np.linalg.norm(g) for g in gw.values())
    worst, each = max((np.linalg.norm(gg[n] - gw[n])
                       / max(np.linalg.norm(gw[n]), floor), n) for n in gw)
    stats = max(np.abs(got['stats'][n] - v).max() / (1 + np.abs(v).max())
                for n, v in want['stats'].items())
    params = max((np.abs(got['params'][n] - v) - 1e-6 * np.abs(v)).max()
                 for n, v in want['params'].items())
    return dict(losses=float(losses), acc=float(acc), together=together,
                each=float(worst), each_name=each, stats=float(stats),
                params=float(params))


class PermutedDraws(Draws):
    """`table`'s draws for a batch whose row j is image `perm[j]` of the
    batch the table was drawn for."""

    def __init__(self, table, perm):
        super().__init__(torch.Generator().manual_seed(0))
        self.draws, self.perm = TableDraws(table), perm

    def uniforms(self, site, image, n, device):
        return self.draws.uniforms(site, int(self.perm[image]), n, device)


def permuted(batch, perm):
    return {k: [m[perm] for m in v] if k == 'mod_imgs' else v[perm]
            for k, v in batch.items()}


def sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def sharded_eval_rank(rank, world_size, address, config, root, batch_size,
                      device='cpu', backend=None, dtype='f32',
                      checkpoint=None, data_patch=None, threads=1,
                      counters=None, warmup=False):
    """`run_inference` over the nuScenes val split at `root` on this
    rank's rows (global batch `batch_size`), after an untimed run when
    `warmup`. Returns the collected results, the dataset indices this
    rank loaded, its batches, the seconds of the run, and the launch
    counts of the `counters` wrappers ({name: 'module:attr'}) in it."""
    import importlib
    import time

    from hrfuser_tpu_torch.apis.inference import init_detector
    from hrfuser_tpu_torch.apis.test import run_inference
    from hrfuser_tpu_torch.configs import get_experiment
    from hrfuser_tpu_torch.data.datasets.coco import CocoFusionDataset
    from hrfuser_tpu_torch.data.loader import DetDataLoader
    from hrfuser_tpu_torch.parallel.mesh import process_group
    torch.set_num_threads(threads)
    dtypes = {'f32': torch.float32, 'bf16': torch.bfloat16}
    with process_group(device, backend, rank, world_size,
                       address=address) as group:
        data = get_experiment(config).data
        if data_patch:
            data = dataclasses.replace(data, **data_patch)
        ds = CocoFusionDataset('nuscenes_infos_val_mono3d.coco.json',
                               data.classes, data_root=root, test_mode=True)
        loaded, sample = [], ds.sample

        def counted(idx):
            loaded.append(int(idx))
            return sample(idx)

        ds.sample = counted
        loader = DetDataLoader(ds, data, batch_size, train=False,
                               device=group.device, rank=group.rank,
                               world_size=world_size)
        det = init_detector(config, group.device, seed=0,
                            dtype=dtypes[dtype], checkpoint=checkpoint)
        det.data = data
        wrappers = {k: _attr(importlib, v) for k, v in (counters or {}
                                                       ).items()}
        if warmup:
            run_inference(det, loader, progress=False, group=group)
            loaded.clear()
        for fn in wrappers.values():
            fn.launches = 0
        sync()
        t0 = time.perf_counter()
        results = run_inference(det, loader, progress=False, group=group)
        sync()
        seconds = time.perf_counter() - t0
        return dict(results=results, loaded=loaded, batches=len(loader), seconds=seconds,
                    launches={k: fn.launches for k, fn in wrappers.items()})


def _attr(importlib, spec):
    module, name = spec.split(':')
    obj = importlib.import_module(module)
    for part in name.split('.'):
        obj = getattr(obj, part)
    return obj


def cli_rank(rank, world_size, address, tool, argv, small_scale=None,
             threads=1):
    """`hrfuser_tpu_torch.tools.<tool>.main(argv)` as `torchrun` would
    start rank `rank` (its environment; the store at `address` hosted
    by the launcher), with the configs' `img_scale` cut to
    `small_scale` and their classes to 4 when given. Returns what
    `main` returns and the files this rank opened to write."""
    import builtins
    import importlib

    import hrfuser_tpu_torch.apis.inference as inference
    import hrfuser_tpu_torch.configs as configs
    torch.set_num_threads(threads)
    host, port = address.rsplit('//', 1)[-1].rsplit(':', 1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size),
                      LOCAL_RANK=str(rank), MASTER_ADDR=host,
                      MASTER_PORT=port, TORCHELASTIC_USE_AGENT_STORE='True')
    if small_scale is not None:
        real = configs.get_experiment

        def get_experiment(name):
            exp = real(name)
            return dataclasses.replace(exp, data=dataclasses.replace(
                exp.data, img_scale=tuple(small_scale),
                classes=exp.data.classes[:4]))

        configs.get_experiment = inference.get_experiment = get_experiment
    written, real_open = [], builtins.open

    def recording_open(file, mode='r', *a, **k):
        if any(c in mode for c in 'wax+'):
            written.append(os.path.abspath(file))
        return real_open(file, mode, *a, **k)

    builtins.open = recording_open
    try:
        out = importlib.import_module(
            f'hrfuser_tpu_torch.tools.{tool}').main(argv)
    finally:
        builtins.open = real_open
    return out, written


def one_process_step(name, batch, draws, device='cpu', state_dict=None,
                     caps=TRAIN_CAPS, dtype=torch.float32):
    """`train_step` of `name` on the whole `batch` in this process, with
    the sharded step's weights and caps: its `step_result`."""
    from hrfuser_tpu_torch.apis.train import train_step
    state = train_setup(name, 0, device, state_dict, dtype=dtype)
    losses = train_step(state, batch, draws=draws, **caps)
    return step_result(state, losses)


def mesh_rank(rank, world_size, address):
    """The mesh helpers on a CPU group: ragged per-rank lists collected,
    rows cut and joined, a sum and a differentiable sum over the ranks
    (`loss = (rank + 1) * sum(t)`: every rank's `t` gets the gradient
    1 + 2 + ... + world_size)."""
    from hrfuser_tpu_torch.parallel.mesh import (all_reduce_sum,
                                                 collect_results, gather,
                                                 local_rows, process_group,
                                                 sum_over_ranks)
    with process_group('cpu', None, rank, world_size,
                       address=address) as group:
        collected = collect_results([f'{rank}-{i}' for i in range(rank + 1)],
                                    group)
        rows = local_rows(torch.arange(12.).reshape(6, 2), group)
        joined = gather({'rows': rows, 'pair': (rows[:1], rows[1:])}, group)
        total = sum_over_ranks(torch.tensor([rank + 1.]), group)
        t = torch.tensor([1.0], requires_grad=True)
        (all_reduce_sum(t) * (rank + 1)).sum().backward()
        return dict(collected=collected, rows=rows.numpy(), joined=joined,
                    total=float(total), grad=float(t.grad))


def join_rank(rank, world_size, address, device, backend=None):
    """Join the group and report (rank, device, backend)."""
    from hrfuser_tpu_torch.parallel.mesh import process_group
    with process_group(device, backend, rank, world_size,
                       address=address) as group:
        return group.rank, str(group.device), group.backend


def paired_train_rank(rank, world_size, address, name, steps, opts=None):
    """`steps` steps of `make_sharded_train_step` in a world of one rank,
    each beside `train_step` from the same weights and optimizer state
    (copied over before every step) on the same synthetic batch
    (`tools.train.synthetic_batches`, the config's batch, a pool of 4)
    and the same draws (`KeyedDraws(step)`). `opts` as
    `sharded_train_rank`'s, and `deterministic` (cuDNN's deterministic
    algorithms). Returns each step's losses of both, ms of
    both, the params' and BN statistics' largest difference after it
    (params beyond 1e-6 of their size), the gradient all-reduce's ms and
    buffer size, and the eval kernels' launches."""
    import copy
    import time

    from hrfuser_tpu_torch.apis.train import train_step
    from hrfuser_tpu_torch.configs import get_experiment
    from hrfuser_tpu_torch.core.samplers import KeyedDraws
    from hrfuser_tpu_torch.ops import chain, roi_align
    from hrfuser_tpu_torch.parallel import api
    from hrfuser_tpu_torch.parallel.mesh import process_group
    from hrfuser_tpu_torch.tools.train import synthetic_batches
    opts = dict(opts or {})
    torch.set_num_threads(opts.get('threads', 1))
    torch.backends.cudnn.deterministic = opts.get('deterministic', False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    exp = get_experiment(name)
    batches = synthetic_batches(exp, exp.schedule.samples_per_device, pool=4)
    caps = opts.get('caps', TRAIN_CAPS)
    out = dict(plain=[], sharded=[], plain_ms=[], sharded_ms=[], params=[],
               stats=[], reduce_ms=[])
    real_sum = api.sum_gradients

    def timed_sum(params, group):
        sync()
        t0 = time.perf_counter()
        flat = real_sum(params, group)
        sync()
        out['reduce_ms'].append((time.perf_counter() - t0) * 1e3)
        out['buffer_mb'] = flat.numel() * flat.element_size() / 2**20
        return flat

    api.sum_gradients = timed_sum
    with process_group(opts.get('device', 'cpu'), opts.get('backend'), rank,
                       world_size, address=address) as group:
        sharded = train_setup(name, 0, group.device)
        plain = train_setup(name, 0, group.device)
        step = api.make_sharded_train_step(sharded, group, 0, **caps)
        for i in range(steps):
            plain.model.load_state_dict(sharded.model.state_dict())
            plain.optimizer.load_state_dict(      # its own moments
                copy.deepcopy(sharded.optimizer.state_dict()))
            plain.load_counters(sharded.counters())
            batch = next(batches)
            for label, run in (
                    ('plain', lambda: train_step(plain, batch,
                                                 draws=KeyedDraws(i), **caps)),
                    ('sharded', lambda: step(batch, KeyedDraws(i)))):
                sync()
                t0 = time.perf_counter()
                losses = run()
                sync()
                out[f'{label}_ms'].append((time.perf_counter() - t0) * 1e3)
                out[label].append({k: float(v) for k, v in losses.items()})
            a, b = ({n: p.detach() for n, p in s.model.named_parameters()}
                    for s in (sharded, plain))
            out['params'].append(max(float(((a[n] - b[n]).abs()
                                            - 1e-6 * b[n].abs()).max())
                                     for n in b))
            a, b = (bn_stats(s.model) for s in (sharded, plain))
            out['stats'].append(max(float(np.abs(a[n] - b[n]).max()
                                          / (1 + np.abs(b[n]).max()))
                                    for n in b))
        kernels = (chain.window_self_attention, chain.window_cross_attention,
                   chain.cross_ffn, roi_align.multilevel_roi_align)
        out['launches'] = sum(fn.launches for fn in kernels)
        out['lr'] = sharded.schedule(0)
        return out
