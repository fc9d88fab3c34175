"""Process groups, row sharding and cross-rank collection.

Counterpart of `hrfuser_tpu/parallel/mesh.py`. JAX runs one program over
a mesh of devices, and XLA inserts the collectives. The port runs one
process per rank on `torch.distributed` and calls the collectives
itself. A `Group` is a rank's handle on its data-parallel group: its
rank, the world size, its device and the backend (`nccl` on the card,
`gloo` on the CPU, or `gloo` on the card when asked). A world of one
rank is a valid group.

Nothing falls back. An `nccl` init that fails raises and does not switch
to `gloo`; a rank asked for CUDA where there is none raises and does not
move to the CPU; two ranks mapped to one GPU under `nccl` raise (NCCL
refuses a duplicate GPU).

`shard_rows` / `local_rows` cut a global batch into a rank's rows (the
counterpart of `shard_batch` and `host_local_to_global`), `gather`
joins the ranks' rows again on every rank, and `collect_results`
all-gathers picklable per-rank lists in rank order, so every rank ends
with the whole list (`mesh.py:82-111` in JAX). `run_ranks` starts ranks
as spawned processes, each with a deadline.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class Group:
    """One rank's view of a data-parallel group. `objects` is a `gloo`
    group for the pickled-object collectives when the main group runs on
    `nccl` (None: the main group serves)."""
    rank: int
    world_size: int
    device: torch.device
    backend: str
    objects: Optional[Any] = None


def launched_with_ranks() -> bool:
    """Whether the environment names this process's rank (`torchrun`)."""
    return 'RANK' in os.environ and 'WORLD_SIZE' in os.environ


def _device(device, local_rank: int) -> torch.device:
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(f'rank on {device}: no CUDA device is '
                               f'available; ask for the CPU explicitly')
        if device.index is None:
            device = torch.device('cuda', local_rank)
    return device


def _gpu_identity(device: torch.device) -> str:
    props = torch.cuda.get_device_properties(device)
    return f'{socket.gethostname()}/{getattr(props, "uuid", device.index)}'


def _refuse_shared_gpus(group: Group) -> None:
    """Raise if two ranks of an `nccl` group sit on one GPU."""
    ids: List[Optional[str]] = [None] * group.world_size
    dist.all_gather_object(ids, _gpu_identity(group.device),
                           group=group.objects)
    for r, gpu in enumerate(ids):
        first = ids.index(gpu)
        if first != r:
            raise RuntimeError(
                f'ranks {first} and {r} are both on GPU {gpu}: NCCL refuses '
                f'a duplicate GPU. Give each rank its own card (one '
                f'LOCAL_RANK per GPU), or ask for the gloo backend')


@contextlib.contextmanager
def process_group(device=None, backend: Optional[str] = None,
                  rank: Optional[int] = None,
                  world_size: Optional[int] = None,
                  address: Optional[str] = None,
                  timeout_s: float = DEFAULT_TIMEOUT_S) -> Iterator[Group]:
    """Join a group for the body of the `with`, then leave it.

    Without `rank`, the group comes from the `torchrun` environment
    (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR` / `MASTER_PORT`).
    Otherwise `rank`, `world_size` and `address` ('tcp://host:port' of
    a store the launcher hosts, as `torchrun`'s agent does) name it, on
    one host (the local rank is the rank). The rank's device is
    `cuda:LOCAL_RANK` unless `device` says otherwise ('cpu', or
    'cuda:k'); the backend is `nccl` for CUDA and
    `gloo` for the CPU unless `backend` asks for `gloo`.
    `timeout_s` bounds the rendezvous and every collective.
    """
    timeout = datetime.timedelta(seconds=timeout_s)
    if rank is None:
        rank = int(os.environ['RANK'])
        world_size = int(os.environ['WORLD_SIZE'])
        local_rank = int(os.environ.get('LOCAL_RANK', rank))
    elif world_size is None or address is None:
        raise ValueError('an explicit rank needs world_size and address')
    else:
        local_rank = rank
    device = _device(device, local_rank)
    backend = backend or ('nccl' if device.type == 'cuda' else 'gloo')
    if backend == 'nccl' and device.type != 'cuda':
        raise ValueError(f'nccl runs on CUDA devices, not {device}')
    if backend not in ('nccl', 'gloo'):
        raise ValueError(f'unknown backend {backend!r}')
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    if address is None:
        kw = dict(init_method='env://')
    else:
        host, port = address.rsplit('//', 1)[-1].rsplit(':', 1)
        kw = dict(store=dist.TCPStore(host, int(port), world_size,
                                      is_master=False, timeout=timeout))
    dist.init_process_group(backend, rank=rank, world_size=world_size,
                            timeout=timeout, **kw)
    try:
        objects = (dist.new_group(backend='gloo', timeout=timeout)
                   if backend == 'nccl' and world_size > 1 else None)
        group = Group(rank, world_size, device, backend, objects)
        if objects is not None:
            _refuse_shared_gpus(group)
        yield group
    finally:
        dist.destroy_process_group()


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose backward sums the gradients over the
    ranks too, so a value computed from the global sum sends its
    gradient to every rank's inputs."""

    @staticmethod
    def forward(ctx, tensor):
        out = tensor.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad)


def all_reduce_sum(tensor: torch.Tensor) -> torch.Tensor:
    """The sum of `tensor` over the ranks, differentiable."""
    return _AllReduceSum.apply(tensor)


def sum_over_ranks(tensor: torch.Tensor, group: Optional[Group]
                   ) -> torch.Tensor:
    """The sum of `tensor` over the ranks (no gradient; `tensor` as is
    without a group or in a world of one)."""
    if group is None or group.world_size == 1:
        return tensor
    out = tensor.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out)
    return out


def _rows_of(n: int, group: Group) -> slice:
    if n % group.world_size:
        raise ValueError(f'{n} rows do not split over {group.world_size} '
                         f'ranks')
    k = n // group.world_size
    return slice(group.rank * k, (group.rank + 1) * k)


def local_rows(x, group: Group):
    """This rank's rows of a global batch-major array, tensor or list:
    rank r of N holds rows [r * n / N, (r + 1) * n / N)."""
    return x[_rows_of(len(x), group)]


def shard_rows(batch: dict, group: Group) -> dict:
    """This rank's rows of a global batch dict (`mod_imgs` a list of
    arrays; `num_real`, the leading real rows, becomes this rank's
    count)."""
    rows = _rows_of(len(batch['img']), group)
    out = {}
    for k, v in batch.items():
        if k == 'num_real':
            out[k] = np.asarray(np.clip(int(v) - rows.start, 0,
                                        rows.stop - rows.start), np.int32)
        elif k == 'mod_imgs' and v is not None:
            out[k] = [m[rows] for m in v]
        else:
            out[k] = v[rows]
    return out


def gather(tree, group: Optional[Group]):
    """Every rank's rows of each tensor leaf of `tree` (a tensor, or a
    tuple, list or dict of them; same shapes on every rank) joined in
    rank order, on every rank, as host numpy arrays."""
    def one(t):
        if group is not None and group.world_size > 1:
            t = t.contiguous()
            parts = [torch.empty_like(t) for _ in range(group.world_size)]
            dist.all_gather(parts, t)
            t = torch.cat(parts)
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    if torch.is_tensor(tree):
        return one(tree)
    if isinstance(tree, dict):
        return {k: gather(v, group) for k, v in tree.items()}
    items = [gather(v, group) for v in tree]
    return type(tree)(*items) if hasattr(tree, '_fields') else \
        type(tree)(items)


def collect_results(results: list, group: Optional[Group]) -> list:
    """Every rank's picklable `results` list joined in rank order, on
    every rank (identity without a group or in a world of one)."""
    if group is None or group.world_size == 1:
        return results
    lists: List[Optional[list]] = [None] * group.world_size
    dist.all_gather_object(lists, results, group=group.objects)
    return [r for part in lists for r in part]


def free_store(world_size: int, timeout_s: float = DEFAULT_TIMEOUT_S):
    """A rendezvous store on a free local port (the OS picks it, so
    concurrent launchers never collide) and its address."""
    store = dist.TCPStore('127.0.0.1', 0, world_size, is_master=True,
                          wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=timeout_s))
    return store, f'tcp://127.0.0.1:{store.port}'


def _child(fn, rank, world_size, address, args, results):
    try:
        results.put((rank, True, fn(rank, world_size, address, *args)))
    except BaseException:                       # reported to the parent
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world_size: int, args: Sequence = (),
              timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """`fn(rank, world_size, address, *args)` in `world_size` spawned
    processes; their picklable results in rank order.

    `address` names a store this process hosts (pass it to
    `process_group`). `fn` must be importable by name. A rank that
    raises, dies or outlives
    `timeout_s` ends every rank and raises here with its traceback.
    """
    import torch.multiprocessing as mp
    ctx = mp.get_context('spawn')
    store, address = free_store(world_size, timeout_s)
    results = ctx.Queue()
    procs = [ctx.Process(target=_child, daemon=True,
                         args=(fn, r, world_size, address, tuple(args),
                               results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout_s
    try:
        while len(out) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f'ranks {sorted(set(range(world_size)) - set(out))} '
                                   f'did not finish within {timeout_s:.0f} s')
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    time.sleep(0.5)             # a last result in flight
                    if results.empty():
                        raise RuntimeError(
                            f'rank {dead[0]} exited with code '
                            f'{procs[dead[0]].exitcode} and no result')
                continue
            if not ok:
                raise RuntimeError(f'rank {rank} failed:\n{value}')
            out[rank] = value
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
        del store
    return [out[r] for r in range(world_size)]
