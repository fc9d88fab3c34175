"""Measure kernel C and the detectors on one NVIDIA GPU, against another
checkout of the repository, in turns (other, this tree, this tree, other).

    python3 chip_profile.py [--parent DIR [DIR ...]] [--unchecked]
                            [--configs T,B,H] [--offline] [--out FILE]

Each DIR holds another checkout, e.g. the parent commit unpacked from
`git archive` into `build/parent`, or a copy of this tree with one change
to a kernel. With DIRs A and B the turns run A, B, this tree, this tree,
B, A. With --unchecked, the other trees' kernel C results are not held to
the twin (their errors are still recorded): for knock-out copies that
skip loads or stores on purpose. Each turn is a process of its own that
imports `hrfuser_tpu_torch` from its tree, so each tree builds and loads
its own kernels into its own `build/`. The inputs, timers and bounds are
this tree's (`chip_smoke.py`). Measured, bf16:

- `roi`: kernel C (`multilevel_roi_align`) at r640, C = 256, 8 x 1000
  RoIs: `chip_smoke.py` phase 3's batch (float32 too) and two skewed ones
  (every RoI on level 0, every RoI on level 3). Per batch: the median of
  3 CUDA-event timings of 30 calls, the device time per call under
  `torch.profiler`, the max error against the plain twin (fails beyond
  atol = rtol = 0.05, 1e-3 in float32), the bytes moved and the bound;
  and kernel C's registers a thread, as `ptxas -v` gives them when the
  turn builds its tree's kernels.
- `model`: per config, the latency per batch of 8 at 384x640 (median of
  7 calls after 2 warm-ups) and, under `torch.profiler` over 2 calls,
  wall and device busy time per call, idle share, kernel C's device time
  per call and the kernels with the most device time.
- `offline` (with --offline, in place of the two above): one nuScenes
  sample through the tree's `tools/create_data.convert_sample` on the
  card (phase 11a's seeded sample): ms per sample (median of 7 after 2
  warm-ups) with and without its 24 PNGs, the calls that wait for the
  card (`torch.cuda.set_sync_debug_mode`), and under `torch.profiler`
  one call's wall and device busy time, idle share, kernel count and
  the kernels with the most device time.

Without --parent only this tree is measured. Prints each turn as a JSON
line, then a summary; writes all turns to FILE (default
`chiprun_out/chip_profile.json`). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
CONFIGS = {'T': 'cascade_rcnn_hrfuser_t_1x_nus_r640_l_r_fusion',
           'B': 'cascade_rcnn_hrfuser_b_1x_nus_r640_l_r_fusion',
           'H': 'cascade_rcnn_hrfuser_hrnet_w18_1x_nus_r640_l_r_fusion'}
STRIDES = (4, 8, 16, 32)


def _smoke():
    """This tree's `chip_smoke.py`, loaded by path (never another tree's)."""
    spec = importlib.util.spec_from_file_location('smoke',
                                                  HERE / 'chip_smoke.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ptxas(log):
    """`ptxas -v` lines of the kernel C entries in an nvcc log."""
    out, entry = [], None
    for line in log.splitlines():
        if 'Compiling entry function' in line:
            entry = line.split("'")[1] if "'" in line else line
        elif entry and 'roi_align' in entry and 'registers' in line:
            out.append(f'{entry}: {line.split(":", 1)[1].strip()}')
    return out


def _roi(smoke, checked=True):
    from hrfuser_tpu_torch.ops import roi_align
    from hrfuser_tpu_torch.utils import cuda_build
    ptxas = _ptxas(cuda_build.build().log)
    g = torch.Generator().manual_seed(4)
    feats32, mixed = smoke._roi_inputs(g)
    bf = [f.to(torch.bfloat16).contiguous() for f in feats32]
    cases = {'mixed bf16': (bf, mixed),
             'level 0 bf16': (bf, smoke._skewed_rois(g, 0)),
             'level 3 bf16': (bf, smoke._skewed_rois(g, 3)),
             'mixed f32': (feats32, mixed)}
    out = {}
    for name, (feats, rois) in cases.items():
        def fk():
            return roi_align.multilevel_roi_align(feats, rois, STRIDES)

        got = fk()
        want = roi_align.multilevel_roi_align_plain(feats, rois, STRIDES)
        tol = smoke.TOL[feats[0].dtype]
        err = (got.float() - want.float()).abs().max().item()
        if checked and not torch.allclose(got.float(), want.float(),
                                          atol=tol, rtol=tol):
            raise AssertionError(f'kernel C {name}: max_abs_err {err}')
        times = sorted(smoke._time_ms(fk, iters=30) for _ in range(3))
        flops, nbytes, peak_dt, pixels = smoke._roi_work(feats, rois, got)
        bound_ms, bound_by = smoke._bound(flops, nbytes, peak_dt)
        out[name] = dict(ms=times[1], ms_runs=times,
                         device_ms=smoke._device_ms(fk, 'roi_align_kernel',
                                                    iters=30),
                         max_abs_err=err, mbytes=nbytes / 1e6, pixels=pixels,
                         bound_ms=bound_ms, bound_by=bound_by)
    return dict(cases=out, ptxas=ptxas)


def _model(smoke, config):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from hrfuser_tpu_torch import init_detector
    det = init_detector(config, 'cuda', seed=0, dtype=torch.bfloat16)
    img, mods = smoke._inputs(det.cfg, smoke.BATCH, np.random.default_rng(0))
    for _ in range(2):
        det(img, mods)
    torch.cuda.synchronize()
    times = []
    for _ in range(7):
        t0 = time.perf_counter()
        det(img, mods)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    calls = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            det(img, mods)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    ms, count = defaultdict(float), defaultdict(int)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms[e.name] += e.time_range.elapsed_us() / 1e3 / calls
            count[e.name] += 1
    busy = sum(ms.values())
    top = sorted(ms, key=ms.get, reverse=True)[:12]
    return dict(config=config, latency_ms=sorted(times)[len(times) // 2],
                latency_runs=times, wall_ms=wall, busy_ms=busy,
                idle=1 - busy / wall,
                kernels_per_call=sum(count.values()) / calls,
                roi_align_ms=sum(v for k, v in ms.items()
                                 if 'roi_align_kernel' in k),
                top=[(k[:90], ms[k], count[k] / calls) for k in top])


def _offline(smoke):
    """One nuScenes sample (`chip_smoke.py` phase 11a's) through the
    tree's `convert_sample` on the card, reference mode."""
    import tempfile
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from hrfuser_tpu_torch.tools.create_data import convert_sample
    db, lidar, radars = smoke._oracle('offline_data').nuscenes_sample(seed=0)

    def run(out_dir=None):
        convert_sample(db, db.sample, lidar, radars, out_dir, 'cuda')

    for _ in range(2):
        run()
    ms = smoke._host_ms(run, runs=7)
    with tempfile.TemporaryDirectory() as root:
        png_ms = smoke._host_ms(lambda: run(root), runs=7)
    syncs = smoke._sync_count(run)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name, count = defaultdict(float), defaultdict(int)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us() / 1e3
            count[e.name] += 1
    busy = sum(by_name.values())
    top = sorted(by_name, key=by_name.get, reverse=True)[:6]
    return dict(ms=ms[0], ms_range=ms[1:], png_ms=png_ms[0], syncs=syncs,
                wall_ms=wall, busy_ms=busy, idle=1 - busy / wall,
                kernels_per_call=sum(count.values()),
                top=[(k[:90], by_name[k], count[k]) for k in top])


def _worker(root, what, config, checked):
    sys.path.insert(0, str(root))
    import hrfuser_tpu_torch
    pkg = Path(hrfuser_tpu_torch.__file__).resolve()
    if Path(root).resolve() not in pkg.parents:
        raise RuntimeError(f'imported {pkg}, not the package of {root}')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke = _smoke()
    res = (_roi(smoke, checked) if what == 'roi'
           else _offline(smoke) if what == 'offline'
           else _model(smoke, config))
    print('RESULT ' + json.dumps(dict(root=str(root), what=what, **res)))


def _turn(root, what, config=None, checked=True):
    cmd = [sys.executable, str(Path(__file__).resolve()), '--worker-root',
           str(root), '--what', what] + (['--config', config] if config
                                          else [])
    cmd += [] if checked else ['--unchecked']
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith('RESULT ')]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f'{what} {config or ""} in {root} failed '
                           f'({proc.returncode}):\n{proc.stderr[-4000:]}')
    res = json.loads(lines[-1][len('RESULT '):])
    res['seconds'] = time.perf_counter() - t0
    print(json.dumps(res), flush=True)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--parent', type=Path, nargs='+', default=[],
                    help='other checkouts, each timed against this tree')
    ap.add_argument('--unchecked', action='store_true',
                    help='do not hold the other trees\' kernel C to its twin')
    ap.add_argument('--configs', default='T,B',
                    help='detectors to profile: T, B, H (comma separated)')
    ap.add_argument('--offline', action='store_true',
                    help='measure only the offline nuScenes conversion')
    ap.add_argument('--out', type=Path,
                    default=HERE / 'chiprun_out' / 'chip_profile.json')
    ap.add_argument('--worker-root', type=Path, help=argparse.SUPPRESS)
    ap.add_argument('--what', help=argparse.SUPPRESS)
    ap.add_argument('--config', help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker_root is not None:
        _worker(args.worker_root, args.what, args.config,
                not args.unchecked)
        return
    others = [p.resolve() for p in args.parent]
    if not torch.cuda.is_available():
        print('no CUDA device: this measurement needs an NVIDIA GPU',
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    roots = [*others, HERE, HERE, *others[::-1]] if others else [HERE]
    tag = {HERE: 'this tree', **{p: p.name for p in others}}
    if args.offline:
        runs = [_turn(r, 'offline') for r in roots]
        print(f'== one nuScenes sample, reference mode ({smi})')
        for r in runs:
            print(f'  {tag[Path(r["root"])]}: {r["ms"]:.1f} ms (min '
                  f'{r["ms_range"][0]:.1f}, max {r["ms_range"][1]:.1f}), '
                  f'{r["png_ms"]:.1f} with PNGs; {r["syncs"]} synchronising '
                  f'calls; profiled wall {r["wall_ms"]:.1f}, busy '
                  f'{r["busy_ms"]:.2f}, idle {r["idle"]:.1%}, '
                  f'{r["kernels_per_call"]} kernels')
            for name, ms, n in r['top']:
                print(f'    {ms:.3f} ms in {n} x {name}')
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(device=smi, runs=runs),
                                       indent=1))
        print(f'wrote {args.out}')
        return
    runs = [_turn(r, 'roi', checked=r == HERE or not args.unchecked)
            for r in roots]
    configs = [CONFIGS[c] for c in args.configs.split(',') if c]
    runs += [_turn(r, 'model', c) for c in configs for r in roots]

    print(f'== kernel C, ms ({smi}); turns in order')
    for case in runs[0]['cases']:
        cells = []
        for r in runs[:len(roots)]:
            v = r['cases'][case]
            dev = ('not measured' if v['device_ms'] is None
                   else f'{v["device_ms"]:.4f}')
            cells.append(f'{tag[Path(r["root"])]} {v["ms"]:.4f} '
                         f'(profiler {dev})')
        v = runs[0]['cases'][case]
        print(f'  {case}: ' + '; '.join(cells) + f'; bound '
              f'{v["bound_ms"]:.4f} ({v["bound_by"]}, {v["mbytes"]:.1f} MB)')
    for r in runs[:len(roots)]:
        for line in r['ptxas']:
            print(f'  {tag[Path(r["root"])]} {line}')
    print('== detectors, bf16 batch of 8, ms per call')
    for r in runs[len(roots):]:
        print(f'  {r["config"]} {tag[Path(r["root"])]}: latency '
              f'{r["latency_ms"]:.2f}, profiled wall {r["wall_ms"]:.2f}, '
              f'busy {r["busy_ms"]:.2f}, idle {r["idle"]:.1%}, kernel C '
              f'{r["roi_align_ms"]:.3f}, {r["kernels_per_call"]:.0f} '
              f'kernels a call')
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(device=smi, runs=runs), indent=1))
    print(f'wrote {args.out}')


if __name__ == '__main__':
    main()
