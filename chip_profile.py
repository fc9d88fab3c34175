"""Measure kernel C and the detectors on one NVIDIA GPU, against another
checkout of the repository, in turns (other, this tree, this tree, other).

    python3 chip_profile.py [--parent DIR [DIR ...]] [--unchecked]
                            [--configs T,B,H] [--dtype bf16|f32]
                            [--kernels | --offline] [--cases TEXT]
                            [--out FILE]

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
  (every RoI on level 0, every RoI on level 3) on the 2x2 plan; phase
  16a's batch (seed 16) on the 2x2 plan and on the general plan in each
  of 16a's modes in bf16 (adaptive `max_grid` 4 and 8, static 1, 3 and
  4, unaligned static 2 and adaptive) and adaptive `max_grid` 4 in
  float32. Per batch: the median of 3 CUDA-event timings of 30 calls,
  the device time per call of the plan's kernel under `torch.profiler`,
  the max error against the plain twin (fails beyond atol = rtol =
  0.05, 1e-3 in float32), the bytes moved and the bound; and kernel C's
  registers a thread, as `ptxas -v` gives them when the turn builds its
  tree's kernels.
- `model`: per config, the latency per batch of 8 at 384x640 (median of
  7 calls after 2 warm-ups) and, under `torch.profiler` over 2 calls,
  wall and device busy time per call, idle share, kernel C's device time
  per call and the kernels with the most device time; in bf16, or with
  `--dtype f32` in float32 (the serving entry points' default), the same
  weights either way. With `--dtype f32` the kernel C turns are skipped
  (its float32 batch is the one above; no float32 plan of its own).
- `kernels` (with --kernels, in place of the two above): kernels A (self,
  cross over two modalities) and B at HRFuser-T's four widths, HRFuser-B's
  four and the STF r1248 map at C = 72, B = 8, in `--dtype`: ms per call (median
  of 3 CUDA-event timings of 20 calls), device ms per call of each
  launch under `torch.profiler`, max error against the twin (held to
  `chip_smoke.TOL` and, in float32, its 1e-4 bar, but for --unchecked
  trees): for knock-out copies of a kernel's parts.
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


def _roi(smoke, checked=True, only=''):
    from hrfuser_tpu_torch.ops import roi_align
    from hrfuser_tpu_torch.utils import cuda_build
    ptxas = _ptxas(cuda_build.build().log)
    g = torch.Generator().manual_seed(4)
    feats32, mixed = smoke._roi_inputs(g)
    bf = [f.to(torch.bfloat16).contiguous() for f in feats32]
    # name: (features, RoIs, sample_num, max_grid, aligned)
    cases = {'mixed bf16': (bf, mixed, 2, 4, True),
             'level 0 bf16': (bf, smoke._skewed_rois(g, 0), 2, 4, True),
             'level 3 bf16': (bf, smoke._skewed_rois(g, 3), 2, 4, True),
             'mixed f32': (feats32, mixed, 2, 4, True)}
    # the general plan on phase 16a's inputs, beside the 2x2 plan on them
    feats32, grid = smoke._contract_rois(torch.Generator().manual_seed(16))
    bf = [f.to(torch.bfloat16).contiguous() for f in feats32]
    cases['16a 2x2 bf16'] = (bf, grid, 2, 4, True)
    for label, sn, mg, al in smoke.ROI_MODES:
        cases[f'16a {label} bf16'] = (bf, grid, sn, mg, al)
    cases['16a adaptive max_grid 4 f32'] = (feats32, grid, 0, 4, True)
    out = {}
    for name, (feats, rois, sn, mg, al) in cases.items():
        if only not in name:
            continue

        def fk():
            return roi_align.multilevel_roi_align(feats, rois, STRIDES, 7,
                                                  sn, 56, mg, al)

        got = fk()
        want = roi_align.multilevel_roi_align_plain(feats, rois, STRIDES, 7,
                                                    sn, 56, mg, al)
        tol = smoke.TOL[feats[0].dtype]
        err = (got.float() - want.float()).abs().max().item()
        if checked and not torch.allclose(got.float(), want.float(),
                                          atol=tol, rtol=tol):
            raise AssertionError(f'kernel C {name}: max_abs_err {err}')
        times = sorted(smoke._time_ms(fk, iters=30) for _ in range(3))
        flops, nbytes, peak_dt, pixels = smoke._roi_work(feats, rois, got,
                                                         sn, mg, al)
        bound_ms, bound_by = smoke._bound(flops, nbytes, peak_dt)
        kernel = ('roi_align_kernel' if roi_align.plan(sn, al) == '2x2'
                  else 'roi_align_grid_kernel')
        out[name] = dict(ms=times[1], ms_runs=times,
                         device_ms=smoke._device_ms(fk, kernel, iters=30),
                         max_abs_err=err, mbytes=nbytes / 1e6, pixels=pixels,
                         bound_ms=bound_ms, bound_by=bound_by)
    return dict(cases=out, ptxas=ptxas)


DTYPES = {'bf16': torch.bfloat16, 'f32': torch.float32}


def _model(smoke, config, dtype='bf16'):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from hrfuser_tpu_torch import init_detector
    det = init_detector(config, 'cuda', seed=0, dtype=DTYPES[dtype])
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
    return dict(config=config, dtype=dtype,
                latency_ms=sorted(times)[len(times) // 2],
                latency_runs=times, wall_ms=wall, busy_ms=busy,
                idle=1 - busy / wall,
                kernels_per_call=sum(count.values()) / calls,
                roi_align_ms=sum(v for k, v in ms.items()
                                 if 'roi_align_' in k),
                top=[(k[:90], ms[k], count[k] / calls) for k in top])


KERNEL_SHAPES = ((96, 160, 18, 1), (48, 80, 36, 2), (24, 40, 72, 4),
                 (12, 20, 144, 8), (24, 78, 72, 4), (96, 160, 78, 2),
                 (48, 80, 156, 4), (24, 40, 312, 8), (12, 20, 624, 16))


def _launch_ms(fn, iters=10):
    """Device ms per call of each kernel `fn` launches (`torch.profiler`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ms = defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms[e.name.split('(')[0][:60]] += e.time_range.elapsed_us() / 1e3
    return {k: v / iters for k, v in ms.items()}


def _kernels(smoke, dtype, checked=True):
    from hrfuser_tpu_torch.layers.attention import (HRFormerBlock,
                                                    HRFuserFusionBlock)
    from hrfuser_tpu_torch.ops import chain
    dt = DTYPES[dtype]
    g = torch.Generator().manual_seed(2)
    out = {}
    for h, w, c, heads in KERNEL_SHAPES:
        blk = smoke._randomize(HRFormerBlock(c, heads), g).cuda()
        fus = smoke._randomize(HRFuserFusionBlock(c, heads, 2), g).cuda()
        p, pf = blk.folded(), fus.folded()
        x, z0, z1 = (torch.randn((smoke.BATCH, h, w, c), generator=g)
                     .cuda().to(dt) for _ in range(3))

        def cross(attn, x=x, zs=(z0, z1), ps=pf['attn'], heads=heads):
            out = x
            for z, pk in zip(zs, ps):
                out = attn(out, x, z, pk, heads)
            return out

        cases = {
            'self': (lambda: chain.window_self_attention(x, p['attn'], heads),
                     lambda: chain.window_attention_plain(x, x, p['attn'],
                                                          heads)),
            'cross x2': (lambda: cross(chain.window_cross_attention),
                         lambda: cross(lambda o, q, z, pk, n: chain.
                                       window_attention_plain(
                                           o, q, pk, n, kv_src=z, z=z))),
            'ffn': (lambda: chain.cross_ffn(x, p['ffn']),
                    lambda: chain.cross_ffn_plain(x, p['ffn']))}
        for name, (fk, fp) in cases.items():
            got, want = fk().float(), fp().float()
            err = (got - want).abs().max().item()
            tol = smoke.TOL[dt]
            bar = smoke.F32_BAR if dt == torch.float32 else None
            if checked and not (torch.allclose(got, want, atol=tol, rtol=tol)
                                and (bar is None or err <= bar)):
                raise AssertionError(f'{h}x{w}x{c} {name}: max_abs_err '
                                     f'{err}')
            times = sorted(smoke._time_ms(fk) for _ in range(3))
            out[f'{h}x{w}x{c} {name}'] = dict(
                ms=times[1], ms_runs=times, max_abs_err=err,
                launches=_launch_ms(fk))
    return dict(cases=out)


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


def _worker(root, what, config, checked, dtype, only):
    sys.path.insert(0, str(root))
    import hrfuser_tpu_torch
    pkg = Path(hrfuser_tpu_torch.__file__).resolve()
    if Path(root).resolve() not in pkg.parents:
        raise RuntimeError(f'imported {pkg}, not the package of {root}')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke = _smoke()
    res = (_roi(smoke, checked, only) if what == 'roi'
           else _offline(smoke) if what == 'offline'
           else _kernels(smoke, dtype, checked) if what == 'kernels'
           else _model(smoke, config, dtype))
    print('RESULT ' + json.dumps(dict(root=str(root), what=what, **res)))


def _turn(root, what, config=None, checked=True, dtype='bf16', only=''):
    cmd = [sys.executable, str(Path(__file__).resolve()), '--worker-root',
           str(root), '--what', what, '--dtype', dtype, '--cases', only] + (
               ['--config', config] if config else [])
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
    ap.add_argument('--dtype', choices=sorted(DTYPES), default='bf16',
                    help='the detectors\' compute dtype')
    ap.add_argument('--kernels', action='store_true',
                    help='measure only kernels A and B by width')
    ap.add_argument('--offline', action='store_true',
                    help='measure only the offline nuScenes conversion')
    ap.add_argument('--cases', default='',
                    help='only the kernel C cases whose name holds this')
    ap.add_argument('--out', type=Path,
                    default=HERE / 'chiprun_out' / 'chip_profile.json')
    ap.add_argument('--worker-root', type=Path, help=argparse.SUPPRESS)
    ap.add_argument('--what', help=argparse.SUPPRESS)
    ap.add_argument('--config', help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker_root is not None:
        _worker(args.worker_root, args.what, args.config,
                not args.unchecked, args.dtype, args.cases)
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
    if args.kernels:
        runs = [_turn(r, 'kernels', checked=r == HERE or not args.unchecked,
                      dtype=args.dtype) for r in roots]
        print(f'== kernels A and B, {args.dtype}, B = {_smoke().BATCH}, ms a '
              f'call ({smi}); turns in order')
        for case in runs[0]['cases']:
            print(f'  {case}:')
            for r in runs:
                v = r['cases'][case]
                parts = ', '.join(f'{k} {ms:.4f}'
                                  for k, ms in v['launches'].items())
                print(f'    {tag[Path(r["root"])]}: {v["ms"]:.4f} (device: '
                      f'{parts}), max_abs_err {v["max_abs_err"]:.3e}')
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(device=smi, runs=runs),
                                       indent=1))
        print(f'wrote {args.out}')
        return
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
    nroi = 0 if args.dtype == 'f32' else len(roots)
    runs = [_turn(r, 'roi', checked=r == HERE or not args.unchecked,
                  only=args.cases) for r in roots[:nroi]]
    configs = [CONFIGS[c] for c in args.configs.split(',') if c]
    runs += [_turn(r, 'model', c, dtype=args.dtype) for c in configs
             for r in roots]

    if nroi:
        print(f'== kernel C, ms ({smi}); turns in order')
    for case in (runs[0]['cases'] if nroi else ()):
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
    for r in runs[:nroi]:
        for line in r['ptxas']:
            print(f'  {tag[Path(r["root"])]} {line}')
    print(f'== detectors, {args.dtype} batch of 8, ms per call')
    for r in runs[nroi:]:
        print(f'  {r["config"]} {tag[Path(r["root"])]}: latency '
              f'{r["latency_ms"]:.2f}, profiled wall {r["wall_ms"]:.2f}, '
              f'busy {r["busy_ms"]:.2f}, idle {r["idle"]:.1%}, kernel C '
              f'{r["roi_align_ms"]:.3f}, {r["kernels_per_call"]:.0f} '
              f'kernels a call')
        for name, ms, n in r['top'][:6]:
            print(f'    {ms:.3f} ms in {n:g} x {name}')
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(device=smi, runs=runs), indent=1))
    print(f'wrote {args.out}')


if __name__ == '__main__':
    main()
