"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero:

1. environment: torch / CUDA / nvcc versions and the card's name and
   power limit (exits non-zero without a CUDA device);
2. build: nvcc compiles `hrfuser_tpu_torch/csrc/*.cu` into `build/`;
3. every kernel of the eval path vs its plain PyTorch twin on the card at
   HRFuser-T's main-path shapes, float32 (TF32 off) and bfloat16, with
   both timed;
3b. the same at HRFuser-B's widths (kernel A in self, cross and windows
   mode, kernel B), the block-level entries (`ops/block.py`), the
   pre-partitioned window entry (`ops/window_attention.py`) and the
   single-image RoIAlign entry with variants v4 and v8;
4. the main path: `init_detector` on the full-width HRFuser-T r640
   lidar+radar config (random weights from seed 0), three bf16 batches of
   8 at 384x640; checks the outputs and every kernel's launch count;
4b. the same for HRFuser-B (`cascade_rcnn_hrfuser_b_1x_nus_r640_l_r_
   fusion`, widths 78-624);
5. HRFuser-T at batch 1 in float32 on the card (kernels) vs the CPU
   (plain twins): neck features compared;
5b. the same for HRFuser-B (its CPU forward at 384x640 takes seconds, so
   it runs at full size).

The last line is `{"ok": true, "device": {...}}`; the line before it
lists each kernel's launches, error and times as JSON.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

CONFIG = 'cascade_rcnn_hrfuser_t_1x_nus_r640_l_r_fusion'
CONFIG_B = 'cascade_rcnn_hrfuser_b_1x_nus_r640_l_r_fusion'
BATCH, H, W = 8, 384, 640
TOL = {torch.float32: 1e-3, torch.bfloat16: 0.05}
SRC_A = 'hrfuser_tpu_torch/csrc/window_attention.cu'
SRC_B = 'hrfuser_tpu_torch/csrc/cross_ffn.cu'
SRC_C = 'hrfuser_tpu_torch/csrc/roi_align.cu'
# every TPU pallas_call each kernel serves
REPLACES_A = ['hrfuser_tpu/ops/pallas_chain.py:878',
              'hrfuser_tpu/ops/pallas_chain.py:670',
              'hrfuser_tpu/ops/pallas_block.py:228',
              'hrfuser_tpu/ops/pallas_attention.py:125']
REPLACES_B = ['hrfuser_tpu/ops/pallas_chain.py:878',
              'hrfuser_tpu/ops/pallas_chain.py:670',
              'hrfuser_tpu/ops/pallas_block.py:370']
REPLACES_C = ['hrfuser_tpu/ops/pallas_roi_align.py:597',
              'hrfuser_tpu/ops/pallas_roi_align.py:633',
              'hrfuser_tpu/ops/pallas_roi_align.py:558']


def _run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def _time_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _randomize(module, g):
    """Non-trivial eval weights: biases, norms and BN statistics too."""
    with torch.no_grad():
        for p in module.parameters():
            if p.dim() > 1:
                p.copy_(torch.randn(p.shape, generator=g)
                        / p[0].numel() ** 0.5)
            else:
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
        for m in module.modules():
            if isinstance(m, (torch.nn.LayerNorm, torch.nn.BatchNorm2d)):
                m.weight.add_(1.0)
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.num_features,
                                                 generator=g) * 0.3)
                m.running_var.copy_(torch.rand(m.num_features,
                                               generator=g) * 1.5 + 0.5)
    return module.eval()


class Report:
    """Per-kernel results for the JSON line."""

    def __init__(self):
        self.kernels = {}

    def add(self, name, source, replaces, err, ms=None, plain_ms=None):
        k = self.kernels.setdefault(name, dict(
            name=name, route='cuda', source=source, replaces=replaces,
            launches=0, max_abs_err=0.0, ms=None, plain_ms=None))
        k['max_abs_err'] = max(k['max_abs_err'], err)
        if ms is not None and k['ms'] is None:
            k['ms'], k['plain_ms'] = ms, plain_ms


def _compare(label, got, want, dtype):
    tol = TOL[dtype]
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    ok = torch.allclose(got, want, atol=tol, rtol=tol)
    print(f'  {label}: max_abs_err {err:.3e} (atol=rtol={tol:g}) '
          f'{"ok" if ok else "FAIL"}')
    if not ok:
        raise AssertionError(f'{label}: kernel disagrees with its twin')
    return err


def phase_environment():
    print('== 1. environment')
    print(f'python {sys.version.split()[0]}  torch {torch.__version__}  '
          f'cuda {torch.version.cuda}')
    if not torch.cuda.is_available():
        print('no CUDA device: this smoke run needs an NVIDIA GPU',
              file=sys.stderr)
        sys.exit(1)
    from hrfuser_tpu_torch.utils.cuda_build import nvcc
    print(_run([nvcc(), '--version']).splitlines()[-1])
    smi = _run(['nvidia-smi', '--query-gpu=name,power.limit',
                '--format=csv,noheader']).splitlines()[0]
    print(smi)
    return smi


def phase_build():
    print('== 2. build')
    from hrfuser_tpu_torch.utils import cuda_build
    info = cuda_build.build()
    cuda_build.lib()
    print(f'built {info.path.name} in {info.seconds:.1f} s')
    for line in info.log.splitlines():
        if 'registers' in line or 'spill' in line or 'Compiling' in line:
            print('  ' + line.strip())


def phase_kernels(report):
    print('== 3. kernels vs plain twins')
    from hrfuser_tpu_torch.layers.attention import (HRFormerBlock,
                                                    HRFuserFusionBlock)
    from hrfuser_tpu_torch.ops import chain, roi_align
    g = torch.Generator().manual_seed(1)
    for (h, w, c, heads) in ((96, 160, 18, 1), (12, 20, 144, 8)):
        blk = _randomize(HRFormerBlock(c, heads), g).cuda()
        fus = _randomize(HRFuserFusionBlock(c, heads, 2), g).cuda()
        p, pf = blk.folded(), fus.folded()
        x32 = torch.randn((BATCH, h, w, c), generator=g).cuda()
        z32 = [torch.randn((BATCH, h, w, c), generator=g).cuda()
               for _ in range(2)]
        for dt in (torch.float32, torch.bfloat16):
            x, z = x32.to(dt), [t.to(dt) for t in z32]
            tag = f'{h}x{w}x{c} heads={heads} B={BATCH} {str(dt)[6:]}'

            def self_k():
                return chain.window_self_attention(x, p['attn'], heads)

            def self_p():
                return chain.window_attention_plain(x, x, p['attn'], heads)

            def cross_k():
                out = x
                for zk, pk in zip(z, pf['attn']):
                    out = chain.window_cross_attention(out, x, zk, pk, heads)
                return out

            def cross_p():
                out = x
                for zk, pk in zip(z, pf['attn']):
                    out = chain.window_attention_plain(out, x, pk, heads,
                                                       kv_src=zk, z=zk)
                return out

            def ffn_k():
                return chain.cross_ffn(x, p['ffn'])

            def ffn_p():
                return chain.cross_ffn_plain(x, p['ffn'])

            main = dt == torch.bfloat16 and c == 18
            for name, src, rep, fk, fp in (
                    ('window_attention_self', SRC_A, REPLACES_A, self_k,
                     self_p),
                    ('window_attention_cross', SRC_A, REPLACES_A, cross_k,
                     cross_p),
                    ('cross_ffn', SRC_B, REPLACES_B, ffn_k, ffn_p)):
                err = _compare(f'{name} {tag}', fk(), fp(), dt)
                torch.cuda.synchronize()
                ms, plain_ms = _time_ms(fk), _time_ms(fp)
                print(f'    time {ms:.4f} ms, plain {plain_ms:.4f} ms')
                report.add(name, src, rep, err, *((ms, plain_ms) if main
                                                  else (None, None)))

    # kernel C at the r640 pyramid, 8 x 1000 RoIs with the edge cases
    feats32, rois = _roi_inputs(g)
    n = rois.shape[1]
    for dt in (torch.float32, torch.bfloat16):
        feats = [f.to(dt).contiguous() for f in feats32]

        def roi_k():
            return roi_align.multilevel_roi_align(feats, rois, (4, 8, 16, 32))

        def roi_p():
            return roi_align.multilevel_roi_align_plain(feats, rois,
                                                        (4, 8, 16, 32))

        err = _compare(f'roi_align r640 C=256 {BATCH}x{n} {str(dt)[6:]}',
                       roi_k(), roi_p(), dt)
        ms, plain_ms = _time_ms(roi_k), _time_ms(roi_p, iters=3, warmup=1)
        print(f'    time {ms:.4f} ms, plain {plain_ms:.4f} ms')
        main = dt == torch.bfloat16
        report.add('roi_align', SRC_C, REPLACES_C, err,
                   *((ms, plain_ms) if main else (None, None)))


def _roi_inputs(g):
    """The r640 pyramid (C = 256) and 8 x 1000 RoIs with the edge cases."""
    feats32 = [torch.randn((BATCH, H // s, W // s, 256), generator=g).cuda()
               for s in (4, 8, 16, 32)]
    n = 1000
    xy = torch.rand((BATCH, n, 2), generator=g) * torch.tensor([W, H]) - 20
    wh = torch.rand((BATCH, n, 2), generator=g) ** 2 * torch.tensor([W, H])
    rois = torch.cat([xy, xy + wh + 1], -1)
    rois[:, :100] = 0.0                                  # padded proposals
    rois[:, 100:150] = torch.tensor([0., 40., W, 43.])   # full-width slivers
    rois[:, 150:200] = torch.tensor([-80., -60., -5., -2.])      # outside
    rois[:, 200:250] = torch.tensor([W - 10., H - 10., W + 50., H + 40.])
    return feats32, rois.cuda().contiguous()


def _check(report, name, src, rep, label, fk, fp, dt, time_it=True):
    """Hold a kernel call to its twin; time both."""
    err = _compare(label, fk(), fp(), dt)
    torch.cuda.synchronize()
    if time_it:
        ms, plain_ms = _time_ms(fk), _time_ms(fp)
        print(f'    time {ms:.4f} ms, plain {plain_ms:.4f} ms')
    report.add(name, src, rep, err)


def phase_kernels_wide(report):
    print('== 3b. HRFuser-B widths and the block / window / variant entries')
    from hrfuser_tpu_torch.layers.attention import (HRFormerBlock,
                                                    HRFuserFusionBlock)
    from hrfuser_tpu_torch.layers.common import layer_norm
    from hrfuser_tpu_torch.ops import (block, chain, roi_align,
                                       window_attention)
    from hrfuser_tpu_torch.ops.window import window_partition
    g = torch.Generator().manual_seed(2)
    for (h, w, c, heads) in ((96, 160, 78, 2), (12, 20, 624, 16)):
        print(f'  plans at C={c}, {heads} heads: kernel A self '
              f'{chain.attention_plan(c, heads, False)}, cross '
              f'{chain.attention_plan(c, heads, True)} (plan, chunk, bytes); '
              f'kernel B {chain.ffn_plan(c, 4 * c)} (rows, chunk, bytes)')
        blk = _randomize(HRFormerBlock(c, heads), g).cuda()
        fus = _randomize(HRFuserFusionBlock(c, heads, 2), g).cuda()
        p, pf = blk.folded(), fus.folded()
        x32 = torch.randn((BATCH, h, w, c), generator=g).cuda()
        z32 = [torch.randn((BATCH, h, w, c), generator=g).cuda()
               for _ in range(2)]
        # row 6's inputs: the LN'd windows of the same maps
        xw32 = window_partition(layer_norm(x32, *p['attn']['lnq']), 7)
        yw32 = window_partition(layer_norm(z32[0], *p['attn']['lnq']), 7)
        wts = [t.contiguous() for t in (
            *p['attn']['wqkv'].split(c, 1), p['attn']['wo'],
            *p['attn']['bqkv'].split(c), p['attn']['bo'])]
        bias = p['attn']['bias']
        for dt in (torch.float32, torch.bfloat16):
            x, z = x32.to(dt), [t.to(dt) for t in z32]
            xw, yw = xw32.to(dt).contiguous(), yw32.to(dt).contiguous()
            tag = f'{h}x{w}x{c} heads={heads} B={BATCH} {str(dt)[6:]}'

            def cross_k():
                out = x
                for zk, pk in zip(z, pf['attn']):
                    out = chain.window_cross_attention(out, x, zk, pk, heads)
                return out

            def cross_p():
                out = x
                for zk, pk in zip(z, pf['attn']):
                    out = chain.window_attention_plain(out, x, pk, heads,
                                                       kv_src=zk, z=zk)
                return out

            for name, src, rep, label, fk, fp in (
                    ('window_attention_self', SRC_A, REPLACES_A, 'self',
                     lambda: chain.window_self_attention(x, p['attn'], heads),
                     lambda: chain.window_attention_plain(x, x, p['attn'],
                                                          heads)),
                    ('window_attention_cross', SRC_A, REPLACES_A,
                     'cross x2', cross_k, cross_p),
                    ('window_attention_self', SRC_A, REPLACES_A,
                     f'windows [{xw.shape[0]}, 49, {c}] cross',
                     lambda: window_attention.fused_window_attention(
                         xw, yw, *wts, bias, heads),
                     lambda: window_attention.fused_window_attention_plain(
                         xw, yw, *wts, bias, heads)),
                    ('cross_ffn', SRC_B, REPLACES_B, 'ffn',
                     lambda: chain.cross_ffn(x, p['ffn']),
                     lambda: chain.cross_ffn_plain(x, p['ffn']))):
                _check(report, name, src, rep, f'{name} {label} {tag}', fk,
                       fp, dt)

    # rows 4 and 5: the block entries at test_pallas_block.py's shapes
    for (h, w, c, heads) in ((20, 26, 18, 1), (13, 12, 36, 2),
                             (12, 20, 144, 8), (12, 20, 624, 16)):
        blk = _randomize(HRFormerBlock(c, heads), g).cuda()
        fus = _randomize(HRFuserFusionBlock(c, heads, 2), g).cuda()
        x = torch.randn((BATCH, h, w, c), generator=g).cuda()
        zs = [torch.randn((BATCH, h, w, c), generator=g).cuda()
              for _ in range(2)]
        tag = f'{h}x{w}x{c} heads={heads} B={BATCH} float32'
        with torch.no_grad():
            _check(report, 'window_attention_self', SRC_A, REPLACES_A,
                   f'block.fused_hrformer_block {tag}',
                   lambda: block.fused_hrformer_block(x, blk,
                                                      num_heads=heads),
                   lambda: blk(x), torch.float32)
            _check(report, 'window_attention_cross', SRC_A, REPLACES_A,
                   f'block.fused_fusion_block {tag}',
                   lambda: block.fused_fusion_block(x, zs, fus,
                                                    num_heads=heads),
                   lambda: fus(x, zs), torch.float32)

    # rows 3b / 3c: the single-image entry, variants v4 and v8
    feats32, rois = _roi_inputs(g)
    for dt in (torch.float32, torch.bfloat16):
        feats = [f[0].to(dt).contiguous() for f in feats32]

        def roi_p():                  # the twin, in the flat (q, p) order
            out = roi_align.multilevel_roi_align_plain(
                [f[None] for f in feats], rois[:1], (4, 8, 16, 32))[0]
            return out.reshape(-1, 7, 7, 256).transpose(1, 2).reshape(
                -1, 49, 256)

        for variant in ('v4', 'v8'):
            _check(report, 'roi_align', SRC_C, REPLACES_C,
                   f'roi_align multilevel_roi_align_pallas variant={variant} '
                   f'flat_out 1x{rois.shape[1]} {str(dt)[6:]}',
                   lambda: roi_align.multilevel_roi_align_pallas(
                       feats, rois[0], variant=variant, flat_out=True),
                   roi_p, dt)


def _inputs(cfg, batch, rng, hw=(H, W)):
    img = rng.normal(0., 1., (batch, *hw, 3)).astype(np.float32)
    mods = [rng.normal(0., 1., (batch, *hw, c)).astype(np.float32)
            for c in cfg.backbone.mod_in_channels]
    return img, mods


def _expected_launches(cfg):
    bb = cfg.backbone
    hr_blocks = sum(s.num_modules * sum(s.num_blocks)
                    for s in (bb.stage2, bb.stage3, bb.stage4))
    hr_blocks += bb.num_fused_modalities * sum(
        s.num_modules * s.num_blocks[0] for s in (bb.stage_b, bb.stage_c))
    fusion_blocks = sum(f.num_branches
                        for f in (bb.fusion_a, bb.fusion_b, bb.fusion_c))
    print(f'  per forward: {hr_blocks} HRFormer blocks, {fusion_blocks} '
          f'fusion blocks')
    return {'window_attention_self': hr_blocks,
            'window_attention_cross': fusion_blocks
            * bb.num_fused_modalities,
            'cross_ffn': hr_blocks + fusion_blocks,
            'roi_align': cfg.roi.num_stages}


def phase_slice(report, smi, config, title, record):
    """Drive `config` as a user would; check launches and outputs."""
    print(f'== {title}')
    from hrfuser_tpu_torch import init_detector
    from hrfuser_tpu_torch.ops import chain, roi_align
    counters = {'window_attention_self': chain.window_self_attention,
                'window_attention_cross': chain.window_cross_attention,
                'cross_ffn': chain.cross_ffn,
                'roi_align': roi_align.multilevel_roi_align}
    det = init_detector(config, 'cuda', seed=0, dtype=torch.bfloat16)
    cfg = det.cfg
    img, mods = _inputs(cfg, BATCH, np.random.default_rng(0))
    det(img, mods)                                       # warm-up
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    calls, times = 3, []
    for _ in range(calls):
        t0 = time.perf_counter()
        out = det(img, mods)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = {k: fn.launches for k, fn in counters.items()}
    want = _expected_launches(cfg)
    print(f'  expected launches per forward {want}')
    print(f'  launches over {calls} calls: {counts}')
    for k, n in want.items():
        if counts[k] != calls * n:
            raise AssertionError(f'{k}: {counts[k]} launches, expected '
                                 f'{calls * n}')
        if record:
            report.kernels[k]['launches'] = counts[k]
    m = cfg.roi.max_per_img
    shapes = {'boxes': (BATCH, m, 4), 'scores': (BATCH, m),
              'labels': (BATCH, m), 'valid': (BATCH, m)}
    for k, shape in shapes.items():
        t = getattr(out, k)
        if tuple(t.shape) != shape:
            raise AssertionError(f'{k}: shape {tuple(t.shape)} != {shape}')
    if not (out.boxes.isfinite().all() and out.scores.isfinite().all()):
        raise AssertionError('non-finite detections')
    print(f'  detections ok: {int(out.valid.sum())} valid of {BATCH}x{m}')
    print(f'  latency per batch of {BATCH} (ms): '
          f'{", ".join(f"{t:.1f}" for t in times)}; median '
          f'{sorted(times)[len(times) // 2]:.1f} on {smi}')
    del det
    torch.cuda.empty_cache()


def phase_cpu_check(config, title, hw=(H, W)):
    print(f'== {title}: batch 1 float32 at {hw[0]}x{hw[1]}, GPU kernels '
          f'vs CPU plain twins')
    from hrfuser_tpu_torch import init_detector
    gpu = init_detector(config, 'cuda', seed=0)
    cpu = init_detector(config, 'cpu', seed=0)
    img, mods = _inputs(gpu.cfg, 1, np.random.default_rng(1), hw)
    with torch.no_grad():
        fg = gpu.model.forward_features(
            torch.from_numpy(img).cuda(),
            [torch.from_numpy(m).cuda() for m in mods])[0]
        t0 = time.perf_counter()
        fc = cpu.model.forward_features(
            torch.from_numpy(img), [torch.from_numpy(m) for m in mods])[0]
        print(f'  CPU forward {time.perf_counter() - t0:.1f} s')
    for lvl, (a, b) in enumerate(zip(fg, fc)):
        a = a.cpu()
        err = (a - b).abs().max().item()
        print(f'  neck level {lvl} {tuple(b.shape)}: max_abs_err {err:.3e}')
        if not torch.allclose(a, b, atol=5e-3, rtol=1e-3):
            raise AssertionError(f'neck level {lvl}: GPU and CPU disagree')


def main():
    smi = phase_environment()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_build()
    report = Report()
    phases = [
        ('3', lambda: phase_kernels(report)),
        ('3b', lambda: phase_kernels_wide(report)),
        ('4', lambda: phase_slice(
            report, smi, CONFIG, '4. main path: HRFuser-T r640 lidar+radar, '
            'bf16, batch 8', record=True)),
        ('4b', lambda: phase_slice(
            report, smi, CONFIG_B, '4b. HRFuser-B r640 lidar+radar, bf16, '
            'batch 8', record=False)),
        ('5', lambda: phase_cpu_check(CONFIG, '5. HRFuser-T')),
        ('5b', lambda: phase_cpu_check(CONFIG_B, '5b. HRFuser-B')),
    ]
    for name, run in phases:
        t1 = time.perf_counter()
        run()
        print(f'   phase {name}: {time.perf_counter() - t1:.1f} s')
    print(f'== done in {time.perf_counter() - t0:.0f} s')
    print(json.dumps({'kernels': list(report.kernels.values())}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
