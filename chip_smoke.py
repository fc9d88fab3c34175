"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero:

1. environment: torch / CUDA / nvcc versions and the card's name and
   power limit (exits non-zero without a CUDA device);
2. build: nvcc compiles `hrfuser_tpu_torch/csrc/*.cu` into `build/`; the
   count of tensor-core instructions (`HMMA`, `HGMMA`) in each kernel of
   the library, from `cuobjdump --dump-sass` (fails if kernel A's or B's
   bf16 plan has none);
3. every kernel of the eval path vs its plain PyTorch twin on the card at
   HRFuser-T's main-path shapes, float32 (TF32 off) and bfloat16, with
   both timed, each line naming the plan the host picked and each timed
   kernel call printing its bound (the larger of its FLOPs over the
   card's peak for their type and the bytes it must move over 3.35 TB/s);
   kernel C at r640, C = 256, 8 x 1000 RoIs also prints its bytes (output
   plus the pyramid pixels its taps touch, counted on the card), GB/s,
   share of bound and device time under `torch.profiler`, and is timed on
   two skewed batches (every RoI on level 0, every RoI on level 3);
3b. the same at HRFuser-B's four widths (kernel A in self, cross and
   windows mode, kernel B), the block-level entries (`ops/block.py`), the
   pre-partitioned window entry (`ops/window_attention.py`) and the
   single-image RoIAlign entry with variants v4 and v8;
4. the main path: `init_detector` on the full-width HRFuser-T r640
   lidar+radar config (random weights from seed 0), three bf16 batches of
   8 at 384x640; checks the outputs (shapes, finite values, at least
   one detection in the batch) and every kernel's launch count;
4b. the same for HRFuser-B (`cascade_rcnn_hrfuser_b_1x_nus_r640_l_r_
   fusion`, widths 78-624);
5. HRFuser-T at batch 1 in float32 on the card (kernels) vs the CPU
   (plain twins): neck features compared;
5b. the same for HRFuser-B (its CPU forward at 384x640 takes seconds, so
   it runs at full size);
6. the serving path, HRFuser-T r640 bf16 from raw requests (a 900x1600
   BGR uint8 camera image, nuScenes' native size, and two 360x640 uint16
   lidar / radar projections): 6a preprocessing (resize, dequantize,
   normalize, pad) on the card vs the CPU; 6b `inference_detector` with
   weights from a checkpoint this phase writes (`save_checkpoint`, loaded
   bit-equal), each request's launch counts, boxes inside the 1600x900
   frame, camera-only too, and the median request latency with its host
   -> device copy / preprocessing / `predict` split (CUDA events); 6c
   `run_inference` over 3 raw batches of 8 + `evaluate_nuscenes` and
   `evaluate_proposal_recall` on seeded ground truth, images/s; 6d the
   HTTP server on 127.0.0.1 (/healthz, /predict_multi with PNGs encoded
   here, its `latency_ms` beside the host's PNG, JSON and base64 decode
   times; /predict with the camera as a baseline JPEG from the oracle
   encoder: 200, 2 JPEG kernel launches, the detections of a PNG payload
   of its decoded pixels; a progressive JPEG refused with 400) and
   `inference_detector`'s time on this thread, on fresh threads and on
   one worker thread;
3c. every kernel of the STF path vs its twin at the r1248 map shapes
   (HRFuser-T widths at 96x312x18, 48x156x36, 24x78x72, 12x39x144:
   kernel A self, A cross over three modalities accumulated as the
   fusion block does, B), and kernel C over the 96x312 ... 12x39 pyramid
   with 8 x 1000 RoIs, float32 and bfloat16, each timed beside its twin
   and its bound;
7. STF HRFuser-T with camera + lidar + radar + gated
   (`cascade_rcnn_hrfuser_t_1x_stf_r1248_4mod`, input channels 3 / 2 /
   1): bf16 batches of 8 at 384x1248 with launch counts, then batch 1
   f32 card vs CPU at 192x608 (odd stride-32 width, as r1248's 39);
7b. the camera-only HRFormer-T and HRFormer-B r640 configs, bf16 batches
   of 8 with launch counts, and HRFormer-T card vs CPU;
7c. the request path of the new configs: `inference_detector` on a
   camera-only request (HRFormer-T, 900x1600 camera image) and on an STF
   request (1024x1920 camera image, uint16 lidar, radar and gated
   images with 3 / 2 / 1 channels), launch counts and boxes inside the
   frame; `run_inference` + `evaluate` on a synthetic STF
   `Kitti2DDataset` written to a temporary directory, every KITTI metric
   present and finite.
8. training: 8a `train_step` on the full-width HRFuser-T r640 config
   (`cascade_rcnn_hrfuser_t_1x_nus_r640_l_r_fusion`, random weights from
   seed 0) at its batch of 3, 384x640, float32 (TF32 off), the reference
   caps (2000 proposals, 512 RoIs a stage), drop path 0.2 and `proj_drop`
   0.1 live: 40 steps on one `synthetic_batches` batch at the full lr
   3e-4 from the first step (the preset's warmup dropped for this check
   only); the overfit ratio (mean of the last
   quarter of the losses over the first, must be < 0.7), median ms a
   step over steps 5-40, images/s, peak memory, device busy / idle and
   the ten kernels with the most device time under `torch.profiler` for 2
   steps, the parts of one step on the host clock; no kernel launches
   inside a step;
   then in eval the trained weights serve a bf16 batch of 8 with exact
   launch counts, and card vs CPU neck features agree at batch 1 f32;
   8b the card's train step against the CPU's on the same weights, batch
   and draws (made on the CPU and moved), HRFuser-T at 128x192, B = 2,
   drop rates 0, lr 3e-4 from the first step: losses at rtol 1e-3
   (accuracies within 3 of the 1,024 sampled RoIs), all gradients
   together within relative L2 2e-2 and each within 1e-1, params after
   the step within 2 x lr. The bars are about three times the float32
   spread measured between the two devices (PERF.md §6): rounding
   amplified by the norm layers' backward in the random-weight trunk, and
   near-tied random-weight RPN scores that can swap a proposal.

9. the data slice, on seeded synthetic folders in the converters'
   formats written to a temporary directory: 9a the image decoders (PNG
   round trips of 8-bit colour, grey and 16-bit 3-channel files
   bit-equal; the committed `cv2`-written PNG and JPEG fixtures (JPEG
   at 4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1, with restart markers, grey)
   bit-equal to their committed `cv2` decodes through `imread`, the
   JPEG pixels made by the kernel; the JPEG kernel bit-equal to
   `pixels_plain` on the card's own coefficients for each fixture and
   for a 900x1600 4:2:0 frame from the oracle encoder, whose host
   Huffman decode, coefficient copy, kernel (CUDA events, beside its
   bound and its twin), `decode_jpeg` end to end, and `imread` beside
   the `imread` of a PNG of the same pixels are timed); 9b nuScenes
   dataset eval at full width: 16 samples of a 900x1600 camera JPEG
   (baseline 4:2:0, from the oracle encoder, as nuScenes stores its
   frames), uint16 lidar `rih` / radar `riv` 360x640 projections and a
   COCO json with the config's classes; images/s of the loader alone over
   the JPEG folder and over a PNG copy of the same pixels, then
   `python -m hrfuser_tpu_torch.tools.test` in process on HRFuser-T
   r640, bf16, batch 8, weights from a checkpoint: launch counts exactly
   2 x one forward's and 2 JPEG kernel launches a frame, every COCO and
   recall metric finite, images/s of the whole run and of the same run
   over the PNG copy; 9c `tools.train`
   from the same files, float32, batch 3, flip and modality drop live,
   one epoch of `len(loader)` steps with the eval hook and a checkpoint
   at its end: 0 kernel launches inside a step, the eval hook's counts
   exact, then `--resume-from` continues the step count; ms a step
   beside phase 8a's synthetic step, with and without the wait for the
   next batch; 9d STF: 8 samples (1024x1920 camera PNG, lidar `yzi`,
   radar `yzv` with channel 0 deleted, a grey gated image) in the four
   weather test splits and the train split, `tools.test` on
   `cascade_rcnn_hrfuser_t_1x_stf_r1248_4mod` (bf16, batch 8) with the
   ten KITTI metrics finite and launch counts exact, then two train
   steps through both crops.
10. the rest of the model family, with weights from
   `tests/oracles/card_checks.py:calibrate` (random, seed 0, then each
   BatchNorm's statistics set to those of its input on the batch, and
   the regression layers `rpn_reg` / `fc_reg` scaled by 0.1: at BN's
   initial statistics HRNet-W18's residual trunk grows its maps to an RMS
   of thousands and no detection survives): 10a the HRNet-based HRFuser
   (`cascade_rcnn_hrfuser_hrnet_w18_1x_nus_r640_l_r_fusion`: BASIC conv
   trunk and streams, MWCA fusion banks, widths 18-144) as phase 4, bf16
   batches of 8 at 384x640 with exact launch counts (kernel A self 0,
   cross 18, B 9, C 3 a forward: only the fusion banks hold transformer
   blocks) and detections in the batch, latency and device busy / idle
   share, then the batch's bf16 neck maps vs its float32 ones (relative
   L2 a level, bar `BF16_MAP_REL`); 10a modules: one stage-4 `HRModule`
   (BasicBlocks, BN folds, nearest and bilinear-fallback up paths,
   stride-2 down paths) on the card in float32 and bf16 vs the CPU at
   r640's branch shapes and at 95x159; 10b card vs CPU at batch 1,
   float32: neck features at phase 5's tolerance, then `predict` whole on
   each device, its RPN proposals matched at the decode tolerances
   (0.15 px, 5e-3) and its detections at 1e-2 px (1e-3 relative), 5e-3;
   10c its `train_step` at batch 3, float32, 40 steps: finite losses, no
   kernel launch in a step, ms a step, peak memory, then the weights
   serve the trained images as a bf16 batch of 8 with exact counts and
   at least one detection; 10d flip TTA on HRFuser-T r640
   (`predict_tta_flip`, `predict_aug_test_flip`), bf16 batches of 8 with
   exact counts (twice one forward's: two `predict`s, or two forwards and
   one cascade decode per view), detections, boxes inside the frame,
   then batch 1 float32 card vs CPU at 128x192 as 10b (each view's
   proposals and the fused detections); 10e a stage-D model at
   HRFuser-T widths built by `backbone_cfg_from_extra` (`LidarStageD` =
   stage C's dict, `ModFusionD` = fusion C's): exact counts of one
   `predict`, card vs CPU neck features at batch 1, float32.
11. the offline preprocessing (no kernel: PyTorch on the card), on
   seeded synthetic inputs from `tests/oracles/offline_data.py`, each
   timed on the host clock with the card synchronised: 11a one nuScenes
   sample through `tools/create_data.convert_sample` (a 34,720-point
   lidar sweep and 5 radars x 125 returns into 6 cameras of 1600x900
   on 640x360 grids, through a fake devkit DB), both splat modes card vs
   CPU bit-equal, the 24 PNGs read back bit-equal, the COCO json of the
   card's run identical to the CPU's, ms a sample with and without PNG
   encode, and the calls a sample that wait for the card; 11b one STF
   frame (`tools/stf_projection.project_frame`,
   110,000 HDL-64 points and 60 radar targets onto 1280x768), both
   modes card vs CPU bit-equal, ms a frame; 11c the gated -> RGB warp of
   one frame (`tools/stf_gated_warp.warp_frame`: three 720x1280 10-bit
   slices from uncompressed TIFFs this phase writes, a 1024x1920
   disparity, the ego offset, max-accumulate, the 768x1280 crop) card vs
   CPU within one count, timed again with the slices rewritten as `cv2`
   writes them (LZW, predictor 2, strips of 3 rows), and the committed
   `cv2`-written LZW TIFFs bit-equal to their committed decodes; 11d
   `homography_warp` of a 720x1280 frame onto 768x1280 card vs CPU
   (float32 within 1e-3, integers within one count) and
   `homography_from_points` with 20 % outliers card vs CPU within 1e-9.
12. data parallelism (`hrfuser_tpu_torch/parallel/`) on HRFuser-T r640,
   ranks spawned by `parallel.mesh.run_ranks` (each with a deadline) and
   sharing this one card, so no figure here is a scaling result: 12a a
   world of one rank on `nccl`, 20 float32 steps of
   `make_sharded_train_step` at batch 3 (drop off, the reference caps),
   each beside `train_step` from the same weights and optimizer state
   on the same batch and draws (cuDNN deterministic): losses at rtol
   1e-3 (accuracies within 3 RoIs), params within two AdamW updates
   (2 x lr at the first step, the bias-corrected bound later), BN
   statistics 1e-4, bit-equality reported; ms a step of both, the gradient
   all-reduce's ms and buffer size, 0 eval-kernel launches; 12b two
   `gloo` ranks on the card (CUDA tensors), 3 images each of a joined
   batch of 6 whose last three have no valid GT, one step against one
   process on the joined batch, held with a float64 trunk (losses 1e-3,
   gradients 2e-2 together and 1e-1 each, params 2 x lr, the ranks' BN
   statistics bit-identical) and shown in float32 (where a batch
   layout's 1e-7 can swap a proposal), each beside one process's
   float32 spread on the same batch in another row order; 12c sharded
   `run_inference` over 9b's 16 JPEG samples (written again from its
   seed; weights `card_checks.calibrate`d), bf16, global batch 8, at
   world size 1 (`nccl`) and 2 (`gloo`): every image once in dataset
   order on every rank, detections against one process at
   `card_checks`' tolerances, each rank's samples and its kernel A / B /
   C and JPEG launches exact, images/s; 12d `parallel/dryrun.py` with
   two ranks on the card (`micro_fusion_dryrun`).
13. model export: 13a `torch.library.opcheck` of the `hrfuser::` ops'
   CUDA implementations against their fakes and the ops' host dispatch
   cost; 13b `apis/export.export_predict` of HRFuser-T r640 bf16 batch
   8, saved, loaded and run with exact launch counts beside eager
   `predict`; 13c `tools/export_model.py` as a subprocess.
14. the model tools: 14a `apis/flops.count_flops` of one bf16 batch of 8
   on HRFuser-T and HRFuser-B r640 on the card: each kernel op's calls
   equal that forward's launch counters, its FLOPs the formula of
   `ops/flops.py` summed over its calls at their shapes
   (`card_checks.kernel_op_flops`), no op of the path counting 0;
   GFLOPs a batch and an image, and TFLOP/s with the share of the bf16
   peak at phase 4 / 4b's median latency and device-busy time; then
   HRFuser-T's float32 train step (batch 3) beside phase 8a's ms a step,
   as a share of the float32 peak (TF32 off); 14b bf16 vs float32 drift
   (`tools/numerics_drift.py`: one model under a float32 and a bf16
   `Detector`, TF32 off for the float32 run): HRFuser-T overfit by
   `numerics_drift.overfit`, what `--overfit-steps 40` runs (40 float32
   steps, drop rates 0, the full lr from the first step), on one
   synthetic batch of 4, measured on that batch as the tool measures
   after `--overfit-steps`, then on its 4 seeded batches of 4; HRFuser-B
   on random weights, 2 batches of 4; each `predict_pair`'s launches two
   forwards', every dtype-keyed fold of its dtype, the JAX tool's report
   lines; fails on a non-finite statistic or no matched detection on the
   overfit batch (the drift itself is a report); 14c the tools through their
   `main`: `get_flops --json` (its total equals 14a's), `print_config`,
   `publish_model` of a checkpoint with an AdamW state written here
   (the weights alone, bit-equal, under their digest) and
   `numerics_drift --overfit-steps 2` on `tiny_fusion_test`.
15. the image renderings (no kernel: integer and float32 PyTorch ops on
   the card), each card run held bit-equal to the CPU port on the same
   seeded inputs and timed (CUDA events, or the host clock with the card
   synchronised): 15a `data/stf_lut.py`'s CLAHE (clip 2.0 and 0.5), GB
   demosaic and both Lab directions, `gated_raw_to_lut8` of a 720x1280
   frame and `raw_to_lut8` (daytime and nighttime) of a 1024x1920 one;
   15b `tools/stf_gated_warp.py --lut8` through its `main` on one
   synthetic frame (card vs CPU at 11c's bar, uint8); 15c the JPEG
   writer (`data/jpeg.py:imencode`) on a 900x1600 colour frame and a grey
   one: bytes equal to the CPU run's, read back by the port's decoder,
   the pixel stage (card) and the Huffman stage (host) timed apart;
   15d `tools.test --show-dir` over 9b's 16 JPEG samples (written again
   from its seed: 9c removes 9b's folder), HRFuser-T r640
   bf16, batch 8, through kernels A, B and C with exact launch counts
   (and 4 JPEG kernel launches a frame: the loader's and the show
   loop's reads), one JPEG a frame that decodes, the drawing and its
   JPEG card vs CPU bit-equal on the same results, ms per image; 15e
   `tools.browse_dataset` writing 4 composites from that folder's train
   split.
16. RoIAlign's whole sampling contract, remat, the parity rehearsal:
   16a kernel C's general plan against its twin at r640, C = 256, 8 x
   1000 RoIs (phase 3's edge cases plus level-0 RoIs of grids 1-4, a
   sliver capped at 4 but not 8, bins of exactly 2 and 3 px and one ulp
   either side): adaptive `sample_num=0` at `max_grid` 4 and 8, static
   grids 1, 3, 4, unaligned (static 2 and adaptive), float32 (TF32 off)
   and bfloat16, each launch counted on the plan; time, twin time and
   bound (bytes and FLOPs from the RoIs' own grids) beside the 2x2 plan's
   time on the same inputs; the single-image entry's v4 and v8 at a
   static 3x3 grid; 16b HRFuser-T r640 bf16 batch 8 with
   `roi.sample_num=0` on calibrated weights: exact launch counts (every C
   launch on the general plan), detections, latency and device busy time
   in turns beside `sample_num=2` on the same weights, then batch 1
   float32 card vs CPU (`card_checks.same_runs`); 16c one float32
   HRFuser-T train step at batch 3 with and without `backbone.remat`,
   the same weights, batch and generator (drops live): losses, gradients
   and BN statistics at phase 8b's bars with bit-equality reported, one
   BN update, the generator's end state, peak memory and ms a step of
   both, then a `sample_num=0` step through the one-hot pool; 16d
   `tools.real_parity --dry-run`.

The last line is `{"ok": true, "device": {...}}`; the line before it
lists each kernel's launches, error, times and bound as JSON.
"""

from __future__ import annotations

import base64
import contextlib
import functools
import io
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import warnings

import numpy as np
import torch

CONFIG = 'cascade_rcnn_hrfuser_t_1x_nus_r640_l_r_fusion'
RAW_HW, GRID_HW = (900, 1600), (360, 640)    # nuScenes camera; model grid
PRE_TOL = 1e-4                   # card vs CPU preprocessing, normalized
CONFIG_B = 'cascade_rcnn_hrfuser_b_1x_nus_r640_l_r_fusion'
BATCH, H, W = 8, 384, 640
CONFIG_STF = 'cascade_rcnn_hrfuser_t_1x_stf_r1248_4mod'
CONFIG_CAM_T = 'cascade_rcnn_hrformer_t_1x_nus_r640'
CONFIG_CAM_B = 'cascade_rcnn_hrformer_b_1x_nus_r640'
CONFIG_HRNET = 'cascade_rcnn_hrfuser_hrnet_w18_1x_nus_r640_l_r_fusion'
CLI_EXPORT_CONFIG = 'tiny_fusion_test'   # phase 13c, the CLI at 384x640
DRIFT_OVERFIT_STEPS = 40             # phase 14b, as phase 8a trains
TTA_CPU_HW = (128, 192)              # flip TTA, card vs CPU at batch 1
STF_HW = (384, 1248)                 # the STF grid; stride 32 is 12x39
STF_CPU_HW = (192, 608)              # reduced, stride 32 still odd: 6x19
STF_RAW_HW = (1024, 1920)            # STF's camera frame
TOL = {torch.float32: 1e-3, torch.bfloat16: 0.05}
# a whole model's bf16 neck maps vs its float32 ones (relative L2 a
# level): bf16's rounding, amplified through a random-weight trunk, stays
# well below it; a fold or upsample gone wrong moves the maps by O(1)
BF16_MAP_REL = 0.25
SRC_A = 'hrfuser_tpu_torch/csrc/window_attention.cu'
SRC_B = 'hrfuser_tpu_torch/csrc/cross_ffn.cu'
SRC_C = 'hrfuser_tpu_torch/csrc/roi_align.cu'
SRC_JPEG = 'hrfuser_tpu_torch/csrc/jpeg_pixels.cu'
# no TPU kernel: the JAX package decodes JPEG with libjpeg on the host
REPLACES_JPEG = 'hrfuser_tpu/data/_native/loader.cpp:150'
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
# H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W): kernels A and B
# multiply bf16 on tensor cores and float32 on CUDA cores; kernel C
# accumulates in float32 on CUDA cores whatever its features' type
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12


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


def _device_ms(fn, name, iters=20):
    """Device time per call of the kernels whose name holds `name`, from
    `torch.profiler` (CUDA activity only); None if it records none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and name in e.name]
    return sum(us) / iters / 1e3 if us else None


def _nbytes(*tensors):
    """Bytes of distinct tensors, each counted once."""
    seen = {t.data_ptr(): t.numel() * t.element_size() for t in tensors}
    return sum(seen.values())


def _bound(flops, nbytes, dt):
    """(least ms, 'bytes' or 'operations'): the larger of FLOPs over the
    peak for `dt` and bytes over the memory rate."""
    ops_ms = flops / PEAK_FLOPS[dt] * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (bytes_ms, 'bytes') if bytes_ms >= ops_ms else (ops_ms,
                                                            'operations')


def _attn_work(x, ps, dt, acts):
    """FLOPs, bytes and peak type of one kernel A call per folded weight
    set in `ps` on maps like `x`: T C (8C + 196) a call (`ops/flops.py`),
    T the map's own tokens, not the ring that pads it to whole windows
    (no output of the kernel's); the activations `acts` (read or written
    once) and the weights the plan reads."""
    from hrfuser_tpu_torch.ops.flops import window_attention_flops
    keys = ['lnq', 'lnkv', 'bqkv', 'bo', 'bias']
    keys += ['wqkv_p', 'wo_p'] if dt == torch.bfloat16 else ['wqkv', 'wo']
    return (sum(window_attention_flops(x.shape, p['bias'].shape[-1],
                                       padded=False) for p in ps),
            _nbytes(*acts, *(p[k] for p in ps for k in keys)), dt)


def _ffn_work(x, p, dt, acts):
    """FLOPs (16 P C^2 + 72 P C, `ops/flops.py`), bytes and peak type of
    one kernel B call."""
    from hrfuser_tpu_torch.ops.flops import cross_ffn_flops
    keys = ['ln', 'b1', 'wdw', 'bdw', 'b2']
    keys += ['w1_p', 'w2_p'] if dt == torch.bfloat16 else ['w1', 'w2']
    return (cross_ffn_flops(x.shape, p['w1'].shape[1]),
            _nbytes(*acts, *(p[k] for k in keys)), dt)


def _roi_work(feats, rois, out, sample_num=2, max_grid=4, aligned=True):
    """FLOPs (2 per channel of each of the 4 taps of each sample, float32,
    counted from the RoIs' own grids: `sample_num` squared a bin, or in
    the adaptive mode each RoI's ceil(bin) counts), bytes, float32 and
    pixels of one kernel C call. The bytes are its output, its RoIs and
    the pyramid pixels whose taps these RoIs weight non-zero, each
    counted once (on the device)."""
    from hrfuser_tpu_torch.ops.roi_align import (_bilinear, _sample_coords,
                                                 map_roi_levels)
    b, n, _ = rois.shape
    c, dev = feats[0].shape[-1], rois.device
    lvl = map_roi_levels(rois, 4)
    hs = torch.tensor([f.shape[1] for f in feats], device=dev)
    ws = torch.tensor([f.shape[2] for f in feats], device=dev)
    starts = torch.cumsum(b * hs * ws, 0) - b * hs * ws  # level offsets
    scale = torch.tensor([1.0 / s for s in (4, 8, 16, 32)],
                         device=dev)[lvl]
    xs, ys, wx, wy = _sample_coords(rois, scale, 7, sample_num, aligned,
                                    max_grid)
    samples = int(((wy > 0).sum(-1) * (wx > 0).sum(-1)).sum())  # a bin
    fh, fw = hs[lvl], ws[lvl]
    pixels = 0
    for i in range(b):
        taps = []
        for coord, wgt, size in ((xs[i], wx[i], fw[i]), (ys[i], wy[i],
                                                          fh[i])):
            lo, hi, wl, wh = _bilinear(coord, size)
            per = wgt[:, None, :].expand(n, 7, wgt.shape[-1]).reshape(n, -1)
            taps.append((torch.stack([lo, hi], -1),
                         torch.stack([wl, wh], -1) * per[..., None]))
        (xt, xw), (yt, yw) = taps                        # [N, 7g, 2]
        base = starts[lvl[i]] + i * fh[i] * fw[i]                   # [N]
        idx = (base[:, None, None, None, None]
               + yt[:, :, :, None, None] * fw[i][:, None, None, None, None]
               + xt[:, None, None])
        wt = yw[:, :, :, None, None] * xw[:, None, None]
        pixels += torch.unique(idx[wt != 0]).numel()
    nbytes = (pixels * c * feats[0].element_size() + _nbytes(rois, out))
    return samples * 49 * 4 * 2 * c, nbytes, torch.float32, pixels


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

    def add(self, name, source, replaces, err, ms=None, plain_ms=None,
            bound=None):
        """`bound`: (ms, 'bytes' or 'operations') of the timed call. No
        single PyTorch call computes any of the kernels' functions
        (PERF.md gives the reasons), so `library_ms` stays null."""
        k = self.kernels.setdefault(name, dict(
            name=name, route='cuda', source=source, replaces=replaces,
            launches=0, max_abs_err=0.0, ms=None, plain_ms=None,
            bound_ms=None, bound_by=None, library_ms=None))
        k['max_abs_err'] = max(k['max_abs_err'], err)
        if ms is not None and k['ms'] is None:
            k['ms'], k['plain_ms'] = ms, plain_ms
            k['bound_ms'], k['bound_by'] = bound


def _print_time(ms, plain_ms, bound):
    print(f'    time {ms:.4f} ms, plain {plain_ms:.4f} ms, bound '
          f'{bound[0]:.4f} ms ({bound[1]}), {bound[0] / ms:.1%} of bound')


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


def _kernel_name(mangled):
    """`_ZN3hrf11name_kernelILi4ELb0EE..` -> `name_kernel<4, false>`"""
    m = re.search(r'_ZN3hrf(\d+)', mangled)
    rest = mangled[m.end():]
    name, rest = rest[:int(m.group(1))], rest[int(m.group(1)):]
    words = {'Lb0E': 'false', 'Lb1E': 'true', '13__nv_bfloat16': 'bf16',
             'f': 'f32'}
    args = []
    if rest.startswith('I'):
        for tok in re.finditer(r'Li(\d+)E|Lb[01]E|13__nv_bfloat16|f|E',
                               rest[1:]):
            if tok.group(0) == 'E':
                break
            args.append(tok.group(1) or words[tok.group(0)])
    return f'{name}<{", ".join(args)}>' if args else name


def _sass_mma_counts(path):
    """Tensor-core instructions (HMMA, HGMMA) per kernel of a library."""
    from pathlib import Path
    from hrfuser_tpu_torch.utils.cuda_build import nvcc
    sass = _run([str(Path(nvcc()).parent / 'cuobjdump'), '--dump-sass',
                 str(path)])
    counts, name = {}, None
    for line in sass.splitlines():
        if 'Function :' in line:
            name = _kernel_name(line.split('Function :')[1].strip())
            counts[name] = 0
        elif name and re.search(r'\bHG?MMA\b', line):
            counts[name] += 1
    return counts


def phase_build():
    print('== 2. build')
    from hrfuser_tpu_torch.utils import cuda_build
    info = cuda_build.build()
    cuda_build.lib()
    print(f'built {info.path.name} in {info.seconds:.1f} s')
    for line in info.log.splitlines():
        if 'registers' in line or 'spill' in line or 'Compiling' in line:
            print('  ' + line.strip())
    counts = _sass_mma_counts(info.path)
    for name, n in counts.items():
        print(f'  SASS {name}: {n} HMMA/HGMMA')
    for kernel, prefixes in (('A', ('window_attention_mma', 'window_out_mma')),
                             ('B', ('ffn_fc1_mma', 'ffn_tile_mma'))):
        n = sum(v for k, v in counts.items() if k.startswith(prefixes))
        print(f'  kernel {kernel} bf16 plan: {n} tensor-core instructions')
        if n == 0:
            raise AssertionError(f'kernel {kernel}: no HMMA/HGMMA in its '
                                 f'bf16 instantiation')


def _plans(c, heads, dt):
    """The plan the host picks for each kernel at a width and dtype."""
    from hrfuser_tpu_torch.ops import chain
    return {'window_attention_self': chain.attention_plan(c, heads, False,
                                                          dt)[0],
            'window_attention_cross': chain.attention_plan(c, heads, True,
                                                           dt)[0],
            'cross_ffn': chain.ffn_plan(c, 4 * c, dt)[0]}


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
            plans = _plans(c, heads, dt)
            for name, src, rep, fk, fp, work in (
                    ('window_attention_self', SRC_A, REPLACES_A, self_k,
                     self_p, lambda out: _attn_work(x, [p['attn']], dt,
                                                    [x, out])),
                    ('window_attention_cross', SRC_A, REPLACES_A, cross_k,
                     cross_p, lambda out: _attn_work(x, pf['attn'], dt,
                                                     [x, *z, out])),
                    ('cross_ffn', SRC_B, REPLACES_B, ffn_k, ffn_p,
                     lambda out: _ffn_work(x, p['ffn'], dt, [x, out]))):
                got = fk()
                err = _compare(f'{name} {tag} [plan {plans[name]}]', got,
                               fp(), dt)
                torch.cuda.synchronize()
                ms, plain_ms = _time_ms(fk), _time_ms(fp)
                bound = _bound(*work(got))
                _print_time(ms, plain_ms, bound)
                report.add(name, src, rep, err,
                           *((ms, plain_ms, bound) if main else ()))

    # kernel C at the r640 pyramid, 8 x 1000 RoIs with the edge cases,
    # then bf16 batches skewed onto one level
    feats32, rois = _roi_inputs(g)
    for dt in (torch.float32, torch.bfloat16):
        feats = [f.to(dt).contiguous() for f in feats32]
        _roi_case(report, f'r640 C=256 {BATCH}x{rois.shape[1]} '
                  f'{str(dt)[6:]}', feats, rois, dt,
                  record=dt == torch.bfloat16)
    for level in (0, 3):
        _roi_case(report, f'r640 C=256 {BATCH}x1000 bfloat16, every RoI on '
                  f'level {level}', feats, _skewed_rois(g, level),
                  torch.bfloat16)


def _roi_case(report, label, feats, rois, dt, record=False):
    """Kernel C against its twin on one batch: error, times, bytes, bound
    and device time under the profiler."""
    from hrfuser_tpu_torch.ops import roi_align

    def roi_k():
        return roi_align.multilevel_roi_align(feats, rois, (4, 8, 16, 32))

    def roi_p():
        return roi_align.multilevel_roi_align_plain(feats, rois,
                                                    (4, 8, 16, 32))

    got = roi_k()
    err = _compare(f'roi_align {label}', got, roi_p(), dt)
    ms, plain_ms = _time_ms(roi_k), _time_ms(roi_p, iters=3, warmup=1)
    flops, nbytes, peak_dt, pixels = _roi_work(feats, rois, got)
    bound = _bound(flops, nbytes, peak_dt)
    _print_time(ms, plain_ms, bound)
    dev_ms = _device_ms(roi_k, 'roi_align_kernel')
    print(f'    moves {nbytes / 1e6:.1f} MB (output, RoIs and the {pixels} '
          f'pyramid pixels its taps touch): {nbytes / ms / 1e6:.0f} GB/s; '
          f'device time under torch.profiler '
          + ('not measured' if dev_ms is None else f'{dev_ms:.4f} ms'))
    report.add('roi_align', SRC_C, REPLACES_C, err,
               *((ms, plain_ms, bound) if record else ()))


def _skewed_rois(g, level):
    """8 x 1000 RoIs inside the image, every one on FPN level 0 (sides of
    4-110 px) or 3 (530-640 x 380-384 px)."""
    from hrfuser_tpu_torch.ops.roi_align import map_roi_levels
    lo, hi = {0: ([4., 4.], [110., 110.]),
              3: ([530., 380.], [640., 384.])}[level]
    lo, hi = torch.tensor(lo), torch.tensor(hi)
    wh = lo + torch.rand((BATCH, 1000, 2), generator=g) * (hi - lo)
    xy = torch.rand((BATCH, 1000, 2), generator=g) * (torch.tensor([W, H])
                                                      - wh)
    rois = torch.cat([xy, xy + wh], -1).cuda().contiguous()
    if not bool((map_roi_levels(rois, 4) == level).all()):
        raise AssertionError(f'skewed RoIs are not all on level {level}')
    return rois


def _roi_inputs(g, hw=(H, W)):
    """The pyramid of an `hw` grid (C = 256; r640 unless asked) and 8 x
    1000 RoIs with the edge cases."""
    h, w = hw
    feats32 = [torch.randn((BATCH, h // s, w // s, 256), generator=g).cuda()
               for s in (4, 8, 16, 32)]
    n = 1000
    xy = torch.rand((BATCH, n, 2), generator=g) * torch.tensor([w, h]) - 20
    wh = torch.rand((BATCH, n, 2), generator=g) ** 2 * torch.tensor([w, h])
    rois = torch.cat([xy, xy + wh + 1], -1)
    rois[:, :100] = 0.0                                  # padded proposals
    rois[:, 100:150] = torch.tensor([0., 40., w, 43.])   # full-width slivers
    rois[:, 150:200] = torch.tensor([-80., -60., -5., -2.])      # outside
    rois[:, 200:250] = torch.tensor([w - 10., h - 10., w + 50., h + 40.])
    return feats32, rois.cuda().contiguous()


def _check(report, name, src, rep, label, fk, fp, dt, work):
    """Hold a kernel call to its twin; time both beside the call's bound,
    from `work(out)` -> (FLOPs, bytes, peak type)."""
    got = fk()
    err = _compare(label, got, fp(), dt)
    torch.cuda.synchronize()
    _print_time(_time_ms(fk), _time_ms(fp), _bound(*work(got)))
    report.add(name, src, rep, err)


def phase_kernels_wide(report):
    print('== 3b. HRFuser-B widths and the block / window / variant entries')
    from hrfuser_tpu_torch.layers.attention import (HRFormerBlock,
                                                    HRFuserFusionBlock)
    from hrfuser_tpu_torch.layers.common import layer_norm
    from hrfuser_tpu_torch.ops import (block, chain, roi_align,
                                       window_attention)
    from hrfuser_tpu_torch.ops.flops import (cross_ffn_flops,
                                             window_attention_flops)
    from hrfuser_tpu_torch.ops.window import window_partition
    g = torch.Generator().manual_seed(2)
    for (h, w, c, heads) in ((96, 160, 78, 2), (48, 80, 156, 4),
                             (24, 40, 312, 8), (12, 20, 624, 16)):
        for dt in (torch.float32, torch.bfloat16):
            print(f'  plans at C={c}, {heads} heads, {str(dt)[6:]}: kernel A '
                  f'self {chain.attention_plan(c, heads, False, dt)}, cross '
                  f'{chain.attention_plan(c, heads, True, dt)} (plan, chunk, '
                  f'bytes); kernel B {chain.ffn_plan(c, 4 * c, dt)} (plan, '
                  f'rows, chunk, bytes)')
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
            plans = _plans(c, heads, dt)

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

            def windows_work(out):
                return (window_attention_flops((xw.shape[0], 7, 7, c)),
                        _nbytes(xw, yw, out, *wts, bias), dt)

            for name, src, rep, label, fk, fp, plan, work in (
                    ('window_attention_self', SRC_A, REPLACES_A, 'self',
                     lambda: chain.window_self_attention(x, p['attn'], heads),
                     lambda: chain.window_attention_plain(x, x, p['attn'],
                                                          heads),
                     plans['window_attention_self'],
                     lambda out: _attn_work(x, [p['attn']], dt, [x, out])),
                    ('window_attention_cross', SRC_A, REPLACES_A,
                     'cross x2', cross_k, cross_p,
                     plans['window_attention_cross'],
                     lambda out: _attn_work(x, pf['attn'], dt,
                                            [x, *z, out])),
                    ('window_attention_self', SRC_A, REPLACES_A,
                     f'windows [{xw.shape[0]}, 49, {c}] cross',
                     lambda: window_attention.fused_window_attention(
                         xw, yw, *wts, bias, heads),
                     lambda: window_attention.fused_window_attention_plain(
                         xw, yw, *wts, bias, heads),
                     plans['window_attention_cross'], windows_work),
                    ('cross_ffn', SRC_B, REPLACES_B, 'ffn',
                     lambda: chain.cross_ffn(x, p['ffn']),
                     lambda: chain.cross_ffn_plain(x, p['ffn']),
                     plans['cross_ffn'],
                     lambda out: _ffn_work(x, p['ffn'], dt, [x, out]))):
                _check(report, name, src, rep,
                       f'{name} {label} {tag} [plan {plan}]', fk, fp, dt,
                       work)

    # rows 4 and 5: the block entries at test_pallas_block.py's shapes
    for (h, w, c, heads) in ((20, 26, 18, 1), (13, 12, 36, 2),
                             (12, 20, 144, 8), (12, 20, 624, 16)):
        blk = _randomize(HRFormerBlock(c, heads), g).cuda()
        fus = _randomize(HRFuserFusionBlock(c, heads, 2), g).cuda()
        x = torch.randn((BATCH, h, w, c), generator=g).cuda()
        zs = [torch.randn((BATCH, h, w, c), generator=g).cuda()
              for _ in range(2)]
        tag = f'{h}x{w}x{c} heads={heads} B={BATCH} float32'
        # the model's FLOPs of one attention half and of the CrossFFN half
        attn_flops = window_attention_flops((BATCH, h, w, c), padded=False)
        ffn_flops = cross_ffn_flops((BATCH, h, w, c), 4 * c)
        with torch.no_grad():
            _check(report, 'window_attention_self', SRC_A, REPLACES_A,
                   f'block.fused_hrformer_block {tag}',
                   lambda: block.fused_hrformer_block(x, blk,
                                                      num_heads=heads),
                   lambda: blk(x), torch.float32,
                   lambda out: (attn_flops + ffn_flops,
                                _nbytes(x, out, *blk.parameters()),
                                torch.float32))
            _check(report, 'window_attention_cross', SRC_A, REPLACES_A,
                   f'block.fused_fusion_block {tag}',
                   lambda: block.fused_fusion_block(x, zs, fus,
                                                    num_heads=heads),
                   lambda: fus(x, zs), torch.float32,
                   lambda out: (2 * attn_flops + ffn_flops,
                                _nbytes(x, *zs, out, *fus.parameters()),
                                torch.float32))

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
                   roi_p, dt,
                   lambda out: _roi_work([f[None] for f in feats], rois[:1],
                                         out)[:3])


def phase_kernels_r1248(report):
    print('== 3c. kernels vs plain twins at the STF r1248 map shapes')
    from hrfuser_tpu_torch.layers.attention import (HRFormerBlock,
                                                    HRFuserFusionBlock)
    from hrfuser_tpu_torch.ops import chain
    g = torch.Generator().manual_seed(3)
    for (h, w, c, heads) in ((96, 312, 18, 1), (48, 156, 36, 2),
                             (24, 78, 72, 4), (12, 39, 144, 8)):
        blk = _randomize(HRFormerBlock(c, heads), g).cuda()
        fus = _randomize(HRFuserFusionBlock(c, heads, 3), g).cuda()
        p, pf = blk.folded(), fus.folded()
        x32 = torch.randn((BATCH, h, w, c), generator=g).cuda()
        z32 = [torch.randn((BATCH, h, w, c), generator=g).cuda()
               for _ in range(3)]
        for dt in (torch.float32, torch.bfloat16):
            x, z = x32.to(dt), [t.to(dt) for t in z32]
            tag = f'{h}x{w}x{c} heads={heads} B={BATCH} {str(dt)[6:]}'
            plans = _plans(c, heads, dt)

            def cross_k():                # one launch per modality, summed
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

            for name, src, rep, label, fk, fp, work in (
                    ('window_attention_self', SRC_A, REPLACES_A, 'self',
                     lambda: chain.window_self_attention(x, p['attn'], heads),
                     lambda: chain.window_attention_plain(x, x, p['attn'],
                                                          heads),
                     lambda out: _attn_work(x, [p['attn']], dt, [x, out])),
                    ('window_attention_cross', SRC_A, REPLACES_A, 'cross x3',
                     cross_k, cross_p,
                     lambda out: _attn_work(x, pf['attn'], dt,
                                            [x, *z, out])),
                    ('cross_ffn', SRC_B, REPLACES_B, 'ffn',
                     lambda: chain.cross_ffn(x, p['ffn']),
                     lambda: chain.cross_ffn_plain(x, p['ffn']),
                     lambda out: _ffn_work(x, p['ffn'], dt, [x, out]))):
                _check(report, name, src, rep,
                       f'{name} {label} {tag} [plan {plans[name]}]', fk, fp,
                       dt, work)
    feats32, rois = _roi_inputs(g, STF_HW)
    print(f'  pyramid {[tuple(f.shape[1:3]) for f in feats32]}')
    for dt in (torch.float32, torch.bfloat16):
        feats = [f.to(dt).contiguous() for f in feats32]
        _roi_case(report, f'r1248 C=256 {BATCH}x{rois.shape[1]} '
                  f'{str(dt)[6:]}', feats, rois, dt)


def _inputs(cfg, batch, rng, hw=(H, W)):
    img = rng.normal(0., 1., (batch, *hw, 3)).astype(np.float32)
    mods = [rng.normal(0., 1., (batch, *hw, c)).astype(np.float32)
            for c in cfg.backbone.mod_in_channels]
    return img, mods


@functools.cache
def _oracle(name):
    """`tests/oracles/<name>.py`, loaded by path (`tests.oracles` does not
    import here under every runner): `card_checks` (launch counts, the
    detection and proposal matchers, weight calibration) and
    `offline_data` (the converters' synthetic inputs), shared with
    `tests/test_torch_cuda.py`."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'tests',
                        'oracles', f'{name}.py')
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _checks():
    return _oracle('card_checks')


def _expected_launches(cfg):
    """Each kernel's launches in one forward of `cfg`
    (`card_checks.expected_launches`), printed with how they add up."""
    want, how = _checks().expected_launches(cfg)
    print(f'  per forward: {how}')
    return want


def _calibrated(model, img, mods):
    """`card_checks.calibrate` on the card: BatchNorm statistics from this
    f32 input, regression layers scaled by 0.1."""
    _checks().calibrate(model, img, mods)
    print('  weights calibrated (card_checks.calibrate): BatchNorm '
          'statistics of this input, rpn_reg / fc_reg x 0.1')


def _counters():
    from hrfuser_tpu_torch.ops import chain, roi_align
    return {'window_attention_self': chain.window_self_attention,
            'window_attention_cross': chain.window_cross_attention,
            'cross_ffn': chain.cross_ffn,
            'roi_align': roi_align.multilevel_roi_align}


def _reset_counts():
    for fn in _counters().values():
        fn.launches = 0


def _check_counts(want, calls, label):
    counts = {k: fn.launches for k, fn in _counters().items()}
    print(f'  {label}: launches {counts}')
    for k, n in want.items():
        if counts[k] != calls * n:
            raise AssertionError(f'{label}: {k} launched {counts[k]} '
                                 f'times, expected {calls * n}')


def phase_slice(report, smi, config, title, record, hw=(H, W),
                calibrate=False, against_f32=False, shared=None):
    """Drive `config` as a user would on an `hw` grid; check launches and
    outputs; `shared[config]` keeps the median latency and the device busy
    ms (phase 14a). `calibrate`: weights from `card_checks.calibrate` on the
    batch. `against_f32`: the batch's bf16 neck maps held to its float32
    ones on the card within `BF16_MAP_REL` (relative L2 a level)."""
    print(f'== {title}')
    from hrfuser_tpu_torch import init_detector
    counters = _counters()
    det = init_detector(config, 'cuda', seed=0, dtype=torch.bfloat16)
    cfg = det.cfg
    img, mods = _inputs(cfg, BATCH, np.random.default_rng(0), hw)
    x = torch.from_numpy(img).cuda()
    xs = [torch.from_numpy(m).cuda() for m in mods]
    if calibrate:
        _calibrated(det.model, x, xs)
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
    per_image = out.valid.sum(1).tolist()
    print(f'  detections: {sum(per_image)} valid of {BATCH}x{m} '
          f'(per image {per_image})')
    if not sum(per_image):
        raise AssertionError('no detection in the whole batch')
    print(f'  latency per batch of {BATCH} at {hw[0]}x{hw[1]} (ms): '
          f'{", ".join(f"{t:.1f}" for t in times)}; median '
          f'{sorted(times)[len(times) // 2]:.1f} on {smi}')
    busy, wall = _busy_ms(lambda: det(img, mods))
    print(f'  under torch.profiler: {wall:.2f} ms a batch, device busy '
          + ('not measured' if busy is None else
             f'{busy:.2f} ms, idle {1 - busy / wall:.1%}'))
    if shared is not None:
        shared[config] = (sorted(times)[len(times) // 2], busy)
    if against_f32:
        with torch.no_grad():
            fb = det.model.forward_features(
                x.bfloat16(), [t.bfloat16() for t in xs])[0]
            ff = det.model.forward_features(x, xs)[0]
        for lvl, (b, f) in enumerate(zip(fb, ff, strict=True)):
            rel = ((b.float() - f).norm() / f.norm()).item()
            print(f'  bf16 vs float32 neck level {lvl}: relative L2 '
                  f'{rel:.3e} (bar {BF16_MAP_REL:g}), RMS '
                  f'{f.pow(2).mean().sqrt().item():.4g}')
            if not rel <= BF16_MAP_REL:
                raise AssertionError(f'neck level {lvl}: bf16 is {rel:.3f} '
                                     f'from float32')
    del det
    torch.cuda.empty_cache()


def phase_cpu_check(config, title, hw=(H, W), calibrate=False):
    """Batch 1 float32: the card's neck features vs the CPU's. With
    `calibrate`, the weights come from `card_checks.calibrate` on the
    card, are copied to the CPU, and `predict`'s RPN proposals and
    detections are compared too, each device's path whole."""
    print(f'== {title}: batch 1 float32 at {hw[0]}x{hw[1]}, GPU kernels '
          f'vs CPU plain twins')
    from hrfuser_tpu_torch import init_detector
    from hrfuser_tpu_torch.models import predict
    gpu = init_detector(config, 'cuda', seed=0)
    cpu = init_detector(config, 'cpu', seed=0)
    img, mods = _inputs(gpu.cfg, 1, np.random.default_rng(1), hw)
    img, mods = torch.from_numpy(img), [torch.from_numpy(m) for m in mods]
    if calibrate:
        _calibrated(gpu.model, img.cuda(), [m.cuda() for m in mods])
        cpu.model.load_state_dict(gpu.model.state_dict())
    with torch.no_grad():
        fg = gpu.model.forward_features(img.cuda(),
                                        [m.cuda() for m in mods])[0]
        t0 = time.perf_counter()
        fc = cpu.model.forward_features(img, mods)[0]
        print(f'  CPU forward {time.perf_counter() - t0:.1f} s')
    for lvl, (a, b) in enumerate(zip(fg, fc)):
        a = a.cpu()
        err = (a - b).abs().max().item()
        print(f'  neck level {lvl} {tuple(b.shape)}: max_abs_err {err:.3e}')
        if not torch.allclose(a, b, atol=5e-3, rtol=1e-3):
            raise AssertionError(f'neck level {lvl}: GPU and CPU disagree')
    if calibrate:
        _same_paths(predict, gpu, cpu, img, mods, 'predict')


def _same_paths(fn, gpu, cpu, img, mods, label):
    """`card_checks.same_runs`: `fn` on the card and on the CPU, nothing
    shared, proposals and detections of image 0 matched."""
    for what, r in _checks().same_runs(fn, gpu.model, cpu.model, img, mods,
                                       gpu.cfg, label):
        print(f'  {what}: card {r["got"]} / CPU {r["want"]} matched, max '
              f'box err {r["box"]:.3e} px, max score err {r["score"]:.3e}, '
              f'{r["at_cut"]} unmatched at a cut')


def _request(rng):
    """A raw request: 900x1600 BGR uint8 camera image and two 360x640
    uint16 projections (background 0 m, returns on 30 % of the pixels)."""
    from hrfuser_tpu_torch.data.projection import quantize
    img = rng.integers(0, 256, (*RAW_HW, 3)).astype(np.uint8)
    mods = []
    for _ in range(2):
        m = quantize(np.zeros((*GRID_HW, 3), np.float32))
        hit = rng.random(GRID_HW) < 0.3
        m[hit] = quantize(rng.uniform(-1., 60., (int(hit.sum()), 3)))
        mods.append(m)
    return img, mods


def phase_preprocess(state):
    print('== 6a. serving path: preprocessing on the card vs the CPU')
    from hrfuser_tpu_torch.data.device_pipeline import (
        make_device_preprocess, resize_image, to_device)
    img, mods = state['request'] = _request(np.random.default_rng(6))
    pre = make_device_preprocess('nuscenes', ('lidar', 'radar'))

    def run(device):
        x = resize_image(to_device(img[None], device), GRID_HW)
        return pre(x, [to_device(m[None], device) for m in mods])

    (gi, gm), (ci, cm) = run('cuda'), run('cpu')
    for label, g, c in (('camera', gi, ci), ('lidar', gm[0], cm[0]),
                        ('radar', gm[1], cm[1])):
        err = (g.cpu() - c).abs().max().item()
        ok = tuple(g.shape) == (1, 384, 640, 3) and err <= PRE_TOL
        print(f'  {label} {tuple(g.shape)}: max_abs_err {err:.3e} '
              f'(atol {PRE_TOL:g}) {"ok" if ok else "FAIL"}')
        if not ok:
            raise AssertionError(f'{label}: card and CPU preprocessing '
                                 f'disagree')


def _check_frame(boxes, label, hw=RAW_HW):
    h, w = hw
    ok = (np.isfinite(boxes).all() and (boxes >= 0).all()
          and (boxes[:, [0, 2]] <= w + 1e-3).all()
          and (boxes[:, [1, 3]] <= h + 1e-3).all())
    if not ok:
        raise AssertionError(f'{label}: boxes not finite inside the '
                             f'{w}x{h} frame')


def phase_inference_detector(state, smi):
    print('== 6b. serving path: inference_detector, HRFuser-T r640 bf16, '
          'weights from a checkpoint')
    from hrfuser_tpu_torch import inference_detector, init_detector
    from hrfuser_tpu_torch.apis.inference import (detections_of,
                                                  preprocess_request,
                                                  request_to_device)
    from hrfuser_tpu_torch.utils.checkpoint import save_checkpoint
    src = init_detector(CONFIG, 'cuda', seed=0, dtype=torch.bfloat16)
    with tempfile.TemporaryDirectory() as ckpt:
        save_checkpoint(ckpt, 0, src.model, meta={'config': CONFIG})
        det = init_detector(CONFIG, 'cuda', seed=1, dtype=torch.bfloat16,
                            checkpoint=ckpt)
    a, b = src.model.state_dict(), det.model.state_dict()
    if a.keys() != b.keys() or not all(torch.equal(a[k], b[k]) for k in a):
        raise AssertionError('checkpoint round trip changed the weights')
    print(f'  checkpoint round trip: {len(a)} tensors bit-equal')
    del src, a, b
    state['det'] = det
    img, mods = state['request']
    want = _expected_launches(det.cfg)
    for label, request in (('camera + lidar + radar', (img, mods)),
                           ('camera only', (img,))):
        inference_detector(det, *request)                  # warm-up
        torch.cuda.synchronize()
        _reset_counts()
        out = inference_detector(det, *request)
        _check_counts(want, 1, f'one request, {label}')
        _check_frame(out['boxes'], label)
        print(f'  {label}: {len(out["boxes"])} detections, boxes inside '
              f'{RAW_HW[1]}x{RAW_HW[0]}')
    state['direct'] = inference_detector(det, img, mods)
    rows = []
    for _ in range(11):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        t0 = time.perf_counter()
        ev[0].record()
        img_t, mods_t = request_to_device(det, img, mods)
        ev[1].record()
        inputs = preprocess_request(det, img_t, mods_t)
        ev[2].record()
        out = det(*inputs)
        ev[3].record()
        detections_of(out)
        torch.cuda.synchronize()
        rows.append(((time.perf_counter() - t0) * 1e3,
                     *(ev[i].elapsed_time(ev[i + 1]) for i in range(3))))
    med = [float(np.median([r[i] for r in rows])) for i in range(4)]
    print(f'  request latency over {len(rows)} requests (ms): '
          f'{", ".join(f"{r[0]:.1f}" for r in rows)}')
    print(f'  median request {med[0]:.2f} ms: host->device copy '
          f'{med[1]:.2f}, preprocessing {med[2]:.2f}, predict {med[3]:.2f} '
          f'(CUDA events) on {smi}')
    busy, wall = _busy_ms(lambda: inference_detector(det, img, mods))
    print(f'  under torch.profiler: {wall:.2f} ms a request, device busy '
          + ('not measured' if busy is None else
             f'{busy:.2f} ms, idle {1 - busy / wall:.1%}'))


def _busy_ms(fn, calls=3, top=0):
    """(device busy ms, wall ms) per call of `fn` under `torch.profiler`:
    the union of the CUDA-side event intervals; busy is None if the
    profiler records no device activity. `top` > 0 prints the kernels
    with the most device time a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    cuda = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if top:
        per = {}
        for e in cuda:
            per[e.name] = per.get(e.name, 0) + e.time_range.elapsed_us()
        for name, us in sorted(per.items(), key=lambda kv: -kv[1])[:top]:
            print(f'    {us / 1e3 / calls:8.2f} ms  {name[:90]}')
    spans = sorted((e.time_range.start, e.time_range.end) for e in cuda)
    if not spans:
        return None, wall
    busy, end = 0, spans[0][0]
    for a, b in spans:
        busy += max(0, b - max(a, end))
        end = max(end, b)
    return busy / 1e3 / calls, wall


class _GroundTruth:
    """Seeded ground truth in the 1600x900 frame: every class at each of
    COCO's small, medium and large sizes, and two boxes near each image's
    first detections."""

    def __init__(self, results, num_classes, rng):
        self.anns = []
        for r in results:
            side = np.repeat([[20.], [60.], [200.]], num_classes, 0)
            xy = rng.uniform(0, [RAW_HW[1] - 200, RAW_HW[0] - 200],
                             (len(side), 2))
            near = r['boxes'][:2] + rng.normal(0, 4, (len(r['boxes'][:2]),
                                                      4))
            self.anns.append(dict(
                bboxes=np.concatenate([np.concatenate([xy, xy + side], 1),
                                       near]).astype(np.float32),
                labels=np.concatenate([np.tile(np.arange(num_classes), 3),
                                       r['labels'][:2]])))

    def __len__(self):
        return len(self.anns)

    def get_ann_info(self, i):
        return self.anns[i]


def phase_run_inference(state, smi):
    print('== 6c. serving path: run_inference over raw batches + '
          'evaluate_nuscenes')
    from hrfuser_tpu_torch.apis.test import (evaluate_nuscenes,
                                             evaluate_proposal_recall,
                                             run_inference)
    det = state['det']
    rng = np.random.default_rng(7)

    def batch(i):
        imgs = rng.integers(0, 256, (BATCH, *GRID_HW, 3)).astype(np.uint8)
        mods = [np.stack(m) for m in zip(*(_request(rng)[1]
                                           for _ in range(BATCH)))]
        return dict(img=imgs, mod_imgs=mods,
                    img_shapes=np.array([GRID_HW] * BATCH, np.float32),
                    scale_factors=np.full((BATCH, 4), 0.4, np.float32),
                    metas=[{'index': i * BATCH + j} for j in range(BATCH)])

    batches = [batch(i) for i in range(3)]
    run_inference(det, batches[:1], progress=False)          # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    results = run_inference(det, batches, progress=False)
    dt = time.perf_counter() - t0
    _check_counts(_expected_launches(det.cfg), len(batches),
                  f'run_inference, {len(batches)} batches of {BATCH}')
    if len(results) != len(batches) * BATCH:
        raise AssertionError(f'{len(results)} results for '
                             f'{len(batches) * BATCH} images')
    for r in results:
        _check_frame(r['boxes'], 'run_inference')
    gts = _GroundTruth(results, len(det.data.classes), rng)
    metrics = evaluate_nuscenes(results, gts, len(det.data.classes))
    metrics.update(evaluate_proposal_recall(results, gts))
    bad = [k for k, v in metrics.items() if not np.isfinite(v)]
    if bad:
        raise AssertionError(f'non-finite metrics: {bad}')
    print(f'  {len(results)} images in {dt * 1e3:.1f} ms: '
          f'{len(results) / dt:.1f} images/s on {smi}; '
          f'{sum(len(r["boxes"]) for r in results)} detections')
    print('  metrics (random weights) ' + ', '.join(
        f'{k} {metrics[k]:.4f}' for k in ('mAP', 'mAP_50', 'mAP_s',
                                          'mAP_l', 'AR@100', 'AR@1000')))


def _by_thread(fn, calls=3):
    """Host ms of `fn` on this thread, each on a fresh thread (as the
    server's handlers run), and on one long-lived worker thread."""
    from concurrent.futures import ThreadPoolExecutor

    def timed():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    main = [timed() for _ in range(calls)]
    fresh = []
    for _ in range(calls):
        box = []
        t = threading.Thread(target=lambda: box.append(timed()))
        t.start()
        t.join()
        fresh.append(box[0])
    with ThreadPoolExecutor(1) as pool:
        worker = [pool.submit(timed).result() for _ in range(calls)]
    return '; '.join(f'{k} {", ".join(f"{v:.1f}" for v in vs)}' for k, vs in
                     (('this', main), ('fresh', fresh), ('worker', worker)))


def phase_serve(state):
    print('== 6d. serving path: HTTP server on 127.0.0.1')
    from hrfuser_tpu_torch import inference_detector
    from hrfuser_tpu_torch.data.png import imdecode, imencode
    from hrfuser_tpu_torch.tools import serve
    det, (img, mods) = state['det'], state['request']
    server = serve.make_server(det, '127.0.0.1', 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f'http://127.0.0.1:{server.server_address[1]}'
    # a local server: never through a proxy the environment may name
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))

    def call(path, data=None):
        try:
            with opener.open(url + path, data=data, timeout=300) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    pngs = [imencode(img), *(imencode(m) for m in mods)]
    t0 = time.perf_counter()
    imdecode(pngs[0])
    t1 = time.perf_counter()
    for data in pngs[1:]:
        imdecode(data, unchanged=True)
    t2 = time.perf_counter()
    print(f'  PNG decode on the host: camera {(t1 - t0) * 1e3:.1f} ms, two '
          f'sensor images {(t2 - t1) * 1e3:.1f} ms')
    try:
        code, reply = call('/healthz')
        print(f'  GET /healthz: {code} {reply}')
        if (code, reply) != (200, {'status': 'ok'}):
            raise AssertionError('/healthz failed')
        body = json.dumps({'img': base64.b64encode(pngs[0]).decode(),
                           'mods': [base64.b64encode(p).decode()
                                    for p in pngs[1:]]}).encode()
        code, reply = call('/predict_multi', body)
        if code != 200:
            raise AssertionError(f'/predict_multi: {code} {reply}')
        boxes = np.asarray(reply['boxes'], np.float32).reshape(-1, 4)
        _check_frame(boxes, '/predict_multi')
        same = reply['labels'] == state['direct']['labels'].tolist()
        print(f'  POST /predict_multi ({len(body) / 1e6:.1f} MB): 200, '
              f'{len(boxes)} detections, latency_ms {reply["latency_ms"]} '
              f'(PNG decode included); labels as inference_detector: {same}')
        if not same:
            raise AssertionError('/predict_multi differs from '
                                 'inference_detector on the same request')
        again = [call('/predict_multi', body)[1]['latency_ms']
                 for _ in range(3)]
        t0 = time.perf_counter()
        req = json.loads(body)
        [base64.b64decode(v) for v in (req['img'], *req['mods'])]
        print(f'  latency_ms of 3 more requests: {again}; JSON + base64 '
              f'decode {(time.perf_counter() - t0) * 1e3:.1f} ms')
        print('  inference_detector ms by calling thread: '
              + _by_thread(lambda: inference_detector(det, img, mods)))
        _serve_jpeg(call, img)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise AssertionError('server thread did not stop')


def _serve_jpeg(call, img):
    """/predict with the request's camera as a baseline JPEG: 200, two
    JPEG kernel launches, and the detections of a PNG payload of the
    decoded pixels; a progressive JPEG gets a 400 naming the mode."""
    from hrfuser_tpu_torch.data import jpeg
    from hrfuser_tpu_torch.data.png import imencode
    enc = _oracle('jpeg_encoder')
    data = enc.encode(*enc.image_coefficients(img, 90), img.shape[:2])
    pixels = imencode(jpeg.decode_jpeg(data, 'cuda').cpu().numpy())
    jpeg.pixels.launches = 0
    code, by_jpeg = call('/predict', data)
    launches = jpeg.pixels.launches
    if code != 200:
        raise AssertionError(f'/predict with a JPEG: {code} {by_jpeg}')
    code, by_png = call('/predict', pixels)
    if code != 200:
        raise AssertionError(f'/predict with a PNG: {code} {by_png}')
    print(f'  POST /predict, camera as a {len(data) / 1e3:.0f} kB JPEG: 200, '
          f'{len(by_jpeg["labels"])} detections, latency_ms '
          f'{by_jpeg["latency_ms"]} (JPEG decode included, {launches} '
          f'JPEG kernel launches); as a {len(pixels) / 1e6:.1f} MB PNG of '
          f'the decoded pixels: latency_ms {by_png["latency_ms"]}')
    if launches != 2:
        raise AssertionError(f'a JPEG request launched the JPEG kernel '
                             f'{launches} times, expected 2')
    same = (by_jpeg['labels'] == by_png['labels']
            and np.allclose(by_jpeg['boxes'], by_png['boxes'], atol=0.01)
            and np.allclose(by_jpeg['scores'], by_png['scores'], atol=1e-4))
    print(f'  JPEG and PNG payloads of the same pixels detect the same: '
          f'{same}')
    if not same:
        raise AssertionError('the JPEG payload detects other objects than '
                             'the PNG of its pixels')
    code, reply = call('/predict', data.replace(b'\xff\xc0', b'\xff\xc2',
                                                1))
    print(f'  POST /predict with a progressive JPEG: {code} {reply}')
    if code != 400 or 'progressive' not in reply.get('error', ''):
        raise AssertionError('a progressive JPEG was not refused with 400')


def _stf_request(rng):
    """A raw STF request: a 1024x1920 BGR uint8 camera image, uint16 lidar
    (3 channels) and radar (2) projections (background 0 m, returns on
    30 % of the pixels) and a 1-channel uint16 gated image of 10-bit
    intensities."""
    from hrfuser_tpu_torch.data.projection import quantize
    img = rng.integers(0, 256, (*STF_RAW_HW, 3)).astype(np.uint8)
    mods = []
    for c in (3, 2):
        m = quantize(np.zeros((*STF_RAW_HW, c), np.float32))
        hit = rng.random(STF_RAW_HW) < 0.3
        m[hit] = quantize(rng.uniform(-1., 60., (int(hit.sum()), c)))
        mods.append(m)
    mods.append(rng.integers(0, 1024, (*STF_RAW_HW, 1)).astype(np.uint16))
    return img, mods


def _serve_request(det, request, label, frame_hw, smi):
    """One request's launch counts and frame, then its latency."""
    from hrfuser_tpu_torch import inference_detector
    inference_detector(det, *request)                      # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    out = inference_detector(det, *request)
    _check_counts(_expected_launches(det.cfg), 1, f'one request, {label}')
    _check_frame(out['boxes'], label, frame_hw)
    times = []
    for _ in range(7):
        t0 = time.perf_counter()
        inference_detector(det, *request)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f'  {label}: {len(out["boxes"])} detections inside '
          f'{frame_hw[1]}x{frame_hw[0]}; request latency (ms) '
          f'{", ".join(f"{t:.1f}" for t in times)}, median '
          f'{float(np.median(times)):.1f} on {smi}')


def _kitti_dataset(folder, results, data, rng):
    """A synthetic STF `Kitti2DDataset` pickled into `folder`: per image,
    ground truth near its first three detections taller than KITTI's
    easy gate (40 px) and one box of every class, all moved from the
    model frame into the camera frame by the eval crop's offset (so
    `gt_annos(crop=)` moves them back)."""
    import pickle
    from hrfuser_tpu_torch.data.datasets.kitti2d import Kitti2DDataset
    ch, cw, oy, ox = data.eval_on_crop
    infos = []
    for i, r in enumerate(results):
        tall = np.flatnonzero(r['boxes'][:, 3] - r['boxes'][:, 1] > 45)[:3]
        near = r['boxes'][tall] + rng.normal(0, 2, (len(tall), 4))
        k = len(data.classes)
        xy = rng.uniform(0, [cw - 200, ch - 150], (k, 2))
        rand = np.concatenate([xy, xy + rng.uniform(40, 150, (k, 2))], 1)
        names = [data.classes[c] for c in r['labels'][tall]] + list(
            data.classes)
        n = len(names)
        infos.append({'image': {'image_path': f'{i:06d}.png',
                                'image_shape': np.array(STF_RAW_HW)},
                      'annos': {'name': np.array(names),
                                'bbox': (np.concatenate([near, rand])
                                         + [ox, oy, ox, oy]).astype(
                                             np.float32),
                                'truncated': np.zeros(n),
                                'occluded': np.zeros(n)}})
    path = f'{folder}/dense_infos_test.pkl'
    with open(path, 'wb') as f:
        pickle.dump(infos, f)
    return Kitti2DDataset(path, data.classes, test_mode=True)


def phase_new_requests(smi):
    print('== 7c. request path of the new configs: camera-only and STF '
          'requests, run_inference + KITTI evaluation')
    from hrfuser_tpu_torch import get_experiment, init_detector
    from hrfuser_tpu_torch.apis.test import evaluate, run_inference
    rng = np.random.default_rng(8)
    det = init_detector(CONFIG_CAM_T, 'cuda', seed=0, dtype=torch.bfloat16)
    _serve_request(det, _request(rng)[:1], 'HRFormer-T camera only, '
                   f'{RAW_HW[0]}x{RAW_HW[1]}', RAW_HW, smi)
    del det
    det = init_detector(CONFIG_STF, 'cuda', seed=0, dtype=torch.bfloat16)
    _serve_request(det, _stf_request(rng), 'STF camera + lidar + radar + '
                   f'gated, {STF_RAW_HW[0]}x{STF_RAW_HW[1]}', STF_RAW_HW,
                   smi)
    hw = STF_HW

    def batch(i):                 # projections of -1 to 60 m, 10-bit gated
        mods = [rng.integers(19900, 26000, (BATCH, *hw, c)).astype(np.uint16)
                for c in (3, 2)]
        mods.append(rng.integers(0, 1024, (BATCH, *hw, 1)).astype(np.uint16))
        return dict(img=rng.integers(0, 256, (BATCH, *hw, 3)).astype(
                        np.uint8), mod_imgs=mods,
                    img_shapes=np.array([hw] * BATCH, np.float32),
                    scale_factors=np.ones((BATCH, 4), np.float32),
                    metas=[{'index': i * BATCH + j} for j in range(BATCH)])

    batches = [batch(i) for i in range(2)]
    run_inference(det, batches[:1], progress=False)          # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    results = run_inference(det, batches, progress=False)
    dt = time.perf_counter() - t0
    _check_counts(_expected_launches(det.cfg), len(batches),
                  f'run_inference, {len(batches)} STF batches of {BATCH}')
    for r in results:
        _check_frame(r['boxes'], 'run_inference STF', hw)
    exp = get_experiment(CONFIG_STF)
    with tempfile.TemporaryDirectory() as folder:
        metrics = evaluate(exp, results,
                           _kitti_dataset(folder, results, exp.data, rng))
    want = {f'{c}_2d_{d}' for c in exp.data.classes
            for d in ('easy', 'moderate', 'hard')} | {'mAP_2d_moderate'}
    if set(metrics) != want or not all(np.isfinite(v)
                                       for v in metrics.values()):
        raise AssertionError(f'KITTI metrics incomplete or not finite: '
                             f'{metrics}')
    print(f'  {len(results)} STF images in {dt * 1e3:.1f} ms: '
          f'{len(results) / dt:.1f} images/s on {smi}; '
          f'{sum(len(r["boxes"]) for r in results)} detections')
    print('  KITTI metrics (random weights) ' + ', '.join(
        f'{k} {v:.4f}' for k, v in sorted(metrics.items())))


def _train_setup(config, device, seed=0, no_drop=False, warmup=True,
                 remat=False, sample_num=None):
    """A training model on `device` (random weights drawn on the CPU from
    `seed`), its `TrainState` and experiment; `remat` and `sample_num`
    replace the backbone's and the RoI head's."""
    import dataclasses
    from hrfuser_tpu_torch.apis.inference import init_weights_
    from hrfuser_tpu_torch.apis.train import create_train_state
    from hrfuser_tpu_torch.configs import get_experiment
    from hrfuser_tpu_torch.configs.presets import without_drops
    from hrfuser_tpu_torch.models.detectors.cascade_rcnn import CascadeRCNN
    exp = get_experiment(config)
    if no_drop:
        exp = dataclasses.replace(exp, model=without_drops(exp.model))
    model_cfg = exp.model
    if remat:
        model_cfg = dataclasses.replace(model_cfg, backbone=dataclasses.replace(
            model_cfg.backbone, remat=True))
    if sample_num is not None:
        model_cfg = dataclasses.replace(model_cfg, roi=dataclasses.replace(
            model_cfg.roi, sample_num=sample_num))
    exp = dataclasses.replace(exp, model=model_cfg)
    sched = exp.schedule
    if not warmup:
        # the full lr from the first step: with warmup_iters 0 alone the
        # schedule stays at lr x warmup_ratio (t = min(count, 0))
        sched = dataclasses.replace(sched, warmup_iters=0, warmup_ratio=1.0)
    model = CascadeRCNN(exp.model)
    init_weights_(model, torch.Generator().manual_seed(seed))
    state = create_train_state(model.to(device), exp.optim, sched, 100)
    return state, exp


def _step_split(state, batch, gen):
    """Host-clock times of one step's parts, synchronised between them."""
    from hrfuser_tpu_torch.apis.train import apply_gradients, batch_to
    from hrfuser_tpu_torch.core.samplers import Draws
    from hrfuser_tpu_torch.layers.common import train_generator
    from hrfuser_tpu_torch.models.dense_heads.rpn_head import (
        train_proposals)
    from hrfuser_tpu_torch.models.detectors.train_loss import forward_train
    model, tb = state.model, batch_to(batch, 'cuda')

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def features():
        with train_generator(gen):
            return model.forward_features(tb['img'], tb['mod_imgs'])

    (feats, cls, reg), t_feat = timed(features)
    anchors = [torch.from_numpy(a).cuda() for a in
               model.cfg.anchor_generator().grid_anchors(
                   [tuple(f.shape[1:3]) for f in feats])]
    hw = torch.tensor([[H, W]], dtype=torch.float32, device='cuda')
    _, t_props = timed(lambda: train_proposals(cls, reg, anchors,
                                               hw.expand(len(cls[0]), 2)))
    del feats, cls, reg
    state.optimizer.zero_grad(set_to_none=True)
    losses, t_fwd = timed(lambda: forward_train(model, tb, Draws(gen)))
    _, t_bwd = timed(lambda: losses['loss'].backward())
    _, t_opt = timed(lambda: apply_gradients(state))
    print(f'  one step, synchronised between parts (ms): forward_train '
          f'{t_fwd:.1f} (alone: backbone + neck + RPN maps {t_feat:.1f}, '
          f'proposal decode + NMS {t_props:.1f}; the rest is targets and '
          f'the cascade), backward {t_bwd:.1f}, AdamW with the finite '
          f'check {t_opt:.1f}')


def phase_train(report, smi, shared):
    print(f'== 8a. training: {CONFIG}, float32, batch 3 at {H}x{W}, '
          f'reference caps, drop path live')
    from hrfuser_tpu_torch.apis.inference import Detector
    from hrfuser_tpu_torch.apis.train import train_step
    from hrfuser_tpu_torch.tools.train import (overfit_ratio,
                                               synthetic_batches)
    state, exp = _train_setup(CONFIG, 'cuda', warmup=False)
    fb = exp.model.backbone.fusion_a
    print(f'  drop path {fb.drop_path}, proj_drop {fb.proj_drop_rate}, '
          f'lr {state.schedule(0)} from the first step (the preset warms up '
          f'over {exp.schedule.warmup_iters} steps from lr x '
          f'{exp.schedule.warmup_ratio})')
    batch = next(synthetic_batches(exp, exp.schedule.samples_per_device,
                                   pool=1))
    gen = torch.Generator('cuda').manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    losses, times = [], []
    for _ in range(40):
        t0 = time.perf_counter()
        m = train_step(state, batch, gen)
        losses.append(float(m['loss']))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = {k: fn.launches for k, fn in _counters().items()}
    print(f'  kernel launches over 40 train steps: {counts}')
    if any(counts.values()):
        raise AssertionError('a train step launched an eval kernel')
    if not all(np.isfinite(losses)):
        raise AssertionError(f'non-finite loss: {losses}')
    ratio = overfit_ratio(losses)
    print(f'  loss {losses[0]:.4f} -> {losses[-1]:.4f}; last-quarter mean '
          f'/ first = {ratio:.3f} ' + ('PASS' if ratio < 0.7 else 'FAIL'))
    print('  losses: ' + ' '.join(f'{v:.3f}' for v in losses))
    if ratio >= 0.7:
        raise AssertionError(f'overfit ratio {ratio:.3f} >= 0.7')
    med = shared['synthetic_step_ms'] = float(np.median(times[4:]))
    b = exp.schedule.samples_per_device
    print(f'  ms per step (steps 5-40): median {med:.1f}, min '
          f'{min(times[4:]):.1f}, max {max(times[4:]):.1f}; '
          f'{b / med * 1e3:.2f} images/s; peak memory '
          f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {smi}')
    print('  kernels with the most device time a step:')
    busy, wall = _busy_ms(lambda: train_step(state, batch, gen), calls=2,
                          top=10)
    print(f'  under torch.profiler: {wall:.1f} ms a step, device busy '
          + ('not measured' if busy is None else
             f'{busy:.1f} ms, idle {1 - busy / wall:.1%}'))
    _step_split(state, batch, gen)

    model = state.model.eval()
    det = Detector(model, exp.data, torch.device('cuda'), torch.bfloat16)
    img, mods = _inputs(exp.model, BATCH, np.random.default_rng(0))
    _reset_counts()
    out = det(img, mods)
    torch.cuda.synchronize()
    _check_counts(_expected_launches(exp.model), 1,
                  'trained weights, eval bf16 batch of 8')
    if not (out.boxes.isfinite().all() and out.scores.isfinite().all()):
        raise AssertionError('non-finite detections from trained weights')
    import copy
    cpu = copy.deepcopy(model).cpu()
    img, mods = _inputs(exp.model, 1, np.random.default_rng(1))
    with torch.no_grad():
        fg = model.forward_features(torch.from_numpy(img).cuda(), [
            torch.from_numpy(m).cuda() for m in mods])[0]
        fc = cpu.forward_features(torch.from_numpy(img),
                                  [torch.from_numpy(m) for m in mods])[0]
    for lvl, (a, c) in enumerate(zip(fg, fc)):
        a = a.cpu()
        err = (a - c).abs().max().item()
        print(f'  trained, neck level {lvl}: card vs CPU max_abs_err '
              f'{err:.3e}')
        if not torch.allclose(a, c, atol=5e-3, rtol=1e-3):
            raise AssertionError(f'trained neck level {lvl}: card and CPU '
                                 f'disagree')
    del state, model, det, cpu
    torch.cuda.empty_cache()


def _one_step(dev, hw):
    """One train step of HRFuser-T (drop rates 0, no warmup) on `dev` from
    seed-0 weights, a fixed synthetic batch and sampler draws made on the
    CPU: (losses, gradients, params after, lr of the step)."""
    from hrfuser_tpu_torch.apis.train import apply_gradients, batch_to
    from hrfuser_tpu_torch.core.samplers import Draws
    from hrfuser_tpu_torch.models.detectors.train_loss import forward_train
    from hrfuser_tpu_torch.tools.train import synthetic_batches
    state, exp = _train_setup(CONFIG, dev, no_drop=True, warmup=False)
    model = state.model
    t0 = time.perf_counter()
    losses = forward_train(
        model, batch_to(next(synthetic_batches(exp, 2, hw, pool=1)), dev),
        Draws(torch.Generator().manual_seed(3)))
    losses['loss'].backward()
    grads = {n: p.grad.detach().cpu().clone()
             for n, p in model.named_parameters() if p.grad is not None}
    apply_gradients(state)
    print(f'  {dev}: step {time.perf_counter() - t0:.1f} s')
    return ({k: float(v.detach()) for k, v in losses.items()}, grads,
            {n: p.detach().cpu() for n, p in model.named_parameters()},
            state.schedule(0))


def phase_train_parity():
    hw = (128, 192)
    print(f'== 8b. train step, card vs CPU: HRFuser-T at {hw[0]}x{hw[1]}, '
          f'batch 2, drop rates 0, same weights, batch and draws')
    (lg, gg, pg, lr), (lc, gc, pc, _) = (_one_step('cuda', hw),
                                         _one_step('cpu', hw))
    for k in lc:
        diff = abs(lg[k] - lc[k])
        if k.endswith('acc'):        # one of 2 x 512 sampled RoIs: 1e-3
            ok, err = diff * 1024 <= 3, f'{diff * 1024:.1f} RoIs'
        else:
            ok, err = diff <= 1e-3 * abs(lc[k]), f'{diff / abs(lc[k]):.2e}'
        print(f'  {k}: card {lg[k]:.6f}, CPU {lc[k]:.6f}, {err}')
        if not ok:
            raise AssertionError(f'card vs CPU {k}: {lg[k]} vs {lc[k]}')
    if set(gg) != set(gc):
        raise AssertionError('card and CPU differ in which params get grads')
    whole = (torch.cat([(gg[n] - gc[n]).flatten() for n in gc]).norm()
             / torch.cat([gc[n].flatten() for n in gc]).norm()).item()
    floor = 1e-3 * max(g.norm().item() for g in gc.values())
    rels = sorted(((gg[n] - gc[n]).norm().item()
                   / max(gc[n].norm().item(), floor), n) for n in gc)
    print(f'  gradients: relative L2 of all {len(gc)} together {whole:.2e} '
          f'(bar 2e-2); per parameter, worst: ' + ', '.join(
              f'{n} {r:.2e}' for r, n in rels[:-4:-1]) + ' (bar 1e-1)')
    if whole > 2e-2 or rels[-1][0] > 1e-1:
        raise AssertionError('card vs CPU gradients')
    # a gradient of opposite sign moves a param +lr on one side and -lr on
    # the other; float32 rounds the updated param to 1e-6 of its size
    step_err = max(((pg[n] - pc[n]).abs() - 1e-6 * pc[n].abs()).max().item()
                   for n in pc)
    print(f'  params after one step at lr {lr:g}: max abs difference '
          f'{step_err:.2e} beyond 1e-6 of the param (bound 2 x lr)')
    if step_err > 2 * lr:
        raise AssertionError('card vs CPU params after one step')


FIXTURES = 'tests/data'
NUS_N, STF_N = 16, 8
NUS_VAL = 'nuscenes_infos_val_mono3d.coco.json'
NUS_TRAIN = 'nuscenes_infos_train_mono3d.coco.json'
STF_TEST = ('dense_infos_test_clear.pkl', 'dense_infos_light_fog.pkl',
            'dense_infos_dense_fog.pkl', 'dense_infos_snow.pkl')
STF_SENSOR_HW = (768, 1280)          # the grid of STF's first crop


def _write_png(path, img):
    from hrfuser_tpu_torch.data.png import imwrite
    os.makedirs(os.path.dirname(path), exist_ok=True)
    imwrite(path, img)


def _projection(rng, hw, c):
    """uint16 projection: 0 m background, returns of -1 to 60 m on 30 % of
    the pixels, quantized as the converters do."""
    from hrfuser_tpu_torch.data.projection import quantize
    m = quantize(np.zeros((*hw, c), np.float32))
    hit = rng.random(hw) < 0.3
    m[hit] = quantize(rng.uniform(-1., 60., (int(hit.sum()), c)))
    return m


def _jpeg_frame(rng, hw=RAW_HW, quality=90):
    """A camera-like BGR frame (smooth ramps and noise) and its baseline
    4:2:0 JPEG from the oracle encoder (`tests/oracles/jpeg_encoder.py`),
    as nuScenes' camera frames are stored."""
    enc = _oracle('jpeg_encoder')
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 200 / w, yy * 200 / h, (xx + yy) * 100 / (h + w)],
                   -1) + rng.integers(0, 40, (h, w, 3))
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img, enc.encode(*enc.image_coefficients(img, quality), hw)


# a JPEG frame's pixel work, counted from the kernel's arithmetic: an
# 8x8 block's dequantisation and two 8-point passes (8 x (16 + 82) +
# 8 x (82 + 24) integer operations), a pixel's sample fetch (8 a
# full-size component, 40 a fancy-upsampled one) and colour conversion
# and store (18); the card's integer rate is taken as its float32
# CUDA-core peak (the measurement table has no integer rate)
JPEG_OPS_BLOCK, JPEG_OPS_FULL, JPEG_OPS_FANCY, JPEG_OPS_PIXEL = 1632, 8, 40, 18


def _jpeg_work(frame, coefs, out):
    """(operations, bytes) of one frame through the kernel: the
    coefficients and tables read once, the BGR written once."""
    ops = JPEG_OPS_BLOCK * sum(frame.blocks)
    per_pixel = JPEG_OPS_PIXEL + sum(
        JPEG_OPS_FULL if frame.expand(i) == (1, 1) else JPEG_OPS_FANCY
        for i in range(len(frame.comps)))
    ops += per_pixel * frame.height * frame.width
    return ops, _nbytes(coefs, out)


def phase_decoders(report, smi):
    print('== 9a. data slice: image decoders')
    from hrfuser_tpu_torch.data import jpeg
    from hrfuser_tpu_torch.data.pipelines.loading import imread
    want = np.load(f'{FIXTURES}/decoded_cv2.npz')
    for name, flag, key in (('camera.png', 'color', 'camera_png'),
                            ('grey.png', 'grayscale', 'grey_png'),
                            ('sensor16.png', 'unchanged', 'sensor16_png')):
        got = imread(f'{FIXTURES}/{name}', flag)
        if got.dtype != want[key].dtype or not np.array_equal(got,
                                                              want[key]):
            raise AssertionError(f'{name}: differs from its cv2 decode')
        print(f'  {name} ({flag}) {got.shape} {got.dtype}: bit-equal to '
              f'its committed cv2 decode')
    rng = np.random.default_rng(9)
    with tempfile.TemporaryDirectory() as folder:
        for label, img, flag in (
                ('8-bit colour 900x1600', rng.integers(
                    0, 256, (*RAW_HW, 3)).astype(np.uint8), 'color'),
                ('8-bit grey 768x1280', rng.integers(
                    0, 256, STF_SENSOR_HW).astype(np.uint8), 'grayscale'),
                ('16-bit 3-channel 360x640', _projection(rng, GRID_HW, 3),
                 'unchanged')):
            path = f'{folder}/x.png'
            _write_png(path, img)
            t0 = time.perf_counter()
            got = imread(path, flag)
            ms = (time.perf_counter() - t0) * 1e3
            if got.dtype != img.dtype or not np.array_equal(got, img):
                raise AssertionError(f'PNG round trip {label}')
            print(f'  PNG round trip {label}: bit-equal, read in '
                  f'{ms:.1f} ms')

    # JPEG: the committed cv2-written fixtures through imread (the host's
    # Huffman decoding, the kernel on the card), bit-equal to cv2; the
    # kernel against its twin on the same coefficients on the card
    streams = {}
    for key in sorted(k for k in want.files if k.endswith('jpg')
                      or k.startswith('jpeg_')):
        name = 'camera.jpg' if key == 'camera_jpg' else f'{key}.jpg'
        got = imread(f'{FIXTURES}/{name}')
        if not np.array_equal(got, want[key]):
            raise AssertionError(f'{name}: differs from its cv2 decode')
        with open(f'{FIXTURES}/{name}', 'rb') as f:
            streams[name] = f.read()
        print(f'  {name} {got.shape}: bit-equal to its committed cv2 decode')
    img, data = _jpeg_frame(rng)
    streams['oracle encoder 900x1600 4:2:0 q90'] = data
    err = 0
    for label, stream in streams.items():
        frame, coefs = jpeg.decode_coefficients(stream)
        c = torch.from_numpy(coefs).cuda()
        got, plain = jpeg.pixels(c, frame), jpeg.pixels_plain(c, frame)
        torch.cuda.synchronize()
        diff = (got.int() - plain.int()).abs().max().item()
        err = max(err, diff)
        if diff:
            raise AssertionError(f'{label}: the JPEG kernel differs from '
                                 f'its twin by {diff}')
    print(f'  JPEG kernel vs pixels_plain on the card, {len(streams)} '
          f'streams (the fixtures and the 900x1600 frame): bit-equal')
    frame, coefs = jpeg.decode_coefficients(data)
    decoded = jpeg.decode_jpeg(data, 'cuda')
    # the frame's +-20 noise, through 4:2:0 chroma and quality 90, comes
    # back within 8.4 on average (the CPU decode of these bytes)
    loss = (decoded.float() - torch.from_numpy(img).cuda().float()).abs(
        ).mean().item()
    print(f'  the 900x1600 frame decodes within {loss:.2f} of its image on '
          f'average')
    if loss > 12:
        raise AssertionError('the 900x1600 frame decodes far from the '
                             'image it encodes')
    c = torch.from_numpy(coefs).cuda()
    entropy = _host_ms(lambda: jpeg.decode_coefficients(data))
    copy_ms = _time_ms(lambda: torch.from_numpy(coefs).to('cuda'))
    ms = _time_ms(lambda: jpeg.pixels(c, frame), iters=50)
    plain_ms = _time_ms(lambda: jpeg.pixels_plain(c, frame), iters=5,
                        warmup=1)
    ops, nbytes = _jpeg_work(frame, c, decoded)
    bound = max((nbytes / HBM_BYTES_PER_S * 1e3, 'bytes'),
                (ops / PEAK_FLOPS[torch.float32] * 1e3, 'operations'))
    whole = _host_ms(lambda: jpeg.decode_jpeg(data, 'cuda'))
    with tempfile.TemporaryDirectory() as folder:
        with open(f'{folder}/x.jpg', 'wb') as f:
            f.write(data)
        _write_png(f'{folder}/x.png', decoded.cpu().numpy())
        loader_jpeg = _host_ms(lambda: imread(f'{folder}/x.jpg'))
        loader_png = _host_ms(lambda: imread(f'{folder}/x.png'))
    print(f'  900x1600 4:2:0 frame ({len(data) / 1e3:.0f} kB, '
          f'{sum(frame.blocks)} blocks) on {smi}:')
    print(f'    host Huffman decode {_fmt(entropy)} ms; coefficient copy '
          f'{copy_ms:.3f} ms ({coefs.nbytes / 1e6:.2f} MB, CUDA events)')
    print(f'    kernel {ms:.4f} ms (2 launches, CUDA events, mean of 50), '
          f'plain twin on the card {plain_ms:.3f} ms')
    print(f'    bound {bound[0]:.4f} ms ({bound[1]}: {nbytes / 1e6:.2f} MB '
          f'at 3.35 TB/s, {ops / 1e6:.0f} M integer operations at 67 T/s), '
          f'{bound[0] / ms:.1%} of bound')
    print(f'    decode_jpeg end to end {_fmt(whole)} ms; imread of the JPEG '
          f'(side stream, copy back) {_fmt(loader_jpeg)} ms; imread of '
          f'the PNG of the same pixels {_fmt(loader_png)} ms')
    report.add('jpeg_pixels', SRC_JPEG, REPLACES_JPEG, float(err), ms,
               plain_ms, bound)


def _nus_folder(root, rng, classes):
    """`NUS_N` nuScenes samples: a 900x1600 camera JPEG (baseline 4:2:0,
    quality 90, from the oracle encoder, as nuScenes stores its frames),
    lidar `rih` and radar `riv` 360x640 projections, 2-6 boxes an image
    (one each of COCO's small, medium and large sizes, then random ones),
    visibility tokens 1-4; the json as the val and the train split."""
    images, anns, lidar, radar = [], [], [], []
    h, w = RAW_HW
    for i in range(NUS_N):
        cam = f'samples/CAM_FRONT/{i:04d}.jpg'
        os.makedirs(os.path.dirname(f'{root}/{cam}'), exist_ok=True)
        with open(f'{root}/{cam}', 'wb') as f:
            f.write(_jpeg_frame(rng)[1])
        images.append(dict(file_name=cam, id=f'tok{i}', width=w, height=h))
        sides = [20., 60., 200.] + list(rng.uniform(15, 400,
                                                    rng.integers(0, 4)))
        for j, side in enumerate(sides):
            x, y = rng.uniform(0, [w - side, h - side])
            anns.append(dict(image_id=f'tok{i}', id=100 * i + j,
                             bbox=[x, y, side, side * 0.8],
                             category_id=int(rng.integers(len(classes))),
                             iscrowd=0, visibility_token=str(j % 4 + 1)))
        for table, suffix, ch in ((lidar, 'l', 'rih'), (radar, 'r', 'riv')):
            png = f'{ch}/{i:04d}.png'
            _write_png(f'{root}/{png}', _projection(rng, GRID_HW, 3))
            table.append({'id': f'tok{i}{suffix}', ch: dict(
                file_name=png, pixel_scale_factor=100.0, shift=200.0,
                empty_channels=[])})
    coco = json.dumps(dict(
        images=images, annotations=anns, lidar_projections=lidar,
        radar_projections=radar,
        categories=[dict(id=k, name=c) for k, c in enumerate(classes)]))
    for split in (NUS_VAL, NUS_TRAIN):
        with open(f'{root}/{split}', 'w') as f:
            f.write(coco)


def _png_twin(root, twin):
    """`root`'s val split with each camera JPEG replaced by a PNG of its
    decoded pixels (the sensor folders linked): a yardstick for the
    loader."""
    from hrfuser_tpu_torch.data.pipelines.loading import imread
    with open(f'{root}/{NUS_VAL}') as f:
        coco = json.load(f)
    for img in coco['images']:
        name = img['file_name']
        img['file_name'] = name[:-4] + '.png'
        _write_png(f'{twin}/{img["file_name"]}', imread(f'{root}/{name}'))
    for ch in ('rih', 'riv'):
        os.symlink(f'{root}/{ch}', f'{twin}/{ch}')
    with open(f'{twin}/{NUS_VAL}', 'w') as f:
        json.dump(coco, f)


def _checkpoint(config, folder):
    """A checkpoint of `config`'s seed-0 random weights in `folder`."""
    from hrfuser_tpu_torch import init_detector
    from hrfuser_tpu_torch.utils.checkpoint import save_checkpoint
    det = init_detector(config, 'cpu', seed=0)
    save_checkpoint(folder, 0, det.model, meta={'config': config})
    return folder


def _launches():
    return {k: fn.launches for k, fn in _counters().items()}


def phase_dataset_eval(state, smi, report):
    print(f'== 9b. data slice: nuScenes dataset eval, {CONFIG}, bf16, batch '
          f'{BATCH}, {NUS_N} JPEG samples of {RAW_HW[0]}x{RAW_HW[1]}')
    from hrfuser_tpu_torch import get_experiment
    from hrfuser_tpu_torch.data import jpeg
    from hrfuser_tpu_torch.data.datasets.coco import CocoFusionDataset
    from hrfuser_tpu_torch.data.loader import DetDataLoader
    from hrfuser_tpu_torch.tools import test as test_cli
    exp = get_experiment(CONFIG)
    root = state['nus_root'] = tempfile.mkdtemp(prefix='nus_')
    t0 = time.perf_counter()
    _nus_folder(root, np.random.default_rng(10), exp.data.classes)
    ckpt = _checkpoint(CONFIG, f'{root}/ckpt')
    print(f'  wrote the folder and a checkpoint in '
          f'{time.perf_counter() - t0:.1f} s')
    twin = f'{root}/png_twin'
    _png_twin(root, twin)
    for label, folder in (('JPEG cameras', root), ('PNG of the same pixels',
                                                   twin)) * 2:
        ds = CocoFusionDataset(NUS_VAL, exp.data.classes, data_root=folder,
                               test_mode=True)
        t0 = time.perf_counter()
        n = sum(int(b['num_real'])
                for b in DetDataLoader(ds, exp.data, BATCH, train=False))
        dt = time.perf_counter() - t0
        print(f'  loader alone, {label}: {n} images in {dt * 1e3:.0f} ms, '
              f'{n / dt:.1f} images/s (camera decode, resize, normalize, '
              f'pad)')
    _reset_counts()
    jpeg.pixels.launches = 0
    t0 = time.perf_counter()
    metrics = test_cli.main([CONFIG, '--data-root', root, '--checkpoint',
                             ckpt, '--batch-size', str(BATCH), '--dtype',
                             'bf16', '--eval', 'bbox,proposal_fast',
                             '--out', f'{root}/metrics.json'])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    _check_counts(_expected_launches(exp.model), NUS_N // BATCH,
                  f'tools.test over {NUS_N} images')
    print(f'  JPEG kernel launches: {jpeg.pixels.launches} (2 a frame)')
    if jpeg.pixels.launches != 2 * NUS_N:
        raise AssertionError(f'the JPEG kernel launched '
                             f'{jpeg.pixels.launches} times, expected '
                             f'{2 * NUS_N}')
    report.kernels['jpeg_pixels']['launches'] = jpeg.pixels.launches
    want = {'mAP', 'mAP_50', 'mAP_75', 'mAP_s', 'mAP_m', 'mAP_l', 'AR@100',
            'AR@300', 'AR@1000'}
    bad = [k for k in want if not np.isfinite(metrics.get(k, np.nan))]
    if bad:
        raise AssertionError(f'metrics missing or not finite: {bad}')
    print(f'  whole run (detector set-up, loading, inference, evaluation): '
          f'{NUS_N} images in {dt:.2f} s, {NUS_N / dt:.1f} images/s on {smi}')
    print('  metrics (random weights) ' + ', '.join(
        f'{k} {metrics[k]:.4f}' for k in sorted(want)))
    t0 = time.perf_counter()
    test_cli.main([CONFIG, '--data-root', twin, '--checkpoint', ckpt,
                   '--batch-size', str(BATCH), '--dtype', 'bf16', '--eval',
                   'bbox,proposal_fast', '--out', f'{twin}/metrics.json'])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f'  the same run over the PNG copy: {NUS_N} images in {dt:.2f} s, '
          f'{NUS_N / dt:.1f} images/s')


def _timed_steps(run):
    """Run `run()` with `apis.train.train_step` wrapped: (ms a step in
    `train_step`, its kernel launches, ms from one step's start to the
    next's: the step plus the wait for its batch)."""
    from hrfuser_tpu_torch.apis import train as train_api
    real = train_api.train_step
    inside, launched, starts = [], [], []

    def step(*args, **kw):
        before = sum(_launches().values())
        torch.cuda.synchronize()
        starts.append(time.perf_counter())
        out = real(*args, **kw)
        torch.cuda.synchronize()
        inside.append((time.perf_counter() - starts[-1]) * 1e3)
        launched.append(sum(_launches().values()) - before)
        return out

    train_api.train_step = step
    try:
        run()
    finally:
        train_api.train_step = real
    between = list(np.diff(starts) * 1e3)
    return inside, launched, between


def phase_dataset_train(state, smi):
    print(f'== 9c. data slice: nuScenes training from the same files, '
          f'{CONFIG}, float32, batch 3, flip and modality drop live')
    from hrfuser_tpu_torch import get_experiment
    from hrfuser_tpu_torch.tools import train as train_cli
    exp = get_experiment(CONFIG)
    root, wd = state['nus_root'], f'{state["nus_root"]}/work'
    b = exp.schedule.samples_per_device
    epoch = NUS_N // b
    args = [CONFIG, '--data-root', root, '--work-dir', wd, '--log-interval',
            '1', '--eval-interval-epochs', '1', '--ckpt-interval-epochs', '1']
    _reset_counts()
    inside, launched, between = _timed_steps(
        lambda: train_cli.main(args + ['--max-iters', str(epoch)]))
    counts = _launches()
    print(f'  {len(inside)} steps (one epoch of len(loader) = {epoch}); '
          f'kernel launches inside each step: {launched}')
    if len(inside) != epoch or any(launched):
        raise AssertionError('a train step launched an eval kernel')
    with open(f'{wd}/train.log.json') as f:
        log = [json.loads(line) for line in f]
    losses = [r['loss'] for r in log if r['mode'] == 'train']
    val = [r for r in log if r['mode'] == 'val']
    if len(losses) != epoch or not np.isfinite(losses).all():
        raise AssertionError(f'train losses {losses}')
    if len(val) != 1 or not np.isfinite(val[0]['mAP']):
        raise AssertionError(f'eval hook records {val}')
    print('  losses ' + ' '.join(f'{v:.3f}' for v in losses)
          + f'; eval hook at step {val[0]["iter"]}: mAP {val[0]["mAP"]:.4f}')
    val_batches = -(-NUS_N // b)
    _check_counts(_expected_launches(exp.model), val_batches,
                  f'eval hook, {val_batches} float32 batches of {b}')
    if not os.path.exists(f'{wd}/step_{epoch}.pth'):
        raise AssertionError('no checkpoint at the end of the epoch')
    steady = inside[1:]
    print(f'  ms a step in train_step (steps 2-{epoch}): median '
          f'{np.median(steady):.1f}; from one step to the next (the wait '
          f'for the batch included): median {np.median(between[1:]):.1f}; '
          f'phase 8a synthetic step: median '
          f'{state["synthetic_step_ms"]:.1f}, on {smi}')
    _, launched, _ = _timed_steps(lambda: train_cli.main(
        args + ['--max-iters', str(epoch + 1), '--resume-from', wd]))
    with open(f'{wd}/train.log.json') as f:
        last = json.loads(f.readlines()[-1])
    if launched != [0] or last['iter'] != epoch + 1 or not os.path.exists(
            f'{wd}/step_{epoch + 1}.pth'):
        raise AssertionError(f'resume: steps {launched}, last log {last}')
    print(f'  --resume-from continued at step {epoch} to {epoch + 1}: '
          f'loss {last["loss"]:.3f}')
    shutil.rmtree(root)


def _stf_folder(root, rng, data):
    """`STF_N` STF samples: a 1024x1920 camera PNG; lidar `yzi` and radar
    `yzv` (channel 0 empty) projections and a grey gated image on the
    768x1280 grid of the first crop; per image one box of every class
    inside the eval crop, taller than KITTI's easy gate (40 px), one more
    random box and a `DontCare`; the infos as the four weather test
    splits (two samples each) and the train split."""
    ch, cw, oy, ox = data.eval_on_crop
    infos = []
    for i in range(STF_N):
        cam = f'cam_stereo_left_lut/{i:05d}.png'
        _write_png(f'{root}/{cam}', rng.integers(
            0, 256, (*STF_RAW_HW, 3)).astype(np.uint8))
        _write_png(f'{root}/gated_acc_wraped_grey/{cam}', rng.integers(
            0, 256, STF_SENSOR_HW).astype(np.uint8))
        proj = {}
        for key, c in (('lidar_projections', 'yzi'),
                       ('radar_projections', 'yzv')):
            png = f'{c}/{i:05d}.png'
            _write_png(f'{root}/{png}', _projection(rng, STF_SENSOR_HW, 3))
            proj[key] = {c: dict(file_name=png, pixel_scale_factor=100.0,
                                 shift=200.0, empty_channels=[])}
        names = list(data.classes) + [data.classes[0], 'DontCare']
        k = len(names)
        xy = rng.uniform([ox + 20, oy + 20], [ox + cw - 200, oy + ch - 170],
                         (k, 2))
        boxes = np.concatenate([xy, xy + rng.uniform([40, 50], [150, 150],
                                                     (k, 2))], 1)
        infos.append({'image': {'image_path': cam,
                                'image_shape': np.array(STF_RAW_HW)},
                      'annos': {'name': np.array(names),
                                'bbox': boxes.astype(np.float32),
                                'truncated': np.zeros(k),
                                'occluded': np.zeros(k)}, **proj})
    per = STF_N // len(STF_TEST)
    for j, split in enumerate(STF_TEST):
        with open(f'{root}/{split}', 'wb') as f:
            pickle.dump(infos[j * per:(j + 1) * per], f)
    with open(f'{root}/dense_infos_train.pkl', 'wb') as f:
        pickle.dump(infos, f)


def phase_stf_dataset(smi):
    print(f'== 9d. data slice: STF, {CONFIG_STF}, {STF_N} samples of '
          f'{STF_RAW_HW[0]}x{STF_RAW_HW[1]}: eval on the crop, then two '
          f'train steps through both crops')
    from hrfuser_tpu_torch import get_experiment
    from hrfuser_tpu_torch.tools import test as test_cli
    from hrfuser_tpu_torch.tools import train as train_cli
    exp = get_experiment(CONFIG_STF)
    with tempfile.TemporaryDirectory() as root:
        _stf_folder(root, np.random.default_rng(11), exp.data)
        ckpt = _checkpoint(CONFIG_STF, f'{root}/ckpt')
        _reset_counts()
        t0 = time.perf_counter()
        metrics = test_cli.main([CONFIG_STF, '--data-root', root,
                                 '--checkpoint', ckpt, '--batch-size',
                                 str(BATCH), '--dtype', 'bf16'])
        dt = time.perf_counter() - t0
        _check_counts(_expected_launches(exp.model), STF_N // BATCH,
                      f'tools.test over the {len(STF_TEST)} STF test splits')
        want = {f'{c}_2d_{d}' for c in exp.data.classes
                for d in ('easy', 'moderate', 'hard')} | {'mAP_2d_moderate'}
        if set(metrics) != want or not all(np.isfinite(v)
                                           for v in metrics.values()):
            raise AssertionError(f'KITTI metrics incomplete or not finite: '
                                 f'{metrics}')
        print(f'  {STF_N} images in {dt:.2f} s ({STF_N / dt:.1f} images/s, '
              f'set-up and loading included) on {smi}; KITTI (random '
              f'weights) ' + ', '.join(f'{k} {v:.4f}'
                                       for k, v in sorted(metrics.items())))
        inside, launched, _ = _timed_steps(lambda: train_cli.main([
            CONFIG_STF, '--data-root', root, '--work-dir', f'{root}/work',
            '--max-iters', '2', '--log-interval', '1']))
        with open(f'{root}/work/train.log.json') as f:
            losses = [json.loads(line)['loss'] for line in f]
        if launched != [0, 0] or not np.isfinite(losses).all():
            raise AssertionError(f'STF train: launches {launched}, losses '
                                 f'{losses}')
        print(f'  two train steps at batch '
              f'{exp.schedule.samples_per_device}: losses '
              + ' '.join(f'{v:.3f}' for v in losses)
              + f', {", ".join(f"{t:.0f}" for t in inside)} ms, no kernel '
              f'launch')


def phase_hrnet_modules():
    """One HRNet-W18 stage-4 `HRModule` (four BASIC branches of four
    blocks, widths 18-144, the conv fuse paths: nearest upsample by 2, 4
    and 8, stride-2 conv chains) on the card in float32 and bf16 vs the
    CPU in float32, at r640's branch shapes and at an odd grid where
    every up path takes the bilinear fallback (95x159: the 2x upsample of
    48x80 is 96x160). Each branch's max error is held to `TOL` of its
    largest value: four residual blocks and a sum of four paths carry a
    bf16 rounding of the maps' largest values to every element."""
    print('== 10a modules. HRNet-W18 stage-4 HRModule (BasicBlock, BN '
          'folds, FuseUp, fuse_down): card float32 / bf16 vs CPU float32')
    from hrfuser_tpu_torch.configs import get_config
    from hrfuser_tpu_torch.models.backbones.hr_modules import HRModule
    stage = get_config(CONFIG_HRNET).backbone.stage4
    cpu = _randomize(HRModule(stage), torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    for hw in ((H // 4, W // 4), (95, 159)):
        shapes, (h, w) = [], hw
        for c in stage.num_channels:
            shapes.append((2, h, w, c))
            h, w = (h + 1) // 2, (w + 1) // 2
        xs = [torch.randn(s, generator=g) for s in shapes]
        with torch.no_grad():
            want = cpu(xs)
            gpu = _randomize(HRModule(stage), torch.Generator().manual_seed(
                0)).cuda()
            for dt in (torch.float32, torch.bfloat16):
                got = gpu([x.cuda().to(dt) for x in xs])
                for i, (a, b) in enumerate(zip(got, want, strict=True)):
                    err = (a.float().cpu() - b).abs().max().item()
                    top = b.abs().max().item()
                    print(f'  {dt} branch {i} {tuple(b.shape)}: max_abs_err '
                          f'{err:.3e}, largest value {top:.3g} (bar '
                          f'{TOL[dt]:g} of it)')
                    if not err <= TOL[dt] * top:
                        raise AssertionError(f'HRModule branch {i}, {dt}: '
                                             f'card and CPU disagree')


def phase_hrnet_train(smi, steps=40):
    """HRNet-W18 training from calibrated weights (`card_checks.calibrate`
    on the batch), then the trained weights serve the images they were
    trained on, which must hold detections: the steps are as many as
    phase 8a takes, since a few leave the cascade calling every RoI
    background."""
    print(f'== 10c. training: {CONFIG_HRNET}, float32, batch 3 at {H}x{W}, '
          f'{steps} steps, reference caps, fusion drop path live')
    from hrfuser_tpu_torch.apis.inference import Detector
    from hrfuser_tpu_torch.apis.train import train_step
    from hrfuser_tpu_torch.tools.train import overfit_ratio, synthetic_batches
    state, exp = _train_setup(CONFIG_HRNET, 'cuda', warmup=False)
    batch = next(synthetic_batches(exp, exp.schedule.samples_per_device,
                                   pool=1))
    _calibrated(state.model, torch.from_numpy(batch['img']).cuda(),
                [torch.from_numpy(m).cuda() for m in batch['mod_imgs']])
    state.model.train()
    gen = torch.Generator('cuda').manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        m = train_step(state, batch, gen)
        losses.append(float(m['loss']))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = {k: fn.launches for k, fn in _counters().items()}
    print(f'  kernel launches over {steps} train steps: {counts}')
    if any(counts.values()):
        raise AssertionError('an HRNet train step launched an eval kernel')
    if not all(np.isfinite(losses)):
        raise AssertionError(f'non-finite loss: {losses}')
    med = float(np.median(times[2:]))
    b = exp.schedule.samples_per_device
    print('  losses: ' + ' '.join(f'{v:.3f}' for v in losses))
    print(f'  overfit ratio (mean of the last quarter over the first): '
          f'{overfit_ratio(losses):.3f}')
    print(f'  ms per step (steps 3-{steps}): median {med:.1f}, min '
          f'{min(times[2:]):.1f}, max {max(times[2:]):.1f}; '
          f'{b / med * 1e3:.2f} images/s; peak memory '
          f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {smi}')
    busy, wall = _busy_ms(lambda: train_step(state, batch, gen), calls=2)
    print(f'  under torch.profiler: {wall:.1f} ms a step, device busy '
          + ('not measured' if busy is None else
             f'{busy:.1f} ms, idle {1 - busy / wall:.1%}'))
    det = Detector(state.model.eval(), exp.data, torch.device('cuda'),
                   torch.bfloat16)
    pick = np.arange(BATCH) % b                  # the trained images, cycled
    img, mods = batch['img'][pick], [m[pick] for m in batch['mod_imgs']]
    _reset_counts()
    out = det(img, mods)
    torch.cuda.synchronize()
    _check_counts(_expected_launches(exp.model), 1,
                  f'trained weights, eval bf16 batch of {BATCH} (the '
                  f'{b} trained images, cycled)')
    if not (out.boxes.isfinite().all() and out.scores.isfinite().all()):
        raise AssertionError('non-finite detections from trained weights')
    hits = 0
    for i in range(BATCH):
        v = out.valid[i].cpu().numpy()
        boxes = out.boxes[i].float().cpu().numpy()[v]
        labels = out.labels[i].cpu().numpy()[v]
        for gt, lb in zip(batch['gt_boxes'][pick[i]],
                          batch['gt_labels'][pick[i]]):
            lt = np.maximum(boxes[:, :2], gt[:2])
            rb = np.minimum(boxes[:, 2:], gt[2:])
            inter = np.prod(np.clip(rb - lt, 0, None), 1)
            union = (np.prod(boxes[:, 2:] - boxes[:, :2], 1)
                     + np.prod(gt[2:] - gt[:2]) - inter)
            hits += int(((inter / union >= 0.5) & (labels == lb)).sum())
    per_image = out.valid.sum(1).tolist()
    print(f'  served: {sum(per_image)} detections (per image {per_image}), '
          f'{hits} of them at IoU >= 0.5 with a trained box of their label')
    if not sum(per_image):
        raise AssertionError('the trained weights detect nothing')
    del state, det
    torch.cuda.empty_cache()


def phase_tta(smi):
    print(f'== 10d. flip TTA on HRFuser-T r640: bf16 batches of {BATCH}, '
          f'then batch 1 float32 card vs CPU at {TTA_CPU_HW[0]}x'
          f'{TTA_CPU_HW[1]}')
    from hrfuser_tpu_torch import init_detector
    from hrfuser_tpu_torch.models import (predict_aug_test_flip,
                                          predict_tta_flip)
    fns = (predict_tta_flip, predict_aug_test_flip)
    det = init_detector(CONFIG, 'cuda', seed=0, dtype=torch.bfloat16)
    cfg = det.cfg
    img, mods = _inputs(cfg, BATCH, np.random.default_rng(0))
    x = torch.from_numpy(img).cuda()
    ms = [torch.from_numpy(m).cuda() for m in mods]
    _calibrated(det.model, x, ms)
    x, ms = x.bfloat16(), [m.bfloat16() for m in ms]
    for fn in fns:
        with torch.no_grad():
            fn(det.model, x, ms)                           # warm-up
            torch.cuda.synchronize()
            _reset_counts()
            calls, times = 3, []
            for _ in range(calls):
                t0 = time.perf_counter()
                out = fn(det.model, x, ms)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            _check_counts(_checks().tta_launches(cfg, fn.__name__), calls,
                          f'{fn.__name__}, {calls} batches')
            busy, wall = _busy_ms(lambda: fn(det.model, x, ms))
        m = cfg.roi.max_per_img
        if tuple(out.boxes.shape) != (BATCH, m, 4):
            raise AssertionError(f'{fn.__name__}: boxes {out.boxes.shape}')
        for i in range(BATCH):
            v = out.valid[i]
            _check_frame(out.boxes[i][v].float().cpu().numpy(),
                         fn.__name__, (H, W))
        per_image = out.valid.sum(1).tolist()
        if not sum(per_image):
            raise AssertionError(f'{fn.__name__}: no detection')
        print(f'  {fn.__name__}: {sum(per_image)} valid of {BATCH}x{m} '
              f'(per image {per_image}), boxes inside {W}x{H}; latency per '
              f'batch (ms) {", ".join(f"{t:.1f}" for t in times)}, median '
              f'{sorted(times)[1]:.1f} on {smi}')
        print(f'    under torch.profiler: {wall:.2f} ms a batch, device '
              'busy ' + ('not measured' if busy is None else
                         f'{busy:.2f} ms, idle {1 - busy / wall:.1%}'))
    del det
    gpu = init_detector(CONFIG, 'cuda', seed=0)
    cpu = init_detector(CONFIG, 'cpu', seed=0)
    img, mods = _inputs(cfg, 1, np.random.default_rng(1), TTA_CPU_HW)
    img, mods = torch.from_numpy(img), [torch.from_numpy(m) for m in mods]
    _calibrated(gpu.model, img.cuda(), [m.cuda() for m in mods])
    cpu.model.load_state_dict(gpu.model.state_dict())
    for fn in fns:
        _same_paths(fn, gpu, cpu, img, mods, fn.__name__)
    del gpu, cpu
    torch.cuda.empty_cache()


def _stage_d_extra(bb):
    """A reference-style `extra` dict of backbone `bb` with a modality
    stage D (stage C's dict) and a fusion bank D (fusion C's)."""
    import dataclasses
    d = dataclasses.asdict
    return dict(stage1=d(bb.stage1), stage2=d(bb.stage2),
                stage3=d(bb.stage3), stage4=d(bb.stage4),
                LidarStageA=d(bb.stage_a), LidarStageB=d(bb.stage_b),
                LidarStageC=d(bb.stage_c), LidarStageD=d(bb.stage_c),
                ModFusionA=d(bb.fusion_a), ModFusionB=d(bb.fusion_b),
                ModFusionC=d(bb.fusion_c), ModFusionD=d(bb.fusion_c))


def phase_stage_d():
    print(f'== 10e. pre-neck fusion stage D at HRFuser-T widths '
          f'(backbone_cfg_from_extra): batch 1 float32 at {H}x{W}, card vs '
          f'CPU, launch counts')
    import copy
    import dataclasses
    from hrfuser_tpu_torch.apis.inference import init_weights_
    from hrfuser_tpu_torch.configs import get_config
    from hrfuser_tpu_torch.models import (CascadeRCNN,
                                          backbone_cfg_from_extra, predict)
    ref = get_config(CONFIG)
    bb = backbone_cfg_from_extra(_stage_d_extra(ref.backbone),
                                 ref.backbone.num_fused_modalities,
                                 ref.backbone.mod_in_channels)
    cfg = dataclasses.replace(ref, backbone=bb)
    model = CascadeRCNN(cfg)
    init_weights_(model, torch.Generator().manual_seed(0))
    cpu = copy.deepcopy(model.eval())
    gpu = model.cuda()
    img, mods = _inputs(cfg, 1, np.random.default_rng(2))
    img, mods = torch.from_numpy(img), [torch.from_numpy(m) for m in mods]
    want = _expected_launches(cfg)
    with torch.no_grad():
        _reset_counts()
        out = predict(gpu, img.cuda(), [m.cuda() for m in mods])
        torch.cuda.synchronize()
        _check_counts(want, 1, 'stage-D model, one predict')
        if not (out.boxes.isfinite().all() and out.scores.isfinite().all()):
            raise AssertionError('stage D: non-finite detections')
        fg = gpu.forward_features(img.cuda(), [m.cuda() for m in mods])[0]
        fc = cpu.forward_features(img, mods)[0]
    for lvl, (a, c) in enumerate(zip(fg, fc, strict=True)):
        a = a.cpu()
        err = (a - c).abs().max().item()
        print(f'  neck level {lvl} {tuple(c.shape)}: max_abs_err {err:.3e}')
        if not torch.allclose(a, c, atol=5e-3, rtol=1e-3):
            raise AssertionError(f'stage D, neck level {lvl}: card and CPU '
                                 f'disagree')
    del gpu, cpu
    torch.cuda.empty_cache()


def _host_ms(fn, runs=5):
    """Median, min and max ms of `fn` over `runs` calls on the host clock,
    the card synchronised before and after each."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), min(times), max(times)


def _fmt(ms):
    return f'{ms[0]:.1f} (min {ms[1]:.1f}, max {ms[2]:.1f})'


def phase_offline_nuscenes(smi):
    print('== 11a. offline preprocessing: one synthetic nuScenes sample '
          '(34,720 lidar points, 5 radars x 125 returns, 6 cameras of '
          '1600x900 onto 640x360 grids)')
    from hrfuser_tpu_torch.data.nuscenes_export import export_2d_annotation
    from hrfuser_tpu_torch.data.pipelines.loading import imread
    from hrfuser_tpu_torch.tools.create_data import convert_sample
    db, lidar, radars = _oracle('offline_data').nuscenes_sample(seed=0)

    def run(device, mode='reference', out_dir=None):
        return convert_sample(db, db.sample, lidar, radars, out_dir,
                              device, mode)

    for mode in ('reference', 'zbuffer'):
        (_, gpu), (_, cpu) = run('cuda', mode), run('cpu', mode)
        for cam in cpu:
            for key in cpu[cam]:
                if not np.array_equal(gpu[cam][key], cpu[cam][key]):
                    raise AssertionError(f'11a {mode}: {cam} {key} card vs '
                                         f'CPU differ')
        drawn = sum(int((cpu[c][k][..., 0] != 20000).sum()) for c in cpu
                    for k in ('rih', 'riv'))
        print(f'  {mode}: 24 uint16 images card vs CPU bit-equal '
              f'({drawn} lidar + radar pixels drawn)')
    with tempfile.TemporaryDirectory() as root:
        info, gpu = run('cuda', out_dir=root)
        info_cpu, _ = run('cpu')
        for cam in gpu:
            for entry, group, key in (('lidar_img', 'rih', 'rih'),
                                      ('lidar_img', 'xz0', 'xz0'),
                                      ('radar_img', 'riv', 'riv'),
                                      ('radar_img', 'xz0', 'rxz0')):
                path = f'{root}/{info[entry][cam][group]["file_name"]}'
                if not np.array_equal(imread(path, 'unchanged'),
                                      gpu[cam][key]):
                    raise AssertionError(f'11a: PNG round trip of {path}')
        coco = export_2d_annotation(db, [info], f'{root}/card.json')
        export_2d_annotation(db, [info_cpu], f'{root}/cpu.json')
        with open(f'{root}/card.json', 'rb') as a, \
                open(f'{root}/cpu.json', 'rb') as b:
            if a.read() != b.read():
                raise AssertionError('11a: COCO json card vs CPU differ')
        print(f'  24 PNGs round trip bit-equal; COCO json identical card vs '
              f'CPU ({len(coco["images"])} images, '
              f'{len(coco["annotations"])} annotations)')
        card = _host_ms(lambda: run('cuda'))
        card_png = _host_ms(lambda: run('cuda', out_dir=root))
        cpu_ms = _host_ms(lambda: run('cpu'), runs=3)
    print(f'  ms per sample (host clock, synchronised; median of 5, CPU of '
          f'3) on {smi}: card {_fmt(card)}, with PNG encode {_fmt(card_png)}'
          f'; CPU {_fmt(cpu_ms)}; {_sync_count(lambda: run("cuda"))} '
          f'synchronising calls a sample on the card')


def _sync_count(fn):
    """The calls of `fn` that wait for the card, as
    `torch.cuda.set_sync_debug_mode` reports them."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode('default')
    return sum('synchroniz' in str(w.message) for w in caught)


def phase_offline_stf(smi):
    print('== 11b. offline preprocessing: one STF frame (110,000 HDL-64 '
          'points, 60 radar targets onto 1280x768, `project_frame`)')
    from hrfuser_tpu_torch.tools.stf_projection import project_frame
    frame = _oracle('offline_data').stf_frame(np.random.default_rng(1))
    for mode in ('reference', 'zbuffer'):
        gpu = project_frame(*frame, mode=mode, device='cuda')
        cpu = project_frame(*frame, mode=mode, device='cpu')
        if not all(np.array_equal(g, c) for g, c in zip(gpu, cpu)):
            raise AssertionError(f'11b {mode}: card vs CPU differ')
        print(f'  {mode}: yzi and yzv card vs CPU bit-equal '
              f'({int((cpu[0][..., 1] != 20000).sum())} lidar pixels, '
              f'{int((cpu[1][0, :, 1] != 20000).sum())} radar columns)')
    card = _host_ms(lambda: project_frame(*frame, device='cuda'))
    cpu_ms = _host_ms(lambda: project_frame(*frame, device='cpu'), runs=3)
    print(f'  ms per frame (host clock, synchronised; median of 5, CPU of 3) '
          f'on {smi}: card {_fmt(card)}; CPU {_fmt(cpu_ms)}')


def phase_offline_gated(smi):
    print('== 11c. offline preprocessing: the gated -> RGB depth warp of one '
          'frame (three 720x1280 10-bit slices from TIFFs, a 1024x1920 '
          'disparity, ego offset, max-accumulate, crop to 768x1280)')
    from hrfuser_tpu_torch.data import tiff
    from hrfuser_tpu_torch.tools.stf_gated_warp import warp_frame
    want = np.load(f'{FIXTURES}/decoded_tiff_cv2.npz')
    for name in ('gated16_lzw.tiff', 'grey8_lzw.tiff'):
        got = tiff.imread(f'{FIXTURES}/{name}')
        ref = want[name.replace('.', '_')]
        if got.dtype != ref.dtype or not np.array_equal(got, ref):
            raise AssertionError(f'11c: {name} differs from its cv2 decode')
        print(f'  {name} (cv2-written, LZW + predictor 2) {got.shape} '
              f'{got.dtype}: bit-equal to its committed cv2 decode')
    frame = 'f_00001'
    with tempfile.TemporaryDirectory() as root:
        slices = _oracle('offline_data').write_gated_frame(
            root, frame, np.random.default_rng(2))
        for i, img in enumerate(slices):
            if not np.array_equal(tiff.imread(
                    f'{root}/gated{i}_raw/{frame}.tiff'), img):
                raise AssertionError(f'11c: gated{i} TIFF round trip')
        print('  three uncompressed 720x1280 uint16 TIFFs round trip '
              'bit-equal')
        gpu = warp_frame(root, frame, 'cam_stereo_sgm', device='cuda')
        cpu = warp_frame(root, frame, 'cam_stereo_sgm', device='cpu')
        diff = np.abs(gpu.astype(np.int32) - cpu)
        print(f'  768x1280 uint16 card vs CPU: {int((diff > 0).sum())} '
              f'pixels differ, by at most {int(diff.max())} count '
              f'(bar: none by more than 1); {(cpu > 0).mean():.1%} of the '
              f'crop covered')
        if diff.max() > 1 or gpu.shape != (768, 1280):
            raise AssertionError('11c: card vs CPU differ')
        card = _host_ms(lambda: warp_frame(root, frame, 'cam_stereo_sgm',
                                           device='cuda'))
        cpu_ms = _host_ms(lambda: warp_frame(root, frame, 'cam_stereo_sgm',
                                             device='cpu'), runs=1)
        print(f'  uncompressed input: ms per frame (host clock, '
              f'synchronised, TIFF reads included; median of 5, CPU one '
              f'run) on {smi}: card {_fmt(card)}; CPU {cpu_ms[0]:.1f}')
        # the same slices as cv2 writes them: LZW, predictor 2, 3-row strips
        for i, img in enumerate(slices):
            with open(f'{root}/gated{i}_raw/{frame}.tiff', 'wb') as f:
                f.write(_oracle('offline_data').lzw_tiff_bytes(img, rows=3))
        path = f'{root}/gated0_raw/{frame}.tiff'
        size = os.path.getsize(path)
        if not np.array_equal(tiff.imread(path), slices[0]):
            raise AssertionError('11c: LZW TIFF round trip')
        lzw = warp_frame(root, frame, 'cam_stereo_sgm', device='cuda')
        if not np.array_equal(lzw, gpu):
            raise AssertionError('11c: LZW input warps otherwise')
        read = _host_ms(lambda: tiff.imread(path))
        card_lzw = _host_ms(lambda: warp_frame(root, frame, 'cam_stereo_sgm',
                                               device='cuda'))
        cpu_lzw = _host_ms(lambda: warp_frame(root, frame, 'cam_stereo_sgm',
                                              device='cpu'), runs=1)
    print(f'  LZW input ({size} bytes a slice, the same '
          f'crop as uncompressed): one slice read {_fmt(read)} ms; ms per '
          f'frame card {_fmt(card_lzw)}; CPU {cpu_lzw[0]:.1f}')


def phase_offline_homography(smi):
    print('== 11d. offline preprocessing: `homography_warp` of a 720x1280 '
          'gated frame onto the 768x1280 RGB crop, `homography_from_points` '
          'with 20 % outliers')
    from hrfuser_tpu_torch.data.gated_warp import (homography_from_points,
                                                   homography_warp)
    m = np.array([[1.02, 0.015, -12.5], [-0.01, 0.99, 8.25],
                  [1.5e-5, -1e-5, 1.0]])
    yy, xx = np.mgrid[0:720, 0:1280]
    img = (300 + 200 * np.sin(xx / 40.0) * np.cos(yy / 33.0)).astype(
        np.float32)
    for label, src in (('float32', torch.from_numpy(img)),
                       ('uint16-valued int32', torch.from_numpy(
                           img.astype(np.int32)))):
        gpu = homography_warp(src.cuda(), m, (1280, 768)).cpu()
        cpu = homography_warp(src, m, (1280, 768))
        diff = (gpu.double() - cpu.double()).abs()
        print(f'  {label}: card vs CPU {int((diff > 0).sum())} '
              f'pixels differ, max {diff.max().item():.3g} (bar: 1e-3 '
              f'float32, 1 count integer)')
        if diff.max().item() > (1e-3 if label == 'float32' else 1):
            raise AssertionError(f'11d {label}: card vs CPU differ')
    rng = np.random.default_rng(3)
    pts = rng.uniform(0, 1200, (40, 2))
    q = m @ np.vstack([pts.T, np.ones(40)])
    dst = (q[:2] / q[2]).T
    dst[:8] += rng.uniform(40, 90, (8, 2))
    h_gpu = homography_from_points(torch.from_numpy(pts).cuda(),
                                   torch.from_numpy(dst).cuda()).cpu()
    h_cpu = homography_from_points(pts, dst)
    err = (h_gpu - h_cpu).abs().max().item()
    truth = np.abs(h_cpu.numpy() - m).max()
    print(f'  homography_from_points: card vs CPU {err:.2e} (bar 1e-9), '
          f'{truth:.2e} from the true H')
    if err > 1e-9 or truth > 1e-6:
        raise AssertionError('11d: homography_from_points')
    src = torch.from_numpy(img).cuda()
    card = _time_ms(lambda: homography_warp(src, m, (1280, 768)), iters=10)
    cpu_ms = _host_ms(lambda: homography_warp(torch.from_numpy(img), m,
                                              (1280, 768)), runs=1)
    print(f'  homography_warp float32 on {smi}: card {card:.3f} ms '
          f'(CUDA events, mean of 10); CPU {cpu_ms[0]:.1f} ms')


PARALLEL_STEPS = 20                  # 12a: world size 1 vs train_step
PARALLEL_DEADLINE_S = 420            # a spawned rank's deadline
SHARED = '2 ranks sharing one H100'  # 12b-12d: no scaling result
EVAL_COUNTERS = {
    'window_attention_self': 'hrfuser_tpu_torch.ops.chain:'
                             'window_self_attention',
    'window_attention_cross': 'hrfuser_tpu_torch.ops.chain:'
                              'window_cross_attention',
    'cross_ffn': 'hrfuser_tpu_torch.ops.chain:cross_ffn',
    'roi_align': 'hrfuser_tpu_torch.ops.roi_align:multilevel_roi_align',
    'jpeg_pixels': 'hrfuser_tpu_torch.data.jpeg:pixels'}


def _parallel_ranks():
    """`tests/oracles/parallel_ranks.py` as a top-level module: the ranks
    `run_ranks` spawns import its functions by name, and they inherit this
    process's `sys.path`."""
    oracles = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           'tests', 'oracles')
    if oracles not in sys.path:
        sys.path.insert(0, oracles)
    import parallel_ranks
    return parallel_ranks


def _adamw_update_bound(t, betas):
    """The largest |update| / lr of AdamW's t-th step over any gradient
    history: by Cauchy-Schwarz on its moments, bias-corrected, 1 at the
    first step and 1.16 at the 20th for betas (0.9, 0.999)."""
    b1, b2 = betas
    s = sum((b1 * b1 / b2) ** k for k in range(t))
    return ((1 - b1) / np.sqrt(1 - b2) * np.sqrt(s)
            * np.sqrt(1 - b2 ** t) / (1 - b1 ** t))


def _held(m, bars, label):
    """Print a step's `parallel_ranks.mismatch` figures beside `bars`;
    raise where one is over."""
    print(f'  {label}: losses {m["losses"]:.2e} (relative; bar '
          f'{bars["losses"]:g}), accuracies {m["acc"]:.2e} (bar '
          f'{bars["acc"]:.2e}), gradients together {m["together"]:.2e} '
          f'(bar {bars["together"]:g}), worst one {m["each"]:.2e} '
          f'({m["each_name"]}; bar {bars["each"]:g}), BN statistics '
          f'{m["stats"]:.2e}, params {m["params"]:.2e} beyond 1e-6 of '
          f'their size (bar {bars["params"]:g})')
    over = [k for k in bars if m[k] > bars[k]]
    if over:
        raise AssertionError(f'{label}: {over} over their bars')


def phase_parallel_step(smi):
    pr = _parallel_ranks()
    from hrfuser_tpu_torch import get_experiment
    from hrfuser_tpu_torch.parallel.mesh import run_ranks
    exp = get_experiment(CONFIG)
    b = exp.schedule.samples_per_device
    print(f'== 12a. data-parallel train step, world size 1 on nccl: {CONFIG} '
          f'at {H}x{W}, float32, batch {b}, {PARALLEL_STEPS} steps, drop '
          f'off, the reference caps, the same draws; each step beside '
          f'`train_step` from the same weights and optimizer state')
    (got,) = run_ranks(pr.paired_train_rank, 1, (
        CONFIG, PARALLEL_STEPS, dict(device='cuda', caps={}, threads=4,
                                     deterministic=True)),
        timeout_s=PARALLEL_DEADLINE_S)
    lr = got['lr']
    worst, same = 0.0, 0
    for i, (a, w) in enumerate(zip(got['sharded'], got['plain'])):
        same += a == w
        for k, v in w.items():
            if k.endswith('acc'):
                ok = abs(a[k] - v) * b * 512 <= 3
            else:
                err = abs(a[k] - v) / max(abs(v), 1e-6)
                worst, ok = max(worst, err), err <= 1e-3
            if not ok:
                raise AssertionError(f'12a step {i + 1} {k}: sharded '
                                     f'{a[k]} vs train_step {v}')
    stats = max(got['stats'])
    # the same weights and moments before each step: a near-zero gradient
    # of opposite sign moves a param by up to one AdamW update each way
    betas = exp.optim.betas
    bars = [2 * lr * _adamw_update_bound(t + 1, betas)
            for t in range(PARALLEL_STEPS)]
    share = max(p / bar for p, bar in zip(got['params'], bars))
    print(f'  {same} of {PARALLEL_STEPS} steps\' losses bit-equal, worst '
          f'relative difference {worst:.2e} (bar 1e-3); after a step, '
          f'params at most {max(got["params"]):.2e} beyond 1e-6 of their '
          f'size, {share:.0%} of the step\'s bar (two AdamW updates: 2 x lr '
          f'at step 1, {bars[-1]:.2e} at step {PARALLEL_STEPS}), BN '
          f'statistics {stats:.2e} (bar 1e-4)'
          + ('' if max(got['params']) <= 0 and same == PARALLEL_STEPS else
             '; not bit-equal: the backward\'s atomics (HRFPN\'s bilinear '
             'upsampling) sum in another order each run'))
    if share > 1 or stats > 1e-4:
        raise AssertionError('12a: params or BN statistics over their bars')
    if got['launches']:
        raise AssertionError(f'12a: the steps launched {got["launches"]} '
                             f'eval kernels')
    print(f'  eval kernel launches in the {2 * PARALLEL_STEPS} steps: 0')
    print(f'  ms a step (steps 5-{PARALLEL_STEPS}, median, cuDNN '
          f'deterministic): sharded {np.median(got["sharded_ms"][4:]):.1f},'
          f' train_step {np.median(got["plain_ms"][4:]):.1f}; the gradient '
          f'all-reduce {np.median(got["reduce_ms"][4:]):.2f} ms over a '
          f'{got["buffer_mb"]:.1f} MB flat float32 buffer (flatten, nccl '
          f'all-reduce, views; world size 1) on {smi}')


def phase_parallel_joined(smi):
    pr = _parallel_ranks()
    from hrfuser_tpu_torch import get_experiment
    from hrfuser_tpu_torch.core.samplers import KeyedDraws
    from hrfuser_tpu_torch.parallel.mesh import run_ranks
    exp = get_experiment(CONFIG)
    print(f'== 12b. 2 ranks on the one card (gloo, CUDA tensors), global '
          f'batch 6 (3 a rank; rank 1\'s images have no valid GT), one step '
          f'against one process on the joined batch: held with a float64 '
          f'trunk, then shown in float32 beside the float32 spread of one '
          f'process on the batch in another row order')
    bars = dict(losses=1e-3, acc=3 / (6 * 512), together=2e-2, each=1e-1,
                params=2 * exp.optim.lr)
    perm = np.array([3, 4, 5, 0, 1, 2])
    for dtype in (torch.float64, torch.float32):
        t0 = time.perf_counter()
        name = str(dtype).split('.')[-1]
        batch = pr.joined_batch(6, (H, W), exp.model.backbone.mod_in_channels,
                                empty=(3, 4, 5))
        if dtype == torch.float64:
            batch = pr.in_float64(batch)
        draws = pr.RecordingDraws(KeyedDraws(100))
        want = pr.one_process_step(CONFIG, batch, draws, 'cuda', caps={},
                                   dtype=dtype)
        torch.cuda.empty_cache()
        if dtype == torch.float32:
            spread = pr.mismatch(pr.one_process_step(
                CONFIG, pr.permuted(batch, perm),
                pr.PermutedDraws(draws.table, perm), 'cuda', caps={}), want)
            torch.cuda.empty_cache()
            print(f'  {name}: one process on the batch in another row order: '
                  f'losses {spread["losses"]:.2e}, accuracies '
                  f'{spread["acc"]:.2e}, gradients together '
                  f'{spread["together"]:.2e}, worst one {spread["each"]:.2e}'
                  f', BN statistics {spread["stats"]:.2e}')
        ranks = run_ranks(pr.sharded_train_rank, 2, (
            CONFIG, [batch], [draws.table],
            dict(device='cuda:0', backend='gloo', caps={}, threads=4,
                 dtype=dtype)), timeout_s=PARALLEL_DEADLINE_S)
        for r in ranks:
            m = pr.mismatch(r, want)
            label = f'{name}, rank {r["rank"]} vs one process'
            if dtype == torch.float64:
                _held(m, bars, label)
            else:               # a proposal swap at a cut moves it by O(1e-2)
                print(f'  {label} (not held: a batch layout\'s 1e-7 can '
                      f'swap a proposal at the top-k / NMS cut, and the '
                      f'sampler then picks other RoIs): losses '
                      f'{m["losses"]:.2e}, accuracies {m["acc"]:.2e}, '
                      f'gradients together {m["together"]:.2e}, worst one '
                      f'{m["each"]:.2e}, BN statistics {m["stats"]:.2e}')
        a, c = (r['stats'] for r in ranks)
        if not all(np.array_equal(a[n], c[n]) for n in a):
            raise AssertionError(f'12b {name}: the ranks\' BN running '
                                 f'statistics differ')
        if ranks[0]['losses'] != ranks[1]['losses']:
            raise AssertionError(f'12b {name}: the ranks report different '
                                 f'losses')
        print(f'  {name}: BN running statistics bit-identical on the two '
              f'ranks; the ranks\' first step {ranks[0]["ms"][0]:.1f} / '
              f'{ranks[1]["ms"][0]:.1f} ms (a fresh process), its gradient '
              f'all-reduce over gloo {ranks[0]["reduce_ms"][0]:.1f} ms for '
              f'{ranks[0]["buffer_mb"]:.1f} MB; {time.perf_counter() - t0:.1f}'
              f' s with set-up, {SHARED}, {smi}')


def phase_parallel_eval(smi):
    pr = _parallel_ranks()
    cc = _checks()
    from hrfuser_tpu_torch import get_experiment, init_detector
    from hrfuser_tpu_torch.apis.test import run_inference
    from hrfuser_tpu_torch.data.datasets.coco import CocoFusionDataset
    from hrfuser_tpu_torch.data.loader import DetDataLoader
    from hrfuser_tpu_torch.parallel.mesh import run_ranks
    from hrfuser_tpu_torch.utils.checkpoint import save_checkpoint
    exp = get_experiment(CONFIG)
    print(f'== 12c. sharded evaluation: {CONFIG}, bf16, global batch {BATCH}, '
          f'phase 9b\'s {NUS_N} JPEG samples (written again from its seed), '
          f'world size 1 (nccl) and 2 (gloo, {SHARED}) against one process')
    root = tempfile.mkdtemp(prefix='nus_')
    _nus_folder(root, np.random.default_rng(10), exp.data.classes)
    det = init_detector(CONFIG, 'cuda', seed=0)
    img, mods = _inputs(exp.model, 2, np.random.default_rng(12))
    _calibrated(det.model, torch.from_numpy(img).cuda(),
                [torch.from_numpy(m).cuda() for m in mods])
    ckpt = f'{root}/ckpt_calibrated'
    save_checkpoint(ckpt, 0, det.model, meta={'config': CONFIG})
    det = init_detector(CONFIG, 'cuda', seed=0, dtype=torch.bfloat16,
                        checkpoint=ckpt)
    ds = CocoFusionDataset(NUS_VAL, exp.data.classes, data_root=root,
                           test_mode=True)
    loader = DetDataLoader(ds, exp.data, BATCH, train=False)
    run_inference(det, loader, progress=False)          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = run_inference(det, loader, progress=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f'  one process: {NUS_N} images in {dt:.2f} s, {NUS_N / dt:.1f} '
          f'images/s (`run_inference` after a warm-up run, loading '
          f'included) on {smi}')
    del det
    torch.cuda.empty_cache()
    one, _ = cc.expected_launches(exp.model)
    meta = want[0]['meta']              # boxes come in the original frame
    scale = meta['img_shape'][1] / meta['ori_shape'][1]
    tol = dict(cc.DETECTION_TOL, box=cc.DETECTION_TOL['box'] / scale)
    for world, device, backend in ((1, 'cuda', None), (2, 'cuda:0', 'gloo')):
        ranks = run_ranks(pr.sharded_eval_rank, world, (
            CONFIG, root, BATCH, device, backend, 'bf16', ckpt, None, 4,
            EVAL_COUNTERS, True), timeout_s=PARALLEL_DEADLINE_S)
        k = BATCH // world
        compared = at_cut = 0
        for rank, r in enumerate(ranks):
            mine = [b * BATCH + rank * k + i for b in range(NUS_N // BATCH)
                    for i in range(k)]
            if r['loaded'] != mine:
                raise AssertionError(f'12c world {world} rank {rank} loaded '
                                     f'{r["loaded"]}, not its rows {mine}')
            got = r['results']
            if [g['meta'] for g in got] != [w['meta'] for w in want]:
                raise AssertionError(f'12c world {world} rank {rank}: the '
                                     f'images are not those of one process, '
                                     f'once each, in dataset order')
            for i, (g, w) in enumerate(zip(got, want)):
                sides = [(x['boxes'], x['scores'], x['labels'])
                         for x in (g, w)]
                cut = cc._cut(sides, exp.model.roi.score_thr,
                              exp.model.roi.max_per_img)
                res = cc.match(*sides, tol, cut,
                               f'12c world {world} rank {rank} image {i}')
                compared += res['got']
                at_cut += res['at_cut']
            want_launches = {n: r['batches'] * c for n, c in one.items()}
            want_launches['jpeg_pixels'] = 2 * len(r['loaded'])
            if r['launches'] != want_launches:
                raise AssertionError(f'12c world {world} rank {rank}: '
                                     f'launches {r["launches"]}, expected '
                                     f'{want_launches}')
        if not compared:
            raise AssertionError(f'12c world {world}: no detection compared')
        slowest = max(r['seconds'] for r in ranks)
        print(f'  world size {world}: every rank holds the {NUS_N} images '
              f'once in dataset order, {compared // world} detections a rank '
              f'matched ({at_cut} missing at the score cut), each rank '
              f'loaded only its {NUS_N // world} samples; launches a rank '
              f'{ranks[0]["launches"]} over {ranks[0]["batches"]} forwards; '
              f'{NUS_N / slowest:.1f} images/s (the slowest rank\'s '
              f'`run_inference` after a warm-up run, loading included)'
              + (f', {SHARED}' if world > 1 else '') + f' on {smi}')
    shutil.rmtree(root)


def phase_parallel_dryrun(smi):
    print(f'== 12d. `parallel/dryrun.py`: micro_fusion_dryrun, one sharded '
          f'train step and one sharded predict, {SHARED} (gloo)')
    from hrfuser_tpu_torch.parallel.dryrun import dryrun
    t0 = time.perf_counter()
    loss, shape = dryrun(2, 'cuda:0', 'gloo', PARALLEL_DEADLINE_S)
    if not np.isfinite(loss) or shape[0] != 2:
        raise AssertionError(f'12d: loss {loss}, boxes {shape}')
    print(f'  loss {loss:.4f}, joined boxes {shape}, '
          f'{time.perf_counter() - t0:.1f} s with the ranks\' start-up, '
          f'on {smi}')


def phase_op_checks():
    print('== 13a. the hrfuser:: ops on the card against their fake '
          'implementations (`torch.library.opcheck`, '
          '`tests/oracles/op_cases.py`)')
    cases = _oracle('op_cases')
    for dt in (torch.float32, torch.bfloat16):
        for label in cases.LABELS:
            op, args = cases.op_case(label, 'cuda', dt)
            torch.library.opcheck(op, args)
            print(f'  {label} {str(dt)[6:]}: schema, fake, dynamic-shape '
                  f'trace ok')
    _dispatch_cost()


def _host_us(fn, calls=500):
    """Host microseconds per call of `fn`, the card not waited on inside
    the loop (at these small shapes the host, not the card, sets the
    pace)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def _dispatch_cost():
    """What the registered ops add to each kernel call on the host: a
    call through the op beside the op's own launcher called directly, at
    HRFuser-T's stride-32 map (12x20x144, bf16, batch 8)."""
    from hrfuser_tpu_torch.layers.attention import HRFormerBlock
    from hrfuser_tpu_torch.ops import chain
    blk = _randomize(HRFormerBlock(144, 8), torch.Generator().manual_seed(0))
    p = blk.cuda().folded()
    x = torch.randn((BATCH, 12, 20, 144), device='cuda').bfloat16()
    with torch.no_grad():
        cases = {
            'A': (lambda: chain.window_self_attention(x, p['attn'], 8),
                  lambda: chain.launch_window_attention(x, None, x, None,
                                                        p['attn'], 8)),
            'B': (lambda: chain.cross_ffn(x, p['ffn']),
                  lambda: chain.launch_cross_ffn(x, p['ffn']))}
        for name, (op, direct) in cases.items():
            us = [_host_us(f) for f in (op, direct, direct, op)]
            print(f'  dispatch, kernel {name} at {BATCH}x12x20x144 bf16: '
                  f'through the op {us[0]:.1f} / {us[3]:.1f} us a call, '
                  f'its launcher alone {us[1]:.1f} / {us[2]:.1f} (host '
                  f'clock, 500 calls each, in turns)')


def _field_diffs(got, want):
    return {k: (getattr(got, k).float() - getattr(want, k).float())
            .abs().max().item() for k in got._fields}


def _counted_calls(fn, xs, want, label, calls=3):
    """A warm-up call of `fn(*xs)`, then `calls` timed ones with each
    kernel's launches held to `calls` x `want`: (last output, ms each)."""
    fn(*xs)
    torch.cuda.synchronize()
    _reset_counts()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        out = fn(*xs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    _check_counts(want, calls, label)
    return out, times


def phase_export(smi):
    print(f'== 13b. export: `apis/export.export_predict` of HRFuser-T r640 '
          f'lidar+radar, bf16, batch {BATCH}, saved, loaded and run on the '
          f'card')
    from hrfuser_tpu_torch import init_detector
    from hrfuser_tpu_torch.apis.export import PredictModule, export_predict
    det = init_detector(CONFIG, 'cuda', seed=0, dtype=torch.bfloat16)
    img, mods = _inputs(det.cfg, BATCH, np.random.default_rng(0), (H, W))
    xs = [torch.from_numpy(a).cuda() for a in (img, *mods)]
    t0 = time.perf_counter()
    program = export_predict(det, BATCH, (H, W))
    export_s = time.perf_counter() - t0
    consts = [t for t in program.constants.values()
              if isinstance(t, torch.Tensor)]
    ops = {}
    for node in program.graph.nodes:
        if node.op == 'call_function' and 'hrfuser' in str(node.target):
            ops[str(node.target)] = ops.get(str(node.target), 0) + 1
    print(f'  traced in {export_s:.1f} s (the eager warm-up call '
          f'included): {len(program.graph.nodes)} graph nodes, '
          f'{len(program.state_dict)} parameters, {len(consts)} constants '
          f'({sum(t.numel() * t.element_size() for t in consts) / 1e6:.1f}'
          f' MB); op calls {ops}')
    root = tempfile.mkdtemp(prefix='export_')
    try:
        path = os.path.join(root, 'hrfuser_t_r640_bf16_b8.pt2')
        t0 = time.perf_counter()
        torch.export.save(program, path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        run = torch.export.load(path).module()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        print(f'  saved {os.path.getsize(path) / 1e6:.1f} MB in '
              f'{save_s:.1f} s, loaded in {load_s:.1f} s')
    finally:
        shutil.rmtree(root)
    eager = PredictModule(det)
    want = _expected_launches(det.cfg)
    with torch.no_grad():
        (got, run_ms), (out, eager_ms) = (
            _counted_calls(fn, xs, want, label)
            for fn, label in ((run, 'loaded program'),
                              (eager, 'eager predict')))
        diffs = _field_diffs(got, out)
        for k in ('labels', 'valid'):
            if not torch.equal(getattr(got, k), getattr(out, k)):
                raise AssertionError(f'13b: {k} of the loaded program differ '
                                     f'from eager predict\'s')
        bit = all(torch.equal(getattr(got, k), getattr(out, k))
                  for k in got._fields)
        print(f'  loaded vs eager on the same inputs: labels and valid '
              f'equal; largest difference {diffs}; '
              f'{"bit-equal" if bit else "not bit-equal"}')
        if not (torch.allclose(got.boxes, out.boxes, atol=1e-2, rtol=1e-3)
                and torch.allclose(got.scores, out.scores, atol=5e-3,
                                   rtol=0)):
            raise AssertionError('13b: loaded program off eager predict '
                                 'beyond 1e-2 px + 1e-3 rel / 5e-3')
        per_image = got.valid.sum(1).tolist()
        if not all(torch.isfinite(getattr(got, k).float()).all()
                   for k in ('boxes', 'scores')) or not sum(per_image):
            raise AssertionError(f'13b: non-finite outputs or no detection '
                                 f'({per_image})')
        print(f'  detections: {sum(per_image)} valid of {BATCH}x'
              f'{det.cfg.roi.max_per_img} (per image {per_image})')
        for label, fn, ts in (('loaded program', run, run_ms),
                              ('eager predict', eager, eager_ms)):
            busy, wall = _busy_ms(lambda: fn(*xs))
            print(f'  {label}: latency per batch of {BATCH} (ms) '
                  f'{", ".join(f"{t:.1f}" for t in ts)}; median '
                  f'{sorted(ts)[1]:.1f}; under torch.profiler {wall:.2f} ms '
                  'a batch, device busy '
                  + ('not measured' if busy is None else
                     f'{busy:.2f} ms, idle {1 - busy / wall:.1%}')
                  + f' on {smi}')
    del det, program, run, eager
    torch.cuda.empty_cache()


def phase_export_cli(smi):
    print(f'== 13c. `python -m hrfuser_tpu_torch.tools.export_model '
          f'{CLI_EXPORT_CONFIG} --dtype bf16 --verify` as a subprocess on '
          f'the card')
    root = tempfile.mkdtemp(prefix='export_cli_')
    try:
        path = os.path.join(root, 'tiny.pt2')
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, '-m', 'hrfuser_tpu_torch.tools.export_model',
             CLI_EXPORT_CONFIG, '--dtype', 'bf16', '--out', path,
             '--verify'], capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        for line in proc.stdout.splitlines():
            print('  ' + line)
        if proc.returncode != 0 or 'verify ok' not in proc.stdout:
            raise AssertionError(f'13c: the CLI exited {proc.returncode}:\n'
                                 f'{proc.stderr[-3000:]}')
        print(f'  {time.perf_counter() - t0:.1f} s with the process\'s '
              f'start-up, on {smi}')
    finally:
        shutil.rmtree(root)


def _entry_counts(res):
    """`count_flops`' calls by counter entry, under `_counters()`' names."""
    from hrfuser_tpu_torch.ops import chain
    entry = {fn: e for e, fn in chain.COUNTERS.items()}
    return {k: res['entries'].get(entry[fn], 0)
            for k, fn in _counters().items()}


def _counted_flops(det, x, xs, label):
    """`count_flops` of one bf16 forward on the card, held to its launch
    counters and to each op's formula call by call
    (`card_checks.kernel_op_flops`); returns its result."""
    from hrfuser_tpu_torch.apis.flops import count_flops
    _reset_counts()
    with _checks().kernel_op_flops() as rec:
        res = count_flops(det.model, x, xs)
    torch.cuda.synchronize()
    _check_counts(_expected_launches(det.cfg), 1, label)
    calls = _entry_counts(res)
    counts = {k: fn.launches for k, fn in _counters().items()}
    if calls != counts:
        raise AssertionError(f'{label}: op calls {calls} != launches '
                             f'{counts}')
    for op, (n, flops) in rec.items():
        if res['by_op'][op] != {'calls': n, 'flops': flops}:
            raise AssertionError(f'{label}: {op} counted {res["by_op"][op]}, '
                                 f'its formula over its calls {n} / {flops}')
    zero = [op for op, v in res['by_op'].items()
            if not v['flops'] and op != 'hrfuser.greedy_keep']
    if zero or set(rec) != {'hrfuser.window_attention', 'hrfuser.cross_ffn',
                            'hrfuser.roi_align'}:
        raise AssertionError(f'{label}: ops that count 0: {zero}, kernel ops '
                             f'{sorted(rec)}')
    for op, v in res['by_op'].items():
        print(f'    {op:26s} {v["calls"]:5d} calls {v["flops"] / 1e9:10.2f} '
              f'GFLOPs')
    return res


def _rate(flops, ms, peak):
    """`flops` done in `ms` as TFLOP/s and as a share of `peak` TFLOP/s."""
    tflops = flops / ms / 1e9
    return f'{tflops:.1f} TFLOP/s, {tflops / peak:.2%} of {peak:g}'


def phase_flops(state, smi):
    print(f'== 14a. FLOPs (`apis/flops.count_flops`): HRFuser-T and -B r640 '
          f'bf16 batch {BATCH} forwards on the card, HRFuser-T\'s float32 '
          f'train step')
    from hrfuser_tpu_torch import init_detector
    from hrfuser_tpu_torch.apis.flops import count_flops
    peak = PEAK_FLOPS[torch.bfloat16] / 1e12
    for config, label in ((CONFIG, 'HRFuser-T'), (CONFIG_B, 'HRFuser-B')):
        det = init_detector(config, 'cuda', seed=0, dtype=torch.bfloat16)
        img, mods = _inputs(det.cfg, BATCH, np.random.default_rng(0), (H, W))
        x = torch.from_numpy(img).cuda().bfloat16()
        xs = [torch.from_numpy(m).cuda().bfloat16() for m in mods]
        res = _counted_flops(det, x, xs, f'{label} count_flops')
        flops = res['flops']
        state[f'flops_{config}'] = flops
        ms, busy = state[config]
        print(f'  {label}: {flops / 1e9:.2f} GFLOPs a batch of {BATCH}, '
              f'{flops / 1e9 / BATCH:.2f} a {H}x{W} image; at phase '
              f'4{"b" if config == CONFIG_B else ""}\'s {ms:.1f} ms a batch '
              f'{_rate(flops, ms, peak)}; at its device-busy '
              + ('not measured' if busy is None else
                 f'{busy:.2f} ms {_rate(flops, busy, peak)}') + f' on {smi}')
        del det
        torch.cuda.empty_cache()
    from hrfuser_tpu_torch.tools.train import synthetic_batches
    train_state, exp = _train_setup(CONFIG, 'cuda', warmup=False)
    b = exp.schedule.samples_per_device
    batch = next(synthetic_batches(exp, b, pool=1))
    _reset_counts()
    res = count_flops(train_state.model, torch.from_numpy(batch['img']).cuda(),
                      [torch.from_numpy(m).cuda() for m in batch['mod_imgs']],
                      train=True)
    if any(fn.launches for fn in _counters().values()) or res['entries']:
        raise AssertionError('14a: the train count launched an eval kernel')
    flops = res['flops']
    step_ms = state['synthetic_step_ms']
    print(f'  HRFuser-T train step (forward_train + backward, float32, batch '
          f'{b}, one gt box an image): {flops / 1e9:.2f} GFLOPs, '
          f'{flops / 1e9 / b:.2f} an image; at phase 8a\'s {step_ms:.1f} ms a '
          f'step {_rate(flops, step_ms, PEAK_FLOPS[torch.float32] / 1e12)} '
          f'(TF32 off) on {smi}')
    for op, v in res['by_op'].items():
        print(f'    {op:26s} {v["calls"]:5d} calls {v["flops"] / 1e9:10.2f} '
              f'GFLOPs')
    del train_state
    torch.cuda.empty_cache()


def _drift(config, det32, det16, batches, label):
    """Each batch through `numerics_drift.predict_pair` (float32 with TF32
    off, then bf16), each pair's launches held to two forwards'; the JAX
    tool's report lines; returns the summary."""
    from hrfuser_tpu_torch.tools import numerics_drift as nd
    want = _expected_launches(det32.cfg)
    pairs = []
    t0 = time.perf_counter()
    for i, (img, mods) in enumerate(batches):
        _reset_counts()
        pairs.append(nd.predict_pair(det32, det16, img, mods))
        _check_counts(want, 2, f'{label} batch {i}, float32 + bf16')
    secs = time.perf_counter() - t0
    print(f'  folds held to their dtype: {nd.check_folds(det32.model)}')
    b = len(batches[0][0])
    stats = nd.drift_stats(pairs, 50)
    for line in nd.report_lines(stats, config, len(batches), b, (H, W), 50):
        print('  ' + line)
    s = nd.summary(stats)
    print(f'  {len(batches)} batches x 2 dtypes in {secs:.1f} s; summary '
          f'{json.dumps(s)}')
    # NaN where there is nothing to reduce (no match, no image with a
    # detection in both runs) is no fault
    data = {'box': s['matched'], 'score': s['matched'],
            'churn': len(stats['churns'])}
    bad = [k for k, v in s.items()
           if data.get(k.split('_')[0], 1) and not np.isfinite(v)]
    if bad:
        raise AssertionError(f'{label}: non-finite statistics {bad}')
    return s


def phase_drift(state, smi):
    print('== 14b. bf16 vs float32 drift (`tools/numerics_drift.py`): one '
          'model, two Detectors, the JAX tool\'s matching and lines')
    from hrfuser_tpu_torch.tools import numerics_drift as nd
    det32, det16 = nd.detector_pair(CONFIG, 'cuda')
    t0 = time.perf_counter()
    _reset_counts()
    batch = nd.overfit(det32, CONFIG, DRIFT_OVERFIT_STEPS, 4, (H, W),
                       log=lambda line: print('  ' + line))
    torch.cuda.synchronize()
    if any(fn.launches for fn in _counters().values()):
        raise AssertionError('14b: the overfit launched an eval kernel')
    # 14c publishes these weights
    state['overfit_t'] = {k: v.detach().cpu().clone()
                          for k, v in det32.model.state_dict().items()}
    print(f'  HRFuser-T r640: `numerics_drift.overfit`, as '
          f'--overfit-steps {DRIFT_OVERFIT_STEPS} runs it, on one synthetic '
          f'batch of 4 in {time.perf_counter() - t0:.1f} s; drift on that '
          f'batch, as the tool measures after --overfit-steps')
    s = _drift(CONFIG, det32, det16, [batch], 'HRFuser-T overfit, its batch')
    if not s['matched']:
        raise AssertionError('14b: no matched detection on the overfit '
                             'weights\' batch')
    print('  the same weights on the JAX tool\'s default batches: 4 of 4 '
          '(default_rng(100 + i))')
    _drift(CONFIG, det32, det16, nd.eval_batches(det32, 4, 4, (H, W)),
           'HRFuser-T overfit, seeded batches')
    del det32, det16
    det32, det16 = nd.detector_pair(CONFIG_B, 'cuda')
    print('  HRFuser-B r640 on random weights (seed 0): 2 batches of 4; its '
          'rank churn is near 1 by construction (near-uniform scores whose '
          'NMS survivors rounding decides), its box and score deltas and '
          'valid counts are the report')
    _drift(CONFIG_B, det32, det16, nd.eval_batches(det32, 2, 4, (H, W)),
           'HRFuser-B random')
    del det32, det16
    torch.cuda.empty_cache()


def _main_output(main, argv):
    """What `main(argv)` prints."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def phase_model_tools(state, smi):
    print('== 14c. the tools through their main: get_flops, print_config, '
          'publish_model, numerics_drift --overfit-steps')
    from hrfuser_tpu_torch.apis.train import make_optimizer
    from hrfuser_tpu_torch.configs import get_experiment
    from hrfuser_tpu_torch.models.detectors.cascade_rcnn import CascadeRCNN
    from hrfuser_tpu_torch.tools import (get_flops, numerics_drift,
                                         print_config, publish_model)
    from hrfuser_tpu_torch.utils.checkpoint import (load_weights,
                                                    save_checkpoint)
    out = json.loads(_main_output(get_flops.main, [
        CONFIG, '--batch', str(BATCH), '--img-hw', str(H), str(W), '--bf16',
        '--json']))
    print(f'  get_flops --json: {json.dumps(out)}')
    if out['gflops_total'] != state[f'flops_{CONFIG}'] / 1e9:
        raise AssertionError(f'14c: get_flops {out["gflops_total"]} GFLOPs, '
                             f'14a {state[f"flops_{CONFIG}"] / 1e9}')
    text = _main_output(print_config.main, [CONFIG]).splitlines()
    print(f'  print_config: {len(text)} lines, ' + ' | '.join(text[:3]))
    if text[0] != f'name: {CONFIG}' or 'model:' not in text:
        raise AssertionError('14c: print_config printed no config tree')
    exp = get_experiment(CONFIG)
    sd = state['overfit_t']
    model = CascadeRCNN(exp.model)
    model.load_state_dict(sd)
    opt = make_optimizer(model, exp.optim)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()                          # an AdamW state to drop
    root = tempfile.mkdtemp(prefix='publish_')
    try:
        ckpt = save_checkpoint(os.path.join(root, 'work'), 40, sd, opt,
                               meta={'config': CONFIG}, extra={'applied': 40})
        line = _main_output(publish_model.main,
                            [ckpt, os.path.join(root, 'hrfuser_t')])
        path = line.split('[publish] ')[1].strip()
        payload = torch.load(path, weights_only=True)
        got = payload['state_dict']
        digest = publish_model.digest(got)
        same = list(got) == list(sd) and all(torch.equal(got[k], v)
                                             for k, v in sd.items())
        loaded = load_weights(path, CascadeRCNN(exp.model)).state_dict()
        print(f'  publish_model: {os.path.basename(path)}, '
              f'{os.path.getsize(path) / 1e6:.1f} MB (checkpoint '
              f'{os.path.getsize(ckpt) / 1e6:.1f} MB), keys '
              f'{sorted(payload)}, bit-equal {same}')
        if ('optimizer' in payload or not same
                or not path.endswith(f'-{digest}.pth')
                or not all(torch.equal(loaded[k], v) for k, v in sd.items())):
            raise AssertionError('14c: publish_model did not keep the '
                                 'weights alone under their digest')
    finally:
        shutil.rmtree(root)
    t0 = time.perf_counter()
    lines = _main_output(numerics_drift.main, [
        '--config', CLI_EXPORT_CONFIG, '--batch', '2', '--overfit-steps',
        '2']).splitlines()
    for line in lines:
        print('  ' + line)
    print(f'  numerics_drift {CLI_EXPORT_CONFIG} --overfit-steps 2: '
          f'{time.perf_counter() - t0:.1f} s on {smi}')
    if not lines[-1].startswith('valid-count delta'):
        raise AssertionError('14c: numerics_drift printed no report')


# -- 15. the image renderings -------------------------------------------------

RENDER_GATED_HW, RENDER_RAW_HW = (720, 1280), STF_RAW_HW


def _same(label, card, cpu):
    """Card vs CPU, bit for bit (tensors, arrays or bytes)."""
    if isinstance(card, torch.Tensor):
        card = card.cpu().numpy()
    if isinstance(cpu, torch.Tensor):
        cpu = cpu.numpy()
    same = (card == cpu if isinstance(card, bytes) else
            card.dtype == cpu.dtype and np.array_equal(card, cpu))
    print(f'  {label}: card vs CPU {"bit-equal" if same else "DIFFER"}')
    if not same:
        raise AssertionError(f'15: {label} differs between card and CPU')


def _gated_raw(rng, hw=RENDER_GATED_HW):
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
    return np.clip(300 + 200 * np.sin(xx / 40.0) * np.cos(yy / 33.0)
                   + rng.normal(0, 30, hw), 0, 1023).astype(np.uint16)


def _bayer_raw(rng, hw=RENDER_RAW_HW):
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
    return np.clip(1800 + 1500 * np.sin(xx / 60.0) * np.cos(yy / 45.0)
                   + rng.normal(0, 200, hw), 0, 3967).astype(np.uint16)


def phase_render_lut8(smi):
    print(f'== 15a. 8-bit STF LUT images on the card vs the CPU port '
          f'(gated {RENDER_GATED_HW[0]}x{RENDER_GATED_HW[1]}, Bayer '
          f'{RENDER_RAW_HW[0]}x{RENDER_RAW_HW[1]})')
    from hrfuser_tpu_torch.data import stf_lut
    rng = np.random.default_rng(15)
    gated = _gated_raw(rng)
    raw = _bayer_raw(rng)
    grey = stf_lut.gated_raw_to_lut8(gated, 'cpu')
    for clip in (2.0, 0.5):
        _same(f'clahe clip {clip} on {tuple(grey.shape)}',
              stf_lut.clahe(grey.cuda(), clip), stf_lut.clahe(grey, clip))
    bgr = stf_lut.bayer_gb_to_bgr(raw, 'cpu')
    _same(f'bayer_gb_to_bgr {raw.shape} uint16',
          stf_lut.bayer_gb_to_bgr(raw, 'cuda'), bgr)
    img8 = (bgr >> 8).to(torch.uint8)
    lab = stf_lut.bgr_to_lab(img8)
    _same('bgr_to_lab', stf_lut.bgr_to_lab(img8.cuda()), lab)
    every = torch.arange(1 << 24, dtype=torch.int64)
    every = torch.stack([every >> 16, (every >> 8) & 255, every & 255],
                        -1).to(torch.uint8).reshape(4096, 4096, 3)
    for name, fn in (('bgr_to_lab', stf_lut.bgr_to_lab),
                     ('lab_to_bgr', stf_lut.lab_to_bgr)):
        _same(f'{name} on all 2^24 triples', fn(every.cuda()), fn(every))
    _same(f'gated_raw_to_lut8 {gated.shape}',
          stf_lut.gated_raw_to_lut8(gated, 'cuda'), grey)
    for daytime in (True, False):
        _same(f'raw_to_lut8 {raw.shape} daytime={daytime}',
              stf_lut.raw_to_lut8(raw, daytime, 'cuda'),
              stf_lut.raw_to_lut8(raw, daytime, 'cpu'))
    g = torch.from_numpy(gated).cuda()
    r = torch.from_numpy(raw.astype(np.int32)).cuda()
    grey_card = grey.cuda()
    clahe_ms = _time_ms(lambda: stf_lut.clahe(grey_card, 2.0))
    gated_ms = _time_ms(lambda: stf_lut.gated_raw_to_lut8(g))
    raw_ms = _host_ms(lambda: stf_lut.raw_to_lut8(r, True))
    print(f'  on {smi} (CUDA events, 20 calls after 3; raw_to_lut8 on the '
          f'host clock, synchronised, median of 5): clahe 720x1280 '
          f'{clahe_ms:.3f} ms, gated_raw_to_lut8 720x1280 {gated_ms:.3f} '
          f'ms, raw_to_lut8 1024x1920 {_fmt(raw_ms)} ms')


def phase_render_gated_warp(smi):
    print('== 15b. `tools/stf_gated_warp.py --lut8`: one synthetic frame '
          'through its main on the card, the frame warped on the CPU')
    from hrfuser_tpu_torch.data.png import imdecode
    from hrfuser_tpu_torch.tools import stf_gated_warp
    frame = 'scene_00001'                  # split line `scene,00001`
    with tempfile.TemporaryDirectory() as root:
        _oracle('offline_data').write_gated_frame(root, frame,
                                                  np.random.default_rng(3))
        with open(f'{root}/split.txt', 'w') as f:
            f.write('scene,00001\n')
        t0 = time.perf_counter()
        stf_gated_warp.main(['--root', root, '--split', f'{root}/split.txt',
                             '--lut8'])
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        with open(f'{root}/gated_acc_wraped_grey/{frame}.png', 'rb') as f:
            card = imdecode(f.read(), unchanged=True)
        cpu = stf_gated_warp.warp_frame(root, frame, 'cam_stereo_sgm',
                                        use_lut8=True, device='cpu')
    diff = np.abs(card.astype(np.int32) - cpu)
    print(f'  written {card.dtype} {card.shape}; card vs CPU: '
          f'{int((diff > 0).sum())} pixels differ, by at most '
          f'{int(diff.max())} (bar: 11c\'s, none by more than 1); '
          f'{len(np.unique(card))} distinct levels; the CLI {dt:.0f} ms '
          f'for one frame (TIFF reads and PNG write included) on {smi}')
    if card.dtype != np.uint8 or card.shape != (768, 1280) or \
            diff.max() > 1:
        raise AssertionError('15b: --lut8 output')


def phase_render_jpeg(smi):
    print('== 15c. JPEG writer (`data/jpeg.py:imencode`): a 900x1600 '
          'camera-like frame and its grey channel, card vs CPU')
    from hrfuser_tpu_torch.data import jpeg
    img, _ = _jpeg_frame(np.random.default_rng(16))
    for label, x in (('colour 900x1600', img),
                     ('grey 900x1600', np.ascontiguousarray(img[..., 1]))):
        card_t = torch.from_numpy(x).cuda()
        card = jpeg.imencode(card_t)
        _same(f'{label} JPEG bytes ({len(card)})', card,
              jpeg.imencode(x, device='cpu'))
        back = jpeg.decode_jpeg(card, 'cuda').cpu().numpy()
        ref = jpeg.decode_jpeg(card, 'cpu').numpy()
        if back.shape[:2] != x.shape[:2] or not np.array_equal(back, ref):
            raise AssertionError(f'15c: {label} does not read back')
        err = np.abs(back.astype(np.int32) - (x[..., None] if x.ndim == 2
                                              else x)).mean()
        pixel_ms = _time_ms(lambda: jpeg.encode_blocks(card_t))
        blocks, comps = jpeg.encode_blocks(card_t)
        host = blocks.cpu().numpy()
        copy_ms = _host_ms(lambda: blocks.cpu().numpy())
        entropy_ms = _host_ms(lambda: jpeg.encode_scan(host, comps))
        total_ms = _host_ms(lambda: jpeg.imencode(card_t))
        print(f'    read back by the port decoder (mean |error| '
              f'{err:.2f} levels); on {smi}: pixel stage (card, CUDA '
              f'events) {pixel_ms:.3f} ms, block copy {_fmt(copy_ms)} ms, '
              f'Huffman stage (host) {_fmt(entropy_ms)} ms, imencode end '
              f'to end {_fmt(total_ms)} ms')


def phase_render_show_dir(state, smi):
    print(f'== 15d. `tools.test --show-dir` over 9b\'s {NUS_N} JPEG '
          f'samples (written again from its seed), {CONFIG}, bf16, batch '
          f'{BATCH}')
    from hrfuser_tpu_torch import get_experiment
    from hrfuser_tpu_torch.data import jpeg
    from hrfuser_tpu_torch.data.pipelines.loading import imread
    from hrfuser_tpu_torch.tools import test as test_cli
    from hrfuser_tpu_torch.utils.visualization import draw_detections
    exp = get_experiment(CONFIG)
    root = state['render_root'] = tempfile.mkdtemp(prefix='nus_')
    _nus_folder(root, np.random.default_rng(10), exp.data.classes)
    _checkpoint(CONFIG, f'{root}/ckpt')
    show = f'{root}/show'
    seen, spent = [], []
    real = test_cli.show_results

    def recorded(results, *args, **kw):
        seen.append(results)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = real(results, *args, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return n

    _reset_counts()
    jpeg.pixels.launches = 0
    test_cli.show_results = recorded
    try:
        test_cli.main([CONFIG, '--data-root', root, '--checkpoint',
                       f'{root}/ckpt', '--batch-size', str(BATCH),
                       '--dtype', 'bf16', '--eval', 'bbox',
                       '--show-dir', show])
    finally:
        test_cli.show_results = real
    _check_counts(_expected_launches(exp.model), NUS_N // BATCH,
                  f'tools.test --show-dir over {NUS_N} images')
    print(f'  JPEG kernel launches: {jpeg.pixels.launches} (4 a frame: the '
          f'loader\'s read and the show loop\'s)')
    if jpeg.pixels.launches != 4 * NUS_N:
        raise AssertionError(f'15d: the JPEG kernel launched '
                             f'{jpeg.pixels.launches} times, expected '
                             f'{4 * NUS_N}')
    (results,) = seen
    names = sorted(os.listdir(show))
    if names != [f'{i:04d}.jpg' for i in range(NUS_N)]:
        raise AssertionError(f'15d: wrote {names}')
    for name in names:
        with open(f'{show}/{name}', 'rb') as f:
            if jpeg.decode_jpeg(f.read(), 'cuda').shape != (*RAW_HW, 3):
                raise AssertionError(f'15d: {name} does not decode')
    kept = sum(int((r['scores'] >= 0.3).sum()) for r in results)
    print(f'  {len(names)} JPEGs written, each decodes to {RAW_HW}; '
          f'{kept} detections at score >= 0.3 drawn; the show loop '
          f'{spent[0] * 1e3 / NUS_N:.1f} ms per image (read, draw, JPEG '
          f'write) on {smi}')
    drawn = 0
    for r in results[:4]:                     # every valid detection
        img = imread(r['meta']['filename'], device='cuda')
        args = (r['boxes'], r['labels'], r['scores'])
        kw = dict(class_names=exp.data.classes, score_thr=0.0)
        card = draw_detections(img, *args, device='cuda', **kw)
        cpu = draw_detections(img, *args, device='cpu', **kw)
        _same(f'{os.path.basename(r["meta"]["filename"])}: '
              f'{len(r["boxes"])} boxes drawn', card, cpu)
        _same('  its JPEG', jpeg.imencode(card), jpeg.imencode(
            cpu, device='cpu'))
        drawn += len(r['boxes'])
    if not drawn:
        raise AssertionError('15d: no detection to draw')


def phase_render_browse(state, smi):
    print(f'== 15e. `tools.browse_dataset` over 15d\'s train split, '
          f'{CONFIG}, 4 composites')
    from hrfuser_tpu_torch.data.jpeg import decode_jpeg
    from hrfuser_tpu_torch.tools import browse_dataset
    root = state['render_root']
    out = f'{root}/browse'
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    written = browse_dataset.main([CONFIG, '--data-root', root,
                                   '--out-dir', out, '--num', '4'])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if [os.path.basename(p) for p in written] != [
            f'sample_{i}.jpg' for i in range(4)]:
        raise AssertionError(f'15e: wrote {written}')
    shapes = set()
    for path in written:
        with open(path, 'rb') as f:
            shapes.add(tuple(decode_jpeg(f.read(), 'cuda').shape))
    print(f'  4 composites {sorted(shapes)} written and decoded, '
          f'{dt * 1e3 / 4:.0f} ms a sample (pipeline included) on {smi}')
    shutil.rmtree(root)


# (label, sample_num, max_grid, aligned) of phase 16a
ROI_MODES = (('adaptive max_grid 4', 0, 4, True),
             ('adaptive max_grid 8', 0, 8, True),
             ('static 1', 1, 4, True), ('static 3', 3, 4, True),
             ('static 4', 4, 4, True), ('unaligned static 2', 2, 4, False),
             ('unaligned adaptive', 0, 4, False))


def _contract_rois(g):
    """`_roi_inputs`' pyramid and 8 x 1000 RoIs, with 12 RoIs of every
    image from row 250 replaced by `card_checks.grid_rois()`: grids 1-4,
    a sliver capped at `max_grid` 4 but not 8, integer-boundary bins."""
    feats32, rois = _roi_inputs(g)
    extra = torch.from_numpy(_checks().grid_rois()).cuda()
    rois[:, 250:250 + len(extra)] = extra
    return feats32, rois


def phase_roi_contract(report, smi):
    print('== 16a. kernel C, the whole sampling contract vs its twin: r640, '
          f'C = 256, {BATCH} x 1000 RoIs with grids 1-4, capped and '
          f'integer-boundary bins')
    from hrfuser_tpu_torch.ops import roi_align
    g = torch.Generator().manual_seed(16)
    feats32, rois = _contract_rois(g)
    strides = (4, 8, 16, 32)
    fb = [f.bfloat16().contiguous() for f in feats32]
    ms2 = _time_ms(lambda: roi_align.multilevel_roi_align(fb, rois, strides))
    print(f'  the 2x2 plan on these inputs, bf16: {ms2:.4f} ms ({smi})')
    for label, sn, mg, al in ROI_MODES:
        for dt in (torch.float32, torch.bfloat16):
            feats = feats32 if dt == torch.float32 else fb

            def roi_k():
                return roi_align.multilevel_roi_align(feats, rois, strides, 7,
                                                      sn, 56, mg, al)

            def roi_p():
                return roi_align.multilevel_roi_align_plain(
                    feats, rois, strides, 7, sn, 56, mg, al)

            before = roi_align.PLAN_LAUNCHES['grid']
            got = roi_k()
            if roi_align.PLAN_LAUNCHES['grid'] != before + 1:
                raise AssertionError(f'{label}: the general plan did not '
                                     f'launch')
            err = _compare(f'roi_align {label} {str(dt)[6:]} [plan grid]',
                           got, roi_p(), dt)
            main = sn == 0 and mg == 4 and al
            if dt == torch.bfloat16 or main:
                ms = _time_ms(roi_k)
                plain_ms = _time_ms(roi_p, iters=1, warmup=0)
                flops, nbytes, peak, pixels = _roi_work(feats, rois, got, sn,
                                                        mg, al)
                bound = _bound(flops, nbytes, peak)
                _print_time(ms, plain_ms, bound)
                print(f'    {flops / 1e9:.2f} GFLOP from the RoIs\' own '
                      f'grids, {nbytes / 1e6:.1f} MB ({pixels} pyramid '
                      f'pixels); {ms / ms2:.2f}x the 2x2 plan; {smi}')
                record = main and dt == torch.bfloat16
                report.add('roi_align_grid', SRC_C, REPLACES_C, err,
                           *((ms, plain_ms, bound) if record else ()))
            else:
                report.add('roi_align_grid', SRC_C, REPLACES_C, err)
    for variant in ('v4', 'v8'):
        for dt in (torch.float32, torch.bfloat16):
            single = [f[0].to(dt).contiguous() for f in feats32]
            _check(report, 'roi_align_grid', SRC_C, REPLACES_C,
                   f'roi_align multilevel_roi_align_pallas variant={variant} '
                   f'static 3 1x{rois.shape[1]} {str(dt)[6:]}',
                   lambda: roi_align.multilevel_roi_align_pallas(
                       single, rois[0], sample_num=3, variant=variant),
                   lambda: roi_align.multilevel_roi_align_plain(
                       [f[None] for f in single], rois[:1], strides,
                       sample_num=3)[0].reshape(-1, 7, 7, 256), dt,
                   lambda out: _roi_work([f[None] for f in single],
                                         rois[:1], out, 3)[:3])


def phase_adaptive_slice(report, smi):
    print(f'== 16b. HRFuser-T r640 lidar+radar, bf16, batch {BATCH}, '
          f'roi.sample_num=0 (adaptive, max_grid 4), calibrated weights')
    import dataclasses
    from hrfuser_tpu_torch.apis.inference import Detector, init_weights_
    from hrfuser_tpu_torch.configs import get_experiment
    from hrfuser_tpu_torch.models import predict
    from hrfuser_tpu_torch.models.detectors.cascade_rcnn import CascadeRCNN
    from hrfuser_tpu_torch.ops import roi_align
    exp = get_experiment(CONFIG)
    cfgs = {sn: dataclasses.replace(exp.model, roi=dataclasses.replace(
        exp.model.roi, sample_num=sn)) for sn in (0, 2)}
    models = {sn: CascadeRCNN(c) for sn, c in cfgs.items()}
    init_weights_(models[0], torch.Generator().manual_seed(0))
    img, mods = _inputs(exp.model, BATCH, np.random.default_rng(0))
    x = torch.from_numpy(img).cuda()
    xs = [torch.from_numpy(m).cuda() for m in mods]
    models[0].cuda()
    _calibrated(models[0], x, xs)
    models[2].load_state_dict(models[0].state_dict())
    dets = {sn: Detector(m.eval().cuda(), exp.data, torch.device('cuda'),
                         torch.bfloat16) for sn, m in models.items()}
    for det in dets.values():
        det(img, mods)                                   # warm-up
    torch.cuda.synchronize()
    calls, times = 3, []
    _reset_counts()
    plans = dict(roi_align.PLAN_LAUNCHES)
    for _ in range(calls):
        t0 = time.perf_counter()
        out = dets[0](img, mods)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    plans = {k: roi_align.PLAN_LAUNCHES[k] - n for k, n in plans.items()}
    want = _expected_launches(cfgs[0])
    _check_counts(want, calls, f'sample_num=0 over {calls} calls')
    print(f'  kernel C plans launched: {plans}')
    if plans != {'2x2': 0, 'grid': calls * want['roi_align']}:
        raise AssertionError('sample_num=0 must run the general plan alone')
    report.kernels['roi_align_grid']['launches'] = plans['grid']
    if not (out.boxes.isfinite().all() and out.scores.isfinite().all()):
        raise AssertionError('non-finite detections')
    per_image = out.valid.sum(1).tolist()
    print(f'  detections: {sum(per_image)} valid (per image {per_image})')
    if not sum(per_image):
        raise AssertionError('no detection in the whole batch')
    turns = {0: [], 2: []}
    for _ in range(5):                      # in turns: 0, 2, 0, 2, ...
        for sn in turns:
            t0 = time.perf_counter()
            dets[sn](img, mods)
            torch.cuda.synchronize()
            turns[sn].append((time.perf_counter() - t0) * 1e3)
    med = {sn: sorted(t)[2] for sn, t in turns.items()}
    busy = {sn: _busy_ms(lambda sn=sn: dets[sn](img, mods))[0]
            for sn in turns}
    print(f'  latency per batch (ms): the counted calls '
          f'{", ".join(f"{t:.1f}" for t in times)}; then in turns, median '
          f'of 5, sample_num=0 {med[0]:.1f}, sample_num=2 {med[2]:.1f}; '
          f'device busy a batch (torch.profiler) ' + ' vs '.join(
              'not measured' if busy[sn] is None else f'{busy[sn]:.2f} ms'
              for sn in turns) + f'; {smi}')
    cpu = CascadeRCNN(cfgs[0])
    cpu.load_state_dict({k: v.cpu() for k, v in
                         models[0].state_dict().items()})
    img1, mods1 = _inputs(exp.model, 1, np.random.default_rng(1))
    t0 = time.perf_counter()
    for what, r in _checks().same_runs(
            predict, models[0].float(), cpu.eval(), torch.from_numpy(img1),
            [torch.from_numpy(m) for m in mods1], cfgs[0],
            'predict sample_num=0'):
        print(f'  batch 1 f32, {what}: card {r["got"]} / CPU {r["want"]} '
              f'matched, max box err {r["box"]:.3e} px, max score err '
              f'{r["score"]:.3e}, {r["at_cut"]} unmatched at a cut')
    print(f'  card vs CPU in {time.perf_counter() - t0:.1f} s')
    del dets, models
    torch.cuda.empty_cache()


def phase_remat(smi):
    print(f'== 16c. backbone.remat: HRFuser-T float32 train step, batch 3 '
          f'at {H}x{W}, with and without remat, same weights, batch and '
          f'generator (drop path and proj_drop live)')
    from hrfuser_tpu_torch.apis.train import train_step
    from hrfuser_tpu_torch.tools.train import synthetic_batches
    runs = {}
    for remat in (False, True):
        state, exp = _train_setup(CONFIG, 'cuda', warmup=False, remat=remat)
        batch = next(synthetic_batches(exp, exp.schedule.samples_per_device,
                                       pool=1))
        model = state.model
        gen = torch.Generator('cuda').manual_seed(5)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        losses = train_step(state, batch, gen)
        torch.cuda.synchronize()
        launches = sum(fn.launches for fn in _counters().values())
        runs[remat] = dict(
            losses={k: float(v) for k, v in losses.items()},
            grads={n: p.grad.detach().clone()
                   for n, p in model.named_parameters() if p.grad is not None},
            stats={n: b.detach().clone() for n, b in model.named_buffers()
                   if n.endswith(('running_mean', 'running_var'))},
            tracked={int(b) for n, b in model.named_buffers()
                     if n.endswith('num_batches_tracked')},
            gen=gen.get_state(), peak=torch.cuda.max_memory_allocated(),
            launches=launches)
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(state, batch, gen)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        runs[remat]['ms'] = sorted(ms)[1]
        del state, model
        torch.cuda.empty_cache()
    a, b = runs[False], runs[True]
    for k in a['losses']:
        diff = abs(b['losses'][k] - a['losses'][k])
        ok = (diff * 1024 <= 3 if k.endswith('acc')
              else diff <= 1e-3 * abs(a['losses'][k]))
        if not ok:
            raise AssertionError(f'remat {k}: {b["losses"][k]} vs '
                                 f'{a["losses"][k]}')
    ga, gb = a['grads'], b['grads']
    if set(ga) != set(gb):
        raise AssertionError('remat changes which params get grads')
    whole = (torch.cat([(gb[n] - ga[n]).flatten() for n in ga]).norm()
             / torch.cat([ga[n].flatten() for n in ga]).norm()).item()
    floor = 1e-3 * max(g.norm().item() for g in ga.values())
    each = max((gb[n] - ga[n]).norm().item() / max(ga[n].norm().item(), floor)
               for n in ga)
    stats = max(((b['stats'][n] - v).abs().max() / (1 + v.abs().max())).item()
                for n, v in a['stats'].items())
    bits = (a['losses'] == b['losses']
            and all(torch.equal(ga[n], gb[n]) for n in ga)
            and all(torch.equal(a['stats'][n], b['stats'][n])
                    for n in a['stats']))
    print(f'  losses within rtol 1e-3; gradients relative L2 {whole:.2e} '
          f'together (bar 2e-2), {each:.2e} worst (bar 1e-1); BN running '
          f'statistics {stats:.2e} (bar 1e-4); bit-equal to the plain step: '
          f'{bits}')
    if whole > 2e-2 or each > 1e-1 or stats > 1e-4:
        raise AssertionError('the remat step departs from the plain step')
    print(f'  num_batches_tracked after one step: plain {sorted(a["tracked"])}'
          f', remat {sorted(b["tracked"])}; generator state after the step '
          f'equal: {torch.equal(a["gen"], b["gen"])}')
    if b['tracked'] != a['tracked'] or max(b['tracked']) != 1:
        raise AssertionError('remat updated BatchNorm statistics more than '
                             'once')
    if a['launches'] or b['launches']:
        raise AssertionError('a train step launched an eval kernel')
    gib = 2 ** 30
    print(f'  peak memory (torch.cuda.max_memory_allocated) plain '
          f'{a["peak"] / gib:.2f} GiB, remat {b["peak"] / gib:.2f} GiB; ms '
          f'a step (median of 3) plain {a["ms"]:.1f}, remat {b["ms"]:.1f} '
          f'on {smi}')
    state, exp = _train_setup(CONFIG, 'cuda', warmup=False, sample_num=0)
    batch = next(synthetic_batches(exp, exp.schedule.samples_per_device,
                                   pool=1))
    _reset_counts()
    losses = train_step(state, batch, torch.Generator('cuda').manual_seed(5))
    launches = sum(fn.launches for fn in _counters().values())
    print(f'  sample_num=0 through the one-hot pool: loss '
          f'{float(losses["loss"]):.4f}, {launches} kernel launches')
    if not all(bool(v.isfinite()) for v in losses.values()) or launches:
        raise AssertionError('sample_num=0 train step')
    del state
    torch.cuda.empty_cache()


def phase_real_parity(smi):
    print('== 16d. tools.real_parity --dry-run on the card')
    from hrfuser_tpu_torch.tools import real_parity
    t0 = time.perf_counter()
    metrics = real_parity.main(['--dry-run'])
    print(f'  metrics {metrics} in {time.perf_counter() - t0:.1f} s on '
          f'{smi}')


def main():
    smi = phase_environment()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_build()
    report = Report()
    state = {}
    phases = [
        ('3', lambda: phase_kernels(report)),
        ('3b', lambda: phase_kernels_wide(report)),
        ('3c', lambda: phase_kernels_r1248(report)),
        ('4', lambda: phase_slice(
            report, smi, CONFIG, '4. main path: HRFuser-T r640 lidar+radar, '
            'bf16, batch 8', record=True, shared=state)),
        ('4b', lambda: phase_slice(
            report, smi, CONFIG_B, '4b. HRFuser-B r640 lidar+radar, bf16, '
            'batch 8', record=False, shared=state)),
        ('5', lambda: phase_cpu_check(CONFIG, '5. HRFuser-T')),
        ('5b', lambda: phase_cpu_check(CONFIG_B, '5b. HRFuser-B')),
        ('6a', lambda: phase_preprocess(state)),
        ('6b', lambda: phase_inference_detector(state, smi)),
        ('6c', lambda: phase_run_inference(state, smi)),
        ('6d', lambda: phase_serve(state)),
        ('7', lambda: phase_slice(
            report, smi, CONFIG_STF, '7. STF HRFuser-T r1248 camera + lidar '
            '+ radar + gated, bf16, batch 8', record=False, hw=STF_HW)),
        ('7 cpu', lambda: phase_cpu_check(CONFIG_STF, '7. STF HRFuser-T',
                                          STF_CPU_HW)),
        ('7b T', lambda: phase_slice(
            report, smi, CONFIG_CAM_T, '7b. HRFormer-T r640 camera only, '
            'bf16, batch 8', record=False)),
        ('7b B', lambda: phase_slice(
            report, smi, CONFIG_CAM_B, '7b. HRFormer-B r640 camera only, '
            'bf16, batch 8', record=False)),
        ('7b cpu', lambda: phase_cpu_check(CONFIG_CAM_T, '7b. HRFormer-T')),
        ('7c', lambda: phase_new_requests(smi)),
        ('8a', lambda: phase_train(report, smi, state)),
        ('8b', phase_train_parity),
        ('9a', lambda: phase_decoders(report, smi)),
        ('9b', lambda: phase_dataset_eval(state, smi, report)),
        ('9c', lambda: phase_dataset_train(state, smi)),
        ('9d', lambda: phase_stf_dataset(smi)),
        ('10a', lambda: phase_slice(
            report, smi, CONFIG_HRNET, '10a. HRNet-W18 HRFuser r640 lidar + '
            'radar, bf16, batch 8', record=False, calibrate=True,
            against_f32=True)),
        ('10a modules', phase_hrnet_modules),
        ('10b', lambda: phase_cpu_check(CONFIG_HRNET, '10b. HRNet-W18 '
                                        'HRFuser', calibrate=True)),
        ('10c', lambda: phase_hrnet_train(smi)),
        ('10d', lambda: phase_tta(smi)),
        ('10e', phase_stage_d),
        ('11a', lambda: phase_offline_nuscenes(smi)),
        ('11b', lambda: phase_offline_stf(smi)),
        ('11c', lambda: phase_offline_gated(smi)),
        ('11d', lambda: phase_offline_homography(smi)),
        ('12a', lambda: phase_parallel_step(smi)),
        ('12b', lambda: phase_parallel_joined(smi)),
        ('12c', lambda: phase_parallel_eval(smi)),
        ('12d', lambda: phase_parallel_dryrun(smi)),
        ('13a', phase_op_checks),
        ('13b', lambda: phase_export(smi)),
        ('13c', lambda: phase_export_cli(smi)),
        ('14a', lambda: phase_flops(state, smi)),
        ('14b', lambda: phase_drift(state, smi)),
        ('14c', lambda: phase_model_tools(state, smi)),
        ('15a', lambda: phase_render_lut8(smi)),
        ('15b', lambda: phase_render_gated_warp(smi)),
        ('15c', lambda: phase_render_jpeg(smi)),
        ('15d', lambda: phase_render_show_dir(state, smi)),
        ('15e', lambda: phase_render_browse(state, smi)),
        ('16a', lambda: phase_roi_contract(report, smi)),
        ('16b', lambda: phase_adaptive_slice(report, smi)),
        ('16c', lambda: phase_remat(smi)),
        ('16d', lambda: phase_real_parity(smi)),
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
