// Kernel B: CrossFFN half of an HRFormer / HRFuser block, eval.
//
// Replaces the FFN parts of the TPU Pallas kernels
//   hrfuser_tpu/ops/pallas_chain.py:_chain_kernel (hrformer_chain,
//     pallas_call :878) and :_fusion_kernel (fusion_chain, pallas_call
//     :670), their _ffn_segment;
//   hrfuser_tpu/ops/pallas_block.py:_ffn_kernel (fused_cross_ffn,
//     pallas_call :370), with the BatchNorms folded as its _fold_bn does:
//
//   out = x + GELU(fc2'(GELU(dw3x3'(GELU(fc1'(LN(x)))))))
//
// where fc1', dw3x3', fc2' carry their folded BN scale and shift. GELU is
// the exact erf form (the TPU kernels used an Abramowitz-Stegun erf
// because Mosaic had none). The depthwise 3x3 zero-pads the hidden map at
// the real image edge.
//
// Two plans, picked by the host from the dtype and C:
//
// "mma" (bf16 activations, every width whose fc1 block fits 227 KB: C
// up to 1,664): tensor cores (`mma.sync` m16n8k16, bf16 operands, f32
// accumulators, `common.cuh:warp_mma`), two launches of this file a call.
//   1. fc1: one block per (64 pixels, `tpb` tiles of 64 hidden channels),
//      256 threads. LN(x) of its pixels staged once as bf16 [64][KP] (C
//      zero-padded to KP, a multiple of 64), then per hidden tile
//      [64 x KP] . W1p^T, K-slices of 64 streamed through a two-stage
//      cp.async ring; bias and GELU, stored as bf16 to a scratch
//      [B*H*W][round64(4C)] in device memory.
//   2. Tiles: one block per (TH x 8 pixel tile, image, fc2 column split),
//      256 threads. Chunk k of 64 hidden channels is one pipeline stage,
//      loaded by cp.async one chunk ahead: the scratch on the tile plus
//      its one-pixel halo (zero-filled outside the image, the dw conv's
//      zero padding) and the chunk's W2 slices for this block's columns.
//      Per chunk: dw3x3 + GELU on CUDA cores -> bf16 [TH*8][64], then
//      fc2's partial product accumulated in f32 registers. The last GELU
//      and the residual run once, from registers.
//   TH = 8 for C <= 192, 4 above, where an 8x8 tile's fc2 accumulator
//   would not fit in registers (a block holds at most 3 (8x8) or 5 (4x8)
//   of fc2's 64-column tiles). The operands are rounded to bf16 where the
//   TPU kernel rounds them (LN output, GELU of fc1, GELU of dw:
//   `pallas_chain.py:369, 371, 401`); accumulation is f32.
//   Grid: a block's fixed work (staging its pixels, its halo) does not
//   shrink when its hidden tiles or fc2 columns are split further, so
//   both launches split as far as one wave of the card still holds
//   (`common.cuh:one_wave_per`, from the occupancy calculator), no
//   further. Plan per width, B = 8 (fc1 tiles a block / blocks; tile
//   rows, fc2 tiles a block / blocks): 96x160x18 2 / 1,920, 8, 1 / 1,920;
//   12x20x144 1 / 270, 8, 1 / 144; 96x160x78 5 / 1,920, 8, 2 / 1,920;
//   48x80x156 10 / 480, 8, 3 / 480; 24x40x312 7 / 360, 4, 5 / 240;
//   12x20x624 5 / 240, 4, 4 / 216. At 12x20x624 the first plan's fixed
//   4 tiles (300 blocks) and 2 column splits of 5 (144 blocks) each took
//   a second wave: 0.342 ms, against 0.275 now (H100, 700 W). Shared
//   memory at C = 624: 101,376 B (fc1), 96,768 B (tiles), two blocks an
//   SM each.
//   Why two launches: the TPU kernel keeps the [4C] hidden map on chip,
//   and so did this plan's first form, one fused launch that ran fc1 on
//   the tile plus halo in each block. Measured on an H100 at 700 W it was
//   slower at every width and slower than the plain twin at 12x20x624
//   (0.745 vs 0.46 ms; two launches 0.40): a 4x8 tile's halo is 60 pixels
//   for 32, and each fc2 column split recomputed fc1, so fc1 ran 4.8x its
//   FLOPs. With fc1 once per pixel the hidden map crosses L2 (9.6 MB bf16
//   at 12x20x624, B = 8; 79 MB at 96x160x78, which spills to device
//   memory and is still faster, 0.57 vs 0.63 ms).
//
// "scalar" (float32 activations, and bf16 beyond "mma"): the CUDA-core
// loop that came before "mma", kept for the float32 correctness path. One block per (TH x 8
// tile, image) with LN on the halo tile in f32 shared memory; the hidden
// channels in chunks of KH; f32 FMAs with weight columns read through the
// read-only path (`dot_column`). Shared memory, 4-byte words, NH =
// (TH+2)(TW+2), NP = TH*TW: NH*C + NH*KH + NP*KH [+ NP*C]. One chunk with
// the tallest tile that fits 200 KB where possible (8x8 at C <= 36, 4x8
// at 72 and 78, 2x8 at 144 and 156); else the tallest tile whose chunk of
// at least 32 channels fits (C = 312: TH = 4, 6 chunks of 208; C = 624:
// TH = 2, 9 chunks of 278, 202,048 B). A shape with no plan (C above
// about 1,500) is refused with its byte count (kErrNoPlan).
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W), "mma", bf16,
// B = 8, FLOPs of the model (16 P C^2 + 72 P C for P pixels) over the
// call's time: 27.7 TFLOP/s at 96x160x78 (0.457 ms), 40.4 at 48x80x156,
// 59.4 at 24x40x312, 43.8 at 12x20x624 (0.275 ms), 4.3 at 96x160x18 and
// 8.4 at 12x20x144: 0.4-6 % of the 989 TFLOP/s bf16 peak. Not memory
// (the scratch round trip is 2 x 79 MB at 96x160x78, under 0.05 ms at
// 3.35 TB/s), and not the weight copies: a ring of 3 or 4 stages for fc1
// instead of 2 changed nothing measurable. With parts knocked out at
// 96x160x78 (same card): fc1's GELU is 17 % of its launch and its stores
// 5 %; dw's taps 13 % of the tile launch and its stores 2 %. The rest,
// the tile products and each block's staging at two or three blocks an
// SM, was not separated further. At HRFuser-T's narrow C the padding to
// 64 channels wastes most of each product (C = 18: 18 of 64).
// "scalar": f32 FMAs on CUDA cores.
#include "common.cuh"

namespace hrf {

constexpr int kTw = 8;
constexpr int kFfnThreads = 256;
constexpr size_t kFfnSmemCap = 200 * 1024;
constexpr int kMinHidden = 32;

static size_t ffn_smem(int th, int C, int kh, bool chunked) {
  const size_t halo = (size_t)(th + 2) * (kTw + 2);
  const size_t tile = (size_t)th * kTw;
  return sizeof(float) *
         (halo * C + halo * kh + tile * kh + (chunked ? tile * C : 0));
}

struct FfnPlan {
  int th;  // tile rows; 0: no plan fits
  int kh;  // hidden channels per chunk
  size_t bytes;
};

static FfnPlan ffn_plan(int C, int CH) {
  for (int th = 8; th >= 1; th >>= 1) {
    const size_t bytes = ffn_smem(th, C, CH, false);
    if (bytes <= kFfnSmemCap) return {th, CH, bytes};
  }
  for (int th = 8; th >= 1; th >>= 1) {
    for (int n = 2;; ++n) {
      const int kh = (CH + n - 1) / n;
      if (kh < kMinHidden) break;
      const size_t bytes = ffn_smem(th, C, kh, true);
      if (bytes <= kFfnSmemCap) return {th, kh, bytes};
    }
  }
  return {0, 0, ffn_smem(1, C, kMinHidden, true)};
}

template <typename T>
__global__ void cross_ffn_kernel(
    const T* __restrict__ x, T* __restrict__ out,
    const float* __restrict__ ln, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ wdw,
    const float* __restrict__ bdw, const float* __restrict__ w2,
    const float* __restrict__ b2, int H, int W, int C, int CH, int TH,
    int KH, int ntx) {
  extern __shared__ float smem[];
  const int HW = kTw + 2;
  const int NH = (TH + 2) * HW;
  const int NP = TH * kTw;
  float* xn = smem;              // [NH][C]   LN(x) on the halo tile
  float* hid = xn + NH * C;      // [NH][kh]  GELU(fc1), 0 outside the image
  float* hid2 = hid + NH * KH;   // [NP][kh]  GELU(dw3x3)
  float* acc2 = hid2 + NP * KH;  // [NP][C]   fc2 partial sums (chunked)

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, nwarp = kFfnThreads >> 5;
  const int b = blockIdx.y;
  const int y0 = (blockIdx.x / ntx) * TH, x0 = (blockIdx.x % ntx) * kTw;

  for (int p = warp; p < NH; p += nwarp) {
    const int y = y0 - 1 + p / HW, xx = x0 - 1 + p % HW;
    if (y >= 0 && y < H && xx >= 0 && xx < W)
      warp_layer_norm(x + ((size_t)(b * H + y) * W + xx) * C, ln, xn + p * C,
                      C, lane);
  }
  __syncthreads();

  const int nchunk = (CH + KH - 1) / KH;
  for (int k = 0; k < nchunk; ++k) {
    const int j0 = k * KH, kh = min(KH, CH - j0);
    for (int i = tid; i < NH * kh; i += kFfnThreads) {
      const int p = i / kh, j = i % kh;
      const int y = y0 - 1 + p / HW, xx = x0 - 1 + p % HW;
      float v = 0.f;
      if (y >= 0 && y < H && xx >= 0 && xx < W) {
        v = gelu(dot_column(xn + p * C, w1 + j0 + j, CH, C, b1[j0 + j]));
      }
      hid[i] = v;
    }
    __syncthreads();

    for (int i = tid; i < NP * kh; i += kFfnThreads) {
      const int p = i / kh, j = i % kh;
      const int py = p / kTw, px = p % kTw;
      const float* wj = wdw + (j0 + j) * 9;
      float acc = bdw[j0 + j];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          acc = fmaf(hid[((py + dy) * HW + px + dx) * kh + j],
                     __ldg(wj + dy * 3 + dx), acc);
      hid2[i] = gelu(acc);
    }
    __syncthreads();

    const bool last = k == nchunk - 1;
    for (int i = tid; i < NP * C; i += kFfnThreads) {
      const int p = i / C, j = i % C;
      const int y = y0 + p / kTw, xx = x0 + p % kTw;
      if (y >= H || xx >= W) continue;
      const float acc = dot_column(hid2 + p * kh, w2 + j0 * C + j, C, kh,
                                   k == 0 ? b2[j] : acc2[i]);
      if (last) {
        const size_t g = ((size_t)(b * H + y) * W + xx) * C + j;
        out[g] = store<T>(load(x + g) + gelu(acc));
      } else {
        acc2[i] = acc;
      }
    }
    if (!last) __syncthreads();  // hid2 readers done before the next chunk
  }
}

template <typename T>
static int launch(const void* x, void* out, const float* ln, const float* w1,
                  const float* b1, const float* wdw, const float* bdw,
                  const float* w2, const float* b2, int B, int H, int W,
                  int C, int CH, cudaStream_t stream) {
  const FfnPlan plan = ffn_plan(C, CH);
  if (plan.th == 0) return kErrNoPlan;
  cudaError_t err = cudaFuncSetAttribute(
      cross_ffn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)plan.bytes);
  if (err != cudaSuccess) return (int)err;
  const int nty = (H + plan.th - 1) / plan.th, ntx = (W + kTw - 1) / kTw;
  dim3 grid(nty * ntx, B);
  cross_ffn_kernel<T><<<grid, kFfnThreads, plan.bytes, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), ln, w1, b1, wdw, bdw,
      w2, b2, H, W, C, CH, plan.th, plan.kh, ntx);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// "mma" plan: bf16 on tensor cores, two launches
// ---------------------------------------------------------------------------

constexpr int kHid = 64;       // hidden channels per chunk / fc1 tile
constexpr int kSlice = 64;     // ring slices: [64 rows][64] bf16
constexpr int kNCol = 64;      // fc2 output columns a register tile holds
constexpr int kFc1Rows = 64;   // pixels an fc1 block computes
using Ring = WeightRing<2>;
constexpr int kFfnWarps = kFfnThreads / 32;

template <int TH>
struct MmaTile {
  static constexpr int NH = (TH + 2) * (kTw + 2);  // halo pixels
  static constexpr int MH = round_up(NH, 16);      // halo rows in smem
  static constexpr int NP = TH * kTw;              // tile pixels, fc2 rows
  static constexpr int MT2 = (NP / 16 + 1) / 2;    // fc2 m16 tiles a warp
  static constexpr int NQ = TH == 8 ? 3 : 5;       // fc2 column tiles a block
};

static int ffn_mma_th(int C) {
  return round_up(C, kNCol) / kNCol <= MmaTile<8>::NQ ? 8 : 4;
}

// Shared memory of the fc1 launch (LN(x) of 64 pixels + ring) and of the
// tile launch (hidden chunk on the halo tile, dw output, ring).
static size_t ffn_fc1_smem(int C) {
  return sizeof(bf16) * (size_t)kFc1Rows * padded_stride(round_up(C, 64)) +
         Ring::bytes(kHid, kSlice);
}

// Tile launch: two chunk stages (hidden chunk on the halo tile + the
// chunk's `per` W2 slices) and the dw output.
static size_t ffn_tile_smem(int th, int per) {
  const int mh = round_up((th + 2) * (kTw + 2), 16);
  return sizeof(bf16) * padded_stride(kHid) *
         (2 * (size_t)(mh + per * kNCol) + (size_t)th * kTw);
}

static size_t ffn_mma_bytes(int C) {
  const int th = ffn_mma_th(C);
  return std::max(ffn_fc1_smem(C),
                  ffn_tile_smem(th, th == 8 ? MmaTile<8>::NQ
                                            : MmaTile<4>::NQ));
}

// Launch 1: hbuf[p] = GELU(fc1'(LN x[p])) in bf16 for every pixel p,
// [P][CHP]; one block per (64 pixels, `tpb` hidden tiles of 64).
__global__ void __launch_bounds__(kFfnThreads, 2) ffn_fc1_mma_kernel(
    const bf16* __restrict__ x, const float* __restrict__ ln,
    const bf16* __restrict__ w1p, const float* __restrict__ b1,
    bf16* __restrict__ hbuf, int P, int C, int CH, int tpb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int SR = padded_stride(kSlice);
  const int KP = round_up(C, 64), SX = padded_stride(KP);
  const int CHP = round_up(CH, kHid);
  bf16* xn = reinterpret_cast<bf16*>(smem_raw);  // [64][SX]  LN(x)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2;  // m16 tile, n32 column group
  const Ring ring{xn + kFc1Rows * SX, kHid, kSlice, SR, tid, kFfnThreads};
  const int p0 = blockIdx.x * kFc1Rows, t0 = blockIdx.y * tpb;
  const int nt = min(tpb, CHP / kHid - t0), nks = KP / kSlice;
  auto src = [&](int i) -> const bf16* {
    if (i >= nt * nks) return nullptr;
    return w1p + (size_t)(t0 + i / nks) * kHid * KP + (i % nks) * kSlice;
  };
  auto ld = [KP](int) { return KP; };
  ring.start(src, ld);
  auto live = [&](int r) { return p0 + r < P; };
  stage_rows(
      xn, SX, kFc1Rows, C,
      [&](int r) { return live(r) ? x + (size_t)(p0 + r) * C : nullptr; },
      tid, kFfnThreads);
  __syncthreads();
  ln_rows(xn, SX, kFc1Rows, C, KP, ln, live, warp, kFfnWarps, lane);
  int i = 0;
  for (int t = 0; t < nt; ++t) {
    float acc[1][4][4];
    zero_acc(acc);
    for (int r = 0; r < nks; ++r, ++i) {
      const bf16* w = ring.wait(i, src, ld);  // syncs xn too
      warp_mma(acc, xn + 16 * wm * SX + r * kSlice, SX, 1, 1,
               w + 32 * wn * SR, SR, kSlice / 16, lane);
      ring.release();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + 16 * wm + (lane >> 2) + 8 * h;
        const int col = (t0 + t) * kHid + 32 * wn + 8 * j + 2 * (lane & 3);
        if (p >= P) continue;
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          o[e] = col + e < CH ? gelu(acc[0][j][2 * h + e] + b1[col + e]) : 0.f;
        *reinterpret_cast<unsigned*>(hbuf + (size_t)p * CHP + col) =
            pack_bf16(o[0], o[1]);
      }
  }
}

// Launch 2: one block per (TH x 8 tile, image, fc2 column split). Chunk
// k of 64 hidden channels is one pipeline stage: the tile plus halo of
// hbuf (zero-filled outside the image: the dw conv's zero padding) and
// the chunk's W2 slices for this block's columns, all by cp.async, one
// chunk ahead. Per chunk: dw3x3 + GELU on CUDA cores -> bf16 [TH*8][64],
// then fc2 accumulated in registers; the last GELU and the residual once.
template <int TH>
__global__ void __launch_bounds__(kFfnThreads, 2) ffn_tile_mma_kernel(
    const bf16* __restrict__ x, bf16* __restrict__ out,
    const float* __restrict__ wdw, const float* __restrict__ bdw,
    const bf16* __restrict__ w2p, const float* __restrict__ b2,
    const bf16* __restrict__ hbuf, int H, int W, int C, int CH, int ntx,
    int per_split) {
  using T = MmaTile<TH>;
  constexpr int HW = kTw + 2, SH = padded_stride(kHid);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int CHP = round_up(CH, kHid), NT = round_up(C, kNCol) / kNCol;
  const int stage = (T::MH + per_split * kNCol) * SH;  // elements
  bf16* hd2 = reinterpret_cast<bf16*>(smem_raw);  // [NP][SH]  GELU(dw)
  bf16* stages = hd2 + T::NP * SH;  // 2 x {hid [MH][SH], W2 [per][64][SH]}

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wn = warp & 3, wm = warp >> 2;  // n16 column group, m parity
  const int mc2 = (T::NP / 16 - wm + 1) / 2;
  const int b = blockIdx.y;
  const int y0 = (blockIdx.x / ntx) * TH, x0 = (blockIdx.x % ntx) * kTw;
  const int q0 = blockIdx.z * per_split;       // first fc2 column tile
  const int nq = min(per_split, NT - q0);      // fc2 column tiles here
  const int nchunk = CHP / kHid;
  auto issue = [&](int k) {  // chunk k -> stage k % 2
    bf16* hid = stages + (k & 1) * stage;
    for (int e = tid; e < (T::MH + nq * kNCol) * (kHid / 8);
         e += kFfnThreads) {
      const int row = e / (kHid / 8), c = e % (kHid / 8) * 8;
      if (row < T::MH) {
        const int y = y0 - 1 + row / HW, xx = x0 - 1 + row % HW;
        const bool in = row < T::NH && y >= 0 && y < H && xx >= 0 && xx < W;
        cp_async16_zfill(hid + row * SH + c,
                         in ? hbuf + ((size_t)(b * H + y) * W + xx) * CHP +
                                  k * kHid + c
                            : hbuf,
                         in);
      } else {
        const int n = row - T::MH;  // row of this block's W2 slices
        cp_async16(hid + row * SH + c,
                   w2p + (size_t)(q0 * kNCol + n) * CHP + k * kHid + c);
      }
    }
    cp_async_commit();
  };
  issue(0);
  if (nchunk > 1) issue(1);
  else cp_async_commit();

  float acc2[T::NQ][T::MT2][2][4];
#pragma unroll
  for (int q = 0; q < T::NQ; ++q) zero_acc(acc2[q]);

  for (int k = 0; k < nchunk; ++k) {
    const int j0 = k * kHid;
    const bf16* hid = stages + (k & 1) * stage;
    const bf16* w2s = hid + T::MH * SH;
    cp_async_wait<1>();  // chunk k landed; chunk k + 1 may be in flight
    __syncthreads();
    {  // a thread keeps one channel (kFfnThreads % kHid == 0)
      const int j = tid % kHid;
      const bool live = j0 + j < CH;
      float wk[9], bk = 0.f;
#pragma unroll
      for (int t = 0; t < 9; ++t)
        wk[t] = live ? __ldg(wdw + (j0 + j) * 9 + t) : 0.f;
      if (live) bk = __ldg(bdw + j0 + j);
      for (int p = tid / kHid; p < T::NP; p += kFfnThreads / kHid) {
        const int py = p / kTw, px = p % kTw;
        float a = bk;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            a = fmaf(
                __bfloat162float(hid[((py + dy) * HW + px + dx) * SH + j]),
                wk[dy * 3 + dx], a);
        hd2[p * SH + j] = __float2bfloat16(live ? gelu(a) : 0.f);
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < T::NQ; ++q) {
      if (q >= nq) break;
      warp_mma(acc2[q], hd2 + 16 * wm * SH, SH, 2, mc2,
               w2s + (q * kNCol + 16 * wn) * SH, SH, kHid / 16, lane);
    }
    __syncthreads();  // stage k % 2 and hd2 are free
    if (k + 2 < nchunk) issue(k + 2);
    else cp_async_commit();  // keep one group per chunk for the wait
  }

  // out = x + GELU(fc2 + b2), real pixels and channels only
#pragma unroll
  for (int q = 0; q < T::NQ; ++q) {
    if (q >= nq) break;
#pragma unroll
    for (int mi = 0; mi < T::MT2; ++mi) {
      if (mi >= mc2) break;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = 16 * (wm + 2 * mi) + (lane >> 2) + 8 * h;
          const int y = y0 + p / kTw, xx = x0 + p % kTw;
          if (y >= H || xx >= W) continue;
          const int col =
              (q0 + q) * kNCol + 16 * wn + 8 * j + 2 * (lane & 3);
          const size_t g = ((size_t)(b * H + y) * W + xx) * C;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = col + e;
            if (n < C)
              out[g + n] = __float2bfloat16(
                  load(x + g + n) + gelu(acc2[q][mi][j][2 * h + e] + b2[n]));
          }
        }
    }
  }
}

static int launch_fc1(const void* x, const float* ln, const bf16* w1p,
                      const float* b1, bf16* hbuf, int P, int C, int CH,
                      cudaStream_t stream) {
  const size_t bytes = ffn_fc1_smem(C);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_fc1_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles = round_up(CH, kHid) / kHid;
  const int rows = (P + kFc1Rows - 1) / kFc1Rows;
  const int wave = wave_blocks(
      reinterpret_cast<const void*>(ffn_fc1_mma_kernel), kFfnThreads, bytes);
  const int tpb = one_wave_per(rows, tiles, 1, [wave](int) { return wave; });
  dim3 grid(rows, (tiles + tpb - 1) / tpb);
  ffn_fc1_mma_kernel<<<grid, kFfnThreads, bytes, stream>>>(
      static_cast<const bf16*>(x), ln, w1p, b1, hbuf, P, C, CH, tpb);
  return (int)cudaGetLastError();
}

template <int TH>
static int launch_tiles(const void* x, void* out, const float* wdw,
                        const float* bdw, const bf16* w2p, const float* b2,
                        const bf16* hbuf, int B, int H, int W, int C, int CH,
                        cudaStream_t stream) {
  // fc2's column tiles: at most NQ a block (its registers), fewer where
  // the split still runs in one wave
  const int nt = round_up(C, kNCol) / kNCol;
  const int lo = (nt + MmaTile<TH>::NQ - 1) / MmaTile<TH>::NQ;
  cudaError_t err = cudaFuncSetAttribute(
      ffn_tile_mma_kernel<TH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)ffn_tile_smem(TH, (nt + lo - 1) / lo));
  if (err != cudaSuccess) return (int)err;
  const int nty = (H + TH - 1) / TH, ntx = (W + kTw - 1) / kTw;
  const int per = one_wave_per((long long)nty * ntx * B, nt, lo, [](int q) {
    return wave_blocks(reinterpret_cast<const void*>(ffn_tile_mma_kernel<TH>),
                       kFfnThreads, ffn_tile_smem(TH, q));
  });
  const size_t bytes = ffn_tile_smem(TH, per);
  dim3 grid(nty * ntx, B, (nt + per - 1) / per);
  ffn_tile_mma_kernel<TH><<<grid, kFfnThreads, bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), wdw, bdw, w2p, b2,
      hbuf, H, W, C, CH, ntx, per);
  return (int)cudaGetLastError();
}

static int launch_mma(const void* x, void* out, const float* ln,
                      const bf16* w1p, const float* b1, const float* wdw,
                      const float* bdw, const bf16* w2p, const float* b2,
                      bf16* hbuf, int B, int H, int W, int C, int CH,
                      cudaStream_t stream) {
  const int err = launch_fc1(x, ln, w1p, b1, hbuf, B * H * W, C, CH, stream);
  if (err != 0) return err;
  if (ffn_mma_th(C) == 8)
    return launch_tiles<8>(x, out, wdw, bdw, w2p, b2, hbuf, B, H, W, C, CH,
                           stream);
  return launch_tiles<4>(x, out, wdw, bdw, w2p, b2, hbuf, B, H, W, C, CH,
                         stream);
}

static bool ffn_mma_fits(int C) { return ffn_mma_bytes(C) <= kSmemMax; }

}  // namespace hrf

// The plan for (C, hidden, dtype): *mma = 1 for the tensor-core plan
// (*kh is then its chunk of 64), 0 for the scalar plan; *th = 0: none
// fits. Returns the shared memory of its largest launch in bytes.
extern "C" long long hrf_cross_ffn_plan(int C, int CH, int bf16, int* th,
                                        int* kh, int* mma) {
  if (bf16 && hrf::ffn_mma_fits(C)) {
    *th = hrf::ffn_mma_th(C);
    *kh = hrf::kHid;
    *mma = 1;
    return (long long)hrf::ffn_mma_bytes(C);
  }
  const hrf::FfnPlan plan = hrf::ffn_plan(C, CH);
  *th = plan.th;
  *kh = plan.kh;
  *mma = 0;
  return (long long)plan.bytes;
}

// w1p [round64(CH)][round64(C)], w2p [round64(C)][round64(CH)]: bf16
// weights packed for the tensor-core plan (bf16 activations only); hbuf
// [B*H*W][round64(CH)] its bf16 scratch for GELU(fc1).
extern "C" int hrf_cross_ffn(const void* x, void* out, const float* ln,
                             const float* w1, const float* b1,
                             const float* wdw, const float* bdw,
                             const float* w2, const float* b2,
                             const void* w1p, const void* w2p, void* hbuf,
                             int B, int H, int W, int C, int CH, int bf16,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16 && hrf::ffn_mma_fits(C)) {
    if (w1p == nullptr || w2p == nullptr || hbuf == nullptr)
      return hrf::kErrNoPlan;
    return hrf::launch_mma(x, out, ln, static_cast<const hrf::bf16*>(w1p), b1,
                           wdw, bdw, static_cast<const hrf::bf16*>(w2p), b2,
                           static_cast<hrf::bf16*>(hbuf), B, H, W, C, CH, s);
  }
  if (bf16)
    return hrf::launch<__nv_bfloat16>(x, out, ln, w1, b1, wdw, bdw, w2, b2, B,
                                      H, W, C, CH, s);
  return hrf::launch<float>(x, out, ln, w1, b1, wdw, bdw, w2, b2, B, H, W, C,
                            CH, s);
}
