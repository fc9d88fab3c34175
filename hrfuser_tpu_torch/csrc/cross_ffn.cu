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
// One block per (TH x TW spatial tile, image). The block computes LN on
// the tile plus a one-pixel halo (recomputing the halo that its
// neighbours also compute) and keeps it in shared memory. The hidden
// channels are walked in chunks of KH: fc1 + GELU on the halo, then the
// depthwise 3x3 + GELU on the tile (both per channel), then the chunk's
// share of fc2 is accumulated into an f32 [TH*TW][C] buffer. The final
// GELU and the residual are applied once, after the last chunk. With one
// chunk (KH = hidden) the accumulator is not needed and fc2 writes the
// output directly. The [4C]-wide hidden map never goes to device memory.
//
// Shared memory, 4-byte words, NH = (TH+2)(TW+2) halo pixels, NP = TH*TW:
//   NH*C (LN) + NH*KH (fc1) + NP*KH (dw) [+ NP*C (fc2 accumulator)].
// The host keeps one chunk with the tallest tile that fits 200 KB (8x8 at
// C <= 36, 4x8 at 72 and 78, 2x8 at 144 and 156); otherwise it takes the
// tallest tile for which a chunk of at least 32 channels fits, balanced
// over the hidden channels. C = 312, hidden 1,248: TH = 4 and 6 chunks of
// 208, 191,360 B. C = 624, hidden 2,496: TH = 2 and 9 chunks of 278
// (NH = 40, NP = 16), 202,048 B; one chunk would take 658,944 B at TH = 2.
// A shape with no plan (C above about 1,500) is refused with its byte
// count (kErrNoPlan).
//
// What bounds it on the H100: the two 1x1 projections (C x 4C each per
// pixel) as scalar FMAs on CUDA cores; the halo recompute adds
// (TH+2)(TW+2)/(TH TW) to fc1. Shared memory holds one block per SM.
// Tensor-core MMA for the projections is later work.
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

}  // namespace hrf

// Shared memory of the plan for (C, hidden); *th = 0: none fits.
extern "C" long long hrf_cross_ffn_plan(int C, int CH, int* th, int* kh) {
  const hrf::FfnPlan plan = hrf::ffn_plan(C, CH);
  *th = plan.th;
  *kh = plan.kh;
  return (long long)plan.bytes;
}

extern "C" int hrf_cross_ffn(const void* x, void* out, const float* ln,
                             const float* w1, const float* b1,
                             const float* wdw, const float* bdw,
                             const float* w2, const float* b2, int B, int H,
                             int W, int C, int CH, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return hrf::launch<__nv_bfloat16>(x, out, ln, w1, b1, wdw, bdw, w2, b2, B,
                                      H, W, C, CH, s);
  return hrf::launch<float>(x, out, ln, w1, b1, wdw, bdw, w2, b2, B, H, W, C,
                            CH, s);
}
