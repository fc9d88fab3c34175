// Kernel B: CrossFFN half of an HRFormer / HRFuser block, eval.
//
// Replaces the FFN segment of the TPU Pallas kernels
// hrfuser_tpu/ops/pallas_chain.py:_chain_kernel and :_fusion_kernel
// (_ffn_segment at :362, with the BatchNorms folded as in
// hrfuser_tpu/ops/pallas_block.py:_fold_bn):
//
//   out = x + GELU(fc2'(GELU(dw3x3'(GELU(fc1'(LN(x)))))))
//
// where fc1', dw3x3', fc2' carry their folded BN scale and shift. GELU is
// the exact erf form (the TPU kernel used an Abramowitz-Stegun erf
// because Mosaic had none). The depthwise 3x3 zero-pads the hidden map at
// the real image edge.
//
// One block per (TH x TW spatial tile, image). The block computes LN and
// fc1 + GELU on the tile plus a one-pixel halo (recomputing the halo that
// its neighbours also compute), keeps that hidden map in shared memory,
// runs the depthwise 3x3 + GELU on the tile, then fc2 + GELU + residual.
// The [4C]-wide hidden map never goes to device memory.
//
// What bounds it on the H100: the two 1x1 projections (C x 4C each per
// pixel) as scalar FMAs on CUDA cores; the halo recompute adds
// (TH+2)(TW+2)/(TH TW) to fc1. Shared memory (up to ~200 KB for the
// f32 hidden map at C = 144) holds one block per SM. The host picks the
// tallest tile that fits. Tensor-core MMA for the projections is later
// work.
#include "common.cuh"

namespace hrf {

constexpr int kTw = 8;
constexpr size_t kSmemCap = 200 * 1024;

static size_t ffn_smem(int th, int C, int CH) {
  const size_t halo = (size_t)(th + 2) * (kTw + 2);
  return sizeof(float) * (halo * C + halo * CH + (size_t)th * kTw * CH);
}

template <typename T>
__global__ void cross_ffn_kernel(
    const T* __restrict__ x, T* __restrict__ out,
    const float* __restrict__ ln, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ wdw,
    const float* __restrict__ bdw, const float* __restrict__ w2,
    const float* __restrict__ b2, int H, int W, int C, int CH, int TH,
    int ntx) {
  extern __shared__ float smem[];
  const int HW = kTw + 2;
  const int NH = (TH + 2) * HW;
  const int NP = TH * kTw;
  float* xn = smem;            // [NH][C]  LN(x) on the halo tile
  float* hid = xn + NH * C;    // [NH][CH] GELU(fc1), 0 outside the image
  float* hid2 = hid + NH * CH; // [NP][CH] GELU(dw3x3)

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarp = nthr >> 5;
  const int b = blockIdx.y;
  const int y0 = (blockIdx.x / ntx) * TH, x0 = (blockIdx.x % ntx) * kTw;

  for (int p = warp; p < NH; p += nwarp) {
    const int y = y0 - 1 + p / HW, xx = x0 - 1 + p % HW;
    if (y >= 0 && y < H && xx >= 0 && xx < W)
      warp_layer_norm(x + ((size_t)(b * H + y) * W + xx) * C, ln, xn + p * C,
                      C, lane);
  }
  __syncthreads();

  for (int i = tid; i < NH * CH; i += nthr) {
    const int p = i / CH, j = i % CH;
    const int y = y0 - 1 + p / HW, xx = x0 - 1 + p % HW;
    float v = 0.f;
    if (y >= 0 && y < H && xx >= 0 && xx < W) {
      const float* a = xn + p * C;
      float acc = b1[j];
      for (int c = 0; c < C; ++c) acc = fmaf(a[c], __ldg(w1 + c * CH + j), acc);
      v = gelu(acc);
    }
    hid[i] = v;
  }
  __syncthreads();

  for (int i = tid; i < NP * CH; i += nthr) {
    const int p = i / CH, j = i % CH;
    const int py = p / kTw, px = p % kTw;
    const float* wj = wdw + j * 9;
    float acc = bdw[j];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        acc = fmaf(hid[((py + dy) * HW + px + dx) * CH + j], __ldg(wj + dy * 3 + dx),
                   acc);
    hid2[i] = gelu(acc);
  }
  __syncthreads();

  for (int i = tid; i < NP * C; i += nthr) {
    const int p = i / C, j = i % C;
    const int y = y0 + p / kTw, xx = x0 + p % kTw;
    if (y >= H || xx >= W) continue;
    const float* a = hid2 + p * CH;
    float acc = b2[j];
    for (int c = 0; c < CH; ++c) acc = fmaf(a[c], __ldg(w2 + c * C + j), acc);
    const size_t g = ((size_t)(b * H + y) * W + xx) * C + j;
    out[g] = store<T>(load(x + g) + gelu(acc));
  }
}

template <typename T>
static int launch(const void* x, void* out, const float* ln, const float* w1,
                  const float* b1, const float* wdw, const float* bdw,
                  const float* w2, const float* b2, int B, int H, int W,
                  int C, int CH, cudaStream_t stream) {
  int th = 8;
  while (th > 1 && ffn_smem(th, C, CH) > kSmemCap) th >>= 1;
  const size_t smem = ffn_smem(th, C, CH);
  cudaError_t err = cudaFuncSetAttribute(
      cross_ffn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nty = (H + th - 1) / th, ntx = (W + kTw - 1) / kTw;
  dim3 grid(nty * ntx, B);
  cross_ffn_kernel<T><<<grid, 256, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), ln, w1, b1, wdw, bdw,
      w2, b2, H, W, C, CH, th, ntx);
  return (int)cudaGetLastError();
}

}  // namespace hrf

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
