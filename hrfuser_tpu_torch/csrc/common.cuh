// Shared helpers for the hand-written Hopper kernels.
//
// Activations are float or __nv_bfloat16 (template parameter T); every
// kernel loads them as float, computes in float and rounds once on store.
// Weights and folded norm parameters are always float.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hrf {

template <typename T>
__device__ __forceinline__ float load(const T* p);

template <>
__device__ __forceinline__ float load<float>(const float* p) {
  return *p;
}

template <>
__device__ __forceinline__ float load<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ T store(float v);

template <>
__device__ __forceinline__ float store<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ __nv_bfloat16 store<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Exact (erf) GELU, as torch.nn.GELU() and flax nn.gelu(approximate=False).
__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.7071067811865476f));
}

// LayerNorm statistics of one C-vector by one warp, with the zero-variance
// guard of hrfuser_tpu/layers/common.py:224: a constant row gets rstd 0,
// so it maps to `bias`. Every lane returns the same mean and rstd.
template <typename T>
__device__ __forceinline__ void warp_ln_stats(const T* __restrict__ row,
                                              int C, int lane, float& mean,
                                              float& rstd) {
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += load(row + c);
  mean = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = load(row + c) - mean;
    v += d * d;
  }
  const float var = warp_sum(v) / C;
  rstd = var > 0.f ? 1.0f / sqrtf(var + 1e-6f) : 0.f;
}

// LayerNorm of one C-vector by one warp. `ln` is [2, C]: scale then bias.
// Writes C floats to `dst`.
template <typename T>
__device__ __forceinline__ void warp_layer_norm(const T* __restrict__ row,
                                                const float* __restrict__ ln,
                                                float* dst, int C, int lane) {
  float mean, rstd;
  warp_ln_stats(row, C, lane, mean, rstd);
  for (int c = lane; c < C; c += 32)
    dst[c] = (load(row + c) - mean) * rstd * ln[c] + ln[C + c];
}

// acc + sum_{c < n} a[c] * w[c * stride], with `a` in shared memory and
// `w` a weight column read through the read-only path. The projections
// are latency bound (few warps per SM, one FMA chain per thread), so each
// batch of 16 weight loads is issued before its FMAs: 16 reads in flight
// per thread, independent of how the compiler schedules a plain loop.
__device__ __forceinline__ float dot_column(const float* a,
                                            const float* __restrict__ w,
                                            int stride, int n, float acc) {
  constexpr int kBatch = 16;
  int c = 0;
  for (; c + kBatch <= n; c += kBatch) {
    float wv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) wv[u] = __ldg(w + (c + u) * stride);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) acc = fmaf(a[c + u], wv[u], acc);
  }
  for (; c < n; ++c) acc = fmaf(a[c], __ldg(w + c * stride), acc);
  return acc;
}

// Largest dynamic shared memory a block may use on the H100 (227 KB).
constexpr size_t kSmemMax = 232448;

// Returned by a launcher when no shared-memory plan fits the shape; the
// host queries the plan's byte count to say why.
constexpr int kErrNoPlan = 100000;

}  // namespace hrf
