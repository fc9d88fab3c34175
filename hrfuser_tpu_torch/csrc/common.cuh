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

// LayerNorm of one C-vector by one warp, with the zero-variance guard of
// hrfuser_tpu/layers/common.py:224 (a constant row maps to `bias`).
// `ln` is [2, C]: scale then bias. Writes C floats to `dst`.
template <typename T>
__device__ __forceinline__ void warp_layer_norm(const T* __restrict__ row,
                                                const float* __restrict__ ln,
                                                float* dst, int C, int lane) {
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += load(row + c);
  const float mean = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = load(row + c) - mean;
    v += d * d;
  }
  const float var = warp_sum(v) / C;
  const float inv = var > 0.f ? 1.0f / sqrtf(var + 1e-6f) : 0.f;
  for (int c = lane; c < C; c += 32)
    dst[c] = (load(row + c) - mean) * inv * ln[c] + ln[C + c];
}

}  // namespace hrf
