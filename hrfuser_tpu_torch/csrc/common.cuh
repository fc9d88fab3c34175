// Shared helpers for the hand-written Hopper kernels.
//
// Activations are float or __nv_bfloat16 (template parameter T). The
// CUDA-core ("scalar") plans load them as float, compute in float and
// round once on store, with float weights. The tensor-core ("mma") plans
// take bf16 activations and bf16 weights packed at fold time, multiply
// bf16 operands with f32 accumulation, and round to bf16 where the TPU
// kernels do. Biases and norm parameters are always float.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

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

// ---------------------------------------------------------------------------
// Tensor-core tile products (bf16 operands, f32 accumulators)
// ---------------------------------------------------------------------------
//
// `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32` fed by `ldmatrix`
// from shared memory. An operand A is [M][K] bf16, K contiguous; an operand
// B is stored as [N][K] bf16, K contiguous (the weight transposed, as
// `ops/chain.py:pack_*` lay it out at fold time). Row strides of shared
// tiles are `padded_stride(K)`: an odd number of 16-byte units, so the 8
// rows an `ldmatrix` reads fall in 8 distinct bank groups.
//
// Weights reach shared memory through `cp.async.cg` (16 bytes a copy,
// bypassing L1) into a ring of K-slices (`WeightRing`): the next slices
// load while the current one multiplies.
//
// Accumulator fragment of one m16n8 tile, as the PTX ISA lays it out:
// c[0], c[1] at row lane/4, columns 2*(lane%4) + {0, 1}; c[2], c[3] at
// row lane/4 + 8.

using bf16 = __nv_bfloat16;

// Row stride (elements) of a shared bf16 tile with k columns, k % 8 == 0.
__host__ __device__ constexpr int padded_stride(int k) {
  return (k / 8) % 2 == 0 ? k + 8 : k;
}

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

// 16 bytes, or 16 zero bytes when !valid (src is then not read).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A fragment of a 16x16 tile at `a` (row stride `lda` elements).
__device__ __forceinline__ void ldmatrix_a(unsigned (&r)[4], const bf16* a,
                                           int lda, int lane) {
  const bf16* p = a + (lane & 15) * lda + (lane >> 4) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// B fragment of an n8 x k16 tile stored [N][K] at `b` (row stride `ldb`).
__device__ __forceinline__ void ldmatrix_b(unsigned (&r)[2], const bf16* b,
                                           int ldb, int lane) {
  const bf16* p = b + (lane & 7) * ldb + ((lane >> 3) & 1) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// B fragment of a k16 x n8 tile stored [K][N] (N contiguous) at `b`.
__device__ __forceinline__ void ldmatrix_b_trans(unsigned (&r)[2],
                                                 const bf16* b, int ldb,
                                                 int lane) {
  const bf16* p = b + (lane & 15) * ldb;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// One warp's share of C[M x N] += A[M x K] . B[K x N] over k16 steps:
// MT m16 tiles (rows a + 16 * mstep * i, those with i < mcount) by NT n8
// tiles (B rows b + 8 * j). A and B point at the k-origin of the slice.
template <int MT, int NT>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4],
                                         const bf16* a, int lda, int mstep,
                                         int mcount, const bf16* b, int ldb,
                                         int ksteps, int lane) {
  for (int ks = 0; ks < ksteps; ++ks) {
    unsigned bf[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      ldmatrix_b(bf[j], b + 8 * j * ldb + 16 * ks, ldb, lane);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i >= mcount) break;
      unsigned af[4];
      ldmatrix_a(af, a + 16 * mstep * i * lda + 16 * ks, lda, lane);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], af, bf[j]);
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// Rows r < rows of C bf16 values into shared memory at dst + r * ld, by
// every thread of the block at once (one round trip to memory for all
// rows, where a warp per row would wait for each in turn). `src(r)` is
// row r's first value, nullptr for a row of zeros. Row starts are 4-byte
// aligned when C is even (contiguous bf16 tensors).
template <class Src>
__device__ __forceinline__ void stage_rows(bf16* dst, int ld, int rows,
                                           int C, Src src, int tid,
                                           int nthreads) {
  if (C % 2 == 0) {
    const int half = C / 2;
    for (int e = tid; e < rows * half; e += nthreads) {
      const int r = e / half, c = 2 * (e - r * half);
      const bf16* s = src(r);
      *reinterpret_cast<unsigned*>(dst + r * ld + c) =
          s != nullptr ? *reinterpret_cast<const unsigned*>(s + c) : 0u;
    }
  } else {
    for (int e = tid; e < rows * C; e += nthreads) {
      const int r = e / C, c = e - r * C;
      const bf16* s = src(r);
      dst[r * ld + c] = s != nullptr ? s[c] : __float2bfloat16(0.f);
    }
  }
}

// LayerNorm in place of staged bf16 rows r < rows (stride ld), a warp a
// row; `ln` [2][C] scale then bias, nullptr: none. Rows with !live(r)
// become zero (a zero LN output), and so do columns [C, KP).
template <class Live>
__device__ __forceinline__ void ln_rows(bf16* x, int ld, int rows, int C,
                                        int KP, const float* ln, Live live,
                                        int warp, int nwarps, int lane) {
  for (int r = warp; r < rows; r += nwarps) {
    bf16* row = x + r * ld;
    if (!live(r)) {
      for (int c = lane; c < KP; c += 32) row[c] = __float2bfloat16(0.f);
      continue;
    }
    float mean = 0.f, rstd = 1.f;
    if (ln != nullptr) warp_ln_stats(row, C, lane, mean, rstd);
    for (int c = lane; c < KP; c += 32) {
      float v = 0.f;
      if (c < C) {
        v = load(row + c);
        if (ln != nullptr) v = (v - mean) * rstd * ln[c] + ln[C + c];
      }
      row[c] = __float2bfloat16(v);
    }
  }
}

// Ring of NS stages of bf16 weight slices [rows][cols] in shared memory,
// filled by cp.async, NS - 1 slices ahead of the one being multiplied.
// The block walks a fixed sequence of slices; slice i sits in stage
// i % NS. `src(i)` gives slice i's first element (nullptr past the end)
// and `ld(i)` its row stride in device memory. Every thread of the block:
//   ring.start(src, ld);                   // once
//   for each slice i:
//     const bf16* w = ring.wait(i, src, ld);
//     ... multiply with w (row stride ring.stride) ...
//     ring.release();
template <int NS>
struct WeightRing {
  bf16* buf;
  int rows, cols, stride;  // slice shape; stride = padded_stride(cols)
  int tid, nthreads;

  __device__ void load(int stage, const bf16* src, int ld) const {
    bf16* dst = buf + stage * rows * stride;
    const int per_row = cols / 8;
    for (int i = tid; i < rows * per_row; i += nthreads) {
      const int r = i / per_row, c = (i - r * per_row) * 8;
      cp_async16(dst + r * stride + c, src + (size_t)r * ld + c);
    }
  }
  template <class Src, class Ld>
  __device__ void start(Src src, Ld ld) const {
#pragma unroll
    for (int s = 0; s < NS - 1; ++s) {
      const bf16* p = src(s);
      if (p != nullptr) load(s, p, ld(s));
      cp_async_commit();
    }
  }
  // Prefetch slice i + NS - 1, then wait for slice i.
  template <class Src, class Ld>
  __device__ const bf16* wait(int i, Src src, Ld ld) const {
    const int n = i + NS - 1;
    const bf16* p = src(n);
    if (p != nullptr) load(n % NS, p, ld(n));
    cp_async_commit();
    cp_async_wait<NS - 1>();
    __syncthreads();
    return buf + (i % NS) * rows * stride;
  }
  // Every warp is done with the current slice; its stage may be refilled.
  __device__ void release() const { __syncthreads(); }
  static size_t bytes(int rows, int cols) {
    return NS * sizeof(bf16) * (size_t)rows * padded_stride(cols);
  }
};

// Blocks of `kernel` the card runs at once: its SMs times the blocks one
// SM holds at `threads` threads and `smem` bytes of dynamic shared memory,
// as the occupancy calculator gives it (at least 1). Cached, as every
// launch asks; the kernel's dynamic shared memory limit must allow `smem`.
inline int wave_blocks(const void* kernel, int threads, size_t smem) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int, size_t>, int> seen;
  int dev = 0;
  cudaGetDevice(&dev);
  const auto key = std::make_tuple(dev, kernel, threads, smem);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = seen.find(key);
  if (it != seen.end()) return it->second;
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  return seen[key] = std::max(1, sms * per_sm);
}

// Units per block when a launch of `base` blocks splits `n` units (heads,
// column tiles, hidden tiles) further, each block taking `per` of them,
// at most ceil(n / lo): the fewest per block whose blocks all run in one
// wave (`wave(per)` blocks at once), else ceil(n / lo). One more split
// would add a wave, which costs more than the units it takes off each
// block, because a block's fixed work (staging its tokens or pixels)
// does not shrink with them.
template <class Wave>
int one_wave_per(long long base, int n, int lo, Wave wave) {
  int best = (n + lo - 1) / lo;
  for (int s = lo; s <= n; ++s) {
    const int per = (n + s - 1) / s;
    if (base * ((n + per - 1) / per) <= wave(per)) best = std::min(best, per);
  }
  return best;
}

// Returned by a launcher when no shared-memory plan fits the shape; the
// host queries the plan's byte count to say why.
constexpr int kErrNoPlan = 100000;

}  // namespace hrf
