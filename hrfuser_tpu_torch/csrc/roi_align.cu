// Kernel C: aligned multilevel RoIAlign, 7x7 bins x 2x2 samples.
//
// Replaces the TPU Pallas kernels of hrfuser_tpu/ops/pallas_roi_align.py,
// multilevel_roi_align_pallas -> _call: pallas_call :597 (_kernel_v7, the
// default eval pool of every cascade stage), :633 (_kernel_v4) and :558
// (_kernel_v8). They are three schedules of one function, served here by
// one kernel.
//
// The function (hrfuser_tpu/ops/roi_align.py:157-192,282-315): each RoI
// (all images' RoIs flattened) takes its FPN level as map_roi_levels does
// (floor(log2(sqrt(wh) / finest + 1e-6)), clipped to [0, 3]); per axis its
// 14 sample coordinates follow _bilinear_weights: a sample counts when it
// lies in (-1, size), is clamped to [0, size - 1], and hi = min(lo + 1,
// size - 1); the aligned -0.5 offset is applied. Samples are accumulated
// in f32 and rounded once on store (the TPU kernel's bf16 round between
// its x- and y-pools is not copied). Output rows are [B, N, 49, C], bins
// in (y, x) row-major order. Zero-padded proposals, boxes outside the
// image and full-width slivers need no special path. The coordinates are
// written with __fmul_rn / __fsub_rn / __fdiv_rn / __fadd_rn so that nvcc
// cannot contract them into an FMA, which would move floor() across a
// pixel boundary for some RoIs against the plain twin.
//
// What bounds it on the H100: bytes. Per RoI it writes 49 x C outputs and
// reads 196 samples x 4 taps x C, under 1 FLOP per byte of those reads,
// so it is a gather: staging pixels and tensor cores buy nothing. The
// least it must move is the output plus the pyramid pixels its RoIs touch
// (each once): at r640, C = 256, 8 x 1000 RoIs, bf16 that is 200.7 MB of
// output plus at most the 83.6 MB pyramid, 60-85 us at 3.35 TB/s. The
// taps themselves are 3.2 GB of reads at that size, so what the card
// really spends is L1/L2 bandwidth and load instructions.
//
// The design, against that:
//  - 16-byte vectors along C: a lane owns 8 bf16 (4 f32) channels, so a
//    warp reads a C = 256 bf16 pixel in one 512-byte request and writes a
//    bin in one 16-byte store a lane (evict-first: the output is not read
//    again here, the pyramid is).
//  - A thread owns one bin row (RoI, py) of its lane's channels and walks
//    its 14 x samples in order: it y-pools a pixel column once (4 taps,
//    the two y samples' lo and hi rows) and x-pools the columns, reusing a
//    column that the previous sample used already. The sample spacing is
//    under 2 pixels for an RoI on its own level, often under 1, so this
//    cuts the tap loads by up to 14x on small RoIs and changes nothing on
//    RoIs with 2 pixels or more between samples.
//  - An RoI's level, image and 28 taps are computed once, by 29 threads,
//    into a table in shared memory (464 bytes), double-buffered so that
//    the next RoI's table is built while this one pools; every lane reads
//    its taps from there as broadcasts.
//  - The 7 bin rows of an RoI run on the 7 warps of a block at once, so
//    rows shared between neighbouring bin rows are L1 hits; blocks walk
//    the RoIs in order, so the RoIs in flight belong to one or two images
//    and their pyramid (10.4 MB a bf16 image at C = 256) stays in the
//    50 MB L2. The grid is one wave (`common.cuh:wave_blocks`, from the
//    occupancy calculator).
//  - The host requires C % 8 == 0 (bf16) or C % 4 == 0 (f32) and 16-byte
//    aligned levels; there is no scalar path.
//
// Measured against knock-out copies (PERF.md, chip_profile.py): with every
// tap an L1 hit the bf16 kernel is 14 % faster, without its stores 20 %,
// with neither 20 %, so in bf16 it is bound by its load, unpack and FMA
// instructions and not by misses, and an RoI's footprint is not staged in
// shared memory. float32 moves twice the bytes and halves with every tap
// a hit.
#include "common.cuh"

namespace hrf {

constexpr int kOut = 7;
constexpr int kGrid = 2;
constexpr int kSamp = kOut * kGrid;  // samples an axis
constexpr int kRoiThreads = 512;  // most threads a block; C = 256 f32: 448

struct Pyramid {
  const void* f[4];
  int h[4];
  int w[4];
  float scale[4];
};

// One sample on one axis: its two taps and their masked weights.
struct __align__(16) Tap {
  int lo, hi;
  float wlo, whi;
};

// Sample k (of 14) on an axis whose aligned RoI edges are a1, a2.
__device__ __forceinline__ Tap axis_tap(float a1, float bin, int k,
                                        int size) {
  const float frac = (float)(k / kGrid) + ((k % kGrid) + 0.5f) / kGrid;
  const float coord = __fadd_rn(a1, __fmul_rn(frac, bin));
  const bool inside = coord > -1.f && coord < (float)size;
  const float c = fminf(fmaxf(coord, 0.f), (float)(size - 1));
  const int lo = (int)floorf(c);
  const float whi = c - (float)lo;
  return {lo, min(lo + 1, size - 1), inside ? 1.f - whi : 0.f,
          inside ? whi : 0.f};
}

// What the bin rows of one RoI share, built once per RoI in shared memory:
// its image at its level, the level's width and the 14 taps of each axis.
// y taps hold pixel-row offsets (lo * W, hi * W) and carry the 1 / 4 of
// the 2 x 2 sample mean (a power of two: exact).
struct RoiTab {
  const uint4* f;
  int W, pad;
  Tap x[kSamp];
  Tap y[kSamp];
};
constexpr int kTabItems = 2 * kSamp + 1;  // x taps, y taps, header

// Item k of RoI r's table.
__device__ __forceinline__ void fill(RoiTab& tab, const Pyramid& pyr,
                                     const float* __restrict__ rois, int r,
                                     int N, int V, int k, float finest) {
  const float* box = rois + 4 * (size_t)r;
  const float x1 = __ldg(box), y1 = __ldg(box + 1);
  const float x2 = __ldg(box + 2), y2 = __ldg(box + 3);
  const float area = (x2 - x1) * (y2 - y1);
  const float l = floorf(log2f(sqrtf(area) / finest + 1e-6f));
  const int lvl = l >= 3.f ? 3 : (l >= 0.f ? (int)l : 0);
  const int H = pyr.h[lvl], W = pyr.w[lvl];
  const float s = pyr.scale[lvl];
  if (k < kSamp) {
    const float a1 = __fsub_rn(__fmul_rn(x1, s), 0.5f);
    const float a2 = __fsub_rn(__fmul_rn(x2, s), 0.5f);
    tab.x[k] = axis_tap(a1, __fdiv_rn(__fsub_rn(a2, a1), (float)kOut), k, W);
  } else if (k < 2 * kSamp) {
    const float a1 = __fsub_rn(__fmul_rn(y1, s), 0.5f);
    const float a2 = __fsub_rn(__fmul_rn(y2, s), 0.5f);
    Tap t = axis_tap(a1, __fdiv_rn(__fsub_rn(a2, a1), (float)kOut),
                     k - kSamp, H);
    constexpr float norm = 1.f / (kGrid * kGrid);
    tab.y[k - kSamp] = {t.lo * W, t.hi * W, t.wlo * norm, t.whi * norm};
  } else {
    tab.f = static_cast<const uint4*>(pyr.f[lvl]) +
            (size_t)(r / N) * H * W * V;
    tab.W = W;
  }
}

// 16 bytes of T as floats.
template <typename T>
struct Vec {
  static constexpr int n = 16 / sizeof(T);
};

__device__ __forceinline__ void unpack(const uint4& d, float (&v)[8]) {
  const unsigned u[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __uint_as_float(u[j] << 16);
    v[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack(const uint4& d, float (&v)[4]) {
  v[0] = __uint_as_float(d.x);
  v[1] = __uint_as_float(d.y);
  v[2] = __uint_as_float(d.z);
  v[3] = __uint_as_float(d.w);
}

__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                    pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

__device__ __forceinline__ uint4 pack(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}

// The y-pool of NC pixel columns xs[] of one bin row: g[j] = sum over the
// row's 4 y taps of wy * f[y][xs[j]]. All 4 * NC loads are issued first.
template <int NC, int E>
__device__ __forceinline__ void columns(const uint4* __restrict__ f, int V,
                                        const int (&yoff)[4],
                                        const float (&wy)[4],
                                        const int (&xs)[NC],
                                        float (&g)[NC][E]) {
  uint4 d[NC][4];
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int t = 0; t < 4; ++t)
      d[j][t] = __ldg(f + (size_t)(yoff[t] + xs[j]) * V);
#pragma unroll
  for (int j = 0; j < NC; ++j) {
#pragma unroll
    for (int e = 0; e < E; ++e) g[j][e] = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      float v[E];
      unpack(d[j][t], v);
#pragma unroll
      for (int e = 0; e < E; ++e) g[j][e] = fmaf(wy[t], v[e], g[j][e]);
    }
  }
}

// One bin row py of an RoI, 16-byte lane v: 7 output vectors at o.
template <typename T>
__device__ __forceinline__ void pool_row(const RoiTab& tab,
                                         uint4* __restrict__ o, int V,
                                         int py, int v) {
  constexpr int E = Vec<T>::n;
  const uint4* f = tab.f + v;
  const int W = tab.W;
  // the row's 4 y taps: (lo, hi) of samples 2py and 2py + 1
  int yoff[4];
  float wy[4];
#pragma unroll
  for (int g = 0; g < kGrid; ++g) {
    const Tap t = tab.y[kGrid * py + g];
    yoff[2 * g] = t.lo;
    yoff[2 * g + 1] = t.hi;
    wy[2 * g] = t.wlo;
    wy[2 * g + 1] = t.whi;
  }

  // y-pooled columns of the previous sample: gc[0] at x = plo, gc[1] at
  // its hi
  float gc[2][E];
  int plo = -1;
#pragma unroll 1
  for (int px = 0; px < kOut; ++px) {
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
#pragma unroll
    for (int gx = 0; gx < kGrid; ++gx) {
      const Tap t = tab.x[kGrid * px + gx];
      if (t.lo != plo) {
        if (plo >= 0 && t.lo == min(plo + 1, W - 1)) {
          // lo is the previous sample's hi: shift, load the new hi
#pragma unroll
          for (int e = 0; e < E; ++e) gc[0][e] = gc[1][e];
          const int xs[1] = {t.hi};
          float g1[1][E];
          columns<1, E>(f, V, yoff, wy, xs, g1);
#pragma unroll
          for (int e = 0; e < E; ++e) gc[1][e] = g1[0][e];
        } else {
          const int xs[2] = {t.lo, t.hi};
          columns<2, E>(f, V, yoff, wy, xs, gc);
        }
        plo = t.lo;
      }
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[e] = fmaf(t.wlo, gc[0][e], fmaf(t.whi, gc[1][e], acc[e]));
    }
    __stcs(o + px * V + v, pack(acc));
  }
}

// Block g of the grid pools RoIs [g * rpb, (g + 1) * rpb), then g +
// gridDim.x, and so on: rpb RoIs x 7 bin rows x V lanes a group. The
// tables of the next group are built while this group's rows run (two
// buffers, one barrier a group).
template <typename T>
__global__ void __launch_bounds__(kRoiThreads)
    roi_align_kernel(Pyramid pyr, const float* __restrict__ rois,
                     T* __restrict__ out, int R, int N, int V, int rpb,
                     float finest) {
  extern __shared__ __align__(16) unsigned char smem[];
  RoiTab* tabs = reinterpret_cast<RoiTab*>(smem);
  const int items = rpb * kOut * V;
  const int groups = (R + rpb - 1) / rpb;
  auto build = [&](int g, RoiTab* tab) {
    for (int t = threadIdx.x; t < rpb * kTabItems; t += blockDim.x) {
      const int i = t / kTabItems, r = g * rpb + i;
      if (g < groups && r < R)
        fill(tab[i], pyr, rois, r, N, V, t - i * kTabItems, finest);
    }
  };
  build(blockIdx.x, tabs);
  __syncthreads();
  for (int g = blockIdx.x, buf = 0; g < groups; g += gridDim.x, buf ^= 1) {
    RoiTab* tab = tabs + buf * rpb;
    build(g + gridDim.x, tabs + (buf ^ 1) * rpb);
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
      const int row = it / V, i = row / kOut, r = g * rpb + i;
      if (r < R)
        pool_row<T>(tab[i], reinterpret_cast<uint4*>(out) +
                                ((size_t)r * kOut + row % kOut) * kOut * V,
                    V, row % kOut, it - row * V);
    }
    __syncthreads();
  }
}

template <typename T>
static int launch(const Pyramid& pyr, const float* rois, void* out, int B,
                  int N, int C, float finest, cudaStream_t stream) {
  constexpr int kVec = Vec<T>::n;
  if (C <= 0 || C % kVec != 0) return (int)cudaErrorInvalidValue;
  const int R = B * N;
  if (R == 0) return 0;
  const int V = C / kVec;
  const int rpb = V >= 32 ? 1 : 32 / V;  // about 7 warps a group
  const int threads = std::min(round_up(rpb * kOut * V, 32), kRoiThreads);
  const int groups = (R + rpb - 1) / rpb;
  const size_t smem = 2 * rpb * sizeof(RoiTab);
  const int wave = wave_blocks(
      reinterpret_cast<const void*>(roi_align_kernel<T>), threads, smem);
  roi_align_kernel<T><<<std::min(groups, wave), threads, smem, stream>>>(
      pyr, rois, static_cast<T*>(out), R, N, V, rpb, finest);
  return (int)cudaGetLastError();
}

}  // namespace hrf

extern "C" int hrf_roi_align(const void* f0, const void* f1, const void* f2,
                             const void* f3, int h0, int w0, int h1, int w1,
                             int h2, int w2, int h3, int w3, float s0,
                             float s1, float s2, float s3, const float* rois,
                             void* out, int B, int N, int C, float finest,
                             int bf16, void* stream) {
  hrf::Pyramid pyr{{f0, f1, f2, f3},
                   {h0, h1, h2, h3},
                   {w0, w1, w2, w3},
                   {s0, s1, s2, s3}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return hrf::launch<__nv_bfloat16>(pyr, rois, out, B, N, C, finest, s);
  return hrf::launch<float>(pyr, rois, out, B, N, C, finest, s);
}
