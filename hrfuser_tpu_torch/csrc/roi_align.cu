// Kernel C: multilevel RoIAlign, 7x7 bins. Two plans: the aligned 2x2
// grid below, which the model path runs by default, and the general plan
// further down (any static grid, the adaptive grid, aligned or not).
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

// ---------------------------------------------------------------------------
// The general plan: any static grid, the adaptive grid, aligned or not
// ---------------------------------------------------------------------------
//
// The function is the same as above with JAX's whole sampling contract
// (hrfuser_tpu/ops/roi_align.py:8-18,282-335): a static grid of k x k
// samples a bin (sample_num = k > 0), or the adaptive one (sample_num = 0,
// mmcv's sampling_ratio=0): each RoI samples gy = ceil(bin_h) by gx =
// ceil(bin_w) points a bin, clamped to [1, max_grid], each axis's samples
// weighted 1 / count. `aligned` = 0 drops the half-pixel offset and makes
// the RoI at least 1 pixel a side. A bin's x sample i of an axis with
// `cnt` samples sits at a1 + (px + (i + 0.5) / cnt) * bin, as JAX computes
// it; the count comes from the same __fdiv_rn(a2 - a1, 7) bin width, so a
// bin exactly on an integer samples as many points as the twin does.
//
// Each RoI's table holds its level, image, counts and up to 7 * G taps an
// axis, G the launch's grid bound (the static k, or max_grid); it lives in
// dynamic shared memory sized by G (16 + 224 G bytes a RoI, two buffers).
// The 1 / gy and 1 / gx weights are folded into the taps. A thread owns
// one bin row of its lane's channels, as in the 2x2 plan, and for each bin
// y-pools the two pixel columns of each of its gx x samples over the gy y
// samples' rows; there is no column reuse (simple, not yet fast).

struct GridHead {
  const uint4* f;
  int W;
  short gy, gx;
};
static_assert(sizeof(GridHead) == 16, "GridHead is one 16-byte slot");

__host__ __device__ constexpr long long grid_tab_bytes(int G) {
  return (long long)sizeof(GridHead) + 2LL * kOut * G * (long long)sizeof(Tap);
}

struct GridArgs {
  int G;         // taps a bin reserved an axis
  int adaptive;  // 1: counts from ceil(bin), clamped to [1, G]
  float offset;  // 0.5 when aligned, else 0
  int aligned;
};

// Sample i (of cnt) of bin p on an axis with start a1, bin width `bin`.
__device__ __forceinline__ Tap grid_tap(float a1, float bin, int p, int i,
                                        int cnt, int size) {
  const float frac =
      __fadd_rn((float)p, __fdiv_rn((float)i + 0.5f, (float)cnt));
  const float coord = __fadd_rn(a1, __fmul_rn(frac, bin));
  const bool inside = coord > -1.f && coord < (float)size;
  const float c = fminf(fmaxf(coord, 0.f), (float)(size - 1));
  const int lo = (int)floorf(c);
  const float whi = c - (float)lo;
  return {lo, min(lo + 1, size - 1), inside ? 1.f - whi : 0.f,
          inside ? whi : 0.f};
}

// An axis's aligned (or not) start and bin width, and its sample count.
__device__ __forceinline__ void grid_axis(float v1, float v2, float s,
                                          const GridArgs& a, float& a1,
                                          float& bin, int& cnt) {
  a1 = __fsub_rn(__fmul_rn(v1, s), a.offset);
  const float a2 = __fsub_rn(__fmul_rn(v2, s), a.offset);
  float roi = __fsub_rn(a2, a1);
  if (!a.aligned) roi = fmaxf(roi, 1.f);
  bin = __fdiv_rn(roi, (float)kOut);
  cnt = a.adaptive ? (int)fminf(fmaxf(ceilf(bin), 1.f), (float)a.G) : a.G;
}

// Item k of RoI r's table: x taps [0, 7G), y taps [7G, 14G), the header.
__device__ __forceinline__ void grid_fill(unsigned char* tab,
                                          const Pyramid& pyr,
                                          const float* __restrict__ rois,
                                          int r, int N, int V, int k,
                                          float finest, const GridArgs& a) {
  const float* box = rois + 4 * (size_t)r;
  const float x1 = __ldg(box), y1 = __ldg(box + 1);
  const float x2 = __ldg(box + 2), y2 = __ldg(box + 3);
  const float area = (x2 - x1) * (y2 - y1);
  const float l = floorf(log2f(sqrtf(area) / finest + 1e-6f));
  const int lvl = l >= 3.f ? 3 : (l >= 0.f ? (int)l : 0);
  const int H = pyr.h[lvl], W = pyr.w[lvl];
  const float s = pyr.scale[lvl];
  const int S = kOut * a.G;
  Tap* x = reinterpret_cast<Tap*>(tab + sizeof(GridHead));
  Tap* y = x + S;
  float a1, bin;
  int cnt;
  if (k < 2 * S) {
    const bool is_x = k < S;
    const int j = is_x ? k : k - S;
    const int p = j / a.G, i = j % a.G;
    if (is_x)
      grid_axis(x1, x2, s, a, a1, bin, cnt);
    else
      grid_axis(y1, y2, s, a, a1, bin, cnt);
    if (i >= cnt) return;  // past this RoI's count: never read
    Tap t = grid_tap(a1, bin, p, i, cnt, is_x ? W : H);
    const float w = __fdiv_rn(1.f, (float)cnt);
    if (is_x)
      x[j] = {t.lo, t.hi, t.wlo * w, t.whi * w};
    else
      y[j] = {t.lo * W, t.hi * W, t.wlo * w, t.whi * w};
  } else {
    GridHead* h = reinterpret_cast<GridHead*>(tab);
    int gy, gx;
    grid_axis(y1, y2, s, a, a1, bin, gy);
    grid_axis(x1, x2, s, a, a1, bin, gx);
    h->f = static_cast<const uint4*>(pyr.f[lvl]) + (size_t)(r / N) * H * W * V;
    h->W = W;
    h->gy = (short)gy;
    h->gx = (short)gx;
  }
}

// One bin row py of an RoI, 16-byte lane v: 7 output vectors at o.
template <typename T>
__device__ __forceinline__ void grid_row(const unsigned char* tab,
                                         uint4* __restrict__ o, int V,
                                         int py, int v, int G) {
  constexpr int E = Vec<T>::n;
  const GridHead h = *reinterpret_cast<const GridHead*>(tab);
  const Tap* xt = reinterpret_cast<const Tap*>(tab + sizeof(GridHead));
  const Tap* yt = xt + kOut * G + py * G;
  const uint4* f = h.f + v;
#pragma unroll 1
  for (int px = 0; px < kOut; ++px) {
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
#pragma unroll 1
    for (int ix = 0; ix < h.gx; ++ix) {
      const Tap tx = xt[px * G + ix];
#pragma unroll 1
      for (int iy = 0; iy < h.gy; ++iy) {
        const Tap ty = yt[iy];
        const uint4 d00 = __ldg(f + (size_t)(ty.lo + tx.lo) * V);
        const uint4 d01 = __ldg(f + (size_t)(ty.lo + tx.hi) * V);
        const uint4 d10 = __ldg(f + (size_t)(ty.hi + tx.lo) * V);
        const uint4 d11 = __ldg(f + (size_t)(ty.hi + tx.hi) * V);
        float v00[E], v01[E], v10[E], v11[E];
        unpack(d00, v00);
        unpack(d01, v01);
        unpack(d10, v10);
        unpack(d11, v11);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float lo = fmaf(ty.wlo, v00[e], ty.whi * v10[e]);
          const float hi = fmaf(ty.wlo, v01[e], ty.whi * v11[e]);
          acc[e] = fmaf(tx.wlo, lo, fmaf(tx.whi, hi, acc[e]));
        }
      }
    }
    __stcs(o + px * V + v, pack(acc));
  }
}

// The 2x2 kernel's schedule (groups of rpb RoIs, tables double-buffered)
// over the general tables.
template <typename T>
__global__ void __launch_bounds__(kRoiThreads)
    roi_align_grid_kernel(Pyramid pyr, const float* __restrict__ rois,
                          T* __restrict__ out, int R, int N, int V, int rpb,
                          float finest, GridArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tab_bytes = (int)grid_tab_bytes(a.G);
  const int tab_items = 2 * kOut * a.G + 1;
  const int items = rpb * kOut * V;
  const int groups = (R + rpb - 1) / rpb;
  auto build = [&](int g, unsigned char* tab) {
    for (int t = threadIdx.x; t < rpb * tab_items; t += blockDim.x) {
      const int i = t / tab_items, r = g * rpb + i;
      if (g < groups && r < R)
        grid_fill(tab + i * tab_bytes, pyr, rois, r, N, V,
                  t - i * tab_items, finest, a);
    }
  };
  build(blockIdx.x, smem);
  __syncthreads();
  for (int g = blockIdx.x, buf = 0; g < groups; g += gridDim.x, buf ^= 1) {
    unsigned char* tab = smem + buf * rpb * tab_bytes;
    build(g + gridDim.x, smem + (buf ^ 1) * rpb * tab_bytes);
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
      const int row = it / V, i = row / kOut, r = g * rpb + i;
      if (r < R)
        grid_row<T>(tab + i * tab_bytes,
                    reinterpret_cast<uint4*>(out) +
                        ((size_t)r * kOut + row % kOut) * kOut * V,
                    V, row % kOut, it - row * V, a.G);
    }
    __syncthreads();
  }
}

// RoIs a group and threads a block, the same for both plans.
static void roi_groups(int V, int& rpb, int& threads) {
  rpb = V >= 32 ? 1 : 32 / V;  // about 7 warps a group
  threads = std::min(round_up(rpb * kOut * V, 32), kRoiThreads);
}

static long long grid_smem(int C, int vec, int G) {
  int rpb, threads;
  roi_groups(C / vec, rpb, threads);
  return 2LL * rpb * grid_tab_bytes(G);
}

template <typename T>
static int launch_grid(const Pyramid& pyr, const float* rois, void* out,
                       int B, int N, int C, float finest, const GridArgs& a,
                       cudaStream_t stream) {
  constexpr int kVec = Vec<T>::n;
  if (C <= 0 || C % kVec != 0 || a.G < 1) return (int)cudaErrorInvalidValue;
  const long long smem = grid_smem(C, kVec, a.G);
  if (smem > (long long)kSmemMax) return kErrNoPlan;
  const int R = B * N;
  if (R == 0) return 0;
  const int V = C / kVec;
  int rpb, threads;
  roi_groups(V, rpb, threads);
  const int groups = (R + rpb - 1) / rpb;
  const void* kernel = reinterpret_cast<const void*>(roi_align_grid_kernel<T>);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int wave = wave_blocks(kernel, threads, (size_t)smem);
  roi_align_grid_kernel<T><<<std::min(groups, wave), threads, (size_t)smem,
                             stream>>>(pyr, rois, static_cast<T*>(out), R, N,
                                       V, rpb, finest, a);
  return (int)cudaGetLastError();
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

// sample_num > 0: a static sample_num x sample_num grid; 0: adaptive, up
// to max_grid an axis. An aligned 2x2 grid takes the 2x2 plan, the rest
// the general plan, which returns kErrNoPlan when its tables do not fit.
extern "C" int hrf_roi_align(const void* f0, const void* f1, const void* f2,
                             const void* f3, int h0, int w0, int h1, int w1,
                             int h2, int w2, int h3, int w3, float s0,
                             float s1, float s2, float s3, const float* rois,
                             void* out, int B, int N, int C, float finest,
                             int bf16, int sample_num, int max_grid,
                             int aligned, void* stream) {
  hrf::Pyramid pyr{{f0, f1, f2, f3},
                   {h0, h1, h2, h3},
                   {w0, w1, w2, w3},
                   {s0, s1, s2, s3}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sample_num < 0) return (int)cudaErrorInvalidValue;
  if (sample_num == hrf::kGrid && aligned) {
    if (bf16)
      return hrf::launch<__nv_bfloat16>(pyr, rois, out, B, N, C, finest, s);
    return hrf::launch<float>(pyr, rois, out, B, N, C, finest, s);
  }
  const hrf::GridArgs a{sample_num > 0 ? sample_num : max_grid,
                        sample_num == 0, aligned ? 0.5f : 0.f, aligned};
  if (bf16)
    return hrf::launch_grid<__nv_bfloat16>(pyr, rois, out, B, N, C, finest,
                                           a, s);
  return hrf::launch_grid<float>(pyr, rois, out, B, N, C, finest, a, s);
}

// Shared memory of the general plan at C channels and a grid bound of G.
extern "C" long long hrf_roi_align_smem(int C, int bf16, int G) {
  return hrf::grid_smem(C, bf16 ? 8 : 4, G);
}
