// Kernel C: multilevel RoIAlign, 7x7 bins. Two plans: the aligned 2x2
// grid below, which the model path runs by default, and the general plan
// further down (any static grid, the adaptive grid, aligned or not), which
// pools the separable form: per axis and bin, the distinct pixels its
// samples touch with their summed weights, each pixel of a bin row loaded
// once a lane. The notes below up to the general plan are the 2x2 plan's.
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

#include <climits>

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
// The design. The function is separable: a bin's value is sum over its
// x pixels of wx * sum over its y pixels of wy * f[y][x], where a pixel's
// weight on an axis is the sum, over the bin's samples on that axis, of
// the sample's bilinear weight on that pixel (lo or hi) times 1 / cnt and
// the axis's `inside` mask. It equals the per-sample sum of 4 taps up to
// float32 summation order. The TPU kernel pools the same way
// (`pallas_roi_align.py:_axis_strip`: one weight per pixel, two one-hot
// products); per sample taps would cost 4 x 16-byte loads a sample,
// 448 a bin row and lane for 3.5-pixel adaptive bins, where the row's
// distinct pixels are about 5 x 26.
//  - Each RoI's table holds, for each of the 7 bins of each axis, the
//    distinct pixels its samples touch with their summed weights (zero
//    weights dropped), at most 2G entries, G the launch's grid bound (the
//    static k, or max_grid): 48 + 224 G bytes a RoI, two buffers of rpb
//    RoIs in dynamic shared memory, beside a 16-byte slot a thread. One
//    thread per (RoI, axis, bin) builds a list. Samples are monotone in their coordinate, so a pixel met
//    again is one of the list's last two entries; a list is sorted and
//    holds no pixel twice (a RoI with x2 < x1 may repeat one, which costs
//    a load and changes nothing). Capped bins and static grids with more
//    than a pixel between samples give non-adjacent pixels: nothing
//    assumes contiguity.
//  - A thread owns one bin row (RoI, py) of its lane's 16-byte vector. The
//    row's count of y entries picks an unrolled form (1-8 rows, their
//    offsets and weights in registers; warp-uniform where a warp holds
//    one row, C >= 256 bf16 / 128 f32), or a loop over the table past 8;
//    a row with none stores zeros. It walks its 7 bins' x entries left to
//    right and y-pools each new column once, two columns' loads issued
//    together (2 x NY, up to 16 loads in flight a thread). The last two
//    pooled columns are kept (the newer in registers, the older in a slot
//    of shared memory a thread), so the 1-2 pixels that neighbouring bins
//    share are loaded once, and all seven bins of an RoI clamped to one
//    edge column read one pooled column. A bin is stored (evict-first)
//    once its last column is added. Launches of one sample a bin (G = 1,
//    at most 2 entries a bin) take a form without kept columns
//    (grid_row_2), and build their tables on the row threads' lanes.
//  - The schedule is the 2x2 plan's: groups of rpb RoIs, tables
//    double-buffered, one wave from the occupancy calculator, C % 8 (bf16)
//    / C % 4 (f32) with no scalar path; nothing else is staged in shared
//    memory (PR 4 measured that L1 serves the re-reads). But for G > 1 a
//    block's last warp builds the next group's tables while the others
//    pool rows: a list is a chain of dependent steps that delayed one row
//    warp a group.
//
// Measured (PERF.md, `chip_profile.py`, NVIDIA H100): a knock-out copy
// whose loads all hit L1 is 30-50 % faster, so the plan waits on L2; more
// loads in flight a thread (pairs up to 16 loads, at 99 registers, two
// blocks an SM) beat more warps with fewer (64 registers, four blocks);
// the tables alone (rows skipped) take 0.064 ms of the adaptive launch.

// A pixel of one axis (x, or y * W) and its summed weight.
struct Ent {
  int p;
  float w;
};
static_assert(sizeof(Ent) == 8, "Ent is 8 bytes");

struct __align__(16) GridHead {
  const uint4* f;
  int W, pad;
  unsigned short nx[kOut], ny[kOut];  // entries of each bin, per axis
};
static_assert(sizeof(GridHead) == 48, "GridHead is three 16-byte slots");

__host__ __device__ constexpr long long grid_tab_bytes(int G) {
  return (long long)sizeof(GridHead) +
         2LL * kOut * 2 * G * (long long)sizeof(Ent);
}

// The entries of a table: x bins [0, 7), then y bins, 2G slots a bin.
__device__ __forceinline__ Ent* grid_ents(unsigned char* tab) {
  return reinterpret_cast<Ent*>(tab + sizeof(GridHead));
}
__device__ __forceinline__ const Ent* grid_ents(const unsigned char* tab) {
  return reinterpret_cast<const Ent*>(tab + sizeof(GridHead));
}

struct GridArgs {
  int G;         // samples a bin reserved an axis
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

// The list of bin p of an axis (start a1, bin width `bin`, cnt samples,
// `size` pixels, a pixel stored as pixel * mul): its entries at e, their
// count returned. The last two entries stay in registers until pushed
// out, so a sample costs no shared-memory round trip.
__device__ __forceinline__ int grid_bin(Ent* e, float a1, float bin, int p,
                                        int cnt, int size, int mul) {
  const float w = __fdiv_rn(1.f, (float)cnt);
  int n = 0, p1 = -1, p2 = -1;  // the second to last and the last pixel
  float w1 = 0.f, w2 = 0.f;
  auto add = [&](int q, float v) {
    if (v == 0.f) return;  // outside (-1, size), or hi at weight 0
    if (q == p2) {
      w2 += v;
    } else if (q == p1) {
      w1 += v;
    } else {
      if (p1 >= 0) e[n++] = {p1, w1};
      p1 = p2;
      w1 = w2;
      p2 = q;
      w2 = v;
    }
  };
#pragma unroll 4
  for (int i = 0; i < cnt; ++i) {
    const Tap t = grid_tap(a1, bin, p, i, cnt, size);
    add(t.lo * mul, t.wlo * w);
    add(t.hi * mul, t.whi * w);
  }
  if (p1 >= 0) e[n++] = {p1, w1};
  if (p2 >= 0) e[n++] = {p2, w2};
  return n;
}

// Item k of RoI r's table: x bins [0, 7), y bins [7, 14), the header.
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
  GridHead* h = reinterpret_cast<GridHead*>(tab);
  if (k < 2 * kOut) {
    const bool is_x = k < kOut;
    const int p = is_x ? k : k - kOut;
    float a1, bin;
    int cnt;
    if (is_x)
      grid_axis(x1, x2, s, a, a1, bin, cnt);
    else
      grid_axis(y1, y2, s, a, a1, bin, cnt);
    const int n = grid_bin(grid_ents(tab) + k * 2 * a.G, a1, bin, p, cnt,
                           is_x ? W : H, is_x ? 1 : W);
    (is_x ? h->nx : h->ny)[p] = (unsigned short)n;
  } else {
    h->f = static_cast<const uint4*>(pyr.f[lvl]) + (size_t)(r / N) * H * W * V;
    h->W = W;
  }
}

// The y-pool of NC columns of one bin row: g[j] = sum over the row's NY
// rows of wy[t] * f[yo[t] + xo[j]] (offsets in 16-byte vectors). All NC *
// NY loads are issued first.
template <int NC, int NY, int E>
__device__ __forceinline__ void ypool(const uint4* __restrict__ f,
                                      const int (&yo)[NY],
                                      const float (&wy)[NY],
                                      const int (&xo)[NC],
                                      float (&g)[NC][E]) {
  uint4 d[NC][NY];
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int t = 0; t < NY; ++t) d[j][t] = __ldg(f + (yo[t] + xo[j]));
#pragma unroll
  for (int j = 0; j < NC; ++j) {
#pragma unroll
    for (int e = 0; e < E; ++e) g[j][e] = 0.f;
#pragma unroll
    for (int t = 0; t < NY; ++t) {
      float v[E];
      unpack(d[j][t], v);
#pragma unroll
      for (int e = 0; e < E; ++e) g[j][e] = fmaf(wy[t], v[e], g[j][e]);
    }
  }
}

// The same for one column over ny rows read from the table, 4 loads at a
// time (a slot past ny reloads the last row at weight 0).
template <int E>
__device__ __forceinline__ void ypool_any(const uint4* __restrict__ f,
                                          const Ent* __restrict__ ye, int ny,
                                          int V, int xo, float (&g)[E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) g[e] = 0.f;
#pragma unroll 1
  for (int t0 = 0; t0 < ny; t0 += 4) {
    uint4 d[4];
    float w[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const Ent y = ye[min(t0 + t, ny - 1)];
      w[t] = t0 + t < ny ? y.w : 0.f;
      d[t] = __ldg(f + (y.p * V + xo));
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      float v[E];
      unpack(d[t], v);
#pragma unroll
      for (int e = 0; e < E; ++e) g[e] = fmaf(w[t], v[e], g[e]);
    }
  }
}

// One bin row py of an RoI whose row has NY y entries (0: any number, read
// from the table), 16-byte lane v: 7 output vectors at o.
template <typename T, int NY>
__device__ __forceinline__ void grid_row_n(const unsigned char* tab,
                                           uint4* __restrict__ o, int V,
                                           int py, int v, int G,
                                           float4* __restrict__ slot,
                                           int stride) {
  constexpr int E = Vec<T>::n;
  constexpr int R = NY > 0 ? NY : 1;
  const GridHead& h = *reinterpret_cast<const GridHead*>(tab);
  const Ent* xe = grid_ents(tab);
  const Ent* ye = xe + (kOut + py) * 2 * G;
  const int ny = h.ny[py];
  const uint4* f = h.f + v;
  int yo[R];
  float wy[R];
#pragma unroll
  for (int t = 0; t < R; ++t) {
    const Ent y = ye[t];
    yo[t] = y.p * V;
    wy[t] = y.w;
  }
  // the last two pooled columns: the older (x offset ca) in this thread's
  // slot of shared memory (E / 4 float4s `stride` apart), the newer (cb)
  // in gb
  int ca = -1, cb = -1;
  float gb[E];
#pragma unroll
  for (int e = 0; e < E; ++e) gb[e] = 0.f;
  auto put_a = [&](const float (&g)[E]) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q)
      slot[q * stride] =
          make_float4(g[4 * q], g[4 * q + 1], g[4 * q + 2], g[4 * q + 3]);
  };
  auto add_a = [&](float w, float (&acc)[E]) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      const float4 c = slot[q * stride];
      acc[4 * q] = fmaf(w, c.x, acc[4 * q]);
      acc[4 * q + 1] = fmaf(w, c.y, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(w, c.z, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(w, c.w, acc[4 * q + 3]);
    }
  };
#pragma unroll 1
  for (int px = 0; px < kOut; ++px) {
    const Ent* xs = xe + px * 2 * G;
    const int n = h.nx[px];
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
#pragma unroll 1
    for (int k = 0; k < n;) {
      const Ent e0 = xs[k];
      const int x0 = e0.p * V;
      if (x0 == cb) {  // pooled for an earlier bin
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = fmaf(e0.w, gb[e], acc[e]);
        ++k;
        continue;
      }
      if (x0 == ca) {
        add_a(e0.w, acc);
        ++k;
        continue;
      }
      if constexpr (NY > 0) {
        if (k + 1 < n) {
          const Ent e1 = xs[k + 1];
          const int x1 = e1.p * V;
          if (x1 != ca && x1 != cb) {
            const int xo[2] = {x0, x1};
            float g[2][E];
            ypool<2, NY, E>(f, yo, wy, xo, g);
            put_a(g[0]);
#pragma unroll
            for (int e = 0; e < E; ++e) {
              gb[e] = g[1][e];
              acc[e] = fmaf(e0.w, g[0][e], fmaf(e1.w, gb[e], acc[e]));
            }
            ca = x0;
            cb = x1;
            k += 2;
            continue;
          }
        }
      }
      float g[E];
      if constexpr (NY > 0) {
        const int xo[1] = {x0};
        float g1[1][E];
        ypool<1, NY, E>(f, yo, wy, xo, g1);
#pragma unroll
        for (int e = 0; e < E; ++e) g[e] = g1[0][e];
      } else {
        ypool_any<E>(f, ye, ny, V, x0, g);
      }
      put_a(gb);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        gb[e] = g[e];
        acc[e] = fmaf(e0.w, g[e], acc[e]);
      }
      ca = cb;
      cb = x0;
      ++k;
    }
    __stcs(o + px * V + v, pack(acc));
  }
}

// One bin row of a launch whose bins hold at most 2 entries an axis (G =
// 1: one sample, lo and hi): a bin's columns' NY rows loaded together, no
// column kept (bins share a column only when under a pixel wide; the
// reload is an L1 hit). Measured against two and more bins a batch, which
// cost as much or more.
template <typename T, int NY>
__device__ __forceinline__ void grid_row_2(const unsigned char* tab,
                                           uint4* __restrict__ o, int V,
                                           int py, int v) {
  constexpr int E = Vec<T>::n;
  const GridHead& h = *reinterpret_cast<const GridHead*>(tab);
  const Ent* xe = grid_ents(tab);
  const Ent* ye = xe + (kOut + py) * 2;
  const uint4* f = h.f + v;
  int yo[NY];
  float wy[NY];
#pragma unroll
  for (int t = 0; t < NY; ++t) {
    const Ent y = ye[t];
    yo[t] = y.p * V;
    wy[t] = y.w;
  }
#pragma unroll 1
  for (int px = 0; px < kOut; ++px) {
    uint4 d[2][NY];
    float w[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool on = j < h.nx[px];
      const Ent e = xe[px * 2 + (on ? j : 0)];
      w[j] = on ? e.w : 0.f;
#pragma unroll
      for (int t = 0; t < NY; ++t)
        d[j][t] = on ? __ldg(f + (yo[t] + e.p * V))
                     : make_uint4(0u, 0u, 0u, 0u);
    }
    float acc[E];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float g[E];
#pragma unroll
      for (int e = 0; e < E; ++e) g[e] = 0.f;
#pragma unroll
      for (int t = 0; t < NY; ++t) {
        float u[E];
        unpack(d[j][t], u);
#pragma unroll
        for (int e = 0; e < E; ++e) g[e] = fmaf(wy[t], u[e], g[e]);
      }
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[e] = j ? fmaf(w[j], g[e], acc[e]) : w[j] * g[e];
    }
    __stcs(o + px * V + v, pack(acc));
  }
}

// One bin row py of an RoI, 16-byte lane v: 7 output vectors at o. ONE:
// a launch of one sample a bin an axis (G = 1), whose rows take
// grid_row_2 alone; the other launches take the form of the row's count
// of y entries.
template <typename T, bool ONE>
__device__ __forceinline__ void grid_row(const unsigned char* tab,
                                         uint4* __restrict__ o, int V,
                                         int py, int v, int G,
                                         float4* __restrict__ slot,
                                         int stride) {
  const int ny = reinterpret_cast<const GridHead*>(tab)->ny[py];
  if (ny == 0) {  // every y sample outside the map
#pragma unroll
    for (int px = 0; px < kOut; ++px)
      __stcs(o + px * V + v, make_uint4(0u, 0u, 0u, 0u));
    return;
  }
  if constexpr (ONE) {
    if (ny == 1) return grid_row_2<T, 1>(tab, o, V, py, v);
    return grid_row_2<T, 2>(tab, o, V, py, v);
  } else {
    switch (ny) {
      case 1: return grid_row_n<T, 1>(tab, o, V, py, v, G, slot, stride);
      case 2: return grid_row_n<T, 2>(tab, o, V, py, v, G, slot, stride);
      case 3: return grid_row_n<T, 3>(tab, o, V, py, v, G, slot, stride);
      case 4: return grid_row_n<T, 4>(tab, o, V, py, v, G, slot, stride);
      case 5: return grid_row_n<T, 5>(tab, o, V, py, v, G, slot, stride);
      case 6: return grid_row_n<T, 6>(tab, o, V, py, v, G, slot, stride);
      case 7: return grid_row_n<T, 7>(tab, o, V, py, v, G, slot, stride);
      case 8: return grid_row_n<T, 8>(tab, o, V, py, v, G, slot, stride);
      default: return grid_row_n<T, 0>(tab, o, V, py, v, G, slot, stride);
    }
  }
}

// The 2x2 kernel's schedule (groups of rpb RoIs, tables double-buffered)
// over the general tables, but the block's last warp builds the tables of
// the next group while the others pool this one's rows: a table is a
// chain of dependent steps (the RoI's box, its level, each sample's
// coordinate and merge) that would otherwise delay one row warp a group.
template <typename T, bool ONE>
__global__ void __launch_bounds__(kRoiThreads)
    roi_align_grid_kernel(Pyramid pyr, const float* __restrict__ rois,
                          T* __restrict__ out, int R, int N, int V, int rpb,
                          float finest, GridArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tab_bytes = (int)grid_tab_bytes(a.G);
  constexpr int tab_items = 2 * kOut + 1;
  // threads that pool rows; the last warp builds (a launch of one sample
  // a bin, whose tables are short, builds on the row threads' lanes)
  const int rows_n = ONE ? blockDim.x : blockDim.x - 32;
  const bool builder = ONE || threadIdx.x >= rows_n;
  float4* slot = reinterpret_cast<float4*>(smem + 2 * rpb * tab_bytes) +
                 threadIdx.x;
  const int items = rpb * kOut * V;
  const int groups = (R + rpb - 1) / rpb;
  auto build = [&](int g, unsigned char* tab) {
    const int lane = ONE ? threadIdx.x : threadIdx.x - rows_n;
    for (int t = lane; t < rpb * tab_items; t += ONE ? blockDim.x : 32) {
      const int i = t / tab_items, r = g * rpb + i;
      if (g < groups && r < R)
        grid_fill(tab + i * tab_bytes, pyr, rois, r, N, V,
                  t - i * tab_items, finest, a);
    }
  };
  if (builder) build(blockIdx.x, smem);
  __syncthreads();
  for (int g = blockIdx.x, buf = 0; g < groups; g += gridDim.x, buf ^= 1) {
    unsigned char* tab = smem + buf * rpb * tab_bytes;
    if (builder) build(g + gridDim.x, smem + (buf ^ 1) * rpb * tab_bytes);
    if (ONE || !builder) {
      for (int it = threadIdx.x; it < items; it += rows_n) {
        const int row = it / V, i = row / kOut, r = g * rpb + i;
        if (r < R)
          grid_row<T, ONE>(tab + i * tab_bytes,
                           reinterpret_cast<uint4*>(out) +
                               ((size_t)r * kOut + row % kOut) * kOut * V,
                           V, row % kOut, it - row * V, a.G, slot,
                           blockDim.x);
      }
    }
    __syncthreads();
  }
}

// RoIs a group (as the 2x2 plan's `launch`) and threads a block of the
// general plan: the row threads (at most kRoiThreads - 32 when G > 1)
// and, for G > 1, the builder warp.
static void grid_groups(int V, bool one, int& rpb, int& threads) {
  rpb = V >= 32 ? 1 : 32 / V;  // about 7 warps a group
  const int rows = round_up(rpb * kOut * V, 32);
  threads = one ? std::min(rows, kRoiThreads)
                : std::min(rows, kRoiThreads - 32) + 32;
}

static long long grid_smem(int C, int vec, int G) {
  int rpb, threads;
  grid_groups(C / vec, G == 1, rpb, threads);
  return 2LL * rpb * grid_tab_bytes(G) + 4LL * threads * vec;  // + slots
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
  for (int l = 0; l < 4; ++l)  // a pixel's vector offset in an image is an int
    if ((long long)pyr.h[l] * pyr.w[l] * V > INT_MAX)
      return (int)cudaErrorInvalidValue;
  int rpb, threads;
  grid_groups(V, a.G == 1, rpb, threads);
  const int groups = (R + rpb - 1) / rpb;
  const void* kernel =
      a.G == 1
          ? reinterpret_cast<const void*>(roi_align_grid_kernel<T, true>)
          : reinterpret_cast<const void*>(roi_align_grid_kernel<T, false>);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int wave = wave_blocks(kernel, threads, (size_t)smem);
  void* args[] = {(void*)&pyr, (void*)&rois, (void*)&out, (void*)&R,
                  (void*)&N,   (void*)&V,    (void*)&rpb, (void*)&finest,
                  (void*)&a};
  const cudaError_t e = cudaLaunchKernel(kernel, std::min(groups, wave),
                                         threads, args, (size_t)smem, stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
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
