// Kernel C: aligned multilevel RoIAlign, 7x7 bins x 2x2 samples.
//
// Replaces the TPU Pallas kernel hrfuser_tpu/ops/pallas_roi_align.py:
// multilevel_roi_align_pallas -> _call -> pallas_call :597 (_kernel_v7),
// the default eval pool of every cascade stage.
//
// One block per RoI (all images' RoIs flattened), threads across the C
// channels of the NHWC pyramid, so each bilinear tap is one coalesced
// C-vector read. The block computes the RoI's FPN level as
// map_roi_levels does (floor(log2(sqrt(wh) / finest + 1e-6)), clipped),
// then per axis the 14 sample coordinates with the semantics of
// hrfuser_tpu/ops/roi_align.py:_bilinear_weights: a sample counts when it
// lies in (-1, size), is clamped to [0, size - 1], and hi = min(lo + 1,
// size - 1); the aligned -0.5 offset is applied. Samples are accumulated
// in f32 and rounded once on store (the TPU kernel's extra bf16 round
// between its x- and y-pools is not copied). Zero-padded proposals, boxes
// outside the image and full-width slivers need no special path.
//
// Output rows are [B, N, 49, C] with bins in (y, x) row-major order.
//
// What bounds it on the H100: 196 samples x 4 taps x C reads per RoI,
// mostly L2 hits (one image's stride-4 level at C = 256 bf16 is 7.9 MB),
// so it is bound by L2 and load-issue bandwidth; writes are 49 x C per
// RoI. The design reads every tap as a coalesced channel vector and keeps
// the per-axis sample table in shared memory.
#include "common.cuh"

namespace hrf {

constexpr int kOut = 7;
constexpr int kGrid = 2;
constexpr int kSamp = kOut * kGrid;

struct Pyramid {
  const void* f[4];
  int h[4];
  int w[4];
  float scale[4];
};

template <typename T>
__global__ void roi_align_kernel(Pyramid pyr, const float* __restrict__ rois,
                                 T* __restrict__ out, int N, int C,
                                 float finest) {
  __shared__ int lo_s[2][kSamp], hi_s[2][kSamp];
  __shared__ float wlo_s[2][kSamp], whi_s[2][kSamp];
  __shared__ int lvl_s;
  const int r = blockIdx.x;
  const int b = r / N;
  const float* box = rois + 4 * (size_t)r;
  const int tid = threadIdx.x;

  if (tid == 0) {
    const float area = (box[2] - box[0]) * (box[3] - box[1]);
    const float l = floorf(log2f(sqrtf(area) / finest + 1e-6f));
    lvl_s = l >= 3.f ? 3 : (l >= 0.f ? (int)l : 0);
  }
  __syncthreads();
  const int lvl = lvl_s;
  const int H = pyr.h[lvl], W = pyr.w[lvl];

  if (tid < 2 * kSamp) {
    const int axis = tid / kSamp, k = tid % kSamp;  // axis 0: x, 1: y
    const float s = pyr.scale[lvl];
    const float a1 = __fsub_rn(__fmul_rn(box[axis], s), 0.5f);
    const float a2 = __fsub_rn(__fmul_rn(box[axis + 2], s), 0.5f);
    const float bin = __fdiv_rn(__fsub_rn(a2, a1), (float)kOut);
    const float frac = (float)(k / kGrid) + ((k % kGrid) + 0.5f) / kGrid;
    const float coord = __fadd_rn(a1, __fmul_rn(frac, bin));
    const int size = axis ? H : W;
    const bool inside = coord > -1.f && coord < (float)size;
    const float c = fminf(fmaxf(coord, 0.f), (float)(size - 1));
    const int lo = (int)floorf(c);
    const float whi = c - (float)lo;
    lo_s[axis][k] = lo;
    hi_s[axis][k] = min(lo + 1, size - 1);
    wlo_s[axis][k] = inside ? 1.f - whi : 0.f;
    whi_s[axis][k] = inside ? whi : 0.f;
  }
  __syncthreads();

  const T* f = static_cast<const T*>(pyr.f[lvl]) + (size_t)b * H * W * C;
  T* o = out + (size_t)r * kOut * kOut * C;
  const float norm = 1.f / (kGrid * kGrid);
  for (int c = tid; c < C; c += blockDim.x) {
    for (int py = 0; py < kOut; ++py) {
      for (int px = 0; px < kOut; ++px) {
        float acc = 0.f;
#pragma unroll
        for (int gy = 0; gy < kGrid; ++gy) {
          const int ky = py * kGrid + gy;
          const size_t r0 = (size_t)lo_s[1][ky] * W;
          const size_t r1 = (size_t)hi_s[1][ky] * W;
          const float wyl = wlo_s[1][ky], wyh = whi_s[1][ky];
#pragma unroll
          for (int gx = 0; gx < kGrid; ++gx) {
            const int kx = px * kGrid + gx;
            const int x0 = lo_s[0][kx], x1 = hi_s[0][kx];
            const float wxl = wlo_s[0][kx], wxh = whi_s[0][kx];
            acc += wyl * (wxl * load(f + (r0 + x0) * C + c) +
                          wxh * load(f + (r0 + x1) * C + c)) +
                   wyh * (wxl * load(f + (r1 + x0) * C + c) +
                          wxh * load(f + (r1 + x1) * C + c));
          }
        }
        o[(py * kOut + px) * C + c] = store<T>(acc * norm);
      }
    }
  }
}

template <typename T>
static int launch(const Pyramid& pyr, const float* rois, void* out, int B,
                  int N, int C, float finest, cudaStream_t stream) {
  roi_align_kernel<T><<<B * N, 256, 0, stream>>>(
      pyr, rois, static_cast<T*>(out), N, C, finest);
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
