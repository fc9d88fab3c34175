// Kernel A: 7x7 window attention half of an HRFormer / HRFuser block.
//
// Replaces the attention halves of the TPU Pallas kernels
// hrfuser_tpu/ops/pallas_chain.py:_chain_kernel (reached from
// hrformer_chain, pallas_call at :878) and :_fusion_kernel (fusion_chain,
// pallas_call at :670), i.e. _ln_cf + _attn_groups.
//
//   self : out = res + Wo . MHSA(LN1(x))             (q, k, v from LN1(x))
//   cross: out = res + z + Wo . MHSA(q = LN1(xq), kv = LN2(z))
//
// One block per (window, image). The block reads its 49 tokens straight
// from the unpadded NHWC map; tokens on the centre-padding ring read as a
// zero LN output, so they enter the softmax with k = b_k and v = b_v, as
// the reference's zero-pad-then-project does (hrfuser_tpu/ops/window.py).
// Only real pixels are written, so a window never touches another's
// tokens. The attention scale d^-0.5 is folded into Wq/bq by the caller;
// `bias` is the gathered relative-position bias [nh, 49, 49].
//
// What bounds it on the H100: at C = 18 (branch 0, 96x160) the 49x54
// projections are tiny and the block is bound by global loads of the
// window and by per-block fixed cost; at C = 144 it is bound by the
// scalar-FMA projections (49 x 432 x 144 per window) on CUDA cores, with
// one block per SM because of its ~150 KB of shared memory. The design
// keeps everything of a window on-chip (LN, q/k/v, logits, softmax, the
// head outputs) so each token is read once and written once; weights come
// from L2 through the read-only path. Tensor-core MMA and several windows
// per block are later work.
#include "common.cuh"

namespace hrf {

constexpr int kWs = 7;
constexpr int kTok = kWs * kWs;

template <typename T>
__global__ void window_attention_kernel(
    const T* __restrict__ res, const T* __restrict__ qsrc,
    const T* __restrict__ kvsrc, const T* __restrict__ zadd,
    T* __restrict__ out, const float* __restrict__ lnq,
    const float* __restrict__ lnkv, const float* __restrict__ wqkv,
    const float* __restrict__ bqkv, const float* __restrict__ wo,
    const float* __restrict__ bo, const float* __restrict__ bias, int H,
    int W, int C, int nh, int pt, int pl, int nww, int cross) {
  extern __shared__ float smem[];
  __shared__ int pix[kTok];
  const int C3 = 3 * C;
  const int S3 = C3 | 1;  // odd row stride: conflict-free column reads
  float* xq = smem;                              // [49][C]
  float* xkv = cross ? xq + kTok * C : xq;       // [49][C]
  float* qkv = xkv + kTok * C;                   // [49][S3]
  float* prob = qkv + kTok * S3;                 // [49][49]

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarp = nthr >> 5;
  const int b = blockIdx.y;
  const int wy = blockIdx.x / nww, wx = blockIdx.x % nww;

  if (tid < kTok) {
    const int y = wy * kWs + tid / kWs - pt;
    const int x = wx * kWs + tid % kWs - pl;
    pix[tid] = (y >= 0 && y < H && x >= 0 && x < W) ? (b * H + y) * W + x
                                                    : -1;
  }
  __syncthreads();

  // LayerNorm of the query source (and, in cross mode, the kv source).
  const int n_ln = cross ? 2 * kTok : kTok;
  for (int t = warp; t < n_ln; t += nwarp) {
    const int tok = t % kTok;
    const bool kv = t >= kTok;
    float* dst = (kv ? xkv : xq) + tok * C;
    const int p = pix[tok];
    if (p < 0) {
      for (int c = lane; c < C; c += 32) dst[c] = 0.f;
    } else {
      warp_layer_norm((kv ? kvsrc : qsrc) + (size_t)p * C, kv ? lnkv : lnq,
                      dst, C, lane);
    }
  }
  __syncthreads();

  // q | k | v = [LN_q | LN_kv | LN_kv] . Wqkv + bqkv
  for (int i = tid; i < kTok * C3; i += nthr) {
    const int t = i / C3, j = i % C3;
    const float* a = (j < C ? xq : xkv) + t * C;
    float acc = bqkv[j];
    for (int c = 0; c < C; ++c) acc = fmaf(a[c], __ldg(wqkv + c * C3 + j), acc);
    qkv[t * S3 + j] = acc;
  }
  __syncthreads();

  // per head: logits + bias, softmax, p . v -> head columns of xq
  const int d = C / nh;
  for (int h = 0; h < nh; ++h) {
    const float* bh = bias + h * kTok * kTok;
    for (int i = tid; i < kTok * kTok; i += nthr) {
      const int r = i / kTok, s = i % kTok;
      const float* qr = qkv + r * S3 + h * d;
      const float* ks = qkv + s * S3 + C + h * d;
      float acc = 0.f;
      for (int e = 0; e < d; ++e) acc = fmaf(qr[e], ks[e], acc);
      prob[i] = acc + __ldg(bh + i);
    }
    __syncthreads();
    for (int r = warp; r < kTok; r += nwarp) {
      float* row = prob + r * kTok;
      const bool two = lane + 32 < kTok;
      const float v0 = row[lane];
      const float v1 = two ? row[lane + 32] : v0;
      const float m = warp_max(fmaxf(v0, v1));
      const float e0 = expf(v0 - m);
      const float e1 = two ? expf(v1 - m) : 0.f;
      const float inv = 1.0f / warp_sum(e0 + e1);
      row[lane] = e0 * inv;
      if (two) row[lane + 32] = e1 * inv;
    }
    __syncthreads();
    for (int i = tid; i < kTok * d; i += nthr) {
      const int r = i / d, e = i % d;
      const float* pr = prob + r * kTok;
      const float* vc = qkv + 2 * C + h * d + e;
      float acc = 0.f;
      for (int s = 0; s < kTok; ++s) acc = fmaf(pr[s], vc[s * S3], acc);
      xq[r * C + h * d + e] = acc;
    }
    __syncthreads();
  }

  // out = res (+ z) + heads . Wo + bo, real pixels only
  for (int i = tid; i < kTok * C; i += nthr) {
    const int t = i / C, j = i % C;
    const int p = pix[t];
    if (p < 0) continue;
    const float* o = xq + t * C;
    float acc = bo[j];
    for (int c = 0; c < C; ++c) acc = fmaf(o[c], __ldg(wo + c * C + j), acc);
    const size_t g = (size_t)p * C + j;
    float r = load(res + g);
    if (zadd != nullptr) r += load(zadd + g);
    out[g] = store<T>(r + acc);
  }
}

template <typename T>
static int launch(const void* res, const void* qsrc, const void* kvsrc,
                  const void* zadd, void* out, const float* lnq,
                  const float* lnkv, const float* wqkv, const float* bqkv,
                  const float* wo, const float* bo, const float* bias, int B,
                  int H, int W, int C, int nh, int cross,
                  cudaStream_t stream) {
  const int ph = (H + kWs - 1) / kWs * kWs - H;
  const int pw = (W + kWs - 1) / kWs * kWs - W;
  const int nwh = (H + ph) / kWs, nww = (W + pw) / kWs;
  const size_t smem =
      sizeof(float) * ((cross ? 2 : 1) * kTok * C + kTok * ((3 * C) | 1) +
                       kTok * kTok);
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nwh * nww, B);
  window_attention_kernel<T><<<grid, 256, smem, stream>>>(
      static_cast<const T*>(res), static_cast<const T*>(qsrc),
      static_cast<const T*>(kvsrc), static_cast<const T*>(zadd),
      static_cast<T*>(out), lnq, lnkv, wqkv, bqkv, wo, bo, bias, H, W, C, nh,
      ph / 2, pw / 2, nww, cross);
  return (int)cudaGetLastError();
}

}  // namespace hrf

extern "C" int hrf_window_attention(
    const void* res, const void* qsrc, const void* kvsrc, const void* zadd,
    void* out, const float* lnq, const float* lnkv, const float* wqkv,
    const float* bqkv, const float* wo, const float* bo, const float* bias,
    int B, int H, int W, int C, int nh, int cross, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return hrf::launch<__nv_bfloat16>(res, qsrc, kvsrc, zadd, out, lnq, lnkv,
                                      wqkv, bqkv, wo, bo, bias, B, H, W, C,
                                      nh, cross, s);
  return hrf::launch<float>(res, qsrc, kvsrc, zadd, out, lnq, lnkv, wqkv,
                            bqkv, wo, bo, bias, B, H, W, C, nh, cross, s);
}
