// Kernel A: 7x7 window attention, one block per (window, image).
//
// Replaces the attention parts of the TPU Pallas kernels
//   hrfuser_tpu/ops/pallas_chain.py:_chain_kernel (hrformer_chain,
//     pallas_call :878) and :_fusion_kernel (fusion_chain, pallas_call
//     :670), i.e. _ln_cf + _attn_groups;
//   hrfuser_tpu/ops/pallas_block.py:_attn_kernel (fused_window_attention,
//     pallas_call :228);
//   hrfuser_tpu/ops/pallas_attention.py:_attention_kernel
//     (fused_window_attention, pallas_call :125).
//
//   out = [res] [+ z] + real . (Wo . MHA(q = [LN_q](xq), kv = [LN_kv](xkv))
//                               + bo)
//
// Modes of the one kernel:
//   self / cross   kv comes from the query source and its LN, or from a
//                  second tensor (and LN); z is any tensor added on top.
//   maps           tokens are read from an NHWC map, either unpadded (only
//                  real pixels are written) or stored centre padded
//                  (`padded`: the ring is written as res + z, as
//                  pallas_block.py writes its whole slab).
//   windows        pre-partitioned [nwin, 49, C] token windows: the host
//                  passes them as nwin images of 7x7 with no LN and no
//                  residual, so the output is the pre-residual Wo.MHA + bo.
// Tokens on the centre-padding ring read as a zero LN output, so they
// enter the softmax with k = b_k and v = b_v, as the reference's
// zero-pad-then-project does (hrfuser_tpu/ops/window.py). The attention
// scale d^-0.5 is folded into Wq / bq by the host; `bias` is the gathered
// relative-position bias [nh, 49, 49].
//
// Shared-memory plans (4-byte words; nx = 2 in cross mode, else 1):
//   pix, real [2][49]   token rows in the stored frame, real-pixel flags
//   stats [nx*49][2]    LN mean and rstd per token
//   X [nx*49][CK]       staged (LN'd) tokens, channels [c0, c0 + CK)
//   QKV [49][S]         q | k | v, S rounded up to odd so column reads are
//                       conflict-free
//   P [49][49]          one head's probabilities
//   O [49][C]           the head outputs, gathered for the Wo product
// "resident" (taken whenever it fits 227 KB): CK = C, the
// window is staged once, all heads' q/k/v are projected in one pass
// (S = 3C | 1) and O reuses X. That covers every HRFuser-T width and
// HRFuser-B's C = 78 and 156 (163,856 B at C = 156, cross).
// "streamed": heads are streamed; each head projects its q/k/v (S = 3d | 1)
// over the channels in chunks of CK, the widest balanced chunk that fits,
// re-staging each chunk per head from L2 when CK < C; O has its own
// buffer. At C = 312, 8 heads, cross: CK = C, 217,168 B (resident would
// take 316,736 B). At C = 624, 16 heads (d = 39), cross: resident would
// take 622,496 B; 4 chunks of 156 take 217,168 B (self mode: 2 chunks of
// 312, 216,776 B). A shape with no plan (C above about 1,000) is refused
// with its byte count (kErrNoPlan), never run another way.
//
// What bounds it on the H100: at C = 18 (branch 0, 96x160) global loads
// of the window and per-block fixed cost; at C >= 144 the scalar-FMA
// projections (49 x 4C x C per window) on CUDA cores, with few blocks in
// flight (48 windows at 12x20, B = 8). Each token is read from device
// memory once per chunk pass and written once; weights come from L2
// through the read-only path. Tensor-core MMA and splitting a window over
// several blocks are later work.
#include "common.cuh"

namespace hrf {

constexpr int kWs = 7;
constexpr int kTok = kWs * kWs;
constexpr int kThreads = 256;
constexpr int kMinChunk = 32;

struct AttnArgs {
  const void* res;    // residual; nullptr: none (windows mode)
  const void* qsrc;   // query tokens
  const void* kvsrc;  // key/value tokens (the query tokens in self mode)
  const void* zadd;   // added to the output; nullptr: none
  void* out;
  const float* lnq;   // [2, C] LN of the query tokens; nullptr: no LN
  const float* lnkv;  // [2, C] LN of the kv tokens
  const float* wqkv;  // [C, 3C]
  const float* bqkv;  // [3C]
  const float* wo;    // [C, C]
  const float* bo;    // [C]
  const float* bias;  // [nh, 49, 49]
  int H, W;           // real map
  int C, nh;
  int pt, pl;         // centre pads
  int sh, sw;         // padded frame Hp x Wp
  int padded;         // tokens stored in the padded frame
  int cross;          // kv tokens or LN differ from the query's
  int nwin, nww;      // windows per image, per row
  int chunk;          // channels staged per pass
  int resident;       // all heads projected in one pass
};

static size_t attn_smem(int C, int nh, int cross, int chunk, bool resident) {
  const size_t nx = cross ? 2 : 1;
  const size_t s = (size_t)(resident ? 3 * C : 3 * (C / nh)) | 1;
  return sizeof(float) * (2 * kTok + nx * 2 * kTok + nx * kTok * chunk +
                          kTok * s + kTok * kTok +
                          (resident ? 0 : (size_t)kTok * C));
}

// The resident plan if it fits, else the widest streamed chunk, balanced
// over C, that fits; chunk 0 if none does. `bytes` gets the plan's shared
// memory (the last one tried if none fits).
static int attn_plan(int C, int nh, int cross, int* resident,
                     size_t* bytes) {
  *bytes = attn_smem(C, nh, cross, C, true);
  *resident = *bytes <= kSmemMax;
  if (*resident) return C;
  for (int n = 1;; ++n) {
    const int chunk = (C + n - 1) / n;
    *bytes = attn_smem(C, nh, cross, chunk, false);
    if (*bytes <= kSmemMax) return chunk;
    if (chunk <= kMinChunk) return 0;
  }
}

template <typename T>
__global__ void window_attention_kernel(const AttnArgs a) {
  extern __shared__ float smem[];
  const int C = a.C, C3 = 3 * C, CK = a.chunk, d = C / a.nh;
  const int pw = a.resident ? C : d;  // width of q, k and v in one pass
  const int NJ = 3 * pw, S = NJ | 1;
  const int nx = a.cross ? 2 : 1;
  int* pix = reinterpret_cast<int*>(smem);  // [49]
  int* real = pix + kTok;                   // [49]
  float* stats = smem + 2 * kTok;           // [nx * 49][2]
  float* xs = stats + nx * 2 * kTok;        // [nx * 49][CK]
  float* qkv = xs + nx * kTok * CK;         // [49][S]
  float* prob = qkv + kTok * S;             // [49][49]
  float* o = a.resident ? xs : prob + kTok * kTok;  // [49][C]
  const T* qsrc = static_cast<const T*>(a.qsrc);
  const T* kvsrc = static_cast<const T*>(a.kvsrc);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, nwarp = kThreads >> 5;
  const int b = blockIdx.x / a.nwin, win = blockIdx.x % a.nwin;
  const int wy = win / a.nww, wx = win % a.nww;

  if (tid < kTok) {
    const int y = wy * kWs + tid / kWs, x = wx * kWs + tid % kWs;
    const bool in = y >= a.pt && y < a.pt + a.H && x >= a.pl &&
                    x < a.pl + a.W;
    int p = -1;
    if (a.padded)
      p = (b * a.sh + y) * a.sw + x;
    else if (in)
      p = (b * a.H + y - a.pt) * a.W + x - a.pl;
    pix[tid] = p;
    real[tid] = in;
  }
  __syncthreads();

  const int nchunk = (C + CK - 1) / CK;
  for (int h = 0; h < a.nh; ++h) {
    const int hoff = a.resident ? 0 : h * d;  // head columns of this pass
    for (int k = 0; k < nchunk && (h == 0 || !a.resident); ++k) {
      const int c0 = k * CK, ck = min(CK, C - c0);
      if (nchunk > 1 || h == 0) {
        __syncthreads();  // the last chunk's readers are done
        // one warp per token: LN statistics on the first pass (the same
        // warp stages the token on every pass), then the chunk
        for (int t = warp; t < nx * kTok; t += nwarp) {
          const int tok = t % kTok;
          const bool kv = t >= kTok;
          float* dst = xs + t * CK;
          if (!real[tok]) {
            for (int c = lane; c < ck; c += 32) dst[c] = 0.f;
            continue;
          }
          const T* row = (kv ? kvsrc : qsrc) + (size_t)pix[tok] * C;
          const float* ln = kv ? a.lnkv : a.lnq;
          if (ln == nullptr) {
            for (int c = lane; c < ck; c += 32) dst[c] = load(row + c0 + c);
            continue;
          }
          float mean, rstd;
          if (h == 0 && k == 0) {
            warp_ln_stats(row, C, lane, mean, rstd);
            if (lane == 0) {
              stats[2 * t] = mean;
              stats[2 * t + 1] = rstd;
            }
          } else {
            mean = stats[2 * t];
            rstd = stats[2 * t + 1];
          }
          for (int c = lane; c < ck; c += 32)
            dst[c] = (load(row + c0 + c) - mean) * rstd * ln[c0 + c] +
                     ln[C + c0 + c];
        }
      }
      __syncthreads();
      // q | k | v (all heads, or head h) += X[:, :ck] . Wqkv[c0:c0 + ck]
      for (int i = tid; i < kTok * NJ; i += kThreads) {
        const int t = i / NJ, j = i % NJ, part = j / pw;
        const int col = part * C + hoff + j - part * pw;
        const float* xr = xs + ((part > 0 && a.cross) ? kTok + t : t) * CK;
        qkv[t * S + j] = dot_column(xr, a.wqkv + c0 * C3 + col, C3, ck,
                                    k == 0 ? a.bqkv[col] : qkv[t * S + j]);
      }
    }
    __syncthreads();

    // logits + bias, softmax, p . v -> this head's columns of O
    const int qoff = a.resident ? h * d : 0;  // q | k | v of head h in QKV
    const float* bh = a.bias + h * kTok * kTok;
    for (int i = tid; i < kTok * kTok; i += kThreads) {
      const int r = i / kTok, s = i % kTok;
      const float* qr = qkv + r * S + qoff;
      const float* ks = qkv + s * S + qoff + pw;
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
    for (int i = tid; i < kTok * d; i += kThreads) {
      const int r = i / d, e = i % d;
      const float* pr = prob + r * kTok;
      const float* vc = qkv + qoff + 2 * pw + e;
      float acc = 0.f;
      for (int s = 0; s < kTok; ++s) acc = fmaf(pr[s], vc[s * S], acc);
      o[r * C + h * d + e] = acc;
    }
    __syncthreads();
  }

  // out = [res] [+ z] + (real ? O . Wo + bo : 0), stored tokens only
  const T* res = static_cast<const T*>(a.res);
  const T* z = static_cast<const T*>(a.zadd);
  T* out = static_cast<T*>(a.out);
  for (int i = tid; i < kTok * C; i += kThreads) {
    const int t = i / C, j = i % C, p = pix[t];
    if (p < 0) continue;
    float acc = 0.f;
    if (real[t]) {
      acc = dot_column(o + t * C, a.wo + j, C, C, a.bo[j]);
    }
    const size_t g = (size_t)p * C + j;
    float r = res != nullptr ? load(res + g) : 0.f;
    if (z != nullptr) r += load(z + g);
    out[g] = store<T>(r + acc);
  }
}

template <typename T>
static int launch(AttnArgs a, int B, cudaStream_t stream) {
  size_t smem;
  a.chunk = attn_plan(a.C, a.nh, a.cross, &a.resident, &smem);
  if (a.chunk == 0) return kErrNoPlan;
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  window_attention_kernel<T><<<B * a.nwin, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace hrf

// Shared memory of the plan for (C, heads, cross); *chunk = 0: none fits.
extern "C" long long hrf_window_attention_plan(int C, int nh, int cross,
                                               int* chunk, int* resident) {
  size_t bytes;
  *chunk = hrf::attn_plan(C, nh, cross, resident, &bytes);
  return (long long)bytes;
}

extern "C" int hrf_window_attention(
    const void* res, const void* qsrc, const void* kvsrc, const void* zadd,
    void* out, const float* lnq, const float* lnkv, const float* wqkv,
    const float* bqkv, const float* wo, const float* bo, const float* bias,
    int B, int H, int W, int C, int nh, int padded, int cross, int bf16,
    void* stream) {
  using hrf::kWs;
  const int ph = (H + kWs - 1) / kWs * kWs - H;
  const int pw = (W + kWs - 1) / kWs * kWs - W;
  hrf::AttnArgs a;
  a.res = res;
  a.qsrc = qsrc;
  a.kvsrc = kvsrc;
  a.zadd = zadd;
  a.out = out;
  a.lnq = lnq;
  a.lnkv = lnkv;
  a.wqkv = wqkv;
  a.bqkv = bqkv;
  a.wo = wo;
  a.bo = bo;
  a.bias = bias;
  a.H = H;
  a.W = W;
  a.C = C;
  a.nh = nh;
  a.pt = ph / 2;
  a.pl = pw / 2;
  a.sh = H + ph;
  a.sw = W + pw;
  a.padded = padded;
  a.cross = cross;
  a.nww = (W + pw) / kWs;
  a.nwin = (H + ph) / kWs * a.nww;
  a.chunk = 0;
  a.resident = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return hrf::launch<__nv_bfloat16>(a, B, s);
  return hrf::launch<float>(a, B, s);
}
