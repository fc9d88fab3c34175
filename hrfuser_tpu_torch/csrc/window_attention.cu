// Kernel A: 7x7 window attention, eval.
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
// Two plans, picked by the host from the dtype, C and the head dim:
//
// "mma" (bf16 activations, head dim up to 64, whose staged window fits
// 227 KB: every HRFuser-T and HRFuser-B width): tensor cores (`mma.sync`
// m16n8k16, bf16 operands, f32 accumulators), two launches of this file
// per call.
//   1. Attention: one block per (window, image, group of heads), 256
//      threads. The LN'd window (and the kv window in cross mode) is
//      staged once as bf16, 49 tokens padded to 64 rows, C zero-padded to
//      a multiple of 64: 83 KB each at C = 624. For each head of the
//      group, q | k | v [64 x 3dp] come from one tile product, K-slices
//      of 32 of the packed Wqkv streamed through a three-stage cp.async
//      ring, the head dim d padded to dp, a multiple of 16, with zero
//      weight rows (39 -> 48, 18 -> 32), as the TPU stackers pad odd head
//      dims (`pallas_chain.py:328-332`). q, k, v are rounded to bf16
//      (`pallas_chain.py:450`). Four warps then run the core, 16 query
//      rows each, in registers: logits q.k^T by `mma`, bias, the padding
//      keys masked, an f32 softmax, the probabilities rounded to bf16
//      (`pallas_chain.py:352`) and fed from registers as the A operand of
//      p.v by `mma`. The head output, rounded to bf16, goes to an O
//      scratch [B * nwin, 49, C8] in device memory (L2-resident at the
//      shapes of the configs: 2.9 MB at 12x20x624, B = 8).
//   2. Output: one block per (window, image, slice of Wo's columns): O of
//      the window staged in shared memory, Wo.O by the tile product with
//      64 x 64 weight slices streamed by cp.async, then bo, the real-pixel
//      mask, the residual and z.
//   The Wo product needs every head's output, so it cannot run in the
//   blocks that split the heads. A second launch over the L2-resident
//   scratch was taken over a thread-block cluster because it keeps both
//   launches free of cluster-size limits (16 heads do not split evenly
//   into the 2, 4 or 8 blocks of a portable cluster) and lets the Wo
//   launch pick its own split.
//   Grid: a block's fixed work (staging and normalising its window) does
//   not shrink when its heads or Wo columns are split further, so both
//   launches split as far as one wave of the card still holds
//   (`common.cuh:one_wave_per`, from the occupancy calculator), no
//   further. Plan per width, B = 8 (heads a block / blocks; Wo column
//   tiles of 64 a block / blocks): 96x160x18 1 / 2,576, 1 / 2,576;
//   12x20x144 1 / 384 (cross 2 / 192), 1 / 144; 96x160x78 2 / 2,576,
//   2 / 2,576; 48x80x156 4 / 672, 3 / 672; 24x40x312 8 / 192, 3 / 384;
//   12x20x624 8 / 96, 2 / 240. At 12x20x624 the attention launch has 96
//   blocks, fewer than the 132 SMs, because its shared memory (139,520 B
//   self, 222,464 B cross) holds one block an SM: the first plan's 3
//   groups of 6 heads (144 blocks) took two waves, 0.199 ms self and
//   0.258 ms cross for the attention launch, against 0.168 and 0.199 for
//   2 groups of 8 (H100, 700 W). Output launch at C = 624: 111,104 B.
//
// "scalar" (float32 activations, and bf16 where "mma" has no plan): the
// CUDA-core loops that came before "mma", kept for the float32
// correctness path. Shared
// memory, 4-byte words, nx = 2 in cross mode, else 1:
//   pix, real [2][49]; stats [nx*49][2]; X [nx*49][CK] staged tokens;
//   QKV [49][S] (S odd); P [49][49]; O [49][C].
// "resident" (whenever it fits 227 KB, every HRFuser-T width and C = 78
// and 156): CK = C, all heads projected in one pass, O reuses X.
// "streamed": heads one at a time, each projected over channel chunks of
// CK re-staged from L2 (C = 624 cross: 4 chunks of 156, 217,168 B). A
// shape with no plan (C above about 1,000) is refused with its byte count
// (kErrNoPlan), never run another way.
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W), "mma", bf16,
// B = 8, FLOPs of the model (T C (8C + 196) for T window tokens) over the
// call's time: self 21.6 TFLOP/s at 96x160x78 (0.374 ms), 32.0 at
// 48x80x156, 44.3 at 24x40x312, 36.7 at 12x20x624 (0.208 ms); two cross
// launches 16.4-31.3; HRFuser-T 6.1 (96x160x18) and 4.5 (12x20x144, where
// the host's work per call is as long as the kernels). That is 0.4-4.5 % of
// the 989 TFLOP/s bf16 peak, with 49 of 64 rows and 39 of 48 head
// columns useful. Not memory (a window is read once and written once),
// and not the weight copies: rings of 4 or 5 stages instead of 3 changed
// nothing measurable. With parts knocked out at 96x160x78 (same card):
// the head-output stores are 7 % of the attention launch and the output
// launch's stores 19 % of it. The rest, each block's serial phases
// (staging and LN of the window, the core on four of eight warps, the
// heads of a group in turn; at C = 624 one block an SM), was not
// separated further.
// "scalar": f32 FMAs on CUDA cores with few blocks in flight.
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
  // "mma" plan
  const bf16* wqkvp;  // [nh][3dp][KP] packed q | k | v rows of each head
  const bf16* wop;    // [round64(C)][KP] packed Wo^T
  bf16* obuf;         // [B * nwin, 49, round8(C)] head outputs
  int group;          // heads per block
};

// Token t of window `win` of image b: its row in the stored frame (-1:
// not stored) and whether it is a real pixel (else a centre-padding ring
// token, whose LN output is zero).
__device__ __forceinline__ void map_token(const AttnArgs& a, int b, int win,
                                          int t, int* pix, int* real) {
  const int wy = win / a.nww, wx = win % a.nww;
  const int y = wy * kWs + t / kWs, x = wx * kWs + t % kWs;
  const bool in = y >= a.pt && y < a.pt + a.H && x >= a.pl && x < a.pl + a.W;
  int p = -1;
  if (a.padded)
    p = (b * a.sh + y) * a.sw + x;
  else if (in)
    p = (b * a.H + y - a.pt) * a.W + x - a.pl;
  pix[t] = p;
  real[t] = in;
}

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
  if (tid < kTok) map_token(a, b, win, tid, pix, real);
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

// ---------------------------------------------------------------------------
// "mma" plan: bf16 on tensor cores
// ---------------------------------------------------------------------------

constexpr int kRows = 64;        // 49 tokens padded to four m16 tiles
constexpr int kQkvSlice = 32;    // K-slice of the q | k | v projection
constexpr int kOutSlice = 64;    // K- and N-slice of the Wo product
constexpr int kMaxHeadPad = 64;  // widest padded head dim with a plan
using Ring = WeightRing<3>;

static int head_pad(int C, int nh) { return round_up(C / nh, 16); }

static size_t attn_mma_smem(int C, int nh, int cross) {
  const int dp = head_pad(C, nh);
  return 2 * kRows * sizeof(int) +
         sizeof(bf16) * ((cross ? 2 : 1) * kRows *
                             (size_t)padded_stride(round_up(C, 64)) +
                         3 * kRows * (size_t)padded_stride(dp)) +
         Ring::bytes(3 * dp, kQkvSlice);
}

static size_t out_mma_smem(int C) {
  return 2 * kRows * sizeof(int) +
         sizeof(bf16) * kRows * (size_t)padded_stride(round_up(C, 64)) +
         Ring::bytes(kOutSlice, kOutSlice);
}

static bool attn_mma_fits(int C, int nh, int cross) {
  return head_pad(C, nh) <= kMaxHeadPad &&
         attn_mma_smem(C, nh, cross) <= kSmemMax &&
         out_mma_smem(C) <= kSmemMax;
}

// Launch 1: q | k | v of each head of the block's group, attention core,
// head outputs (bf16) to a.obuf. Registers are held to three blocks an SM
// up to DP = 32 (80 a thread, 16 bytes spilled at DP = 32: 20 % faster at
// 96x160x18 than two blocks at 128 registers) and to two at DP = 48 (128;
// three spill more than the third block buys, one is 1.4x slower).
constexpr int attn_min_blocks(int dp) {
  return dp <= 32 ? 3 : dp <= 48 ? 2 : 1;
}

template <int DP>
__global__ void __launch_bounds__(kThreads, attn_min_blocks(DP))
    window_attention_mma_kernel(
    const AttnArgs a) {
  constexpr int SD = padded_stride(DP);
  constexpr int NTW = 3 * DP / 16;  // q | k | v n8 tiles of one warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = a.C, d = C / a.nh, KP = round_up(C, 64);
  const int SX = padded_stride(KP), SQ = padded_stride(kQkvSlice);
  const int nx = a.cross ? 2 : 1;
  int* pix = reinterpret_cast<int*>(smem_raw);     // [64]
  int* real = pix + kRows;                          // [64]
  bf16* xs = reinterpret_cast<bf16*>(real + kRows);  // [nx][64][SX]
  bf16* qkv = xs + nx * kRows * SX;                 // [3][64][SD]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Ring ring{qkv + 3 * kRows * SD, 3 * DP, kQkvSlice, SQ, tid,
                  kThreads};
  const int b = blockIdx.x / a.nwin, win = blockIdx.x % a.nwin;
  const int h0 = blockIdx.y * a.group, nhb = min(a.group, a.nh - h0);
  const int nks = KP / kQkvSlice, total = nhb * nks;
  auto src = [&](int i) -> const bf16* {
    if (i >= total) return nullptr;
    return a.wqkvp + (size_t)(h0 + i / nks) * 3 * DP * KP +
           (i % nks) * kQkvSlice;
  };
  auto ld = [KP](int) { return KP; };
  ring.start(src, ld);

  if (tid < kRows) {
    if (tid < kTok) {
      map_token(a, b, win, tid, pix, real);
    } else {
      pix[tid] = -1;
      real[tid] = 0;
    }
  }
  __syncthreads();
  // raw tokens, then LN in place; padding rows and ring tokens stay zero
  const bf16* qsrc = static_cast<const bf16*>(a.qsrc);
  const bf16* kvsrc = static_cast<const bf16*>(a.kvsrc);
  stage_rows(
      xs, SX, nx * kRows, C,
      [&](int t) -> const bf16* {
        const int tok = t % kRows;
        if (!real[tok]) return nullptr;
        return (t >= kRows ? kvsrc : qsrc) + (size_t)pix[tok] * C;
      },
      tid, kThreads);
  __syncthreads();
  auto live = [&](int t) { return real[t % kRows] != 0; };
  ln_rows(xs, SX, kRows, C, KP, a.lnq, live, warp, kThreads / 32, lane);
  if (a.cross)
    ln_rows(xs + kRows * SX, SX, kRows, C, KP, a.lnkv, live, warp,
            kThreads / 32, lane);

  // projection: warp (wm, wh) computes rows 16 wm.., n8 tiles wh * NTW..
  const int wm = warp & 3, wh = warp >> 2;
  const bf16* xq = xs + 16 * wm * SX;
  const bf16* xkv = xq + (a.cross ? kRows * SX : 0);
  int i = 0;
  for (int hh = h0; hh < h0 + nhb; ++hh) {
    float acc[NTW][4];
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int r = 0; r < nks; ++r, ++i) {
      const bf16* w = ring.wait(i, src, ld);
#pragma unroll
      for (int ks = 0; ks < kQkvSlice / 16; ++ks) {
        const int k0 = r * kQkvSlice + 16 * ks;
        unsigned aq[4], ak[4];
        ldmatrix_a(aq, xq + k0, SX, lane);
        ldmatrix_a(ak, xkv + k0, SX, lane);
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          const int jj = wh * NTW + j;  // n8 tile of q | k | v
          unsigned bw[2], af[4];
          ldmatrix_b(bw, w + 8 * jj * SQ + 16 * ks, SQ, lane);
#pragma unroll
          for (int e = 0; e < 4; ++e) af[e] = 8 * jj < DP ? aq[e] : ak[e];
          mma_bf16(acc[j], af, bw);
        }
      }
      ring.release();
    }
    // + bias, rounded to bf16 -> q | k | v in shared memory
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const int col = 8 * (wh * NTW + j) + 2 * (lane & 3);
      const int part = col / DP, e0 = col % DP;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * wm + (lane >> 2) + 8 * h;
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          o[e] = acc[j][2 * h + e] +
                 (e0 + e < d ? a.bqkv[part * C + hh * d + e0 + e] : 0.f);
        *reinterpret_cast<unsigned*>(qkv + (part * kRows + row) * SD + e0) =
            pack_bf16(o[0], o[1]);
      }
    }
    __syncthreads();

    // core: warp w < 4 owns query rows 16 w ..; all 64 keys in registers
    if (warp < 4) {
      const bf16* q = qkv + 16 * warp * SD;
      const bf16* k = qkv + kRows * SD;
      const bf16* v = qkv + 2 * kRows * SD;
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {
        unsigned af[4];
        ldmatrix_a(af, q + 16 * ks, SD, lane);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          unsigned bk[2];
          ldmatrix_b(bk, k + 8 * j * SD + 16 * ks, SD, lane);
          mma_bf16(s[j], af, bk);
        }
      }
      const float* bh = a.bias + hh * kTok * kTok;
      float inv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + (lane >> 2) + 8 * h;
        float m = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + 2 * (lane & 3) + e;
            float x = s[j][2 * h + e];
            if (c >= kTok)
              x = -INFINITY;  // padding keys
            else if (r < kTok)
              x += __ldg(bh + r * kTok + c);
            s[j][2 * h + e] = x;
            m = fmaxf(m, x);
          }
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = expf(s[j][2 * h + e] - m);
            s[j][2 * h + e] = x;
            sum += x;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        inv[h] = 1.0f / sum;
      }
      // p (bf16, from registers) . v
      float o[DP / 8][4];
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        unsigned pa[4];
        const float(&lo)[4] = s[2 * kk], (&hi)[4] = s[2 * kk + 1];
        pa[0] = pack_bf16(lo[0] * inv[0], lo[1] * inv[0]);
        pa[1] = pack_bf16(lo[2] * inv[1], lo[3] * inv[1]);
        pa[2] = pack_bf16(hi[0] * inv[0], hi[1] * inv[0]);
        pa[3] = pack_bf16(hi[2] * inv[1], hi[3] * inv[1]);
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          unsigned bv[2];
          ldmatrix_b_trans(bv, v + 16 * kk * SD + 8 * j, SD, lane);
          mma_bf16(o[j], pa, bv);
        }
      }
      const int cs = round_up(C, 8);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * warp + (lane >> 2) + 8 * h;
          if (r >= kTok) continue;
          bf16* dst = a.obuf + ((size_t)blockIdx.x * kTok + r) * cs + hh * d;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + 2 * (lane & 3) + e;
            if (c < d) dst[c] = __float2bfloat16(o[j][2 * h + e]);
          }
        }
    }
    // the next head's q | k | v are written after its K loop, whose ring
    // waits hold every warp until this core is done
  }
}

// Launch 2: out = [res] [+ z] + real . (O . Wo + bo) over the block's
// slice of Wo's columns.
__global__ void __launch_bounds__(kThreads) window_out_mma_kernel(
    const AttnArgs a, int per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = a.C, KP = round_up(C, 64), SX = padded_stride(KP);
  const int SO = padded_stride(kOutSlice), cs = round_up(C, 8);
  int* pix = reinterpret_cast<int*>(smem_raw);
  int* real = pix + kRows;
  bf16* xo = reinterpret_cast<bf16*>(real + kRows);  // [64][SX]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Ring ring{xo + kRows * SX, kOutSlice, kOutSlice, SO, tid, kThreads};
  const int b = blockIdx.x / a.nwin, win = blockIdx.x % a.nwin;
  const int nt = round_up(C, kOutSlice) / kOutSlice;
  const int q0 = blockIdx.y * per_split, nq = min(per_split, nt - q0);
  const int nks = KP / kOutSlice, total = nq * nks;
  auto src = [&](int i) -> const bf16* {
    if (i >= total) return nullptr;
    return a.wop + (size_t)(q0 + i / nks) * kOutSlice * KP +
           (i % nks) * kOutSlice;
  };
  auto ld = [KP](int) { return KP; };
  ring.start(src, ld);
  if (tid < kTok) map_token(a, b, win, tid, pix, real);
  for (int e = tid; e < kRows * (KP / 8); e += kThreads) {
    const int r = e / (KP / 8), c = (e % (KP / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < kTok && c < C) {
      const bf16* s = a.obuf + ((size_t)blockIdx.x * kTok + r) * cs + c;
      if (c + 8 <= C) {
        v = *reinterpret_cast<const uint4*>(s);
      } else {
        bf16* vb = reinterpret_cast<bf16*>(&v);
        for (int u = 0; u < C - c; ++u) vb[u] = s[u];
      }
    }
    *reinterpret_cast<uint4*>(xo + r * SX + c) = v;
  }

  const bf16* res = static_cast<const bf16*>(a.res);
  const bf16* z = static_cast<const bf16*>(a.zadd);
  bf16* out = static_cast<bf16*>(a.out);
  const int wm = warp & 3, wn = warp >> 2;  // m16 tile, n32 column group
  int i = 0;
  for (int q = 0; q < nq; ++q) {
    float acc[1][4][4];
    zero_acc(acc);
    for (int r = 0; r < nks; ++r, ++i) {
      const bf16* w = ring.wait(i, src, ld);  // syncs xo, pix too
      warp_mma(acc, xo + 16 * wm * SX + r * kOutSlice, SX, 1, 1,
               w + 32 * wn * SO, SO, kOutSlice / 16, lane);
      ring.release();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = 16 * wm + (lane >> 2) + 8 * h;
        if (t >= kTok || pix[t] < 0) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = (q0 + q) * kOutSlice + 32 * wn + 8 * j +
                        2 * (lane & 3) + e;
          if (n >= C) continue;
          const size_t g = (size_t)pix[t] * C + n;
          float r = res != nullptr ? load(res + g) : 0.f;
          if (z != nullptr) r += load(z + g);
          out[g] = __float2bfloat16(
              r + (real[t] ? acc[0][j][2 * h + e] + a.bo[n] : 0.f));
        }
      }
  }
}

template <int DP>
static int launch_attention_mma(AttnArgs a, int B, cudaStream_t stream) {
  const size_t bytes = attn_mma_smem(a.C, a.nh, a.cross);
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_mma_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int windows = B * a.nwin;
  const int wave = wave_blocks(
      reinterpret_cast<const void*>(window_attention_mma_kernel<DP>),
      kThreads, bytes);
  a.group = one_wave_per(windows, a.nh, 1, [wave](int) { return wave; });
  dim3 grid(windows, (a.nh + a.group - 1) / a.group);
  window_attention_mma_kernel<DP><<<grid, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

static int launch_mma(AttnArgs a, int B, cudaStream_t stream) {
  int err;
  switch (head_pad(a.C, a.nh)) {
    case 16: err = launch_attention_mma<16>(a, B, stream); break;
    case 32: err = launch_attention_mma<32>(a, B, stream); break;
    case 48: err = launch_attention_mma<48>(a, B, stream); break;
    case 64: err = launch_attention_mma<64>(a, B, stream); break;
    default: return kErrNoPlan;
  }
  if (err != 0) return err;
  const size_t bytes = out_mma_smem(a.C);
  cudaError_t e = cudaFuncSetAttribute(
      window_out_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const int windows = B * a.nwin, nt = round_up(a.C, kOutSlice) / kOutSlice;
  const int wave = wave_blocks(
      reinterpret_cast<const void*>(window_out_mma_kernel), kThreads, bytes);
  const int per = one_wave_per(windows, nt, 1, [wave](int) { return wave; });
  dim3 grid(windows, (nt + per - 1) / per);
  window_out_mma_kernel<<<grid, kThreads, bytes, stream>>>(a, per);
  return (int)cudaGetLastError();
}

}  // namespace hrf

// The plan for (C, heads, cross, dtype). *mma = 1: the tensor-core plan
// (*chunk = C, *resident = 0), returning the attention launch's shared
// memory. Else the scalar plan's: *chunk = 0 when none fits.
extern "C" long long hrf_window_attention_plan(int C, int nh, int cross,
                                               int bf16, int* chunk,
                                               int* resident, int* mma) {
  if (bf16 && hrf::attn_mma_fits(C, nh, cross)) {
    *chunk = C;
    *resident = 0;
    *mma = 1;
    return (long long)hrf::attn_mma_smem(C, nh, cross);
  }
  size_t bytes;
  *chunk = hrf::attn_plan(C, nh, cross, resident, &bytes);
  *mma = 0;
  return (long long)bytes;
}

// wqkvp [nh][3 round16(d)][round64(C)], wop [round64(C)][round64(C)]:
// bf16 weights packed for the tensor-core plan; obuf [B * nwin, 49,
// round8(C)] bf16 scratch. Used for bf16 activations only.
extern "C" int hrf_window_attention(
    const void* res, const void* qsrc, const void* kvsrc, const void* zadd,
    void* out, const float* lnq, const float* lnkv, const float* wqkv,
    const float* bqkv, const float* wo, const float* bo, const float* bias,
    const void* wqkvp, const void* wop, void* obuf, int B, int H, int W,
    int C, int nh, int padded, int cross, int bf16, void* stream) {
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
  a.wqkvp = static_cast<const hrf::bf16*>(wqkvp);
  a.wop = static_cast<const hrf::bf16*>(wop);
  a.obuf = static_cast<hrf::bf16*>(obuf);
  a.group = a.nh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16 && hrf::attn_mma_fits(C, nh, cross)) {
    if (wqkvp == nullptr || wop == nullptr || obuf == nullptr)
      return hrf::kErrNoPlan;
    return hrf::launch_mma(a, B, s);
  }
  if (bf16) return hrf::launch<__nv_bfloat16>(a, B, s);
  return hrf::launch<float>(a, B, s);
}
