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
// Three plans, picked by the host from the dtype, C and the head dim:
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
// "tf32x3" (float32 activations, head dim up to 64: every width of every
// preset, and any C; float32 has no other plan, so a wider head dim is
// refused with the bytes this plan would need): tensor cores in split TF32 (`common.cuh`:
// x = hi + lo, each product as lo.hi + hi.lo + hi.hi, three `mma.sync`
// m16n8k8 TF32 with f32 accumulators, about 2^-21 a product; one-pass
// TF32 would keep 2^-11), rounding nothing to bf16: the LN, softmax and
// products stay float32-accurate. "mma"'s decomposition, two launches
// (one at narrow C, below):
//   1. Attention: one block per (window, image, group of heads), 256
//      threads. A float32 window of C = 624 is 123 KB, and cross mode's
//      two would not fit 227 KB, so the window is never staged whole: LN
//      statistics of its tokens first (a warp a token, from L2), then
//      for each head of the group, K-slices of 32 channels of the tokens
//      (both windows in cross mode) and of that head's q | k | v columns
//      of the float32 Wqkv, cp.async double-buffered (16-byte copies
//      where rows are aligned, else 4-byte: C = 78, d = 39), each token
//      slice layer-normed in place (ring tokens and channels past C
//      zero), then the tile product q | k | v [49 x 3dp], d padded to
//      dp = 16, 24, 40 or 64 (four builds of the launch, to keep the
//      build short) inside the staged tile (zero-filled weight columns:
//      39 -> 40, 18 -> 24; the folded float32 weights as they are). Rows past token 48 read row 48 instead of padding:
//      their logits are masked, their probabilities 0. Four warps then
//      run the core in registers: q.k^T, bias, softmax, and p.v with p
//      from registers as the A operand (m16n8k8's A pairs columns t and
//      t + 4, the accumulator 2t and 2t + 1, so v's rows are read in that
//      order instead of shuffling p). Head outputs (f32) go to an O
//      scratch [B * nwin, 49, round4(C)].
//   2. Output: one block per (window, image, slice of Wo's columns): O
//      and the float32 Wo streamed in K-slices of 32, the tile product,
//      then bo, the real-pixel mask, the residual and z.
//   Shared memory does not grow with C: attention launch 50,304 B self
//   and 64,416 cross at dp = 24 (HRFuser-T), 72,000 and 86,112 at dp = 40
//   (HRFuser-B); output launch 33,056 B. Grids by `one_wave_per`, as
//   "mma". Registers: three blocks an SM at dp = 16 / 24 (80 a thread,
//   200-250 bytes spilled; 2-3 % faster at HRFuser-T's widths than two
//   blocks at 128), two at dp = 40 / 64 (128, 8-36 bytes spilled).
//   One launch at narrow C: where C <= 72 and dp <= 24 (HRFuser-T's
//   heads), the grid gives a block every head of its window and the head
//   outputs' [49][round8(C) + 4] floats (5.5 KB at C = 18, 14.9 KB at 72)
//   cost no block an SM, the attention launch keeps the head outputs in
//   shared memory and makes the Wo product and the output itself, as
//   launch 2 would: no second launch, no O scratch (96x160x18 self 0.207
//   -> 0.189 ms; cross at 24x78x72, where the fused block would cost a
//   block an SM, took 0.55 ms fused against 0.44 in two launches). The
//   LN pass rewrites every float of a token slice, so the slice's tail
//   past C is not copied. Copies 16 bytes wide where rows are aligned,
//   else 4 (8-byte copies cost this launch registers; launch 2 and kernel
//   B take them).
//   Measured (NVIDIA H100 80GB HBM3, 700 W, B = 8, ms, share of the
//   split-TF32 bound (3 x FLOPs at 495 TFLOP/s, or bytes at 3.35 TB/s) /
//   of the CUDA-core bound (FLOPs at 67 TFLOP/s); the CUDA-core loops'
//   time in brackets; `chip_profile.py --kernels --dtype f32`, in turns):
//   self 96x160x18 0.196, 2.7 / 5.7 % (0.189); 48x80x36 0.129 (0.141);
//   24x40x72 0.097-0.115 (0.163); 12x20x144 0.082-0.121 (0.395);
//   96x160x78 0.870, 5.5 / 13.5 % (1.725); 48x80x156 0.675, 6.2 / 15.3 %
//   (2.677); 24x40x312 0.755, 5.2 / 12.8 % (3.347); 12x20x624 0.718, 5.3
//   / 12.9 % (6.646). Two cross launches 2.0-5.0 / 4.3-12.4 %: behind the
//   loops at C = 18 and 36 (96x160x18 0.520 against 0.444, 48x80x36
//   0.332 against 0.303), ahead from C = 72 (24x78x72 0.445 against
//   0.575).
//   1.1-4.1x the "mma" plan's time at the same width. At C = 18-36 (one
//   or two slices of 32, one or two heads a block) a block's fixed work
//   outweighs its products. Knock-outs (`chip_profile.py --kernels
//   --unchecked`, copies of the tree with a part skipped, same card):
//   the projection's loads, splits and `mma` are 1-7 % of a self call,
//   the core 4-12 %, the token and weight copies 13-16 % at C = 18 and
//   25-30 % at C >= 78; the rest is the streamed skeleton (the LN pass
//   over each slice, three barriers a slice, the statistics), which the
//   tensor cores wait on.
//
// "scalar" (bf16 where "mma" has no plan: a head dim above 64 or a staged
// window past 227 KB; no preset has such a width): the CUDA-core loops
// that came before the tensor-core plans, built for bf16 only. Shared
// memory, 4-byte words, nx = 2 in cross mode, else 1:
//   pix, real [2][49]; stats [nx*49][2]; X [nx*49][CK] staged tokens;
//   QKV [49][S] (S odd); P [49][49]; O [49][C].
// "resident" (whenever it fits 227 KB): CK = C, all heads projected in
// one pass, O reuses X.
// "streamed": heads one at a time, each projected over channel chunks of
// CK re-staged from L2. A shape with no plan (C above about 1,000) is
// refused with its byte count (kErrNoPlan), never run another way.
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
// "scalar": f32 FMAs on CUDA cores with few blocks in flight (12x20x624
// self 6.71 ms when its float32 build served float32, before "tf32x3").
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
  // "tf32x3" plan
  float* obuf32;      // [B * nwin, 49, round4(C)] head outputs
  int vec_x, vec_w;   // copy widths (`copy_bytes`) of token rows and of
  int vec_o;          // Wqkv's head columns, and of Wo's rows
  int fuse;           // Wo in the attention launch (one launch, no obuf32)
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

// ---------------------------------------------------------------------------
// "tf32x3" plan: float32 on tensor cores (split TF32), two launches
// ---------------------------------------------------------------------------

constexpr int kSlice32 = 32;               // K-slice of the streamed products
constexpr int kSX32 = stride_a(kSlice32);  // row stride of a token slice
constexpr int kSO32 = stride_b(kOutSlice);  // row stride of a Wo slice

// The head dim padded to the next width the attention launch is built
// for: 16, 24, 40 or 64 (HRFuser-T's 18 and HRFuser-B's 39 waste 6 and 1
// columns); wider heads have no plan here.
static int head_pad32(int C, int nh) {
  const int d = C / nh;
  return d <= 16 ? 16 : d <= 24 ? 24 : d <= 40 ? 40 : d <= 64 ? 64 : d;
}

// Widest C whose Wo product runs in the attention launch when a block
// holds every head of its window: the head outputs stay in shared memory
// and the whole Wo [C][64] column tile fits the two stages. Built into
// the launches of padded head dims up to kFuseMaxDp only (HRFuser-T's):
// in the wider ones its code alone cost 4-5 % at C >= 78 (more spills).
constexpr int kFuseMaxC = 72, kFuseMaxDp = 24;

// Row stride of the head outputs held for that product ([49][round8(C)]).
__host__ __device__ constexpr int fused_stride(int C) {
  return stride_a(round_up(C, 8));
}

// pix, real [64] ints; LN statistics [2 * 49][2]; q | k | v [3][49][dp +
// 4]; two stages of {token slices [nx][49][kSX32], Wqkv slice [32][3dp
// padded]}; `fuse`: the head outputs [49][fused_stride(C)].
static size_t attn_tf32_smem(int C, int nh, int cross, bool fuse) {
  const size_t dp = head_pad32(C, nh), nx = cross ? 2 : 1;
  return sizeof(float) *
         (2 * kRows + 4 * kTok + 3 * kTok * (dp + 4) +
          2 * (nx * kTok * kSX32 + (size_t)kSlice32 * stride_b(3 * (int)dp)) +
          (fuse ? (size_t)kTok * fused_stride(C) : 0));
}

// The most the attention launch may take: with the head outputs where C
// allows the fused Wo product.
static size_t attn_tf32_smem(int C, int nh, int cross) {
  return attn_tf32_smem(
      C, nh, cross, C <= kFuseMaxC && head_pad32(C, nh) <= kFuseMaxDp);
}

static size_t out_tf32_smem() {
  return sizeof(float) *
         (2 * kRows + 2 * ((size_t)kTok * kSX32 + kSlice32 * kSO32));
}

static bool attn_tf32_fits(int C, int nh, int cross) {
  return head_pad32(C, nh) <= kMaxHeadPad &&
         attn_tf32_smem(C, nh, cross) <= kSmemMax;
}

// out = [res] [+ z] + real . (O . Wo + bo) for one warp's m16 x n32 tile
// of the Wo product (rows 16 wm.., columns n0..), from its accumulators.
__device__ __forceinline__ void store_out_tf32(const AttnArgs& a,
                                               const float (&acc)[1][4][4],
                                               const int* pix,
                                               const int* real, int n0,
                                               int wm, int lane) {
  const float* res = static_cast<const float*>(a.res);
  const float* z = static_cast<const float*>(a.zadd);
  float* out = static_cast<float*>(a.out);
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = 16 * wm + g + 8 * h;
      if (t >= kTok || pix[t] < 0) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + 8 * j + 2 * t4 + e;
        if (n >= a.C) continue;
        const size_t gi = (size_t)pix[t] * a.C + n;
        float r = res != nullptr ? res[gi] : 0.f;
        if (z != nullptr) r += z[gi];
        out[gi] = r + (real[t] ? acc[0][j][2 * h + e] + a.bo[n] : 0.f);
      }
    }
}

// Launch 1: per head of the block's group, q | k | v [49 x 3dp] by a tile
// product over K-slices of 32 channels streamed with their Wqkv rows
// (cp.async, double-buffered), each token slice layer-normed in place
// from statistics taken once; then the core on four warps: q.k^T, bias,
// softmax and p.v, from registers. Head outputs (f32) to a.obuf32, or,
// with a.fuse (the block holds every head, C <= kFuseMaxC), to shared
// memory, followed by the Wo product and the output as launch 2 makes
// them.
// Blocks an SM the registers are held to: three at HRFuser-T's head dims
// (padded 16 and 24), where a block's serial phases, not its products,
// take the time, and two above.
constexpr int attn_tf32_min_blocks(int dp) { return dp <= 24 ? 3 : 2; }

template <int DP>
__global__ void __launch_bounds__(kThreads, attn_tf32_min_blocks(DP))
    window_attention_tf32_kernel(const AttnArgs a) {
  constexpr int SD = DP + 4;                // q | k | v row stride
  constexpr int SN = stride_b(3 * DP);      // Wqkv slice row stride
  constexpr int NJ = 3 * DP / 8;            // q | k | v n8 tiles
  constexpr int NTW = (NJ + 1) / 2;         // ... of one warp
  extern __shared__ __align__(16) float smf[];
  const int C = a.C, d = C / a.nh, nx = a.cross ? 2 : 1;
  int* pix = reinterpret_cast<int*>(smf);  // [64]
  int* real = pix + kRows;                 // [64]
  float* stats = smf + 2 * kRows;          // [nx * 49][2]
  float* qkv = stats + 4 * kTok;           // [3][49][SD]
  float* stages = qkv + 3 * kTok * SD;
  const int xsz = nx * kTok * kSX32, ssz = xsz + kSlice32 * SN;
  float* osm = stages + 2 * ssz;  // a.fuse: head outputs [49][so]
  const int cw = round_up(C, 8), so = fused_stride(C);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.x / a.nwin, win = blockIdx.x % a.nwin;
  const int h0 = blockIdx.y * a.group, nhb = min(a.group, a.nh - h0);
  const int nks = (C + kSlice32 - 1) / kSlice32, total = nhb * nks;
  const float* qsrc = static_cast<const float*>(a.qsrc);
  const float* kvsrc = static_cast<const float*>(a.kvsrc);
  if (tid < kRows) {
    if (tid < kTok) {
      map_token(a, b, win, tid, pix, real);
    } else {
      pix[tid] = -1;
      real[tid] = 0;
    }
  }
  if constexpr (DP <= kFuseMaxDp)
    if (a.fuse)  // the K padding of the Wo product, C .. round8(C)
      for (int e = tid; e < kTok * (cw - C); e += kThreads)
        osm[e / (cw - C) * so + C + e % (cw - C)] = 0.f;
  __syncthreads();

  // slice i: channels (i % nks) * 32 .. of the tokens and of head
  // h0 + i / nks's q | k | v columns of Wqkv (zero past d and past C)
  auto issue = [&](int i) {
    if (i < total) {
      float* xs = stages + (i & 1) * ssz;
      float* ws = xs + xsz;
      const int hh = h0 + i / nks, c0 = (i % nks) * kSlice32;
      async_rows<false>([&](int r) { return xs + r * kSX32; },
                 [&](int r) -> const float* {
                   const int tok = r % kTok;
                   if (pix[tok] < 0) return nullptr;
                   return (r >= kTok ? kvsrc : qsrc) + (size_t)pix[tok] * C +
                          c0;
                 },
                 nx * kTok, kSlice32, C - c0, a.vec_x, qsrc, tid, kThreads,
                 false);  // the LN pass writes every float of the slice
      async_rows<false>([&](int r) { return ws + (r % kSlice32) * SN +
                                     (r / kSlice32) * DP; },
                 [&](int r) -> const float* {
                   const int k = c0 + r % kSlice32;
                   if (k >= C) return nullptr;
                   return a.wqkv + (size_t)k * 3 * C + (r / kSlice32) * C +
                          hh * d;
                 },
                 3 * kSlice32, DP, d, a.vec_w, a.wqkv, tid, kThreads);
    }
    cp_async_commit();
  };
  issue(0);
  // LN statistics of every staged token, a warp a token, while slice 0
  // loads (ring tokens and windows mode: none)
  for (int t = warp; t < nx * kTok; t += kThreads / 32) {
    const int tok = t % kTok;
    const float* ln = t >= kTok ? a.lnkv : a.lnq;
    float mean = 0.f, rstd = 0.f;
    if (ln != nullptr && real[tok])
      warp_ln_stats((t >= kTok ? kvsrc : qsrc) + (size_t)pix[tok] * C, C,
                    lane, mean, rstd);
    if (lane == 0) {
      stats[2 * t] = mean;
      stats[2 * t + 1] = rstd;
    }
  }

  // projection: warp (wm, wh) computes rows 16 wm.., n8 tiles wh * NTW..
  const int wm = warp & 3, wh = warp >> 2;
  const int ra = min(16 * wm + g, kTok - 1), rb = min(16 * wm + g + 8,
                                                      kTok - 1);
  int i = 0;
  for (int hh = h0; hh < h0 + nhb; ++hh) {
    float acc[NTW][4];
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int r = 0; r < nks; ++r, ++i) {
      issue(i + 1);
      cp_async_wait<1>();
      __syncthreads();  // slice i landed, statistics written
      float* xs = stages + (i & 1) * ssz;
      const float* ws = xs + xsz;
      const int c0 = r * kSlice32;
      // LN in place; ring tokens and channels past C become zero
      for (int e = tid; e < nx * kTok * kSlice32; e += kThreads) {
        const int t = e / kSlice32, c = e % kSlice32, col = c0 + c;
        float* p = xs + t * kSX32 + c;
        const float* ln = t >= kTok ? a.lnkv : a.lnq;
        float v = 0.f;
        if (real[t % kTok] && col < C) {
          v = *p;
          if (ln != nullptr)
            v = (v - stats[2 * t]) * stats[2 * t + 1] * ln[col] + ln[C + col];
        }
        *p = v;
      }
      __syncthreads();
      const float* xq = xs;
      const float* xkv = xs + (a.cross ? kTok * kSX32 : 0);
#pragma unroll
      for (int ks = 0; ks < kSlice32 / 8; ++ks) {
        const int k = 8 * ks + t4;
        unsigned qh[4], ql[4], kh[4], kl[4];
        frag_a_split(qh, ql, xq + ra * kSX32, xq + rb * kSX32, k);
        if (a.cross) {
          frag_a_split(kh, kl, xkv + ra * kSX32, xkv + rb * kSX32, k);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            kh[e] = qh[e];
            kl[e] = ql[e];
          }
        }
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          const int jj = wh * NTW + j;  // n8 tile of q | k | v
          if (jj >= NJ) break;
          unsigned bh[2], bl[2], ah[4], al[4];
          frag_b_split(bh, bl, ws + k * SN + 8 * jj + g, SN);
          const bool q = 8 * jj < DP;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ah[e] = q ? qh[e] : kh[e];
            al[e] = q ? ql[e] : kl[e];
          }
          mma_split(acc[j], ah, al, bh, bl);
        }
      }
      __syncthreads();  // stage i & 1 free
    }
    // + bias -> q | k | v in shared memory (rows of real tokens' windows)
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const int jj = wh * NTW + j;
      if (jj >= NJ) break;
      const int col = 8 * jj + 2 * t4, part = col / DP, e0 = col % DP;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * wm + g + 8 * h;
        if (row >= kTok) continue;
        float2 o;
        o.x = acc[j][2 * h] +
              (e0 < d ? a.bqkv[part * C + hh * d + e0] : 0.f);
        o.y = acc[j][2 * h + 1] +
              (e0 + 1 < d ? a.bqkv[part * C + hh * d + e0 + 1] : 0.f);
        *reinterpret_cast<float2*>(qkv + (part * kTok + row) * SD + e0) = o;
      }
    }
    __syncthreads();

    // core: warp w < 4 owns query rows 16 w ..; rows and keys past 48 read
    // row 48 (their logits are masked, their probabilities 0)
    if (warp < 4) {
      const float* q = qkv;
      const float* k = qkv + kTok * SD;
      const float* v = qkv + 2 * kTok * SD;
      const int r0 = min(16 * warp + g, kTok - 1);
      const int r1 = min(16 * warp + g + 8, kTok - 1);
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < DP / 8; ++ks) {
        const int kk = 8 * ks + t4;
        unsigned qh[4], ql[4];
        frag_a_split(qh, ql, q + r0 * SD, q + r1 * SD, kk);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float* kr = k + min(8 * j + g, kTok - 1) * SD + kk;
          unsigned bh[2], bl[2];
          split_tf32(kr[0], bh[0], bl[0]);
          split_tf32(kr[4], bh[1], bl[1]);
          mma_split(s[j], qh, ql, bh, bl);
        }
      }
      const float* bh = a.bias + hh * kTok * kTok;
      float inv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + g + 8 * h;
        float m = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + 2 * t4 + e;
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
      // p . v with p from registers: in key block kb the A operand's
      // column t is key 8 kb + 2t and column t + 4 key 8 kb + 2t + 1 (the
      // accumulator's own pair), so v's rows are read in that order
      float o[DP / 8][4];
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
#pragma unroll
      for (int kb = 0; kb < 8; ++kb) {
        unsigned ph[4], pl[4];
        split_tf32(s[kb][0] * inv[0], ph[0], pl[0]);
        split_tf32(s[kb][2] * inv[1], ph[1], pl[1]);
        split_tf32(s[kb][1] * inv[0], ph[2], pl[2]);
        split_tf32(s[kb][3] * inv[1], ph[3], pl[3]);
        const float* v0 = v + min(8 * kb + 2 * t4, kTok - 1) * SD + g;
        const float* v1 = v + min(8 * kb + 2 * t4 + 1, kTok - 1) * SD + g;
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          unsigned vh[2], vl[2];
          split_tf32(v0[8 * j], vh[0], vl[0]);
          split_tf32(v1[8 * j], vh[1], vl[1]);
          mma_split(o[j], ph, pl, vh, vl);
        }
      }
      const int cs = round_up(C, 4);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * warp + g + 8 * h;
          if (r >= kTok) continue;
          float* dst = a.obuf32 + ((size_t)blockIdx.x * kTok + r) * cs;
          if constexpr (DP <= kFuseMaxDp)
            if (a.fuse) dst = osm + r * so;
          dst += hh * d;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + 2 * t4 + e;
            if (c < d) dst[c] = o[j][2 * h + e];
          }
        }
    }
    // the next head's q | k | v are written after its K loop, whose
    // barriers hold every warp until this core is done
  }
  if constexpr (DP <= kFuseMaxDp) {
    if (!a.fuse) return;
    // Wo product on every warp (m16 tile wm, n32 column group wh) per
    // column tile of 64, the tile's Wo rows [round8(C)][kSO32] over both
    // stages (free since the last K loop's barrier)
    for (int n0 = 0; n0 < C; n0 += kOutSlice) {
      async_rows<false>([&](int r) { return stages + r * kSO32; },
                 [&](int r) -> const float* {
                   return r < C ? a.wo + (size_t)r * C + n0 : nullptr;
                 },
                 cw, kOutSlice, C - n0, a.vec_o, a.wo, tid, kThreads,
                 false);  // columns past C are never stored
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();  // Wo tile landed, every head's output written
      float acc[1][4][4];
      zero_acc(acc);
      warp_mma_f32(acc, osm + 16 * wm * so, so, 1, 1, kTok - 16 * wm,
                   stages + 32 * wh, kSO32, cw / 8, lane);
      store_out_tf32(a, acc, pix, real, n0 + 32 * wh, wm, lane);
      __syncthreads();  // stages free for the next tile
    }
  }
}

// Launch 2: out = [res] [+ z] + real . (O . Wo + bo) over the block's
// slice of Wo's columns, O and Wo streamed in K-slices of 32.
__global__ void __launch_bounds__(kThreads) window_out_tf32_kernel(
    const AttnArgs a, int per_split) {
  extern __shared__ __align__(16) float smf[];
  const int C = a.C, cs = round_up(C, 4);
  int* pix = reinterpret_cast<int*>(smf);
  int* real = pix + kRows;
  float* stages = smf + 2 * kRows;  // 2 x {O [49][kSX32], Wo [32][kSO32]}
  const int osz = kTok * kSX32, ssz = osz + kSlice32 * kSO32;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / a.nwin, win = blockIdx.x % a.nwin;
  const int nt = round_up(C, kOutSlice) / kOutSlice;
  const int q0 = blockIdx.y * per_split, nq = min(per_split, nt - q0);
  const int nks = (C + kSlice32 - 1) / kSlice32, total = nq * nks;
  const float* orow = a.obuf32 + (size_t)blockIdx.x * kTok * cs;
  auto issue = [&](int i) {
    if (i < total) {
      float* os = stages + (i & 1) * ssz;
      float* ws = os + osz;
      const int n0 = (q0 + i / nks) * kOutSlice, c0 = (i % nks) * kSlice32;
      async_rows([&](int r) { return os + r * kSX32; },
                 [&](int r) { return orow + (size_t)r * cs + c0; }, kTok,
                 kSlice32, C - c0, 16, orow, tid, kThreads);
      async_rows([&](int r) { return ws + r * kSO32; },
                 [&](int r) -> const float* {
                   if (c0 + r >= C) return nullptr;
                   return a.wo + (size_t)(c0 + r) * C + n0;
                 },
                 kSlice32, kOutSlice, C - n0, a.vec_o, a.wo, tid, kThreads,
                 false);  // columns past C are never stored
    }
    cp_async_commit();
  };
  issue(0);
  if (tid < kTok) map_token(a, b, win, tid, pix, real);

  const int wm = warp & 3, wn = warp >> 2;  // m16 tile, n32 column group
  int i = 0;
  for (int q = 0; q < nq; ++q) {
    float acc[1][4][4];
    zero_acc(acc);
    for (int r = 0; r < nks; ++r, ++i) {
      issue(i + 1);
      cp_async_wait<1>();
      __syncthreads();  // slice i landed; pix, real written
      const float* os = stages + (i & 1) * ssz;
      warp_mma_f32(acc, os + 16 * wm * kSX32, kSX32, 1, 1, kTok - 16 * wm,
                   os + osz + 32 * wn, kSO32, kSlice32 / 8, lane);
      __syncthreads();
    }
    store_out_tf32(a, acc, pix, real, (q0 + q) * kOutSlice + 32 * wn, wm,
                   lane);
  }
}

// Launch 1. Its heads a block are sized on the unfused shared memory;
// where that gives a block every head, C <= kFuseMaxC and the head
// outputs' shared memory costs no block an SM, it also makes the output
// (a.fuse) and launch 2 is skipped. (Cross mode at C = 72 keeps two
// launches: one fused block fewer an SM took 0.55 ms for two cross calls
// at 24x78x72 against 0.44 unfused.)
template <int DP>
static int launch_attention_tf32(AttnArgs& a, int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_tf32_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)attn_tf32_smem(a.C, a.nh, a.cross));
  if (err != cudaSuccess) return (int)err;
  const void* kernel =
      reinterpret_cast<const void*>(window_attention_tf32_kernel<DP>);
  const int windows = B * a.nwin;
  const int wave =
      wave_blocks(kernel, kThreads, attn_tf32_smem(a.C, a.nh, a.cross, false));
  a.group = one_wave_per(windows, a.nh, 1, [wave](int) { return wave; });
  a.fuse = DP <= kFuseMaxDp && a.C <= kFuseMaxC && a.group == a.nh &&
           wave_blocks(kernel, kThreads,
                       attn_tf32_smem(a.C, a.nh, a.cross, true)) == wave;
  const size_t bytes = attn_tf32_smem(a.C, a.nh, a.cross, a.fuse);
  dim3 grid(windows, (a.nh + a.group - 1) / a.group);
  window_attention_tf32_kernel<DP><<<grid, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

static int launch_tf32(AttnArgs a, int B, cudaStream_t stream) {
  const int d = a.C / a.nh;
  a.vec_x = std::min(copy_bytes(a.qsrc, a.C), copy_bytes(a.kvsrc, a.C));
  a.vec_w = std::min(copy_bytes(a.wqkv, a.C), copy_bytes(a.wqkv, d));
  a.vec_o = copy_bytes(a.wo, a.C);
  int err;
  switch (head_pad32(a.C, a.nh)) {
    case 16: err = launch_attention_tf32<16>(a, B, stream); break;
    case 24: err = launch_attention_tf32<24>(a, B, stream); break;
    case 40: err = launch_attention_tf32<40>(a, B, stream); break;
    case 64: err = launch_attention_tf32<64>(a, B, stream); break;
    default: return kErrNoPlan;
  }
  if (err != 0 || a.fuse) return err;
  const size_t bytes = out_tf32_smem();
  cudaError_t e = cudaFuncSetAttribute(
      window_out_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const int windows = B * a.nwin, nt = round_up(a.C, kOutSlice) / kOutSlice;
  const int wave = wave_blocks(
      reinterpret_cast<const void*>(window_out_tf32_kernel), kThreads, bytes);
  const int per = one_wave_per(windows, nt, 1, [wave](int) { return wave; });
  dim3 grid(windows, (nt + per - 1) / per);
  window_out_tf32_kernel<<<grid, kThreads, bytes, stream>>>(a, per);
  return (int)cudaGetLastError();
}

}  // namespace hrf

// The plan for (C, heads, cross, dtype). *mma = 1: the bf16 tensor-core
// plan, 2: the float32 one (*chunk = C, *resident = 0 for both),
// returning the attention launch's shared memory. Else, in bf16, the
// scalar plan's (*chunk = 0 when none fits); in float32 *chunk = 0 and
// the bytes "tf32x3" would need at this head dim.
extern "C" long long hrf_window_attention_plan(int C, int nh, int cross,
                                               int bf16, int* chunk,
                                               int* resident, int* mma) {
  *resident = 0;
  if (bf16 ? hrf::attn_mma_fits(C, nh, cross)
           : hrf::attn_tf32_fits(C, nh, cross)) {
    *chunk = C;
    *mma = bf16 ? 1 : 2;
    return (long long)(bf16 ? hrf::attn_mma_smem(C, nh, cross)
                            : hrf::attn_tf32_smem(C, nh, cross));
  }
  *mma = 0;
  if (!bf16) {  // float32 has no other plan
    *chunk = 0;
    return (long long)hrf::attn_tf32_smem(C, nh, cross);
  }
  size_t bytes;
  *chunk = hrf::attn_plan(C, nh, cross, resident, &bytes);
  return (long long)bytes;
}

// wqkvp [nh][3 round16(d)][round64(C)], wop [round64(C)][round64(C)]:
// bf16 weights packed for the bf16 tensor-core plan (bf16 activations
// only); obuf its head-output scratch, [B * nwin, 49, round8(C)] bf16 for
// that plan and [B * nwin, 49, round4(C)] float32 for the float32 one.
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
  a.obuf32 = static_cast<float*>(obuf);
  a.fuse = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16) {
    if (!hrf::attn_tf32_fits(C, nh, cross) || obuf == nullptr)
      return hrf::kErrNoPlan;
    return hrf::launch_tf32(a, B, s);
  }
  if (hrf::attn_mma_fits(C, nh, cross)) {
    if (wqkvp == nullptr || wop == nullptr || obuf == nullptr)
      return hrf::kErrNoPlan;
    return hrf::launch_mma(a, B, s);
  }
  return hrf::launch<__nv_bfloat16>(a, B, s);
}
