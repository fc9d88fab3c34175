// The JPEG decoder's pixel half: dequantisation, inverse DCT, upsampling
// and colour conversion, in two launches an image (one for a lossless
// frame, below).
//
// Replaces no TPU kernel: the JAX package decodes camera JPEGs on the host
// with libjpeg (hrfuser_tpu/data/native.py, _native/loader.cpp) or cv2,
// and this kernel takes their place after the host's entropy decoding
// (csrc/jpeg_entropy.cpp). The plain twin is data/jpeg.py:pixels_plain.
//
// The function is libjpeg-turbo's decoder on x86-64 (jidctint-avx2.asm,
// jdsample.c, jdcolor.c), and cv2's CMYK conversion after it, so that the
// output is bit-equal to the JAX package's decoder and to cv2:
//  - launch 1, one 8x8 block a group of 8 threads: each coefficient times
//    its quantisation value, kept to 16 bits (pmullw); the ISLOW transform
//    (CONST_BITS 13, PASS1_BITS 2) down the columns, each thread one
//    column, saturated to 16 bits, through shared memory, then along the
//    rows, each thread one row, descaled by 18, saturated to [-128, 127]
//    and offset by 128. The SIMD code's 16-bit sums (x0 +- x4, x7 + x3,
//    x5 + x1) wrap, and a block whose rows 1-7 are all zero takes its
//    shortcut, (c * q) << 2 in 16 bits. Each component's samples go to a
//    uint8 plane over its MCU-padded block grid. A grey read of a grey or
//    YCbCr file transforms the first component alone.
//  - launch 2, one thread an output pixel: each component's sample at the
//    pixel, by fancy upsampling (h2v1, h1v2, h2v2 linear interpolation
//    between sample centres, with libjpeg-turbo's alternating rounding
//    biases; plain repetition for other integral ratios and for chroma 2
//    samples wide or less), the sample grid clamped at the image's last
//    real row and column; then the fixed-point YCbCr -> RGB of jdcolor.c
//    (SCALEBITS 16), clamped to [0, 255], stored as B, G, R. Grey repeats
//    its one plane; RGB files are copied; CMYK (and YCCK, first turned
//    CMYK as jdcolor.c's ycck_cmyk_convert does) goes to BGR as cv2's
//    icvCvt_CMYK2BGR_8u_C4C3R does. A grey read stores one byte: the luma,
//    jdcolor.c's rgb_gray_convert of RGB, cv2's icvCvt_CMYK2Gray of CMYK.
//
// Lossless frames (SOF3) take launch 2 alone: the host rebuilds their
// samples (csrc/jpeg_entropy.cpp), repeated to full size and laid out as
// launch 1 lays out its planes (each component 64 bytes a tile of its
// 8x8 tiles), so every component runs here as a full-size one (1x1, no
// upsampling): RGB stored as B, G, R, CMYK as cv2 converts it.
//
// What bounds it on the H100: for a 900x1600 4:2:0 frame it reads 34,200
// blocks of 128 bytes of coefficients (4.38 MB) and writes 4.32 MB of
// BGR, 2.6 us at 3.35 TB/s; its integer work, counted from this code in
// chip_smoke.py (1,632 operations a block, 106 a pixel: 208 M), takes
// 6.2 us at the card's 32-bit integer rate (64 results an SM a clock,
// CUDA C++ Programming Guide, compute capability 9.0: 33.5 T op/s with a
// multiply-add counted as two), so the integer work bounds it. A
// 4-component frame with K at 2x2 has 57,000 blocks (253 M operations,
// 7.6 us). The planes (1.4 MB at 4:2:0) stay in the 50 MB L2 between the
// launches. The design is the simple one: no tiling across blocks, no
// fusion of the two launches, no vector loads, the parameters indexed at
// run time (they live on the stack); its time is in PERF.md.

#include <cuda_runtime.h>

#include <cstdint>

namespace hrf {

struct JpegComp {
  int rows, cols;  // MCU-padded block grid
  int dh, dw;      // sample rows and columns that hold the image
  int ey, ex;      // upsampling factors
};

struct JpegParams {
  JpegComp c[4];
  int n;
  long long start[5];  // first block of each component
};

namespace {

__device__ __forceinline__ int wrap16(int x) { return (int)(int16_t)x; }

__device__ __forceinline__ int add32(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int sub32(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

__device__ __forceinline__ int sat(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// One 8-point ISLOW pass as jidctint-avx2.asm computes it: inputs are
// 16-bit values; outputs descaled by `shift` and saturated to 16 bits.
__device__ __forceinline__ void idct8(const int* x, int* out, int shift) {
  int tmp3 = x[2] * 10703 + x[6] * 4433;
  int tmp2 = x[2] * 4433 + x[6] * -10704;
  int tmp0 = wrap16(x[0] + x[4]) * 8192;
  int tmp1 = wrap16(x[0] - x[4]) * 8192;
  int tmp10 = add32(tmp0, tmp3), tmp13 = sub32(tmp0, tmp3);
  int tmp11 = add32(tmp1, tmp2), tmp12 = sub32(tmp1, tmp2);
  int z3 = wrap16(x[7] + x[3]);
  int z4 = wrap16(x[5] + x[1]);
  int z3p = z3 * -6436 + z4 * 9633;
  int z4p = z3 * 9633 + z4 * 6437;
  int o0 = add32(x[7] * -4927 + x[1] * -7373, z3p);
  int o1 = add32(x[5] * -4176 + x[3] * -20995, z4p);
  int o2 = add32(x[5] * -20995 + x[3] * 4177, z3p);
  int o3 = add32(x[7] * -7373 + x[1] * 4926, z4p);
  int half = 1 << (shift - 1);
  int a[8] = {add32(tmp10, o3), add32(tmp11, o2), add32(tmp12, o1),
              add32(tmp13, o0), sub32(tmp13, o0), sub32(tmp12, o1),
              sub32(tmp11, o2), sub32(tmp10, o3)};
#pragma unroll
  for (int k = 0; k < 8; k++)
    out[k] = sat(add32(a[k], half) >> shift, -32768, 32767);
}

constexpr int kBlocksPerCta = 32;

}  // namespace

// the first `ncoded` components (a grey read of a YCbCr file codes only
// its luma, as libjpeg then skips the chroma)
__global__ void __launch_bounds__(256)
    jpeg_idct_kernel(const int16_t* __restrict__ coefs,
                     uint8_t* __restrict__ planes, JpegParams p, int ncoded) {
  __shared__ int ws[kBlocksPerCta][64];
  int local = threadIdx.x >> 3, t = threadIdx.x & 7;
  long long total = p.start[ncoded];
  long long blk = (long long)blockIdx.x * kBlocksPerCta + local;
  bool live = blk < total;
  int ci = 0;
  while (ci + 1 < ncoded && blk >= p.start[ci + 1]) ci++;
  const int16_t* src = coefs + (live ? blk : 0) * 64;
  const int16_t* q = coefs + p.start[p.n] * 64 + ci * 64;

  // pass 1: column t
  int x[8], nz = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    int c = src[k * 8 + t];
    if (k) nz |= c;
    x[k] = wrap16(c * q[k * 8 + t]);
  }
  // the group of 8 lanes agrees whether the block's rows 1-7 are zero
  nz |= __shfl_xor_sync(0xffffffffu, nz, 1);
  nz |= __shfl_xor_sync(0xffffffffu, nz, 2);
  nz |= __shfl_xor_sync(0xffffffffu, nz, 4);
  int col[8];
  if (nz) {
    idct8(x, col, 11);
  } else {
    int dc = wrap16(x[0] * 4);
#pragma unroll
    for (int k = 0; k < 8; k++) col[k] = dc;
  }
#pragma unroll
  for (int k = 0; k < 8; k++) ws[local][k * 8 + t] = col[k];
  __syncwarp();

  // pass 2: row t
  int row[8], out[8];
#pragma unroll
  for (int k = 0; k < 8; k++) row[k] = ws[local][t * 8 + k];
  idct8(row, out, 18);
  if (!live) return;
  unsigned lo = 0, hi = 0;
#pragma unroll
  for (int k = 0; k < 4; k++) {
    lo |= (unsigned)(sat(out[k], -128, 127) + 128) << (8 * k);
    hi |= (unsigned)(sat(out[k + 4], -128, 127) + 128) << (8 * k);
  }
  const JpegComp& c = p.c[ci];
  long long b = blk - p.start[ci];
  long long br = b / c.cols, bc = b % c.cols;
  long long stride = (long long)c.cols * 8;
  uint8_t* dst = planes + p.start[ci] * 64 + (br * 8 + t) * stride + bc * 8;
  *reinterpret_cast<uint2*>(dst) = make_uint2(lo, hi);
}

namespace {

__device__ __forceinline__ int at(const uint8_t* pl, const JpegComp& c, int r,
                                  int col) {
  r = sat(r, 0, c.dh - 1);
  col = sat(col, 0, c.dw - 1);
  return pl[(long long)r * c.cols * 8 + col];
}

// component c's sample at output pixel (y, x): libjpeg-turbo's upsampler
__device__ __forceinline__ int upsample(const uint8_t* pl, const JpegComp& c,
                                        int y, int x) {
  if (c.ey == 1 && c.ex == 1) return at(pl, c, y, x);
  if (c.ey == 1 && c.ex == 2 && c.dw > 2) {  // h2v1 fancy
    int j = x >> 1, u = x & 1;
    return (3 * at(pl, c, y, j) + at(pl, c, y, j + 2 * u - 1) + 1 + u) >> 2;
  }
  if (c.ey == 2 && c.ex == 1) {  // h1v2 fancy
    int i = y >> 1, v = y & 1;
    return (3 * at(pl, c, i, x) + at(pl, c, i + 2 * v - 1, x) + 1 + v) >> 2;
  }
  if (c.ey == 2 && c.ex == 2 && c.dw > 2) {  // h2v2 fancy
    int i = y >> 1, v = y & 1, j = x >> 1, u = x & 1;
    int r2 = i + 2 * v - 1, c2 = j + 2 * u - 1;
    int near = 3 * at(pl, c, i, j) + at(pl, c, r2, j);
    int far = 3 * at(pl, c, i, c2) + at(pl, c, r2, c2);
    return (3 * near + far + 8 - u) >> 4;
  }
  return at(pl, c, y / c.ey, x / c.ex);
}

__device__ __forceinline__ void ycc_rgb(const int* s, int& r, int& g,
                                        int& b) {
  int xb = s[1] - 128, xr = s[2] - 128;
  r = sat(s[0] + ((91881 * xr + 32768) >> 16), 0, 255);
  g = sat(s[0] + ((-22554 * xb + 32768 - 46802 * xr) >> 16), 0, 255);
  b = sat(s[0] + ((116130 * xb + 32768) >> 16), 0, 255);
}

// cv2's CMYK -> BGR (icvCvt_CMYK2BGR_8u_C4C3R) of one ink
__device__ __forceinline__ int ink(int v, int k) {
  return k - (((255 - v) * k) >> 8);
}

}  // namespace

// colour: 0 grey, 1 YCbCr, 2 RGB, 3 CMYK, 4 YCCK; channels: 3 (BGR) or
// 1 (grey: the first plane of a grey or YCbCr file, jdcolor.c's
// rgb_gray_convert of RGB, cv2's icvCvt_CMYK2Gray_8u_C4C1R of CMYK)
__global__ void __launch_bounds__(256)
    jpeg_color_kernel(const uint8_t* __restrict__ planes,
                      uint8_t* __restrict__ out, JpegParams p, int height,
                      int width, int colour, int channels) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)height * width) return;
  int y = (int)(idx / width), x = (int)(idx % width);
  int s[4];
  for (int i = 0; i < p.n; i++)
    s[i] = upsample(planes + p.start[i] * 64, p.c[i], y, x);
  int b, g, r;
  if (colour == 0 || (colour == 1 && channels == 1)) {
    b = g = r = s[0];
  } else if (colour == 2) {
    r = s[0];
    g = s[1];
    b = s[2];
  } else if (colour == 1) {
    ycc_rgb(s, r, g, b);
  } else {
    int c = s[0], m = s[1], yy = s[2];
    if (colour == 4) {  // YCCK -> CMYK (jdcolor.c ycck_cmyk_convert)
      ycc_rgb(s, c, m, yy);
      c = 255 - c;
      m = 255 - m;
      yy = 255 - yy;
    }
    r = ink(c, s[3]);
    g = ink(m, s[3]);
    b = ink(yy, s[3]);
    if (channels == 1) {
      out[idx] = (uint8_t)((b * 1868 + g * 9617 + r * 4899 + 8192) >> 14);
      return;
    }
  }
  if (channels == 1) {
    out[idx] = colour == 2
        ? (uint8_t)((19595 * r + 38470 * g + 7471 * b + 32768) >> 16)
        : (uint8_t)r;
    return;
  }
  uint8_t* o = out + idx * 3;
  o[0] = (uint8_t)b;
  o[1] = (uint8_t)g;
  o[2] = (uint8_t)r;
}

namespace {

JpegParams params_of(const int* comp, int n) {
  JpegParams p{};
  p.n = n;
  p.start[0] = 0;
  for (int i = 0; i < n; i++) {
    p.c[i] = JpegComp{comp[6 * i], comp[6 * i + 1], comp[6 * i + 2],
                  comp[6 * i + 3], comp[6 * i + 4], comp[6 * i + 5]};
    p.start[i + 1] = p.start[i] + (long long)p.c[i].rows * p.c[i].cols;
  }
  return p;
}

}  // namespace
}  // namespace hrf

// comp: per component (block rows, block cols, sample rows, sample cols,
// row factor, column factor); coefs: the blocks, then n x 64 quantisation
// values (int16); planes: 64 bytes a block, of the first `ncoded`
// components.
extern "C" int hrf_jpeg_idct(const void* coefs, void* planes, const int* comp,
                             int n, int ncoded, void* stream) {
  if (n < 1 || n > 4 || ncoded < 1 || ncoded > n)
    return (int)cudaErrorInvalidValue;
  hrf::JpegParams p = hrf::params_of(comp, n);
  long long grid =
      (p.start[ncoded] + hrf::kBlocksPerCta - 1) / hrf::kBlocksPerCta;
  hrf::jpeg_idct_kernel<<<(unsigned)grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(coefs), static_cast<uint8_t*>(planes), p,
      ncoded);
  return (int)cudaGetLastError();
}

// colour: 0 grey, 1 YCbCr, 2 RGB, 3 CMYK, 4 YCCK; n: the planes read;
// out: BGR uint8 [height, width, 3], or grey [height, width] if channels
// is 1
extern "C" int hrf_jpeg_color(const void* planes, void* out, const int* comp,
                              int n, int height, int width, int colour,
                              int channels, void* stream) {
  if (n < 1 || n > 4 || (channels != 1 && channels != 3))
    return (int)cudaErrorInvalidValue;
  hrf::JpegParams p = hrf::params_of(comp, n);
  long long pixels = (long long)height * width;
  unsigned grid = (unsigned)((pixels + 255) / 256);
  hrf::jpeg_color_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(planes), static_cast<uint8_t*>(out), p,
      height, width, colour, channels);
  return (int)cudaGetLastError();
}
