// Host half of the JPEG decoder: marker parsing and entropy decoding of
// 8-bit JPEG with 1, 3 or 4 components, in every coding libjpeg-turbo
// reads: baseline and extended sequential Huffman (SOF0, SOF1),
// progressive Huffman (SOF2), arithmetic sequential (SOF9) and
// arithmetic progressive (SOF10). No JPEG library is linked. The same
// tables also serve the host half of the JPEG writer
// (hrf_jpeg_encode_scan, at the end).
//
// It turns a byte stream into each component's quantised DCT coefficients
// (int16, natural order, [block rows, block cols, 64] over the
// component's MCU-padded block grid) and the quantisation table each
// component latched at its first scan. The card does the rest
// (csrc/jpeg_pixels.cu). Entropy decoding is sequential, so it stays on
// the host; this is the part of libjpeg's decoder that the port keeps on
// the CPU.
//
// Behaviour follows libjpeg-turbo 2.1's decoder (jdmarker.c, jdhuff.c,
// jdphuff.c, jdarith.c, jdcoefct.c), so that damaged and incomplete
// streams decode to the same coefficients:
//  - Huffman: bits past the end of a scan's data (the data ends, or a
//    marker comes early) read as zeros; the MCU in which that first
//    happens is decoded from those zeros, and every later MCU of the
//    restart interval is skipped: left all zero in a sequential scan
//    (DC included: the predictor is not applied), left as earlier scans
//    made it in a progressive one (a DC refinement reads the zeros).
//  - arithmetic: from a marker (or the end of the data) on the decoder
//    reads zero bytes and goes on decoding; a spectral or magnitude
//    overflow (ct = -1) leaves the rest of the restart interval as it
//    is. Statistics, predictors and DC contexts reset at each restart.
//  - at each restart marker the DC predictors (and EOB runs) reset and
//    the bit buffer realigns; a missing or out-of-order marker
//    resynchronises as jpeg_resync_to_restart does. A stream that
//    simply ends reads as if an EOI followed it; a marker segment cut
//    short after the first scan reads on into the EOI bytes libjpeg's
//    source inserts (FF D9 FF D9 ...).
//  - an invalid Huffman code decodes as symbol 0 after 17 bits; a run
//    that passes coefficient 63 writes coefficient 63; sequential DC sums
//    wrap as 32-bit integers and are stored as int16; quantisation
//    values are stored as int16 (libjpeg's ISLOW_MULT_TYPE).
//  - a progressive scan script is checked where jdphuff.c / jdarith.c
//    raise (Ss, Se, Ah, Al), and only warned about where they warn;
//    progressive scans find no standard Huffman tables (jdphuff.c
//    installs none; sequential scans do, for motion JPEG).
//  - block smoothing (jdcoefct.c decompress_smooth_data, libjpeg-turbo
//    2.1's 5x5 form): a progressive frame whose scans leave zigzag
//    coefficients 1-9 of some component imprecise (a cut file, or a
//    script without the last refinements) has those coefficients of each
//    block that are still zero estimated from the DC values around it,
//    and while no AC data has come the DC too; iMCU rows after the last
//    one the latest scan reached with data use the precision from before
//    that scan. The estimates are written into the coefficients, which
//    is what libjpeg feeds its inverse DCT. A complete frame is not
//    smoothed.
// Lossless frames (SOF3, Huffman-coded) decode as libjpeg-turbo 3
// (jdlhuff.c, jddiffct.c, jdlossls.c: what cv2 reads them with) decodes
// them through its 8-bit interface: precision 2-8, predictors 1-7, the
// point transform, restart intervals of whole MCU rows, any integral
// sampling factors (samples repeated to full size), 1, 3 (RGB: libjpeg
// converts no colour in lossless mode, so JFIF or an Adobe transform
// other than 0 is refused) or 4 (CMYK) components; a scan whose data
// runs out goes on from zero bits to the end of that MCU row, and each
// later row restarts prediction from zero differences. Hierarchical,
// arithmetic-coded lossless (which cv2 refuses too), other precisions and
// 2-component images are refused with a message naming the mode.
//
// C interface (ctypes):
//   hrf_jpeg_info(data, n, info, err, errlen): frame header -> info
//     (24 ints) = [height, width, ncomp, colour (0 grey, 1 YCbCr, 2 RGB,
//      3 CMYK, 4 YCCK), then per component: h, v, block rows, block
//      cols (a lossless frame: 1, 1 and its 8x8 tiles); at 20: lossless
//      (0 or 1), precision, the first scan's point transform]
//   hrf_jpeg_decode(data, n, out, out_len, err, errlen): out = every
//     component's coefficients, one after the other, then ncomp x 64
//     quantisation values (natural order); out_len counts int16 values.
//   hrf_jpeg_decode_samples(data, n, out, out_len, err, errlen): a
//     lossless frame's samples, each component a uint8 plane of its 8x8
//     tiles at full size (hrf_jpeg_info's rows x 8 by cols x 8, the image
//     at the top left, the rest 0), one after the other.
//   hrf_jpeg_encode_scan(blocks, nmcu, per_mcu, comp, out, cap, written,
//     err, errlen): Huffman-code one interleaved baseline scan with the
//     standard tables of Annex K.3 (see there).
// All return 0, or 1 with a message in err.

#include <cstdint>
#include <climits>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // a run past coefficient 63 lands on 63, as in libjpeg
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

const int kEOI = 0xD9;
const int kLookahead = 8;

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw Error(msg); }

struct HuffSpec {
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
};

// jpeg_make_d_derived_tbl's decoding tables
struct HuffTable {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint16_t look[1 << kLookahead];  // (length << 8) | symbol; length 9 = slow

  // `max_symbol`: the largest symbol a table may hold, checked for DC
  // tables (15; 16 in a lossless frame), -1 for none
  void build(const HuffSpec& spec, int max_symbol) {
    char size[257];
    uint32_t code_of[257];
    int p = 0;
    for (int l = 1; l <= 16; l++) {
      int i = spec.bits[l];
      if (p + i > 256) fail("bad Huffman table");
      while (i--) size[p++] = (char)l;
    }
    size[p] = 0;
    int nsym = p;
    uint32_t code = 0;
    int si = size[0];
    p = 0;
    while (size[p]) {
      while (size[p] == si) code_of[p++] = code++;
      if (code >= (1u << si)) fail("bad Huffman table");
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (spec.bits[l]) {
        valoffset[l] = p - (int32_t)code_of[p];
        p += spec.bits[l];
        maxcode[l] = (int32_t)code_of[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0xFFFFF;
    memcpy(vals, spec.vals, sizeof(vals));
    for (int i = 0; i < (1 << kLookahead); i++)
      look[i] = (kLookahead + 1) << 8;
    p = 0;
    for (int l = 1; l <= kLookahead; l++) {
      for (int i = 0; i < spec.bits[l]; i++, p++) {
        int base = code_of[p] << (kLookahead - l);
        for (int j = 0; j < (1 << (kLookahead - l)); j++)
          look[base + j] = (uint16_t)((l << 8) | spec.vals[p]);
      }
    }
    if (max_symbol >= 0)
      for (int i = 0; i < nsym; i++)
        if (spec.vals[i] > max_symbol) fail("bad Huffman table");
  }
};

// Annex K.3's tables (luma, chroma): code counts of lengths 1-16, symbols
const uint8_t kStdDcBits[2][16] = {{0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
                                   {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
const uint8_t kStdAcBits[2][16] = {{0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
                                   {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
const uint8_t kStdAcVals[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
     0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
     0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
     0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
     0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
     0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
     0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
     0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
     0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
     0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
     0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
     0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
     0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
     0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
     0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
     0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
     0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
     0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
     0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
     0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
     0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
     0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
     0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
     0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
     0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

HuffSpec standard_table(bool ac, int t) {
  HuffSpec spec;
  memcpy(spec.bits + 1, ac ? kStdAcBits[t] : kStdDcBits[t], 16);
  if (ac) {
    memcpy(spec.vals, kStdAcVals[t], 162);
  } else {
    for (int i = 0; i < 12; i++) spec.vals[i] = (uint8_t)i;
  }
  spec.defined = true;
  return spec;
}

struct Component {
  int id, h, v, tq;
  int fh, fv;              // the frame header's factors (lossless frames)
  int rows, cols;          // MCU-padded block grid
  int wblocks, hblocks;    // blocks that hold image samples (lossless:
                           // samples, a block being one)
  long offset;             // first coefficient in the output
  bool latched = false;
  int16_t quant[64];       // as the IDCT multiplies (ISLOW_MULT_TYPE)
  uint16_t qval[64];       // as block smoothing reads them (quantval)
};

// Table D.2 of the standard (jaricom.c): Qe << 16 | Next_Index_MPS << 8 |
// Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed 0.5 estimate
#define QE(a, b, c, d) (((uint32_t)(a) << 16) | ((c) << 8) | ((d) << 7) | (b))
const uint32_t kQe[114] = {
    QE(0x5a1d, 1, 1, 1),     QE(0x2586, 14, 2, 0),    QE(0x1114, 16, 3, 0),
    QE(0x080b, 18, 4, 0),    QE(0x03d8, 20, 5, 0),    QE(0x01da, 23, 6, 0),
    QE(0x00e5, 25, 7, 0),    QE(0x006f, 28, 8, 0),    QE(0x0036, 30, 9, 0),
    QE(0x001a, 33, 10, 0),   QE(0x000d, 35, 11, 0),   QE(0x0006, 9, 12, 0),
    QE(0x0003, 10, 13, 0),   QE(0x0001, 12, 13, 0),   QE(0x5a7f, 15, 15, 1),
    QE(0x3f25, 36, 16, 0),   QE(0x2cf2, 38, 17, 0),   QE(0x207c, 39, 18, 0),
    QE(0x17b9, 40, 19, 0),   QE(0x1182, 42, 20, 0),   QE(0x0cef, 43, 21, 0),
    QE(0x09a1, 45, 22, 0),   QE(0x072f, 46, 23, 0),   QE(0x055c, 48, 24, 0),
    QE(0x0406, 49, 25, 0),   QE(0x0303, 51, 26, 0),   QE(0x0240, 52, 27, 0),
    QE(0x01b1, 54, 28, 0),   QE(0x0144, 56, 29, 0),   QE(0x00f5, 57, 30, 0),
    QE(0x00b7, 59, 31, 0),   QE(0x008a, 60, 32, 0),   QE(0x0068, 62, 33, 0),
    QE(0x004e, 63, 34, 0),   QE(0x003b, 32, 35, 0),   QE(0x002c, 33, 9, 0),
    QE(0x5ae1, 37, 37, 1),   QE(0x484c, 64, 38, 0),   QE(0x3a0d, 65, 39, 0),
    QE(0x2ef1, 67, 40, 0),   QE(0x261f, 68, 41, 0),   QE(0x1f33, 69, 42, 0),
    QE(0x19a8, 70, 43, 0),   QE(0x1518, 72, 44, 0),   QE(0x1177, 73, 45, 0),
    QE(0x0e74, 74, 46, 0),   QE(0x0bfb, 75, 47, 0),   QE(0x09f8, 77, 48, 0),
    QE(0x0861, 78, 49, 0),   QE(0x0706, 79, 50, 0),   QE(0x05cd, 48, 51, 0),
    QE(0x04de, 50, 52, 0),   QE(0x040f, 50, 53, 0),   QE(0x0363, 51, 54, 0),
    QE(0x02d4, 52, 55, 0),   QE(0x025c, 53, 56, 0),   QE(0x01f8, 54, 57, 0),
    QE(0x01a4, 55, 58, 0),   QE(0x0160, 56, 59, 0),   QE(0x0125, 57, 60, 0),
    QE(0x00f6, 58, 61, 0),   QE(0x00cb, 59, 62, 0),   QE(0x00ab, 61, 63, 0),
    QE(0x008f, 61, 32, 0),   QE(0x5b12, 65, 65, 1),   QE(0x4d04, 80, 66, 0),
    QE(0x412c, 81, 67, 0),   QE(0x37d8, 82, 68, 0),   QE(0x2fe8, 83, 69, 0),
    QE(0x293c, 84, 70, 0),   QE(0x2379, 86, 71, 0),   QE(0x1edf, 87, 72, 0),
    QE(0x1aa9, 87, 73, 0),   QE(0x174e, 72, 74, 0),   QE(0x1424, 72, 75, 0),
    QE(0x119c, 74, 76, 0),   QE(0x0f6b, 74, 77, 0),   QE(0x0d51, 75, 78, 0),
    QE(0x0bb6, 77, 79, 0),   QE(0x0a40, 77, 48, 0),   QE(0x5832, 80, 81, 1),
    QE(0x4d1c, 88, 82, 0),   QE(0x438e, 89, 83, 0),   QE(0x3bdd, 90, 84, 0),
    QE(0x34ee, 91, 85, 0),   QE(0x2eae, 92, 86, 0),   QE(0x299a, 93, 87, 0),
    QE(0x2516, 86, 71, 0),   QE(0x5570, 88, 89, 1),   QE(0x4ca9, 95, 90, 0),
    QE(0x44d9, 96, 91, 0),   QE(0x3e22, 97, 92, 0),   QE(0x3824, 99, 93, 0),
    QE(0x32b4, 99, 94, 0),   QE(0x2e17, 93, 86, 0),   QE(0x56a8, 95, 96, 1),
    QE(0x4f46, 101, 97, 0),  QE(0x47e5, 102, 98, 0),  QE(0x41cf, 103, 99, 0),
    QE(0x3c3d, 104, 100, 0), QE(0x375e, 99, 93, 0),   QE(0x5231, 105, 102, 0),
    QE(0x4c0f, 106, 103, 0), QE(0x4639, 107, 104, 0), QE(0x415e, 103, 99, 0),
    QE(0x5627, 105, 106, 1), QE(0x50e7, 108, 107, 0), QE(0x4b85, 109, 103, 0),
    QE(0x5597, 110, 109, 0), QE(0x504f, 111, 107, 0), QE(0x5a10, 110, 111, 1),
    QE(0x5522, 112, 109, 0), QE(0x59eb, 112, 111, 1), QE(0x5a1d, 113, 113, 0)};
#undef QE

const int kSavedCoefs = 10;  // zigzag 0-9: what block smoothing estimates

// what a scan codes: all of each block (sequential), or one stage of a
// progression
enum { SEQ, DC_FIRST, DC_REFINE, AC_FIRST, AC_REFINE };

struct Decoder {
  const uint8_t* data;
  long n;
  long pos = 0;
  bool frame = false, progressive = false, arith = false, lossless = false;
  int precision = 8;
  int height = 0, width = 0, ncomp = 0, hmax = 1, vmax = 1;
  int mcu_rows = 0, mcu_cols = 0;
  Component comp[4];
  bool quant_defined[4] = {};
  uint16_t quant[4][64];
  HuffSpec dc_spec[4], ac_spec[4];
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = 0;
  int16_t* out = nullptr;
  // DAC conditioning (defaults reset by SOI, jdmarker.c get_soi)
  uint8_t dc_L[16], dc_U[16], ac_K[16];

  // progression status (jdphuff.c / jdarith.c coef_bits): the Al each
  // zigzag coefficient of each component was last sent with, -1 for
  // never; `prev_bits` the same before the latest scan that touched it
  int coef_bits[4][64], prev_bits[4][64];
  int scans = 0;           // input_scan_number
  int last_good_row = 0;   // last iMCU row a scan decoded with data left

  // Huffman decoder state (jdhuff.c's bitread_perm_state + marker)
  uint64_t buf = 0;
  int bits = 0;
  int marker = 0;          // marker met inside entropy data, 0 if none
  bool insufficient = false;
  int next_restart = 0;
  int last_dc[4];
  unsigned eobrun = 0;

  // arithmetic decoder state (jdarith.c): C, A, CT, the statistics bins
  int64_t ar_c = 0, ar_a = 0;
  int ar_ct = 0;
  int dc_context[4];
  uint8_t dc_stats[16][64], ac_stats[16][256];
  uint8_t fixed_bin = 113;

  // lossless frames (jddiffct.c, jdlossls.c): each component's samples
  // over its own (downsampled) grid, as the scaler writes them, and
  // whether its next row restarts prediction (predict_undifference is
  // jpeg_undifference_first_row)
  std::vector<uint8_t> samples[4];
  int lhmax = 1, lvmax = 1;
  bool first_row[4] = {};
  bool scanned[4] = {};
  // a first scan that holds every component is the whole frame: libjpeg
  // then decodes in one pass, emitting rows as the scan goes, and cv2
  // keeps them whatever comes after (a later scan, a bad marker)
  bool one_pass = false;

  Decoder() {
    for (int i = 0; i < 16; i++) {
      dc_L[i] = 0;
      dc_U[i] = 1;
      ac_K[i] = 5;
    }
    for (int c = 0; c < 4; c++)
      for (int k = 0; k < 64; k++) coef_bits[c][k] = prev_bits[c][k] = -1;
  }

  // a marker segment's next byte; past the end of the data, once a scan
  // has begun, the bytes of the EOI marker libjpeg's source inserts
  // each time it runs dry (FF D9 FF D9 ...): a segment cut short then
  // reads on, as there
  int byte() {
    if (pos < n) return data[pos++];
    if (!scans) fail("truncated before the image data");
    return (pos++ - n) % 2 ? kEOI : 0xFF;
  }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  // jdmarker.c next_marker: skip to 0xFF, skip fill bytes, return the
  // code; the end of the data reads as EOI
  int next_marker() {
    for (;;) {
      while (pos < n && data[pos] != 0xFF) pos++;
      while (pos < n && data[pos] == 0xFF) pos++;
      if (pos >= n) return kEOI;
      int c = data[pos++];
      if (c != 0) return c;
    }
  }

  // the next data byte of an entropy-coded segment: 0xFF 0x00 reads as
  // 0xFF; a marker (or the end of the data, as EOI) is kept in `marker`
  // and reads as -1
  int data_byte() {
    if (pos >= n) {
      marker = kEOI;
      return -1;
    }
    int c = data[pos++];
    if (c != 0xFF) return c;
    do {
      if (pos >= n) {
        marker = kEOI;
        return -1;
      }
      c = data[pos++];
    } while (c == 0xFF);
    if (c == 0) return 0xFF;
    marker = c;
    return -1;
  }

  // -- Huffman-coded data -------------------------------------------------

  // jpeg_fill_bit_buffer: load bytes up to a marker; if `need` bits are
  // still missing the data has ended: pad with zeros and say so
  void fill(int need) {
    while (!marker && bits <= 56) {
      int c = data_byte();
      if (c < 0) break;
      buf = (buf << 8) | (uint64_t)c;
      bits += 8;
    }
    if (need > bits) {
      insufficient = true;
      buf <<= 57 - bits;
      bits = 57;
    }
  }

  int get_bits(int s) {
    if (bits < s) fill(s);
    bits -= s;
    return (int)((buf >> bits) & ((1u << s) - 1));
  }

  int decode(const HuffTable& t) {
    int l, code;
    if (bits < kLookahead) fill(0);
    if (bits >= kLookahead) {
      int e = t.look[(buf >> (bits - kLookahead)) & ((1 << kLookahead) - 1)];
      l = e >> 8;
      if (l <= kLookahead) {
        bits -= l;
        return e & 0xFF;
      }
      code = get_bits(l);
    } else {
      l = 1;
      code = get_bits(1);
    }
    while (code > t.maxcode[l]) {
      code = (code << 1) | get_bits(1);
      l++;
    }
    if (l > 16) return 0;
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }

  static int extend(int r, int s) {
    return r < (1 << (s - 1)) ? r + (int)((~0u) << s) + 1 : r;
  }

  // a sequential block (jdhuff.c decode_mcu)
  void decode_block(int16_t* blk, int& dc, const HuffTable& dct,
                    const HuffTable& act) {
    int s = decode(dct);
    if (s) s = extend(get_bits(s), s);
    dc = (int)((uint32_t)dc + (uint32_t)s);
    blk[0] = (int16_t)dc;
    for (int k = 1; k < 64; k++) {
      s = decode(act);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = (int16_t)extend(get_bits(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // jdphuff.c decode_mcu_DC_first, one block
  void dc_first(int16_t* blk, int& dc, const HuffTable& t, int al) {
    int s = decode(t);
    if (s) s = extend(get_bits(s), s);
    if ((dc >= 0 && s > INT32_MAX - dc) || (dc < 0 && s < INT32_MIN - dc))
      fail("a DC coefficient out of range");
    dc += s;
    blk[0] = (int16_t)((unsigned)dc << al);
  }

  // jdphuff.c decode_mcu_AC_first
  void ac_first(int16_t* blk, const HuffTable& t, int ss, int se, int al) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    for (int k = ss; k <= se; k++) {
      int s = decode(t), r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        s = extend(get_bits(s), s);
        blk[kNatural[k]] = (int16_t)((unsigned)s << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1u << r;
        if (r) eobrun += get_bits(r);
        eobrun--;
        break;
      }
    }
  }

  // a correction bit for an already nonzero coefficient
  void refine(int16_t* coef, int p1, int m1) {
    if (get_bits(1) && (*coef & p1) == 0)
      *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
  }

  // jdphuff.c decode_mcu_AC_refine
  void ac_refine(int16_t* blk, const HuffTable& t, int ss, int se, int al) {
    int p1 = 1 << al, m1 = (int)(~0u << al);
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; k++) {
        int s = decode(t), r = s >> 4;
        s &= 15;
        if (s) {
          s = get_bits(1) ? p1 : m1;  // a size other than 1: a warning
        } else if (r != 15) {
          eobrun = 1u << r;
          if (r) eobrun += get_bits(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef) {
            refine(coef, p1, m1);
          } else if (--r < 0) {
            break;
          }
          k++;
        } while (k <= se);
        if (s) blk[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++)
        if (blk[kNatural[k]]) refine(blk + kNatural[k], p1, m1);
      eobrun--;
    }
  }

  // -- arithmetic-coded data (jdarith.c) ----------------------------------

  // arith_decode: renormalise, then one binary decision with the
  // adaptive estimate in *st; a marker (or the end of the data) supplies
  // zero bytes from there on
  int arith_decode(uint8_t* st) {
    while (ar_a < 0x8000) {
      if (--ar_ct < 0) {
        int c = marker ? -1 : data_byte();
        ar_c = (ar_c << 8) | (c < 0 ? 0 : c);
        if ((ar_ct += 8) < 0 && ++ar_ct == 0) ar_a = 0x8000;
      }
      ar_a <<= 1;
    }
    int sv = *st;
    uint32_t e = kQe[sv & 0x7F];
    int nl = e & 0xFF, nm = (e >> 8) & 0xFF;
    int64_t qe = e >> 16;
    int64_t temp = ar_a - qe;
    ar_a = temp;
    temp <<= ar_ct;
    if (ar_c >= temp) {
      ar_c -= temp;
      if (ar_a < qe) {
        ar_a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        ar_a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (ar_a < 0x8000) {
      if (ar_a < qe) {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  // Figure F.19 and F.1.4.4.1: a DC difference with its conditioning;
  // false on a magnitude overflow
  bool arith_dc(int i, int tbl, int& diff) {
    uint8_t* st = dc_stats[tbl] + dc_context[i];
    diff = 0;
    if (arith_decode(st) == 0) {
      dc_context[i] = 0;
      return true;
    }
    int sign = arith_decode(st + 1);
    st += 2 + sign;
    int m = arith_decode(st);
    if (m) {
      st = dc_stats[tbl] + 20;  // X1
      while (arith_decode(st)) {
        if ((m <<= 1) == 0x8000) {
          ar_ct = -1;
          return false;
        }
        st++;
      }
    }
    if (m < (int)((1L << dc_L[tbl]) >> 1))
      dc_context[i] = 0;
    else if (m > (int)((1L << dc_U[tbl]) >> 1))
      dc_context[i] = 12 + sign * 4;
    else
      dc_context[i] = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (arith_decode(st)) v |= m;
    v += 1;
    diff = sign ? -v : v;
    return true;
  }

  // Figure F.20 from coefficient `k` on: true and k, v of the next
  // nonzero coefficient; false at the end of block or (with ct = -1) on
  // a spectral or magnitude overflow
  bool arith_ac(int tbl, int& k, int se, int& v) {
    uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
    if (arith_decode(st)) return false;  // EOB
    while (arith_decode(st + 1) == 0) {
      st += 3;
      if (++k > se) {
        ar_ct = -1;
        return false;
      }
    }
    int sign = arith_decode(&fixed_bin);
    st += 2;
    int m = arith_decode(st);
    if (m && arith_decode(st)) {
      m <<= 1;
      st = ac_stats[tbl] + (k <= ac_K[tbl] ? 189 : 217);
      while (arith_decode(st)) {
        if ((m <<= 1) == 0x8000) {
          ar_ct = -1;
          return false;
        }
        st++;
      }
    }
    v = m;
    st += 14;
    while (m >>= 1)
      if (arith_decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    return true;
  }

  // jdarith.c decode_mcu_AC_refine, one block
  void arith_ac_refine(int16_t* blk, int tbl, int ss, int se, int al) {
    int p1 = 1 << al, m1 = (int)(~0u << al);
    int kex = se;
    for (; kex > 0; kex--)
      if (blk[kNatural[kex]]) break;
    for (int k = ss; k <= se; k++) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (k > kex && arith_decode(st)) break;  // EOB
      for (;;) {
        int16_t* coef = blk + kNatural[k];
        if (*coef) {
          if (arith_decode(st + 2))
            *coef = (int16_t)(*coef + (*coef < 0 ? m1 : p1));
          break;
        }
        if (arith_decode(st + 1)) {
          *coef = (int16_t)(arith_decode(&fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) {
          ar_ct = -1;
          return;
        }
      }
    }
  }

  // -- scans --------------------------------------------------------------

  // process_restart + read_restart_marker + jpeg_resync_to_restart
  void restart() {
    bits = 0;
    if (!marker) marker = next_marker();
    if (marker == 0xD0 + next_restart) {
      marker = 0;
    } else {
      for (;;) {
        int action;
        if (marker < 0xC0) {
          action = 2;
        } else if (marker < 0xD0 || marker > 0xD7) {
          action = 3;
        } else if (marker == 0xD0 + ((next_restart + 1) & 7) ||
                   marker == 0xD0 + ((next_restart + 2) & 7)) {
          action = 3;
        } else if (marker == 0xD0 + ((next_restart - 1) & 7) ||
                   marker == 0xD0 + ((next_restart - 2) & 7)) {
          action = 2;
        } else {
          action = 1;
        }
        if (action == 1) {
          marker = 0;
          break;
        }
        if (action == 3) break;
        marker = next_marker();
      }
    }
    next_restart = (next_restart + 1) & 7;
    if (!marker) insufficient = false;
  }

  // a scan's table: the one defined, or for a sequential stream without
  // tables (motion JPEG) the standard one, as jpeg_std_huff_table gives
  // it (jdhuff.c installs them; jdphuff.c does not)
  HuffSpec table(bool ac, int t) {
    if (t > 3) fail("bad Huffman table index");
    const HuffSpec& s = (ac ? ac_spec : dc_spec)[t];
    if (s.defined) return s;
    if (t > 1 || progressive || lossless)
      fail("scan uses an undefined Huffman table");
    return standard_table(ac, t);
  }

  // jdphuff.c / jdarith.c start_pass: the progression's checks (errors
  // where libjpeg errs; its warnings change nothing) and coef_bits
  void progression(Component** sc, int ns, int ss, int se, int ah, int al) {
    bool bad = false;
    if (ss == 0) {
      if (se != 0) bad = true;
    } else {
      if (se < ss || se > 63) bad = true;
      if (ns != 1) bad = true;
    }
    if (ah != 0 && al != ah - 1) bad = true;
    if (al > 13) bad = true;
    if (bad) {
      char msg[96];
      snprintf(msg, sizeof(msg), "invalid progressive parameters Ss=%d "
               "Se=%d Ah=%d Al=%d", ss, se, ah, al);
      fail(msg);
    }
    for (int i = 0; i < ns; i++) {
      int c = (int)(sc[i] - comp);
      for (int k = ss < 1 ? ss : 1; k <= (se > 9 ? se : 9); k++)
        prev_bits[c][k] = scans > 1 ? coef_bits[c][k] : 0;
      for (int k = ss; k <= se; k++) coef_bits[c][k] = al;
    }
  }

  void scan() {
    if (!frame) fail("scan before the frame header");
    int len = word();
    int ns = byte();
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns) fail("bad scan header");
    Component* sc[4];
    int td[4], ta[4];
    for (int i = 0; i < ns; i++) {
      int id = byte(), t = byte();
      sc[i] = nullptr;
      for (int c = 0; c < ncomp; c++)
        if (comp[c].id == id) sc[i] = &comp[c];
      if (!sc[i]) fail("scan names an unknown component");
      td[i] = t >> 4;
      ta[i] = t & 15;
    }
    int ss = byte(), se = byte(), a = byte();
    int ah = a >> 4, al = a & 15;
    scans++;
    if (lossless) {
      lossless_scan(sc, ns, td, ss, se, ah, al);
      return;
    }
    for (int i = 0; i < ns; i++) {
      Component& c = *sc[i];
      if (!c.latched) {
        if (!quant_defined[c.tq]) fail("a component's quantisation table "
                                       "is not defined");
        for (int k = 0; k < 64; k++) {
          c.quant[k] = (int16_t)quant[c.tq][k];
          c.qval[k] = quant[c.tq][k];
        }
        c.latched = true;
      }
    }
    // the scan's kind; sequential scans decode all 64 coefficients
    // whatever Ss, Se, Ah/Al say, as libjpeg does (with a warning)
    int kind = SEQ;
    if (progressive) {
      progression(sc, ns, ss, se, ah, al);
      kind = ss == 0 ? (ah ? DC_REFINE : DC_FIRST)
                     : (ah ? AC_REFINE : AC_FIRST);
    }
    bool dc_stage = kind == SEQ || kind == DC_FIRST;
    bool ac_stage = kind == SEQ || kind == AC_FIRST || kind == AC_REFINE;
    HuffTable dct[4], act[4];
    for (int i = 0; i < ns; i++) {
      if (arith) {
        if (dc_stage) {
          memset(dc_stats[td[i]], 0, 64);
          dc_context[i] = 0;
        }
        if (ac_stage) memset(ac_stats[ta[i]], 0, 256);
      } else {
        if (dc_stage) dct[i].build(table(false, td[i]), 15);
        if (ac_stage) act[i].build(table(true, ta[i]), -1);
      }
    }
    // MCU geometry
    int per_row, rows, row_mcus;  // MCU rows an iMCU row
    if (ns == 1) {
      per_row = sc[0]->wblocks;
      rows = sc[0]->hblocks;
      row_mcus = ncomp == 1 ? 1 : sc[0]->v;
    } else {
      per_row = mcu_cols;
      rows = mcu_rows;
      row_mcus = 1;
    }
    buf = 0;
    bits = 0;
    marker = 0;
    insufficient = false;
    next_restart = 0;
    eobrun = 0;
    ar_c = ar_a = 0;
    ar_ct = -16;
    for (int i = 0; i < 4; i++) last_dc[i] = 0;
    int to_go = restart_interval;
    for (int mr = 0; mr < rows; mr++) {
      for (int mc = 0; mc < per_row; mc++) {
        if (restart_interval) {
          if (to_go == 0) {
            restart();
            for (int i = 0; i < ns; i++) {
              last_dc[i] = 0;
              if (arith && dc_stage) {
                memset(dc_stats[td[i]], 0, 64);
                dc_context[i] = 0;
              }
              if (arith && ac_stage) memset(ac_stats[ta[i]], 0, 256);
            }
            eobrun = 0;
            ar_c = ar_a = 0;
            ar_ct = -16;
            to_go = restart_interval;
          }
          to_go--;
        }
        if (!insufficient) last_good_row = mr / row_mcus;
        mcu(sc, ns, mr, mc, kind, dct, act, td, ta, ss, se, al);
      }
    }
  }

  // one MCU of a scan
  void mcu(Component** sc, int ns, int mr, int mc, int kind,
           const HuffTable* dct, const HuffTable* act, const int* td,
           const int* ta, int ss, int se, int al) {
    // Huffman: the MCU in which the data ran out decodes from zero bits,
    // later ones are skipped (a DC refinement reads the zeros instead);
    // arithmetic: nothing after an overflow (ct = -1) until a restart
    bool skip = kind != DC_REFINE && (arith ? ar_ct == -1 : insufficient);
    int p1 = 1 << al;
    for (int i = 0; i < ns; i++) {
      Component& c = *sc[i];
      int bh = ns == 1 ? 1 : c.v, bw = ns == 1 ? 1 : c.h;
      for (int y = 0; y < bh; y++) {
        for (int x = 0; x < bw; x++) {
          int br = mr * bh + y, bc = mc * bw + x;
          int16_t* blk = out + c.offset + ((long)br * c.cols + bc) * 64;
          if (kind == SEQ) memset(blk, 0, 64 * sizeof(int16_t));
          if (skip) continue;
          switch (kind) {
            case SEQ:
              if (!arith) {
                decode_block(blk, last_dc[i], dct[i], act[i]);
                break;
              }
              {
                int diff, k = 1, v;
                if (!arith_dc(i, td[i], diff)) {
                  skip = true;
                  break;
                }
                last_dc[i] = (last_dc[i] + diff) & 0xffff;
                blk[0] = (int16_t)last_dc[i];
                for (; k <= 63; k++) {
                  if (!arith_ac(ta[i], k, 63, v)) break;
                  blk[kNatural[k]] = (int16_t)v;
                }
                if (ar_ct == -1) skip = true;
              }
              break;
            case DC_FIRST:
              if (!arith) {
                dc_first(blk, last_dc[i], dct[i], al);
              } else {
                int diff;
                if (!arith_dc(i, td[i], diff)) {
                  skip = true;
                  break;
                }
                last_dc[i] = (last_dc[i] + diff) & 0xffff;
                blk[0] = (int16_t)((unsigned)last_dc[i] << al);
              }
              break;
            case DC_REFINE:
              if (arith ? arith_decode(&fixed_bin) : get_bits(1))
                blk[0] = (int16_t)(blk[0] | p1);
              break;
            case AC_FIRST:
              if (!arith) {
                ac_first(blk, act[i], ss, se, al);
              } else {
                int v;
                for (int k = ss; k <= se; k++) {
                  if (!arith_ac(ta[i], k, se, v)) break;
                  blk[kNatural[k]] = (int16_t)((unsigned)v << al);
                }
              }
              break;
            case AC_REFINE:
              if (!arith)
                ac_refine(blk, act[i], ss, se, al);
              else
                arith_ac_refine(blk, ta[i], ss, se, al);
              break;
          }
        }
      }
    }
  }

  // -- lossless scans (libjpeg-turbo 3: jdlhuff.c, jddiffct.c, jdlossls.c)

  // one Huffman-coded difference (jdlhuff.c decode_mcus): category 16
  // carries no extra bits and means 32768
  int difference(const HuffTable& t) {
    int s = decode(t);
    if (s == 16) return 32768;
    return s ? extend(get_bits(s), s) : 0;
  }

  // A lossless scan, as libjpeg-turbo 3 decodes it: an MCU row's
  // differences at a time (the restart check before it: an interval must
  // hold whole MCU rows; a row begun after the data ran out reads as zero
  // differences and restarts prediction), then, an iMCU row at a time,
  // each component's rows undifferenced (ITU T.81 H.1.2.1: a row that
  // restarts prediction starts from 2^(P - Pt - 1) and predicts from the
  // left; other rows' first sample from above, the rest by predictor Ss;
  // sums modulo 2^16) and scaled (<< Pt, kept to 8 bits). A restart
  // marks every component's next undifferenced row, so one that comes
  // inside an iMCU row of a component with v > 1 restarts that iMCU
  // row's first row, as there.
  void lossless_scan(Component** sc, int ns, const int* td, int ss, int se,
                     int ah, int al) {
    if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= precision) {
      char msg[96];
      snprintf(msg, sizeof(msg), "invalid lossless scan parameters Ss=%d "
               "Se=%d Ah=%d Al=%d", ss, se, ah, al);
      fail(msg);
    }
    HuffTable tab[4];
    int ci[4];
    for (int i = 0; i < ns; i++) {
      tab[i].build(table(false, td[i]), 16);
      ci[i] = (int)(sc[i] - comp);
      scanned[ci[i]] = true;
    }
    one_pass = scans == 1 && ns == ncomp;
    // MCU geometry: an interleaved MCU holds h x v samples of each
    // component; a one-component scan one sample, v MCU rows an iMCU row
    int per_row, imcu_rows = (height + lvmax - 1) / lvmax;
    int span[4];  // a row of differences, dummy samples included
    for (int i = 0; i < ns; i++) {
      const Component& k = comp[ci[i]];
      span[i] = ns > 1 ? (width + lhmax - 1) / lhmax * k.fh : k.wblocks;
    }
    per_row = ns > 1 ? (width + lhmax - 1) / lhmax : span[0];
    if (restart_interval % per_row) {
      char msg[96];
      snprintf(msg, sizeof(msg), "restart interval %d is not a whole "
               "number of MCU rows of %d MCUs", restart_interval, per_row);
      fail(msg);
    }
    std::vector<int> diff[4], prev[4], cur;
    for (int i = 0; i < ns; i++) {
      diff[i].assign((size_t)comp[ci[i]].fv * span[i], 0);
      prev[i].assign(comp[ci[i]].wblocks, 0);
    }
    for (int c = 0; c < ncomp; c++) first_row[c] = true;
    buf = 0;
    bits = 0;
    marker = 0;
    insufficient = false;
    next_restart = 0;
    int rows_to_go = restart_interval / per_row;
    const int initial = 1 << (precision - al - 1);
    for (int im = 0; im < imcu_rows; im++) {
      bool last = im == imcu_rows - 1;
      int rows_now = 1;  // MCU rows in this iMCU row
      if (ns == 1) {
        const Component& k = comp[ci[0]];
        rows_now = last ? k.hblocks - (imcu_rows - 1) * k.fv : k.fv;
      }
      for (int y = 0; y < rows_now; y++) {
        if (restart_interval) {
          if (rows_to_go == 0) {
            restart();
            for (int c = 0; c < ncomp; c++) first_row[c] = true;
            rows_to_go = restart_interval / per_row;
          }
          rows_to_go--;
        }
        if (insufficient) {
          for (int i = 0; i < ns; i++) {
            int rows = ns > 1 ? comp[ci[i]].fv : 1;
            int* d = diff[i].data() + (size_t)(ns > 1 ? 0 : y) * span[i];
            memset(d, 0, sizeof(int) * rows * span[i]);
          }
          for (int c = 0; c < ncomp; c++) first_row[c] = true;
          continue;
        }
        for (int mc = 0; mc < per_row; mc++) {
          for (int i = 0; i < ns; i++) {
            if (ns == 1) {
              diff[0][(size_t)y * span[0] + mc] = difference(tab[0]);
              continue;
            }
            const Component& k = comp[ci[i]];
            for (int yy = 0; yy < k.fv; yy++)
              for (int xx = 0; xx < k.fh; xx++)
                diff[i][(size_t)yy * span[i] + mc * k.fh + xx] =
                    difference(tab[i]);
          }
        }
      }
      for (int i = 0; i < ns; i++) {
        int c = ci[i];
        const Component& k = comp[c];
        int w = k.wblocks;
        int rows = last ? k.hblocks - (imcu_rows - 1) * k.fv : k.fv;
        cur.resize(w);
        for (int r = 0; r < rows; r++) {
          const int* d = diff[i].data() + (size_t)r * span[i];
          int ra, rb, rc;
          if (first_row[c]) {
            ra = (d[0] + initial) & 0xFFFF;
            cur[0] = ra;
            for (int x = 1; x < w; x++) cur[x] = ra = (d[x] + ra) & 0xFFFF;
            first_row[c] = false;
          } else {
            rb = prev[i][0];
            ra = (d[0] + rb) & 0xFFFF;
            cur[0] = ra;
            for (int x = 1; x < w; x++) {
              rc = rb;
              rb = prev[i][x];
              int p;
              switch (ss) {
                case 1: p = ra; break;
                case 2: p = rb; break;
                case 3: p = rc; break;
                case 4: p = ra + rb - rc; break;
                case 5: p = ra + ((rb - rc) >> 1); break;
                case 6: p = rb + ((ra - rc) >> 1); break;
                default: p = (ra + rb) >> 1; break;
              }
              cur[x] = ra = (d[x] + p) & 0xFFFF;
            }
          }
          uint8_t* out8 = samples[c].data() + (size_t)(im * k.fv + r) * w;
          for (int x = 0; x < w; x++) out8[x] = (uint8_t)(cur[x] << al);
          prev[i].swap(cur);
        }
      }
    }
  }

  // -- block smoothing (jdcoefct.c, libjpeg-turbo 2.1) --------------------

  // smoothing_ok: a progressive frame whose every component has had DC
  // data and nonzero quantisation values at zigzag 0-9, and some
  // component's coefficients 1-9 are still imprecise; `latch` gets each
  // component's coef_bits 0-9, then the same before the latest scan
  bool smoothing_ok(int (*latch)[2][kSavedCoefs]) const {
    if (!progressive) return false;
    bool useful = false;
    for (int c = 0; c < ncomp; c++) {
      if (!comp[c].latched) return false;
      for (int k = 0; k < kSavedCoefs; k++)
        if (comp[c].qval[kNatural[k]] == 0) return false;
      if (coef_bits[c][0] < 0) return false;
      for (int k = 0; k < kSavedCoefs; k++) {
        latch[c][0][k] = coef_bits[c][k];
        latch[c][1][k] = scans > 1 ? prev_bits[c][k] : -1;
        if (k && coef_bits[c][k] != 0) useful = true;
      }
    }
    return useful;
  }

  // decompress_smooth_data over one component: each block of the image
  // whose coefficients 1-9 are zero and not known exactly gets estimates
  // from the DC values of its 5x5 neighbourhood (the DC itself too, while
  // no AC data has come); iMCU rows after the last one the latest scan
  // decoded with data use the coef_bits from before that scan
  void smooth(int c, const int (*latch)[kSavedCoefs], int imcu_rows) {
    const Component& k = comp[c];
    int v = ncomp == 1 ? 1 : k.v;
    int16_t* base = out + k.offset;
    // the DC values, as the blocks hold them before any estimate
    long nblk = (long)k.rows * k.cols;
    int16_t* dcs = new int16_t[nblk];
    for (long b = 0; b < nblk; b++) dcs[b] = base[b * 64];
    auto dc = [&](int r, int col) { return (int)dcs[(long)r * k.cols + col]; };
    const int64_t q00 = k.qval[0], q01 = k.qval[1], q10 = k.qval[8],
                  q20 = k.qval[16], q11 = k.qval[9], q02 = k.qval[2],
                  q03 = k.qval[3], q12 = k.qval[10], q21 = k.qval[17],
                  q30 = k.qval[24];
    int last_row = imcu_rows - 1, last_col = k.wblocks - 1;
    for (int row = 0; row < imcu_rows; row++) {
      const int* bits = latch[row > last_good_row ? 1 : 0];
      bool change_dc = true;
      for (int i = 1; i < kSavedCoefs; i++)
        if (bits[i] != -1) change_dc = false;
      int block_rows = v;
      if (row == last_row) {
        block_rows = k.hblocks % v;
        if (block_rows == 0) block_rows = v;
      }
      for (int br = 0; br < block_rows; br++) {
        int r = row * v + br;
        int prev = br > 0 || row > 0 ? r - 1 : r;
        int prev2 = br > 1 || row > 1 ? r - 2 : prev;
        int next = br < block_rows - 1 || row < last_row ? r + 1 : r;
        int next2 = br < block_rows - 2 || row + 1 < last_row ? r + 2 : next;
        const int rr[5] = {prev2, prev, r, next, next2};
        int d[5][5];  // DC01-DC25 of jdcoefct.c, row by row
        for (int i = 0; i < 5; i++)
          for (int j = 0; j < 5; j++) d[i][j] = dc(rr[i], 0);
        for (int col = 0; col <= last_col; col++) {
          if (col == 0 && col < last_col)
            for (int i = 0; i < 5; i++) d[i][3] = dc(rr[i], 1);
          if (col + 1 < last_col)
            for (int i = 0; i < 5; i++) d[i][4] = dc(rr[i], col + 2);
          int16_t* w = base + ((long)r * k.cols + col) * 64;
#define DC(i) d[((i) - 1) / 5][((i) - 1) % 5]
          auto estimate = [&](int zz, int pos, int64_t q, int64_t sum) {
            int al = bits[zz];
            if (al == 0 || w[pos] != 0) return;
            int64_t num = q00 * sum;
            int pred;
            if (num >= 0) {
              pred = (int)(((q << 7) + num) / (q << 8));
              if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
            } else {
              pred = (int)(((q << 7) - num) / (q << 8));
              if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
              pred = -pred;
            }
            w[pos] = (int16_t)pred;
          };
          estimate(1, 1, q01, change_dc ?
              -DC(1) - DC(2) + DC(4) + DC(5) - 3 * DC(6) + 13 * DC(7) -
              13 * DC(9) + 3 * DC(10) - 3 * DC(11) + 38 * DC(12) -
              38 * DC(14) + 3 * DC(15) - 3 * DC(16) + 13 * DC(17) -
              13 * DC(19) + 3 * DC(20) - DC(21) - DC(22) + DC(24) + DC(25) :
              -7 * DC(11) + 50 * DC(12) - 50 * DC(14) + 7 * DC(15));
          estimate(2, 8, q10, change_dc ?
              -DC(1) - 3 * DC(2) - 3 * DC(3) - 3 * DC(4) - DC(5) - DC(6) +
              13 * DC(7) + 38 * DC(8) + 13 * DC(9) - DC(10) + DC(16) -
              13 * DC(17) - 38 * DC(18) - 13 * DC(19) + DC(20) + DC(21) +
              3 * DC(22) + 3 * DC(23) + 3 * DC(24) + DC(25) :
              -7 * DC(3) + 50 * DC(8) - 50 * DC(18) + 7 * DC(23));
          estimate(3, 16, q20, change_dc ?
              DC(3) + 2 * DC(7) + 7 * DC(8) + 2 * DC(9) - 5 * DC(12) -
              14 * DC(13) - 5 * DC(14) + 2 * DC(17) + 7 * DC(18) +
              2 * DC(19) + DC(23) :
              -DC(3) + 13 * DC(8) - 24 * DC(13) + 13 * DC(18) - DC(23));
          estimate(4, 9, q11, change_dc ?
              -DC(1) + DC(5) + 9 * DC(7) - 9 * DC(9) - 9 * DC(17) +
              9 * DC(19) + DC(21) - DC(25) :
              DC(10) + DC(16) - 10 * DC(17) + 10 * DC(19) - DC(2) - DC(20) +
              DC(22) - DC(24) + DC(4) - DC(6) + 10 * DC(7) - 10 * DC(9));
          estimate(5, 2, q02, change_dc ?
              2 * DC(7) - 5 * DC(8) + 2 * DC(9) + DC(11) + 7 * DC(12) -
              14 * DC(13) + 7 * DC(14) + DC(15) + 2 * DC(17) - 5 * DC(18) +
              2 * DC(19) :
              -DC(11) + 13 * DC(12) - 24 * DC(13) + 13 * DC(14) - DC(15));
          if (change_dc) {
            estimate(6, 3, q03, DC(7) - DC(9) + 2 * DC(12) - 2 * DC(14) +
                                    DC(17) - DC(19));
            estimate(7, 10, q12, DC(7) - 3 * DC(8) + DC(9) - DC(17) +
                                     3 * DC(18) - DC(19));
            estimate(8, 17, q21, DC(7) - DC(9) - 3 * DC(12) + 3 * DC(14) +
                                     DC(17) - DC(19));
            estimate(9, 24, q30, DC(7) + 2 * DC(8) + DC(9) - DC(17) -
                                     2 * DC(18) - DC(19));
            int64_t num = q00 * (
                -2 * DC(1) - 6 * DC(2) - 8 * DC(3) - 6 * DC(4) - 2 * DC(5) -
                6 * DC(6) + 6 * DC(7) + 42 * DC(8) + 6 * DC(9) - 6 * DC(10) -
                8 * DC(11) + 42 * DC(12) + 152 * DC(13) + 42 * DC(14) -
                8 * DC(15) - 6 * DC(16) + 6 * DC(17) + 42 * DC(18) +
                6 * DC(19) - 6 * DC(20) - 2 * DC(21) - 6 * DC(22) -
                8 * DC(23) - 6 * DC(24) - 2 * DC(25));
            int pred = num >= 0 ? (int)(((q00 << 7) + num) / (q00 << 8))
                                : -(int)(((q00 << 7) - num) / (q00 << 8));
            w[0] = (int16_t)pred;
          }
#undef DC
          for (int i = 0; i < 5; i++)
            for (int j = 0; j < 4; j++) d[i][j] = d[i][j + 1];
        }
      }
    }
    delete[] dcs;
  }

  void smooth_all() {
    int latch[4][2][kSavedCoefs];
    if (!smoothing_ok(latch)) return;
    int imcu_rows = ncomp == 1 ? (height + 7) / 8 : mcu_rows;
    for (int c = 0; c < ncomp; c++) smooth(c, latch[c], imcu_rows);
  }

  // -- marker segments ----------------------------------------------------

  void sof(int code) {
    switch (code) {
      case 0xC5: case 0xC6: case 0xC7:
        fail("hierarchical (differential) JPEG is not supported");
      case 0xCB: fail("arithmetic-coded lossless JPEG is not supported");
      case 0xCD: case 0xCE: case 0xCF:
        fail("arithmetic-coded hierarchical JPEG is not supported");
    }
    if (frame) fail("a second frame header");
    progressive = code == 0xC2 || code == 0xCA;
    arith = code == 0xC9 || code == 0xCA;
    lossless = code == 0xC3;
    int len = word();
    precision = byte();
    height = word();
    width = word();
    ncomp = byte();
    // a lossless frame reads at 2-8 bits, as libjpeg-turbo 3's 8-bit
    // interface (cv2's) reads it
    if (precision == 12) fail("12-bit precision is not supported");
    if (lossless ? precision < 2 || precision > 8 : precision != 8)
      fail("precision " + std::to_string(precision) + " is not supported");
    if (height == 0)
      fail("a height set by a DNL marker is not supported");
    if (width == 0) fail("width 0");
    if (ncomp == 2) fail("2-component JPEG is not supported");
    if (ncomp < 1 || ncomp > 4)
      fail(std::to_string(ncomp) + "-component JPEG is not supported");
    if (len != 8 + 3 * ncomp) fail("bad frame header");
    for (int c = 0; c < ncomp; c++) {
      comp[c].id = byte();
      int hv = byte();
      comp[c].h = comp[c].fh = hv >> 4;
      comp[c].v = comp[c].fv = hv & 15;
      comp[c].tq = byte();
      if (comp[c].h < 1 || comp[c].h > 4 || comp[c].v < 1 || comp[c].v > 4)
        fail("bad sampling factors");
      if (comp[c].tq > 3) fail("bad quantisation table index");
      if (comp[c].h > hmax) hmax = comp[c].h;
      if (comp[c].v > vmax) vmax = comp[c].v;
    }
    lhmax = hmax;
    lvmax = vmax;
    mcu_cols = (width + 8 * hmax - 1) / (8 * hmax);
    mcu_rows = (height + 8 * vmax - 1) / (8 * vmax);
    long offset = 0;
    for (int c = 0; c < ncomp; c++) {
      Component& k = comp[c];
      if (ncomp == 1) {  // one block an MCU, whatever the factors say
        k.h = k.v = hmax = vmax = 1;
        mcu_cols = (width + 7) / 8;
        mcu_rows = (height + 7) / 8;
      }
      k.rows = mcu_rows * k.v;
      k.cols = mcu_cols * k.h;
      long sw = ((long)width * k.h + hmax - 1) / hmax;
      long sh = ((long)height * k.v + vmax - 1) / vmax;
      k.wblocks = (int)((sw + 7) / 8);
      k.hblocks = (int)((sh + 7) / 8);
      k.offset = offset;
      offset += (long)k.rows * k.cols * 64;
    }
    if (lossless) {
      // a sample an MCU row's column per unit of h, libjpeg's
      // downsampled_width / _height over the header's factors; the
      // upsampler repeats samples (no fancy upsampling in lossless mode),
      // integral ratios only
      for (int c = 0; c < ncomp; c++) {
        Component& k = comp[c];
        if (lhmax % k.fh || lvmax % k.fv)
          fail("fractional sampling factors are not supported");
        k.wblocks = (int)(((long)width * k.fh + lhmax - 1) / lhmax);
        k.hblocks = (int)(((long)height * k.fv + lvmax - 1) / lvmax);
        samples[c].assign((size_t)k.wblocks * k.hblocks, 0);
      }
    }
    frame = true;
  }

  // get_dqt: a table cut short by its segment keeps 1 for the rest
  void dqt() {
    long left = word() - 2;
    while (left > 0) {
      int pq = byte(), t = pq & 15, wide = pq >> 4 ? 2 : 1;
      left--;
      if (t > 3) fail("bad quantisation table");
      long count = left < 64 * wide ? left / wide : 64;
      for (int k = 0; k < 64; k++)
        quant[t][kNatural[k]] = 1;
      for (int k = 0; k < count; k++)
        quant[t][kNatural[k]] = (uint16_t)(wide == 2 ? word() : byte());
      left -= count * wide;
      quant_defined[t] = true;
    }
    if (left != 0) fail("bad marker length");
  }

  // get_dht
  void dht() {
    long left = word() - 2;
    while (left > 16) {
      int tc = byte(), ac = tc & 0x10, t = tc - ac;
      HuffSpec spec;
      int count = 0;
      for (int l = 1; l <= 16; l++) count += spec.bits[l] = (uint8_t)byte();
      left -= 17;
      if (count > 256 || count > left) fail("bad Huffman table");
      for (int i = 0; i < count; i++) spec.vals[i] = (uint8_t)byte();
      left -= count;
      if (t > 3) fail("bad Huffman table index");
      spec.defined = true;
      (ac ? ac_spec : dc_spec)[t] = spec;
    }
    if (left != 0) fail("bad marker length");
  }

  void app(int code) {
    long len = word() - 2, start = pos;
    if (len < 0) fail("bad marker length");
    if (code == 0xE0 && len >= 14 && pos + 5 <= n &&
        memcmp(data + pos, "JFIF\0", 5) == 0)
      jfif = true;
    if (code == 0xEE && len >= 12 && pos + 12 <= n &&
        memcmp(data + pos, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = data[pos + 11];
    }
    pos = start + len;
  }

  // get_dac: arithmetic conditioning (L, U of a DC table; K of an AC one)
  void dac() {
    long left = word() - 2;
    while (left > 0) {
      int index = byte(), val = byte();
      left -= 2;
      if (index >= 32) fail("bad DAC table index");
      if (index >= 16) {
        ac_K[index - 16] = (uint8_t)val;
      } else {
        dc_L[index] = (uint8_t)(val & 15);
        dc_U[index] = (uint8_t)(val >> 4);
        if (dc_L[index] > dc_U[index]) fail("bad DAC value");
      }
    }
    if (left != 0) fail("bad marker length");
  }

  void skip() {
    long len = word() - 2;
    if (len < 0) fail("bad marker length");
    pos += len;
  }

  // read marker segments up to the next scan header (true) or the end
  // of the image (false); a marker met inside entropy data is the first
  bool until_scan() {
    for (;;) {
      int m = marker ? marker : next_marker();
      marker = 0;
      if (m == kEOI) return false;
      if (m == 0xDA) return true;
      if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        sof(m);
      } else if (m == 0xC4) {
        dht();
      } else if (m == 0xDB) {
        dqt();
      } else if (m == 0xDD) {
        if (word() != 4) fail("bad marker length");
        restart_interval = word();
      } else if (m >= 0xE0 && m <= 0xEF) {
        app(m);
      } else if (m == 0xCC) {
        dac();
      } else if (m == 0xFE || m == 0xDC) {
        skip();  // COM, DNL
      } else if (m >= 0xD0 && m <= 0xD7) {
        // a stray restart marker outside a scan: ignored, as libjpeg does
      } else if (m == 0xD8) {
        fail("a second start-of-image marker");
      } else {
        char msg[64];
        snprintf(msg, sizeof(msg), "unsupported marker 0xFF%02X", m);
        fail(msg);
      }
    }
  }

  // SOI, then the markers up to the first scan header
  void start() {
    if (n < 2 || data[0] != 0xFF || data[1] != 0xD8)
      fail("not a JPEG (no start-of-image marker)");
    pos = 2;
    if (!until_scan()) fail("truncated before the image data");
    if (!frame) fail("scan before the frame header");
    int cs = colour();
    if (lossless && (cs == 1 || cs == 4))
      fail(std::string("lossless ") + (cs == 1 ? "YCbCr" : "YCCK") +
           " JPEG is not supported (libjpeg converts no colour in "
           "lossless mode)");
  }

  // the point transform of the scan whose header comes next (after
  // start(), the first scan's), read without moving on
  int next_scan_al() {
    long at = pos;
    int len = word(), ns = byte();
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns) fail("bad scan header");
    pos += 2 * ns + 2;
    int al = byte() & 15;
    pos = at;
    return al;
  }

  // jdapimin.c default_decompress_parms: 0 grey, 1 YCbCr, 2 RGB, 3 CMYK,
  // 4 YCCK
  int colour() const {
    if (ncomp == 1) return 0;
    if (ncomp == 4) return adobe && adobe_transform != 0 ? 4 : 3;
    if (jfif) return 1;
    if (adobe) return adobe_transform == 0 ? 2 : 1;
    if (comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B')
      return 2;
    return lossless ? 2 : 1;  // a lossless frame is RGB whatever its ids
  }
};

int report(const char* msg, char* err, int errlen) {
  if (err && errlen > 0) {
    strncpy(err, msg, errlen - 1);
    err[errlen - 1] = 0;
  }
  return 1;
}


// -- the writer's entropy coder ---------------------------------------------

// Huffman code and length of every symbol of a table (Annex C.2)
struct HuffCodes {
  uint16_t code[256] = {};
  uint8_t len[256] = {};

  explicit HuffCodes(const HuffSpec& spec) {
    int p = 0;
    uint32_t code_value = 0;
    for (int l = 1; l <= 16; l++) {
      for (int i = 0; i < spec.bits[l]; i++, p++) {
        code[spec.vals[p]] = (uint16_t)code_value++;
        len[spec.vals[p]] = (uint8_t)l;
      }
      code_value <<= 1;
    }
  }
};

// MSB-first bits into bytes, a 0x00 stuffed after each 0xFF (jchuff.c)
struct BitWriter {
  uint8_t* out;
  long cap;
  long n = 0;
  uint64_t acc = 0;
  int bits = 0;

  void byte(uint8_t b) {
    if (n + 2 > cap) fail("JPEG output buffer too small");
    out[n++] = b;
    if (b == 0xFF) out[n++] = 0;
  }

  void put(uint32_t value, int len) {
    if (!len) return;
    acc = (acc << len) | (value & ((1u << len) - 1));
    bits += len;
    while (bits >= 8) {
      bits -= 8;
      byte((uint8_t)(acc >> bits));
    }
    acc &= (1ull << bits) - 1;
  }

  // pad the last byte with one bits, as libjpeg's flush_bits does
  void flush() {
    if (bits) put(0x7F, 8 - bits);
  }
};

// the magnitude category of a value (its bit count)
int category(int v) {
  int a = v < 0 ? -v : v, nbits = 0;
  while (a) {
    nbits++;
    a >>= 1;
  }
  return nbits;
}

struct Encoder {
  HuffCodes dc[2] = {HuffCodes(standard_table(false, 0)),
                     HuffCodes(standard_table(false, 1))};
  HuffCodes ac[2] = {HuffCodes(standard_table(true, 0)),
                     HuffCodes(standard_table(true, 1))};

  // one block in zigzag order (jchuff.c encode_one_block)
  void block(BitWriter& w, const int16_t* zz, int& last_dc, int t) {
    int diff = zz[0] - last_dc;
    last_dc = zz[0];
    int nbits = category(diff);
    if (nbits > 11) fail("a DC difference out of range");
    w.put(dc[t].code[nbits], dc[t].len[nbits]);
    w.put(diff < 0 ? diff - 1 : diff, nbits);
    int run = 0;
    for (int k = 1; k < 64; k++) {
      int v = zz[k];
      if (!v) {
        run++;
        continue;
      }
      while (run > 15) {
        w.put(ac[t].code[0xF0], ac[t].len[0xF0]);
        run -= 16;
      }
      nbits = category(v);
      if (nbits > 10) fail("an AC coefficient out of range");
      int sym = (run << 4) + nbits;
      w.put(ac[t].code[sym], ac[t].len[sym]);
      w.put(v < 0 ? v - 1 : v, nbits);
      run = 0;
    }
    if (run) w.put(ac[t].code[0], ac[t].len[0]);
  }
};

}  // namespace

extern "C" int hrf_jpeg_info(const uint8_t* data, long n, int* info,
                             char* err, int errlen) {
  try {
    Decoder d;
    d.data = data;
    d.n = n;
    d.start();
    info[0] = d.height;
    info[1] = d.width;
    info[2] = d.ncomp;
    info[3] = d.colour();
    for (int c = 0; c < d.ncomp; c++) {
      // a lossless frame's samples come out at full size, each plane
      // padded to whole 8x8 tiles (hrf_jpeg_decode_samples)
      info[4 + 4 * c] = d.lossless ? 1 : d.comp[c].h;
      info[5 + 4 * c] = d.lossless ? 1 : d.comp[c].v;
      info[6 + 4 * c] = d.lossless ? (d.height + 7) / 8 : d.comp[c].rows;
      info[7 + 4 * c] = d.lossless ? (d.width + 7) / 8 : d.comp[c].cols;
    }
    info[20] = d.lossless;
    info[21] = d.precision;
    info[22] = d.lossless ? d.next_scan_al() : 0;
    return 0;
  } catch (const Error& e) {
    return report(e.what(), err, errlen);
  }
}

extern "C" int hrf_jpeg_decode(const uint8_t* data, long n, int16_t* out,
                               long out_len, char* err, int errlen) {
  try {
    Decoder d;
    d.data = data;
    d.n = n;
    d.start();
    if (d.lossless) fail("a lossless frame holds samples, not coefficients");
    long total = 0;
    for (int c = 0; c < d.ncomp; c++)
      total += (long)d.comp[c].rows * d.comp[c].cols * 64;
    if (out_len != total + 64L * d.ncomp)
      fail("output buffer of the wrong size");
    memset(out, 0, sizeof(int16_t) * out_len);
    d.out = out;
    do {
      d.scan();
    } while (d.until_scan());
    d.smooth_all();
    for (int c = 0; c < d.ncomp; c++)
      if (d.comp[c].latched)
        memcpy(out + total + 64 * c, d.comp[c].quant, 64 * sizeof(int16_t));
    return 0;
  } catch (const Error& e) {
    return report(e.what(), err, errlen);
  }
}

extern "C" int hrf_jpeg_decode_samples(const uint8_t* data, long n,
                                       uint8_t* out, long out_len, char* err,
                                       int errlen) {
  try {
    Decoder d;
    d.data = data;
    d.n = n;
    d.start();
    if (!d.lossless) fail("not a lossless frame: decode its coefficients");
    long rows = (d.height + 7) / 8 * 8, cols = (d.width + 7) / 8 * 8;
    if (out_len != rows * cols * d.ncomp)
      fail("output buffer of the wrong size");
    memset(out, 0, out_len);
    do {
      d.scan();
    } while (!d.one_pass && d.until_scan());
    // a file that ends before some component's first scan is refused,
    // as libjpeg-turbo 3 (through cv2) refuses it
    for (int c = 0; c < d.ncomp; c++)
      if (!d.scanned[c])
        fail("the file ends before a scan of component " +
             std::to_string(c + 1));
    for (int c = 0; c < d.ncomp; c++) {
      const Component& k = d.comp[c];
      int ey = d.lvmax / k.fv, ex = d.lhmax / k.fh;
      for (int y = 0; y < d.height; y++) {
        const uint8_t* src = d.samples[c].data() + (long)(y / ey) * k.wblocks;
        uint8_t* dst = out + (c * rows + y) * cols;
        if (ex == 1) {
          memcpy(dst, src, d.width);
        } else {
          for (int x = 0; x < d.width; x++) dst[x] = src[x / ex];
        }
      }
    }
    return 0;
  } catch (const Error& e) {
    return report(e.what(), err, errlen);
  }
}

// One interleaved baseline scan: `blocks` holds nmcu * per_mcu blocks of
// 64 quantised coefficients in zigzag order, MCU by MCU; comp[j] names
// the component (0 luma, 1 and 2 chroma) of the MCU's j-th block, which
// picks its DC predictor and its Annex K.3 table (luma or chroma). No
// restart markers. Writes the entropy-coded bytes, stuffed and padded,
// to out (cap bytes) and their count to *written.
extern "C" int hrf_jpeg_encode_scan(const int16_t* blocks, long nmcu,
                                    int per_mcu, const int* comp,
                                    uint8_t* out, long cap, long* written,
                                    char* err, int errlen) {
  try {
    Encoder e;
    BitWriter w{out, cap};
    int last_dc[3] = {0, 0, 0};
    for (int j = 0; j < per_mcu; j++)
      if (comp[j] < 0 || comp[j] > 2) fail("component index out of range");
    for (long m = 0; m < nmcu; m++)
      for (int j = 0; j < per_mcu; j++)
        e.block(w, blocks + 64 * (m * per_mcu + j), last_dc[comp[j]],
                comp[j] ? 1 : 0);
    w.flush();
    *written = w.n;
    return 0;
  } catch (const Error& ex) {
    return report(ex.what(), err, errlen);
  }
}
