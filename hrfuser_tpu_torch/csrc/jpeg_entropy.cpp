// Host half of the JPEG decoder: marker parsing and Huffman decoding of
// baseline and extended sequential JPEG (SOF0, SOF1), 8-bit, 1 or 3
// components. No JPEG library is linked.
//
// It turns a byte stream into each component's quantised DCT coefficients
// (int16, natural order, [block rows, block cols, 64] over the
// component's MCU-padded block grid) and the quantisation table each
// component latched at its first scan. The card does the rest
// (csrc/jpeg_pixels.cu). Huffman decoding is sequential, so it stays on
// the host; this is the part of libjpeg's decoder that the port keeps on
// the CPU.
//
// Behaviour follows libjpeg-turbo's decoder (jdmarker.c, jdhuff.c), so
// that damaged streams decode to the same coefficients:
//  - bits past the end of a scan's data (the data ends, or a marker comes
//    early) read as zeros; the block in which that first happens is
//    decoded from those zeros, and every later block of the restart
//    interval is left all zero (DC included: the predictor is not
//    applied). A restart marker found where it is expected clears that
//    state; a stream that simply ends reads as if an EOI followed it.
//  - at each restart marker the DC predictors reset and the bit buffer
//    realigns; a missing or out-of-order marker resynchronises as
//    jpeg_resync_to_restart does.
//  - an invalid Huffman code decodes as symbol 0 after 17 bits; a run
//    that passes coefficient 63 writes coefficient 63; DC sums wrap as
//    32-bit integers and are stored as int16; quantisation values are
//    stored as int16 (libjpeg's ISLOW_MULT_TYPE).
// Progressive, lossless, hierarchical and arithmetic-coded frames, other
// precisions than 8 bits, and 2- or 4-component images are refused with
// a message naming the mode.
//
// C interface (ctypes):
//   hrf_jpeg_info(data, n, info, err, errlen): frame header -> info =
//     [height, width, ncomp, colour (0 grey, 1 YCbCr, 2 RGB),
//      then per component: h, v, block rows, block cols]
//   hrf_jpeg_decode(data, n, out, out_len, err, errlen): out = every
//     component's coefficients, one after the other, then ncomp x 64
//     quantisation values (natural order); out_len counts int16 values.
// Both return 0, or 1 with a message in err.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>

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

  void build(const HuffSpec& spec, bool dc) {
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
    if (dc)
      for (int i = 0; i < nsym; i++)
        if (spec.vals[i] > 15) fail("bad Huffman table");
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
  int rows, cols;          // MCU-padded block grid
  int wblocks, hblocks;    // blocks that hold image samples
  long offset;             // first coefficient in the output
  bool latched = false;
  int16_t quant[64];
};

struct Decoder {
  const uint8_t* data;
  long n;
  long pos = 0;
  bool frame = false;
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

  // entropy decoder state (jdhuff.c's bitread_perm_state + marker)
  uint64_t buf = 0;
  int bits = 0;
  int marker = 0;          // marker met inside entropy data, 0 if none
  bool insufficient = false;
  int next_restart = 0;

  int byte() {
    if (pos >= n) fail("truncated before the image data");
    return data[pos++];
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

  // -- entropy-coded data -------------------------------------------------

  // jpeg_fill_bit_buffer: load bytes up to a marker; if `need` bits are
  // still missing the data has ended: pad with zeros and say so
  void fill(int need) {
    if (!marker) {
      while (bits <= 56) {
        int c;
        if (pos >= n) {
          marker = kEOI;
          break;
        }
        c = data[pos++];
        if (c == 0xFF) {
          do {
            if (pos >= n) {
              c = kEOI;
              break;
            }
            c = data[pos++];
          } while (c == 0xFF);
          if (c == 0) {
            c = 0xFF;
          } else {
            marker = c;
            break;
          }
        }
        buf = (buf << 8) | (uint64_t)c;
        bits += 8;
      }
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

  void decode_block(int16_t* blk, int& last_dc, const HuffTable& dc,
                    const HuffTable& ac) {
    int s = decode(dc);
    if (s) s = extend(get_bits(s), s);
    last_dc = (int)((uint32_t)last_dc + (uint32_t)s);
    blk[0] = (int16_t)last_dc;
    for (int k = 1; k < 64; k++) {
      s = decode(ac);
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

  // a scan's table: the one defined, or for a stream without tables
  // (motion JPEG) the standard one, as jpeg_std_huff_table gives it
  HuffSpec table(bool ac, int t) {
    const HuffSpec& s = (ac ? ac_spec : dc_spec)[t];
    if (s.defined) return s;
    if (t > 1) fail("scan uses an undefined Huffman table");
    return standard_table(ac, t);
  }

  void scan() {
    if (!frame) fail("scan before the frame header");
    int len = word();
    int ns = byte();
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns) fail("bad scan header");
    Component* sc[4];
    HuffTable dct[4], act[4];
    for (int i = 0; i < ns; i++) {
      int id = byte(), t = byte();
      sc[i] = nullptr;
      for (int c = 0; c < ncomp; c++)
        if (comp[c].id == id) sc[i] = &comp[c];
      if (!sc[i]) fail("scan names an unknown component");
      int td = t >> 4, ta = t & 15;
      if (td > 3 || ta > 3) fail("bad Huffman table index");
      dct[i].build(table(false, td), true);
      act[i].build(table(true, ta), false);
    }
    byte();  // Ss, Se, Ah/Al: sequential scans decode all 64 whatever
    byte();  // they say, as libjpeg does (with a warning)
    byte();
    for (int i = 0; i < ns; i++) {
      Component& c = *sc[i];
      if (!c.latched) {
        if (!quant_defined[c.tq]) fail("a component's quantisation table "
                                       "is not defined");
        for (int k = 0; k < 64; k++) c.quant[k] = (int16_t)quant[c.tq][k];
        c.latched = true;
      }
    }
    // MCU geometry
    int per_row, rows;
    if (ns == 1) {
      per_row = sc[0]->wblocks;
      rows = sc[0]->hblocks;
    } else {
      per_row = mcu_cols;
      rows = mcu_rows;
    }
    buf = 0;
    bits = 0;
    marker = 0;
    insufficient = false;
    next_restart = 0;
    int last_dc[4] = {0, 0, 0, 0};
    int to_go = restart_interval;
    for (int mr = 0; mr < rows; mr++) {
      for (int mc = 0; mc < per_row; mc++) {
        if (restart_interval) {
          if (to_go == 0) {
            restart();
            for (int i = 0; i < 4; i++) last_dc[i] = 0;
            to_go = restart_interval;
          }
        }
        bool skip = insufficient;
        for (int i = 0; i < ns; i++) {
          Component& c = *sc[i];
          int bh = ns == 1 ? 1 : c.v, bw = ns == 1 ? 1 : c.h;
          for (int y = 0; y < bh; y++) {
            for (int x = 0; x < bw; x++) {
              int br = mr * bh + y, bc = mc * bw + x;
              int16_t* blk = out + c.offset + ((long)br * c.cols + bc) * 64;
              memset(blk, 0, 64 * sizeof(int16_t));
              if (!skip) decode_block(blk, last_dc[i], dct[i], act[i]);
            }
          }
        }
        if (restart_interval) to_go--;
      }
    }
  }

  // -- marker segments ----------------------------------------------------

  void sof(int code) {
    switch (code) {
      case 0xC2: fail("progressive JPEG is not supported");
      case 0xC3: fail("lossless JPEG is not supported");
      case 0xC5: case 0xC6: case 0xC7:
        fail("hierarchical (differential) JPEG is not supported");
      case 0xC9: fail("arithmetic-coded JPEG is not supported");
      case 0xCA: fail("arithmetic-coded progressive JPEG is not supported");
      case 0xCB: fail("arithmetic-coded lossless JPEG is not supported");
      case 0xCD: case 0xCE: case 0xCF:
        fail("arithmetic-coded hierarchical JPEG is not supported");
    }
    if (frame) fail("a second frame header");
    int len = word();
    int precision = byte();
    height = word();
    width = word();
    ncomp = byte();
    if (precision == 12) fail("12-bit precision is not supported");
    if (precision != 8)
      fail("precision " + std::to_string(precision) + " is not supported");
    if (height == 0)
      fail("a height set by a DNL marker is not supported");
    if (width == 0) fail("width 0");
    if (ncomp == 2) fail("2-component JPEG is not supported");
    if (ncomp == 4) fail("4-component (CMYK/YCCK) JPEG is not supported");
    if (ncomp != 1 && ncomp != 3)
      fail(std::to_string(ncomp) + "-component JPEG is not supported");
    if (len != 8 + 3 * ncomp) fail("bad frame header");
    for (int c = 0; c < ncomp; c++) {
      comp[c].id = byte();
      int hv = byte();
      comp[c].h = hv >> 4;
      comp[c].v = hv & 15;
      comp[c].tq = byte();
      if (comp[c].h < 1 || comp[c].h > 4 || comp[c].v < 1 || comp[c].v > 4)
        fail("bad sampling factors");
      if (comp[c].tq > 3) fail("bad quantisation table index");
      if (comp[c].h > hmax) hmax = comp[c].h;
      if (comp[c].v > vmax) vmax = comp[c].v;
    }
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
      } else if (m == 0xFE || m == 0xCC || m == 0xDC) {
        skip();  // COM, DAC, DNL
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
  }

  int colour() const {
    if (ncomp == 1) return 0;
    if (jfif) return 1;
    if (adobe) return adobe_transform == 0 ? 2 : 1;
    if (comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B')
      return 2;
    return 1;
  }
};

int report(const char* msg, char* err, int errlen) {
  if (err && errlen > 0) {
    strncpy(err, msg, errlen - 1);
    err[errlen - 1] = 0;
  }
  return 1;
}

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
      info[4 + 4 * c] = d.comp[c].h;
      info[5 + 4 * c] = d.comp[c].v;
      info[6 + 4 * c] = d.comp[c].rows;
      info[7 + 4 * c] = d.comp[c].cols;
    }
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
    for (int c = 0; c < d.ncomp; c++)
      if (d.comp[c].latched)
        memcpy(out + total + 64 * c, d.comp[c].quant, 64 * sizeof(int16_t));
    return 0;
  } catch (const Error& e) {
    return report(e.what(), err, errlen);
  }
}
