// Host WebP decoder: the lossless (VP8L) and lossy (VP8) bitstreams, the
// ALPH alpha plane, and libwebp's output stage, as cv2 5.0 reads them
// through WebPDecodeBGRInto / WebPDecodeBGRAInto. No WebP library is
// linked. The container (RIFF, VP8X, the optional chunks, an animation's
// frames) is read in data/webp.py, which hands this file the bitstream.
//
// Decoding is sequential by nature: VP8L's prefix codes, LZ77 copies and
// colour cache work pixel by pixel, and VP8's boolean decoder feeds an
// intra prediction that needs its left and upper neighbours. So it stays
// on the host, in C++.
//
// What is matched, and where it came from:
//  - VP8L (the WebP lossless bitstream specification, and libwebp's
//    vp8l_dec.c / huffman_utils.c / lossless.c): the bit reader (LSB
//    first, 64-bit window; reading past the end of the data flags the
//    end of stream, which fails the decode), simple and normal prefix
//    codes (a code must be complete, or have one symbol, which then
//    takes no bits), the code-length code and its max_symbol, meta
//    prefix codes, LZ77 copies with the 120-entry distance map, the
//    colour cache (hash 0x1e35a7bd), and the four transforms undone in
//    reverse order (predictor modes 0-13, 14 and 15 acting as 0; cross
//    colour; add green; colour indexing with pixel bundling, the later
//    transforms seeing the bundled width).
//  - ALPH: raw or VP8L-coded (an image stream with no header, green
//    channel), then the none / horizontal / vertical / gradient
//    unfiltering. A VP8L-coded alpha plane whose only transform is colour
//    indexing, with no colour cache and single-symbol red, blue and
//    alpha codes, decodes as libwebp's 8-bit path does: its last symbol
//    may end past the data.
//  - VP8 (RFC 6386; libwebp's vp8_dec.c, tree_dec.c, quant_dec.c,
//    frame_dec.c, dsp/dec.c): the boolean decoder with libwebp's
//    end-of-data rule (one zero byte is read past the end and flags it;
//    a flagged partition fails the decode at the next check) and its x86
//    state (56-bit loads, the sign read of VP8GetSigned, the full inverse
//    DCT in 16-bit lanes as dsp/dec_sse2.c runs it), which decide what a
//    damaged stream decodes to; segments,
//    filter header, 1-8 token partitions (the last one runs to the end of
//    the data), quantiser tables with their clamps, coefficient
//    probabilities and their updates, intra 16x16 / 4x4 / chroma
//    prediction with the 127 / 129 borders, the skip flag, inverse WHT
//    and DCT, and the simple and normal loop filters with sharpness and
//    mode_lf_delta, applied macroblock by macroblock in raster order on
//    the unfiltered prediction.
//  - libwebp's output stage: fancy upsampling of 4:2:0 chroma (the first
//    and last rows and odd sizes as EmitFancyRGB treats them) and the
//    14-bit fixed-point YUV -> RGB of yuv.h (MultHi, VP8Clip8). The alpha
//    of a BGRA read is not premultiplied.
//
// The probability and distance tables are the constants of RFC 6386 and
// of the WebP lossless specification.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw Error(msg); }

int report(const char* msg, char* err, int errlen) {
  if (errlen > 0) {
    std::strncpy(err, msg, errlen - 1);
    err[errlen - 1] = 0;
  }
  return 1;
}

// RFC 6386 13.5: default coefficient probabilities; 13.4: the
// probabilities of their updates; 11.5: B_PRED sub-block mode
// probabilities, indexed [above][left] in the mode order below. The WebP
// lossless specification 4.2.2: the distance map, (dy << 4) | (8 - dx).
static const uint8_t kCoeffProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
      1,  98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
     78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
      1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
     77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
      1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
     37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
      1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
      1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
     80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
      1,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198,  35, 237, 223, 193, 187, 162, 160, 145, 155,  62,
    131,  45, 198, 221, 172, 176, 220, 157, 252, 221,   1,
     68,  47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
      1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
     81,  99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
      1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
     99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
     23,  91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
      1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
     44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
      1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
     94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
     22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
      1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
     35,  77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
      1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
     45,  99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
      1,   1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203,   1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137,   1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253,   9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175,  13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
     73,  17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
      1,  95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239,  90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155,  77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
      1,  24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201,  51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
     69,  46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
      1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
      1,  16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190,  36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
      1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
      1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213,  62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
     55,  93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202,  24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126,  38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
     61,  46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
      1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
     39,  77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
      1,  52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124,  74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
     24,  71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
      1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
     28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
      1,  81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
     20,  95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
      1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
     47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
      1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141,  84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
     42,  80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
      1,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
static const uint8_t kCoeffUpdate[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
static const uint8_t kBModeProba[10][10][9] = {
    231, 120,  48,  89, 115, 113, 120, 152, 112,
    152, 179,  64, 126, 170, 118,  46,  70,  95,
    175,  69, 143,  80,  85,  82,  72, 155, 103,
     56,  58,  10, 171, 218, 189,  17,  13, 152,
    114,  26,  17, 163,  44, 195,  21,  10, 173,
    121,  24,  80, 195,  26,  62,  44,  64,  85,
    144,  71,  10,  38, 171, 213, 144,  34,  26,
    170,  46,  55,  19, 136, 160,  33, 206,  71,
     63,  20,   8, 114, 114, 208,  12,   9, 226,
     81,  40,  11,  96, 182,  84,  29,  16,  36,
    134, 183,  89, 137,  98, 101, 106, 165, 148,
     72, 187, 100, 130, 157, 111,  32,  75,  80,
     66, 102, 167,  99,  74,  62,  40, 234, 128,
     41,  53,   9, 178, 241, 141,  26,   8, 107,
     74,  43,  26, 146,  73, 166,  49,  23, 157,
     65,  38, 105, 160,  51,  52,  31, 115, 128,
    104,  79,  12,  27, 217, 255,  87,  17,   7,
     87,  68,  71,  44, 114,  51,  15, 186,  23,
     47,  41,  14, 110, 182, 183,  21,  17, 194,
     66,  45,  25, 102, 197, 189,  23,  18,  22,
     88,  88, 147, 150,  42,  46,  45, 196, 205,
     43,  97, 183, 117,  85,  38,  35, 179,  61,
     39,  53, 200,  87,  26,  21,  43, 232, 171,
     56,  34,  51, 104, 114, 102,  29,  93,  77,
     39,  28,  85, 171,  58, 165,  90,  98,  64,
     34,  22, 116, 206,  23,  34,  43, 166,  73,
    107,  54,  32,  26,  51,   1,  81,  43,  31,
     68,  25, 106,  22,  64, 171,  36, 225, 114,
     34,  19,  21, 102, 132, 188,  16,  76, 124,
     62,  18,  78,  95,  85,  57,  50,  48,  51,
    193, 101,  35, 159, 215, 111,  89,  46, 111,
     60, 148,  31, 172, 219, 228,  21,  18, 111,
    112, 113,  77,  85, 179, 255,  38, 120, 114,
     40,  42,   1, 196, 245, 209,  10,  25, 109,
     88,  43,  29, 140, 166, 213,  37,  43, 154,
     61,  63,  30, 155,  67,  45,  68,   1, 209,
    100,  80,   8,  43, 154,   1,  51,  26,  71,
    142,  78,  78,  16, 255, 128,  34, 197, 171,
     41,  40,   5, 102, 211, 183,   4,   1, 221,
     51,  50,  17, 168, 209, 192,  23,  25,  82,
    138,  31,  36, 171,  27, 166,  38,  44, 229,
     67,  87,  58, 169,  82, 115,  26,  59, 179,
     63,  59,  90, 180,  59, 166,  93,  73, 154,
     40,  40,  21, 116, 143, 209,  34,  39, 175,
     47,  15,  16, 183,  34, 223,  49,  45, 183,
     46,  17,  33, 183,   6,  98,  15,  32, 183,
     57,  46,  22,  24, 128,   1,  54,  17,  37,
     65,  32,  73, 115,  28, 128,  23, 128, 205,
     40,   3,   9, 115,  51, 192,  18,   6, 223,
     87,  37,   9, 115,  59,  77,  64,  21,  47,
    104,  55,  44, 218,   9,  54,  53, 130, 226,
     64,  90,  70, 205,  40,  41,  23,  26,  57,
     54,  57, 112, 184,   5,  41,  38, 166, 213,
     30,  34,  26, 133, 152, 116,  10,  32, 134,
     39,  19,  53, 221,  26, 114,  32,  73, 255,
     31,   9,  65, 234,   2,  15,   1, 118,  73,
     75,  32,  12,  51, 192, 255, 160,  43,  51,
     88,  31,  35,  67, 102,  85,  55, 186,  85,
     56,  21,  23, 111,  59, 205,  45,  37, 192,
     55,  38,  70, 124,  73, 102,   1,  34,  98,
    125,  98,  42,  88, 104,  85, 117, 175,  82,
     95,  84,  53,  89, 128, 100, 113, 101,  45,
     75,  79, 123,  47,  51, 128,  81, 171,   1,
     57,  17,   5,  71, 102,  57,  53,  41,  49,
     38,  33,  13, 121,  57,  73,  26,   1,  85,
     41,  10,  67, 138,  77, 110,  90,  47, 114,
    115,  21,   2,  10, 102, 255, 166,  23,   6,
    101,  29,  16,  10,  85, 128, 101, 196,  26,
     57,  18,  10, 102, 102, 213,  34,  20,  43,
    117,  20,  15,  36, 163, 128,  68,   1,  26,
    102,  61,  71,  37,  34,  53,  31, 243, 192,
     69,  60,  71,  38,  73, 119,  28, 222,  37,
     68,  45, 128,  34,   1,  47,  11, 245, 171,
     62,  17,  19,  70, 146,  85,  55,  62,  70,
     37,  43,  37, 154, 100, 163,  85, 160,   1,
     63,   9,  92, 136,  28,  64,  32, 201,  85,
     75,  15,   9,   9,  64, 255, 184, 119,  16,
     86,   6,  28,   5,  64, 255,  25, 248,   1,
     56,   8,  17, 132, 137, 255,  55, 116, 128,
     58,  15,  20,  82, 135,  57,  26, 121,  40,
    164,  50,  31, 137, 154, 133,  25,  35, 218,
     51, 103,  44, 131, 131, 123,  31,   6, 158,
     86,  40,  64, 135, 148, 224,  45, 183, 128,
     22,  26,  17, 131, 240, 154,  14,   1, 209,
     45,  16,  21,  91,  64, 222,   7,   1, 197,
     56,  21,  39, 155,  60, 138,  23, 102, 213,
     83,  12,  13,  54, 192, 255,  68,  47,  28,
     85,  26,  85,  85, 128, 128,  32, 146, 171,
     18,  11,   7,  63, 144, 171,   4,   4, 246,
     35,  27,  10, 146, 174, 171,  12,  26, 128,
    190,  80,  35,  99, 180,  80, 126,  54,  45,
     85, 126,  47,  87, 176,  51,  41,  20,  32,
    101,  75, 128, 139, 118, 146, 116, 128,  85,
     56,  41,  15, 176, 236,  85,  37,   9,  62,
     71,  30,  17, 119, 118, 255,  17,  18, 138,
    101,  38,  60, 138,  55,  70,  43,  26, 142,
    146,  36,  19,  30, 171, 255,  97,  27,  20,
    138,  45,  61,  62, 219,   1,  81, 188,  64,
     32,  41,  20, 117, 151, 142,  20,  21, 163,
    112,  19,  12,  61, 195, 128,  48,   4,  24,
};
static const uint8_t kCodeToPlane[120] = {
     24,   7,  23,  25,  40,   6,  39,  41,  22,  26,  38,  42,
     56,   5,  55,  57,  21,  27,  54,  58,  37,  43,  72,   4,
     71,  73,  20,  28,  53,  59,  70,  74,  36,  44,  88,  69,
     75,  52,  60,   3,  87,  89,  19,  29,  86,  90,  35,  45,
     68,  76,  85,  91,  51,  61, 104,   2, 103, 105,  18,  30,
    102, 106,  34,  46,  84,  92,  67,  77, 101, 107,  50,  62,
    120,   1, 119, 121,  83,  93,  17,  31, 100, 108,  66,  78,
    118, 122,  33,  47, 117, 123,  49,  63,  99, 109,  82,  94,
      0, 116, 124,  65,  79,  16,  32,  98, 110,  48, 115, 125,
     81,  95,  64, 114, 126,  97, 111,  80, 113, 127,  96, 112,
};

// ---------------------------------------------------------------- VP8L

// The lossless bit reader: bits LSB first from a 64-bit window; the end
// of stream is flagged once more bits were used than the data holds.
struct LReader {
  uint64_t val = 0;
  const uint8_t* buf = nullptr;
  size_t len = 0, pos = 0;
  int bit_pos = 0;
  int eos = 0;

  void init(const uint8_t* start, size_t n) {
    len = n;
    val = 0;
    bit_pos = 0;
    eos = 0;
    size_t k = n < 8 ? n : 8;
    for (size_t i = 0; i < k; ++i) val |= (uint64_t)start[i] << (8 * i);
    pos = k;
    buf = start;
  }
  bool at_end() const { return eos || (pos == len && bit_pos > 64); }
  void set_eos() {
    eos = 1;
    bit_pos = 0;
  }
  void shift() {
    while (bit_pos >= 8 && pos < len) {
      val >>= 8;
      val |= (uint64_t)buf[pos] << 56;
      ++pos;
      bit_pos -= 8;
    }
    if (at_end()) set_eos();
  }
  uint32_t peek() const { return (uint32_t)(val >> (bit_pos & 63)); }
  uint32_t read(int n) {
    if (!eos && n <= 24) {
      uint32_t v = peek() & ((1u << n) - 1);
      bit_pos += n;
      shift();
      return v;
    }
    set_eos();
    return 0;
  }
  void fill() {
    if (bit_pos >= 32) shift();
  }
};

struct HCode {
  uint8_t bits;
  uint16_t value;
};

constexpr int kMaxCodeLength = 15;
constexpr int kRootBits = 8;
constexpr int kLengthsRootBits = 7;

uint32_t next_key(uint32_t key, int len) {
  uint32_t step = 1u << (len - 1);
  while (key & step) step >>= 1;
  return step ? (key & (step - 1)) + step : key;
}

void replicate(HCode* table, int step, int end, HCode code) {
  do {
    end -= step;
    table[end] = code;
  } while (end > 0);
}

int next_table_bits(const int* count, int len, int root_bits) {
  int left = 1 << (len - root_bits);
  while (len < kMaxCodeLength) {
    left -= count[len];
    if (left <= 0) break;
    ++len;
    left <<= 1;
  }
  return len - root_bits;
}

// A canonical prefix code of these lengths as a root table of 2^root_bits
// entries and second-level tables (huffman_utils.c's layout). Returns the
// number of entries, or 0 for a code that is not complete (a single
// symbol excepted, which takes 0 bits). `root_table` null: size only.
int build_code(HCode* root_table, int root_bits, const int* lengths, int n,
               uint16_t* sorted) {
  HCode* table = root_table;
  int total_size = 1 << root_bits;
  int count[kMaxCodeLength + 1] = {0};
  int offset[kMaxCodeLength + 1];
  for (int s = 0; s < n; ++s) {
    if (lengths[s] > kMaxCodeLength) return 0;
    ++count[lengths[s]];
  }
  if (count[0] == n) return 0;
  offset[1] = 0;
  for (int len = 1; len < kMaxCodeLength; ++len) {
    if (count[len] > (1 << len)) return 0;
    offset[len + 1] = offset[len] + count[len];
  }
  for (int s = 0; s < n; ++s) {
    int l = lengths[s];
    if (l > 0) {
      if (sorted) sorted[offset[l]] = (uint16_t)s;
      offset[l]++;
    }
  }
  if (offset[kMaxCodeLength] == 1) {
    if (root_table) replicate(table, 1, total_size, HCode{0, sorted[0]});
    return total_size;
  }
  uint32_t low = 0xffffffffu, mask = total_size - 1, key = 0;
  int num_nodes = 1, num_open = 1, table_bits = root_bits;
  int table_size = 1 << table_bits, symbol = 0, len, step;
  for (len = 1, step = 2; len <= root_bits; ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return 0;
    if (!root_table) continue;
    for (; count[len] > 0; --count[len]) {
      replicate(&table[key], step, table_size,
                HCode{(uint8_t)len, sorted[symbol++]});
      key = next_key(key, len);
    }
  }
  for (len = root_bits + 1, step = 2; len <= kMaxCodeLength;
       ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return 0;
    for (; count[len] > 0; --count[len]) {
      if ((key & mask) != low) {
        if (root_table) table += table_size;
        table_bits = next_table_bits(count, len, root_bits);
        table_size = 1 << table_bits;
        total_size += table_size;
        low = key & mask;
        if (root_table) {
          root_table[low].bits = (uint8_t)(table_bits + root_bits);
          root_table[low].value = (uint16_t)((table - root_table) - low);
        }
      }
      if (root_table)
        replicate(&table[key >> root_bits], step, table_size,
                  HCode{(uint8_t)(len - root_bits), sorted[symbol++]});
      key = next_key(key, len);
    }
  }
  if (num_nodes != 2 * offset[kMaxCodeLength] - 1) return 0;
  return total_size;
}

// Appends the code's tables to `out`; returns their size, 0 if invalid.
int append_code(std::vector<HCode>& out, int root_bits, const int* lengths,
                int n) {
  int size = build_code(nullptr, root_bits, lengths, n, nullptr);
  if (size == 0) return 0;
  std::vector<uint16_t> sorted(n);
  size_t at = out.size();
  out.resize(at + size);
  build_code(out.data() + at, root_bits, lengths, n, sorted.data());
  return size;
}

inline int read_symbol(const HCode* t, LReader& br) {
  uint32_t v = br.peek();
  t += v & ((1u << kRootBits) - 1);
  int nbits = t->bits - kRootBits;
  if (nbits > 0) {
    br.bit_pos += kRootBits;
    v = br.peek();
    t += t->value;
    t += v & ((1u << nbits) - 1);
  }
  br.bit_pos += t->bits;
  return t->value;
}

constexpr int kLiterals = 256, kLengthCodes = 24, kDistanceCodes = 40;
constexpr int kAlphabet[5] = {kLiterals + kLengthCodes, kLiterals, kLiterals,
                              kLiterals, kDistanceCodes};
constexpr int kCodeLengthOrder[19] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                      7,  8,  9, 10, 11, 12, 13, 14, 15};
enum { GREEN = 0, RED = 1, BLUE = 2, ALPHA = 3, DIST = 4 };
enum { PREDICTOR = 0, CROSS_COLOR = 1, SUBTRACT_GREEN = 2, COLOR_INDEXING = 3 };

inline int sub_sample(int size, int bits) {
  return (size + (1 << bits) - 1) >> bits;
}

// What one image stream's entropy coding holds: prefix code groups, the
// meta image that picks a group per tile, the colour cache.
struct Meta {
  int cache_bits = 0;
  int huff_bits = 0, huff_xsize = 0, mask = ~0;
  std::vector<uint32_t> huff_image;
  std::vector<HCode> tables;
  std::vector<int> groups;  // 5 table offsets a group

  const HCode* table(int group, int which) const {
    return tables.data() + groups[5 * group + which];
  }
  int group_at(int col, int row) const {
    if (huff_bits == 0) return 0;
    return (int)huff_image[(size_t)huff_xsize * (row >> huff_bits) +
                           (col >> huff_bits)];
  }
};

struct Transform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline uint32_t clip255(uint32_t a) {
  if (a < 256) return a;
  return ~a >> 24;
}

inline int sub3(int a, int b, int c) {
  int pb = b - c, pa = a - c;
  return std::abs(pb) - std::abs(pa);
}

inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {
  int d = sub3(a >> 24, b >> 24, c >> 24) +
          sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
          sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
          sub3(a & 0xff, b & 0xff, c & 0xff);
  return d <= 0 ? a : b;
}

inline uint32_t add_sub_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t a = clip255((c0 >> 24) + (c1 >> 24) - (c2 >> 24));
  uint32_t r = clip255(((c0 >> 16) & 0xff) + ((c1 >> 16) & 0xff) -
                       ((c2 >> 16) & 0xff));
  uint32_t g = clip255(((c0 >> 8) & 0xff) + ((c1 >> 8) & 0xff) -
                       ((c2 >> 8) & 0xff));
  uint32_t b = clip255((c0 & 0xff) + (c1 & 0xff) - (c2 & 0xff));
  return (a << 24) | (r << 16) | (g << 8) | b;
}

inline int add_sub_half_component(int a, int b) {
  return (int)clip255((uint32_t)(a + (a - b) / 2));
}

inline uint32_t add_sub_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t ave = average2(c0, c1);
  int a = add_sub_half_component(ave >> 24, c2 >> 24);
  int r = add_sub_half_component((ave >> 16) & 0xff, (c2 >> 16) & 0xff);
  int g = add_sub_half_component((ave >> 8) & 0xff, (c2 >> 8) & 0xff);
  int b = add_sub_half_component(ave & 0xff, c2 & 0xff);
  return ((uint32_t)a << 24) | (r << 16) | (g << 8) | b;
}

// Predictor `mode` for the pixel whose left neighbour is `left` and whose
// upper neighbour is up[0] (up[-1] upper left, up[1] upper right).
inline uint32_t predict(int mode, uint32_t left, const uint32_t* up) {
  switch (mode) {
    case 1: return left;
    case 2: return up[0];
    case 3: return up[1];
    case 4: return up[-1];
    case 5: return average2(average2(left, up[1]), up[0]);
    case 6: return average2(left, up[-1]);
    case 7: return average2(left, up[0]);
    case 8: return average2(up[-1], up[0]);
    case 9: return average2(up[0], up[1]);
    case 10:
      return average2(average2(left, up[-1]), average2(up[0], up[1]));
    case 11: return select_pred(up[0], left, up[-1]);
    case 12: return add_sub_full(left, up[0], up[-1]);
    case 13: return add_sub_half(left, up[0], up[-1]);
    default: return 0xff000000u;  // 0, and 14, 15
  }
}

inline int color_delta(int8_t pred, int8_t color) {
  return ((int)pred * color) >> 5;
}

struct Lossless {
  LReader br;
  std::vector<Transform> transforms;
  unsigned seen = 0;

  bool read_code_lengths(const int* cl_lengths, int num_symbols,
                         int* lengths) {
    std::vector<HCode> table;
    if (!append_code(table, kLengthsRootBits, cl_lengths, 19)) return false;
    int max_symbol;
    if (br.read(1)) {
      int length_nbits = 2 + 2 * (int)br.read(3);
      max_symbol = 2 + (int)br.read(length_nbits);
      if (max_symbol > num_symbols) return false;
    } else {
      max_symbol = num_symbols;
    }
    int symbol = 0, prev = 8;
    while (symbol < num_symbols) {
      if (max_symbol-- == 0) break;
      br.fill();
      const HCode& p = table[br.peek() & ((1u << kLengthsRootBits) - 1)];
      br.bit_pos += p.bits;
      int code_len = p.value;
      if (code_len < 16) {
        lengths[symbol++] = code_len;
        if (code_len != 0) prev = code_len;
      } else {
        static const int extra[3] = {2, 3, 7}, offsets[3] = {3, 3, 11};
        int slot = code_len - 16;
        int repeat = (int)br.read(extra[slot]) + offsets[slot];
        if (symbol + repeat > num_symbols) return false;
        int len = code_len == 16 ? prev : 0;
        while (repeat-- > 0) lengths[symbol++] = len;
      }
    }
    return true;
  }

  // One prefix code into `out` (its tables appended); returns the offset
  // of its root table.
  int read_code(int alphabet, std::vector<int>& lengths,
                std::vector<HCode>& out) {
    int simple = br.read(1);
    std::fill(lengths.begin(), lengths.begin() + alphabet, 0);
    bool ok;
    if (simple) {
      int num = br.read(1) + 1;
      int first_bits = br.read(1);
      int symbol = br.read(first_bits == 0 ? 1 : 8);
      lengths[symbol] = 1;
      if (num == 2) {
        symbol = br.read(8);
        lengths[symbol] = 1;
      }
      ok = true;
    } else {
      int cl_lengths[19] = {0};
      int num_codes = br.read(4) + 4;
      for (int i = 0; i < num_codes; ++i)
        cl_lengths[kCodeLengthOrder[i]] = br.read(3);
      ok = read_code_lengths(cl_lengths, alphabet, lengths.data());
    }
    ok = ok && !br.eos;
    int at = (int)out.size();
    if (!ok || !append_code(out, kRootBits, lengths.data(), alphabet))
      fail("VP8L: an invalid prefix code");
    return at;
  }

  void read_codes(Meta& m, int xsize, int ysize, int cache_bits,
                  bool allow_recursion) {
    int num_groups = 1, num_groups_max = 1;
    std::vector<int> mapping;
    if (allow_recursion && br.read(1)) {
      int bits = 2 + br.read(3);
      int hx = sub_sample(xsize, bits), hy = sub_sample(ysize, bits);
      Meta sub;
      int w;
      m.huff_image = decode_stream(hx, hy, false, sub, w);
      m.huff_bits = bits;
      for (auto& p : m.huff_image) {
        p = (p >> 8) & 0xffff;
        if ((int)p >= num_groups_max) num_groups_max = p + 1;
      }
      if (num_groups_max > 1000 ||
          (int64_t)num_groups_max > (int64_t)xsize * ysize) {
        // only the groups the meta image uses are kept, renumbered
        mapping.assign(num_groups_max, -1);
        num_groups = 0;
        for (auto& p : m.huff_image) {
          if (mapping[p] == -1) mapping[p] = num_groups++;
          p = mapping[p];
        }
      } else {
        num_groups = num_groups_max;
      }
    }
    if (br.eos) fail("VP8L: the data ends in the meta prefix codes");
    int max_alphabet = kAlphabet[0] + (cache_bits > 0 ? 1 << cache_bits : 0);
    std::vector<int> lengths(std::max(max_alphabet, 256) + 1, 0);
    m.groups.assign(5 * num_groups, 0);
    std::vector<HCode> scratch;
    for (int i = 0; i < num_groups_max; ++i) {
      bool unused = !mapping.empty() && mapping[i] == -1;
      for (int j = 0; j < 5; ++j) {
        int alphabet = kAlphabet[j];
        if (j == 0 && cache_bits > 0) alphabet += 1 << cache_bits;
        if (unused) {
          scratch.clear();
          read_code(alphabet, lengths, scratch);
        } else {
          int g = mapping.empty() ? i : mapping[i];
          m.groups[5 * g + j] = read_code(alphabet, lengths, m.tables);
        }
      }
    }
  }

  void read_transform(int& xsize, int ysize) {
    int type = br.read(2);
    if (seen & (1u << type)) fail("VP8L: a transform used twice");
    seen |= 1u << type;
    Transform t;
    t.type = type;
    t.xsize = xsize;
    t.ysize = ysize;
    Meta m;
    int w;
    if (type == PREDICTOR || type == CROSS_COLOR) {
      t.bits = br.read(3) + 2;
      t.data = decode_stream(sub_sample(t.xsize, t.bits),
                             sub_sample(t.ysize, t.bits), false, m, w);
    } else if (type == COLOR_INDEXING) {
      int num_colors = br.read(8) + 1;
      int bits = num_colors > 16 ? 0 : num_colors > 4 ? 1
                 : num_colors > 2 ? 2 : 3;
      xsize = sub_sample(t.xsize, bits);
      t.bits = bits;
      std::vector<uint32_t> map = decode_stream(num_colors, 1, false, m, w);
      // palette deltas added byte by byte; entries past it transparent
      t.data.assign(1u << (8 >> bits), 0u);
      t.data[0] = map[0];
      for (int i = 1; i < num_colors; ++i)
        t.data[i] = add_pixels(map[i], t.data[i - 1]);
    }
    transforms.push_back(std::move(t));
  }

  // An image stream of xsize x ysize; level 0 (the main image, or an
  // alpha plane) reads its transforms and leaves its pixels to the
  // caller (`meta`, `out_xsize` the width after colour indexing).
  std::vector<uint32_t> decode_stream(int xsize, int ysize, bool level0,
                                      Meta& meta, int& out_xsize) {
    int txsize = xsize;
    if (level0)
      while (br.read(1)) read_transform(txsize, ysize);
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = br.read(4);
      if (cache_bits < 1 || cache_bits > 11)
        fail("VP8L: a colour cache of " + std::to_string(cache_bits) +
             " bits");
    }
    read_codes(meta, txsize, ysize, cache_bits, level0);
    meta.cache_bits = cache_bits;
    meta.huff_xsize = sub_sample(txsize, meta.huff_bits);
    meta.mask = meta.huff_bits == 0 ? ~0 : (1 << meta.huff_bits) - 1;
    out_xsize = txsize;
    if (level0) return {};
    std::vector<uint32_t> data((size_t)txsize * ysize);
    if (!decode_pixels(data.data(), txsize, ysize, meta) || br.eos)
      fail("VP8L: the image data is damaged or ends early");
    return data;
  }

  int copy_distance(int symbol) {
    if (symbol < 4) return symbol + 1;
    int extra_bits = (symbol - 2) >> 1;
    int offset = (2 + (symbol & 1)) << extra_bits;
    return offset + br.read(extra_bits) + 1;
  }

  static int plane_distance(int xsize, int code) {
    if (code > 120) return code - 120;
    int d = kCodeToPlane[code - 1];
    int dist = (d >> 4) * xsize + (8 - (d & 0xf));
    return dist >= 1 ? dist : 1;
  }

  // The entropy-coded pixels (DecodeImageData); false on an error.
  bool decode_pixels(uint32_t* data, int width, int height, const Meta& m) {
    int row = 0, col = 0;
    uint32_t* src = data;
    uint32_t* last_cached = src;
    uint32_t* const src_end = data + (size_t)width * height;
    const int len_code_limit = kLiterals + kLengthCodes;
    const int cache_size = m.cache_bits > 0 ? 1 << m.cache_bits : 0;
    const int cache_limit = len_code_limit + cache_size;
    std::vector<uint32_t> cache(cache_size, 0);
    const int cache_shift = 32 - m.cache_bits;
    auto insert = [&](uint32_t argb) {
      cache[(0x1e35a7bdu * argb) >> cache_shift] = argb;
    };
    int g = 0;
    while (src < src_end) {
      if ((col & m.mask) == 0) g = m.group_at(col, row);
      br.fill();
      int code = read_symbol(m.table(g, GREEN), br);
      if (br.at_end()) break;
      if (code < kLiterals || (code >= len_code_limit && code < cache_limit)) {
        if (code < kLiterals) {
          int red = read_symbol(m.table(g, RED), br);
          br.fill();
          int blue = read_symbol(m.table(g, BLUE), br);
          int alpha = read_symbol(m.table(g, ALPHA), br);
          if (br.at_end()) break;
          *src = ((uint32_t)alpha << 24) | (red << 16) | (code << 8) | blue;
        } else {
          while (last_cached < src) insert(*last_cached++);
          *src = cache[code - len_code_limit];
        }
        ++src;
        ++col;
        if (col >= width) {
          col = 0;
          ++row;
          if (cache_size)
            while (last_cached < src) insert(*last_cached++);
        }
      } else if (code < len_code_limit) {
        int length = copy_distance(code - kLiterals);
        int dist_symbol = read_symbol(m.table(g, DIST), br);
        br.fill();
        int dist = plane_distance(width, copy_distance(dist_symbol));
        if (br.at_end()) break;
        if (src - data < (ptrdiff_t)dist || src_end - src < (ptrdiff_t)length)
          return false;
        for (int i = 0; i < length; ++i) src[i] = src[i - dist];
        src += length;
        col += length;
        while (col >= width) {
          col -= width;
          ++row;
        }
        if (col & m.mask) g = m.group_at(col, row);
        if (cache_size)
          while (last_cached < src) insert(*last_cached++);
      } else {
        return false;
      }
    }
    br.eos = br.at_end();
    return !br.eos;
  }

  // libwebp's 8-bit route for alpha planes (DecodeAlphaData): the green
  // symbols alone; the data may end inside the last symbol.
  bool decode_alpha_indices(uint8_t* data, int width, int height,
                            const Meta& m) {
    int row = 0, col = 0, pos = 0;
    const int end = width * height;
    const int len_code_limit = kLiterals + kLengthCodes;
    int g = 0;
    while (!br.eos && pos < end) {
      if ((col & m.mask) == 0) g = m.group_at(col, row);
      br.fill();
      int code = read_symbol(m.table(g, GREEN), br);
      if (code < kLiterals) {
        data[pos++] = (uint8_t)code;
        if (++col >= width) {
          col = 0;
          ++row;
        }
      } else if (code < len_code_limit) {
        int length = copy_distance(code - kLiterals);
        int dist_symbol = read_symbol(m.table(g, DIST), br);
        br.fill();
        int dist = plane_distance(width, copy_distance(dist_symbol));
        if (pos >= dist && end - pos >= length) {
          for (int i = 0; i < length; ++i) data[pos + i] = data[pos + i - dist];
        } else {
          return false;
        }
        pos += length;
        col += length;
        while (col >= width) {
          col -= width;
          ++row;
        }
        if (pos < end && (col & m.mask)) g = m.group_at(col, row);
      } else {
        return false;
      }
      br.eos = br.at_end();
    }
    br.eos = br.at_end();
    return !(br.eos && pos < end);
  }

  static void predictor_inverse(const Transform& t, uint32_t* px) {
    const int w = t.xsize;
    px[0] = add_pixels(px[0], 0xff000000u);
    for (int x = 1; x < w; ++x) px[x] = add_pixels(px[x], px[x - 1]);
    const int tiles_per_row = sub_sample(w, t.bits);
    for (int y = 1; y < t.ysize; ++y) {
      uint32_t* out = px + (size_t)y * w;
      const uint32_t* up = out - w;
      const uint32_t* modes =
          t.data.data() + (size_t)(y >> t.bits) * tiles_per_row;
      out[0] = add_pixels(out[0], up[0]);
      for (int x = 1; x < w; ++x) {
        int mode = (modes[x >> t.bits] >> 8) & 0xf;
        out[x] = add_pixels(out[x], predict(mode, out[x - 1], up + x));
      }
    }
  }

  static void color_inverse(const Transform& t, uint32_t* px) {
    const int w = t.xsize;
    const int tiles_per_row = sub_sample(w, t.bits);
    for (int y = 0; y < t.ysize; ++y) {
      uint32_t* row = px + (size_t)y * w;
      const uint32_t* codes =
          t.data.data() + (size_t)(y >> t.bits) * tiles_per_row;
      for (int x = 0; x < w; ++x) {
        uint32_t code = codes[x >> t.bits];
        int8_t g2r = (int8_t)(code & 0xff), g2b = (int8_t)((code >> 8) & 0xff);
        int8_t r2b = (int8_t)((code >> 16) & 0xff);
        uint32_t argb = row[x];
        int8_t green = (int8_t)(argb >> 8);
        int new_red = (argb >> 16) & 0xff, new_blue = argb & 0xff;
        new_red += color_delta(g2r, green);
        new_red &= 0xff;
        new_blue += color_delta(g2b, green);
        new_blue += color_delta(r2b, (int8_t)new_red);
        new_blue &= 0xff;
        row[x] = (argb & 0xff00ff00u) | ((uint32_t)new_red << 16) | new_blue;
      }
    }
  }

  static std::vector<uint32_t> index_inverse(const Transform& t,
                                             const uint32_t* src) {
    const int w = t.xsize;
    std::vector<uint32_t> out((size_t)w * t.ysize);
    const int bits_per_pixel = 8 >> t.bits;
    const int count_mask = (1 << t.bits) - 1;
    const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
    uint32_t* dst = out.data();
    for (int y = 0; y < t.ysize; ++y) {
      uint32_t packed = 0;
      for (int x = 0; x < w; ++x) {
        if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
        *dst++ = t.data[packed & bit_mask];
        packed >>= bits_per_pixel;
      }
    }
    return out;
  }

  // Undoes the transforms, last read first.
  void inverse_transforms(std::vector<uint32_t>& px) {
    for (int n = (int)transforms.size() - 1; n >= 0; --n) {
      const Transform& t = transforms[n];
      switch (t.type) {
        case PREDICTOR: predictor_inverse(t, px.data()); break;
        case CROSS_COLOR: color_inverse(t, px.data()); break;
        case SUBTRACT_GREEN:
          for (auto& p : px) {
            uint32_t green = (p >> 8) & 0xff;
            uint32_t rb = ((p & 0x00ff00ffu) + ((green << 16) | green)) &
                          0x00ff00ffu;
            p = (p & 0xff00ff00u) | rb;
          }
          break;
        case COLOR_INDEXING: px = index_inverse(t, px.data()); break;
      }
    }
  }

  // The main image of a VP8L bitstream (header included) as ARGB.
  std::vector<uint32_t> decode_image(const uint8_t* data, size_t size,
                                     int width, int height) {
    br.init(data, size);
    if (br.read(8) != 0x2f) fail("VP8L: a bad signature byte");
    int w = br.read(14) + 1, h = br.read(14) + 1;
    br.read(1);  // alpha hint
    if (br.read(3) != 0) fail("VP8L: an unknown version");
    if (br.eos) fail("VP8L: the data ends in its header");
    if (w != width || h != height) fail("VP8L: the header's size changed");
    Meta meta;
    int xsize;
    decode_stream(width, height, true, meta, xsize);
    std::vector<uint32_t> px((size_t)xsize * height);
    if (!decode_pixels(px.data(), xsize, height, meta))
      fail("VP8L: the image data is damaged or ends early");
    inverse_transforms(px);
    return px;
  }

  // A VP8L-coded alpha plane (no header): the green channel.
  void decode_alpha(const uint8_t* data, size_t size, int width, int height,
                    uint8_t* out) {
    br.init(data, size);
    Meta meta;
    int xsize;
    decode_stream(width, height, true, meta, xsize);
    bool eight_bit = transforms.size() == 1 &&
                     transforms[0].type == COLOR_INDEXING &&
                     meta.cache_bits == 0;
    for (size_t g = 0; eight_bit && 5 * g < meta.groups.size(); ++g)
      eight_bit = meta.table(g, RED)->bits == 0 &&
                  meta.table(g, BLUE)->bits == 0 &&
                  meta.table(g, ALPHA)->bits == 0;
    std::vector<uint32_t> px((size_t)xsize * height);
    if (eight_bit) {
      std::vector<uint8_t> idx((size_t)xsize * height);
      if (!decode_alpha_indices(idx.data(), xsize, height, meta))
        fail("ALPH: the alpha data is damaged or ends early");
      for (size_t i = 0; i < idx.size(); ++i) px[i] = (uint32_t)idx[i] << 8;
    } else if (!decode_pixels(px.data(), xsize, height, meta)) {
      fail("ALPH: the alpha data is damaged or ends early");
    }
    inverse_transforms(px);
    for (size_t i = 0; i < (size_t)width * height; ++i)
      out[i] = (uint8_t)(px[i] >> 8);
  }
};

// ----------------------------------------------------------------- VP8

// The boolean decoder as libwebp keeps it on x86-64: `range` holds the
// range less one, `value` takes 56 bits at a time while 8 bytes remain
// and then one byte at a time, and a read past the end of the data takes
// one zero byte and flags `eof`. A damaged stream can push `value` past
// its 64 bits; the loads' shifts then decide what it decodes to, so they
// are libwebp's.
struct BoolReader {
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 255 - 1;
  int eof = 0;
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  const uint8_t* buf_max = nullptr;

  void init(const uint8_t* start, size_t size) {
    buf = start;
    end = start + size;
    buf_max = size >= 8 ? start + size - 8 + 1 : start;
    value = 0;
    bits = -8;
    range = 255 - 1;
    eof = 0;
    load();
  }
  void load() {
    if (buf < buf_max) {
      uint64_t in = 0;
      for (int i = 0; i < 8; ++i) in = (in << 8) | buf[i];
      buf += 7;
      value = (in >> 8) | (value << 56);
      bits += 56;
    } else if (buf < end) {
      bits += 8;
      value = (uint64_t)(*buf++) | (value << 8);
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = 1;
    } else {
      bits = 0;
    }
  }
  int get(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    int pos = bits;
    uint32_t split = (r * (uint32_t)prob) >> 8;
    uint32_t v = (uint32_t)(value >> pos);
    int bit = v > split;
    if (bit) {
      r -= split;
      value -= (uint64_t)(split + 1) << pos;
    } else {
      r = split + 1;
    }
    int shift = 7 ^ (31 - __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }
  // A coefficient's sign (VP8GetSigned): GetBit at one half, always one
  // shift, and the bit from the sign of split - value as int32, which
  // differs from `get` only where a damaged stream has left `value` past
  // 2^31 above the range.
  int get_signed(int v) {
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = range >> 1;
    const uint32_t val = (uint32_t)(value >> pos);
    const int32_t mask = (int32_t)(split - val) >> 31;
    bits -= 1;
    range += (uint32_t)mask;
    range |= 1;
    value -= (uint64_t)((split + 1) & (uint32_t)mask) << pos;
    return (v ^ mask) - mask;
  }
  uint32_t value_bits(int n) {
    uint32_t v = 0;
    while (n-- > 0) v |= (uint32_t)get(0x80) << n;
    return v;
  }
  int signed_value(int n) {
    int v = (int)value_bits(n);
    return get(0x80) ? -v : v;
  }
};

// libwebp's mode numbers
enum {
  B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED,
  B_LD_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED,
  DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED,
  TM_PRED = B_TM_PRED
};

const uint8_t kDcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  10,  11,  12,  13,  14,  15,  16,  17,
    17,  18,  19,  20,  20,  21,  21,  22,  22,  23,  23,  24,  25,  25,  26,
    27,  28,  29,  30,  31,  32,  33,  34,  35,  36,  37,  37,  38,  39,  40,
    41,  42,  43,  44,  45,  46,  46,  47,  48,  49,  50,  51,  52,  53,  54,
    55,  56,  57,  58,  59,  60,  61,  62,  63,  64,  65,  66,  67,  68,  69,
    70,  71,  72,  73,  74,  75,  76,  76,  77,  78,  79,  80,  81,  82,  83,
    84,  85,  86,  87,  88,  89,  91,  93,  95,  96,  98,  100, 101, 102, 104,
    106, 108, 110, 112, 114, 116, 118, 122, 124, 126, 128, 130, 132, 134, 136,
    138, 140, 143, 145, 148, 151, 154, 157};

const uint16_t kAcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  11,  12,  13,  14,  15,  16,  17,  18,
    19,  20,  21,  22,  23,  24,  25,  26,  27,  28,  29,  30,  31,  32,  33,
    34,  35,  36,  37,  38,  39,  40,  41,  42,  43,  44,  45,  46,  47,  48,
    49,  50,  51,  52,  53,  54,  55,  56,  57,  58,  60,  62,  64,  66,  68,
    70,  72,  74,  76,  78,  80,  82,  84,  86,  88,  90,  92,  94,  96,  98,
    100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128, 131, 134,
    137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173, 177, 181,
    185, 189, 193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245,
    249, 254, 259, 264, 269, 274, 279, 284};

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

inline int clip(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }
inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

struct Quant {
  int y1[2], y2[2], uv[2];
};

struct FilterInfo {
  int limit = 0, ilevel = 0, inner = 0, hev_thresh = 0;
};

struct MBData {
  int16_t coeffs[384];
  uint8_t is_i4x4 = 0, imodes[16], uvmode = 0, segment = 0, skip = 0;
  // 2 bits a block, the first block highest (libwebp's non_zero_y /
  // non_zero_uv): 0 no coefficient, 1 the DC alone, 2-3 more
  uint32_t non_zero_y = 0, non_zero_uv = 0;
};

constexpr int kYStride = 21, kCStride = 9;  // work buffers, one border row
                                            // and column (+4 top-right)

// Adds the inverse DCT of a block whose only coefficient is its DC.
void transform_dc(const int16_t* in, uint8_t* dst, int stride) {
  const int dc = in[0] + 4;
  for (int y = 0; y < 4; ++y, dst += stride)
    for (int x = 0; x < 4; ++x) dst[x] = clip8(dst[x] + (dc >> 3));
}

// Adds the inverse DCT of `in` (RFC 6386 14.3) to the 4x4 block at dst.
void transform(const int16_t* in, uint8_t* dst, int stride) {
  auto mul1 = [](int a) { return ((a * 20091) >> 16) + a; };
  auto mul2 = [](int a) { return (a * 35468) >> 16; };
  int C[16], *tmp = C;
  for (int i = 0; i < 4; ++i) {
    int a = in[0] + in[8];
    int b = in[0] - in[8];
    int c = mul2(in[4]) - mul1(in[12]);
    int d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    in++;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {
    int dc = tmp[0] + 4;
    int a = dc + tmp[8];
    int b = dc - tmp[8];
    int c = mul2(tmp[4]) - mul1(tmp[12]);
    int d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
    tmp++;
    dst += stride;
  }
}

// The full inverse DCT as libwebp's x86 build runs it (Transform_SSE2):
// the same sums in 16-bit lanes, so a damaged stream's large
// coefficients wrap where the C form would not; products through
// `mulhi` with the constants less 2^16 (20091, 35468 - 65536).
void transform_x86(const int16_t* in, uint8_t* dst, int stride) {
  auto w = [](int v) { return (int)(int16_t)v; };
  auto mulhi = [](int a, int k) { return (int)(int16_t)((a * k) >> 16); };
  constexpr int k1 = 20091, k2 = 35468 - 65536;
  int t[4][4];
  for (int i = 0; i < 4; ++i) {  // vertical pass, column i
    const int i0 = in[i], i1 = in[4 + i], i2 = in[8 + i], i3 = in[12 + i];
    const int a = w(i0 + i2), b = w(i0 - i2);
    const int c = w(w(i1 - i3) + w(mulhi(i1, k2) - mulhi(i3, k1)));
    const int d = w(w(i1 + i3) + w(mulhi(i1, k1) + mulhi(i3, k2)));
    t[0][i] = w(a + d);
    t[1][i] = w(b + c);
    t[2][i] = w(b - c);
    t[3][i] = w(a - d);
  }
  for (int r = 0; r < 4; ++r, dst += stride) {  // horizontal pass, row r
    const int* T = t[r];
    const int dc = w(T[0] + 4);
    const int a = w(dc + T[2]), b = w(dc - T[2]);
    const int c = w(w(T[1] - T[3]) + w(mulhi(T[1], k2) - mulhi(T[3], k1)));
    const int d = w(w(T[1] + T[3]) + w(mulhi(T[1], k1) + mulhi(T[3], k2)));
    dst[0] = clip8(dst[0] + (w(a + d) >> 3));
    dst[1] = clip8(dst[1] + (w(b + c) >> 3));
    dst[2] = clip8(dst[2] + (w(b - c) >> 3));
    dst[3] = clip8(dst[3] + (w(a - d) >> 3));
  }
}

// A luma block's residual by its non-zero code, as libwebp's DoTransform
// picks the routine: none; the DC alone and the first-row-and-column
// shortcut (AC3) in int arithmetic, whose sums equal the full transform's;
// the full transform in 16-bit lanes.
inline void add_residual(uint32_t code, const int16_t* in, uint8_t* dst,
                         int stride) {
  if (code == 3)
    transform_x86(in, dst, stride);
  else if (code == 2)
    transform(in, dst, stride);
  else if (code == 1)
    transform_dc(in, dst, stride);
}

// A chroma plane's four blocks (DoUVTransform): each through the full
// transform when any of them has an AC coefficient, else each with a
// non-zero DC through the DC shortcut.
inline void add_residual_uv(uint32_t bits, const int16_t* in, uint8_t* dst,
                            int stride) {
  if (!(bits & 0xff)) return;
  for (int n = 0; n < 4; ++n) {
    uint8_t* d = dst + (n & 1) * 4 + (n >> 1) * 4 * stride;
    if (bits & 0xaa)
      transform_x86(in + 16 * n, d, stride);
    else if (in[16 * n])
      transform_dc(in + 16 * n, d, stride);
  }
}

// The inverse Walsh-Hadamard transform of the Y2 block: the DC of each
// of the 16 luma blocks.
void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    int a0 = in[0 + i] + in[12 + i];
    int a1 = in[4 + i] + in[8 + i];
    int a2 = in[4 + i] - in[8 + i];
    int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    int dc = tmp[0 + i * 4] + 3;
    int a0 = dc + tmp[3 + i * 4];
    int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    int a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

#define AVG3(a, b, c) ((uint8_t)(((a) + 2 * (b) + (c) + 2) >> 2))
#define AVG2(a, b) (((a) + (b) + 1) >> 1)
#define DST(x, y) dst[(x) + (y) * s]

// 4x4 luma prediction into dst (stride s), from dst's upper row (with 4
// more to the right) and left column.
void predict4(int mode, uint8_t* dst, int s) {
  const uint8_t* top = dst - s;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  const int I = dst[-1], J = dst[-1 + s], K = dst[-1 + 2 * s];
  const int L = dst[-1 + 3 * s];
  switch (mode) {
    case B_DC_PRED: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * s];
      dc >>= 3;
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) DST(x, y) = (uint8_t)dc;
      break;
    }
    case B_TM_PRED:
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x)
          DST(x, y) = clip8(top[x] + dst[-1 + y * s] - X);
      break;
    case B_VE_PRED: {
      const uint8_t v[4] = {AVG3(X, A, B), AVG3(A, B, C), AVG3(B, C, D),
                            AVG3(C, D, E)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) DST(x, y) = v[x];
      break;
    }
    case B_HE_PRED: {
      const uint8_t v[4] = {AVG3(X, I, J), AVG3(I, J, K), AVG3(J, K, L),
                            AVG3(K, L, L)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) DST(x, y) = v[y];
      break;
    }
    case B_RD_PRED:
      DST(0, 3) = AVG3(J, K, L);
      DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
      DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
      DST(3, 0) = AVG3(D, C, B);
      break;
    case B_LD_PRED:
      DST(0, 0) = AVG3(A, B, C);
      DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
      DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
      DST(3, 3) = AVG3(G, H, H);
      break;
    case B_VR_PRED:
      DST(0, 0) = DST(1, 2) = AVG2(X, A);
      DST(1, 0) = DST(2, 2) = AVG2(A, B);
      DST(2, 0) = DST(3, 2) = AVG2(B, C);
      DST(3, 0) = AVG2(C, D);
      DST(0, 3) = AVG3(K, J, I);
      DST(0, 2) = AVG3(J, I, X);
      DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
      DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
      DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
      DST(3, 1) = AVG3(B, C, D);
      break;
    case B_VL_PRED:
      DST(0, 0) = AVG2(A, B);
      DST(1, 0) = DST(0, 2) = AVG2(B, C);
      DST(2, 0) = DST(1, 2) = AVG2(C, D);
      DST(3, 0) = DST(2, 2) = AVG2(D, E);
      DST(0, 1) = AVG3(A, B, C);
      DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
      DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
      DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
      DST(3, 2) = AVG3(E, F, G);
      DST(3, 3) = AVG3(F, G, H);
      break;
    case B_HD_PRED:
      DST(0, 0) = DST(2, 1) = AVG2(I, X);
      DST(0, 1) = DST(2, 2) = AVG2(J, I);
      DST(0, 2) = DST(2, 3) = AVG2(K, J);
      DST(0, 3) = AVG2(L, K);
      DST(3, 0) = AVG3(A, B, C);
      DST(2, 0) = AVG3(X, A, B);
      DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
      DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
      DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
      DST(1, 3) = AVG3(L, K, J);
      break;
    case B_HU_PRED:
      DST(0, 0) = AVG2(I, J);
      DST(2, 0) = DST(0, 1) = AVG2(J, K);
      DST(2, 1) = DST(0, 2) = AVG2(K, L);
      DST(1, 0) = AVG3(I, J, K);
      DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
      DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) =
          DST(3, 3) = (uint8_t)L;
      break;
  }
}

// 16x16 luma or 8x8 chroma prediction (size n) for a macroblock at
// (mb_x, mb_y): DC without its missing neighbours, TM, V, H.
void predict_block(int mode, uint8_t* dst, int s, int n, int mb_x, int mb_y) {
  const uint8_t* top = dst - s;
  if (mode == DC_PRED) {
    int shift = n == 16 ? 4 : 3, dc;
    if (mb_x > 0 && mb_y > 0) {
      dc = n;
      for (int i = 0; i < n; ++i) dc += top[i] + dst[-1 + i * s];
      dc >>= shift + 1;
    } else if (mb_y > 0) {  // no left
      dc = n / 2;
      for (int i = 0; i < n; ++i) dc += top[i];
      dc >>= shift;
    } else if (mb_x > 0) {  // no top
      dc = n / 2;
      for (int i = 0; i < n; ++i) dc += dst[-1 + i * s];
      dc >>= shift;
    } else {
      dc = 0x80;
    }
    for (int y = 0; y < n; ++y) std::memset(dst + y * s, dc, n);
  } else if (mode == TM_PRED) {
    for (int y = 0; y < n; ++y)
      for (int x = 0; x < n; ++x)
        dst[x + y * s] = clip8(top[x] + dst[-1 + y * s] - top[-1]);
  } else if (mode == V_PRED) {
    for (int y = 0; y < n; ++y) std::memcpy(dst + y * s, top, n);
  } else {  // H_PRED
    for (int y = 0; y < n; ++y) std::memset(dst + y * s, dst[-1 + y * s], n);
  }
}

// ---- loop filters (RFC 6386 15; dsp/dec.c)

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
         std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
         std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// `hstride` across the edge, `vstride` along it, `size` pixels.
void simple_edge(uint8_t* p, int hstride, int vstride, int size, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride)
    if (needs_filter(p, hstride, thresh2)) do_filter2(p, hstride);
}

void normal_edge(uint8_t* p, int hstride, int vstride, int size, int thresh,
                 int ithresh, int hev_thresh, bool macroblock_edge) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (!needs_filter2(p, hstride, thresh2, ithresh)) continue;
    if (hev(p, hstride, hev_thresh))
      do_filter2(p, hstride);
    else if (macroblock_edge)
      do_filter6(p, hstride);
    else
      do_filter4(p, hstride);
  }
}

struct VP8 {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  BoolReader br;
  BoolReader parts[8];
  int num_parts_minus_one = 0;
  int use_segment = 0, update_map = 0, absolute_delta = 1;
  int quantizer[4] = {0}, filter_strength[4] = {0};
  int seg_proba[3] = {255, 255, 255};
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
  int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
  int filter_type = 0;
  Quant dqm[4];
  uint8_t proba[4][8][3][11];
  int use_skip_proba = 0, skip_p = 0;
  FilterInfo fstrengths[4][2];

  void headers(const uint8_t* buf, size_t size) {
    if (size < 4) fail("VP8: truncated header");
    const uint32_t bits = buf[0] | (buf[1] << 8) | (buf[2] << 16);
    const int key_frame = !(bits & 1);
    const int profile = (bits >> 1) & 7;
    const int show = (bits >> 4) & 1;
    const uint32_t partition_length = bits >> 5;
    if (profile > 3) fail("VP8: incorrect keyframe parameters");
    if (!show) fail("VP8: frame not displayable");
    buf += 3;
    size -= 3;
    if (!key_frame) fail("VP8: not a key frame");
    if (size < 7) fail("VP8: cannot parse picture header");
    if (buf[0] != 0x9d || buf[1] != 0x01 || buf[2] != 0x2a)
      fail("VP8: bad code word");
    width = ((buf[4] << 8) | buf[3]) & 0x3fff;
    height = ((buf[6] << 8) | buf[5]) & 0x3fff;
    buf += 7;
    size -= 7;
    mb_w = (width + 15) >> 4;
    mb_h = (height + 15) >> 4;
    if (partition_length > size) fail("VP8: bad partition length");
    br.init(buf, partition_length);
    buf += partition_length;
    size -= partition_length;
    br.get(0x80);  // colour space
    br.get(0x80);  // clamping type
    // segment header
    use_segment = br.get(0x80);
    if (use_segment) {
      update_map = br.get(0x80);
      if (br.get(0x80)) {
        absolute_delta = br.get(0x80);
        for (int s = 0; s < 4; ++s)
          quantizer[s] = br.get(0x80) ? br.signed_value(7) : 0;
        for (int s = 0; s < 4; ++s)
          filter_strength[s] = br.get(0x80) ? br.signed_value(6) : 0;
      }
      if (update_map)
        for (int s = 0; s < 3; ++s)
          seg_proba[s] = br.get(0x80) ? (int)br.value_bits(8) : 255;
    } else {
      update_map = 0;
    }
    if (br.eof) fail("VP8: cannot parse segment header");
    // filter header
    simple = br.get(0x80);
    level = br.value_bits(6);
    sharpness = br.value_bits(3);
    use_lf_delta = br.get(0x80);
    if (use_lf_delta && br.get(0x80)) {
      for (int i = 0; i < 4; ++i)
        if (br.get(0x80)) ref_lf_delta[i] = br.signed_value(6);
      for (int i = 0; i < 4; ++i)
        if (br.get(0x80)) mode_lf_delta[i] = br.signed_value(6);
    }
    filter_type = level == 0 ? 0 : simple ? 1 : 2;
    if (br.eof) fail("VP8: cannot parse filter header");
    // partitions
    {
      const uint8_t* sz = buf;
      const uint8_t* buf_end = buf + size;
      num_parts_minus_one = (1 << br.value_bits(2)) - 1;
      size_t last_part = num_parts_minus_one;
      if (size < 3 * last_part) fail("VP8: cannot parse partitions");
      const uint8_t* part_start = buf + last_part * 3;
      size_t size_left = size - last_part * 3;
      for (size_t p = 0; p < last_part; ++p) {
        size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
        if (psize > size_left) psize = size_left;
        parts[p].init(part_start, psize);
        part_start += psize;
        size_left -= psize;
        sz += 3;
      }
      parts[last_part].init(part_start, size_left);
      if (part_start >= buf_end) fail("VP8: cannot parse partitions");
    }
    // quantisers
    {
      const int base_q0 = br.value_bits(7);
      const int dqy1_dc = br.get(0x80) ? br.signed_value(4) : 0;
      const int dqy2_dc = br.get(0x80) ? br.signed_value(4) : 0;
      const int dqy2_ac = br.get(0x80) ? br.signed_value(4) : 0;
      const int dquv_dc = br.get(0x80) ? br.signed_value(4) : 0;
      const int dquv_ac = br.get(0x80) ? br.signed_value(4) : 0;
      for (int i = 0; i < 4; ++i) {
        int q;
        if (use_segment) {
          q = quantizer[i];
          if (!absolute_delta) q += base_q0;
        } else {
          if (i > 0) {
            dqm[i] = dqm[0];
            continue;
          }
          q = base_q0;
        }
        Quant& m = dqm[i];
        m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
        m.y1[1] = kAcTable[clip(q + 0, 127)];
        m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
        m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
        if (m.y2[1] < 8) m.y2[1] = 8;
        m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
        m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
      }
    }
    br.get(0x80);  // update_proba, ignored
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p)
            proba[t][b][c][p] = br.get(kCoeffUpdate[t][b][c][p])
                                    ? (uint8_t)br.value_bits(8)
                                    : kCoeffProba0[t][b][c][p];
    use_skip_proba = br.get(0x80);
    if (use_skip_proba) skip_p = br.value_bits(8);
  }

  void filter_strengths() {
    for (int s = 0; s < 4; ++s) {
      int base_level;
      if (use_segment) {
        base_level = filter_strength[s];
        if (!absolute_delta) base_level += level;
      } else {
        base_level = level;
      }
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FilterInfo& info = fstrengths[s][i4x4];
        int lvl = base_level;
        if (use_lf_delta) {
          lvl += ref_lf_delta[0];
          if (i4x4) lvl += mode_lf_delta[0];
        }
        lvl = lvl < 0 ? 0 : lvl > 63 ? 63 : lvl;
        if (lvl > 0) {
          int ilevel = lvl;
          if (sharpness > 0) {
            ilevel >>= sharpness > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = ilevel;
          info.limit = 2 * lvl + ilevel;
          info.hev_thresh = lvl >= 40 ? 2 : lvl >= 15 ? 1 : 0;
        } else {
          info.limit = 0;
        }
        info.inner = i4x4;
      }
    }
  }

  void parse_intra_mode(MBData& block, uint8_t* top, uint8_t* left) {
    if (update_map)
      block.segment = !br.get(seg_proba[0]) ? br.get(seg_proba[1])
                                            : br.get(seg_proba[2]) + 2;
    else
      block.segment = 0;
    if (use_skip_proba) block.skip = br.get(skip_p);
    block.is_i4x4 = !br.get(145);
    if (!block.is_i4x4) {
      const int ymode = br.get(156) ? (br.get(128) ? TM_PRED : H_PRED)
                                    : (br.get(163) ? V_PRED : DC_PRED);
      block.imodes[0] = ymode;
      std::memset(top, ymode, 4);
      std::memset(left, ymode, 4);
    } else {
      uint8_t* modes = block.imodes;
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* prob = kBModeProba[top[x]][ymode];
          ymode = !br.get(prob[0])   ? B_DC_PRED
                  : !br.get(prob[1]) ? B_TM_PRED
                  : !br.get(prob[2]) ? B_VE_PRED
                  : !br.get(prob[3])
                      ? (!br.get(prob[4]) ? B_HE_PRED
                         : !br.get(prob[5]) ? B_RD_PRED : B_VR_PRED)
                      : (!br.get(prob[6]) ? B_LD_PRED
                         : !br.get(prob[7]) ? B_VL_PRED
                         : !br.get(prob[8]) ? B_HD_PRED : B_HU_PRED);
          top[x] = (uint8_t)ymode;
        }
        std::memcpy(modes, top, 4);
        modes += 4;
        left[y] = (uint8_t)ymode;
      }
    }
    block.uvmode = !br.get(142)   ? DC_PRED
                   : !br.get(114) ? V_PRED
                   : br.get(183)  ? TM_PRED : H_PRED;
  }

  int large_value(BoolReader& tbr, const uint8_t* p) {
    int v;
    if (!tbr.get(p[3])) {
      if (!tbr.get(p[4]))
        v = 2;
      else
        v = 3 + tbr.get(p[5]);
    } else {
      if (!tbr.get(p[6])) {
        if (!tbr.get(p[7])) {
          v = 5 + tbr.get(159);
        } else {
          v = 7 + 2 * tbr.get(165);
          v += tbr.get(145);
        }
      } else {
        const int bit1 = tbr.get(p[8]);
        const int bit0 = tbr.get(p[9 + bit1]);
        const int cat = 2 * bit1 + bit0;
        v = 0;
        for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab)
          v += v + tbr.get(*tab);
        v += 3 + (8 << cat);
      }
    }
    return v;
  }

  // One block's tokens from position n (GetCoeffs); returns the position
  // after the last token read, as libwebp counts it.
  int coeffs(BoolReader& tbr, int type, int ctx, const int* dq, int n,
             int16_t* out) {
    const uint8_t* p = proba[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!tbr.get(p[0])) return n;
      while (!tbr.get(p[1])) {
        p = proba[type][kBands[++n]][0];
        if (n == 16) return 16;
      }
      int v, next_ctx;
      if (!tbr.get(p[2])) {
        v = 1;
        next_ctx = 1;
      } else {
        v = large_value(tbr, p);
        next_ctx = 2;
      }
      p = proba[type][kBands[n + 1]][next_ctx];
      out[kZigzag[n]] = (int16_t)(tbr.get_signed(v) * dq[n > 0]);
    }
    return 16;
  }

  // ParseResiduals; returns whether the macroblock has no non-zero
  // coefficients (the filter's skip).
  bool residuals(BoolReader& tbr, MBData& block, uint8_t& top_nz,
                 uint8_t& top_nz_dc, uint8_t& left_nz, uint8_t& left_nz_dc) {
    const Quant& q = dqm[block.segment];
    int16_t* dst = block.coeffs;
    std::memset(dst, 0, sizeof(block.coeffs));
    uint32_t non_zero_y = 0, non_zero_uv = 0;
    int first, ac_type;
    auto nz_code = [](uint32_t bits, int nz, int dc_nz) {
      bits <<= 2;
      bits |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
      return bits;
    };
    if (!block.is_i4x4) {
      int16_t dc[16] = {0};
      const int ctx = top_nz_dc + left_nz_dc;
      const int nz = coeffs(tbr, 1, ctx, q.y2, 0, dc);
      top_nz_dc = left_nz_dc = (nz > 0);
      transform_wht(dc, dst);
      first = 1;
      ac_type = 0;
    } else {
      first = 0;
      ac_type = 3;
    }
    uint8_t tnz = top_nz & 0x0f, lnz = left_nz & 0x0f;
    for (int y = 0; y < 4; ++y) {
      int l = lnz & 1;
      uint32_t nz_coeffs = 0;
      for (int x = 0; x < 4; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = coeffs(tbr, ac_type, ctx, q.y1, first, dst);
        l = (nz > first);
        tnz = (tnz >> 1) | (l << 7);
        nz_coeffs = nz_code(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 4;
      lnz = (lnz >> 1) | (l << 7);
      non_zero_y = (non_zero_y << 8) | nz_coeffs;
    }
    uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      uint32_t nz_coeffs = 0;
      tnz = top_nz >> (4 + ch);
      lnz = left_nz >> (4 + ch);
      for (int y = 0; y < 2; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x) {
          const int ctx = l + (tnz & 1);
          const int nz = coeffs(tbr, 2, ctx, q.uv, 0, dst);
          l = (nz > 0);
          tnz = (tnz >> 1) | (l << 3);
          nz_coeffs = nz_code(nz_coeffs, nz, dst[0] != 0);
          dst += 16;
        }
        tnz >>= 2;
        lnz = (lnz >> 1) | (l << 5);
      }
      non_zero_uv |= nz_coeffs << (4 * ch);
      out_t_nz |= (tnz << 4) << ch;
      out_l_nz |= (lnz & 0xf0) << ch;
    }
    top_nz = (uint8_t)out_t_nz;
    left_nz = (uint8_t)out_l_nz;
    block.non_zero_y = non_zero_y;
    block.non_zero_uv = non_zero_uv;
    return !(non_zero_y | non_zero_uv);
  }

  void filter_mb(uint8_t* Y, uint8_t* U, uint8_t* V, int ys, int cs,
                 const FilterInfo& f, int mb_x, int mb_y) {
    const int limit = f.limit;
    if (limit == 0) return;
    uint8_t* y_dst = Y + (size_t)mb_y * 16 * ys + mb_x * 16;
    if (filter_type == 1) {
      if (mb_x > 0) simple_edge(y_dst, 1, ys, 16, limit + 4);
      if (f.inner)
        for (int k = 4; k < 16; k += 4) simple_edge(y_dst + k, 1, ys, 16, limit);
      if (mb_y > 0) simple_edge(y_dst, ys, 1, 16, limit + 4);
      if (f.inner)
        for (int k = 4; k < 16; k += 4)
          simple_edge(y_dst + k * ys, ys, 1, 16, limit);
      return;
    }
    uint8_t* u_dst = U + (size_t)mb_y * 8 * cs + mb_x * 8;
    uint8_t* v_dst = V + (size_t)mb_y * 8 * cs + mb_x * 8;
    const int il = f.ilevel, ht = f.hev_thresh;
    if (mb_x > 0) {
      normal_edge(y_dst, 1, ys, 16, limit + 4, il, ht, true);
      normal_edge(u_dst, 1, cs, 8, limit + 4, il, ht, true);
      normal_edge(v_dst, 1, cs, 8, limit + 4, il, ht, true);
    }
    if (f.inner) {
      for (int k = 4; k < 16; k += 4)
        normal_edge(y_dst + k, 1, ys, 16, limit, il, ht, false);
      normal_edge(u_dst + 4, 1, cs, 8, limit, il, ht, false);
      normal_edge(v_dst + 4, 1, cs, 8, limit, il, ht, false);
    }
    if (mb_y > 0) {
      normal_edge(y_dst, ys, 1, 16, limit + 4, il, ht, true);
      normal_edge(u_dst, cs, 1, 8, limit + 4, il, ht, true);
      normal_edge(v_dst, cs, 1, 8, limit + 4, il, ht, true);
    }
    if (f.inner) {
      for (int k = 4; k < 16; k += 4)
        normal_edge(y_dst + k * ys, ys, 1, 16, limit, il, ht, false);
      normal_edge(u_dst + 4 * cs, cs, 1, 8, limit, il, ht, false);
      normal_edge(v_dst + 4 * cs, cs, 1, 8, limit, il, ht, false);
    }
  }

  // Decodes the frame into Y (mb_w*16 wide), U and V (mb_w*8 wide).
  void decode(std::vector<uint8_t>& Y, std::vector<uint8_t>& U,
              std::vector<uint8_t>& V) {
    const int ys = mb_w * 16, cs = mb_w * 8;
    Y.assign((size_t)ys * mb_h * 16, 0);
    U.assign((size_t)cs * mb_h * 8, 0);
    V.assign((size_t)cs * mb_h * 8, 0);
    filter_strengths();
    std::vector<uint8_t> intra_t(4 * mb_w, B_DC_PRED);
    std::vector<uint8_t> nz_top(mb_w, 0), nz_dc_top(mb_w, 0);
    std::vector<uint8_t> top_y(ys), top_u(cs), top_v(cs);
    std::vector<MBData> blocks(mb_w);
    std::vector<FilterInfo> finfo(mb_w);
    uint8_t ybuf[17 * kYStride], ubuf[9 * kCStride], vbuf[9 * kCStride];
    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
      BoolReader& tbr = parts[mb_y & num_parts_minus_one];
      uint8_t intra_l[4] = {B_DC_PRED, B_DC_PRED, B_DC_PRED, B_DC_PRED};
      for (int mb_x = 0; mb_x < mb_w; ++mb_x)
        parse_intra_mode(blocks[mb_x], &intra_t[4 * mb_x], intra_l);
      if (br.eof) fail("VP8: premature end of partition 0");
      uint8_t left_nz = 0, left_nz_dc = 0;
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        MBData& block = blocks[mb_x];
        int skip = use_skip_proba ? block.skip : 0;
        if (!skip) {
          skip = residuals(tbr, block, nz_top[mb_x], nz_dc_top[mb_x], left_nz,
                           left_nz_dc);
        } else {
          left_nz = nz_top[mb_x] = 0;
          if (!block.is_i4x4) left_nz_dc = nz_dc_top[mb_x] = 0;
          block.non_zero_y = block.non_zero_uv = 0;
        }
        if (filter_type > 0) {
          finfo[mb_x] = fstrengths[block.segment][block.is_i4x4];
          finfo[mb_x].inner |= !skip;
        }
        if (tbr.eof) fail("VP8: premature end of file");
      }
      // reconstruct the row from the unfiltered samples around it
      uint8_t* y0 = ybuf + kYStride + 1;
      uint8_t* u0 = ubuf + kCStride + 1;
      uint8_t* v0 = vbuf + kCStride + 1;
      for (int j = 0; j < 16; ++j) y0[j * kYStride - 1] = 129;
      for (int j = 0; j < 8; ++j) u0[j * kCStride - 1] = v0[j * kCStride - 1] = 129;
      if (mb_y > 0) {
        y0[-1 - kYStride] = u0[-1 - kCStride] = v0[-1 - kCStride] = 129;
      } else {
        std::memset(y0 - kYStride - 1, 127, 16 + 4 + 1);
        std::memset(u0 - kCStride - 1, 127, 8 + 1);
        std::memset(v0 - kCStride - 1, 127, 8 + 1);
      }
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        const MBData& block = blocks[mb_x];
        if (mb_x > 0) {  // the previous block's right columns move left
          for (int j = -1; j < 16; ++j) y0[j * kYStride - 1] = y0[j * kYStride + 15];
          for (int j = -1; j < 8; ++j) {
            u0[j * kCStride - 1] = u0[j * kCStride + 7];
            v0[j * kCStride - 1] = v0[j * kCStride + 7];
          }
        }
        if (mb_y > 0) {
          std::memcpy(y0 - kYStride, &top_y[mb_x * 16], 16);
          std::memcpy(u0 - kCStride, &top_u[mb_x * 8], 8);
          std::memcpy(v0 - kCStride, &top_v[mb_x * 8], 8);
        }
        const int16_t* coeffs = block.coeffs;
        if (block.is_i4x4) {
          uint8_t* top_right = y0 - kYStride + 16;
          if (mb_y > 0) {
            if (mb_x >= mb_w - 1)
              std::memset(top_right, top_y[mb_x * 16 + 15], 4);
            else
              std::memcpy(top_right, &top_y[(mb_x + 1) * 16], 4);
          }
          for (int k = 1; k <= 3; ++k)
            std::memcpy(top_right + 4 * k * kYStride, top_right, 4);
          uint32_t bits = block.non_zero_y;
          for (int n = 0; n < 16; ++n, bits <<= 2) {
            uint8_t* dst = y0 + (n & 3) * 4 + (n >> 2) * 4 * kYStride;
            predict4(block.imodes[n], dst, kYStride);
            add_residual(bits >> 30, coeffs + n * 16, dst, kYStride);
          }
        } else {
          predict_block(block.imodes[0], y0, kYStride, 16, mb_x, mb_y);
          uint32_t bits = block.non_zero_y;
          for (int n = 0; n < 16; ++n, bits <<= 2)
            add_residual(bits >> 30, coeffs + n * 16,
                         y0 + (n & 3) * 4 + (n >> 2) * 4 * kYStride, kYStride);
        }
        predict_block(block.uvmode, u0, kCStride, 8, mb_x, mb_y);
        predict_block(block.uvmode, v0, kCStride, 8, mb_x, mb_y);
        add_residual_uv(block.non_zero_uv, coeffs + 256, u0, kCStride);
        add_residual_uv(block.non_zero_uv >> 8, coeffs + 320, v0, kCStride);
        // the top samples for the next row, before any filtering
        std::memcpy(&top_y[mb_x * 16], y0 + 15 * kYStride, 16);
        std::memcpy(&top_u[mb_x * 8], u0 + 7 * kCStride, 8);
        std::memcpy(&top_v[mb_x * 8], v0 + 7 * kCStride, 8);
        for (int j = 0; j < 16; ++j)
          std::memcpy(&Y[(size_t)(mb_y * 16 + j) * ys + mb_x * 16],
                      y0 + j * kYStride, 16);
        for (int j = 0; j < 8; ++j) {
          std::memcpy(&U[(size_t)(mb_y * 8 + j) * cs + mb_x * 8],
                      u0 + j * kCStride, 8);
          std::memcpy(&V[(size_t)(mb_y * 8 + j) * cs + mb_x * 8],
                      v0 + j * kCStride, 8);
        }
      }
      if (filter_type > 0)
        for (int mb_x = 0; mb_x < mb_w; ++mb_x)
          filter_mb(Y.data(), U.data(), V.data(), ys, cs, finfo[mb_x], mb_x,
                    mb_y);
    }
  }
};

// ------------------------------------------------------- output stage

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline int yuv_clip8(int v) {
  return ((v & ~16383) == 0) ? (v >> 6) : (v < 0) ? 0 : 255;
}
inline int yuv_to_r(int y, int v) {
  return yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
}
inline int yuv_to_g(int y, int u, int v) {
  return yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) +
                   8708);
}
inline int yuv_to_b(int y, int u) {
  return yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// One row of fancy-upsampled chroma (width w) from the chroma row nearest
// to it and the one beyond (upsampling.c's UpsampleRgbLinePair, whose
// top and bottom rows share this form).
void upsample_row(const uint8_t* near, const uint8_t* far, int w,
                  uint8_t* out) {
  out[0] = (uint8_t)((3 * near[0] + far[0] + 2) >> 2);
  const int last_pair = (w - 1) >> 1;
  for (int x = 1; x <= last_pair; ++x) {
    const int a = near[x - 1], b = near[x], c = far[x - 1], d = far[x];
    const int avg = a + b + c + d + 8;
    const int diag_12 = (avg + 2 * (b + c)) >> 3;
    const int diag_03 = (avg + 2 * (a + d)) >> 3;
    out[2 * x - 1] = (uint8_t)((diag_12 + a) >> 1);
    out[2 * x] = (uint8_t)((diag_03 + b) >> 1);
  }
  if (!(w & 1))
    out[w - 1] =
        (uint8_t)((3 * near[last_pair] + far[last_pair] + 2) >> 2);
}

// YUV 4:2:0 planes -> BGR / BGRA rows (alpha from `alpha`, else 255).
void emit_bgr(const uint8_t* Y, const uint8_t* U, const uint8_t* V, int ys,
              int cs, int width, int height, const uint8_t* alpha,
              int channels, uint8_t* out, long stride) {
  const int uv_h = (height + 1) / 2;
  std::vector<uint8_t> u(width), v(width);
  for (int r = 0; r < height; ++r) {
    int near = (r & 1) ? (r - 1) >> 1 : r >> 1;
    int far = (r & 1) ? near + 1 : near - 1;
    far = far < 0 ? 0 : far >= uv_h ? uv_h - 1 : far;
    upsample_row(U + (size_t)near * cs, U + (size_t)far * cs, width, u.data());
    upsample_row(V + (size_t)near * cs, V + (size_t)far * cs, width, v.data());
    const uint8_t* yrow = Y + (size_t)r * ys;
    uint8_t* o = out + (size_t)r * stride;
    for (int x = 0; x < width; ++x, o += channels) {
      o[0] = (uint8_t)yuv_to_b(yrow[x], u[x]);
      o[1] = (uint8_t)yuv_to_g(yrow[x], u[x], v[x]);
      o[2] = (uint8_t)yuv_to_r(yrow[x], v[x]);
      if (channels == 4) o[3] = alpha ? alpha[(size_t)r * width + x] : 255;
    }
  }
}

// ------------------------------------------------------------- ALPH

void unfilter(int method, uint8_t* a, int width, int height) {
  if (method == 0) return;
  for (int y = 0; y < height; ++y) {
    uint8_t* out = a + (size_t)y * width;
    const uint8_t* prev = y > 0 ? out - width : nullptr;
    if (method == 1 || !prev) {  // horizontal; the first row of all
      uint8_t pred = prev ? prev[0] : 0;
      for (int i = 0; i < width; ++i) pred = out[i] = (uint8_t)(pred + out[i]);
    } else if (method == 2) {
      for (int i = 0; i < width; ++i) out[i] = (uint8_t)(prev[i] + out[i]);
    } else {  // gradient
      uint8_t top = prev[0], top_left = top, left = top;
      for (int i = 0; i < width; ++i) {
        top = prev[i];
        const int g = left + top - top_left;
        const int pred = ((g & ~0xff) == 0) ? g : (g < 0) ? 0 : 255;
        left = (uint8_t)(out[i] + pred);
        top_left = top;
        out[i] = left;
      }
    }
  }
}

std::vector<uint8_t> decode_alph(const uint8_t* data, size_t size, int width,
                                 int height) {
  if (size <= 1) fail("ALPH: an empty alpha chunk");
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3;
  const int pre_processing = (data[0] >> 4) & 3, reserved = (data[0] >> 6) & 3;
  if (method > 1 || pre_processing > 1 || reserved != 0)
    fail("ALPH: an unknown compression, pre-processing or reserved bits");
  std::vector<uint8_t> a((size_t)width * height);
  if (method == 0) {
    if (size - 1 < a.size()) fail("ALPH: the raw alpha data ends early");
    std::memcpy(a.data(), data + 1, a.size());
  } else {
    Lossless l;
    l.decode_alpha(data + 1, size - 1, width, height, a.data());
  }
  unfilter(filter, a.data(), width, height);
  return a;
}

}  // namespace

// Decodes one WebP bitstream into `out` (height rows of width BGR or BGRA
// pixels, `stride` bytes apart): VP8L from its signature byte, or VP8
// from its frame tag, `size` bytes to the end of the data; `alpha` the
// ALPH chunk's payload for VP8 (or null). Returns 0, or 1 with the reason
// in `err`.
extern "C" int hrf_webp_decode(const uint8_t* data, long size, int lossless,
                               const uint8_t* alpha, long alpha_size,
                               int width, int height, int channels,
                               uint8_t* out, long stride, char* err,
                               int errlen) {
  try {
    if (lossless) {
      Lossless l;
      std::vector<uint32_t> px = l.decode_image(data, size, width, height);
      for (int y = 0; y < height; ++y) {
        const uint32_t* s = px.data() + (size_t)y * width;
        uint8_t* o = out + (size_t)y * stride;
        for (int x = 0; x < width; ++x, o += channels) {
          const uint32_t p = s[x];
          o[0] = (uint8_t)p;
          o[1] = (uint8_t)(p >> 8);
          o[2] = (uint8_t)(p >> 16);
          if (channels == 4) o[3] = (uint8_t)(p >> 24);
        }
      }
      return 0;
    }
    VP8 dec;
    dec.headers(data, size);
    if (dec.width != width || dec.height != height)
      fail("VP8: the frame header's size changed");
    std::vector<uint8_t> Y, U, V;
    dec.decode(Y, U, V);
    std::vector<uint8_t> a;
    if (alpha) a = decode_alph(alpha, alpha_size, width, height);
    emit_bgr(Y.data(), U.data(), V.data(), dec.mb_w * 16, dec.mb_w * 8, width,
             height, alpha ? a.data() : nullptr, channels, out, stride);
    return 0;
  } catch (const Error& e) {
    return report(e.what(), err, errlen);
  } catch (const std::bad_alloc&) {
    return report("out of memory", err, errlen);
  }
}
