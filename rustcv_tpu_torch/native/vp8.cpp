// The lossy WebP decode: a VP8 key frame (RFC 6386) to RGBA, as libwebp's
// default WebPDecode gives it (fancy 4:2:0 upsampling, its fixed-point
// YUV -> RGB), with the ALPH plane (vp8l.cpp) in the alpha channel.
//
// The bitstream is normative: the boolean decoder, the header, the
// segmentation, the token partitions, the coefficient probabilities and
// their updates, intra prediction, dequantization, the inverse WHT and DCT
// and the simple and normal loop filters all give the bytes every
// conforming decoder gives. The decoder reconstructs the whole frame first
// (intra prediction reads the unfiltered neighbours, as libwebp does) and
// then filters it in macroblock raster order: left edge, inner vertical
// edges, top edge, inner horizontal edges, as libwebp's DoFilter does per
// macroblock. What is libwebp's own follows it: the frame filter is off
// where the frame's level is 0, inner edges are skipped where a macroblock
// has no non-zero coefficient (16x16 prediction) or was skipped, the
// upsampler (dsp/upsampling.c) and the YUV -> RGB arithmetic (dsp/yuv.h).
//
// A corrupt or truncated stream returns a negative code; the decoder never
// reads or writes out of bounds.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

extern "C" int rcv_webp_alpha_decode(const uint8_t* data, long size, int width, int height,
                                     uint8_t* out);

namespace {

enum { kOk = 0, kBadHeader = -1, kTruncated = -2, kBadAlpha = -3, kUnsupported = -4,
       kNoMemory = -5 };

// -- the boolean decoder (libwebp's VP8BitReader, one byte at a time) --------

struct BoolReader {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  uint32_t range = 254;  // range - 1
  int bits = -8;
  int eof = 0;

  void init(const uint8_t* b, size_t n) {
    buf = b;
    end = b + n;
    value = 0;
    range = 254;
    bits = -8;
    eof = 0;
    load();
  }
  void load() {
    if (buf < end) {
      bits += 8;
      value = (value << 8) | *buf++;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = 1;
    } else {
      bits = 0;
    }
  }
  int bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * (uint32_t)prob) >> 8;
    const uint32_t v = (uint32_t)(value >> pos);
    const int b = v > split;
    if (b) {
      r -= split;
      value -= (uint64_t)(split + 1) << pos;
    } else {
      r = split + 1;
    }
    const int shift = 7 ^ (31 - __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return b;
  }
  int sign(int v) {  // VP8GetSigned
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = range >> 1;
    const uint32_t val = (uint32_t)(value >> pos);
    const int32_t mask = (int32_t)(split - val) >> 31;  // -1 or 0
    bits -= 1;
    range += (uint32_t)mask;
    range |= 1;
    value -= (uint64_t)((split + 1) & (uint32_t)mask) << pos;
    return (v ^ mask) - mask;
  }
  uint32_t value_bits(int n) {
    uint32_t v = 0;
    while (n-- > 0) v |= (uint32_t)bit(0x80) << n;
    return v;
  }
  int32_t signed_value(int n) {
    const int v = (int)value_bits(n);
    return value_bits(1) ? -v : v;
  }
};

}  // namespace

// What vp8enc.cpp shares with the decoder (it declares them): RFC 6386's
// tables, the inverse transforms and the intra predictors, with external
// linkage in a namespace of their own.
namespace rcv_vp8 {

// -- RFC 6386's tables -----------------------------------------------------

enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED,
       B_VL_PRED, B_HD_PRED, B_HU_PRED, NUM_BMODES,
       DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED, TM_PRED = B_TM_PRED,
       B_DC_PRED_NOTOP = 4, B_DC_PRED_NOLEFT = 5, B_DC_PRED_NOTOPLEFT = 6 };

extern const uint8_t kDcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  10,  11,  12,  13,  14,  15,  16,  17,  17,
    18,  19,  20,  20,  21,  21,  22,  22,  23,  23,  24,  25,  25,  26,  27,  28,
    29,  30,  31,  32,  33,  34,  35,  36,  37,  37,  38,  39,  40,  41,  42,  43,
    44,  45,  46,  46,  47,  48,  49,  50,  51,  52,  53,  54,  55,  56,  57,  58,
    59,  60,  61,  62,  63,  64,  65,  66,  67,  68,  69,  70,  71,  72,  73,  74,
    75,  76,  76,  77,  78,  79,  80,  81,  82,  83,  84,  85,  86,  87,  88,  89,
    91,  93,  95,  96,  98,  100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157};

extern const uint16_t kAcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  11,  12,  13,  14,  15,  16,  17,  18,  19,
    20,  21,  22,  23,  24,  25,  26,  27,  28,  29,  30,  31,  32,  33,  34,  35,
    36,  37,  38,  39,  40,  41,  42,  43,  44,  45,  46,  47,  48,  49,  50,  51,
    52,  53,  54,  55,  56,  57,  58,  60,  62,  64,  66,  68,  70,  72,  74,  76,
    78,  80,  82,  84,  86,  88,  90,  92,  94,  96,  98,  100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284};

// kf_bmode_probs, indexed [top][left] in libwebp's mode order (above)
extern const uint8_t kBModesProba[NUM_BMODES][NUM_BMODES][NUM_BMODES - 1] = {
    {{231, 120, 48, 89, 115, 113, 120, 152, 112}, {152, 179, 64, 126, 170, 118, 46, 70, 95},
     {175, 69, 143, 80, 85, 82, 72, 155, 103},    {56, 58, 10, 171, 218, 189, 17, 13, 152},
     {114, 26, 17, 163, 44, 195, 21, 10, 173},    {121, 24, 80, 195, 26, 62, 44, 64, 85},
     {144, 71, 10, 38, 171, 213, 144, 34, 26},    {170, 46, 55, 19, 136, 160, 33, 206, 71},
     {63, 20, 8, 114, 114, 208, 12, 9, 226},      {81, 40, 11, 96, 182, 84, 29, 16, 36}},
    {{134, 183, 89, 137, 98, 101, 106, 165, 148}, {72, 187, 100, 130, 157, 111, 32, 75, 80},
     {66, 102, 167, 99, 74, 62, 40, 234, 128},    {41, 53, 9, 178, 241, 141, 26, 8, 107},
     {74, 43, 26, 146, 73, 166, 49, 23, 157},     {65, 38, 105, 160, 51, 52, 31, 115, 128},
     {104, 79, 12, 27, 217, 255, 87, 17, 7},      {87, 68, 71, 44, 114, 51, 15, 186, 23},
     {47, 41, 14, 110, 182, 183, 21, 17, 194},    {66, 45, 25, 102, 197, 189, 23, 18, 22}},
    {{88, 88, 147, 150, 42, 46, 45, 196, 205},    {43, 97, 183, 117, 85, 38, 35, 179, 61},
     {39, 53, 200, 87, 26, 21, 43, 232, 171},     {56, 34, 51, 104, 114, 102, 29, 93, 77},
     {39, 28, 85, 171, 58, 165, 90, 98, 64},      {34, 22, 116, 206, 23, 34, 43, 166, 73},
     {107, 54, 32, 26, 51, 1, 81, 43, 31},        {68, 25, 106, 22, 64, 171, 36, 225, 114},
     {34, 19, 21, 102, 132, 188, 16, 76, 124},    {62, 18, 78, 95, 85, 57, 50, 48, 51}},
    {{193, 101, 35, 159, 215, 111, 89, 46, 111},  {60, 148, 31, 172, 219, 228, 21, 18, 111},
     {112, 113, 77, 85, 179, 255, 38, 120, 114},  {40, 42, 1, 196, 245, 209, 10, 25, 109},
     {88, 43, 29, 140, 166, 213, 37, 43, 154},    {61, 63, 30, 155, 67, 45, 68, 1, 209},
     {100, 80, 8, 43, 154, 1, 51, 26, 71},        {142, 78, 78, 16, 255, 128, 34, 197, 171},
     {41, 40, 5, 102, 211, 183, 4, 1, 221},       {51, 50, 17, 168, 209, 192, 23, 25, 82}},
    {{138, 31, 36, 171, 27, 166, 38, 44, 229},    {67, 87, 58, 169, 82, 115, 26, 59, 179},
     {63, 59, 90, 180, 59, 166, 93, 73, 154},     {40, 40, 21, 116, 143, 209, 34, 39, 175},
     {47, 15, 16, 183, 34, 223, 49, 45, 183},     {46, 17, 33, 183, 6, 98, 15, 32, 183},
     {57, 46, 22, 24, 128, 1, 54, 17, 37},        {65, 32, 73, 115, 28, 128, 23, 128, 205},
     {40, 3, 9, 115, 51, 192, 18, 6, 223},        {87, 37, 9, 115, 59, 77, 64, 21, 47}},
    {{104, 55, 44, 218, 9, 54, 53, 130, 226},     {64, 90, 70, 205, 40, 41, 23, 26, 57},
     {54, 57, 112, 184, 5, 41, 38, 166, 213},     {30, 34, 26, 133, 152, 116, 10, 32, 134},
     {39, 19, 53, 221, 26, 114, 32, 73, 255},     {31, 9, 65, 234, 2, 15, 1, 118, 73},
     {75, 32, 12, 51, 192, 255, 160, 43, 51},     {88, 31, 35, 67, 102, 85, 55, 186, 85},
     {56, 21, 23, 111, 59, 205, 45, 37, 192},     {55, 38, 70, 124, 73, 102, 1, 34, 98}},
    {{125, 98, 42, 88, 104, 85, 117, 175, 82},    {95, 84, 53, 89, 128, 100, 113, 101, 45},
     {75, 79, 123, 47, 51, 128, 81, 171, 1},      {57, 17, 5, 71, 102, 57, 53, 41, 49},
     {38, 33, 13, 121, 57, 73, 26, 1, 85},        {41, 10, 67, 138, 77, 110, 90, 47, 114},
     {115, 21, 2, 10, 102, 255, 166, 23, 6},      {101, 29, 16, 10, 85, 128, 101, 196, 26},
     {57, 18, 10, 102, 102, 213, 34, 20, 43},     {117, 20, 15, 36, 163, 128, 68, 1, 26}},
    {{102, 61, 71, 37, 34, 53, 31, 243, 192},     {69, 60, 71, 38, 73, 119, 28, 222, 37},
     {68, 45, 128, 34, 1, 47, 11, 245, 171},      {62, 17, 19, 70, 146, 85, 55, 62, 70},
     {37, 43, 37, 154, 100, 163, 85, 160, 1},     {63, 9, 92, 136, 28, 64, 32, 201, 85},
     {75, 15, 9, 9, 64, 255, 184, 119, 16},       {86, 6, 28, 5, 64, 255, 25, 248, 1},
     {56, 8, 17, 132, 137, 255, 55, 116, 128},    {58, 15, 20, 82, 135, 57, 26, 121, 40}},
    {{164, 50, 31, 137, 154, 133, 25, 35, 218},   {51, 103, 44, 131, 131, 123, 31, 6, 158},
     {86, 40, 64, 135, 148, 224, 45, 183, 128},   {22, 26, 17, 131, 240, 154, 14, 1, 209},
     {45, 16, 21, 91, 64, 222, 7, 1, 197},        {56, 21, 39, 155, 60, 138, 23, 102, 213},
     {83, 12, 13, 54, 192, 255, 68, 47, 28},      {85, 26, 85, 85, 128, 128, 32, 146, 171},
     {18, 11, 7, 63, 144, 171, 4, 4, 246},        {35, 27, 10, 146, 174, 171, 12, 26, 128}},
    {{190, 80, 35, 99, 180, 80, 126, 54, 45},     {85, 126, 47, 87, 176, 51, 41, 20, 32},
     {101, 75, 128, 139, 118, 146, 116, 128, 85}, {56, 41, 15, 176, 236, 85, 37, 9, 62},
     {71, 30, 17, 119, 118, 255, 17, 18, 138},    {101, 38, 60, 138, 55, 70, 43, 26, 142},
     {146, 36, 19, 30, 171, 255, 97, 27, 20},     {138, 45, 61, 62, 219, 1, 81, 188, 64},
     {32, 41, 20, 117, 151, 142, 20, 21, 163},    {112, 19, 12, 61, 195, 128, 48, 4, 24}}};

// the 4x4 mode tree, in libwebp's form: a leaf is -mode
const int8_t kYModesIntra4[18] = {-B_DC_PRED, 1,  -B_TM_PRED, 2,  -B_VE_PRED, 3,
                                  4,          6,  -B_HE_PRED, 5,  -B_RD_PRED, -B_VR_PRED,
                                  -B_LD_PRED, 7,  -B_VL_PRED, 8,  -B_HD_PRED, -B_HU_PRED};

enum { NUM_TYPES = 4, NUM_BANDS = 8, NUM_CTX = 3, NUM_PROBAS = 11 };

extern const uint8_t kCoeffsProba0[NUM_TYPES][NUM_BANDS][NUM_CTX][NUM_PROBAS] = {
    {{{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
     {{253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128},
      {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128},
      {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}},
     {{1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128},
      {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128},
      {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}},
     {{1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128},
      {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128},
      {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}},
     {{1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128},
      {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128},
      {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}},
     {{1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128},
      {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128},
      {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}},
     {{1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128},
      {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128},
      {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}},
     {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}}},
    {{{198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62},
      {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1},
      {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128}},
     {{1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128},
      {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128},
      {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}},
     {{1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128},
      {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128},
      {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}},
     {{1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128},
      {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128},
      {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}},
     {{1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128},
      {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128},
      {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}},
     {{1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128},
      {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128},
      {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}},
     {{1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128},
      {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128},
      {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}},
     {{1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128},
      {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128},
      {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128}}},
    {{{253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128},
      {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128},
      {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128}},
     {{1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128},
      {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128},
      {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128}},
     {{1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128},
      {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128},
      {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}},
     {{1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128},
      {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128},
      {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}},
     {{1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128},
      {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128},
      {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
     {{1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
     {{1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128},
      {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128},
      {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
     {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}}},
    {{{202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255},
      {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128},
      {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128}},
     {{1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128},
      {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128},
      {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128}},
     {{1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128},
      {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128},
      {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}},
     {{1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128},
      {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128},
      {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}},
     {{1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128},
      {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128},
      {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128}},
     {{1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128},
      {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128},
      {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}},
     {{1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128},
      {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128},
      {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128}},
     {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}}}};

extern const uint8_t kCoeffsUpdateProba[NUM_TYPES][NUM_BANDS][NUM_CTX][NUM_PROBAS] = {
    {{{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255},
      {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255},
      {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255},
      {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
    {{{217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255},
      {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}},
     {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
    {{{186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255},
      {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255},
      {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}},
     {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}},
     {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
    {{{248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255},
      {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}},
     {{255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255},
      {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}}};

extern const uint8_t kBands[16 + 1] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
extern const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
extern const uint8_t kCat3[] = {173, 148, 140, 0};
extern const uint8_t kCat4[] = {176, 155, 140, 135, 0};
extern const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
extern const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// -- the work buffer and the transforms (dsp/dec.c) --------------------------

constexpr int BPS = 32;  // the work buffer's stride
constexpr int Y_OFF = BPS * 1 + 8;
constexpr int U_OFF = Y_OFF + BPS * 16 + BPS;
constexpr int V_OFF = U_OFF + 16;
constexpr int YUV_SIZE = BPS * 17 + BPS * 9;

inline uint8_t clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : (uint8_t)v; }

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

void transform_one(const int16_t* in, uint8_t* dst) {
  int C[16];
  int* tmp = C;
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]);
    const int d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    in++;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {  // horizontal pass
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]);
    const int d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
    tmp++;
    dst += BPS;
  }
}

void transform_dc(const int16_t* in, uint8_t* dst) {
  const int dc = in[0] + 4;
  for (int j = 0; j < 4; ++j)
    for (int i = 0; i < 4; ++i) dst[i + j * BPS] = clip8(dst[i + j * BPS] + (dc >> 3));
}

// bits: the block's two-bit code (3 or 2: any AC, 1: DC only, 0: none)
inline void do_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  switch (bits >> 30) {
    case 3:
    case 2:
      transform_one(src, dst);
      break;
    case 1:
      transform_dc(src, dst);
      break;
    default:
      break;
  }
}

void do_uv_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  if (bits & 0xff) {
    if (bits & 0xaa) {
      transform_one(src, dst);
      transform_one(src + 16, dst + 4);
      transform_one(src + 32, dst + 4 * BPS);
      transform_one(src + 48, dst + 4 * BPS + 4);
    } else {
      transform_dc(src, dst);
      transform_dc(src + 16, dst + 4);
      transform_dc(src + 32, dst + 4 * BPS);
      transform_dc(src + 48, dst + 4 * BPS + 4);
    }
  }
}

void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

// -- intra predictors -------------------------------------------------------

#define DST(x, y) dst[(x) + (y) * BPS]
#define AVG3(a, b, c) ((uint8_t)(((a) + 2 * (b) + (c) + 2) >> 2))
#define AVG2(a, b) (((a) + (b) + 1) >> 1)

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int l = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + l - tl);
    dst += BPS;
  }
}

void fill(uint8_t* dst, int v, int size) {
  for (int j = 0; j < size; ++j) memset(dst + j * BPS, v, size);
}

void pred16(uint8_t* dst, int mode) {
  switch (mode) {
    case DC_PRED: {
      int dc = 16;
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      fill(dst, dc >> 5, 16);
      break;
    }
    case TM_PRED:
      true_motion(dst, 16);
      break;
    case V_PRED:
      for (int j = 0; j < 16; ++j) memcpy(dst + j * BPS, dst - BPS, 16);
      break;
    case H_PRED:
      for (int j = 0; j < 16; ++j) memset(dst + j * BPS, dst[j * BPS - 1], 16);
      break;
    case B_DC_PRED_NOTOP: {
      int dc = 8;
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS];
      fill(dst, dc >> 4, 16);
      break;
    }
    case B_DC_PRED_NOLEFT: {
      int dc = 8;
      for (int i = 0; i < 16; ++i) dc += dst[i - BPS];
      fill(dst, dc >> 4, 16);
      break;
    }
    default:
      fill(dst, 0x80, 16);
      break;
  }
}

void pred8uv(uint8_t* dst, int mode) {
  switch (mode) {
    case DC_PRED: {
      int dc = 8;
      for (int i = 0; i < 8; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill(dst, dc >> 4, 8);
      break;
    }
    case TM_PRED:
      true_motion(dst, 8);
      break;
    case V_PRED:
      for (int j = 0; j < 8; ++j) memcpy(dst + j * BPS, dst - BPS, 8);
      break;
    case H_PRED:
      for (int j = 0; j < 8; ++j) memset(dst + j * BPS, dst[j * BPS - 1], 8);
      break;
    case B_DC_PRED_NOTOP: {
      int dc = 4;
      for (int i = 0; i < 8; ++i) dc += dst[-1 + i * BPS];
      fill(dst, dc >> 3, 8);
      break;
    }
    case B_DC_PRED_NOLEFT: {
      int dc = 4;
      for (int i = 0; i < 8; ++i) dc += dst[i - BPS];
      fill(dst, dc >> 3, 8);
      break;
    }
    default:
      fill(dst, 0x80, 8);
      break;
  }
}

void pred4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  switch (mode) {
    case B_DC_PRED: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill(dst, dc >> 3, 4);
      break;
    }
    case B_TM_PRED:
      true_motion(dst, 4);
      break;
    case B_VE_PRED: {
      const uint8_t vals[4] = {AVG3(top[-1], top[0], top[1]), AVG3(top[0], top[1], top[2]),
                               AVG3(top[1], top[2], top[3]), AVG3(top[2], top[3], top[4])};
      for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE_PRED: {
      const int A = dst[-1 - BPS], B = dst[-1], C = dst[-1 + BPS], D = dst[-1 + 2 * BPS],
                E = dst[-1 + 3 * BPS];
      memset(dst + 0 * BPS, AVG3(A, B, C), 4);
      memset(dst + 1 * BPS, AVG3(B, C, D), 4);
      memset(dst + 2 * BPS, AVG3(C, D, E), 4);
      memset(dst + 3 * BPS, AVG3(D, E, E), 4);
      break;
    }
    case B_RD_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS], X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS],
                C = dst[2 - BPS], D = dst[3 - BPS];
      DST(0, 3) = AVG3(J, K, L);
      DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
      DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
      DST(3, 0) = AVG3(D, C, B);
      break;
    }
    case B_LD_PRED: {
      const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS],
                E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS], H = dst[7 - BPS];
      DST(0, 0) = AVG3(A, B, C);
      DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
      DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
      DST(3, 3) = AVG3(G, H, H);
      break;
    }
    case B_VR_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS],
                D = dst[3 - BPS];
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
    }
    case B_VL_PRED: {
      const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS],
                E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS], H = dst[7 - BPS];
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
    }
    case B_HU_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS];
      DST(0, 0) = AVG2(I, J);
      DST(2, 0) = DST(0, 1) = AVG2(J, K);
      DST(2, 1) = DST(0, 2) = AVG2(K, L);
      DST(1, 0) = AVG3(I, J, K);
      DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
      DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
    }
    default: {  // B_HD_PRED
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS], X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS],
                C = dst[2 - BPS];
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
    }
  }
}

#undef DST
#undef AVG3
#undef AVG2

}  // namespace rcv_vp8

namespace {

using namespace rcv_vp8;

// -- the loop filters (dsp/dec.c) ------------------------------------------

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }  // [-1020, 1020]
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }      // [-112, 112]

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

inline int hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return (abs(p1 - p0) > thresh) || (abs(q1 - q0) > thresh);
}

inline int needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return (4 * abs(p0 - q0) + abs(p1 - q1)) <= t;
}

inline int needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if ((4 * abs(p0 - q0) + abs(p1 - q1)) > t) return 0;
  return abs(p3 - p2) <= it && abs(p2 - p1) <= it && abs(p1 - p0) <= it &&
         abs(q3 - q2) <= it && abs(q2 - q1) <= it && abs(q1 - q0) <= it;
}

// an edge of `size` pixels across `hstride`, the pixels `vstride` apart
void simple_filter(uint8_t* p, int hstride, int vstride, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (needs_filter(p, hstride, thresh2)) do_filter2(p, hstride);
}

void filter_loop26(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                   int hev_thresh) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh)) {
        do_filter2(p, hstride);
      } else {
        do_filter6(p, hstride);
      }
    }
    p += vstride;
  }
}

void filter_loop24(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                   int hev_thresh) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh)) {
        do_filter2(p, hstride);
      } else {
        do_filter4(p, hstride);
      }
    }
    p += vstride;
  }
}

// -- the upsampler and YUV -> RGB (dsp/upsampling.c, dsp/yuv.h) -------------

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) { return ((v & ~16383) == 0) ? (uint8_t)(v >> 6) : (v < 0) ? 0 : 255; }

inline void yuv_to_rgba(int y, int u, int v, uint8_t* rgba) {
  rgba[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgba[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgba[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// UpsampleRgbaLinePair: two output rows from the chroma rows above and below
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u,
                   const uint8_t* top_v, const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  const int last_pixel_pair = (len - 1) >> 1;
  int tl_u = top_u[0], tl_v = top_v[0], l_u = cur_u[0], l_v = cur_v[0];
  yuv_to_rgba(top_y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, top_dst);
  if (bottom_y) {
    yuv_to_rgba(bottom_y[0], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2, bottom_dst);
  }
  for (int x = 1; x <= last_pixel_pair; ++x) {
    const int t_u = top_u[x], t_v = top_v[x], u = cur_u[x], v = cur_v[x];
    const int avg_u = tl_u + t_u + l_u + u + 8, avg_v = tl_v + t_v + l_v + v + 8;
    const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3, d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
    const int d03_u = (avg_u + 2 * (tl_u + u)) >> 3, d03_v = (avg_v + 2 * (tl_v + v)) >> 3;
    yuv_to_rgba(top_y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1,
                top_dst + (2 * x - 1) * 4);
    yuv_to_rgba(top_y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1, top_dst + 2 * x * 4);
    if (bottom_y) {
      yuv_to_rgba(bottom_y[2 * x - 1], (d03_u + l_u) >> 1, (d03_v + l_v) >> 1,
                  bottom_dst + (2 * x - 1) * 4);
      yuv_to_rgba(bottom_y[2 * x], (d12_u + u) >> 1, (d12_v + v) >> 1, bottom_dst + 2 * x * 4);
    }
    tl_u = t_u;
    tl_v = t_v;
    l_u = u;
    l_v = v;
  }
  if (!(len & 1)) {
    yuv_to_rgba(top_y[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2,
                top_dst + (len - 1) * 4);
    if (bottom_y) {
      yuv_to_rgba(bottom_y[len - 1], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2,
                  bottom_dst + (len - 1) * 4);
    }
  }
}

// -- the decoder ---------------------------------------------------------------

struct MBData {
  int16_t coeffs[384];
  uint8_t imodes[16];
  uint8_t is_i4x4, uvmode, segment, skip;
  uint32_t non_zero_y, non_zero_uv;
};

struct FInfo {
  uint8_t limit, ilevel, inner, hev_thresh;
};

struct Decoder {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  // segment header
  int use_segment = 0, update_map = 0, absolute_delta = 1;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  uint8_t seg_probs[3] = {255, 255, 255};
  // filter header
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  int filter_type = 0;
  FInfo fstrengths[4][2];
  // partitions and probabilities
  BoolReader br;
  BoolReader parts[8];
  int num_parts_m1 = 0;
  struct { int y1[2], y2[2], uv[2]; } dqm[4];
  uint8_t proba[NUM_TYPES][NUM_BANDS][NUM_CTX][NUM_PROBAS];
  int use_skip = 0, skip_p = 0;
  // contexts
  std::vector<uint8_t> intra_t;  // 4 per macroblock
  uint8_t intra_l[4] = {0, 0, 0, 0};
  std::vector<uint8_t> nz_top, nz_dc_top;
  uint8_t nz_left = 0, nz_dc_left = 0;
  std::vector<MBData> row;
  std::vector<FInfo> finfo;
  // the reconstructed planes (macroblock-aligned)
  std::vector<uint8_t> y, u, v;
  int y_stride = 0, uv_stride = 0;

  int parse_headers(const uint8_t* data, size_t size);
  void parse_quant();
  void parse_proba();
  void parse_intra_mode(int mb_x);
  int parse_residuals(int mb_x, BoolReader* tbr);
  void reconstruct(int mb_x, int mb_y, uint8_t* yuv);
  void filter_mb(int mb_x, int mb_y);
  void precompute_filter_strengths();
  int decode(const uint8_t* data, size_t size);
};

int Decoder::parse_headers(const uint8_t* buf, size_t size) {
  if (size < 10) return kTruncated;
  const uint32_t bits = buf[0] | (buf[1] << 8) | (buf[2] << 16);
  const int key_frame = !(bits & 1);
  const int profile = (bits >> 1) & 7;
  const int show = (bits >> 4) & 1;
  const uint32_t partition_length = bits >> 5;
  if (profile > 3) return kBadHeader;
  if (!show) return kUnsupported;
  if (!key_frame) return kUnsupported;
  buf += 3;
  size -= 3;
  if (buf[0] != 0x9d || buf[1] != 0x01 || buf[2] != 0x2a) return kBadHeader;
  width = ((buf[4] << 8) | buf[3]) & 0x3fff;  // the scale bits are ignored
  height = ((buf[6] << 8) | buf[5]) & 0x3fff;
  if (width == 0 || height == 0) return kBadHeader;
  buf += 7;
  size -= 7;
  mb_w = (width + 15) >> 4;
  mb_h = (height + 15) >> 4;
  if (partition_length > size) return kTruncated;
  br.init(buf, partition_length);
  buf += partition_length;
  size -= partition_length;
  br.value_bits(1);  // colour space
  br.value_bits(1);  // clamping type
  // segment header
  use_segment = br.value_bits(1);
  if (use_segment) {
    update_map = br.value_bits(1);
    if (br.value_bits(1)) {
      absolute_delta = br.value_bits(1);
      for (int s = 0; s < 4; ++s) quantizer[s] = br.value_bits(1) ? br.signed_value(7) : 0;
      for (int s = 0; s < 4; ++s) filter_strength[s] = br.value_bits(1) ? br.signed_value(6) : 0;
    }
    if (update_map)
      for (int s = 0; s < 3; ++s) seg_probs[s] = br.value_bits(1) ? br.value_bits(8) : 255;
  } else {
    update_map = 0;
  }
  if (br.eof) return kBadHeader;
  // filter header
  simple = br.value_bits(1);
  level = br.value_bits(6);
  sharpness = br.value_bits(3);
  use_lf_delta = br.value_bits(1);
  if (use_lf_delta && br.value_bits(1)) {
    for (int i = 0; i < 4; ++i)
      if (br.value_bits(1)) ref_lf_delta[i] = br.signed_value(6);
    for (int i = 0; i < 4; ++i)
      if (br.value_bits(1)) mode_lf_delta[i] = br.signed_value(6);
  }
  filter_type = (level == 0) ? 0 : simple ? 1 : 2;
  if (br.eof) return kBadHeader;
  // token partitions
  num_parts_m1 = (1 << br.value_bits(2)) - 1;
  const size_t last_part = num_parts_m1;
  if (size < 3 * last_part) return kTruncated;
  const uint8_t* sz = buf;
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
  if (part_start >= buf + size) return kTruncated;
  parse_quant();
  br.value_bits(1);  // update_proba, ignored
  parse_proba();
  return kOk;
}

void Decoder::parse_quant() {
  const int base_q0 = br.value_bits(7);
  const int dqy1_dc = br.value_bits(1) ? br.signed_value(4) : 0;
  const int dqy2_dc = br.value_bits(1) ? br.signed_value(4) : 0;
  const int dqy2_ac = br.value_bits(1) ? br.signed_value(4) : 0;
  const int dquv_dc = br.value_bits(1) ? br.signed_value(4) : 0;
  const int dquv_ac = br.value_bits(1) ? br.signed_value(4) : 0;
  auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
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
    auto& m = dqm[i];
    m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
    m.y1[1] = kAcTable[clip(q + 0, 127)];
    m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
    m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;  // x * 155 / 100
    if (m.y2[1] < 8) m.y2[1] = 8;
    m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
    m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
  }
}

void Decoder::parse_proba() {
  for (int t = 0; t < NUM_TYPES; ++t)
    for (int b = 0; b < NUM_BANDS; ++b)
      for (int c = 0; c < NUM_CTX; ++c)
        for (int p = 0; p < NUM_PROBAS; ++p)
          proba[t][b][c][p] = br.bit(kCoeffsUpdateProba[t][b][c][p]) ? br.value_bits(8)
                                                                      : kCoeffsProba0[t][b][c][p];
  use_skip = br.value_bits(1);
  if (use_skip) skip_p = br.value_bits(8);
}

void Decoder::parse_intra_mode(int mb_x) {
  uint8_t* const top = intra_t.data() + 4 * mb_x;
  uint8_t* const left = intra_l;
  MBData& block = row[mb_x];
  if (update_map) {
    block.segment = !br.bit(seg_probs[0]) ? br.bit(seg_probs[1]) : br.bit(seg_probs[2]) + 2;
  } else {
    block.segment = 0;
  }
  block.skip = use_skip ? br.bit(skip_p) : 0;
  block.is_i4x4 = !br.bit(145);
  if (!block.is_i4x4) {
    const int ymode = br.bit(156) ? (br.bit(128) ? TM_PRED : H_PRED)
                                  : (br.bit(163) ? V_PRED : DC_PRED);
    block.imodes[0] = ymode;
    memset(top, ymode, 4);
    memset(left, ymode, 4);
  } else {
    uint8_t* modes = block.imodes;
    for (int yy = 0; yy < 4; ++yy) {
      int ymode = left[yy];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* const prob = kBModesProba[top[x]][ymode];
        int i = kYModesIntra4[br.bit(prob[0])];
        while (i > 0) i = kYModesIntra4[2 * i + br.bit(prob[i])];
        ymode = -i;
        top[x] = ymode;
      }
      memcpy(modes, top, 4);
      modes += 4;
      left[yy] = ymode;
    }
  }
  block.uvmode = !br.bit(142) ? DC_PRED : !br.bit(114) ? V_PRED : br.bit(183) ? TM_PRED : H_PRED;
}

int get_large_value(BoolReader* br, const uint8_t* p) {
  int v;
  if (!br->bit(p[3])) {
    if (!br->bit(p[4])) {
      v = 2;
    } else {
      v = 3 + br->bit(p[5]);
    }
  } else {
    if (!br->bit(p[6])) {
      if (!br->bit(p[7])) {
        v = 5 + br->bit(159);
      } else {
        v = 7 + 2 * br->bit(165);
        v += br->bit(145);
      }
    } else {
      const int bit1 = br->bit(p[8]);
      const int bit0 = br->bit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br->bit(*tab);
      v += 3 + (8 << cat);
    }
  }
  return v;
}

// GetCoeffs: the tokens of one block from position n; returns the position
// after the last non-zero coefficient (16 when the block runs to its end)
int get_coeffs(BoolReader* br, const uint8_t (*bands)[NUM_CTX][NUM_PROBAS], int ctx,
               const int* dq, int n, int16_t* out) {
  const uint8_t* p = bands[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br->bit(p[0])) return n;
    while (!br->bit(p[1])) {
      p = bands[kBands[++n]][0];
      if (n == 16) return 16;
    }
    int v;
    if (!br->bit(p[2])) {
      v = 1;
      p = bands[kBands[n + 1]][1];
    } else {
      v = get_large_value(br, p);
      p = bands[kBands[n + 1]][2];
    }
    out[kZigzag[n]] = (int16_t)(br->sign(v) * dq[n > 0]);
  }
  return 16;
}

inline uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
  nz_coeffs <<= 2;
  nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
  return nz_coeffs;
}

int Decoder::parse_residuals(int mb_x, BoolReader* tbr) {
  MBData& block = row[mb_x];
  const auto& q = dqm[block.segment];
  int16_t* dst = block.coeffs;
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  int first;
  const uint8_t(*ac_proba)[NUM_CTX][NUM_PROBAS];
  memset(dst, 0, 384 * sizeof(*dst));
  if (!block.is_i4x4) {
    int16_t dc[16] = {0};
    const int ctx = nz_dc_top[mb_x] + nz_dc_left;
    const int nz = get_coeffs(tbr, proba[1], ctx, q.y2, 0, dc);
    nz_dc_top[mb_x] = nz_dc_left = (nz > 0);
    if (nz > 1) {
      transform_wht(dc, dst);
    } else {
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 16 * 16; i += 16) dst[i] = (int16_t)dc0;
    }
    first = 1;
    ac_proba = proba[0];
  } else {
    first = 0;
    ac_proba = proba[3];
  }
  uint8_t tnz = nz_top[mb_x] & 0x0f;
  uint8_t lnz = nz_left & 0x0f;
  for (int yy = 0; yy < 4; ++yy) {
    int l = lnz & 1;
    uint32_t nz_coeffs = 0;
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + (tnz & 1);
      const int nz = get_coeffs(tbr, ac_proba, ctx, q.y1, first, dst);
      l = (nz > first);
      tnz = (tnz >> 1) | (l << 7);
      nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
      dst += 16;
    }
    tnz >>= 4;
    lnz = (lnz >> 1) | (l << 7);
    non_zero_y = (non_zero_y << 8) | nz_coeffs;
  }
  uint32_t out_t_nz = tnz;
  uint32_t out_l_nz = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t nz_coeffs = 0;
    tnz = nz_top[mb_x] >> (4 + ch);
    lnz = nz_left >> (4 + ch);
    for (int yy = 0; yy < 2; ++yy) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(tbr, proba[2], ctx, q.uv, 0, dst);
        l = (nz > 0);
        tnz = (tnz >> 1) | (l << 3);
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 2;
      lnz = (lnz >> 1) | (l << 5);
    }
    non_zero_uv |= nz_coeffs << (4 * ch);
    out_t_nz |= (tnz << 4) << ch;
    out_l_nz |= (lnz & 0xf0) << ch;
  }
  nz_top[mb_x] = (uint8_t)out_t_nz;
  nz_left = (uint8_t)out_l_nz;
  block.non_zero_y = non_zero_y;
  block.non_zero_uv = non_zero_uv;
  return !(non_zero_y | non_zero_uv);
}

inline int check_mode(int mb_x, int mb_y, int mode) {
  if (mode == B_DC_PRED) {
    if (mb_x == 0) return (mb_y == 0) ? B_DC_PRED_NOTOPLEFT : B_DC_PRED_NOLEFT;
    return (mb_y == 0) ? B_DC_PRED_NOTOP : B_DC_PRED;
  }
  return mode;
}

const int kScan[16] = {0 + 0 * BPS,  4 + 0 * BPS,  8 + 0 * BPS,  12 + 0 * BPS,
                       0 + 4 * BPS,  4 + 4 * BPS,  8 + 4 * BPS,  12 + 4 * BPS,
                       0 + 8 * BPS,  4 + 8 * BPS,  8 + 8 * BPS,  12 + 8 * BPS,
                       0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};

// one macroblock: its borders from the (unfiltered) planes, prediction and
// residuals in the work buffer, then back into the planes
void Decoder::reconstruct(int mb_x, int mb_y, uint8_t* yuv) {
  uint8_t* const y_dst = yuv + Y_OFF;
  uint8_t* const u_dst = yuv + U_OFF;
  uint8_t* const v_dst = yuv + V_OFF;
  const MBData& block = row[mb_x];
  const int x0 = mb_x * 16, y0 = mb_y * 16, ux0 = mb_x * 8, uy0 = mb_y * 8;
  // the left column and the corner
  for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = mb_x > 0 ? y[(y0 + j) * y_stride + x0 - 1] : 129;
  for (int j = 0; j < 8; ++j) {
    u_dst[j * BPS - 1] = mb_x > 0 ? u[(uy0 + j) * uv_stride + ux0 - 1] : 129;
    v_dst[j * BPS - 1] = mb_x > 0 ? v[(uy0 + j) * uv_stride + ux0 - 1] : 129;
  }
  if (mb_y > 0) {
    y_dst[-1 - BPS] = mb_x > 0 ? y[(y0 - 1) * y_stride + x0 - 1] : 129;
    u_dst[-1 - BPS] = mb_x > 0 ? u[(uy0 - 1) * uv_stride + ux0 - 1] : 129;
    v_dst[-1 - BPS] = mb_x > 0 ? v[(uy0 - 1) * uv_stride + ux0 - 1] : 129;
    memcpy(y_dst - BPS, &y[(y0 - 1) * y_stride + x0], 16);
    memcpy(u_dst - BPS, &u[(uy0 - 1) * uv_stride + ux0], 8);
    memcpy(v_dst - BPS, &v[(uy0 - 1) * uv_stride + ux0], 8);
  } else {
    memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
    memset(u_dst - BPS - 1, 127, 8 + 1);
    memset(v_dst - BPS - 1, 127, 8 + 1);
  }
  const int16_t* const coeffs = block.coeffs;
  uint32_t bits = block.non_zero_y;
  if (block.is_i4x4) {
    uint8_t* const top_right = y_dst - BPS + 16;
    if (mb_y > 0) {
      if (mb_x >= mb_w - 1) {
        memset(top_right, y[(y0 - 1) * y_stride + x0 + 15], 4);
      } else {
        memcpy(top_right, &y[(y0 - 1) * y_stride + x0 + 16], 4);
      }
    }
    for (int r = 1; r <= 3; ++r) memcpy(top_right + 4 * r * BPS, top_right, 4);
    for (int n = 0; n < 16; ++n, bits <<= 2) {
      uint8_t* const dst = y_dst + kScan[n];
      pred4(dst, block.imodes[n]);
      do_transform(bits, coeffs + n * 16, dst);
    }
  } else {
    pred16(y_dst, check_mode(mb_x, mb_y, block.imodes[0]));
    if (bits != 0)
      for (int n = 0; n < 16; ++n, bits <<= 2) do_transform(bits, coeffs + n * 16, y_dst + kScan[n]);
  }
  const int uv_mode = check_mode(mb_x, mb_y, block.uvmode);
  pred8uv(u_dst, uv_mode);
  pred8uv(v_dst, uv_mode);
  do_uv_transform(block.non_zero_uv >> 0, coeffs + 16 * 16, u_dst);
  do_uv_transform(block.non_zero_uv >> 8, coeffs + 20 * 16, v_dst);
  for (int j = 0; j < 16; ++j) memcpy(&y[(y0 + j) * y_stride + x0], y_dst + j * BPS, 16);
  for (int j = 0; j < 8; ++j) {
    memcpy(&u[(uy0 + j) * uv_stride + ux0], u_dst + j * BPS, 8);
    memcpy(&v[(uy0 + j) * uv_stride + ux0], v_dst + j * BPS, 8);
  }
}

void Decoder::precompute_filter_strengths() {
  if (filter_type == 0) return;
  for (int s = 0; s < 4; ++s) {
    int base_level;
    if (use_segment) {
      base_level = filter_strength[s];
      if (!absolute_delta) base_level += level;
    } else {
      base_level = level;
    }
    for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
      FInfo& info = fstrengths[s][i4x4];
      int lvl = base_level;
      if (use_lf_delta) {
        lvl += ref_lf_delta[0];
        if (i4x4) lvl += mode_lf_delta[0];
      }
      lvl = (lvl < 0) ? 0 : (lvl > 63) ? 63 : lvl;
      if (lvl > 0) {
        int ilevel = lvl;
        if (sharpness > 0) {
          if (sharpness > 4) {
            ilevel >>= 2;
          } else {
            ilevel >>= 1;
          }
          if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
        }
        if (ilevel < 1) ilevel = 1;
        info.ilevel = (uint8_t)ilevel;
        info.limit = (uint8_t)(2 * lvl + ilevel);
        info.hev_thresh = (lvl >= 40) ? 2 : (lvl >= 15) ? 1 : 0;
      } else {
        info.limit = 0;
      }
      info.inner = (uint8_t)i4x4;
    }
  }
}

void Decoder::filter_mb(int mb_x, int mb_y) {
  const FInfo& f = finfo[(size_t)mb_y * mb_w + mb_x];
  const int limit = f.limit;
  if (limit == 0) return;
  const int ilevel = f.ilevel;
  uint8_t* const y_dst = &y[(size_t)mb_y * 16 * y_stride + mb_x * 16];
  const int ys = y_stride;
  if (filter_type == 1) {  // simple
    if (mb_x > 0) simple_filter(y_dst, 1, ys, limit + 4);
    if (f.inner)
      for (int k = 1; k <= 3; ++k) simple_filter(y_dst + 4 * k, 1, ys, limit);
    if (mb_y > 0) simple_filter(y_dst, ys, 1, limit + 4);
    if (f.inner)
      for (int k = 1; k <= 3; ++k) simple_filter(y_dst + 4 * k * ys, ys, 1, limit);
  } else {  // normal
    const int uvs = uv_stride;
    uint8_t* const u_dst = &u[(size_t)mb_y * 8 * uvs + mb_x * 8];
    uint8_t* const v_dst = &v[(size_t)mb_y * 8 * uvs + mb_x * 8];
    const int hev_t = f.hev_thresh;
    if (mb_x > 0) {
      filter_loop26(y_dst, 1, ys, 16, limit + 4, ilevel, hev_t);
      filter_loop26(u_dst, 1, uvs, 8, limit + 4, ilevel, hev_t);
      filter_loop26(v_dst, 1, uvs, 8, limit + 4, ilevel, hev_t);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k) filter_loop24(y_dst + 4 * k, 1, ys, 16, limit, ilevel, hev_t);
      filter_loop24(u_dst + 4, 1, uvs, 8, limit, ilevel, hev_t);
      filter_loop24(v_dst + 4, 1, uvs, 8, limit, ilevel, hev_t);
    }
    if (mb_y > 0) {
      filter_loop26(y_dst, ys, 1, 16, limit + 4, ilevel, hev_t);
      filter_loop26(u_dst, uvs, 1, 8, limit + 4, ilevel, hev_t);
      filter_loop26(v_dst, uvs, 1, 8, limit + 4, ilevel, hev_t);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k)
        filter_loop24(y_dst + 4 * k * ys, ys, 1, 16, limit, ilevel, hev_t);
      filter_loop24(u_dst + 4 * uvs, uvs, 1, 8, limit, ilevel, hev_t);
      filter_loop24(v_dst + 4 * uvs, uvs, 1, 8, limit, ilevel, hev_t);
    }
  }
}

int Decoder::decode(const uint8_t* data, size_t size) {
  const int rc = parse_headers(data, size);
  if (rc != kOk) return rc;
  intra_t.assign((size_t)mb_w * 4, B_DC_PRED);
  nz_top.assign(mb_w, 0);
  nz_dc_top.assign(mb_w, 0);
  row.resize(mb_w);
  finfo.assign((size_t)mb_w * mb_h, FInfo{0, 0, 0, 0});
  y_stride = mb_w * 16;
  uv_stride = mb_w * 8;
  y.assign((size_t)y_stride * mb_h * 16, 0);
  u.assign((size_t)uv_stride * mb_h * 8, 0);
  v.assign((size_t)uv_stride * mb_h * 8, 0);
  precompute_filter_strengths();
  alignas(16) uint8_t yuv[YUV_SIZE];
  memset(yuv, 0, sizeof(yuv));
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    BoolReader* const tbr = &parts[mb_y & num_parts_m1];
    // each row starts with fresh left contexts
    nz_left = 0;
    nz_dc_left = 0;
    memset(intra_l, B_DC_PRED, sizeof(intra_l));
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) parse_intra_mode(mb_x);
    if (br.eof) return kTruncated;  // premature end of partition 0
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      MBData& block = row[mb_x];
      int skip = use_skip ? block.skip : 0;
      if (!skip) {
        skip = parse_residuals(mb_x, tbr);
      } else {
        nz_left = nz_top[mb_x] = 0;
        if (!block.is_i4x4) nz_dc_left = nz_dc_top[mb_x] = 0;
        block.non_zero_y = 0;
        block.non_zero_uv = 0;
      }
      if (filter_type > 0) {
        FInfo& f = finfo[(size_t)mb_y * mb_w + mb_x];
        f = fstrengths[block.segment][block.is_i4x4];
        f.inner |= !skip;
      }
      if (tbr->eof) return kTruncated;  // premature end of a token partition
      reconstruct(mb_x, mb_y, yuv);
    }
  }
  if (filter_type > 0)
    for (int mb_y = 0; mb_y < mb_h; ++mb_y)
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) filter_mb(mb_x, mb_y);
  return kOk;
}

// the frame's planes -> RGBA rows as EmitFancyRGB gives them
void emit_rgba(const Decoder& d, uint8_t* out, long stride) {
  const int w = d.width, h = d.height;
  const uint8_t* Y = d.y.data();
  const uint8_t* U = d.u.data();
  const uint8_t* V = d.v.data();
  const int ys = d.y_stride, uvs = d.uv_stride;
  upsample_pair(Y, nullptr, U, V, U, V, out, nullptr, w);
  int yy = 0;
  for (; yy + 2 < h; yy += 2) {
    const int cu = yy / 2;
    upsample_pair(Y + (yy + 1) * ys, Y + (yy + 2) * ys, U + cu * uvs, V + cu * uvs,
                  U + (cu + 1) * uvs, V + (cu + 1) * uvs, out + (yy + 1) * stride,
                  out + (yy + 2) * stride, w);
  }
  if (!(h & 1)) {
    const int cu = yy / 2;
    upsample_pair(Y + (yy + 1) * ys, nullptr, U + cu * uvs, V + cu * uvs, U + cu * uvs,
                  V + cu * uvs, out + (yy + 1) * stride, nullptr, w);
  }
}

}  // namespace

extern "C" {

// The frame header of a VP8 chunk's payload: 0 and the size, or a negative
// code (VP8GetInfo's checks).
int rcv_vp8_info(const uint8_t* data, long size, int* width, int* height) {
  if (size < 10) return kTruncated;
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) return kBadHeader;
  const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
  const int w = ((data[7] << 8) | data[6]) & 0x3fff;
  const int h = ((data[9] << 8) | data[8]) & 0x3fff;
  if (bits & 1) return kUnsupported;  // not a key frame
  if (((bits >> 1) & 7) > 3 || !((bits >> 4) & 1) || (long)(bits >> 5) >= size) return kBadHeader;
  if (w == 0 || h == 0) return kBadHeader;
  *width = w;
  *height = h;
  return kOk;
}

// A VP8 chunk's payload (``size`` bytes, the pad byte included where the file
// has one) -> RGBA rows ``stride`` bytes apart at ``out`` (width x height of
// the frame header). ``alpha``: the ALPH chunk's payload, or null (alpha 255).
int rcv_vp8_decode(const uint8_t* data, long size, const uint8_t* alpha, long alpha_size,
                   uint8_t* out, long stride) {
  try {
    Decoder d;
    const int rc = d.decode(data, (size_t)size);
    if (rc != kOk) return rc;
    if (stride < 4L * d.width) return kBadHeader;
    emit_rgba(d, out, stride);
    if (alpha != nullptr) {
      std::vector<uint8_t> a((size_t)d.width * d.height);
      if (rcv_webp_alpha_decode(alpha, alpha_size, d.width, d.height, a.data()) != 0)
        return kBadAlpha;
      for (int yy = 0; yy < d.height; ++yy)
        for (int x = 0; x < d.width; ++x) out[yy * stride + 4 * x + 3] = a[(size_t)yy * d.width + x];
    } else {
      for (int yy = 0; yy < d.height; ++yy)
        for (int x = 0; x < d.width; ++x) out[yy * stride + 4 * x + 3] = 255;
    }
    return kOk;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}

}  // extern "C"
