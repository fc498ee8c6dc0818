// The lossy WebP encode: Y, U and V planes (4:2:0) to a VP8 key frame (RFC
// 6386), configured as libwebp configures it for Pillow's default save
// (WebPConfigPreset DEFAULT at quality 80: 4 segments, SNS 50, the normal
// loop filter at strength 60, sharpness 0, one token partition).
//
// What the bitstream fixes is the RFC's; what the encoder chooses follows
// libwebp's encoder (src/enc) where Pillow's settings reach it:
//
// * the analysis (analysis_enc.c): per macroblock a "susceptibility" alpha
//   from the histograms of DCT coefficients of its DC and TM predictions
//   (16x16 and chroma) from the source's own neighbours, then k-means of
//   the alphas into up to 4 segments;
// * the quantizers (quant_enc.c, VP8SetSegmentParams): quality -> base
//   compression (QualityToCompression) modulated per segment by its alpha
//   and SNS, the chroma AC and DC offsets from the mean chroma alpha, each
//   segment's filter strength from its AC step and its alpha's "beta";
//   segments equal in quantizer and filter merged;
// * the decision per macroblock (RD_OPT_BASIC, PickBestIntra16/4/UV): the
//   four 16x16 modes, then the ten 4x4 modes per block (abandoned as soon
//   as their running score passes the 16x16 one), then the four chroma
//   modes, each scored as SSE plus the spectral distortion of libwebp's
//   TDisto (luma) plus lambda times the rate, the rate from the token
//   costs of the current probabilities and the mode costs; libwebp's
//   flatness penalties; chroma DC error diffusion between blocks;
// * the forward DCT and WHT (dsp/enc.c) and quantization with libwebp's
//   rounding bias, zero threshold and luma AC sharpening;
// * the token statistics: every macroblock's tokens are recorded as they
//   are decided; the coefficient probabilities are refreshed from them every
//   1/8 of the frame (so later decisions see their costs), and once more at
//   the end, where a probability is updated in the header only where its
//   saving pays for its 8 bits (FinalizeTokenProbas);
// * the loop filter levels raised where a 16x16 block kept only DCs
//   (VP8AdjustFilterStrength).
//
// The reconstruction that predicts the next blocks is the decoder's own:
// vp8.cpp's predictors over the unfiltered neighbours it would see, its
// inverse transforms, so every prediction here equals the decoder's. The
// header never enables mb_no_skip_coeff: every macroblock codes its tokens
// (as libwebp's token loop does), so none is marked skipped.
//
// Written: the 10-byte key frame header (frame tag, start code, size),
// partition 0 (the frame header, the probability updates, per macroblock
// its segment and modes), then the one token partition.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

namespace rcv_vp8 {  // defined in vp8.cpp

enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED,
       B_VL_PRED, B_HD_PRED, B_HU_PRED, NUM_BMODES,
       DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED, TM_PRED = B_TM_PRED,
       B_DC_PRED_NOTOP = 4, B_DC_PRED_NOLEFT = 5, B_DC_PRED_NOTOPLEFT = 6 };
enum { NUM_TYPES = 4, NUM_BANDS = 8, NUM_CTX = 3, NUM_PROBAS = 11 };

extern const uint8_t kDcTable[128];
extern const uint16_t kAcTable[128];
extern const uint8_t kBModesProba[NUM_BMODES][NUM_BMODES][NUM_BMODES - 1];
extern const uint8_t kCoeffsProba0[NUM_TYPES][NUM_BANDS][NUM_CTX][NUM_PROBAS];
extern const uint8_t kCoeffsUpdateProba[NUM_TYPES][NUM_BANDS][NUM_CTX][NUM_PROBAS];
extern const uint8_t kBands[16 + 1];
extern const uint8_t kZigzag[16];
extern const uint8_t kCat3[], kCat4[], kCat5[], kCat6[];

// the work buffer's layout (vp8.cpp): BPS-strided, a border row and column
void transform_one(const int16_t* in, uint8_t* dst);  // adds the residual to dst
void transform_wht(const int16_t* in, int16_t* out);
void pred16(uint8_t* dst, int mode);
void pred8uv(uint8_t* dst, int mode);
void pred4(uint8_t* dst, int mode);

}  // namespace rcv_vp8

namespace {

using namespace rcv_vp8;

enum { kOk = 0, kBadArgs = -1, kTooSmall = -2, kNoMemory = -5 };

constexpr int BPS = 32;
constexpr int Y_OFF = BPS * 1 + 8;
constexpr int U_OFF = Y_OFF + BPS * 16 + BPS;
constexpr int V_OFF = U_OFF + 16;
constexpr int YUV_SIZE = BPS * 17 + BPS * 9;

const int kScan[16] = {0 + 0 * BPS,  4 + 0 * BPS,  8 + 0 * BPS,  12 + 0 * BPS,
                       0 + 4 * BPS,  4 + 4 * BPS,  8 + 4 * BPS,  12 + 4 * BPS,
                       0 + 8 * BPS,  4 + 8 * BPS,  8 + 8 * BPS,  12 + 8 * BPS,
                       0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};
// the chroma blocks: U's four, then V's four
const int kScanUV[8] = {U_OFF + 0, U_OFF + 4, U_OFF + 4 * BPS, U_OFF + 4 * BPS + 4,
                        V_OFF + 0, V_OFF + 4, V_OFF + 4 * BPS, V_OFF + 4 * BPS + 4};

inline int clip(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }

// -- bit costs, in 1/256 bit ---------------------------------------------------

struct Costs {
  uint16_t zero[256];  // the cost of a 0 coded with probability p (of a 0, in 1/256)
  uint16_t one[256];
  Costs() {
    for (int p = 0; p < 256; ++p) {
      const int q = p < 1 ? 1 : p;
      zero[p] = (uint16_t)std::lround(-256.0 * std::log2(q / 256.0));
      one[p] = (uint16_t)std::lround(-256.0 * std::log2((256 - q) / 256.0));
    }
  }
};
const Costs& costs() {
  static const Costs c;
  return c;
}
inline int bit_cost(int bit, int p) { return bit ? costs().one[p] : costs().zero[p]; }

// -- the boolean encoder (libwebp's VP8BitWriter) ------------------------------

struct BoolWriter {
  std::vector<uint8_t> buf;
  int32_t range = 254;  // range - 1
  int32_t value = 0;
  int run = 0;          // pending 0xff bytes (a carry may still reach them)
  int nb_bits = -8;

  void flush() {
    const int s = 8 + nb_bits;
    const int32_t bits = value >> s;
    value -= bits << s;
    nb_bits -= 8;
    if ((bits & 0xff) != 0xff) {
      if ((bits & 0x100) && !buf.empty()) buf.back()++;  // the carry
      for (; run > 0; --run) buf.push_back((bits & 0x100) ? 0x00 : 0xff);
      buf.push_back((uint8_t)(bits & 0xff));
    } else {
      ++run;
    }
  }
  void renorm() {
    if (range < 127) {
      const int shift = 7 - (31 - __builtin_clz((uint32_t)range + 1));
      range = ((range + 1) << shift) - 1;
      value <<= shift;
      nb_bits += shift;
      if (nb_bits > 0) flush();
    }
  }
  int put(int bit, int prob) {
    const int split = (range * prob) >> 8;
    if (bit) {
      value += split + 1;
      range -= split + 1;
    } else {
      range = split;
    }
    renorm();
    return bit;
  }
  int put_uniform(int bit) { return put(bit, 128); }
  void put_bits(uint32_t v, int n) {
    for (uint32_t mask = 1u << (n - 1); mask; mask >>= 1) put_uniform((v & mask) != 0);
  }
  void put_signed_bits(int v, int n) {  // a flag, the magnitude, the sign
    if (!put_uniform(v != 0)) return;
    if (v < 0) {
      put_bits(((uint32_t)-v << 1) | 1, n + 1);
    } else {
      put_bits((uint32_t)v << 1, n + 1);
    }
  }
  void finish() {
    put_bits(0, 9 - nb_bits);
    nb_bits = 0;
    flush();
  }
};

// -- quantization (quant_enc.c) ------------------------------------------------

constexpr int QFIX = 17;
constexpr int MAX_LEVEL = 2047;
// rounding biases (1/256) of {DC, AC}: luma, luma DC (WHT), chroma
const int kBiasMatrices[3][2] = {{96, 110}, {96, 108}, {110, 115}};
const uint8_t kFreqSharpening[16] = {0,  30, 60, 90, 30, 60, 90, 90,
                                     60, 90, 90, 90, 90, 90, 90, 90};

struct Matrix {
  uint16_t q[16], iq[16], sharpen[16];
  uint32_t bias[16], zthresh[16];
};

// libwebp's ExpandMatrix: returns the mean step
int expand_matrix(Matrix* m, int type) {
  for (int i = 0; i < 2; ++i) {
    m->iq[i] = (uint16_t)((1 << QFIX) / m->q[i]);
    m->bias[i] = (uint32_t)kBiasMatrices[type][i > 0] << (QFIX - 8);
    m->zthresh[i] = ((1u << QFIX) - 1 - m->bias[i]) / m->iq[i];
  }
  int sum = 0;
  for (int i = 2; i < 16; ++i) {
    m->q[i] = m->q[1];
    m->iq[i] = m->iq[1];
    m->bias[i] = m->bias[1];
    m->zthresh[i] = m->zthresh[1];
  }
  for (int i = 0; i < 16; ++i) {
    m->sharpen[i] = type == 0 ? (uint16_t)((kFreqSharpening[i] * m->q[i]) >> 11) : 0;
    sum += m->q[i];
  }
  return (sum + 8) >> 4;
}

// in: raster-order coefficients, replaced by their dequantized values;
// out: the levels in zigzag order. Returns whether any level is non-zero.
int quantize_block(int16_t in[16], int16_t out[16], const Matrix& m) {
  int last = -1;
  for (int n = 0; n < 16; ++n) {
    const int j = kZigzag[n];
    const int sign = in[j] < 0;
    const uint32_t coeff = (uint32_t)(sign ? -in[j] : in[j]) + m.sharpen[j];
    if (coeff > m.zthresh[j]) {
      int level = (int)((coeff * m.iq[j] + m.bias[j]) >> QFIX);
      if (level > MAX_LEVEL) level = MAX_LEVEL;
      if (sign) level = -level;
      in[j] = (int16_t)(level * (int)m.q[j]);
      out[n] = (int16_t)level;
      if (level) last = n;
    } else {
      out[n] = 0;
      in[j] = 0;
    }
  }
  return last >= 0;
}

// -- the forward transforms (dsp/enc.c) ----------------------------------------

void ftransform(const uint8_t* src, const uint8_t* ref, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i, src += BPS, ref += BPS) {
    const int d0 = src[0] - ref[0], d1 = src[1] - ref[1], d2 = src[2] - ref[2],
              d3 = src[3] - ref[3];
    const int a0 = d0 + d3, a1 = d1 + d2, a2 = d1 - d2, a3 = d0 - d3;
    tmp[0 + i * 4] = (a0 + a1) * 8;
    tmp[1 + i * 4] = (a2 * 2217 + a3 * 5352 + 1812) >> 9;
    tmp[2 + i * 4] = (a0 - a1) * 8;
    tmp[3 + i * 4] = (a3 * 2217 - a2 * 5352 + 937) >> 9;
  }
  for (int i = 0; i < 4; ++i) {
    const int a0 = tmp[0 + i] + tmp[12 + i], a1 = tmp[4 + i] + tmp[8 + i];
    const int a2 = tmp[4 + i] - tmp[8 + i], a3 = tmp[0 + i] - tmp[12 + i];
    out[0 + i] = (int16_t)((a0 + a1 + 7) >> 4);
    out[4 + i] = (int16_t)(((a2 * 2217 + a3 * 5352 + 12000) >> 16) + (a3 != 0));
    out[8 + i] = (int16_t)((a0 - a1 + 7) >> 4);
    out[12 + i] = (int16_t)((a3 * 2217 - a2 * 5352 + 51000) >> 16);
  }
}

// the DCs of the 16 luma blocks (in[16 * n]) -> the WHT's 16 coefficients
void ftransform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i, in += 64) {
    const int a0 = in[0 * 16] + in[2 * 16], a1 = in[1 * 16] + in[3 * 16];
    const int a2 = in[1 * 16] - in[3 * 16], a3 = in[0 * 16] - in[2 * 16];
    tmp[0 + i * 4] = a0 + a1;
    tmp[1 + i * 4] = a3 + a2;
    tmp[2 + i * 4] = a3 - a2;
    tmp[3 + i * 4] = a0 - a1;
  }
  for (int i = 0; i < 4; ++i) {
    const int a0 = tmp[0 + i] + tmp[8 + i], a1 = tmp[4 + i] + tmp[12 + i];
    const int a2 = tmp[4 + i] - tmp[12 + i], a3 = tmp[0 + i] - tmp[8 + i];
    out[0 + i] = (int16_t)((a0 + a1) >> 1);
    out[4 + i] = (int16_t)((a3 + a2) >> 1);
    out[8 + i] = (int16_t)((a3 - a2) >> 1);
    out[12 + i] = (int16_t)((a0 - a1) >> 1);
  }
}

// -- distortion ------------------------------------------------------------------

int sse(const uint8_t* a, const uint8_t* b, int w, int h) {
  int s = 0;
  for (int y = 0; y < h; ++y, a += BPS, b += BPS)
    for (int x = 0; x < w; ++x) {
      const int d = a[x] - b[x];
      s += d * d;
    }
  return s;
}

const uint16_t kWeightY[16] = {38, 32, 20, 9, 32, 28, 17, 7, 20, 17, 10, 4, 9, 7, 4, 2};

// the weighted sum of a 4x4 Hadamard transform's magnitudes (TTransform)
int ttransform(const uint8_t* in, const uint16_t* w) {
  int tmp[16], sum = 0;
  for (int i = 0; i < 4; ++i, in += BPS) {
    const int a0 = in[0] + in[2], a1 = in[1] + in[3], a2 = in[1] - in[3], a3 = in[0] - in[2];
    tmp[0 + i * 4] = a0 + a1;
    tmp[1 + i * 4] = a3 + a2;
    tmp[2 + i * 4] = a3 - a2;
    tmp[3 + i * 4] = a0 - a1;
  }
  for (int i = 0; i < 4; ++i, ++w) {
    const int a0 = tmp[0 + i] + tmp[8 + i], a1 = tmp[4 + i] + tmp[12 + i];
    const int a2 = tmp[4 + i] - tmp[12 + i], a3 = tmp[0 + i] - tmp[8 + i];
    sum += w[0] * abs(a0 + a1) + w[4] * abs(a3 + a2) + w[8] * abs(a3 - a2) + w[12] * abs(a0 - a1);
  }
  return sum;
}

int tdisto4x4(const uint8_t* a, const uint8_t* b) {
  return abs(ttransform(b, kWeightY) - ttransform(a, kWeightY)) >> 5;
}

int tdisto16x16(const uint8_t* a, const uint8_t* b) {
  int d = 0;
  for (int n = 0; n < 16; ++n) d += tdisto4x4(a + kScan[n], b + kScan[n]);
  return d;
}

inline int mult_8b(int a, int b) { return (a * b + 128) >> 8; }

// -- token costs and statistics ----------------------------------------------------

constexpr int MAX_VARIABLE_LEVEL = 67;
typedef uint8_t Probas[NUM_BANDS][NUM_CTX][NUM_PROBAS];

// the cost of a level's fixed-probability bits: the sign, and the extra bits
// of categories 1-6
int fixed_level_cost(int v) {
  if (v == 0) return 0;
  int cost = 256;  // the sign
  if (v <= 4) return cost;
  if (v <= 6) return cost + bit_cost(v == 6, 159);
  if (v <= 10) return cost + bit_cost(v >= 9, 165) + bit_cost(!(v & 1), 145);
  const uint8_t* tab;
  int mask;
  if (v < 3 + (8 << 1)) {
    v -= 3 + (8 << 0);
    mask = 1 << 2;
    tab = kCat3;
  } else if (v < 3 + (8 << 2)) {
    v -= 3 + (8 << 1);
    mask = 1 << 3;
    tab = kCat4;
  } else if (v < 3 + (8 << 3)) {
    v -= 3 + (8 << 2);
    mask = 1 << 4;
    tab = kCat5;
  } else {
    v -= 3 + (8 << 3);
    mask = 1 << 10;
    tab = kCat6;
  }
  for (; mask; mask >>= 1) cost += bit_cost((v & mask) != 0, *tab++);
  return cost;
}

// the cost of the tree bits of level v (at most MAX_VARIABLE_LEVEL) with the
// probabilities p, the "not the end of block" bit included
int variable_level_cost(int v, const uint8_t* p, int with_eob_bit) {
  int cost = with_eob_bit ? bit_cost(1, p[0]) : 0;
  if (v == 0) return cost + bit_cost(0, p[1]);
  cost += bit_cost(1, p[1]);
  if (v == 1) return cost + bit_cost(0, p[2]);
  cost += bit_cost(1, p[2]);
  if (v <= 4) {
    cost += bit_cost(0, p[3]);
    if (v == 2) return cost + bit_cost(0, p[4]);
    return cost + bit_cost(1, p[4]) + bit_cost(v == 4, p[5]);
  }
  cost += bit_cost(1, p[3]);
  if (v <= 10) return cost + bit_cost(0, p[6]) + bit_cost(v > 6, p[7]);
  cost += bit_cost(1, p[6]);
  if (v < 3 + (8 << 1)) return cost + bit_cost(0, p[8]) + bit_cost(0, p[9]);
  if (v < 3 + (8 << 2)) return cost + bit_cost(0, p[8]) + bit_cost(1, p[9]);
  if (v < 3 + (8 << 3)) return cost + bit_cost(1, p[8]) + bit_cost(0, p[10]);
  return cost + bit_cost(1, p[8]) + bit_cost(1, p[10]);
}

struct LevelCosts {
  // [type][band][ctx][level]: the tree bits, and for ctx > 0 the "not the
  // end" bit a non-zero level before it makes the block code (libwebp's
  // VP8CalculateLevelCosts)
  uint16_t v[NUM_TYPES][NUM_BANDS][NUM_CTX][MAX_VARIABLE_LEVEL + 1];
  std::vector<uint16_t> fixed;  // [level]

  LevelCosts() : fixed(MAX_LEVEL + 1) {
    for (int l = 0; l <= MAX_LEVEL; ++l) fixed[l] = (uint16_t)fixed_level_cost(l);
  }
  void compute(const Probas* proba) {
    for (int t = 0; t < NUM_TYPES; ++t)
      for (int b = 0; b < NUM_BANDS; ++b)
        for (int c = 0; c < NUM_CTX; ++c)
          for (int l = 0; l <= MAX_VARIABLE_LEVEL; ++l)
            v[t][b][c][l] = (uint16_t)variable_level_cost(l, proba[t][b][c], c > 0);
  }
};

// A block's levels (zigzag order) from position `first`, as the coder sees
// them: the type (0: luma AC after a WHT, 1: the WHT, 2: chroma, 3: luma
// with its DC), and the position of the last non-zero level (-1: none).
struct Residual {
  const int16_t* levels;
  int first, type, last;
  Residual(const int16_t* lv, int first_, int type_) : levels(lv), first(first_), type(type_) {
    last = -1;
    for (int n = 15; n >= first; --n)
      if (lv[n]) {
        last = n;
        break;
      }
  }
};

// GetResidualCost
int residual_cost(int ctx0, const Residual& r, const Probas* proba, const LevelCosts& lc) {
  const uint8_t* p0 = proba[r.type][kBands[r.first]][ctx0];
  if (r.last < 0) return bit_cost(0, p0[0]);
  int cost = ctx0 == 0 ? bit_cost(1, p0[0]) : 0;
  int ctx = ctx0;
  int n = r.first;
  for (; n <= r.last; ++n) {
    const int v = abs(r.levels[n]);
    cost += lc.v[r.type][kBands[n]][ctx][v > MAX_VARIABLE_LEVEL ? MAX_VARIABLE_LEVEL : v] +
            lc.fixed[v];
    ctx = v >= 2 ? 2 : v;
  }
  if (n < 16) cost += bit_cost(0, proba[r.type][kBands[n]][ctx][0]);
  return cost;
}

// The token walk of one block (PutCoeffs): `bit(b, t, band, ctx, i)` for a
// bit coded with an adaptive probability, `fixed(b, p)` for one with a fixed
// probability (128 for the sign). Returns whether the block has a non-zero
// level (the context it leaves).
template <class Bit, class Fixed>
int walk_coeffs(int ctx, const Residual& r, Bit bit, Fixed fixed) {
  const int t = r.type;
  int n = r.first;
  int band = kBands[n];
  if (!bit(r.last >= 0, t, band, ctx, 0)) return 0;
  while (n < 16) {
    const int c = r.levels[n++];
    const int sign = c < 0;
    int v = sign ? -c : c;
    if (!bit(v != 0, t, band, ctx, 1)) {
      band = kBands[n];
      ctx = 0;
      continue;
    }
    if (!bit(v > 1, t, band, ctx, 2)) {
      band = kBands[n];
      ctx = 1;
    } else {
      if (!bit(v > 4, t, band, ctx, 3)) {
        if (bit(v != 2, t, band, ctx, 4)) bit(v == 4, t, band, ctx, 5);
      } else if (!bit(v > 10, t, band, ctx, 6)) {
        if (!bit(v > 6, t, band, ctx, 7)) {
          fixed(v == 6, 159);
        } else {
          fixed(v >= 9, 165);
          fixed(!(v & 1), 145);
        }
      } else {
        int mask;
        const uint8_t* tab;
        if (v < 3 + (8 << 1)) {
          bit(0, t, band, ctx, 8);
          bit(0, t, band, ctx, 9);
          v -= 3 + (8 << 0);
          mask = 1 << 2;
          tab = kCat3;
        } else if (v < 3 + (8 << 2)) {
          bit(0, t, band, ctx, 8);
          bit(1, t, band, ctx, 9);
          v -= 3 + (8 << 1);
          mask = 1 << 3;
          tab = kCat4;
        } else if (v < 3 + (8 << 3)) {
          bit(1, t, band, ctx, 8);
          bit(0, t, band, ctx, 10);
          v -= 3 + (8 << 2);
          mask = 1 << 4;
          tab = kCat5;
        } else {
          bit(1, t, band, ctx, 8);
          bit(1, t, band, ctx, 10);
          v -= 3 + (8 << 3);
          mask = 1 << 10;
          tab = kCat6;
        }
        for (; mask; mask >>= 1) fixed((v & mask) != 0, *tab++);
      }
      band = kBands[n];
      ctx = 2;
    }
    fixed(sign, 128);
    if (n == 16 || !bit(n <= r.last, t, band, ctx, 0)) return 1;
  }
  return 1;
}

// -- the macroblock's choices --------------------------------------------------------

constexpr int RD_DISTO_MULT = 256;
constexpr int FLATNESS_LIMIT_I16 = 10, FLATNESS_LIMIT_I4 = 3, FLATNESS_LIMIT_UV = 2;
constexpr int FLATNESS_PENALTY = 140;

struct Score {
  int64_t D = 0, SD = 0, H = 0, R = 0, score = 0;
  void set(int lambda) { score = (R + H) * lambda + RD_DISTO_MULT * (D + SD); }
  void add(const Score& o) {
    D += o.D;
    SD += o.SD;
    H += o.H;
    R += o.R;
    score += o.score;
  }
};

struct MBCode {  // what the coder writes of one macroblock
  uint8_t is_i4 = 0, segment = 0, mode_i16 = 0, mode_uv = 0;
  uint8_t modes[16] = {0};
  int16_t y_dc[16];
  int16_t y_ac[16][16];
  int16_t uv[8][16];
};

struct Segment {
  int quant = 0, fstrength = 0, alpha = 0, beta = 0;
  Matrix y1, y2, uv;
  int lambda_i4 = 0, lambda_i16 = 0, lambda_uv = 0, lambda_mode = 0, tlambda = 0;
  int min_disto = 0, max_edge = 0;
};

inline int is_flat(const int16_t* levels, int num_blocks, int thresh) {
  int score = 0;
  for (; num_blocks > 0; --num_blocks, levels += 16)
    for (int i = 1; i < 16; ++i) {
      score += levels[i] != 0;
      if (score > thresh) return 0;
    }
  return 1;
}

inline int check_mode(int mb_x, int mb_y, int mode) {  // the DC predictor at the edges
  if (mode == B_DC_PRED) {
    if (mb_x == 0) return mb_y == 0 ? B_DC_PRED_NOTOPLEFT : B_DC_PRED_NOLEFT;
    return mb_y == 0 ? B_DC_PRED_NOTOP : B_DC_PRED;
  }
  return mode;
}

void copy_block(const uint8_t* src, uint8_t* dst, int w, int h) {
  for (int y = 0; y < h; ++y) memcpy(dst + y * BPS, src + y * BPS, w);
}

struct Encoder {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  int quality = 80, method = 4, filter_strength = 60;
  static constexpr int kSns = 50, kNumSegments = 4;
  // the source, padded to whole macroblocks, and the reconstruction
  std::vector<uint8_t> ys, us, vs, yr, ur, vr;
  int ystride = 0, uvstride = 0;
  std::vector<uint8_t> mb_alpha, mb_seg;
  std::vector<MBCode> mbs;
  Segment dqm[4];
  int num_segments = kNumSegments, update_map = 0, base_quant = 0;
  uint8_t seg_probs[3] = {255, 255, 255};
  int dq_uv_ac = 0, dq_uv_dc = 0, uv_alpha = 0;
  int filter_level = 0;
  Probas proba[NUM_TYPES];
  uint32_t stats[NUM_TYPES][NUM_BANDS][NUM_CTX][NUM_PROBAS][2];  // (ones, total)
  LevelCosts lc;
  uint16_t mode_costs_i4[NUM_BMODES][NUM_BMODES][NUM_BMODES];  // [top][left][mode]
  int costs_i16[4], costs_uv[4];
  // contexts while coding
  std::vector<uint8_t> top_nz, top_modes;  // 9 and 4 per macroblock column
  uint8_t left_nz[9], left_modes[4];
  std::vector<int8_t> top_derr;  // 2 channels x 2 per macroblock column
  int8_t left_derr[2][2];
  // the work buffers
  uint8_t src[YUV_SIZE], work[YUV_SIZE];

  int cur_seg = 0;  // the segment of the macroblock being coded

  void import(const uint8_t* y, long y_stride, const uint8_t* u, const uint8_t* v,
              long uv_stride);
  void borders(int mb_x, int mb_y, const uint8_t* yp, const uint8_t* up, const uint8_t* vp,
               uint8_t* buf) const;
  void load_source(int mb_x, int mb_y);
  void analyze();
  void assign_segments(const int* alphas);
  void set_segment_params();
  void setup_matrices();
  void simplify_segments();
  void set_segment_probas();
  void init_mode_costs();
  int cost_luma16(int mb_x, const MBCode& c) const;
  int cost_uv(int mb_x, const MBCode& c) const;
  int reconstruct_i16(const uint8_t* pred, uint8_t* out, MBCode* code) const;
  int reconstruct_i4(const uint8_t* src4, const uint8_t* pred, uint8_t* out,
                     int16_t* levels) const;
  int reconstruct_uv(const uint8_t* pred, uint8_t* out, MBCode* code, int8_t derr[2][3],
                     int mb_x) const;
  void pick_i16(int mb_x, int mb_y, MBCode* code, Score* rd, uint8_t* rec);
  bool pick_i4(int mb_x, MBCode* code, const Score& rd16);
  void pick_uv(int mb_x, int mb_y, MBCode* code);
  void record(int mb_x, const MBCode& c);
  int finalize_probas();
  void encode_mbs();
  void adjust_filter_strength();
  void write_header(BoolWriter& bw) const;
  void write_modes(BoolWriter& bw);
  void write_tokens(BoolWriter& bw);
};

void Encoder::import(const uint8_t* y, long y_stride, const uint8_t* u, const uint8_t* v,
                     long uv_stride) {
  ystride = mb_w * 16;
  uvstride = mb_w * 8;
  const int ph = mb_h * 16;
  ys.assign((size_t)ystride * ph, 0);
  us.assign((size_t)uvstride * ph / 2, 0);
  vs.assign((size_t)uvstride * ph / 2, 0);
  // ImportBlock: the last column and row replicated to the macroblock edge
  auto pad = [](const uint8_t* in, long in_stride, int w, int h, uint8_t* out, int out_stride,
                int out_h) {
    for (int j = 0; j < out_h; ++j) {
      const uint8_t* row = in + (long)std::min(j, h - 1) * in_stride;
      uint8_t* dst = out + (size_t)j * out_stride;
      memcpy(dst, row, w);
      memset(dst + w, row[w - 1], out_stride - w);
    }
  };
  pad(y, y_stride, width, height, ys.data(), ystride, ph);
  const int uw = (width + 1) >> 1, uh = (height + 1) >> 1;
  pad(u, uv_stride, uw, uh, us.data(), uvstride, ph / 2);
  pad(v, uv_stride, uw, uh, vs.data(), uvstride, ph / 2);
  yr.assign(ys.size(), 0);
  ur.assign(us.size(), 0);
  vr.assign(vs.size(), 0);
}

// The work buffer's borders from planes yp, up, vp (the reconstruction, or
// the source in the analysis), as vp8.cpp's decoder fills them: the left
// column (129 at the frame's left), the row above (127 at the top), the
// corner, and the 4 pixels above and right of the macroblock that its
// right column of 4x4 blocks predicts from.
void Encoder::borders(int mb_x, int mb_y, const uint8_t* yp, const uint8_t* up,
                      const uint8_t* vp, uint8_t* buf) const {
  uint8_t* const y_dst = buf + Y_OFF;
  uint8_t* const u_dst = buf + U_OFF;
  uint8_t* const v_dst = buf + V_OFF;
  const int x0 = mb_x * 16, y0 = mb_y * 16, ux0 = mb_x * 8, uy0 = mb_y * 8;
  for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = mb_x > 0 ? yp[(y0 + j) * ystride + x0 - 1] : 129;
  for (int j = 0; j < 8; ++j) {
    u_dst[j * BPS - 1] = mb_x > 0 ? up[(uy0 + j) * uvstride + ux0 - 1] : 129;
    v_dst[j * BPS - 1] = mb_x > 0 ? vp[(uy0 + j) * uvstride + ux0 - 1] : 129;
  }
  if (mb_y > 0) {
    y_dst[-1 - BPS] = mb_x > 0 ? yp[(y0 - 1) * ystride + x0 - 1] : 129;
    u_dst[-1 - BPS] = mb_x > 0 ? up[(uy0 - 1) * uvstride + ux0 - 1] : 129;
    v_dst[-1 - BPS] = mb_x > 0 ? vp[(uy0 - 1) * uvstride + ux0 - 1] : 129;
    memcpy(y_dst - BPS, &yp[(y0 - 1) * ystride + x0], 16);
    memcpy(u_dst - BPS, &up[(uy0 - 1) * uvstride + ux0], 8);
    memcpy(v_dst - BPS, &vp[(uy0 - 1) * uvstride + ux0], 8);
    uint8_t* const top_right = y_dst - BPS + 16;
    if (mb_x >= mb_w - 1) {
      memset(top_right, yp[(y0 - 1) * ystride + x0 + 15], 4);
    } else {
      memcpy(top_right, &yp[(y0 - 1) * ystride + x0 + 16], 4);
    }
  } else {
    memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
    memset(u_dst - BPS - 1, 127, 8 + 1);
    memset(v_dst - BPS - 1, 127, 8 + 1);
  }
  uint8_t* const top_right = y_dst - BPS + 16;
  for (int r = 1; r <= 3; ++r) memcpy(top_right + 4 * r * BPS, top_right, 4);
}

void Encoder::load_source(int mb_x, int mb_y) {
  const int x0 = mb_x * 16, y0 = mb_y * 16, ux0 = mb_x * 8, uy0 = mb_y * 8;
  for (int j = 0; j < 16; ++j) memcpy(src + Y_OFF + j * BPS, &ys[(y0 + j) * ystride + x0], 16);
  for (int j = 0; j < 8; ++j) {
    memcpy(src + U_OFF + j * BPS, &us[(uy0 + j) * uvstride + ux0], 8);
    memcpy(src + V_OFF + j * BPS, &vs[(uy0 + j) * uvstride + ux0], 8);
  }
}

// -- the analysis (analysis_enc.c) ------------------------------------------------------

constexpr int MAX_ALPHA = 255, ALPHA_SCALE = 2 * MAX_ALPHA, MAX_COEFF_THRESH = 31;
constexpr int kAnalysisModes = 2;  // MAX_INTRA16_MODE, MAX_UV_MODE: DC and TM only

// GetAlpha of the histogram of |coefficient| >> 3 over the blocks at `offs`
int block_alpha(const uint8_t* source, const uint8_t* pred, const int* offs, int n) {
  int distribution[MAX_COEFF_THRESH + 1] = {0};
  int16_t out[16];
  for (int j = 0; j < n; ++j) {
    ftransform(source + offs[j], pred + offs[j], out);
    for (int k = 0; k < 16; ++k) {
      const int v = abs(out[k]) >> 3;
      ++distribution[v > MAX_COEFF_THRESH ? MAX_COEFF_THRESH : v];
    }
  }
  int max_value = 0, last_non_zero = 1;
  for (int k = 0; k <= MAX_COEFF_THRESH; ++k)
    if (distribution[k] > 0) {
      if (distribution[k] > max_value) max_value = distribution[k];
      last_non_zero = k;
    }
  return max_value > 1 ? ALPHA_SCALE * last_non_zero / max_value : 0;
}

void Encoder::analyze() {
  int alphas[MAX_ALPHA + 1] = {0};
  int64_t sum_uv_alpha = 0;
  uint8_t buf[YUV_SIZE];
  uint8_t pred[YUV_SIZE];
  int y_offs[16], uv_offs[8];
  for (int n = 0; n < 16; ++n) y_offs[n] = Y_OFF + kScan[n];
  for (int n = 0; n < 8; ++n) uv_offs[n] = kScanUV[n];
  mb_alpha.assign((size_t)mb_w * mb_h, 0);
  for (int mb_y = 0; mb_y < mb_h; ++mb_y)
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      load_source(mb_x, mb_y);
      borders(mb_x, mb_y, ys.data(), us.data(), vs.data(), buf);
      int best_alpha = -1;
      for (int mode = 0; mode < kAnalysisModes; ++mode) {
        pred16(buf + Y_OFF, check_mode(mb_x, mb_y, mode));
        copy_block(buf + Y_OFF, pred + Y_OFF, 16, 16);
        const int a = block_alpha(src, pred, y_offs, 16);
        if (a > best_alpha) best_alpha = a;
      }
      int best_uv_alpha = -1;
      for (int mode = 0; mode < kAnalysisModes; ++mode) {
        const int m = check_mode(mb_x, mb_y, mode);
        pred8uv(buf + U_OFF, m);
        pred8uv(buf + V_OFF, m);
        copy_block(buf + U_OFF, pred + U_OFF, 8, 8);
        copy_block(buf + V_OFF, pred + V_OFF, 8, 8);
        const int a = block_alpha(src, pred, uv_offs, 8);
        if (a > best_uv_alpha) best_uv_alpha = a;
      }
      int a = (3 * best_alpha + best_uv_alpha + 2) >> 2;
      a = clip(MAX_ALPHA - a, 0, MAX_ALPHA);  // FinalAlphaValue
      ++alphas[a];
      mb_alpha[mb_y * mb_w + mb_x] = (uint8_t)a;
      sum_uv_alpha += best_uv_alpha;
    }
  uv_alpha = (int)(sum_uv_alpha / (mb_w * mb_h));
  assign_segments(alphas);
}

// AssignSegments: k-means of the alphas into the segments, then
// SetSegmentAlphas
void Encoder::assign_segments(const int* alphas) {
  const int nb = num_segments;
  int centers[4], map[MAX_ALPHA + 1] = {0}, accum[4], dist_accum[4];
  int n, min_a, max_a, weighted_average = 0;
  for (n = 0; n <= MAX_ALPHA && alphas[n] == 0; ++n) {
  }
  min_a = n;
  for (n = MAX_ALPHA; n > min_a && alphas[n] == 0; --n) {
  }
  max_a = n;
  const int range_a = max_a - min_a;
  for (int k = 0, m = 1; k < nb; ++k, m += 2) centers[k] = min_a + (m * range_a) / (2 * nb);
  for (int k = 0; k < 6; ++k) {
    for (n = 0; n < nb; ++n) accum[n] = dist_accum[n] = 0;
    n = 0;
    for (int a = min_a; a <= max_a; ++a) {
      if (alphas[a]) {
        while (n + 1 < nb && abs(a - centers[n + 1]) < abs(a - centers[n])) n++;
        map[a] = n;
        dist_accum[n] += a * alphas[a];
        accum[n] += alphas[a];
      }
    }
    int displaced = 0, total_weight = 0;
    weighted_average = 0;
    for (n = 0; n < nb; ++n) {
      if (accum[n]) {
        const int new_center = (dist_accum[n] + accum[n] / 2) / accum[n];
        displaced += abs(centers[n] - new_center);
        centers[n] = new_center;
        weighted_average += new_center * accum[n];
        total_weight += accum[n];
      }
    }
    weighted_average = (weighted_average + total_weight / 2) / total_weight;
    if (displaced < 5) break;
  }
  mb_seg.assign(mb_alpha.size(), 0);
  for (size_t i = 0; i < mb_alpha.size(); ++i) mb_seg[i] = (uint8_t)map[mb_alpha[i]];
  int mn = centers[0], mx = centers[0];
  for (n = 0; n < nb; ++n) {
    mn = std::min(mn, centers[n]);
    mx = std::max(mx, centers[n]);
  }
  if (mx == mn) mx = mn + 1;
  for (n = 0; n < nb; ++n) {
    dqm[n].alpha = clip(255 * (centers[n] - weighted_average) / (mx - mn), -127, 127);
    dqm[n].beta = clip(255 * (centers[n] - mn) / (mx - mn), 0, 255);
  }
}

// VP8SetSegmentParams with SetupFilterStrength, SimplifySegments and
// SetupMatrices
void Encoder::set_segment_params() {
  const double amp = 0.9 * kSns / 100. / 128.;  // SNS_TO_DQ
  const double q = quality / 100.;
  const double linear_c = q < 0.75 ? q * (2. / 3.) : 2. * q - 1.;
  const double c_base = std::pow(linear_c, 1 / 3.);  // QualityToCompression
  for (int i = 0; i < num_segments; ++i) {
    const double expn = 1. - amp * dqm[i].alpha;
    const double c = std::pow(c_base, expn);
    dqm[i].quant = clip((int)(127. * (1. - c)), 0, 127);
  }
  base_quant = dqm[0].quant;
  for (int i = num_segments; i < 4; ++i) dqm[i].quant = base_quant;
  // the chroma offsets: AC from the mean chroma alpha, DC a fixed boost
  dq_uv_ac = (uv_alpha - 64) * (6 - -4) / (100 - 30);
  dq_uv_ac = clip(dq_uv_ac * kSns / 100, -4, 6);
  dq_uv_dc = clip(-4 * kSns / 100, -15, 15);
  // SetupFilterStrength
  const int level0 = 5 * filter_strength;
  for (int i = 0; i < 4; ++i) {
    const int qstep = kAcTable[clip(dqm[i].quant, 0, 127)] >> 2;
    const int base_strength = qstep < 63 ? qstep : 63;  // sharpness 0
    const int f = base_strength * level0 / (256 + dqm[i].beta);
    dqm[i].fstrength = f < 2 ? 0 : f > 63 ? 63 : f;
  }
  filter_level = dqm[0].fstrength;
  if (num_segments > 1) simplify_segments();
  setup_matrices();
}

void Encoder::simplify_segments() {
  int map[4] = {0, 1, 2, 3};
  int num_final = 1;
  for (int s1 = 1; s1 < num_segments; ++s1) {
    int s2, found = 0;
    for (s2 = 0; s2 < num_final; ++s2)
      if (dqm[s1].quant == dqm[s2].quant && dqm[s1].fstrength == dqm[s2].fstrength) {
        found = 1;
        break;
      }
    map[s1] = s2;
    if (!found) {
      if (num_final != s1) dqm[num_final] = dqm[s1];
      ++num_final;
    }
  }
  if (num_final < num_segments) {
    for (auto& s : mb_seg) s = (uint8_t)map[s];
    for (int i = num_final; i < num_segments; ++i) dqm[i] = dqm[num_final - 1];
    num_segments = num_final;
  }
}

void Encoder::setup_matrices() {
  const int tlambda_scale = method >= 4 ? kSns : 0;
  for (int i = 0; i < num_segments; ++i) {
    Segment& m = dqm[i];
    const int q = m.quant;
    // the steps vp8.cpp's parse_quant dequantizes with
    m.y1.q[0] = kDcTable[clip(q, 0, 127)];
    m.y1.q[1] = kAcTable[clip(q, 0, 127)];
    m.y2.q[0] = (uint16_t)(kDcTable[clip(q, 0, 127)] * 2);
    m.y2.q[1] = (uint16_t)std::max(8, (kAcTable[clip(q, 0, 127)] * 101581) >> 16);
    m.uv.q[0] = kDcTable[clip(q + dq_uv_dc, 0, 117)];
    m.uv.q[1] = kAcTable[clip(q + dq_uv_ac, 0, 127)];
    const int q_i4 = expand_matrix(&m.y1, 0);
    const int q_i16 = expand_matrix(&m.y2, 1);
    const int q_uv = expand_matrix(&m.uv, 2);
    m.lambda_i4 = std::max(1, (3 * q_i4 * q_i4) >> 7);
    m.lambda_i16 = std::max(1, 3 * q_i16 * q_i16);
    m.lambda_uv = std::max(1, (3 * q_uv * q_uv) >> 6);
    m.lambda_mode = std::max(1, (1 * q_i4 * q_i4) >> 7);
    m.tlambda = (tlambda_scale * q_i4) >> 5;
    m.min_disto = 20 * m.y1.q[0];
    m.max_edge = 0;
  }
}

// SetSegmentProbas: the tree probabilities of the segment map
void Encoder::set_segment_probas() {
  int p[4] = {0, 0, 0, 0};
  for (auto s : mb_seg) ++p[s];
  auto get = [](int a, int b) { return a + b == 0 ? 255 : (255 * a + (a + b) / 2) / (a + b); };
  if (num_segments > 1) {
    seg_probs[0] = (uint8_t)get(p[0] + p[1], p[2] + p[3]);
    seg_probs[1] = (uint8_t)get(p[0], p[1]);
    seg_probs[2] = (uint8_t)get(p[2], p[3]);
    update_map = seg_probs[0] != 255 || seg_probs[1] != 255 || seg_probs[2] != 255;
    if (!update_map) std::fill(mb_seg.begin(), mb_seg.end(), 0);
  } else {
    update_map = 0;
  }
}

// the costs of the modes: 16x16 and chroma from the key frame's fixed trees,
// 4x4 from kBModesProba per context
void Encoder::init_mode_costs() {
  costs_i16[DC_PRED] = bit_cost(1, 145) + bit_cost(0, 156) + bit_cost(0, 163);
  costs_i16[V_PRED] = bit_cost(1, 145) + bit_cost(0, 156) + bit_cost(1, 163);
  costs_i16[H_PRED] = bit_cost(1, 145) + bit_cost(1, 156) + bit_cost(0, 128);
  costs_i16[TM_PRED] = bit_cost(1, 145) + bit_cost(1, 156) + bit_cost(1, 128);
  costs_uv[DC_PRED] = bit_cost(0, 142);
  costs_uv[V_PRED] = bit_cost(1, 142) + bit_cost(0, 114);
  costs_uv[H_PRED] = bit_cost(1, 142) + bit_cost(1, 114) + bit_cost(0, 183);
  costs_uv[TM_PRED] = bit_cost(1, 142) + bit_cost(1, 114) + bit_cost(1, 183);
  for (int t = 0; t < NUM_BMODES; ++t)
    for (int l = 0; l < NUM_BMODES; ++l) {
      const uint8_t* p = kBModesProba[t][l];
      for (int m = 0; m < NUM_BMODES; ++m) {  // PutI4Mode's tree
        int c = bit_cost(m != B_DC_PRED, p[0]);
        if (m != B_DC_PRED) {
          c += bit_cost(m != B_TM_PRED, p[1]);
          if (m != B_TM_PRED) {
            c += bit_cost(m != B_VE_PRED, p[2]);
            if (m != B_VE_PRED) {
              c += bit_cost(m >= B_LD_PRED, p[3]);
              if (m < B_LD_PRED) {
                c += bit_cost(m != B_HE_PRED, p[4]);
                if (m != B_HE_PRED) c += bit_cost(m != B_RD_PRED, p[5]);
              } else {
                c += bit_cost(m != B_LD_PRED, p[6]);
                if (m != B_LD_PRED) {
                  c += bit_cost(m != B_VL_PRED, p[7]);
                  if (m != B_VL_PRED) c += bit_cost(m != B_HD_PRED, p[8]);
                }
              }
            }
          }
        }
        mode_costs_i4[t][l][m] = (uint16_t)c;
      }
    }
}


// -- the rate of a macroblock's blocks (VP8GetCostLuma16/4, VP8GetCostUV) ------------

int Encoder::cost_luma16(int mb_x, const MBCode& c) const {
  const uint8_t* tn = &top_nz[mb_x * 9];
  uint8_t t[4], l[4];
  memcpy(t, tn, 4);
  memcpy(l, left_nz, 4);
  int R = residual_cost(tn[8] + left_nz[8], Residual(c.y_dc, 0, 1), proba, lc);
  for (int y = 0; y < 4; ++y)
    for (int x = 0; x < 4; ++x) {
      const Residual r(c.y_ac[x + y * 4], 1, 0);
      R += residual_cost(t[x] + l[y], r, proba, lc);
      t[x] = l[y] = r.last >= 0;
    }
  return R;
}

int Encoder::cost_uv(int mb_x, const MBCode& c) const {
  uint8_t t[9], l[9];
  memcpy(t, &top_nz[mb_x * 9], 9);
  memcpy(l, left_nz, 9);
  int R = 0;
  for (int ch = 0; ch <= 2; ch += 2)
    for (int y = 0; y < 2; ++y)
      for (int x = 0; x < 2; ++x) {
        const Residual r(c.uv[ch * 2 + x + y * 2], 0, 2);
        R += residual_cost(t[4 + ch + x] + l[4 + ch + y], r, proba, lc);
        t[4 + ch + x] = l[4 + ch + y] = r.last >= 0;
      }
  return R;
}

// -- reconstruction (ReconstructIntra16/4, ReconstructUV) -----------------------------

// pred and out: the 16x16 luma at BPS stride
int Encoder::reconstruct_i16(const uint8_t* pred, uint8_t* out, MBCode* code) const {
  const Segment& s = dqm[cur_seg];
  int16_t tmp[16][16], dc_tmp[16];
  int nz = 0;
  for (int n = 0; n < 16; ++n) ftransform(src + Y_OFF + kScan[n], pred + kScan[n], tmp[n]);
  ftransform_wht(tmp[0], dc_tmp);
  nz |= quantize_block(dc_tmp, code->y_dc, s.y2) << 24;
  for (int n = 0; n < 16; ++n) {
    tmp[n][0] = 0;
    nz |= quantize_block(tmp[n], code->y_ac[n], s.y1) << n;
  }
  transform_wht(dc_tmp, tmp[0]);
  copy_block(pred, out, 16, 16);
  for (int n = 0; n < 16; ++n) transform_one(tmp[n], out + kScan[n]);
  return nz;
}

int Encoder::reconstruct_i4(const uint8_t* src4, const uint8_t* pred, uint8_t* out,
                            int16_t* levels) const {
  int16_t tmp[16];
  ftransform(src4, pred, tmp);
  const int nz = quantize_block(tmp, levels, dqm[cur_seg].y1);
  copy_block(pred, out, 4, 4);
  transform_one(tmp, out);
  return nz;
}

// QuantizeSingle: a DC quantized alone, its error (halved) returned
int quantize_single(int16_t* v, const Matrix& m) {
  int V = *v;
  const int sign = V < 0;
  if (sign) V = -V;
  if (V > (int)m.zthresh[0]) {
    const int qV = (int)(((uint32_t)V * m.iq[0] + m.bias[0]) >> QFIX) * m.q[0];
    const int err = V - qV;
    *v = (int16_t)(sign ? -qV : qV);
    return (sign ? -err : err) >> 1;
  }
  *v = 0;
  return (sign ? -V : V) >> 1;
}

// pred and out: whole work buffers (U at U_OFF, V at V_OFF). With diffusion,
// each chroma DC first takes 7/16 of the error of the block above and 8/16
// of the block on its left (CorrectDCValues); derr gets the errors the
// next macroblocks take.
int Encoder::reconstruct_uv(const uint8_t* pred, uint8_t* out, MBCode* code, int8_t derr[2][3],
                            int mb_x) const {
  const Matrix& m = dqm[cur_seg].uv;
  int16_t tmp[8][16];
  int nz = 0;
  for (int n = 0; n < 8; ++n) ftransform(src + kScanUV[n], pred + kScanUV[n], tmp[n]);
  for (int ch = 0; ch <= 1; ++ch) {
    const int8_t* top = &top_derr[(mb_x * 2 + ch) * 2];
    const int8_t* left = left_derr[ch];
    int16_t(*c)[16] = &tmp[ch * 4];
    c[0][0] = (int16_t)(c[0][0] + ((7 * top[0] + 8 * left[0]) >> 3));
    const int err0 = quantize_single(&c[0][0], m);
    c[1][0] = (int16_t)(c[1][0] + ((7 * top[1] + 8 * err0) >> 3));
    const int err1 = quantize_single(&c[1][0], m);
    c[2][0] = (int16_t)(c[2][0] + ((7 * err0 + 8 * left[1]) >> 3));
    const int err2 = quantize_single(&c[2][0], m);
    c[3][0] = (int16_t)(c[3][0] + ((7 * err1 + 8 * err2) >> 3));
    const int err3 = quantize_single(&c[3][0], m);
    derr[ch][0] = (int8_t)err1;
    derr[ch][1] = (int8_t)err2;
    derr[ch][2] = (int8_t)err3;
  }
  for (int n = 0; n < 8; ++n) nz |= quantize_block(tmp[n], code->uv[n], m) << n;
  copy_block(pred + U_OFF, out + U_OFF, 8, 8);
  copy_block(pred + V_OFF, out + V_OFF, 8, 8);
  for (int n = 0; n < 8; ++n) transform_one(tmp[n], out + kScanUV[n]);
  return nz << 16;
}

// -- the choices (PickBestIntra16, PickBestIntra4, PickBestUV) ----------------------

void Encoder::pick_i16(int mb_x, int mb_y, MBCode* code, Score* rd, uint8_t* rec) {
  Segment& s = dqm[cur_seg];
  const uint8_t* const srcy = src + Y_OFF;
  int is_flat_src = 1;
  for (int j = 0; j < 16 && is_flat_src; ++j)
    for (int i = 0; i < 16; ++i)
      if (srcy[j * BPS + i] != srcy[0]) {
        is_flat_src = 0;
        break;
      }
  uint8_t pred[16 * BPS], cand[16 * BPS];
  MBCode tmp;
  int best_nz = 0;
  for (int mode = 0; mode < 4; ++mode) {
    pred16(work + Y_OFF, check_mode(mb_x, mb_y, mode));
    copy_block(work + Y_OFF, pred, 16, 16);
    Score cur;
    const int nz = reconstruct_i16(pred, cand, &tmp);
    cur.D = sse(srcy, cand, 16, 16);
    cur.SD = s.tlambda ? mult_8b(s.tlambda, tdisto16x16(srcy, cand)) : 0;
    cur.H = costs_i16[mode];
    cur.R = cost_luma16(mb_x, tmp);
    if (is_flat_src) {
      is_flat_src = is_flat(tmp.y_ac[0], 16, FLATNESS_LIMIT_I16);
      if (is_flat_src) {  // a flat block: its distortion counts twice
        cur.D *= 2;
        cur.SD *= 2;
      }
    }
    cur.set(s.lambda_i16);
    if (mode == 0 || cur.score < rd->score) {
      *rd = cur;
      best_nz = nz;
      code->mode_i16 = (uint8_t)mode;
      memcpy(code->y_dc, tmp.y_dc, sizeof(tmp.y_dc));
      memcpy(code->y_ac, tmp.y_ac, sizeof(tmp.y_ac));
      copy_block(cand, rec, 16, 16);
    }
  }
  rd->set(s.lambda_mode);
  code->is_i4 = 0;
  // a macroblock that kept only its DCs, with a large distortion: the edge
  // the loop filter has to smooth (StoreMaxDelta)
  if ((best_nz & 0x100ffff) == 0x1000000 && rd->D > s.min_disto) {
    const int v = std::max(abs(code->y_dc[1]), std::max(abs(code->y_dc[2]), abs(code->y_dc[4])));
    if (v > s.max_edge) s.max_edge = v;
  }
}

bool Encoder::pick_i4(int mb_x, MBCode* code, const Score& rd16) {
  const Segment& s = dqm[cur_seg];
  Score best;
  best.H = bit_cost(0, 145);
  best.set(s.lambda_mode);
  uint8_t tnz[4], lnz[4], modes[16];
  memcpy(tnz, &top_nz[mb_x * 9], 4);
  memcpy(lnz, left_nz, 4);
  int16_t levels[16][16];
  int64_t total_header_bits = 0;
  uint8_t pred[4 * BPS], cand[4 * BPS], keep[4 * BPS];
  for (int i4 = 0; i4 < 16; ++i4) {
    const int x = i4 & 3, y = i4 >> 2;
    uint8_t* const dst = work + Y_OFF + kScan[i4];
    const uint8_t* const src4 = src + Y_OFF + kScan[i4];
    const int top = y ? modes[i4 - 4] : top_modes[mb_x * 4 + x];
    const int left = x ? modes[i4 - 1] : left_modes[y];
    Score blk;
    int best_mode = -1, best_nz = 0;
    for (int mode = 0; mode < NUM_BMODES; ++mode) {
      pred4(dst, mode);
      copy_block(dst, pred, 4, 4);
      int16_t lv[16];
      const int nz = reconstruct_i4(src4, pred, cand, lv);
      Score cur;
      cur.D = sse(src4, cand, 4, 4);
      cur.SD = s.tlambda ? mult_8b(s.tlambda, tdisto4x4(src4, cand)) : 0;
      cur.H = mode_costs_i4[top][left][mode];
      // a flat block mispredicted by a complex mode pays a penalty
      cur.R = (mode > 0 && is_flat(lv, 1, FLATNESS_LIMIT_I4)) ? FLATNESS_PENALTY : 0;
      cur.set(s.lambda_i4);
      if (best_mode >= 0 && cur.score >= blk.score) continue;
      cur.R += residual_cost(tnz[x] + lnz[y], Residual(lv, 0, 3), proba, lc);
      cur.set(s.lambda_i4);
      if (best_mode < 0 || cur.score < blk.score) {
        blk = cur;
        best_mode = mode;
        best_nz = nz;
        copy_block(cand, keep, 4, 4);
        memcpy(levels[i4], lv, sizeof(lv));
      }
    }
    blk.set(s.lambda_mode);
    best.add(blk);
    if (best.score >= rd16.score) return false;
    total_header_bits += blk.H;
    if (total_header_bits > 256 * 16 * 16) return false;  // max_i4_header_bits
    copy_block(keep, dst, 4, 4);
    modes[i4] = (uint8_t)best_mode;
    tnz[x] = lnz[y] = best_nz ? 1 : 0;
  }
  code->is_i4 = 1;
  memcpy(code->modes, modes, 16);
  memcpy(code->y_ac, levels, sizeof(levels));
  return true;
}

void Encoder::pick_uv(int mb_x, int mb_y, MBCode* code) {
  const Segment& s = dqm[cur_seg];
  uint8_t pred[YUV_SIZE], cand[YUV_SIZE], keep[YUV_SIZE];
  int8_t derr[2][3], best_derr[2][3] = {{0}};
  MBCode tmp;
  Score best;
  for (int mode = 0; mode < 4; ++mode) {
    const int m = check_mode(mb_x, mb_y, mode);
    pred8uv(work + U_OFF, m);
    pred8uv(work + V_OFF, m);
    copy_block(work + U_OFF, pred + U_OFF, 8, 8);
    copy_block(work + V_OFF, pred + V_OFF, 8, 8);
    reconstruct_uv(pred, cand, &tmp, derr, mb_x);
    Score cur;
    cur.D = sse(src + U_OFF, cand + U_OFF, 8, 8) + sse(src + V_OFF, cand + V_OFF, 8, 8);
    cur.H = costs_uv[mode];
    cur.R = cost_uv(mb_x, tmp);
    if (mode > 0 && is_flat(tmp.uv[0], 8, FLATNESS_LIMIT_UV)) cur.R += FLATNESS_PENALTY * 8;
    cur.set(s.lambda_uv);
    if (mode == 0 || cur.score < best.score) {
      best = cur;
      code->mode_uv = (uint8_t)mode;
      memcpy(code->uv, tmp.uv, sizeof(tmp.uv));
      memcpy(best_derr, derr, sizeof(derr));
      copy_block(cand + U_OFF, keep + U_OFF, 8, 8);
      copy_block(cand + V_OFF, keep + V_OFF, 8, 8);
    }
  }
  copy_block(keep + U_OFF, work + U_OFF, 8, 8);
  copy_block(keep + V_OFF, work + V_OFF, 8, 8);
  for (int ch = 0; ch <= 1; ++ch) {  // StoreDiffusionErrors
    int8_t* top = &top_derr[(mb_x * 2 + ch) * 2];
    left_derr[ch][0] = best_derr[ch][0];
    left_derr[ch][1] = (int8_t)((3 * best_derr[ch][2]) >> 2);
    top[0] = best_derr[ch][1];
    top[1] = (int8_t)(best_derr[ch][2] - left_derr[ch][1]);
  }
}

// -- the token statistics and contexts --------------------------------------------

// The walk of a macroblock's blocks in coding order, with the contexts of
// column mb_x: fn(ctx, residual) returns the context the block leaves.
template <class Fn>
void walk_mb(const MBCode& c, uint8_t* tn, uint8_t* ln, Fn fn) {
  if (!c.is_i4) {
    tn[8] = ln[8] = (uint8_t)fn(tn[8] + ln[8], Residual(c.y_dc, 0, 1));
  }
  const int first = c.is_i4 ? 0 : 1, type = c.is_i4 ? 3 : 0;
  for (int y = 0; y < 4; ++y)
    for (int x = 0; x < 4; ++x)
      tn[x] = ln[y] = (uint8_t)fn(tn[x] + ln[y], Residual(c.y_ac[x + y * 4], first, type));
  for (int ch = 0; ch <= 2; ch += 2)
    for (int y = 0; y < 2; ++y)
      for (int x = 0; x < 2; ++x)
        tn[4 + ch + x] = ln[4 + ch + y] =
            (uint8_t)fn(tn[4 + ch + x] + ln[4 + ch + y], Residual(c.uv[ch * 2 + x + y * 2], 0, 2));
}

void Encoder::record(int mb_x, const MBCode& c) {
  auto bit = [this](int b, int t, int band, int ctx, int i) {
    stats[t][band][ctx][i][0] += b != 0;
    stats[t][band][ctx][i][1] += 1;
    return b;
  };
  auto fixed = [](int, int) {};
  walk_mb(c, &top_nz[mb_x * 9], left_nz,
          [&](int ctx, const Residual& r) { return walk_coeffs(ctx, r, bit, fixed); });
  if (c.is_i4) {
    for (int x = 0; x < 4; ++x) top_modes[mb_x * 4 + x] = c.modes[12 + x];
    for (int y = 0; y < 4; ++y) left_modes[y] = c.modes[y * 4 + 3];
  } else {
    memset(&top_modes[mb_x * 4], c.mode_i16, 4);
    memset(left_modes, c.mode_i16, 4);
  }
}

// FinalizeTokenProbas: a probability leaves its default only where the bits
// it saves pay for its update
int Encoder::finalize_probas() {
  int size = 0;
  for (int t = 0; t < NUM_TYPES; ++t)
    for (int b = 0; b < NUM_BANDS; ++b)
      for (int c = 0; c < NUM_CTX; ++c)
        for (int p = 0; p < NUM_PROBAS; ++p) {
          const int64_t nb = stats[t][b][c][p][0], total = stats[t][b][c][p][1];
          const int update_proba = kCoeffsUpdateProba[t][b][c][p];
          const int old_p = kCoeffsProba0[t][b][c][p];
          const int new_p = nb ? std::max(1, (int)(255 - nb * 255 / total)) : 255;
          const int64_t old_cost =
              nb * bit_cost(1, old_p) + (total - nb) * bit_cost(0, old_p) + bit_cost(0, update_proba);
          const int64_t new_cost = nb * bit_cost(1, new_p) + (total - nb) * bit_cost(0, new_p) +
                                   bit_cost(1, update_proba) + 8 * 256;
          const int use_new = old_cost > new_cost;
          size += bit_cost(use_new, update_proba) + (use_new ? 8 * 256 : 0);
          proba[t][b][c][p] = (uint8_t)(use_new ? new_p : old_p);
        }
  return size;
}

// -- the frame ------------------------------------------------------------------------------

void Encoder::encode_mbs() {
  top_nz.assign((size_t)mb_w * 9, 0);
  top_modes.assign((size_t)mb_w * 4, B_DC_PRED);
  top_derr.assign((size_t)mb_w * 4, 0);
  memcpy(proba, kCoeffsProba0, sizeof(proba));
  memset(stats, 0, sizeof(stats));
  lc.compute(proba);
  mbs.assign((size_t)mb_w * mb_h, MBCode());
  const int max_count = std::max(96, (mb_w * mb_h) >> 3);  // refresh ~8 times per frame
  int cnt = max_count;
  uint8_t rec16[16 * BPS];
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    memset(left_nz, 0, sizeof(left_nz));
    memset(left_modes, B_DC_PRED, sizeof(left_modes));
    memset(left_derr, 0, sizeof(left_derr));
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const int i = mb_y * mb_w + mb_x;
      load_source(mb_x, mb_y);
      borders(mb_x, mb_y, yr.data(), ur.data(), vr.data(), work);
      cur_seg = mb_seg[i];
      if (--cnt < 0) {
        finalize_probas();
        lc.compute(proba);
        cnt = max_count;
      }
      MBCode& code = mbs[i];
      code.segment = (uint8_t)cur_seg;
      Score rd;
      pick_i16(mb_x, mb_y, &code, &rd, rec16);
      if (!pick_i4(mb_x, &code, rd)) copy_block(rec16, work + Y_OFF, 16, 16);
      pick_uv(mb_x, mb_y, &code);
      record(mb_x, code);
      const int x0 = mb_x * 16, y0 = mb_y * 16;
      for (int j = 0; j < 16; ++j) memcpy(&yr[(y0 + j) * ystride + x0], work + Y_OFF + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        memcpy(&ur[(y0 / 2 + j) * uvstride + x0 / 2], work + U_OFF + j * BPS, 8);
        memcpy(&vr[(y0 / 2 + j) * uvstride + x0 / 2], work + V_OFF + j * BPS, 8);
      }
    }
  }
  finalize_probas();
}

// VP8AdjustFilterStrength: a segment whose 16x16 blocks kept only DCs is
// filtered at least as strongly as its largest DC step asks
void Encoder::adjust_filter_strength() {
  if (filter_strength <= 0) return;
  int max_level = 0;
  for (int s = 0; s < 4; ++s) {
    const int delta = (dqm[s].max_edge * dqm[s].y2.q[1]) >> 3;
    const int level = delta < 63 ? delta : 63;
    if (level > dqm[s].fstrength) dqm[s].fstrength = level;
    max_level = std::max(max_level, dqm[s].fstrength);
  }
  filter_level = max_level;
}

// the frame header of partition 0 (RFC 6386 9.2-9.11, 19.2)
void Encoder::write_header(BoolWriter& bw) const {
  bw.put_uniform(0);  // colour space
  bw.put_uniform(0);  // clamping type
  if (bw.put_uniform(num_segments > 1)) {  // segmentation
    bw.put_uniform(update_map);
    if (bw.put_uniform(1)) {  // update the segment data
      bw.put_uniform(1);      // absolute values
      for (int s = 0; s < 4; ++s) bw.put_signed_bits(dqm[s].quant, 7);
      for (int s = 0; s < 4; ++s) bw.put_signed_bits(dqm[s].fstrength, 6);
    }
    if (update_map)
      for (int s = 0; s < 3; ++s)
        if (bw.put_uniform(seg_probs[s] != 255)) bw.put_bits(seg_probs[s], 8);
  }
  bw.put_uniform(0);  // the normal loop filter
  bw.put_bits(filter_level, 6);
  bw.put_bits(0, 3);   // sharpness
  bw.put_uniform(0);   // no loop filter deltas
  bw.put_bits(0, 2);   // one token partition
  bw.put_bits(base_quant, 7);
  bw.put_signed_bits(0, 4);  // y1 DC
  bw.put_signed_bits(0, 4);  // y2 DC
  bw.put_signed_bits(0, 4);  // y2 AC
  bw.put_signed_bits(dq_uv_dc, 4);
  bw.put_signed_bits(dq_uv_ac, 4);
  bw.put_uniform(0);  // refresh_entropy_probs
  for (int t = 0; t < NUM_TYPES; ++t)
    for (int b = 0; b < NUM_BANDS; ++b)
      for (int c = 0; c < NUM_CTX; ++c)
        for (int p = 0; p < NUM_PROBAS; ++p) {
          const int v = proba[t][b][c][p];
          if (bw.put(v != kCoeffsProba0[t][b][c][p], kCoeffsUpdateProba[t][b][c][p]))
            bw.put_bits(v, 8);
        }
  bw.put_uniform(0);  // mb_no_skip_coeff: every macroblock codes its tokens
}

// per macroblock: its segment, its luma and chroma modes (RFC 6386 11.2-11.4)
void Encoder::write_modes(BoolWriter& bw) {
  std::vector<uint8_t> tm((size_t)mb_w * 4, B_DC_PRED);
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    uint8_t lm[4] = {B_DC_PRED, B_DC_PRED, B_DC_PRED, B_DC_PRED};
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const MBCode& c = mbs[mb_y * mb_w + mb_x];
      uint8_t* top = &tm[mb_x * 4];
      if (update_map) {
        if (bw.put(c.segment >= 2, seg_probs[0])) {
          bw.put(c.segment & 1, seg_probs[2]);
        } else {
          bw.put(c.segment & 1, seg_probs[1]);
        }
      }
      if (bw.put(!c.is_i4, 145)) {
        const int m = c.mode_i16;
        if (bw.put(m == TM_PRED || m == H_PRED, 156)) {
          bw.put(m == TM_PRED, 128);
        } else {
          bw.put(m == V_PRED, 163);
        }
        memset(top, m, 4);
        memset(lm, m, 4);
      } else {
        for (int y = 0; y < 4; ++y) {
          int left = lm[y];
          for (int x = 0; x < 4; ++x) {
            const int m = c.modes[y * 4 + x];
            const uint8_t* p = kBModesProba[top[x]][left];
            if (bw.put(m != B_DC_PRED, p[0]) && bw.put(m != B_TM_PRED, p[1]) &&
                bw.put(m != B_VE_PRED, p[2])) {
              if (!bw.put(m >= B_LD_PRED, p[3])) {
                if (bw.put(m != B_HE_PRED, p[4])) bw.put(m != B_RD_PRED, p[5]);
              } else if (bw.put(m != B_LD_PRED, p[6]) && bw.put(m != B_VL_PRED, p[7])) {
                bw.put(m != B_HD_PRED, p[8]);
              }
            }
            top[x] = (uint8_t)m;
            left = m;
          }
          lm[y] = (uint8_t)left;
        }
      }
      const int uv = c.mode_uv;
      if (bw.put(uv != DC_PRED, 142) && bw.put(uv != V_PRED, 114)) bw.put(uv != H_PRED, 183);
    }
  }
}

// the token partition: every macroblock's blocks (RFC 6386 13)
void Encoder::write_tokens(BoolWriter& bw) {
  std::vector<uint8_t> tn((size_t)mb_w * 9, 0);
  auto bit = [&](int b, int t, int band, int ctx, int i) {
    return bw.put(b, proba[t][band][ctx][i]);
  };
  auto fixed = [&](int b, int p) { bw.put(b, p); };
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    uint8_t ln[9] = {0};
    for (int mb_x = 0; mb_x < mb_w; ++mb_x)
      walk_mb(mbs[mb_y * mb_w + mb_x], &tn[mb_x * 9], ln,
              [&](int ctx, const Residual& r) { return walk_coeffs(ctx, r, bit, fixed); });
  }
}

// WebPCleanupTransparentArea (picture_tools_enc.c) on the YUV planes, as
// libwebp runs it before a lossy encode unless `exact` is set: an 8x8 block
// whose alpha is all 0 takes one flat colour (the first of its run of such
// blocks along the row: luma 8x8, chroma 4x4); in a block only partly
// transparent, the transparent pixels take the mean luma of the others.
int smoothen_block(const uint8_t* a, long a_stride, uint8_t* y, long y_stride, int w, int h) {
  int sum = 0, count = 0;
  for (int j = 0; j < h; ++j)
    for (int i = 0; i < w; ++i)
      if (a[j * a_stride + i] != 0) {
        ++count;
        sum += y[j * y_stride + i];
      }
  if (count > 0 && count < w * h) {
    const uint8_t avg = (uint8_t)(sum / count);
    for (int j = 0; j < h; ++j)
      for (int i = 0; i < w; ++i)
        if (a[j * a_stride + i] == 0) y[j * y_stride + i] = avg;
  }
  return count == 0;
}

void flatten(uint8_t* p, int v, long stride, int size) {
  for (int j = 0; j < size; ++j) memset(p + j * stride, v, size);
}

void cleanup_transparent(uint8_t* y, long ys, uint8_t* u, uint8_t* v, long uvs, const uint8_t* a,
                         long as, int width, int height) {
  int values[3] = {0, 0, 0};
  int row = 0;
  for (; row + 8 <= height; row += 8) {
    int need_reset = 1, x = 0;
    uint8_t* yp = y + row * ys;
    uint8_t* up = u + (row / 2) * uvs;
    uint8_t* vp = v + (row / 2) * uvs;
    const uint8_t* ap = a + row * as;
    for (; x + 8 <= width; x += 8) {
      if (smoothen_block(ap + x, as, yp + x, ys, 8, 8)) {
        if (need_reset) {
          values[0] = yp[x];
          values[1] = up[x >> 1];
          values[2] = vp[x >> 1];
          need_reset = 0;
        }
        flatten(yp + x, values[0], ys, 8);
        flatten(up + (x >> 1), values[1], uvs, 4);
        flatten(vp + (x >> 1), values[2], uvs, 4);
      } else {
        need_reset = 1;
      }
    }
    if (x < width) smoothen_block(ap + x, as, yp + x, ys, width - x, 8);
  }
  if (row < height) {
    int x = 0;
    for (; x + 8 <= width; x += 8)
      smoothen_block(a + row * as + x, as, y + row * ys + x, ys, 8, height - row);
    if (x < width) smoothen_block(a + row * as + x, as, y + row * ys + x, ys, width - x, height - row);
  }
}

}  // namespace

extern "C" {

// Y (width x height, rows y_stride apart), U and V ((width + 1) / 2 x
// (height + 1) / 2, rows uv_stride apart) -> a VP8 chunk's payload at out
// (cap bytes). alpha (rows a_stride apart) or null: where given, the
// transparent area is flattened first (WebPCleanupTransparentArea).
// quality 0-100, method 0-6 (4 and up weigh the spectral distortion in the
// luma choices, as libwebp does), filter_strength 0-100 (60: Pillow's; 0: no
// loop filter). Returns the payload's size, or a negative code: -1 bad
// arguments, -2 out too small, -5 out of memory.
long rcv_vp8_encode(const uint8_t* y, long y_stride, const uint8_t* u, const uint8_t* v,
                    long uv_stride, const uint8_t* alpha, long a_stride, int width, int height,
                    int quality, int method, int filter_strength, uint8_t* out, long cap) {
  try {
    if (width < 1 || height < 1 || width > 16383 || height > 16383 || quality < 0 ||
        quality > 100 || filter_strength < 0 || filter_strength > 100)
      return kBadArgs;
    Encoder enc;
    enc.width = width;
    enc.height = height;
    enc.mb_w = (width + 15) >> 4;
    enc.mb_h = (height + 15) >> 4;
    enc.quality = quality;
    enc.method = method;
    enc.filter_strength = filter_strength;
    enc.init_mode_costs();
    std::vector<uint8_t> yc, uc, vc;
    if (alpha != nullptr) {  // the cleanup works on copies
      const int uw = (width + 1) >> 1, uh = (height + 1) >> 1;
      yc.resize((size_t)width * height);
      uc.resize((size_t)uw * uh);
      vc.resize((size_t)uw * uh);
      for (int j = 0; j < height; ++j) memcpy(&yc[(size_t)j * width], y + j * y_stride, width);
      for (int j = 0; j < uh; ++j) {
        memcpy(&uc[(size_t)j * uw], u + j * uv_stride, uw);
        memcpy(&vc[(size_t)j * uw], v + j * uv_stride, uw);
      }
      cleanup_transparent(yc.data(), width, uc.data(), vc.data(), uw, alpha, a_stride, width,
                          height);
      y = yc.data();
      u = uc.data();
      v = vc.data();
      y_stride = width;
      uv_stride = uw;
    }
    enc.import(y, y_stride, u, v, uv_stride);
    enc.analyze();
    enc.set_segment_params();
    enc.set_segment_probas();
    enc.encode_mbs();
    enc.adjust_filter_strength();
    BoolWriter part0, tokens;
    enc.write_header(part0);
    enc.write_modes(part0);
    part0.finish();
    enc.write_tokens(tokens);
    tokens.finish();
    const size_t size0 = part0.buf.size();
    if (size0 >= (1u << 19)) return kBadArgs;  // partition 0 past its 19-bit size
    const long total = (long)(10 + size0 + tokens.buf.size());
    if (total > cap) return kTooSmall;
    const int profile = filter_strength > 0 ? 0 : 2;  // libwebp's: normal filter, or none
    const uint32_t tag = 0u | (profile << 1) | (1u << 4) | ((uint32_t)size0 << 5);
    out[0] = tag & 0xff;
    out[1] = (tag >> 8) & 0xff;
    out[2] = (tag >> 16) & 0xff;
    out[3] = 0x9d;
    out[4] = 0x01;
    out[5] = 0x2a;
    out[6] = width & 0xff;
    out[7] = (width >> 8) & 0x3f;
    out[8] = height & 0xff;
    out[9] = (height >> 8) & 0x3f;
    memcpy(out + 10, part0.buf.data(), size0);
    memcpy(out + 10 + size0, tokens.buf.data(), tokens.buf.size());
    return total;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}

}  // extern "C"
