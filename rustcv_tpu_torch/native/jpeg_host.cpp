// Full JPEG decode on the host, to BGR, with no libjpeg: the decode that
// libjpeg-turbo makes with its default settings, which is what the
// reference gets from Pillow (and from its own libjpeg-turbo binding).
//
//   entropy decode   the port's decoder (jpeg_entropy.cpp,
//                    rcv_jpeg_host_coeffs): baseline and extended
//                    sequential, in one scan or several, progressive,
//                    arithmetic-coded (sequential and progressive), one to
//                    four components; lossless frames come out of it as
//                    samples, and skip the next three steps
//   smoothing        libjpeg's block smoothing (jdcoefct.c,
//                    decompress_smooth_data) of a progressive frame whose
//                    DC is known in every component and some of whose
//                    first nine AC coefficients (zigzag 1..9) are not
//                    refined to their last bit at EOI: each such
//                    coefficient still zero is estimated from the DC values
//                    of the 5x5 blocks around it, and where none of those
//                    nine came at all, the DC is re-estimated too
//   dequantize       coefficient x quant table entry
//   IDCT             the integer "islow" 8x8 inverse DCT: a column pass
//                    kept with 2 extra fraction bits, a row pass, 13-bit
//                    fixed-point constants, each result rounded and
//                    clamped to 0..255 after the +128 level shift
//   upsample         libjpeg's choice per component, by its expansion
//                    against the largest factors: none at full size;
//                    "fancy" (triangle) h2v1, which weighs the nearer
//                    sample 3/4 and the further 1/4 across the row; h1v2
//                    (4:4:0), the same down the column with biases 1 and 2
//                    of 4; h2v2, down the column first (sums of 3 near + 1
//                    far), then across with 3/4, 1/4 weights and
//                    alternating rounding biases (8 and 7 of 16); planes
//                    end by repeating their last real sample. h2v1 and
//                    h2v2 of a plane 2 or fewer samples wide, every other
//                    integral ratio (4:1:1, 4:1:0, ...) and every ratio of
//                    a lossless frame (whose samples are 1x1 "blocks")
//                    replicate samples (box)
//   colour           YCbCr -> RGB with the integer tables of JFIF's
//                    coefficients (16 fraction bits), or none where libjpeg
//                    takes the components as RGB (a lossless frame in YCbCr
//                    or YCCK libjpeg-turbo 3 refuses: it converts none); four components are
//                    CMYK, or YCCK (an Adobe transform other than 0) made
//                    CMYK with the same tables and 255 - each of C, M, Y;
//                    Pillow reads every four-component JPEG inverted
//                    ("CMYK;I") and makes RGB with its integer formula
//                    (rcv_cmyk_to_rgb, which the TIFF reader calls too).
//                    That is the stream's own rule; a caller may set
//                    another, as libtiff sets libjpeg's colour spaces: YCbCr
//                    whatever the markers say (a TIFF page of the YCbCr
//                    photometric), or none (every other TIFF page)
//
// Output: rows of B, G, R bytes (gray repeated three times) into a
// caller's buffer at any stride; with no colour conversion, the components
// as they are. Beside it, libtiff's own YCbCr -> RGB (rcv_tiff_ycbcr_to_rgb),
// which the TIFF reader takes where libtiff's RGBA reader converts.
//
// Built with g++ at first use (see __init__.py); plain C interface.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {
int rcv_jpeg_host_info(const uint8_t* data, long len, int* width, int* height, int* ncomp,
                       int* h_samp, int* v_samp, int* bw, int* bh, int* flags);
int rcv_jpeg_host_coeffs(const uint8_t* data, long len, int16_t** outs, uint16_t** qs, int* bits);
}

namespace {

typedef int64_t i64;

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr i64 FIX_0_298631336 = 2446;
constexpr i64 FIX_0_390180644 = 3196;
constexpr i64 FIX_0_541196100 = 4433;
constexpr i64 FIX_0_765366865 = 6270;
constexpr i64 FIX_0_899976223 = 7373;
constexpr i64 FIX_1_175875602 = 9633;
constexpr i64 FIX_1_501321110 = 12299;
constexpr i64 FIX_1_847759065 = 15137;
constexpr i64 FIX_1_961570560 = 16069;
constexpr i64 FIX_2_053119869 = 16819;
constexpr i64 FIX_2_562915447 = 20995;
constexpr i64 FIX_3_072711026 = 25172;

inline i64 descale(i64 x, int n) { return (x + (i64(1) << (n - 1))) >> n; }
inline uint8_t clamp_u8(i64 v) { return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// The even and odd halves shared by both passes: in[0..7] -> out[0..7]
// before the final descale.
inline void idct_1d(i64 s0, i64 s1, i64 s2, i64 s3, i64 s4, i64 s5, i64 s6, i64 s7,
                    i64 out[8]) {
  i64 z1 = (s2 + s6) * FIX_0_541196100;
  i64 tmp2 = z1 + s6 * -FIX_1_847759065;
  i64 tmp3 = z1 + s2 * FIX_0_765366865;
  i64 tmp0 = (s0 + s4) * (i64(1) << kConstBits);
  i64 tmp1 = (s0 - s4) * (i64(1) << kConstBits);
  i64 tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  i64 tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

  tmp0 = s7;
  tmp1 = s5;
  tmp2 = s3;
  tmp3 = s1;
  z1 = tmp0 + tmp3;
  i64 z2 = tmp1 + tmp2, z3 = tmp0 + tmp2, z4 = tmp1 + tmp3;
  i64 z5 = (z3 + z4) * FIX_1_175875602;
  tmp0 *= FIX_0_298631336;
  tmp1 *= FIX_2_053119869;
  tmp2 *= FIX_3_072711026;
  tmp3 *= FIX_1_501321110;
  z1 *= -FIX_0_899976223;
  z2 *= -FIX_2_562915447;
  z3 *= -FIX_1_961570560;
  z4 *= -FIX_0_390180644;
  z3 += z5;
  z4 += z5;
  tmp0 += z1 + z3;
  tmp1 += z2 + z4;
  tmp2 += z2 + z3;
  tmp3 += z1 + z4;
  out[0] = tmp10 + tmp3;
  out[7] = tmp10 - tmp3;
  out[1] = tmp11 + tmp2;
  out[6] = tmp11 - tmp2;
  out[2] = tmp12 + tmp1;
  out[5] = tmp12 - tmp1;
  out[3] = tmp13 + tmp0;
  out[4] = tmp13 - tmp0;
}

// One block: natural-order coefficients and quant table -> 8x8 samples at
// dst (row stride `stride`).
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* dst, long stride) {
  i64 ws[64];
  i64 o[8];
  for (int c = 0; c < 8; c++) {  // columns
    i64 s[8];
    for (int r = 0; r < 8; r++) s[r] = i64(coef[r * 8 + c]) * q[r * 8 + c];
    if (!s[1] && !s[2] && !s[3] && !s[4] && !s[5] && !s[6] && !s[7]) {
      for (int r = 0; r < 8; r++) ws[r * 8 + c] = s[0] * (1 << kPass1Bits);
      continue;
    }
    idct_1d(s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], o);
    for (int r = 0; r < 8; r++) ws[r * 8 + c] = descale(o[r], kConstBits - kPass1Bits);
  }
  for (int r = 0; r < 8; r++) {  // rows
    const i64* w = ws + r * 8;
    uint8_t* out = dst + r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      // The full pass gives descale(w[0] << 13, 18) == descale(w[0], 5).
      uint8_t v = clamp_u8(descale(w[0], kPass1Bits + 3) + 128);
      for (int c = 0; c < 8; c++) out[c] = v;
      continue;
    }
    idct_1d(w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], o);
    for (int c = 0; c < 8; c++)
      out[c] = clamp_u8(descale(o[c], kConstBits + kPass1Bits + 3) + 128);
  }
}

struct ColorTables {
  int cr_r[256], cb_b[256];
  i64 cr_g[256], cb_g[256];
  ColorTables() {
    const int kScale = 16;
    const i64 half = i64(1) << (kScale - 1);
    auto fix = [](double x) { return i64(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; i++) {
      i64 x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + half) >> kScale);
      cb_b[i] = int((fix(1.77200) * x + half) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};

const ColorTables& tables() {
  static const ColorTables t;
  return t;
}

// Pillow's CMYK -> RGB (Convert.c, cmyk2rgb) of one channel: `v` the
// channel's ink, `nk` 255 - K.
inline uint8_t cmyk_channel(int v, int nk) {
  int t = v * nk + 128;
  return clamp_u8(nk - (((t >> 8) + t) >> 8));
}

// Fancy h2v1: `n` (> 2) input samples -> 2n output samples.
void up_h2v1(const uint8_t* in, int n, uint8_t* out) {
  out[0] = in[0];
  out[1] = uint8_t((in[0] * 3 + in[1] + 2) >> 2);
  for (int i = 1; i < n - 1; i++) {
    int v = in[i] * 3;
    out[2 * i] = uint8_t((v + in[i - 1] + 1) >> 2);
    out[2 * i + 1] = uint8_t((v + in[i + 1] + 2) >> 2);
  }
  out[2 * n - 2] = uint8_t((in[n - 1] * 3 + in[n - 2] + 1) >> 2);
  out[2 * n - 1] = in[n - 1];
}

// Fancy h2v2, one output row: `near` is the chroma row the output row lies
// in, `far` the row above (first output row of the pair) or below; n > 2.
void up_h2v2(const uint8_t* near, const uint8_t* far, int n, uint8_t* out) {
  int this_sum = near[0] * 3 + far[0];
  int next_sum = near[1] * 3 + far[1];
  out[0] = uint8_t((this_sum * 4 + 8) >> 4);
  out[1] = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
  int last_sum = this_sum;
  this_sum = next_sum;
  for (int i = 1; i < n - 1; i++) {
    next_sum = near[i + 1] * 3 + far[i + 1];
    out[2 * i] = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
    out[2 * i + 1] = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
    last_sum = this_sum;
    this_sum = next_sum;
  }
  out[2 * n - 2] = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
  out[2 * n - 1] = uint8_t((this_sum * 4 + 7) >> 4);
}

// libjpeg's upsampler of one component (jdsample.c), by its expansion
// against the largest sampling factors; `fancy` false for a lossless frame.
enum Upsample { kFull, kH2V1, kH1V2, kH2V2, kBox };

Upsample upsampler(int hx, int vy, int dw, bool fancy) {
  if (hx == 1 && vy == 1) return kFull;
  if (!fancy) return kBox;
  if (hx == 2 && vy == 1) return dw > 2 ? kH2V1 : kBox;
  if (hx == 1 && vy == 2) return kH1V2;
  if (hx == 2 && vy == 2) return dw > 2 ? kH2V2 : kBox;
  return kBox;  // int_upsample: every other integral ratio
}

// Natural positions of the coefficients the smoothing estimates, in the
// order of their zigzag indices 1..9.
constexpr int kQ01 = 1, kQ10 = 8, kQ20 = 16, kQ11 = 9, kQ02 = 2, kQ03 = 3, kQ12 = 10, kQ21 = 17,
              kQ30 = 24;

// libjpeg's smoothing_ok: every component's DC at least partly known and
// its DC and first nine AC quantizers nonzero, and some coefficient 1..9
// of some component not refined to its last bit.
bool smoothing_ok(int nc, const uint16_t q[4][64], const int* bits) {
  bool useful = false;
  for (int c = 0; c < nc; c++) {
    const uint16_t* t = q[c];
    if (!t[0] || !t[kQ01] || !t[kQ10] || !t[kQ20] || !t[kQ11] || !t[kQ02] || !t[kQ03] ||
        !t[kQ12] || !t[kQ21] || !t[kQ30])
      return false;
    if (bits[c * 64] < 0) return false;
    for (int k = 1; k < 10; k++) useful = useful || bits[c * 64 + k] != 0;
  }
  return useful;
}

// One estimate: `num` over the coefficient's quantizer, rounded half away
// from zero, held below 2^Al where Al bits are still to come.
inline int16_t estimate(i64 num, i64 qv, int al) {
  i64 p = ((qv << 7) + (num >= 0 ? num : -num)) / (qv << 8);
  if (al > 0 && p >= (i64(1) << al)) p = (i64(1) << al) - 1;
  return int16_t(num >= 0 ? p : -p);
}

// One component's blocks, smoothed as libjpeg's decompress_smooth_data
// smooths them, then through the IDCT into `plane` (row stride pw). `v`,
// `imcu_rows`, `hib` and `wib` are libjpeg's vertical factor, iMCU rows
// and block extent of the component; rows past the grid's `bh` read as
// zero (a lone component whose frame header gives it v > 1). The
// neighbour rows are libjpeg-turbo 3's; libjpeg-turbo 2.1 takes them from
// the block row and the iMCU row instead, which differs in the second and
// third rows from either end of a frame of v > 1 and in a component two
// blocks wide.
void smooth_idct(const int16_t* coef, int bw, int bh, const uint16_t* q, const int* bits, int v,
                 int imcu_rows, int hib, int wib, uint8_t* plane, long pw) {
  const bool change_dc = bits[1] == -1 && bits[2] == -1 && bits[3] == -1 && bits[4] == -1 &&
                         bits[5] == -1 && bits[6] == -1 && bits[7] == -1 && bits[8] == -1 &&
                         bits[9] == -1;
  const i64 Q00 = q[0], Q01 = q[kQ01], Q10 = q[kQ10], Q20 = q[kQ20], Q11 = q[kQ11], Q02 = q[kQ02],
            Q03 = q[kQ03], Q12 = q[kQ12], Q21 = q[kQ21], Q30 = q[kQ30];
  auto dc = [&](int row, int col) -> int {
    return row < bh ? coef[(size_t(row) * bw + col) * 64] : 0;
  };
  int16_t ws[64];
  for (int im = 0; im < imcu_rows; im++) {
    const int block_rows = im < imcu_rows - 1 ? v : (hib % v ? hib % v : v);
    const int image_block_rows = block_rows * imcu_rows;
    for (int br = 0; br < block_rows; br++) {
      const int row = im * v + br;
      // libjpeg-turbo 3's neighbour rows, from its (last-row-skewed)
      // image_block_row
      const int ib = im * block_rows + br;
      const int prev = ib > 0 ? row - 1 : row;
      const int pprev = ib > 1 ? row - 2 : prev;
      const int next = ib < image_block_rows - 1 ? row + 1 : row;
      const int nnext = ib < image_block_rows - 2 ? row + 2 : next;
      const int rows[5] = {pprev, prev, row, next, nnext};
      int D[5][5];  // DC01..DC25: D[r][c], r and c from -2 to +2
      for (int r = 0; r < 5; r++) D[r][0] = D[r][1] = D[r][2] = D[r][3] = D[r][4] = dc(rows[r], 0);
      const int last_col = wib - 1;
      for (int bx = 0; bx < wib; bx++) {
        if (bx == 0 && bx < last_col)
          for (int r = 0; r < 5; r++) D[r][3] = D[r][4] = dc(rows[r], 1);
        if (bx + 1 < last_col)
          for (int r = 0; r < 5; r++) D[r][4] = dc(rows[r], bx + 2);
        const int16_t* blk = coef + (size_t(row) * bw + bx) * 64;
        memcpy(ws, blk, sizeof(ws));
        const int DC01 = D[0][0], DC02 = D[0][1], DC03 = D[0][2], DC04 = D[0][3], DC05 = D[0][4];
        const int DC06 = D[1][0], DC07 = D[1][1], DC08 = D[1][2], DC09 = D[1][3], DC10 = D[1][4];
        const int DC11 = D[2][0], DC12 = D[2][1], DC13 = D[2][2], DC14 = D[2][3], DC15 = D[2][4];
        const int DC16 = D[3][0], DC17 = D[3][1], DC18 = D[3][2], DC19 = D[3][3], DC20 = D[3][4];
        const int DC21 = D[4][0], DC22 = D[4][1], DC23 = D[4][2], DC24 = D[4][3], DC25 = D[4][4];
        int al;
        if ((al = bits[1]) != 0 && ws[kQ01] == 0)
          ws[kQ01] = estimate(
              Q00 * (change_dc ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 +
                                  3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 -
                                  3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20 - DC21 - DC22 +
                                  DC24 + DC25)
                               : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15)),
              Q01, al);
        if ((al = bits[2]) != 0 && ws[kQ10] == 0)
          ws[kQ10] = estimate(
              Q00 * (change_dc ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 +
                                  13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 + DC16 - 13 * DC17 -
                                  38 * DC18 - 13 * DC19 + DC20 + DC21 + 3 * DC22 + 3 * DC23 +
                                  3 * DC24 + DC25)
                               : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23)),
              Q10, al);
        if ((al = bits[3]) != 0 && ws[kQ20] == 0)
          ws[kQ20] = estimate(
              Q00 * (change_dc ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 -
                                  5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 + DC23)
                               : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23)),
              Q20, al);
        if ((al = bits[4]) != 0 && ws[kQ11] == 0)
          ws[kQ11] = estimate(
              Q00 * (change_dc ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 +
                                  DC21 - DC25)
                               : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 -
                                  DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09)),
              Q11, al);
        if ((al = bits[5]) != 0 && ws[kQ02] == 0)
          ws[kQ02] = estimate(
              Q00 * (change_dc ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 +
                                  7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19)
                               : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15)),
              Q02, al);
        if (change_dc) {
          if ((al = bits[6]) != 0 && ws[kQ03] == 0)
            ws[kQ03] = estimate(Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19), Q03, al);
          if ((al = bits[7]) != 0 && ws[kQ12] == 0)
            ws[kQ12] = estimate(Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19), Q12, al);
          if ((al = bits[8]) != 0 && ws[kQ21] == 0)
            ws[kQ21] = estimate(Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19), Q21, al);
          if ((al = bits[9]) != 0 && ws[kQ30] == 0)
            ws[kQ30] = estimate(Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19), Q30, al);
          ws[0] = estimate(
              Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 + 6 * DC07 +
                     42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 + 152 * DC13 +
                     42 * DC14 - 8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 -
                     6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25),
              Q00, 0);
        }
        idct_islow(ws, q, plane + size_t(row) * 8 * pw + bx * 8, pw);
        for (int r = 0; r < 5; r++) {
          D[r][0] = D[r][1];
          D[r][1] = D[r][2];
          D[r][2] = D[r][3];
          D[r][3] = D[r][4];
        }
      }
    }
  }
}

struct Scratch {
  std::vector<int16_t> coef[4];
  std::vector<uint8_t> plane[4];
  std::vector<uint8_t> row[4];
};

}  // namespace

extern "C" {

// Pillow's CMYK (as Pillow holds it: a JPEG's inverted) -> RGB of `n`
// pixels.
void rcv_cmyk_to_rgb(const uint8_t* cmyk, long n, uint8_t* rgb) {
  for (long i = 0; i < n; i++, cmyk += 4, rgb += 3) {
    int nk = 255 - cmyk[3];
    rgb[0] = cmyk_channel(cmyk[0], nk);
    rgb[1] = cmyk_channel(cmyk[1], nk);
    rgb[2] = cmyk_channel(cmyk[2], nk);
  }
}

}  // extern "C"

namespace {

// TIFF's YCbCr -> RGB (libtiff's tif_color.c, TIFFYCbCrToRGBInit and
// TIFFYCbCrtoRGB, which Pillow reaches through TIFFRGBAImage): integer
// tables made in single-precision floats from the YCbCrCoefficients
// (`luma`) and ReferenceBlackWhite (`rbw`) tags, 16 fraction bits.
struct TiffYCbCr {
  int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256], y[256];
  TiffYCbCr(const float* luma, const float* rbw) {
    const int kShift = 16;
    const int32_t half = int32_t(1) << (kShift - 1);
    auto fix = [](float x) { return int32_t(double(x * 65536.0f) + 0.5); };
    auto clampf = [](float v, float lo, float hi) { return v < lo ? lo : (v > hi ? hi : v); };
    // libtiff's Code2V: ((c - (int32_t)RB) * (float)CR) / (float)(RW - RB or 1)
    auto code2v = [](int32_t c, float rb, float rw, float cr) {
      float d = rw - rb;
      return float(c - int32_t(rb)) * cr / (d != 0 ? d : 1.0f);
    };
    // CLAMPw then the cast to int32_t, which truncates toward zero
    auto clampw = [](float v) {
      return int32_t(v < -128.0f * 32 ? -128.0f * 32 : (v > 128.0f * 32 ? 128.0f * 32 : v));
    };
    const float f1 = 2 - 2 * luma[0];
    const int32_t d1 = fix(clampf(f1, 0.0f, 2.0f));
    const float f2 = luma[0] * f1 / luma[1];
    const int32_t d2 = -fix(clampf(f2, 0.0f, 2.0f));
    const float f3 = 2 - 2 * luma[2];
    const int32_t d3 = fix(clampf(f3, 0.0f, 2.0f));
    const float f4 = luma[2] * f3 / luma[1];
    const int32_t d4 = -fix(clampf(f4, 0.0f, 2.0f));
    for (int i = 0, x = -128; i < 256; i++, x++) {
      int32_t cr = clampw(code2v(x, rbw[4] - 128.0f, rbw[5] - 128.0f, 127));
      int32_t cb = clampw(code2v(x, rbw[2] - 128.0f, rbw[3] - 128.0f, 127));
      cr_r[i] = int32_t((int64_t(d1) * cr + half) >> kShift);
      cb_b[i] = int32_t((int64_t(d3) * cb + half) >> kShift);
      cr_g[i] = d2 * cr;
      cb_g[i] = d4 * cb + half;
      y[i] = clampw(code2v(x + 128, rbw[0], rbw[1], 255));
    }
  }
};

// The same integer YCbCr -> RGB the host decode makes of every YCbCr
// frame, into B, G, R bytes.
inline void ycbcr_bgr(const ColorTables& t, int yv, int b, int rr, uint8_t* o) {
  o[2] = clamp_u8(yv + t.cr_r[rr]);
  o[1] = clamp_u8(yv + int((t.cb_g[b] + t.cr_g[rr]) >> 16));
  o[0] = clamp_u8(yv + t.cb_b[b]);
}

}  // namespace

extern "C" {

// libtiff's YCbCr -> RGB of `n` pixels (Y, Cb, Cr bytes each) into R, G,
// B bytes, with the tables of `luma` (3 floats) and `rbw` (6 floats).
// Returns -1 where libtiff refuses the tags (a NaN or zero green
// coefficient, a reference value out of range), else 0.
int rcv_tiff_ycbcr_to_rgb(const uint8_t* ycbcr, long n, const float* luma, const float* rbw,
                          uint8_t* rgb) {
  if (luma[0] != luma[0] || luma[1] != luma[1] || luma[2] != luma[2]) return -1;
  if (luma[1] > -1e-6f && luma[1] < 1e-6f) return -1;  // libtiff's TIFF_FLOAT_EQ(.., 0.0)
  for (int i = 0; i < 6; i++)
    if (!(rbw[i] > float(-0x7FFFFFFF + 128) && rbw[i] < float(0x7FFFFFFF))) return -1;
  const TiffYCbCr t(luma, rbw);
  for (long i = 0; i < n; i++, ycbcr += 3, rgb += 3) {
    const int32_t yv = t.y[ycbcr[0]];
    const int cb = ycbcr[1], cr = ycbcr[2];
    rgb[0] = clamp_u8(yv + t.cr_r[cr]);
    rgb[1] = clamp_u8(yv + int32_t((t.cb_g[cb] + t.cr_g[cr]) >> 16));
    rgb[2] = clamp_u8(yv + t.cb_b[cb]);
  }
  return 0;
}

// Decode JFIF `data` into `out`, row r at out + r*stride. `width`/`height`
// must be the frame's. `colour` is the rule for the components, as libjpeg
// takes it from its caller: 0 the stream's own (its markers; libjpeg's
// default, Pillow's JPEG reads) and 1 YCbCr (libtiff's JPEGCOLORMODE_RGB
// of a YCbCr TIFF page: three components, whatever the markers say), both
// into width*3 B, G, R bytes (gray repeated three times); 2 none (libtiff's
// JCS_UNKNOWN: every other TIFF page), the upsampled components as they
// are, width*ncomp bytes, a four-component frame not inverted. Returns 0,
// a negative decoder code for a corrupt or unsupported stream, -42 for
// sampling factors that are not integral ratios (libjpeg refuses them),
// -43 for a lossless frame whose colour needs converting (libjpeg-turbo 3
// refuses it), -44 for a frame of other than three components under rule
// 1 (libjpeg's bogus colour space), -6 for two components under rules 0
// and 1, and -41 for a size mismatch.
int rcv_jpeg_decode_bgr(const uint8_t* data, long len, uint8_t* out, long stride, int width,
                        int height, int colour) {
  int w, h, nc, hs[4], vs[4], bw[4], bh[4], flags;
  int rc = rcv_jpeg_host_info(data, len, &w, &h, &nc, hs, vs, bw, bh, &flags);
  if (rc != 0) return rc;
  if (w != width || h != height) return -41;
  if (colour == 1 && nc != 3) return -44;
  if (colour != 2 && nc == 2) return -6;  // libjpeg converts no two-component frame
  int hmax = 1, vmax = 1;
  for (int c = 0; c < nc; c++) {
    hmax = hs[c] > hmax ? hs[c] : hmax;
    vmax = vs[c] > vmax ? vs[c] : vmax;
  }
  for (int c = 0; c < nc; c++)
    if (hmax % hs[c] || vmax % vs[c]) return -42;
  const bool lossless = flags & 4;
  // the stream's rule: RGB (flags & 2) and CMYK take no conversion
  const bool rgb = colour == 0 && (flags & 2), ycck = colour == 0 && (flags & 16);
  const bool convert = colour == 1 || (colour == 0 && ((nc == 3 && !rgb) || ycck));
  // libjpeg-turbo 3 converts no colour of a lossless frame: YCbCr to the
  // RGB Pillow asks for, or YCCK to its CMYK, it refuses
  if (lossless && convert) return -43;

  thread_local Scratch s;
  uint16_t q[4][64];
  int bits[4 * 64];
  int16_t* outs[4];
  uint16_t* qs[4];
  for (int c = 0; c < 4; c++) {
    s.coef[c].resize(c < nc ? size_t(bw[c]) * bh[c] * (lossless ? 1 : 64) : 64);
    outs[c] = s.coef[c].data();
    qs[c] = q[c];
  }
  rc = rcv_jpeg_host_coeffs(data, len, outs, qs, bits);
  if (rc != 0) return rc;
  long pw[4], ph[4];
  const bool smooth = (flags & 1) && smoothing_ok(nc, q, bits);
  // libjpeg's geometry of a lone component: its frame header's factor
  const int fv = nc == 1 ? ((flags >> 8) & 15) : 0;
  const int vlib = fv ? fv : vmax;
  const int imcu_rows = int((long(height) + 8 * vlib - 1) / (8 * vlib));
  for (int c = 0; c < nc; c++) {
    pw[c] = long(bw[c]) * (lossless ? 1 : 8);
    ph[c] = long(bh[c]) * (lossless ? 1 : 8);
    s.plane[c].resize(size_t(pw[c]) * ph[c]);
    uint8_t* plane = s.plane[c].data();
    const int16_t* coef = s.coef[c].data();
    if (lossless) {
      for (size_t i = 0; i < s.plane[c].size(); i++) plane[i] = uint8_t(coef[i]);
      continue;
    }
    int first = 0;  // block rows smoothed before the plain IDCT takes the rest
    if (smooth) {
      const int v = fv ? fv : vs[c];
      const int hib = int(((long(height) * v + vlib - 1) / vlib + 7) / 8);
      const int wib = int(((long(width) * hs[c] + hmax - 1) / hmax + 7) / 8);
      smooth_idct(coef, bw[c], bh[c], q[c], bits + c * 64, v, imcu_rows, hib, wib, plane, pw[c]);
      first = hib < bh[c] ? hib : bh[c];
      for (int by = 0; by < first; by++)  // the padding columns of the smoothed rows
        for (int bx = wib; bx < bw[c]; bx++)
          idct_islow(coef + (size_t(by) * bw[c] + bx) * 64, q[c],
                     plane + size_t(by) * 8 * pw[c] + bx * 8, pw[c]);
    }
    for (int by = first; by < bh[c]; by++)
      for (int bx = 0; bx < bw[c]; bx++)
        idct_islow(coef + (size_t(by) * bw[c] + bx) * 64, q[c],
                   plane + size_t(by) * 8 * pw[c] + bx * 8, pw[c]);
  }
  if (nc == 1) {
    for (int r = 0; r < height; r++) {
      const uint8_t* yr = s.plane[0].data() + size_t(r) * pw[0];
      uint8_t* o = out + size_t(r) * stride;
      if (colour == 2)
        memcpy(o, yr, size_t(width));
      else
        for (int x = 0; x < width; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = yr[x];
    }
    return 0;
  }
  // Each component's real extent (libjpeg's downsampled size): samples past
  // it are never read, the upsamplers repeat the last real one.
  int hx[4], vy[4], dw[4], dh[4];
  Upsample how[4];
  for (int c = 0; c < nc; c++) {
    hx[c] = hmax / hs[c];
    vy[c] = vmax / vs[c];
    dw[c] = int((long(width) * hs[c] + hmax - 1) / hmax);
    dh[c] = int((long(height) * vs[c] + vmax - 1) / vmax);
    how[c] = upsampler(hx[c], vy[c], dw[c], !lossless);
    s.row[c].resize(size_t(dw[c]) * hx[c] + 2);
  }
  const ColorTables& t = tables();
  const uint8_t* rows[4];
  for (int r = 0; r < height; r++) {
    for (int c = 0; c < nc; c++) {
      const uint8_t* plane = s.plane[c].data();
      uint8_t* buf = s.row[c].data();
      int cy = r / vy[c];
      // the neighbouring row of the triangle filters: above for the upper
      // output row of a pair, below for the lower, the edge row repeated
      int fy = (r & 1) ? (cy + 1 < dh[c] ? cy + 1 : dh[c] - 1) : (cy > 0 ? cy - 1 : 0);
      const uint8_t* near = plane + size_t(cy) * pw[c];
      const uint8_t* far = plane + size_t(fy) * pw[c];
      switch (how[c]) {
        case kFull:
          rows[c] = near;
          continue;
        case kH2V1:
          up_h2v1(near, dw[c], buf);
          break;
        case kH1V2: {
          int bias = (r & 1) ? 2 : 1;
          for (int x = 0; x < dw[c]; x++) buf[x] = uint8_t((near[x] * 3 + far[x] + bias) >> 2);
          break;
        }
        case kH2V2:
          up_h2v2(near, far, dw[c], buf);
          break;
        case kBox:
          for (int x = 0; x < width; x++) buf[x] = near[x / hx[c]];
          break;
      }
      rows[c] = buf;
    }
    uint8_t* o = out + size_t(r) * stride;
    if (colour == 2) {
      for (int x = 0; x < width; x++)
        for (int c = 0; c < nc; c++) o[nc * x + c] = rows[c][x];
      continue;
    }
    if (nc == 4) {
      for (int x = 0; x < width; x++) {
        int nk = rows[3][x];  // 255 - K as Pillow holds it (inverted)
        int cc = 255 - rows[0][x], mm = 255 - rows[1][x], yy = 255 - rows[2][x];
        if (ycck) {  // libjpeg's YCC -> CMY, inverted: the YCbCr -> RGB values
          uint8_t bgr[3];
          ycbcr_bgr(t, rows[0][x], rows[1][x], rows[2][x], bgr);
          cc = bgr[2];
          mm = bgr[1];
          yy = bgr[0];
        }
        o[3 * x + 2] = cmyk_channel(cc, nk);
        o[3 * x + 1] = cmyk_channel(mm, nk);
        o[3 * x + 0] = cmyk_channel(yy, nk);
      }
      continue;
    }
    if (rgb) {
      for (int x = 0; x < width; x++) {
        o[3 * x + 2] = rows[0][x];
        o[3 * x + 1] = rows[1][x];
        o[3 * x + 0] = rows[2][x];
      }
      continue;
    }
    for (int x = 0; x < width; x++) ycbcr_bgr(t, rows[0][x], rows[1][x], rows[2][x], o + 3 * x);
  }
  return 0;
}

}  // extern "C"
