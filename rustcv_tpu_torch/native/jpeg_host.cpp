// Full JPEG decode on the host, to BGR, with no libjpeg: the decode that
// libjpeg-turbo makes with its default settings, which is what the
// reference gets from Pillow (and from its own libjpeg-turbo binding).
//
//   entropy decode   the port's decoder (jpeg_entropy.cpp,
//                    rcv_jpeg_host_coeffs): baseline and extended
//                    sequential, in one scan or several, and progressive
//                    streams whose every coefficient is refined to its
//                    last bit
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
//                    h2v2 of a plane 2 or fewer samples wide, and every
//                    other integral ratio (4:1:1, 4:1:0, ...), replicate
//                    samples (box)
//   colour           YCbCr -> RGB with the integer tables of JFIF's
//                    coefficients (16 fraction bits), or none where libjpeg
//                    takes the components as RGB
//
// Output: rows of B, G, R bytes (gray repeated three times) into a
// caller's buffer at any stride.
//
// Built with g++ at first use (see __init__.py); plain C interface.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {
int rcv_jpeg_host_info(const uint8_t* data, long len, int* width, int* height, int* ncomp,
                       int* h_samp, int* v_samp, int* bw, int* bh, int* flags);
int rcv_jpeg_host_coeffs(const uint8_t* data, long len, int16_t* out0, int16_t* out1,
                         int16_t* out2, uint16_t* q0, uint16_t* q1, uint16_t* q2);
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
// against the largest sampling factors.
enum Upsample { kFull, kH2V1, kH1V2, kH2V2, kBox };

Upsample upsampler(int hx, int vy, int dw) {
  if (hx == 1 && vy == 1) return kFull;
  if (hx == 2 && vy == 1) return dw > 2 ? kH2V1 : kBox;
  if (hx == 1 && vy == 2) return kH1V2;
  if (hx == 2 && vy == 2) return dw > 2 ? kH2V2 : kBox;
  return kBox;  // int_upsample: every other integral ratio
}

struct Scratch {
  std::vector<int16_t> coef[3];
  std::vector<uint8_t> plane[3];
  std::vector<uint8_t> row[3];
};

}  // namespace

extern "C" {

// Decode JFIF `data` into `out`: height rows of width*3 B, G, R bytes, row
// r at out + r*stride. `width`/`height` must be the frame's. Returns 0, a
// negative decoder code for a corrupt or unsupported stream, -42 for
// sampling factors that are not integral ratios (libjpeg refuses them),
// -41 for a size mismatch, and rcv_jpeg_host_info's and
// rcv_jpeg_host_coeffs' codes (-50, -51) for what it does not read yet.
int rcv_jpeg_decode_bgr(const uint8_t* data, long len, uint8_t* out, long stride, int width,
                        int height) {
  int w, h, nc, hs[3], vs[3], bw[3], bh[3], flags;
  int rc = rcv_jpeg_host_info(data, len, &w, &h, &nc, hs, vs, bw, bh, &flags);
  if (rc != 0) return rc;
  if (w != width || h != height) return -41;
  int hmax = 1, vmax = 1;
  for (int c = 0; c < nc; c++) {
    hmax = hs[c] > hmax ? hs[c] : hmax;
    vmax = vs[c] > vmax ? vs[c] : vmax;
  }
  for (int c = 0; c < nc; c++)
    if (hmax % hs[c] || vmax % vs[c]) return -42;

  thread_local Scratch s;
  uint16_t q[3][64];
  for (int c = 0; c < 3; c++) s.coef[c].resize(c < nc ? size_t(bw[c]) * bh[c] * 64 : 64);
  rc = rcv_jpeg_host_coeffs(data, len, s.coef[0].data(), s.coef[1].data(), s.coef[2].data(), q[0],
                            q[1], q[2]);
  if (rc != 0) return rc;
  long pw[3], ph[3];
  for (int c = 0; c < nc; c++) {
    pw[c] = long(bw[c]) * 8;
    ph[c] = long(bh[c]) * 8;
    s.plane[c].resize(size_t(pw[c]) * ph[c]);
    for (int by = 0; by < bh[c]; by++)
      for (int bx = 0; bx < bw[c]; bx++)
        idct_islow(s.coef[c].data() + (size_t(by) * bw[c] + bx) * 64, q[c],
                   s.plane[c].data() + size_t(by) * 8 * pw[c] + bx * 8, pw[c]);
  }
  if (nc == 1) {
    for (int r = 0; r < height; r++) {
      const uint8_t* yr = s.plane[0].data() + size_t(r) * pw[0];
      uint8_t* o = out + size_t(r) * stride;
      for (int x = 0; x < width; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = yr[x];
    }
    return 0;
  }
  // Each component's real extent (libjpeg's downsampled size): samples past
  // it are never read, the upsamplers repeat the last real one.
  int hx[3], vy[3], dw[3], dh[3];
  Upsample how[3];
  for (int c = 0; c < nc; c++) {
    hx[c] = hmax / hs[c];
    vy[c] = vmax / vs[c];
    dw[c] = int((long(width) * hs[c] + hmax - 1) / hmax);
    dh[c] = int((long(height) * vs[c] + vmax - 1) / vmax);
    how[c] = upsampler(hx[c], vy[c], dw[c]);
    s.row[c].resize(size_t(dw[c]) * hx[c] + 2);
  }
  const ColorTables& t = tables();
  const bool rgb = flags & 2;
  const uint8_t* rows[3];
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
    if (rgb) {
      for (int x = 0; x < width; x++) {
        o[3 * x + 2] = rows[0][x];
        o[3 * x + 1] = rows[1][x];
        o[3 * x + 0] = rows[2][x];
      }
      continue;
    }
    for (int x = 0; x < width; x++) {
      int yv = rows[0][x], b = rows[1][x], rr = rows[2][x];
      o[3 * x + 2] = clamp_u8(yv + t.cr_r[rr]);
      o[3 * x + 1] = clamp_u8(yv + int((t.cb_g[b] + t.cr_g[rr]) >> 16));
      o[3 * x + 0] = clamp_u8(yv + t.cb_b[b]);
    }
  }
  return 0;
}

}  // extern "C"
