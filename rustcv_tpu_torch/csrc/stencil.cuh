// Blur + Sobel |∇| as a register-blocked row march, shared by stencil.cu
// (K1: the gray rows are read from a gray image) and yuyv_tick.cu (K5: the
// gray rows are decoded from YUYV words, which also store their BGR), so
// the two kernels compute the filter with the same code.
//
// Math (bit-exact with rustcv_tpu.ops.filters' frozen chain):
//   blur(y, x) = (Σ g5[dy]·g5[dx]·gray[clamp(y+dy)][clamp(x+dx)] + 128) >> 8
//                for a centre (y, x) inside the image, g5 = (1, 4, 6, 4, 1);
//   Sobel reads blur at clamp(y±1), clamp(x±1): the two-stage border rule
//   (the Gaussian replicates the original image, the Sobel the blurred one);
//   out = min(255, floor(sqrt(gx² + gy²))), exact.
//
// Layout: a block is kWarps warps; a warp owns a strip of `rows` output
// rows and 30·C columns (C = 4 or 8 per lane), lanes 1 .. 30 C adjacent
// columns each; lanes 0 and 31 read the C columns on either side, so every
// lane does the same work and no lane branches for the halo. A lane walks
// down the strip's gray rows (±3 rows of halo, clamped), C/4 32-bit words of
// gray bytes per row; its ±3-column neighbours come from the next lanes'
// words by warp shuffles. The horizontal 5-tap runs on two 16-bit lanes per
// register (a sum is at most 16·255 = 4,080, and a vertical sum at most
// 65,280 + 128 < 2¹⁶, so no carry crosses lanes). The vertical taps are
// cascades of [1, 1] sums holding one row each, which a loop unrolled by 2
// keeps in fixed registers. The magnitude runs in float32 (exact for these
// integers) on the FP32 pipe, beside the integer work. No shared memory,
// no barrier.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rcv {

constexpr int kLanes = 32;  // lanes of a warp
constexpr int kWarps = 4;   // warps (strips) per block

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// sqrt.approx: a few ulp from the exact root (MUFU), not IEEE-rounded.
__device__ __forceinline__ float sqrt_approx(float x) {
#ifdef __CUDA_ARCH__
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
#else
  return sqrtf(x);
#endif
}

// Small integers as floats and back without the conversion units: 2^23 + v
// (bits 0x4B000000 | v) has v in its low mantissa bits, and so has
// 1.5·2^23 + v, where adding a float in [-2^22, 2^22) rounds it to an
// integer.
constexpr float kMagic = 8388608.0f;        // 2^23
constexpr float kRoundMagic = 12582912.0f;  // 1.5·2^23
// The kernels take kMagicBits as an argument: as a register the PRMTs that
// put it under a lane keep their selectors as immediates (with both
// constant, ptxas moves a selector into a register at every use).
constexpr uint32_t kMagicBits = 0x4B000000u;

// min(255, floor(sqrt(gx² + gy²))) as the low byte of a float's bits, from
// gx + 1020 and gy + 2040 as the low 16 bits under the magic exponent.
// Exact: every value below is an integer under 2^24. With m capped at 255²,
// the floor of the approximate root is the root's floor or one below it
// (the approximation is within 1e-3, and a root that is not an integer is
// at least 1/512 from one); one step up makes it exact.
__device__ __forceinline__ uint32_t magnitude_bits(uint32_t gx_lane, uint32_t gy_lane) {
  const float gx = __uint_as_float(gx_lane) - (kMagic + 1020.0f);
  const float gy = __uint_as_float(gy_lane) - (kMagic + 2040.0f);
  const float m = fminf(fmaf(gx, gx, gy * gy), 65025.0f);
  float r = __fadd_rd(sqrt_approx(m), kRoundMagic);  // 1.5·2^23 + floor(root)
  const float up = r - (kRoundMagic - 1.0f);          // that integer + 1
  r += up * up <= m ? 1.0f : 0.0f;
  return __float_as_uint(r);
}

// A lane's C gray columns of one row: C/4 words of bytes.
template <int C>
struct GrayWords {
  uint32_t v[C / 4];
};

// Horizontal 5-tap sums at columns x0-1 .. x0+C of one gray row: C/2 + 1
// registers of two 16-bit lanes, (x0-1, x0), (x0+1, x0+2), ...
template <int C>
struct Hsum {
  static constexpr int kP = C / 2 + 1;
  uint32_t p[kP];
};

template <int C>
__device__ __forceinline__ Hsum<C> operator+(const Hsum<C>& a, const Hsum<C>& b) {
  Hsum<C> s;
#pragma unroll
  for (int j = 0; j < Hsum<C>::kP; ++j) s.p[j] = a.p[j] + b.p[j];
  return s;
}

// The sums from the word at x0-4 (l), the lane's words and the word at
// x0+C (r). e_m: gray bytes 2m, 2m+1 from x0-4 as 16-bit lanes; o_m: bytes
// 2m+1, 2m+2; the sum centred at x0-1+2j is o_j + 4(e_j+1 + e_j+2) +
// 6·o_j+1 + o_j+2.
template <int C>
__device__ __forceinline__ Hsum<C> hsum_row(uint32_t l, const GrayWords<C>& c, uint32_t r) {
  constexpr int kW = C / 4 + 2, kE = 2 * kW;
  uint32_t wd[kW], e[kE], o[kE - 1];
  wd[0] = l;
#pragma unroll
  for (int i = 0; i < C / 4; ++i) wd[i + 1] = c.v[i];
  wd[kW - 1] = r;
#pragma unroll
  for (int i = 0; i < kW; ++i) {
    e[2 * i] = __byte_perm(wd[i], 0, 0x4140);
    e[2 * i + 1] = __byte_perm(wd[i], 0, 0x4342);
  }
#pragma unroll
  for (int m = 0; m < kE - 1; ++m) o[m] = __byte_perm(e[m], e[m + 1], 0x5432);
  Hsum<C> s;
#pragma unroll
  for (int j = 0; j < Hsum<C>::kP; ++j) {
    s.p[j] = o[j] + 4 * (e[j + 1] + e[j + 2]) + 6 * o[j + 1] + o[j + 2];
  }
  return s;
}

// The Sobel's replication of the blurred image at the left and right edges:
// the blur column x0-1 takes column 0's sums when x0 == 0, and column w
// takes column w-1's. The blur is a column-wise function of these sums, so
// copying the sums copies the blurred column. The lane's PRMT selectors
// are fixed for the whole march (identity 0x3210 away from the edges).
template <int C>
struct EdgeFix {
  uint32_t s[Hsum<C>::kP];

  __device__ __forceinline__ EdgeFix(int x0, int w) {
    const int q = w - 1 - x0;  // the lane's position of column w-1, if it holds it
    s[0] = x0 == 0 ? 0x3232 : 0x3210;  // lo := hi
#pragma unroll
    for (int j = 1; j < Hsum<C>::kP; ++j) {
      // column w is the low lane of pair j (q even: it takes the previous
      // pair's high lane) or its high lane (q odd: it takes the low lane)
      s[j] = q >= 0 && q % 2 == 0 && j == q / 2 + 1 ? 0x3276
             : q >= 0 && q % 2 == 1 && j == (q + 1) / 2 ? 0x1010 : 0x3210;
    }
  }
  __device__ __forceinline__ void apply(Hsum<C>& h) const {
    h.p[0] = __byte_perm(h.p[0], 0, s[0]);
#pragma unroll
    for (int j = 1; j < Hsum<C>::kP; ++j) h.p[j] = __byte_perm(h.p[j], h.p[j - 1], s[j]);
  }
};

// Rounded blur from the vertical 5-tap sum: the blurred value (<= 255) in
// the low byte of each 16-bit lane.
__device__ __forceinline__ uint32_t blur_lanes(uint32_t v) {
  return __byte_perm(v + 0x00800080u, 0, 0x4341);
}

// The Sobel |∇| of the lane's C pixels of one row from the vertical smooth
// S = above + 2·at + below (<= 1020 per lane) and the vertical difference
// D = below - above + 510 of the blurred rows, each over x0-1 .. x0+C.
// `magic` holds kMagicBits. Returns the C output bytes as C/4 words.
template <int C>
__device__ __forceinline__ GrayWords<C> sobel_words(const uint32_t* sm, const uint32_t* df,
                                                   uint32_t magic) {
  uint32_t m[C];
#pragma unroll
  for (int k = 0; k < C / 2; ++k) {  // output columns x0+2k, x0+2k+1
    const uint32_t gx = sm[k + 1] + 0x03FC03FCu - sm[k];  // gx + 1020 per lane
    const uint32_t gy = df[k] + 2 * __byte_perm(df[k], df[k + 1], 0x5432) + df[k + 1];  // + 2040
    // 0x7410 / 0x7432: the low / high 16-bit lane under the magic exponent.
    m[2 * k] = magnitude_bits(__byte_perm(gx, magic, 0x7410), __byte_perm(gy, magic, 0x7410));
    m[2 * k + 1] = magnitude_bits(__byte_perm(gx, magic, 0x7432), __byte_perm(gy, magic, 0x7432));
  }
  GrayWords<C> out;
#pragma unroll
  for (int i = 0; i < C / 4; ++i) {
    out.v[i] = __byte_perm(__byte_perm(m[4 * i], m[4 * i + 1], 0x0040),
                           __byte_perm(m[4 * i + 2], m[4 * i + 3], 0x0040), 0x5410);
  }
  return out;
}

// The row march of one lane: its state and its steps. `src` gives gray:
//   Src::kCols                   C, the lane's columns;
//   src.load(yc)                 the raw data of row yc for the lane (loads);
//   src.gray(raw, yc, store)     GrayWords<C> at columns clamp(x0 .. x0+C-1),
//                                where `store` says the lane owns x0 on an
//                                output row.
// The vertical taps are cascades of [1, 1] sums, each holding one row:
// (1, 4, 6, 4, 1) = [1, 1]⁴ for the blur, and (1, 2, 1) = [1, 1]², (1, 0,
// -1) = [1, 1]·[1, -1] for the Sobel. The next row's load is issued before
// the current row is worked, so its latency hides behind that work.
template <class Src>
struct March {
  static constexpr int C = Src::kCols;
  static constexpr int kP = Hsum<C>::kP;
  const Src& src;
  int h;
  EdgeFix<C> fix;
  decltype(src.load(0)) next;
  Hsum<C> h1 = {}, a1 = {}, a2 = {}, a3 = {};         // the blur cascade at the last row
  uint32_t b1[kP] = {}, s1[kP] = {}, d1[kP] = {};    // the Sobel cascade at the last row

  __device__ __forceinline__ March(const Src& s, int h_, int w, int x0, int g0)
      : src(s), h(h_), fix(x0, w), next(s.load(clampi(g0, 0, h_ - 1))) {}

  // Gray row g (the next one of the march) into the blur cascade; returns
  // the vertical 5-tap sums of rows g-4 .. g, centred at g-2.
  __device__ __forceinline__ Hsum<C> gray_row(int g, bool store) {
    const auto raw = next;
    next = src.load(clampi(g + 1, 0, h - 1));
    const GrayWords<C> c = src.gray(raw, clampi(g, 0, h - 1), store);
    const uint32_t l = __shfl_up_sync(0xFFFFFFFFu, c.v[C / 4 - 1], 1);
    const uint32_t r = __shfl_down_sync(0xFFFFFFFFu, c.v[0], 1);
    Hsum<C> hn = hsum_row<C>(l, c, r);
    fix.apply(hn);
    const Hsum<C> n1 = hn + h1, n2 = n1 + a1, n3 = n2 + a2, v = n3 + a3;
    h1 = hn;
    a1 = n1;
    a2 = n2;
    a3 = n3;
    return v;
  }
  // The blurred row of `v` (centre c) into the Sobel cascade: sm, df get
  // the vertical smooth and difference (+ 510) centred at c-1. `bottom`:
  // row c lies below the image, so it repeats row c-1.
  __device__ __forceinline__ void blurred_row(const Hsum<C>& v, uint32_t* sm, uint32_t* df,
                                              bool bottom) {
#pragma unroll
    for (int k = 0; k < kP; ++k) {
      const uint32_t bl = blur_lanes(v.p[k]);
      const uint32_t sn = bottom ? 2 * b1[k] : bl + b1[k];
      const uint32_t dn = bottom ? 0x00FF00FFu : bl + 0x00FF00FFu - b1[k];  // + 255
      sm[k] = sn + s1[k];
      df[k] = dn + d1[k];
      b1[k] = bl;
      s1[k] = sn;
      d1[k] = dn;
    }
  }
  // Row -1 above the image repeats row 0 (the last blurred row).
  __device__ __forceinline__ void top_edge() {
#pragma unroll
    for (int k = 0; k < kP; ++k) {
      s1[k] = 2 * b1[k];
      d1[k] = 0x00FF00FFu;
    }
  }
};

// One warp's strip: output rows y0 .. y1-1 (y1 <= h) of the [h, w] plane
// `out`; this lane's columns x0 .. x0+C-1, stored when `owner` (lanes 0
// and 31 only supply the halo of their neighbours). A prologue takes gray
// rows y0-3 .. y0+2; each step of the loop then takes one gray row and
// gives one output row, with no branch, so unrolled by 2 the cascades'
// previous and new rows swap registers with no moves; the last output row
// is peeled off for the bottom edge. kWordStore: w % 4 == 0 and `out`
// 4-byte aligned, so a lane stores its words left of w. `magic` holds
// kMagicBits. Every lane of the warp must call it (shuffles); y0, y1 are
// warp-uniform.
template <bool kWordStore, class Src>
__device__ __forceinline__ void blur_sobel_strip(const Src& src, uint8_t* __restrict__ out,
                                                 int h, int w, int x0, int y0, int y1,
                                                 bool owner, uint32_t magic) {
  constexpr int C = Src::kCols;
  March<Src> m(src, h, w, x0, y0 - 3);
  uint32_t sm[Hsum<C>::kP], df[Hsum<C>::kP];
  for (int g = y0 - 3; g < y0 + 3; ++g) {
    const Hsum<C> v = m.gray_row(g, owner && g >= y0 && g < y1);
    if (g >= y0 + 1) m.blurred_row(v, sm, df, false);  // centres y0-1, y0
  }
  if (y0 == 0) m.top_edge();
  uint8_t* row = out + static_cast<size_t>(y0) * w + x0;
  const auto put = [&] {
    const GrayWords<C> word = sobel_words<C>(sm, df, magic);
    if (kWordStore) {
#pragma unroll
      for (int i = 0; i < C / 4; ++i) {
        if (owner && x0 + 4 * i < w) reinterpret_cast<uint32_t*>(row)[i] = word.v[i];
      }
    } else if (owner) {
#pragma unroll
      for (int i = 0; i < C; ++i) {
        if (x0 + i < w) row[i] = static_cast<uint8_t>(word.v[i / 4] >> (8 * (i % 4)));
      }
    }
    row += w;
  };
#pragma unroll 2
  for (int y = y0; y < y1 - 1; ++y) {
    m.blurred_row(m.gray_row(y + 3, owner && y + 3 < y1), sm, df, false);
    put();
  }
  m.blurred_row(m.gray_row(y1 + 2, false), sm, df, y1 == h);
  put();
}

// Output rows per strip: as many strips as give the card its resident
// warps once (one wave, no tail), within 8 .. 64 rows (the halo costs
// (rows + 6) / rows). `kernel` is the kernel to launch, for its occupancy;
// `resident_warps` caches the card's number for it (0: not yet read).
template <class Kernel>
inline int strip_rows(Kernel kernel, int& resident_warps, int cols, int n, int h, int w) {
  if (resident_warps == 0) {
    int dev = 0, sms = 0, blocks = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kLanes * kWarps, 0);
    resident_warps = max(sms * blocks * kWarps, 1);
  }
  const int out_cols = (kLanes - 2) * cols;
  const long col_warps = static_cast<long>(n) * ((w + out_cols - 1) / out_cols);
  const long strips = max(resident_warps / col_warps, 1L);
  return static_cast<int>(min(max((h + strips - 1) / strips, 8L), 64L));
}

inline dim3 strip_grid(int cols, int n, int h, int w, int rows) {
  const int strips = (h + rows - 1) / rows;
  const int out_cols = (kLanes - 2) * cols;
  return dim3((w + out_cols - 1) / out_cols, (strips + kWarps - 1) / kWarps, n);
}

// Gray words of a [h, w] u8 plane for one lane at columns x0 .. x0+C-1,
// clamped (K1 and K6). kWords: w % 4 == 0 and the plane 4-byte aligned, so
// the lane loads each aligned word at clamp(x, 0, w-4) and, off the
// image's edges, repeats its edge byte (PRMT selectors fixed for the
// march); otherwise it loads bytes at clamped columns.
template <bool kWords, int C>
struct GrayRows {
  static constexpr int kCols = C;
  const uint8_t* __restrict__ plane;
  int w, x0;
  uint32_t sel[C / 4];

  __device__ __forceinline__ GrayRows(const uint8_t* p, int w_, int x0_)
      : plane(p), w(w_), x0(x0_) {
#pragma unroll
    for (int i = 0; i < C / 4; ++i) {
      const int x = x0_ + 4 * i;
      sel[i] = x < 0 ? 0x0000 : x >= w_ ? 0x3333 : 0x3210;
    }
  }
  __device__ __forceinline__ GrayWords<C> load(int yc) const {
    const uint8_t* row = plane + static_cast<size_t>(yc) * w;
    GrayWords<C> v;
#pragma unroll
    for (int i = 0; i < C / 4; ++i) {
      if (kWords) {
        v.v[i] = __ldg(reinterpret_cast<const uint32_t*>(row + clampi(x0 + 4 * i, 0, w - 4)));
      } else {
        v.v[i] = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          v.v[i] |= static_cast<uint32_t>(row[clampi(x0 + 4 * i + b, 0, w - 1)]) << (8 * b);
        }
      }
    }
    return v;
  }
  __device__ __forceinline__ GrayWords<C> gray(GrayWords<C> raw, int, bool) const {
    if (kWords) {
#pragma unroll
      for (int i = 0; i < C / 4; ++i) raw.v[i] = __byte_perm(raw.v[i], 0, sel[i]);
    }
    return raw;
  }
};

// The warp's strip and this lane's first column, or false when the strip
// lies below the image (the whole warp returns). A warp outputs 30·cols
// columns from lanes 1 .. 30; lanes 0 and 31 read the columns on either
// side.
__device__ __forceinline__ bool warp_strip(int cols, int h, int rows, int& y0, int& y1, int& x0,
                                           bool& owner) {
  y0 = (blockIdx.y * kWarps + threadIdx.y) * rows;
  y1 = min(y0 + rows, h);
  x0 = (static_cast<int>(blockIdx.x) * (kLanes - 2) + static_cast<int>(threadIdx.x) - 1) * cols;
  owner = threadIdx.x >= 1 && threadIdx.x <= kLanes - 2;
  return y0 < h;
}

}  // namespace rcv
