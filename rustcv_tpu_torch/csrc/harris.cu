// K6: Harris response on u8 gray [N, H, W], one kernel in two arithmetic
// forms (float32 and the frozen int32 fixed-point spec).
//
// Replaces the Pallas kernel rustcv_tpu/ops/pallas/harris.py
// (harris_response_pallas), the float32 response. The int32 form computes
// features.harris_response_i32, which defines config 4's corners.
//
// Math (both forms, bit-exact with the plain PyTorch versions in
// rustcv_tpu_torch/ops/kernels/harris.py):
//   gx, gy   integer 3×3 Sobel on replicate-padded gray;
//   products gx², gy², gx·gy (float32: of gx/1020 and gy/1020);
//   window   separable 5×5 (1, 4, 6, 4, 1) over the replicate-padded
//            PRODUCTS (a product outside the image equals the product at
//            the clamped position, not a product of replicated gray):
//            horizontal taps first, then vertical;
//   float32: taps /16 summed left to right, R = det − (k·tr)·tr;
//   int32:   s5 = ((Σ + 128) >> 8) >> 5 = (Σ + 128) >> 13 (arithmetic
//            shifts compose), R = det − k_num·((((sxx5 + syy5) >> 1)²) >> 8).
//
// Bound: the response reads 1 B and writes 4 B per pixel, but its
// arithmetic (about 65 instructions per pixel at 8 × 1080p, most of them on
// the half-rate integer pipes in the int32 form) is the nearer limit. The
// design is the row march of stencil.cuh: a warp walks a strip of 11 to 24
// output rows, a lane owns 4 adjacent columns (lanes 0 and 31 only supply
// the halo), and the neighbours' gray comes by warp shuffles; no shared
// memory, no barrier.
// Per gray row a lane takes its gray as 16-bit pairs and keeps the
// vertical Sobel sums as [1, 1] cascades; per product row it forms gx, gy
// at its columns ±2 in 16-bit lanes (PRMT selectors fixed per lane
// replicate them, and so the products, past the image's edges), the three
// products on the FP32 pipe, and their horizontal 5-tap; the vertical
// 5-tap is a cascade of four partial sums per column and product, each
// summed oldest row first, which keeps the float32 form's order of
// roundings with no register moves. The int32 form computes each product
// as the bits of gx·gy + 1.5·2²³ (exact: |gx·gy| < 2²⁰), so its sums run in
// wrapping integers, each carrying a constant bias that the final shift
// removes.
//
// C interface for ctypes: each launcher returns cudaGetLastError().

#include "stencil.cuh"

namespace rcv {

// float32 form (K6). One IEEE rounding per operation, in the plain
// version's order; the _rn intrinsics keep nvcc from contracting a
// multiply and an add into an FMA. The taps run on values 16 times the
// plain version's, weights (1, 4, 6, 4, 1) for (1, 4, 6, 4, 1)/16: scaling
// by a power of two commutes with every rounding (no value here comes near
// float32's overflow or subnormal range), so each sum is exactly 16 times
// the plain one, the windows 256 times, the response 65536 times, and one
// exact multiply by 2⁻¹⁶ gives the plain response bit for bit. A weight of
// 4 or 1 scales exactly, so fmaf with it rounds once, as the plain
// multiply and add do.
struct HarrisF32 {
  using T = float;
  using Out = float;
  float k;

  __device__ __forceinline__ void products(float gx, float gy, float& xx, float& yy,
                                           float& xy) const {
    const float norm = static_cast<float>(1.0 / (255.0 * 4.0));
    const float fx = __fmul_rn(gx, norm);
    const float fy = __fmul_rn(gy, norm);
    xx = __fmul_rn(fx, fx);
    yy = __fmul_rn(fy, fy);
    xy = __fmul_rn(fx, fy);
  }
  // 16 · (1, 4, 6, 4, 1)/16 · p, summed left to right.
  __device__ __forceinline__ float hsum(float p0, float p1, float p2, float p3, float p4) const {
    float acc = fmaf(4.0f, p1, p0);
    acc = __fadd_rn(acc, __fmul_rn(6.0f, p2));
    acc = fmaf(4.0f, p3, acc);
    return __fadd_rn(acc, p4);
  }
  // A new row into the vertical cascade: q[j] holds the sum of the first
  // j+1 terms of a window that started j rows ago; returns the window that
  // the new row completes.
  __device__ __forceinline__ float feed(float (&q)[4], float v) const {
    const float out = __fadd_rn(q[3], v);
    q[3] = fmaf(4.0f, v, q[2]);
    q[2] = __fadd_rn(q[1], __fmul_rn(6.0f, v));
    q[1] = fmaf(4.0f, v, q[0]);
    q[0] = v;
    return out;
  }
  __device__ __forceinline__ float response(float sxx, float syy, float sxy) const {
    const float det = __fsub_rn(__fmul_rn(sxx, syy), __fmul_rn(sxy, sxy));
    const float tr = __fadd_rn(sxx, syy);
    return __fmul_rn(__fsub_rn(det, __fmul_rn(__fmul_rn(k, tr), tr)), 1.0f / 65536.0f);
  }
};

// int32 form. A product is carried as its biased bits b = p + 0x4B400000
// (the bits of the float p + 1.5·2²³, exact for |p| ≤ 1020² < 2²²); the
// window's weights sum to 256, so the window sum is Σ + 256·0x4B400000 =
// Σ + 0x40000000 modulo 2³². Σ is at most 256·1020² < 2³¹, so the window
// is exact, and after >> 13 every product below fits int32
// (golden.harris_response_i32). Only k_num·(...) may exceed it for a large
// k_num: that step wraps in unsigned arithmetic, as int32 tensors do.
struct HarrisI32 {
  using T = uint32_t;
  using Out = int;
  int k_num;

  __device__ __forceinline__ void products(float gx, float gy, uint32_t& xx, uint32_t& yy,
                                           uint32_t& xy) const {
    xx = __float_as_uint(fmaf(gx, gx, kRoundMagic));
    yy = __float_as_uint(fmaf(gy, gy, kRoundMagic));
    xy = __float_as_uint(fmaf(gx, gy, kRoundMagic));
  }
  __device__ __forceinline__ uint32_t hsum(uint32_t p0, uint32_t p1, uint32_t p2, uint32_t p3,
                                           uint32_t p4) const {
    return p0 + p4 + 4 * (p1 + p3) + 6 * p2;
  }
  __device__ __forceinline__ uint32_t feed(uint32_t (&q)[4], uint32_t v) const {
    const uint32_t out = q[3] + v;
    q[3] = q[2] + 4 * v;
    q[2] = q[1] + 6 * v;
    q[1] = q[0] + 4 * v;
    q[0] = v;
    return out;
  }
  // (Σ + 128) >> 13 from the biased window sum.
  __device__ __forceinline__ static int window(uint32_t acc) {
    return static_cast<int>(acc + (128u - 0x40000000u)) >> 13;
  }
  __device__ __forceinline__ int response(uint32_t axx, uint32_t ayy, uint32_t axy) const {
    const int sxx5 = window(axx), syy5 = window(ayy), sxy5 = window(axy);
    const int det = sxx5 * syy5 - sxy5 * sxy5;
    const int trh = (sxx5 + syy5) >> 1;
    const unsigned penalty =
        static_cast<unsigned>(k_num) * static_cast<unsigned>((trh * trh) >> 8);
    return static_cast<int>(static_cast<unsigned>(det) - penalty);
  }
};

// One lane's march over a strip: C output columns x0 .. x0+C-1. Gray pairs
// k = 0 .. C/2+2 hold columns (x0-3+2k, x0-2+2k) as 16-bit lanes; product
// columns j = 0 .. C+3 are x0-2+j.
template <class P, class Src>
struct HarrisMarch {
  static constexpr int C = Src::kCols;
  static constexpr int kG = C / 2 + 3;  // gray pairs
  static constexpr int kQ = C + 4;      // product columns
  using T = typename P::T;
  const Src& src;
  const P& pol;
  int h;
  // PRMT selectors that replicate the products at the image's edges, fixed
  // for the march: pair k of gx (and of gy) takes its lanes from itself or
  // from pair k-1 once fixed (bytes 4-7), identity 0x3210 away from the
  // edges. Replicating gx and gy at a column replicates its products.
  uint32_t fix[kQ / 2];
  decltype(src.load(0)) next;
  uint32_t g1[kG] = {}, a1[kG] = {}, d1[kG] = {};  // the gray cascade at the last row
  uint32_t sm[kG], df[kG];  // vertical smooth (<= 1020) and difference (+ 510) per pair
  T q[3][C][4] = {};        // the vertical cascades per product and column

  __device__ __forceinline__ HarrisMarch(const Src& s, const P& p, int h_, int w, int x0, int g0)
      : src(s), pol(p), h(h_), next(s.load(clampi(g0, 0, h_ - 1))) {
    const int last = w - 1 - (x0 - 2);  // the product column of image column w-1
#pragma unroll
    for (int k = 1; k < kQ / 2; ++k) {
      // columns beyond w-1 take column w-1: the pair's high lane from its
      // low one, or both lanes from the previous pair's high lane
      fix[k] = 2 * k + 1 <= last ? 0x3210 : 2 * k == last ? 0x1010 : 0x7676;
    }
    fix[0] = x0 == 0 ? 0x5454 : 0x3210;  // columns -2, -1 take column 0 (pair 1's low lane)
  }

  // Gray row g (the next one of the march): sm and df then hold the
  // vertical Sobel sums centred at g-1 over rows clamp(g-2 .. g).
  __device__ __forceinline__ void gray_row(int g) {
    const auto raw = next;
    next = src.load(clampi(g + 1, 0, h - 1));
    const GrayWords<C> c = src.gray(raw, clampi(g, 0, h - 1), false);
    uint32_t wd[C / 4 + 2];
    wd[0] = __shfl_up_sync(0xFFFFFFFFu, c.v[C / 4 - 1], 1);
#pragma unroll
    for (int i = 0; i < C / 4; ++i) wd[i + 1] = c.v[i];
    wd[C / 4 + 1] = __shfl_down_sync(0xFFFFFFFFu, c.v[0], 1);
#pragma unroll
    for (int k = 0; k < kG; ++k) {
      // bytes 1+2k, 2+2k of wd as the low bytes of two 16-bit lanes
      const int b = 1 + 2 * k;
      const uint32_t t = b % 4 == 1 ? wd[b / 4] : __funnelshift_r(wd[b / 4], wd[b / 4 + 1], 24);
      const uint32_t p = __byte_perm(t, 0, b % 4 == 1 ? 0x4241 : 0x4140);
      const uint32_t a = p + g1[k];
      const uint32_t d = p + 0x00FF00FFu - g1[k];
      sm[k] = a + a1[k];
      df[k] = d + d1[k];
      g1[k] = p;
      a1[k] = a;
      d1[k] = d;
    }
  }

  // The products at the centre of sm, df, at columns clamp(x0-2 .. x0+C+1),
  // and their horizontal window sums at x0 .. x0+C-1.
  __device__ __forceinline__ void product_row(T (&hs)[3][C], uint32_t magic) const {
    uint32_t gx[kQ / 2], gy[kQ / 2];
#pragma unroll
    for (int k = 0; k < kQ / 2; ++k) {  // product columns 2k, 2k+1
      gx[k] = sm[k + 1] + 0x03FC03FCu - sm[k];  // gx + 1020 per lane
      gy[k] = df[k] + 2 * __byte_perm(df[k], df[k + 1], 0x5432) + df[k + 1];  // + 2040
    }
#pragma unroll
    for (int k = 1; k < kQ / 2; ++k) {
      gx[k] = __byte_perm(gx[k], gx[k - 1], fix[k]);
      gy[k] = __byte_perm(gy[k], gy[k - 1], fix[k]);
    }
    gx[0] = __byte_perm(gx[0], gx[1], fix[0]);
    gy[0] = __byte_perm(gy[0], gy[1], fix[0]);
    T pr[3][kQ];
#pragma unroll
    for (int k = 0; k < kQ / 2; ++k) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint32_t sel = half ? 0x7432 : 0x7410;  // the lane under the magic exponent
        const float fx = __uint_as_float(__byte_perm(gx[k], magic, sel)) - (kMagic + 1020.0f);
        const float fy = __uint_as_float(__byte_perm(gy[k], magic, sel)) - (kMagic + 2040.0f);
        pol.products(fx, fy, pr[0][2 * k + half], pr[1][2 * k + half], pr[2][2 * k + half]);
      }
    }
#pragma unroll
    for (int m = 0; m < 3; ++m) {
#pragma unroll
      for (int i = 0; i < C; ++i) {
        hs[m][i] = pol.hsum(pr[m][i], pr[m][i + 1], pr[m][i + 2], pr[m][i + 3], pr[m][i + 4]);
      }
    }
  }

  // One product row's sums into the vertical cascades; out gets the
  // windows it completes.
  __device__ __forceinline__ void feed(const T (&hs)[3][C], T (&out)[3][C]) {
#pragma unroll
    for (int m = 0; m < 3; ++m) {
#pragma unroll
      for (int i = 0; i < C; ++i) out[m][i] = pol.feed(q[m][i], hs[m][i]);
    }
  }
};

__device__ __forceinline__ uint32_t out_bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t out_bits(int v) { return static_cast<uint32_t>(v); }

// One warp's strip: output rows y0 .. y1-1 of the [h, w] plane; the lane's
// columns x0 .. x0+C-1, stored when `owner`. Product rows y0-2 .. y1+1 at
// clamped rows: the centres above the image take row 0 (fed three times
// when y0 == 0), those below it repeat row h-1. The main loop computes
// one product row and one output row per step, with no branch.
// kStore: w % 4 == 0 and `out` 16-byte aligned, so C outputs go out as
// 16-byte stores. Every lane of the warp must call it (shuffles).
template <bool kStore, class P, class Src>
__device__ __forceinline__ void harris_strip(const Src& src, const P& pol,
                                             typename P::Out* __restrict__ out, int h, int w,
                                             int x0, int y0, int y1, bool owner, uint32_t magic) {
  constexpr int C = Src::kCols;
  using T = typename P::T;
  using Out = typename P::Out;
  HarrisMarch<P, Src> m(src, pol, h, w, x0, y0 - 3);
  m.gray_row(y0 - 3);
  m.gray_row(y0 - 2);
  T hs[3][C], acc[3][C];
  for (int c = y0 - 2; c < y0 + 2; ++c) {  // the first four product rows
    if (c < h) {
      m.gray_row(c + 1);
      if (c < 0) continue;
      m.product_row(hs, magic);
    }
    for (int r = c == 0 ? 3 - y0 : 1; r > 0; --r) m.feed(hs, acc);
  }
  Out* row = out + static_cast<size_t>(y0) * w + x0;
  const auto put = [&] {
    Out v[C];
#pragma unroll
    for (int i = 0; i < C; ++i) v[i] = pol.response(acc[0][i], acc[1][i], acc[2][i]);
    if (kStore) {
#pragma unroll
      for (int i = 0; i < C / 4; ++i) {
        if (owner && x0 + 4 * i < w) {
          reinterpret_cast<uint4*>(row)[i] = make_uint4(out_bits(v[4 * i]), out_bits(v[4 * i + 1]),
                                                        out_bits(v[4 * i + 2]),
                                                        out_bits(v[4 * i + 3]));
        }
      }
    } else if (owner) {
#pragma unroll
      for (int i = 0; i < C; ++i) {
        if (x0 + i < w) row[i] = v[i];
      }
    }
    row += w;
  };
  const int y_end = min(y1, h - 2);  // rows whose last product row lies in the image
  int y = y0;
#pragma unroll 2
  for (; y < y_end; ++y) {
    m.gray_row(y + 3);
    m.product_row(hs, magic);
    m.feed(hs, acc);
    put();
  }
  for (; y < y1; ++y) {  // the bottom rows repeat product row h-1
    m.feed(hs, acc);
    put();
  }
}

constexpr int kHarrisCols = 4;  // columns per lane
// Strip heights the launcher picks from: a strip computes rows + 4 product
// rows, so shorter strips pay more halo, and taller ones leave too few
// warps to hide the march's latency (on the H100 the fastest fixed heights
// lay within this range at 1 and at 8 × 1080p).
constexpr int kHarrisMinRows = 11;
constexpr int kHarrisMaxRows = 24;

// At most 128 registers a thread: 4 blocks (16 warps) per SM.
template <bool kWords, class P>
__global__ void __launch_bounds__(kLanes * kWarps, 4)
    harris_kernel(const uint8_t* __restrict__ gray, typename P::Out* __restrict__ out, int h,
                  int w, int rows, P pol, uint32_t magic) {
  int y0, y1, x0;
  bool owner;
  if (!warp_strip(kHarrisCols, h, rows, y0, y1, x0, owner)) return;  // the whole warp
  const size_t plane = static_cast<size_t>(blockIdx.z) * h * w;
  harris_strip<kWords>(GrayRows<kWords, kHarrisCols>(gray + plane, w, x0), pol, out + plane, h,
                       w, x0, y0, y1, owner, magic);
}

// Rows per strip, within kHarrisMinRows .. kHarrisMaxRows, that least load
// the busiest SM when the strips (kWarps to a block) spread evenly over
// the card's SMs: the SM that gets ceil(blocks / SMs) blocks works rows + 4
// product rows per warp of each. For a grid of about one wave this beats
// filling the card to the brim; `sms` caches the card's number of SMs (0:
// not yet read).
inline int harris_rows(int& sms, long col_warps, int h) {
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    sms = max(sms, 1);
  }
  int best = kHarrisMinRows;
  long best_cost = -1;
  for (int rows = kHarrisMinRows; rows <= kHarrisMaxRows; ++rows) {
    const long strips = (h + rows - 1) / rows;
    const long blocks = col_warps * ((strips + kWarps - 1) / kWarps);
    const long cost = (blocks + sms - 1) / sms * (rows + 4);
    if (best_cost < 0 || cost < best_cost) {
      best = rows;
      best_cost = cost;
    }
  }
  return best;
}

template <class P>
int launch_harris(const void* gray, void* out, int n, int h, int w, P pol, void* stream) {
  static int sms = 0;  // read from the card at first use
  const auto st = static_cast<cudaStream_t>(stream);
  const bool words = w % 4 == 0 && reinterpret_cast<uintptr_t>(gray) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 block(kLanes, kWarps);
  const auto* in = static_cast<const uint8_t*>(gray);
  auto* o = static_cast<typename P::Out*>(out);
  const int out_cols = (kLanes - 2) * kHarrisCols;
  const int rows = harris_rows(sms, static_cast<long>(n) * ((w + out_cols - 1) / out_cols), h);
  const dim3 grid = strip_grid(kHarrisCols, n, h, w, rows);
  if (words) {
    harris_kernel<true, P><<<grid, block, 0, st>>>(in, o, h, w, rows, pol, kMagicBits);
  } else {
    harris_kernel<false, P><<<grid, block, 0, st>>>(in, o, h, w, rows, pol, kMagicBits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rcv

extern "C" int rcv_harris_response_f32(const void* gray, void* out, int n, int h, int w, float k,
                                       void* stream) {
  return rcv::launch_harris(gray, out, n, h, w, rcv::HarrisF32{k}, stream);
}

extern "C" int rcv_harris_response_i32(const void* gray, void* out, int n, int h, int w,
                                       int k_num, void* stream) {
  return rcv::launch_harris(gray, out, n, h, w, rcv::HarrisI32{k_num}, stream);
}
