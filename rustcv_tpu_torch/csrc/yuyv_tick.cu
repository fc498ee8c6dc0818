// K4 and K5: the YUYV tick kernels.
//
// K4 yuyv_decode_interleave replaces rustcv_tpu/ops/pallas/decode_interleave.py
// (yuyv_decode_interleave): YUYV words → BT.601 pair values → gray (taken
// before the overlay) and, with the rectangle overlay applied to the pair's
// two pixels, packed BGR rows.
//
// K5 yuyv_tick_fused replaces rustcv_tpu/ops/pallas/tick_fused.py
// (yuyv_tick_fused): K4's decode, overlay and BGR store, plus K1's blur +
// Sobel |∇| on the gray, which never reaches device memory: the row march
// of stencil.cuh reads its gray rows from the wire words, decoded in
// registers.
//
// Bound: bytes. Per pixel K4 reads 2 B and writes 4 B (3 BGR + 1 gray);
// K5 reads 2 B and writes 4 B (3 BGR + 1 filtered), where the unfused path
// also writes and re-reads the gray plane. Design: one thread per YUYV
// word (pixel pair) for K4, storing its 6 BGR bytes as three 16-bit words.
// K5: a lane owns 4 columns (2 words) of a warp's strip of rows and
// decodes each of its words once per row into gray and BGR; the neighbours'
// gray comes by warp shuffles, and lanes 0 and 31 decode the warp's halo
// words (±2 words, clamped). The overlay's rectangle is classified
// once per row, so a pixel tests only x. BGR goes out as 3 words per lane
// where W % 4 == 0, else as 16-bit words. Any even W and any H; K5 also
// takes words at any address (K4 needs them 4-byte aligned).
//
// C interface for ctypes: each launcher returns cudaGetLastError().

#include "stencil.cuh"

namespace rcv {

constexpr int kPairThreads = 128;  // threads per K4 block (pairs of a row)

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__device__ __forceinline__ int clamp_shift8(int x) { return clampi(x >> 8, 0, 255); }

__device__ __forceinline__ int luma(int b, int g, int r) {
  return (77 * r + 150 * g + 29 * b + 128) >> 8;
}

// BT.601 integer decode of one YUYV word (bytes Y0 U Y1 V), as
// rustcv_tpu.ops.color._bt601_pair.
struct Pair {
  int b0, g0, r0, b1, g1, r1;
};

__device__ __forceinline__ Pair decode_pair(uint32_t wd) {
  const int y0 = wd & 255;
  const int u = (wd >> 8) & 255;
  const int y1 = (wd >> 16) & 255;
  const int v = wd >> 24;
  const int c0 = 298 * (y0 - 16);
  const int c1 = 298 * (y1 - 16);
  const int d = u - 128;
  const int e = v - 128;
  const int tb = 516 * d + 128;
  const int tg = -100 * d - 208 * e + 128;
  const int tr = 409 * e + 128;
  return {clamp_shift8(c0 + tb), clamp_shift8(c0 + tg), clamp_shift8(c0 + tr),
          clamp_shift8(c1 + tb), clamp_shift8(c1 + tg), clamp_shift8(c1 + tr)};
}

// The rectangle's edge mask, as rustcv_tpu.ops.draw._edge_masks (int32 wrap
// included).
struct RectMask {
  int x_min, y_min, x_max, y_max, t;
  bool live;
};

__device__ __forceinline__ RectMask make_rect(const int* rect, int t, int w, int h) {
  RectMask m;
  m.x_min = max(rect[0], 0);
  m.y_min = max(rect[1], 0);
  m.x_max = min(wadd(rect[0], rect[2]), w);
  m.y_max = min(wadd(rect[1], rect[3]), h);
  m.t = t;
  m.live = m.x_min < m.x_max && m.y_min < m.y_max;
  return m;
}

__device__ __forceinline__ bool on_edge(const RectMask& m, int x, int y) {
  const bool x_span = x >= m.x_min && x < m.x_max;
  const bool y_span = y >= m.y_min && y < m.y_max;
  const bool top_bot = (y >= m.y_min && y < wadd(m.y_min, m.t)) ||
                       (y >= wsub(m.y_max, m.t) && y < m.y_max);
  const bool left_right = (x >= m.x_min && x < wadd(m.x_min, m.t)) ||
                          (x >= wsub(m.x_max, m.t) && x < m.x_max);
  return m.live && ((x_span && top_bot) || (y_span && left_right));
}

// Overlay (when live) pixel pair i of row y, then store its 6 BGR bytes
// into the packed row as three little-endian 16-bit words.
__device__ __forceinline__ void store_pair(Pair p, uint8_t* __restrict__ bgr_row,
                                           int i, int y, bool overlay,
                                           const RectMask& m,
                                           const uint8_t* color) {
  if (overlay) {
    if (on_edge(m, 2 * i, y)) {
      p.b0 = color[0];
      p.g0 = color[1];
      p.r0 = color[2];
    }
    if (on_edge(m, 2 * i + 1, y)) {
      p.b1 = color[0];
      p.g1 = color[1];
      p.r1 = color[2];
    }
  }
  uint16_t* o = reinterpret_cast<uint16_t*>(bgr_row + 6 * i);
  o[0] = static_cast<uint16_t>(p.b0 | (p.g0 << 8));
  o[1] = static_cast<uint16_t>(p.r0 | (p.b1 << 8));
  o[2] = static_cast<uint16_t>(p.g1 | (p.r1 << 8));
}

__global__ void __launch_bounds__(kPairThreads)
    decode_interleave_kernel(const uint32_t* __restrict__ words,
                             const int* __restrict__ rects,
                             const uint8_t* __restrict__ colors, int thickness,
                             int overlay, uint8_t* __restrict__ bgr,
                             uint8_t* __restrict__ gray, int h, int w) {
  const int p = w >> 1;
  const int i = blockIdx.x * kPairThreads + threadIdx.x;
  if (i >= p) return;
  const int y = blockIdx.y;
  const int s = blockIdx.z;
  const size_t row = static_cast<size_t>(s) * h + y;
  const Pair px = decode_pair(words[row * p + i]);
  *reinterpret_cast<uint16_t*>(gray + row * w + 2 * i) = static_cast<uint16_t>(
      luma(px.b0, px.g0, px.r0) | (luma(px.b1, px.g1, px.r1) << 8));
  RectMask m{};
  if (overlay) m = make_rect(rects + 4 * s, thickness, w, h);
  store_pair(px, bgr + row * 3 * w, i, y, overlay, m, colors + 3 * s);
}

// The overlay's rectangle for K5: which rows paint, then per pixel only the
// x test. on_edge(x, y) = live && ((x_span && top_bot) || (y_span &&
// left_right)); the x intervals, cut to [0, w), are fixed per stream, and
// top_bot and y_span are fixed per row.
struct RectRows {
  int y_min, y_max, top_end, bot_start;
  bool live;
  int lo[3], len[3];  // x_span, left band, right band: [lo, lo + len)

  __device__ __forceinline__ void init(const RectMask& m, int w) {
    y_min = m.y_min;
    y_max = m.y_max;
    top_end = wadd(m.y_min, m.t);
    bot_start = wsub(m.y_max, m.t);
    live = m.live;
    const int a[3] = {m.x_min, m.x_min, wsub(m.x_max, m.t)};
    const int b[3] = {m.x_max, wadd(m.x_min, m.t), m.x_max};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      lo[k] = clampi(a[k], 0, w);
      len[k] = max(clampi(b[k], 0, w) - lo[k], 0);
    }
  }
  // Which of pixels x .. x+3 of row y the rectangle paints (bit i: x + i).
  __device__ __forceinline__ uint32_t row_mask(int y, int x) const {
    const bool top_bot = (y >= y_min && y < top_end) || (y >= bot_start && y < y_max);
    const bool y_span = y >= y_min && y < y_max;
    if (!live || !(top_bot || y_span)) return 0;
    uint32_t mask = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const auto in = [&](int k) {
        return static_cast<unsigned>(x + i - lo[k]) < static_cast<unsigned>(len[k]);
      };
      mask |= ((top_bot && in(0)) || (y_span && (in(1) || in(2)))) ? 1u << i : 0u;
    }
    return mask;
  }
};

// K5's decode (K4 keeps decode_pair) on the FP32 pipe: a channel is
// clamp(floor((298·y + k) / 256), 0, 255) with k per word from u and v, as
// rustcv_tpu.ops.color._bt601_pair. Every FFMA below is exact: its result
// is a multiple of 1/256 below 2^11 in size, well inside float32's 24 bits.
// Adding 1.5·2^23 rounding down gives floor(t) in the low bits, and the
// clamp then keeps 0 .. 255 in the low byte.
__device__ __forceinline__ uint32_t channel(float y, float k) {
  const float t = __fadd_rd(fmaf(y, 298.0f / 256.0f, k), kRoundMagic);
  return __float_as_uint(fminf(fmaxf(t, kRoundMagic), kRoundMagic + 255.0f));
}

// One YUYV word (Y0 U Y1 V) → its two pixels as words of bytes (b, g, r, -).
// `magic` holds kMagicBits: the PRMTs put a byte under the magic exponent.
__device__ __forceinline__ void decode_word(uint32_t wd, uint32_t magic, uint32_t& p0,
                                            uint32_t& p1) {
  const float y0 = __uint_as_float(__byte_perm(wd, magic, 0x7440)) - kMagic;
  const float u = __uint_as_float(__byte_perm(wd, magic, 0x7441)) - kMagic;
  const float y1 = __uint_as_float(__byte_perm(wd, magic, 0x7442)) - kMagic;
  const float v = __uint_as_float(__byte_perm(wd, magic, 0x7443)) - kMagic;
  // k/256 for b, g, r: 516(u-128) + 128, -100(u-128) - 208(v-128) + 128,
  // 409(v-128) + 128, each less 298·16.
  const float kb = fmaf(u, 516.0f / 256.0f, -70688.0f / 256.0f);
  const float kg = fmaf(u, -100.0f / 256.0f, fmaf(v, -208.0f / 256.0f, 34784.0f / 256.0f));
  const float kr = fmaf(v, 409.0f / 256.0f, -56992.0f / 256.0f);
  p0 = __byte_perm(__byte_perm(channel(y0, kb), channel(y0, kg), 0x0040), channel(y0, kr), 0x0410);
  p1 = __byte_perm(__byte_perm(channel(y1, kb), channel(y1, kg), 0x0040), channel(y1, kr), 0x0410);
}

// 256·luma + (0 .. 255): (29·b + 150·g + 77·r + 128), luma in byte 1.
__device__ __forceinline__ uint32_t luma256(uint32_t p) {
  return __dp4a(p, 0x004D961Du, 128u);
}

// Gray words of one stream's YUYV plane for the row march, and the packed
// BGR store of the lane's own pixels on the strip's output rows, from the
// same decode. The lane reads the words clamp(x0/2) and clamp(x0/2 + 1) of
// each row. kWords: w % 4 == 0 and the words 4-byte aligned, so a word is
// one load and a lane's 12 BGR bytes are 3 aligned words; otherwise a word
// is read as 4 bytes and each pixel pair stores three 16-bit words.
template <bool kWords>
struct YuyvRows {
  static constexpr int kCols = 4;
  const uint32_t* __restrict__ words;  // [h, w/2] of this stream
  uint8_t* __restrict__ bgr;           // [h, 3w] of this stream
  int w, x0, ia, ib;
  uint32_t magic;
  uint32_t gray_sel;  // PRMT of the 4 lumas' bytes into the gray of clamp(x0 .. x0+3)
  bool overlay;
  RectRows rect;
  uint32_t color;     // bytes (b, g, r, 0)

  __device__ __forceinline__ uint32_t word(int yc, int i) const {
    const size_t k = static_cast<size_t>(yc) * (w >> 1) + i;
    if (kWords) return __ldg(words + k);
    const uint8_t* b = reinterpret_cast<const uint8_t*>(words) + 4 * k;
    return b[0] | b[1] << 8 | b[2] << 16 | static_cast<uint32_t>(b[3]) << 24;
  }
  __device__ __forceinline__ uint2 load(int yc) const { return {word(yc, ia), word(yc, ib)}; }
  // Gray of pixels clamp(x0 .. x0+3) of row yc; with `store`, the overlaid
  // BGR of pixels x0 .. x0+3 (those left of w) from the same decode.
  __device__ __forceinline__ GrayWords<4> gray(uint2 raw, int yc, bool store) const {
    uint32_t p[4];
    decode_word(raw.x, magic, p[0], p[1]);
    decode_word(raw.y, magic, p[2], p[3]);
    const uint32_t ta = __byte_perm(luma256(p[0]), luma256(p[1]), 0x5151);
    const uint32_t tb = __byte_perm(luma256(p[2]), luma256(p[3]), 0x5151);
    const GrayWords<4> g = {{__byte_perm(ta, tb, gray_sel)}};
    const int x = x0;
    if (!store || x >= w) return g;
    if (overlay) {
      const uint32_t mask = rect.row_mask(yc, x);
      if (mask) {
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = mask >> i & 1 ? color : p[i];
      }
    }
    uint8_t* out = bgr + static_cast<size_t>(yc) * 3 * w + 3 * x;
    if (kWords) {  // x + 3 < w: pixels x .. x+3 as 12 bytes, 3 words
      uint32_t* o = reinterpret_cast<uint32_t*>(out);
      o[0] = __byte_perm(p[0], p[1], 0x4210);
      o[1] = __byte_perm(p[1], p[2], 0x5421);
      o[2] = __byte_perm(p[2], p[3], 0x6542);
    } else {  // 16-bit words: x is even and 3w is even
      uint16_t* o = reinterpret_cast<uint16_t*>(out);
      const int n = x + 2 < w ? 6 : 3;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        if (i < n) {
          const uint32_t lo = p[(2 * i) / 3], hi = p[(2 * i + 1) / 3];
          const uint32_t sel = (2 * i) % 3 | ((2 * i + 1) % 3 + 4) << 4;
          o[i] = static_cast<uint16_t>(__byte_perm(lo, hi, sel));
        }
      }
    }
    return g;
  }
};

template <bool kWords>
__global__ void __launch_bounds__(kLanes * kWarps)
    tick_fused_kernel(const uint32_t* __restrict__ words, const int* __restrict__ rects,
                      const uint8_t* __restrict__ colors, int thickness, int overlay,
                      uint8_t* __restrict__ bgr, uint8_t* __restrict__ filt, int h, int w,
                      int rows, uint32_t magic) {
  int y0, y1, x0;
  bool owner;
  if (!warp_strip(YuyvRows<kWords>::kCols, h, rows, y0, y1, x0, owner)) return;  // whole warp
  const int s = blockIdx.z;
  const int last = (w >> 1) - 1;
  // Left of 0 a pixel is column 0 (the even pixel of word 0); from w on,
  // column w-1 (the odd pixel of the last word). Bytes 0-3: the lumas of
  // the two pixels of word ia, twice; 4-7: of word ib.
  const uint32_t gray_sel = (x0 < w ? 0u : 1u) | (x0 + 1 < 0 ? 0u : 1u) << 4 |
                            (x0 + 2 < w ? 4u : 5u) << 8 | (x0 + 3 < 0 ? 4u : 5u) << 12;
  YuyvRows<kWords> src{words + static_cast<size_t>(s) * h * (w >> 1),
                       bgr + static_cast<size_t>(s) * h * 3 * w, w, x0,
                       clampi(x0 >> 1, 0, last), clampi((x0 >> 1) + 1, 0, last), magic, gray_sel,
                       overlay != 0, {}, 0};
  if (overlay) {
    src.rect.init(make_rect(rects + 4 * s, thickness, w, h), w);
    src.color = colors[3 * s] | colors[3 * s + 1] << 8 | colors[3 * s + 2] << 16;
  }
  blur_sobel_strip<kWords>(src, filt + static_cast<size_t>(s) * h * w, h, w, x0, y0, y1, owner,
                           magic);
}

}  // namespace rcv

extern "C" int rcv_yuyv_decode_interleave(const void* src, const void* rects,
                                          const void* colors, int thickness,
                                          int overlay, void* bgr, void* gray,
                                          int n, int h, int w, void* stream) {
  const dim3 grid((w / 2 + rcv::kPairThreads - 1) / rcv::kPairThreads, h, n);
  rcv::decode_interleave_kernel<<<grid, rcv::kPairThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(src), static_cast<const int*>(rects),
      static_cast<const uint8_t*>(colors), thickness, overlay,
      static_cast<uint8_t*>(bgr), static_cast<uint8_t*>(gray), h, w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rcv_yuyv_tick_fused(const void* src, const void* rects,
                                   const void* colors, int thickness,
                                   int overlay, void* bgr, void* filt, int n,
                                   int h, int w, void* stream) {
  static int resident[2] = {};  // per form, read from the card at first use
  const dim3 block(rcv::kLanes, rcv::kWarps);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* words = static_cast<const uint32_t*>(src);
  const auto* r = static_cast<const int*>(rects);
  const auto* c = static_cast<const uint8_t*>(colors);
  auto* b = static_cast<uint8_t*>(bgr);
  auto* f = static_cast<uint8_t*>(filt);
  // The outputs are fresh allocations (aligned).
  if (w % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 4 == 0) {
    const int rows = rcv::strip_rows(rcv::tick_fused_kernel<true>, resident[1], 4, n, h, w);
    rcv::tick_fused_kernel<true><<<rcv::strip_grid(4, n, h, w, rows), block, 0, st>>>(
        words, r, c, thickness, overlay, b, f, h, w, rows, rcv::kMagicBits);
  } else {
    const int rows = rcv::strip_rows(rcv::tick_fused_kernel<false>, resident[0], 4, n, h, w);
    rcv::tick_fused_kernel<false><<<rcv::strip_grid(4, n, h, w, rows), block, 0, st>>>(
        words, r, c, thickness, overlay, b, f, h, w, rows, rcv::kMagicBits);
  }
  return static_cast<int>(cudaGetLastError());
}
