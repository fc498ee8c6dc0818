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
// also writes and re-reads the gray plane. Both decode on the FP32 pipe
// (decode_word, exact on all 2^24 (Y, U, V)) and take luma with dp4a.
// K4: a warp walks 2 rows over 256 columns of one stream (many short-lived
// warps stream better than long marches); a lane owns 8 pixels (4 words)
// of each row, loads them as one 16-byte word while it works the row
// before, overlays with masks classified once per lane (x) and once per
// row (y), and stores 8 gray bytes and 24 BGR bytes, staged through shared
// memory so that each store instruction of the warp covers 256 contiguous
// bytes. K5: a lane owns 4 columns (2 words) of a
// warp's strip of rows and decodes each of its words once per row into
// gray and BGR; the neighbours' gray comes by warp shuffles, and lanes 0
// and 31 decode the warp's halo words (±2 words, clamped). The overlay's
// rectangle is classified once per row, so a pixel tests only x. BGR goes
// out as 3 words per lane where W % 4 == 0, else as 16-bit words. Both
// take any even W, any H and words at any address (their second forms
// read words or bytes).
//
// C interface for ctypes: each launcher returns cudaGetLastError().

#include "stencil.cuh"

namespace rcv {

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
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

// The overlay's rectangle, classified once per row: a pixel (x, y) is on
// the edge when live && ((x_span && top_bot) || (y_span && left_right)).
// The x intervals, cut to [0, w), are fixed per stream, and top_bot and
// y_span are fixed per row.
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
  // Which of pixels x .. x+P-1 lie in the x span (`span`) and in the left
  // or right band (`band`), bit i for x + i; fixed for a lane's march.
  template <int P>
  __device__ __forceinline__ void cols(int x, uint32_t& span, uint32_t& band) const {
    span = band = 0;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const auto in = [&](int k) {
        return static_cast<unsigned>(x + i - lo[k]) < static_cast<unsigned>(len[k]);
      };
      span |= live && in(0) ? 1u << i : 0u;
      band |= live && (in(1) || in(2)) ? 1u << i : 0u;
    }
  }
  // Which of those pixels the rectangle paints on row y.
  __device__ __forceinline__ uint32_t row_of(int y, uint32_t span, uint32_t band) const {
    const bool top_bot = (y >= y_min && y < top_end) || (y >= bot_start && y < y_max);
    const bool y_span = y >= y_min && y < y_max;
    return (top_bot ? span : 0u) | (y_span ? band : 0u);
  }
};

// The decode of K4 and K5, on the FP32 pipe: a channel is
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

constexpr int kDecCols = 8;                  // K4: pixels (4 YUYV words) per lane
constexpr int kDecSpan = kLanes * kDecCols;  // K4: pixels per warp and row
// K4: rows per warp. Many short-lived warps stream better than one wave of
// long row marches: on the H100 at 8 × 1080p, strips of 2 rows ran faster
// than taller strips or one wave of them.
constexpr int kDecRows = 2;

// K4's 4 words of row y at word i0 (pixels 2·i0 ..). kVec: one 16-byte
// load; otherwise the words left of w/2 as words (aligned4) or as bytes,
// the others 0.
template <bool kVec>
__device__ __forceinline__ uint4 decode_load(const uint8_t* __restrict__ in, int y, int i0,
                                             int wp, bool aligned4) {
  const uint8_t* row = in + static_cast<size_t>(y) * 4 * wp;
  if (kVec) return __ldg(reinterpret_cast<const uint4*>(row) + (i0 >> 2));
  uint32_t wd[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint8_t* b = row + 4 * (i0 + k);
    wd[k] = i0 + k >= wp ? 0u
            : aligned4   ? __ldg(reinterpret_cast<const uint32_t*>(b))
                         : b[0] | b[1] << 8 | b[2] << 16 | static_cast<uint32_t>(b[3]) << 24;
  }
  return {wd[0], wd[1], wd[2], wd[3]};
}

// K4: a warp walks kDecRows rows of one stream over kDecSpan pixels; a lane
// owns 8 pixels (4 words) of each row. It prefetches the next row's words,
// decodes on the FP32 pipe, takes luma with dp4a, overlays with masks
// classified once per lane (x) and once per row (y), and stores gray as 8
// bytes and BGR as 24. kVec (w % 8 == 0, words 16-byte aligned, outputs
// 8-byte aligned): one 16-byte load per row, and the warp's 768 BGR bytes
// staged in shared memory so that each 8-byte store instruction covers 256
// contiguous bytes; otherwise 16-bit stores of the pixel pairs left of w.
template <bool kVec>
__global__ void __launch_bounds__(kLanes * kWarps)
    decode_interleave_kernel(const uint8_t* __restrict__ src, const int* __restrict__ rects,
                             const uint8_t* __restrict__ colors, int thickness, int overlay,
                             uint8_t* __restrict__ bgr, uint8_t* __restrict__ gray, int h,
                             int w, int aligned4, uint32_t magic) {
  __shared__ uint2 stage[kWarps][3 * kLanes];
  const int y0 = (blockIdx.y * kWarps + threadIdx.y) * kDecRows;
  if (y0 >= h) return;  // the whole warp
  const int y1 = min(y0 + kDecRows, h);
  const int s = blockIdx.z;
  const int lane = threadIdx.x;
  const int xw = blockIdx.x * kDecSpan;
  const int x0 = xw + lane * kDecCols;
  const int wp = w >> 1;
  const size_t plane = static_cast<size_t>(s) * h;
  const uint8_t* in = src + plane * 2 * w;
  uint8_t* bout = bgr + plane * 3 * w;
  uint8_t* gout = gray + plane * w;
  RectRows rect{};
  uint32_t span = 0, band = 0, color = 0;
  if (overlay) {
    rect.init(make_rect(rects + 4 * s, thickness, w, h), w);
    rect.cols<kDecCols>(x0, span, band);
    color = colors[3 * s] | colors[3 * s + 1] << 8 | colors[3 * s + 2] << 16;
  }
  const bool live = x0 < w;
  const int i0 = x0 >> 1;
  uint4 next = live ? decode_load<kVec>(in, y0, i0, wp, aligned4) : uint4{0, 0, 0, 0};
  for (int y = y0; y < y1; ++y) {
    const uint4 cur = next;
    if (live && y + 1 < y1) next = decode_load<kVec>(in, y + 1, i0, wp, aligned4);
    uint32_t p[8];
    decode_word(cur.x, magic, p[0], p[1]);
    decode_word(cur.y, magic, p[2], p[3]);
    decode_word(cur.z, magic, p[4], p[5]);
    decode_word(cur.w, magic, p[6], p[7]);
    uint32_t g[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      g[k] = __byte_perm(__byte_perm(luma256(p[4 * k]), luma256(p[4 * k + 1]), 0x5151),
                         __byte_perm(luma256(p[4 * k + 2]), luma256(p[4 * k + 3]), 0x5151),
                         0x5410);
    }
    const uint32_t mask = rect.row_of(y, span, band);
    if (mask) {
#pragma unroll
      for (int i = 0; i < 8; ++i) p[i] = mask >> i & 1 ? color : p[i];
    }
    // pixels 4k .. 4k+3 as 12 bytes, 3 words
    uint32_t o[6];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      o[3 * k] = __byte_perm(p[4 * k], p[4 * k + 1], 0x4210);
      o[3 * k + 1] = __byte_perm(p[4 * k + 1], p[4 * k + 2], 0x5421);
      o[3 * k + 2] = __byte_perm(p[4 * k + 2], p[4 * k + 3], 0x6542);
    }
    uint8_t* grow = gout + static_cast<size_t>(y) * w + x0;
    if (kVec) {
      if (live) *reinterpret_cast<uint2*>(grow) = make_uint2(g[0], g[1]);
      uint2* st = stage[threadIdx.y];
#pragma unroll
      for (int k = 0; k < 3; ++k) st[3 * lane + k] = make_uint2(o[2 * k], o[2 * k + 1]);
      __syncwarp();
      uint8_t* brow = bout + static_cast<size_t>(y) * 3 * w + 3 * xw;
      const int nb = 3 * min(kDecSpan, w - xw);  // the warp's BGR bytes of the row
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int i = lane + kLanes * k;
        if (8 * i < nb) reinterpret_cast<uint2*>(brow)[i] = st[i];
      }
      __syncwarp();
    } else {  // 16-bit stores: x0 is even, and so are w and 3w
      uint16_t* g16 = reinterpret_cast<uint16_t*>(grow);
      uint16_t* b16 = reinterpret_cast<uint16_t*>(bout + static_cast<size_t>(y) * 3 * w + 3 * x0);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (x0 + 2 * k < w) {
          g16[k] = static_cast<uint16_t>(g[k / 2] >> (16 * (k % 2)));
#pragma unroll
          for (int m = 3 * k; m < 3 * k + 3; ++m) {
            b16[m] = static_cast<uint16_t>(o[m / 2] >> (16 * (m % 2)));
          }
        }
      }
    }
  }
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
  uint32_t color;       // bytes (b, g, r, 0)
  uint32_t span, band;  // rect.cols of pixels x0 .. x0+3

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
      const uint32_t mask = rect.row_of(yc, span, band);
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
                       overlay != 0, {}, 0, 0, 0};
  if (overlay) {
    src.rect.init(make_rect(rects + 4 * s, thickness, w, h), w);
    src.rect.template cols<4>(x0, src.span, src.band);
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
  const auto at = [](const void* p, int a) { return reinterpret_cast<uintptr_t>(p) % a == 0; };
  const bool vec = w % 8 == 0 && at(src, 16) && at(bgr, 8) && at(gray, 8);
  const int strips = (h + rcv::kDecRows - 1) / rcv::kDecRows;
  const dim3 grid((w + rcv::kDecSpan - 1) / rcv::kDecSpan, (strips + rcv::kWarps - 1) / rcv::kWarps,
                  n);
  const dim3 block(rcv::kLanes, rcv::kWarps);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const uint8_t*>(src);
  const auto* r = static_cast<const int*>(rects);
  const auto* c = static_cast<const uint8_t*>(colors);
  auto* b = static_cast<uint8_t*>(bgr);
  auto* g = static_cast<uint8_t*>(gray);
  if (vec) {
    rcv::decode_interleave_kernel<true><<<grid, block, 0, st>>>(in, r, c, thickness, overlay, b, g,
                                                                h, w, 1, rcv::kMagicBits);
  } else {
    rcv::decode_interleave_kernel<false><<<grid, block, 0, st>>>(in, r, c, thickness, overlay, b,
                                                                 g, h, w, at(src, 4),
                                                                 rcv::kMagicBits);
  }
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
