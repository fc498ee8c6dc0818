// K4 and K5: the YUYV tick kernels.
//
// K4 yuyv_decode_interleave replaces rustcv_tpu/ops/pallas/decode_interleave.py
// (yuyv_decode_interleave): YUYV words → BT.601 pair values → gray (taken
// before the overlay) and, with the rectangle overlay applied to the pair's
// two pixels, packed BGR rows.
//
// K5 yuyv_tick_fused replaces rustcv_tpu/ops/pallas/tick_fused.py
// (yuyv_tick_fused): K4's decode, overlay and BGR store, plus K1's blur +
// Sobel |∇| on the gray, which never reaches device memory: each block
// decodes the gray of its tile ±3 rows and columns straight from the wire
// words into shared memory and runs the stencil of stencil.cuh on it.
//
// Bound: bytes. Per pixel K4 reads 2 B and writes 4 B (3 BGR + 1 gray);
// K5 reads 2 B and writes 4 B (3 BGR + 1 filtered), where the unfused path
// also writes and re-reads the gray plane. Design: one thread per YUYV
// word (pixel pair) for K4, storing its 6 BGR bytes as three 16-bit words;
// one block per (64×32 tile, image) for K5. Any even W and any H.
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

// Gray of the even (odd = 0) or odd (odd = 1) pixel of a word.
__device__ __forceinline__ int gray_of(uint32_t wd, int odd) {
  const Pair p = decode_pair(wd);
  return odd ? luma(p.b1, p.g1, p.r1) : luma(p.b0, p.g0, p.r0);
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

__global__ void __launch_bounds__(kThreads)
    tick_fused_kernel(const uint32_t* __restrict__ words,
                      const int* __restrict__ rects,
                      const uint8_t* __restrict__ colors, int thickness,
                      int overlay, uint8_t* __restrict__ bgr,
                      uint8_t* __restrict__ filt, int h, int w) {
  __shared__ StencilSmem sm;
  const int p = w >> 1;
  const int tx0 = blockIdx.x * kTileW;
  const int ty0 = blockIdx.y * kTileH;
  const int s = blockIdx.z;
  const uint32_t* wd = words + static_cast<size_t>(s) * h * p;
  // Gray of the tile ±3 at clamped coordinates, decoded from the words.
  for (int i = threadIdx.x; i < kGrayH * kGrayW; i += kThreads) {
    const int r = i / kGrayW;
    const int c = i - r * kGrayW;
    const int yy = clampi(ty0 - kHalo + r, 0, h - 1);
    const int xx = clampi(tx0 - kHalo + c, 0, w - 1);
    sm.gray[r][c] = static_cast<uint8_t>(
        gray_of(wd[static_cast<size_t>(yy) * p + (xx >> 1)], xx & 1));
  }
  __syncthreads();
  stencil_tile(sm, filt + static_cast<size_t>(s) * h * w, ty0, tx0, h, w);

  // Packed BGR of the tile's own pixel pairs (tx0 is even).
  RectMask m{};
  if (overlay) m = make_rect(rects + 4 * s, thickness, w, h);
  constexpr int kPairsW = kTileW / 2;
  for (int i = threadIdx.x; i < kTileH * kPairsW; i += kThreads) {
    const int r = i / kPairsW;
    const int y = ty0 + r;
    const int pi = (tx0 >> 1) + (i - r * kPairsW);
    if (y >= h || pi >= p) continue;
    const Pair px = decode_pair(wd[static_cast<size_t>(y) * p + pi]);
    store_pair(px, bgr + (static_cast<size_t>(s) * h + y) * 3 * w, pi, y,
               overlay, m, colors + 3 * s);
  }
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
  const dim3 grid((w + rcv::kTileW - 1) / rcv::kTileW,
                  (h + rcv::kTileH - 1) / rcv::kTileH, n);
  rcv::tick_fused_kernel<<<grid, rcv::kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(src), static_cast<const int*>(rects),
      static_cast<const uint8_t*>(colors), thickness, overlay,
      static_cast<uint8_t*>(bgr), static_cast<uint8_t*>(filt), h, w);
  return static_cast<int>(cudaGetLastError());
}
