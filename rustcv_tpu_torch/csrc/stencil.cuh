// Blur + Sobel |∇| on one output tile, from a gray tile in shared memory.
//
// Shared by stencil.cu (the gray tile is read from a gray image) and
// yuyv_tick.cu (the gray tile is decoded from YUYV words in the block), so
// the two kernels compute the filter with the same code.
//
// Math (bit-exact with rustcv_tpu.ops.filters' frozen chain):
//   blur(y, x) = (Σ g5[dy]·g5[dx]·gray[clamp(y+dy)][clamp(x+dx)] + 128) >> 8
//                for a centre (y, x) inside the image, g5 = (1, 4, 6, 4, 1);
//   Sobel reads blur at clamp(y±1), clamp(x±1): the two-stage border rule
//   (the Gaussian replicates the original image, the Sobel the blurred one);
//   out = min(255, floor(sqrt(gx² + gy²))), exact.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rcv {

constexpr int kTileW = 64;    // output columns per block
constexpr int kTileH = 32;    // output rows per block
constexpr int kThreads = 256; // threads per stencil block
constexpr int kHalo = 3;      // Gaussian radius 2 + Sobel radius 1
constexpr int kGrayH = kTileH + 2 * kHalo;
constexpr int kGrayW = kTileW + 2 * kHalo;
constexpr int kBlurH = kTileH + 2;
constexpr int kBlurW = kTileW + 2;

struct StencilSmem {
  // gray[r][c] = gray[clamp(ty0 - 3 + r)][clamp(tx0 - 3 + c)]
  uint8_t gray[kGrayH][kGrayW];
  // horizontal Gaussian sums of each gray row at the blur columns
  int hsum[kGrayH][kBlurW];
  // blur[r][c] = blur at centre (clamp(ty0 - 1 + r), clamp(tx0 - 1 + c))
  int blur[kBlurH][kBlurW];
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// floor(sqrt(x)) for 0 <= x < 2^24: the float is exact, the rounded sqrt
// is within one of the floor, and the two fix-ups make it exact.
__device__ __forceinline__ int isqrt_floor(int x) {
  int s = static_cast<int>(__fsqrt_rn(static_cast<float>(x)));
  if ((s + 1) * (s + 1) <= x) s += 1;
  if (s * s > x) s -= 1;
  return s;
}

// Needs sm.gray filled and a __syncthreads() after the fill. Writes the
// tile's in-image outputs into out, the [h, w] plane of this image.
__device__ __forceinline__ void stencil_tile(StencilSmem& sm,
                                             uint8_t* __restrict__ out,
                                             int ty0, int tx0, int h, int w) {
  // 1. Horizontal taps at each blur column's clamped centre. The centre's
  //    gray column is sc; its taps sc-2..sc+2 stay inside the tile.
  for (int i = threadIdx.x; i < kGrayH * kBlurW; i += kThreads) {
    const int r = i / kBlurW;
    const int c = i - r * kBlurW;
    const int sc = clampi(tx0 - 1 + c, 0, w - 1) - (tx0 - kHalo);
    const uint8_t* g = &sm.gray[r][sc - 2];
    sm.hsum[r][c] = g[0] + 4 * g[1] + 6 * g[2] + 4 * g[3] + g[4];
  }
  __syncthreads();
  // 2. Vertical taps at each blur row's clamped centre, then the rounding.
  for (int i = threadIdx.x; i < kBlurH * kBlurW; i += kThreads) {
    const int r = i / kBlurW;
    const int c = i - r * kBlurW;
    const int sr = clampi(ty0 - 1 + r, 0, h - 1) - (ty0 - kHalo);
    const int acc = sm.hsum[sr - 2][c] + 4 * sm.hsum[sr - 1][c] +
                    6 * sm.hsum[sr][c] + 4 * sm.hsum[sr + 1][c] +
                    sm.hsum[sr + 2][c];
    sm.blur[r][c] = (acc + 128) >> 8;
  }
  __syncthreads();
  // 3. Sobel on the blurred tile: blur rows r, r+1, r+2 hold image rows
  //    clamp(y-1), y, clamp(y+1); columns likewise.
  for (int i = threadIdx.x; i < kTileH * kTileW; i += kThreads) {
    const int r = i / kTileW;
    const int c = i - r * kTileW;
    const int y = ty0 + r;
    const int x = tx0 + c;
    if (y >= h || x >= w) continue;
    const auto& b = sm.blur;
    const int smooth_l = b[r][c] + 2 * b[r + 1][c] + b[r + 2][c];
    const int smooth_r = b[r][c + 2] + 2 * b[r + 1][c + 2] + b[r + 2][c + 2];
    const int diff_l = b[r + 2][c] - b[r][c];
    const int diff_m = b[r + 2][c + 1] - b[r][c + 1];
    const int diff_r = b[r + 2][c + 2] - b[r][c + 2];
    const int gx = smooth_r - smooth_l;
    const int gy = diff_l + 2 * diff_m + diff_r;
    out[static_cast<size_t>(y) * w + x] =
        static_cast<uint8_t>(min(isqrt_floor(gx * gx + gy * gy), 255));
  }
}

}  // namespace rcv
