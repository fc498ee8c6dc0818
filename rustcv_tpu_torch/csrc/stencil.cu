// K1: fused 5×5 Gaussian + 3×3 Sobel + exact |∇| on u8 gray [N, H, W].
//
// Replaces the Pallas kernels rustcv_tpu/ops/pallas/stencil_v3.py
// (blur_sobel_mag_pallas_v3), stencil.py (v1) and stencil_v2.py (v2), which
// compute the same function.
//
// Bound: bytes. The filter reads 1 B and writes 1 B per pixel (about 33 MB
// for a tick of 8 × 1920×1080); the plain PyTorch chain instead writes and
// re-reads int32 intermediates between its passes. Its arithmetic (about
// 30 instructions per pixel, most on the half-rate integer pipe) and the
// latency it must hide are the nearer limits in practice, so the design
// spends few instructions per pixel: the row march of stencil.cuh at 8
// columns per lane, two word loads and two word stores per 8 pixels and
// row, 16-bit lanes for the blur, neighbours by warp shuffles, the
// magnitude on the FP32 pipe, no shared memory and no barrier.
// Any H and W: where W % 4 != 0 or a plane does not start on a 4-byte
// boundary, the second form of the kernel reads and writes bytes.
//
// C interface for ctypes: each launcher returns cudaGetLastError().

#include "stencil.cuh"

namespace rcv {

constexpr int kGrayCols = 8;  // columns per lane
// Blocks per SM the register budget must allow: 5 caps a thread at 96
// registers (20 warps per SM). On the H100 this ran faster than the
// 112-register build at 4 blocks, though ptxas spills a few bytes for it.
constexpr int kGrayMinBlocks = 5;

// Gray words of a [h, w] u8 plane for one lane at columns x0 .. x0+7,
// clamped. kWords: w % 4 == 0 and the plane 4-byte aligned, so the lane
// loads each aligned word at clamp(x, 0, w-4) and, off the image's edges,
// repeats its edge byte (PRMT selectors fixed for the march); otherwise it
// loads bytes at clamped columns.
template <bool kWords>
struct GrayRows {
  static constexpr int kCols = kGrayCols;
  const uint8_t* __restrict__ plane;
  int w, x0;
  uint32_t sel[kCols / 4];

  __device__ __forceinline__ GrayRows(const uint8_t* p, int w_, int x0_)
      : plane(p), w(w_), x0(x0_) {
#pragma unroll
    for (int i = 0; i < kCols / 4; ++i) {
      const int x = x0_ + 4 * i;
      sel[i] = x < 0 ? 0x0000 : x >= w_ ? 0x3333 : 0x3210;
    }
  }
  __device__ __forceinline__ GrayWords<kCols> load(int yc) const {
    const uint8_t* row = plane + static_cast<size_t>(yc) * w;
    GrayWords<kCols> v;
#pragma unroll
    for (int i = 0; i < kCols / 4; ++i) {
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
  __device__ __forceinline__ GrayWords<kCols> gray(GrayWords<kCols> raw, int, bool) const {
    if (kWords) {
#pragma unroll
      for (int i = 0; i < kCols / 4; ++i) raw.v[i] = __byte_perm(raw.v[i], 0, sel[i]);
    }
    return raw;
  }
};

template <bool kWords>
__global__ void __launch_bounds__(kLanes * kWarps, kGrayMinBlocks)
    blur_sobel_kernel(const uint8_t* __restrict__ gray, uint8_t* __restrict__ out,
                      int h, int w, int rows, uint32_t magic) {
  int y0, y1, x0;
  bool owner;
  if (!warp_strip(kGrayCols, h, rows, y0, y1, x0, owner)) return;  // the whole warp
  const size_t plane = static_cast<size_t>(blockIdx.z) * h * w;
  blur_sobel_strip<kWords>(GrayRows<kWords>(gray + plane, w, x0), out + plane, h, w, x0, y0, y1,
                           owner, magic);
}

}  // namespace rcv

extern "C" int rcv_blur_sobel_mag(const void* gray, void* out, int n, int h,
                                  int w, void* stream) {
  const bool words = w % 4 == 0 && reinterpret_cast<uintptr_t>(gray) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 4 == 0;
  const dim3 block(rcv::kLanes, rcv::kWarps);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const uint8_t*>(gray);
  auto* o = static_cast<uint8_t*>(out);
  static int resident[2] = {};  // per form, read from the card at first use
  if (words) {
    const int rows = rcv::strip_rows(rcv::blur_sobel_kernel<true>, resident[1], rcv::kGrayCols,
                                     n, h, w);
    rcv::blur_sobel_kernel<true><<<rcv::strip_grid(rcv::kGrayCols, n, h, w, rows), block, 0,
                                   st>>>(in, o, h, w, rows, rcv::kMagicBits);
  } else {
    const int rows = rcv::strip_rows(rcv::blur_sobel_kernel<false>, resident[0], rcv::kGrayCols,
                                     n, h, w);
    rcv::blur_sobel_kernel<false><<<rcv::strip_grid(rcv::kGrayCols, n, h, w, rows), block, 0,
                                    st>>>(in, o, h, w, rows, rcv::kMagicBits);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rcv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
