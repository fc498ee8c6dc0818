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

template <bool kWords>
__global__ void __launch_bounds__(kLanes * kWarps, kGrayMinBlocks)
    blur_sobel_kernel(const uint8_t* __restrict__ gray, uint8_t* __restrict__ out,
                      int h, int w, int rows, uint32_t magic) {
  int y0, y1, x0;
  bool owner;
  if (!warp_strip(kGrayCols, h, rows, y0, y1, x0, owner)) return;  // the whole warp
  const size_t plane = static_cast<size_t>(blockIdx.z) * h * w;
  blur_sobel_strip<kWords>(GrayRows<kWords, kGrayCols>(gray + plane, w, x0), out + plane, h, w,
                           x0, y0, y1, owner, magic);
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
