// K1: fused 5×5 Gaussian + 3×3 Sobel + exact |∇| on u8 gray [N, H, W].
//
// Replaces the Pallas kernels rustcv_tpu/ops/pallas/stencil_v3.py
// (blur_sobel_mag_pallas_v3), stencil.py (v1) and stencil_v2.py (v2), which
// compute the same function.
//
// Bound: bytes. The filter reads 1 B and writes 1 B per pixel (about 33 MB
// for a tick of 8 × 1920×1080); the plain PyTorch chain instead writes and
// re-reads int32 intermediates between its passes. Design: one block per
// (64×32 output tile, image); the block reads its gray tile with a ±3 halo
// once into shared memory at clamped coordinates, keeps the blurred tile
// (±1) in shared memory, and writes only the magnitude. Any H and W.
//
// C interface for ctypes: each launcher returns cudaGetLastError().

#include "stencil.cuh"

namespace rcv {

__global__ void __launch_bounds__(kThreads)
    blur_sobel_kernel(const uint8_t* __restrict__ gray,
                      uint8_t* __restrict__ out, int h, int w) {
  __shared__ StencilSmem sm;
  const int tx0 = blockIdx.x * kTileW;
  const int ty0 = blockIdx.y * kTileH;
  const size_t plane = static_cast<size_t>(blockIdx.z) * h * w;
  const uint8_t* g = gray + plane;
  for (int i = threadIdx.x; i < kGrayH * kGrayW; i += kThreads) {
    const int r = i / kGrayW;
    const int c = i - r * kGrayW;
    const int yy = clampi(ty0 - kHalo + r, 0, h - 1);
    const int xx = clampi(tx0 - kHalo + c, 0, w - 1);
    sm.gray[r][c] = g[static_cast<size_t>(yy) * w + xx];
  }
  __syncthreads();
  stencil_tile(sm, out + plane, ty0, tx0, h, w);
}

}  // namespace rcv

extern "C" int rcv_blur_sobel_mag(const void* gray, void* out, int n, int h,
                                  int w, void* stream) {
  const dim3 grid((w + rcv::kTileW - 1) / rcv::kTileW,
                  (h + rcv::kTileH - 1) / rcv::kTileH, n);
  rcv::blur_sobel_kernel<<<grid, rcv::kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(gray), static_cast<uint8_t*>(out), h, w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rcv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
