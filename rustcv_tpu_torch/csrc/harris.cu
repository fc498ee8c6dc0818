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
//   int32:   s5 = ((Σ + 128) >> 8) >> 5 (arithmetic shifts),
//            R = det − k_num·((((sxx5 + syy5) >> 1)²) >> 8).
//
// Bound: bytes. The response reads 1 B and writes 4 B per pixel; the plain
// chain writes and re-reads int32 / float32 planes between ~20 passes.
// Design: one block per (32×32 output tile, image). The block reads its
// gray tile with a ±3 halo once, at clamped coordinates, into shared
// memory; computes the Sobel and the three products at the CLAMPED centres
// of the tile ±2 (so the window's replicate border falls out of the
// indexing, for any H and W and a partial last tile); keeps the product
// planes and the horizontal sums in shared memory; writes only R.
//
// C interface for ctypes: each launcher returns cudaGetLastError().

#include "stencil.cuh"

namespace rcv {

constexpr int kHarrisTile = 32;     // output rows and columns per block
constexpr int kHarrisThreads = 256;
constexpr int kHarrisHalo = 3;      // Sobel radius 1 + window radius 2
constexpr int kHarrisGray = kHarrisTile + 2 * kHarrisHalo;  // gray tile side
constexpr int kHarrisProd = kHarrisTile + 4;                // product tile side

template <typename T>
struct HarrisSmem {
  // gray[r][c] = gray[clamp(ty0 - 3 + r)][clamp(tx0 - 3 + c)]
  uint8_t gray[kHarrisGray][kHarrisGray];
  // prod[q][r][c] = product q (xx, yy, xy) at centre
  //                 (clamp(ty0 - 2 + r), clamp(tx0 - 2 + c))
  T prod[3][kHarrisProd][kHarrisProd];
  // hsum[q][r][c] = horizontal window sum of prod[q][r] at output column c
  T hsum[3][kHarrisProd][kHarrisTile];
};

// float32 form (K6). One IEEE rounding per operation, in the plain
// version's order; the _rn intrinsics keep nvcc from contracting a
// multiply and an add into an FMA.
struct HarrisF32 {
  using T = float;
  float k;

  __device__ __forceinline__ void products(int gx, int gy, float& xx, float& yy,
                                           float& xy) const {
    const float norm = static_cast<float>(1.0 / (255.0 * 4.0));
    const float fx = __fmul_rn(static_cast<float>(gx), norm);
    const float fy = __fmul_rn(static_cast<float>(gy), norm);
    xx = __fmul_rn(fx, fx);
    yy = __fmul_rn(fy, fy);
    xy = __fmul_rn(fx, fy);
  }
  // Σ w_i·p[i·stride], w = (1, 4, 6, 4, 1)/16 (exact in float32).
  __device__ __forceinline__ float taps(const float* p, int stride) const {
    float acc = __fmul_rn(0.0625f, p[0]);
    acc = __fadd_rn(acc, __fmul_rn(0.25f, p[stride]));
    acc = __fadd_rn(acc, __fmul_rn(0.375f, p[2 * stride]));
    acc = __fadd_rn(acc, __fmul_rn(0.25f, p[3 * stride]));
    return __fadd_rn(acc, __fmul_rn(0.0625f, p[4 * stride]));
  }
  __device__ __forceinline__ float window(float acc) const { return acc; }
  __device__ __forceinline__ float response(float sxx, float syy, float sxy) const {
    const float det = __fsub_rn(__fmul_rn(sxx, syy), __fmul_rn(sxy, sxy));
    const float tr = __fadd_rn(sxx, syy);
    return __fsub_rn(det, __fmul_rn(__fmul_rn(k, tr), tr));
  }
};

// int32 form. |product| <= 1,040,400, a window sum <= 256 times that, and
// after >> 5 every product below fits int32 (golden.harris_response_i32).
// Only k_num·(...) may exceed it for a large k_num: that step wraps in
// unsigned arithmetic, as int32 tensors do.
struct HarrisI32 {
  using T = int;
  int k_num;

  __device__ __forceinline__ void products(int gx, int gy, int& xx, int& yy,
                                           int& xy) const {
    xx = gx * gx;
    yy = gy * gy;
    xy = gx * gy;
  }
  __device__ __forceinline__ int taps(const int* p, int stride) const {
    return p[0] + 4 * p[stride] + 6 * p[2 * stride] + 4 * p[3 * stride] +
           p[4 * stride];
  }
  __device__ __forceinline__ int window(int acc) const {
    return ((acc + 128) >> 8) >> 5;
  }
  __device__ __forceinline__ int response(int sxx5, int syy5, int sxy5) const {
    const int det = sxx5 * syy5 - sxy5 * sxy5;
    const int trh = (sxx5 + syy5) >> 1;
    const unsigned penalty =
        static_cast<unsigned>(k_num) * static_cast<unsigned>((trh * trh) >> 8);
    return static_cast<int>(static_cast<unsigned>(det) - penalty);
  }
};

template <typename P>
__global__ void __launch_bounds__(kHarrisThreads)
    harris_kernel(const uint8_t* __restrict__ gray,
                  typename P::T* __restrict__ out, int h, int w, P pol) {
  using T = typename P::T;
  __shared__ HarrisSmem<T> sm;
  const int tx0 = blockIdx.x * kHarrisTile;
  const int ty0 = blockIdx.y * kHarrisTile;
  const size_t plane = static_cast<size_t>(blockIdx.z) * h * w;
  const uint8_t* g = gray + plane;

  // 1. The gray tile ±3 at clamped coordinates.
  for (int i = threadIdx.x; i < kHarrisGray * kHarrisGray; i += kHarrisThreads) {
    const int r = i / kHarrisGray;
    const int c = i - r * kHarrisGray;
    const int yy = clampi(ty0 - kHarrisHalo + r, 0, h - 1);
    const int xx = clampi(tx0 - kHarrisHalo + c, 0, w - 1);
    sm.gray[r][c] = g[static_cast<size_t>(yy) * w + xx];
  }
  __syncthreads();

  // 2. Sobel and products at the clamped centres of the tile ±2. The
  //    centre's gray row sr and column sc lie in [1, kHarrisGray - 2], and
  //    gray rows sr±1 hold image rows clamp(centre ± 1).
  for (int i = threadIdx.x; i < kHarrisProd * kHarrisProd; i += kHarrisThreads) {
    const int r = i / kHarrisProd;
    const int c = i - r * kHarrisProd;
    const int sr = clampi(ty0 - 2 + r, 0, h - 1) - (ty0 - kHarrisHalo);
    const int sc = clampi(tx0 - 2 + c, 0, w - 1) - (tx0 - kHarrisHalo);
    const uint8_t* top = sm.gray[sr - 1];
    const uint8_t* mid = sm.gray[sr];
    const uint8_t* bot = sm.gray[sr + 1];
    const int smooth_l = top[sc - 1] + 2 * mid[sc - 1] + bot[sc - 1];
    const int smooth_r = top[sc + 1] + 2 * mid[sc + 1] + bot[sc + 1];
    const int gx = smooth_r - smooth_l;
    const int gy = (bot[sc - 1] - top[sc - 1]) + 2 * (bot[sc] - top[sc]) +
                   (bot[sc + 1] - top[sc + 1]);
    pol.products(gx, gy, sm.prod[0][r][c], sm.prod[1][r][c], sm.prod[2][r][c]);
  }
  __syncthreads();

  // 3. Horizontal window taps: output column c reads product columns c..c+4,
  //    which hold image columns clamp(x - 2) .. clamp(x + 2).
  for (int i = threadIdx.x; i < 3 * kHarrisProd * kHarrisTile; i += kHarrisThreads) {
    const int q = i / (kHarrisProd * kHarrisTile);
    const int rest = i - q * (kHarrisProd * kHarrisTile);
    const int r = rest / kHarrisTile;
    const int c = rest - r * kHarrisTile;
    sm.hsum[q][r][c] = pol.taps(&sm.prod[q][r][c], 1);
  }
  __syncthreads();

  // 4. Vertical taps (rows r..r+4), then the response.
  T* o = out + plane;
  for (int i = threadIdx.x; i < kHarrisTile * kHarrisTile; i += kHarrisThreads) {
    const int r = i / kHarrisTile;
    const int c = i - r * kHarrisTile;
    const int y = ty0 + r;
    const int x = tx0 + c;
    if (y >= h || x >= w) continue;
    const T sxx = pol.window(pol.taps(&sm.hsum[0][r][c], kHarrisTile));
    const T syy = pol.window(pol.taps(&sm.hsum[1][r][c], kHarrisTile));
    const T sxy = pol.window(pol.taps(&sm.hsum[2][r][c], kHarrisTile));
    o[static_cast<size_t>(y) * w + x] = pol.response(sxx, syy, sxy);
  }
}

template <typename P>
int launch_harris(const void* gray, void* out, int n, int h, int w, P pol,
                  void* stream) {
  const dim3 grid((w + kHarrisTile - 1) / kHarrisTile,
                  (h + kHarrisTile - 1) / kHarrisTile, n);
  harris_kernel<P><<<grid, kHarrisThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(gray), static_cast<typename P::T*>(out), h, w, pol);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rcv

extern "C" int rcv_harris_response_f32(const void* gray, void* out, int n, int h,
                                       int w, float k, void* stream) {
  return rcv::launch_harris(gray, out, n, h, w, rcv::HarrisF32{k}, stream);
}

extern "C" int rcv_harris_response_i32(const void* gray, void* out, int n, int h,
                                       int w, int k_num, void* stream) {
  return rcv::launch_harris(gray, out, n, h, w, rcv::HarrisI32{k_num}, stream);
}
