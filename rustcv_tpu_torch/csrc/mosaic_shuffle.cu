// K7: the lane-shuffle cases of the Mosaic probe, one small kernel per case.
//
// Replaces the Pallas kernels of probe_mosaic_shuffle.py: the bodies of its
// CASES (:17-156), each run through pl.pallas_call (:166). On the TPU they
// asked which in-register lane shuffles Mosaic would compile (strided lane
// loads and stores, //3 gathers, a mod-3 select, a u32 → u8 sublane
// bitcast, a lane roll, truncating casts, an element repeat, the stride-3
// interleave, a u16 pack). On Hopper none of that is a question: a thread
// reads any address, so each case is one thread per output element that
// computes its source index. The arrays are a few KB, so a launch is bound
// by its latency, not by bytes or operations.
//
// The outputs are what each case's numpy `ref` computes (the kernels are
// checked against it and against the plain PyTorch versions in
// rustcv_tpu_torch/ops/kernels/mosaic_shuffle.py):
//   sublane_bitcast  out[s, l] = byte s % 4 of word x[s / 4, l] (little-endian);
//   repeat_lanes     np.repeat, element-repeat: out[r, j] = x[r, j / 3].
//
// C interface for ctypes: the launcher returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace rcv {
namespace {

constexpr int kThreads = 256;
constexpr int kSliceStart = 42;  // unaligned_slice: x[:, 42:170]

// Case ids: the order of probe_mosaic_shuffle.CASES, as the Python wrapper
// numbers them.
enum Case : int {
  kStridedLoad = 0,
  kStridedStore,
  kLaneGather,
  kU8Select,
  kSublaneBitcast,
  kLaneRoll,
  kU8Astype,
  kGather128,
  kUnalignedSlice,
  kU16Astype,
  kRepeatLanes,
  kInterleave3Vreg,
  kU16Ops,
};

// Every kernel: output element i of a row-major [out_rows, out_cols] array,
// inputs [rows, in_cols] row-major.
struct Shape {
  int in_cols, out_cols, total;
};

__device__ __forceinline__ int element() {
  return blockIdx.x * blockDim.x + threadIdx.x;
}

// out[r, j] = x[r, 2j]
__global__ void strided_load(const int32_t* __restrict__ x, int32_t* __restrict__ out, Shape s) {
  const int i = element();
  if (i >= s.total) return;
  const int r = i / s.out_cols, j = i - r * s.out_cols;
  out[i] = x[r * s.in_cols + 2 * j];
}

// out[r, 3m + p] = x[r, m] + p
__global__ void strided_store(const int32_t* __restrict__ x, int32_t* __restrict__ out, Shape s) {
  const int i = element();
  if (i >= s.total) return;
  const int r = i / s.out_cols, j = i - r * s.out_cols;
  out[i] = x[r * s.in_cols + j / 3] + j % 3;
}

// out[r, j] = x[r, j / 3]: lane_gather, gather_128 and repeat_lanes
// (np.repeat's element repeat) differ only in the output width.
__global__ void gather_div3(const int32_t* __restrict__ x, int32_t* __restrict__ out, Shape s) {
  const int i = element();
  if (i >= s.total) return;
  const int r = i / s.out_cols, j = i - r * s.out_cols;
  out[i] = x[r * s.in_cols + j / 3];
}

// out[r, j] = j % 3 == 0 ? x[r, j] : y[r, j]
__global__ void u8_select(const uint8_t* __restrict__ x, const uint8_t* __restrict__ y,
                          uint8_t* __restrict__ out, Shape s) {
  const int i = element();
  if (i >= s.total) return;
  const int j = i % s.out_cols;
  out[i] = j % 3 == 0 ? x[i] : y[i];
}

// out[s, l] = byte s % 4 of the u32 word x[s / 4, l], little-endian
__global__ void sublane_bitcast(const uint32_t* __restrict__ x, uint8_t* __restrict__ out,
                                Shape s) {
  const int i = element();
  if (i >= s.total) return;
  const int row = i / s.out_cols, l = i - row * s.out_cols;
  out[i] = static_cast<uint8_t>(x[(row >> 2) * s.in_cols + l] >> (8 * (row & 3)));
}

// np.roll(x, 1, axis=1): out[r, j] = x[r, (j - 1) mod cols]
__global__ void lane_roll(const int32_t* __restrict__ x, int32_t* __restrict__ out, Shape s) {
  const int i = element();
  if (i >= s.total) return;
  const int r = i / s.out_cols, j = i - r * s.out_cols;
  out[i] = x[r * s.in_cols + (j == 0 ? s.in_cols - 1 : j - 1)];
}

// (x & 255) as u8
__global__ void u8_astype(const int32_t* __restrict__ x, uint8_t* __restrict__ out, Shape s) {
  const int i = element();
  if (i >= s.total) return;
  out[i] = static_cast<uint8_t>(x[i] & 255);
}

// out[r, j] = x[r, j + 42]
__global__ void unaligned_slice(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                                Shape s) {
  const int i = element();
  if (i >= s.total) return;
  const int r = i / s.out_cols, j = i - r * s.out_cols;
  out[i] = x[r * s.in_cols + kSliceStart + j];
}

// (x & 0xFFFF) as u16
__global__ void u16_astype(const int32_t* __restrict__ x, uint16_t* __restrict__ out, Shape s) {
  const int i = element();
  if (i >= s.total) return;
  out[i] = static_cast<uint16_t>(x[i] & 0xFFFF);
}

// out[r, 3m + p] = w_p[r, m] & 0xFFFF as u16: the stride-3 interleave
__global__ void interleave3(const int32_t* __restrict__ w0, const int32_t* __restrict__ w1,
                            const int32_t* __restrict__ w2, uint16_t* __restrict__ out,
                            Shape s) {
  const int i = element();
  if (i >= s.total) return;
  const int r = i / s.out_cols, j = i - r * s.out_cols;
  const int p = j % 3;
  const int32_t* w = p == 0 ? w0 : (p == 1 ? w1 : w2);
  out[i] = static_cast<uint16_t>(w[r * s.in_cols + j / 3] & 0xFFFF);
}

// w = (x & 255) as u16; w | (w << 8)
__global__ void u16_ops(const int32_t* __restrict__ x, uint16_t* __restrict__ out, Shape s) {
  const int i = element();
  if (i >= s.total) return;
  const uint16_t w = static_cast<uint16_t>(x[i] & 255);
  out[i] = static_cast<uint16_t>(w | (w << 8));
}

}  // namespace
}  // namespace rcv

// One launch of case `which` on inputs a (and b, c where the case takes
// them), each row-major with in_cols columns, into out [out_rows, out_cols].
// Returns cudaErrorInvalidValue for an unknown case.
extern "C" int rcv_mosaic_shuffle(int which, const void* a, const void* b, const void* c,
                                  void* out, int in_cols, int out_rows, int out_cols,
                                  void* stream) {
  using namespace rcv;
  const Shape s{in_cols, out_cols, out_rows * out_cols};
  const dim3 grid((s.total + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* i32 = static_cast<const int32_t*>(a);
  auto* o32 = static_cast<int32_t*>(out);
  auto* o16 = static_cast<uint16_t*>(out);
  auto* o8 = static_cast<uint8_t*>(out);
  switch (which) {
    case kStridedLoad:
      strided_load<<<grid, kThreads, 0, st>>>(i32, o32, s);
      break;
    case kStridedStore:
      strided_store<<<grid, kThreads, 0, st>>>(i32, o32, s);
      break;
    case kLaneGather:
    case kGather128:
    case kRepeatLanes:
      gather_div3<<<grid, kThreads, 0, st>>>(i32, o32, s);
      break;
    case kU8Select:
      u8_select<<<grid, kThreads, 0, st>>>(static_cast<const uint8_t*>(a),
                                           static_cast<const uint8_t*>(b), o8, s);
      break;
    case kSublaneBitcast:
      sublane_bitcast<<<grid, kThreads, 0, st>>>(static_cast<const uint32_t*>(a), o8, s);
      break;
    case kLaneRoll:
      lane_roll<<<grid, kThreads, 0, st>>>(i32, o32, s);
      break;
    case kU8Astype:
      u8_astype<<<grid, kThreads, 0, st>>>(i32, o8, s);
      break;
    case kUnalignedSlice:
      unaligned_slice<<<grid, kThreads, 0, st>>>(i32, o32, s);
      break;
    case kU16Astype:
      u16_astype<<<grid, kThreads, 0, st>>>(i32, o16, s);
      break;
    case kInterleave3Vreg:
      interleave3<<<grid, kThreads, 0, st>>>(i32, static_cast<const int32_t*>(b),
                                             static_cast<const int32_t*>(c), o16, s);
      break;
    case kU16Ops:
      u16_ops<<<grid, kThreads, 0, st>>>(i32, o16, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
