// q8vadd: quantized elementwise add of two uint8 tensors of one shape.
//
// Replaces the TPU kernel qnnpack_tpu/kernels/vpu_ops.py:q8vadd_pallas (the
// add_quantize contract, qnnpack_tpu/quant/requantize.py:158-175):
//
//   acc = zero_point_product + a * a_multiplier + b * b_multiplier  (int32)
//   acc = (acc >> shift) + (remainder > threshold)
//   y   = clamp(acc + y_zero_point, y_min, y_max)
//
// with remainder = (acc & mask) - (acc < 0), mask = 2^shift - 1 and
// threshold = mask >> 1.  The sum is taken in uint32, whose low 32 bits are
// those of the reference's wrapping int32 arithmetic.  The rounding is the
// same test without a compare: remainder > threshold holds exactly when
// d = (acc & mask) + (acc >> 31) - 2^(shift - 1) is not negative, so the
// increment is 1 + (d >> 31), and the 1 joins the zero point.  No term can
// overflow for 1 <= shift <= 31.
//
// What bounds it: 3 bytes moved per element (2 read, 1 written), against
// about 12 integer operations (2 byte extractions, 2 multiply-adds, 6 for
// the rounding shift, 2 for the clamp, and a share of the packing).  At
// the card's 3.35 TB/s and its int32 rate the two come out close, so the
// design keeps the memory side at full width and the arithmetic in 32 bits:
// a grid-stride loop over 16-byte vectors of a, b and y, one a thread and
// step (uint4 loads and stores), 16 bytes computed from the words with
// __byte_perm; the bytes past the last whole vector, or every byte when a
// pointer is off a 16-byte boundary, go one at a time.
#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;

struct AddArgs {
  uint32_t zero_point_product;
  uint32_t a_multiplier;
  uint32_t b_multiplier;
  uint32_t mask;
  int32_t half;  // 2^(shift - 1)
  int32_t shift;
  int32_t y_zero_point_plus_1;
  int32_t y_min;
  int32_t y_max;
};

// One element: the uint8 result (before the cast) of bytes a and b.
__device__ __forceinline__ int32_t add_quant(uint32_t a, uint32_t b,
                                             const AddArgs& p) {
  const int32_t acc = static_cast<int32_t>(p.zero_point_product +
                                           a * p.a_multiplier +
                                           b * p.b_multiplier);
  const int32_t d = static_cast<int32_t>(static_cast<uint32_t>(acc) & p.mask) +
                    (acc >> 31) - p.half;
  int32_t v = (acc >> p.shift) + (d >> 31) + p.y_zero_point_plus_1;
  v = v < p.y_max ? v : p.y_max;
  return v > p.y_min ? v : p.y_min;
}

// Four elements packed in a word each way.
__device__ __forceinline__ uint32_t add_quant4(uint32_t a, uint32_t b,
                                               const AddArgs& p) {
  int32_t v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[e] = add_quant(__byte_perm(a, 0, 0x4440 + e),
                     __byte_perm(b, 0, 0x4440 + e), p);
  }
  const uint32_t lo = __byte_perm(v[0], v[1], 0x0040);
  const uint32_t hi = __byte_perm(v[2], v[3], 0x0040);
  return __byte_perm(lo, hi, 0x5410);
}

__global__ void __launch_bounds__(kThreads)
    q8vadd_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                  uint8_t* __restrict__ y, int64_t n, int64_t vecs,
                  const AddArgs p) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads +
                        threadIdx.x;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  const uint4* av = reinterpret_cast<const uint4*>(a);
  const uint4* bv = reinterpret_cast<const uint4*>(b);
  uint4* yv = reinterpret_cast<uint4*>(y);
  for (int64_t i = first; i < vecs; i += step) {
    const uint4 x = av[i];
    const uint4 w = bv[i];
    yv[i] = make_uint4(add_quant4(x.x, w.x, p), add_quant4(x.y, w.y, p),
                       add_quant4(x.z, w.z, p), add_quant4(x.w, w.w, p));
  }
  for (int64_t i = vecs * 16 + first; i < n; i += step) {
    y[i] = static_cast<uint8_t>(add_quant(a[i], b[i], p));
  }
}

}  // namespace

extern "C" int qnn_q8vadd(int device, const void* a, const void* b, void* y,
                          int64_t n, int zero_point_product, int a_multiplier,
                          int b_multiplier, int shift, int y_zero_point,
                          int y_min, int y_max, void* stream) {
  const qnn::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) {
    return static_cast<int>(guard.error());
  }
  if (shift < 1 || shift > 31) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const AddArgs p{static_cast<uint32_t>(zero_point_product),
                  static_cast<uint32_t>(a_multiplier),
                  static_cast<uint32_t>(b_multiplier),
                  (1u << shift) - 1u,
                  static_cast<int32_t>(1u << (shift - 1)),
                  shift,
                  y_zero_point + 1,
                  y_min,
                  y_max};
  const bool aligned = ((reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const int64_t vecs = aligned ? n / 16 : 0;
  const int64_t work = vecs > 0 ? vecs : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;
  q8vadd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
      static_cast<uint8_t*>(y), n, vecs, p);
  return static_cast<int>(cudaGetLastError());
}
