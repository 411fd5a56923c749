// q8vadd: quantized elementwise add of two uint8 tensors of one shape.
//
// Replaces the TPU kernel qnnpack_tpu/kernels/vpu_ops.py:q8vadd_pallas (the
// add_quantize contract, qnnpack_tpu/quant/requantize.py:158-175):
//
//   acc = zero_point_product + a * a_multiplier + b * b_multiplier  (int32)
//   acc = (acc >> shift) + (remainder > threshold)
//   y   = clamp(acc + y_zero_point, y_min, y_max)
//
// The sum is taken in int64 and cut to its low 32 bits, so it wraps as the
// reference's int32 arithmetic does (signed overflow is undefined in C++).
//
// What bounds it: 3 bytes moved for about 10 int operations per element -
// memory bound.  Design: a grid-stride loop, one element per thread and
// step, consecutive threads on consecutive bytes so loads and stores
// coalesce.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    q8vadd_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                  uint8_t* __restrict__ y, int64_t n, int32_t zero_point_product,
                  int32_t a_multiplier, int32_t b_multiplier, int32_t shift,
                  int32_t y_zero_point, int32_t y_min, int32_t y_max) {
  const int32_t mask = static_cast<int32_t>((1u << shift) - 1u);
  const int32_t threshold = mask >> 1;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t sum = static_cast<int64_t>(zero_point_product) +
                        static_cast<int64_t>(a[i]) * a_multiplier +
                        static_cast<int64_t>(b[i]) * b_multiplier;
    int32_t acc = static_cast<int32_t>(
        static_cast<uint32_t>(static_cast<uint64_t>(sum)));
    const int32_t remainder = (acc & mask) - (acc < 0 ? 1 : 0);
    acc = (acc >> shift) + (remainder > threshold ? 1 : 0);
    int32_t v = acc + y_zero_point;
    v = v < y_max ? v : y_max;
    v = v > y_min ? v : y_min;
    y[i] = static_cast<uint8_t>(v);
  }
}

}  // namespace

extern "C" int qnn_q8vadd(int device, const void* a, const void* b, void* y,
                          int64_t n, int zero_point_product, int a_multiplier,
                          int b_multiplier, int shift, int y_zero_point,
                          int y_min, int y_max, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;
  q8vadd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
      static_cast<uint8_t*>(y), n, zero_point_product, a_multiplier,
      b_multiplier, shift, y_zero_point, y_min, y_max);
  return static_cast<int>(cudaGetLastError());
}
