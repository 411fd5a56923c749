// q8gavgpool: quantized global average pool, uint8 [B, S, C] -> uint8 [B, C].
//
// Replaces the TPU kernel qnnpack_tpu/kernels/pool.py:q8gavgpool_pallas:
//
//   acc[b, c] = sum_s x[b, s, c] + bias          (int32, wrapping)
//   y[b, c]   = avgpool_quantize(acc)            (64-bit product, -1 for
//               negative values, rounding arithmetic shift, low 32 bits)
//
// What bounds it: S bytes read per output byte and one add each - memory
// bound.  Design: one thread per (b, c) looping over S; neighbouring
// threads take neighbouring channels, so every step of the loop is one
// coalesced row read.
#include <cuda_runtime.h>

#include <cstdint>

#include "requant.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    q8gavgpool_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
                      int batch, int rows, int channels, int32_t bias,
                      int32_t multiplier, int32_t shift, int32_t zero_point,
                      int32_t lo, int32_t hi) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= static_cast<int64_t>(batch) * channels) return;
  const int64_t b = idx / channels;
  const int c = static_cast<int>(idx % channels);
  const uint8_t* p = x + b * rows * channels + c;
  uint32_t acc = static_cast<uint32_t>(bias);
  for (int s = 0; s < rows; ++s) {
    acc += p[static_cast<int64_t>(s) * channels];
  }
  y[idx] = qnn::avgpool_requant(static_cast<int32_t>(acc), multiplier, shift,
                                zero_point, lo, hi);
}

}  // namespace

extern "C" int qnn_q8gavgpool(int device, const void* x, void* y, int batch,
                              int rows, int channels, int bias, int multiplier,
                              int shift, int zero_point, int lo, int hi,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(batch) * channels;
  if (total == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  q8gavgpool_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(y), batch, rows,
      channels, bias, multiplier, shift, zero_point, lo, hi);
  return static_cast<int>(cudaGetLastError());
}
