// u8clamp: y = min(max(x, lo), hi) over a flat uint8 buffer.
//
// Replaces the TPU kernel qnnpack_tpu/kernels/vpu_ops.py:u8clamp_pallas (the
// u8clamp ukernel contract, the lifecycle API's Clamp operator).
//
// What bounds it: one byte read and one written per element, two compares -
// memory bound.  Design: a grid-stride loop over 16-byte vectors, one a
// thread and step (uint4 loads and stores, __vmaxu4 / __vminu4 on each of
// its four words: sixteen byte clamps in eight instructions); the bytes past
// the last whole vector, or every byte when a pointer is off a 16-byte
// boundary, go one at a time.
#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned clamp4(unsigned v, unsigned lo4,
                                           unsigned hi4) {
  return __vminu4(__vmaxu4(v, lo4), hi4);
}

__global__ void __launch_bounds__(kThreads)
    u8clamp_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
                   int64_t n, int64_t vecs, int lo, int hi) {
  const unsigned lo4 = static_cast<unsigned>(lo) * 0x01010101u;
  const unsigned hi4 = static_cast<unsigned>(hi) * 0x01010101u;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads +
                        threadIdx.x;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  for (int64_t i = first; i < vecs; i += step) {
    uint4 v = xv[i];
    v.x = clamp4(v.x, lo4, hi4);
    v.y = clamp4(v.y, lo4, hi4);
    v.z = clamp4(v.z, lo4, hi4);
    v.w = clamp4(v.w, lo4, hi4);
    yv[i] = v;
  }
  for (int64_t i = vecs * 16 + first; i < n; i += step) {
    int v = x[i];
    v = v > lo ? v : lo;
    v = v < hi ? v : hi;
    y[i] = static_cast<uint8_t>(v);
  }
}

}  // namespace

extern "C" int qnn_u8clamp(int device, const void* x, void* y, int64_t n,
                           int lo, int hi, void* stream) {
  const qnn::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) {
    return static_cast<int>(guard.error());
  }
  if (n == 0) return 0;
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const int64_t vecs = aligned ? n / 16 : 0;
  const int64_t work = vecs > 0 ? vecs : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;
  u8clamp_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(y), n, vecs, lo,
      hi);
  return static_cast<int>(cudaGetLastError());
}
