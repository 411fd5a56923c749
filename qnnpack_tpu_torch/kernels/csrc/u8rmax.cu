// u8rmax: the max of each row of a uint8 matrix, [R, N] -> [R].
//
// Replaces the TPU kernel qnnpack_tpu/kernels/vpu_ops.py:u8rmax_pallas (the
// u8rmax ukernel contract): pass 1 of softargmax, whose pass 2 is
// u8lut32norm.cu.
//
// What bounds it: one byte read per element and one written per row, one
// compare per element - memory bound.  Design: one warp a row, eight rows a
// block.  Where the row starts on a 4-byte boundary, lane i takes words i,
// i + 32, ... with __vmaxu4 (four byte maxima in one instruction; a BERT
// score row of 128 bytes is one word a lane, one 128-byte load a warp); the
// bytes past the last whole word, and every byte of a row that starts off
// the boundary (any N), go one at a time.  __shfl_xor_sync folds the lanes.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
    u8rmax_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
                  int64_t rows, int n) {
  const int lane = threadIdx.x % 32;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kRowsPerBlock;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock +
                   threadIdx.x / 32;
       r < rows; r += step) {
    const uint8_t* row = x + r * n;
    unsigned m = 0;
    int start = 0;
    if ((reinterpret_cast<uintptr_t>(row) & 3) == 0) {
      const int words = n / 4;
      const unsigned* w = reinterpret_cast<const unsigned*>(row);
      unsigned mw = 0;
      for (int i = lane; i < words; i += 32) mw = __vmaxu4(mw, w[i]);
      m = max(max(mw & 0xFFu, (mw >> 8) & 0xFFu),
              max((mw >> 16) & 0xFFu, mw >> 24));
      start = words * 4;
    }
    for (int i = start + lane; i < n; i += 32) {
      m = max(m, static_cast<unsigned>(row[i]));
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      m = max(m, __shfl_xor_sync(0xFFFFFFFFu, m, off));
    }
    if (lane == 0) y[r] = static_cast<uint8_t>(m);
  }
}

}  // namespace

extern "C" int qnn_u8rmax(int device, const void* x, void* y, int64_t rows,
                          int n, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows == 0) return 0;
  int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;
  u8rmax_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(y), rows, n);
  return static_cast<int>(cudaGetLastError());
}
