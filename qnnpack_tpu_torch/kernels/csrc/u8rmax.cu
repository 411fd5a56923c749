// u8rmax: the max of each row of a uint8 matrix, [R, N] -> [R].
//
// Replaces the TPU kernel qnnpack_tpu/kernels/vpu_ops.py:u8rmax_pallas (the
// u8rmax ukernel contract): pass 1 of softargmax, whose pass 2 is
// u8lut32norm.cu.
//
// What bounds it: one byte read per element and one written per row - the
// memory, if enough bytes are in flight.  Design (the row mapping of
// u8rows.cuh): L lanes a row, V bytes a lane at a time, 2 consecutive rows
// a lane group, both loads issued before either is reduced (BERT's 128-byte
// score rows: 8 lanes a row, one 16-byte load a lane, 8 rows a warp) in
// 128-thread blocks (48 of them for batch 1's 1,536 rows); a row that takes
// a whole warp is one row a warp, its loop unrolled 4 times.  A lane folds
// its words with __vmaxu4 (four byte maxima an instruction), the group
// folds its lanes with __shfl_xor_sync, and the first lane of every other
// group stores the maxima of 4 consecutive rows (its group's and the
// next's) as one word.
#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"
#include "u8rows.cuh"

namespace {

using qnn_rows::Vec;

constexpr int kThreads = 128;

// Rows a lane group takes at a time: 2 where a row takes part of a warp,
// 1 where it takes the whole warp (whose loop over the row is unrolled
// instead).
template <int L>
constexpr int kRows = L == 32 ? 1 : 2;

// The byte-wise max of a lane's V bytes, as four byte maxima in a word.
template <int V>
__device__ __forceinline__ uint32_t fold(const uint32_t (&w)[Vec<V>::kWords]) {
  uint32_t m = w[0];
#pragma unroll
  for (int i = 1; i < Vec<V>::kWords; ++i) m = __vmaxu4(m, w[i]);
  return m;
}

template <int V, int L>
__global__ void __launch_bounds__(kThreads)
    u8rmax_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
                  int64_t rows, int n) {
  constexpr int kR = kRows<L>;
  constexpr int kBlockRows = kThreads / L * kR;
  const int lig = threadIdx.x % L;  // lane in the row's group
  const int vecs = n / V;
  const bool word_out = qnn_rows::aligned(y, 4);
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kBlockRows;
       base < rows; base += static_cast<int64_t>(gridDim.x) * kBlockRows) {
    const int64_t r0 = base + threadIdx.x / L * kR;
    uint32_t m[kR] = {};
    // Below 32 lanes a group covers its row (row_instance_ok): one pass.
#pragma unroll (L == 32 ? 4 : 1)
    for (int j = lig; j < vecs; j += L) {
      uint32_t w[kR][Vec<V>::kWords];
#pragma unroll
      for (int k = 0; k < kR; ++k) {
        if (r0 + k < rows) {
          Vec<V>::load(x + (r0 + k) * n + static_cast<int64_t>(j) * V, w[k]);
        } else {
#pragma unroll
          for (int i = 0; i < Vec<V>::kWords; ++i) w[k][i] = 0;
        }
      }
#pragma unroll
      for (int k = 0; k < kR; ++k) m[k] = __vmaxu4(m[k], fold<V>(w[k]));
    }
#pragma unroll
    for (int off = L / 2; off > 0; off /= 2) {
#pragma unroll
      for (int k = 0; k < kR; ++k) {
        m[k] = __vmaxu4(m[k], __shfl_xor_sync(0xFFFFFFFFu, m[k], off));
      }
    }
    uint32_t packed = 0;
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      uint32_t b = __vmaxu4(m[k], m[k] >> 16);
      b = __vmaxu4(b, b >> 8);
      packed |= (b & 0xFFu) << (8 * k);
    }
    if constexpr (kR == 1) {
      if (lig == 0 && r0 < rows) y[r0] = static_cast<uint8_t>(packed);
    } else {
      // This group's 2 maxima and the next group's: 4 consecutive rows.
      const uint32_t four =
          packed | __shfl_down_sync(0xFFFFFFFFu, packed, L) << 16;
      if (lig == 0 && threadIdx.x / L % 2 == 0) {
        if (word_out && r0 + 4 <= rows) {
          *reinterpret_cast<uint32_t*>(y + r0) = four;
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (r0 + k < rows) y[r0 + k] = static_cast<uint8_t>(four >> (8 * k));
          }
        }
      }
    }
  }
}

struct Launch {
  const uint8_t* x;
  uint8_t* y;
  int64_t rows;
  int n;
  cudaStream_t stream;

  template <int V, int L>
  cudaError_t run() const {
    u8rmax_kernel<V, L>
        <<<qnn_rows::grid_for(rows, kThreads / L * kRows<L>), kThreads, 0,
           stream>>>(x, y, rows, n);
    return cudaGetLastError();
  }
};

}  // namespace

// vec and lanes: the instance kernels/vpu_ops.py:row_instance picked; one
// that n or the bases do not allow is refused.
extern "C" int qnn_u8rmax(int device, const void* x, void* y, int64_t rows,
                          int n, int vec, int lanes, void* stream) {
  const qnn::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) {
    return static_cast<int>(guard.error());
  }
  if (!qnn_rows::row_instance_ok(vec, lanes, n, x, x)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  const Launch launch{static_cast<const uint8_t*>(x), static_cast<uint8_t*>(y),
                      rows, n, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(qnn_rows::dispatch(vec, lanes, launch));
}
