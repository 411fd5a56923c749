// q8gemm: uint8 A [M, K] x biased-int8 W [K, N] -> uint8 [M, N].
//
// Replaces the TPU kernels qnnpack_tpu/kernels/q8gemm_small.py:
// q8gemm_small_pallas (K untiled, per-tensor or per-channel requant) and
// qnnpack_tpu/kernels/q8gemm.py:q8gemm_pallas (K tiled, accumulator and row
// sum carried across K steps).  One kernel serves both contracts: the K loop
// runs inside the block, so nothing is carried between blocks.
//
//   acc[m, n] = sum_k A'[m, k] W'[k, n] - kzp' * sum_k A'[m, k] + bias'[n]
//   out[m, n] = requantize(acc[m, n])        (any scheme, in registers)
//
// A' = A ^ 0x80 is rebiased as it is loaded.  Ragged M, N and K edges are
// masked: a padded K position holds biased 0, which adds nothing to the
// product or to the row sum.
//
// What bounds it: the main-path shapes are skinny (K 16..960, N 16..1280)
// with M up to 1.6M rows, so most layers move far more bytes than they do
// operations per byte (below the int8 ridge) and are bound by memory; the
// head and FC layers at large M are the most compute-heavy.  Design: the
// 64 x 64 tile of igemm_tile.cuh (a 32-deep K step staged through shared
// memory, __dp4a on the CUDA cores, 4 x 4 outputs per thread, the row sum
// for kzp != 128 as one more __dp4a per row against 0x01010101).  The int32
// accumulator never leaves registers: the only store is the uint8 output.
// Tensor cores (mma.sync / wgmma) and TMA are work for a later change.
#include <cuda_runtime.h>

#include <cstdint>

#include "igemm_tile.cuh"

namespace {

using qnn::kTileK;
using qnn::kTileM;
using qnn::kTileN;
using qnn::kTileRow;
using qnn::kTileThreads;

__global__ void __launch_bounds__(kTileThreads)
    q8gemm_kernel(const uint8_t* __restrict__ a, const int8_t* __restrict__ w,
                  const int32_t* __restrict__ bias,
                  const float* __restrict__ scales, uint8_t* __restrict__ out,
                  int64_t m, int n, int k, int kzp_biased, qnn::Requant rp) {
  __shared__ __align__(16) int8_t as[kTileM][kTileRow];
  __shared__ __align__(16) int8_t ws[kTileN][kTileRow];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kTileM;
  const int n0 = blockIdx.y * kTileN;

  qnn::TileAcc t;
  qnn::tile_zero(t);

  // Loader coordinates: A tile 64 rows x 32 bytes, 8 bytes of one row per
  // thread; W tile 32 k-rows x 64 columns, 8 columns of one k-row per thread.
  const int a_row = tid / 4;
  const int a_col = (tid % 4) * 8;
  const int w_row = tid / 8;
  const int w_col = (tid % 8) * 8;
  const int64_t a_gm = m0 + a_row;

  for (int k0 = 0; k0 < k; k0 += kTileK) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gk = k0 + a_col + j;
      int8_t v = 0;
      if (a_gm < m && gk < k) {
        v = static_cast<int8_t>(a[a_gm * k + gk] ^ 0x80);
      }
      as[a_row][a_col + j] = v;
    }
    const int w_gk = k0 + w_row;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + w_col + j;
      int8_t v = 0;
      if (w_gk < k && gn < n) v = w[static_cast<int64_t>(w_gk) * n + gn];
      ws[w_col + j][w_row] = v;
    }
    __syncthreads();
    qnn::tile_step(as, ws, tx, ty, kzp_biased != 0, t);
    __syncthreads();
  }
  qnn::tile_store(t, m0, n0, m, n, n, 0, tx, ty, bias, scales, kzp_biased, rp,
                  out);
}

}  // namespace

extern "C" int qnn_q8gemm(int device, const void* a, const void* w,
                          const void* bias, const void* scales, void* out,
                          int64_t m, int n, int k, int kzp_biased, int scheme,
                          int multiplier, int shift, int zero_point, int qmin,
                          int qmax, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m == 0 || n == 0) return 0;
  const qnn::Requant rp{scheme, multiplier, shift, zero_point, qmin, qmax,
                        scale};
  const dim3 grid(static_cast<unsigned>((m + kTileM - 1) / kTileM),
                  static_cast<unsigned>((n + kTileN - 1) / kTileN));
  q8gemm_kernel<<<grid, kTileThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(bias), static_cast<const float*>(scales),
      static_cast<uint8_t*>(out), m, n, k, kzp_biased, rp);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* qnn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
