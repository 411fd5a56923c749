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
// head and FC layers at large M are the most compute-heavy.  Design: a
// 64 x 64 output tile per 256-thread block, a 32-deep K step staged through
// shared memory (A row-major, W transposed so that four consecutive k of
// one column form one 32-bit word), and __dp4a on the CUDA cores, 4 x 4
// outputs per thread.  The row sum for kzp != 128 is one more __dp4a per
// row against 0x01010101.  The int32 accumulator never leaves registers:
// the only store is the uint8 output.  Tensor cores (mma.sync / wgmma) and
// TMA are work for a later change.
#include <cuda_runtime.h>

#include <cstdint>

#include "requant.cuh"

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kPad = 4;  // bytes of padding per shared row (bank spread)
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    q8gemm_kernel(const uint8_t* __restrict__ a, const int8_t* __restrict__ w,
                  const int32_t* __restrict__ bias,
                  const float* __restrict__ scales, uint8_t* __restrict__ out,
                  int64_t m, int n, int k, int kzp_biased, qnn::Requant rp) {
  __shared__ __align__(16) int8_t as[kBM][kBK + kPad];
  __shared__ __align__(16) int8_t ws[kBN][kBK + kPad];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  int32_t acc[4][4];
  int32_t row_sum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row_sum[i] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  }

  // Loader coordinates: A tile 64 rows x 32 bytes, 8 bytes of one row per
  // thread; W tile 32 k-rows x 64 columns, 8 columns of one k-row per thread.
  const int a_row = tid / 4;
  const int a_col = (tid % 4) * 8;
  const int w_row = tid / 8;
  const int w_col = (tid % 8) * 8;
  const int64_t a_gm = m0 + a_row;

  for (int k0 = 0; k0 < k; k0 += kBK) {
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

#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      int av[4];
      int wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = *reinterpret_cast<const int*>(&as[ty + 16 * i][kk]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wv[j] = *reinterpret_cast<const int*>(&ws[tx + 16 * j][kk]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], wv[j], acc[i][j]);
      }
      if (kzp_biased != 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          row_sum[i] = __dp4a(av[i], 0x01010101, row_sum[i]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t gm = m0 + ty + 16 * i;
    if (gm >= m) continue;
    const uint32_t zp_term =
        static_cast<uint32_t>(kzp_biased) * static_cast<uint32_t>(row_sum[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= n) continue;
      const int32_t v = static_cast<int32_t>(
          static_cast<uint32_t>(acc[i][j]) +
          static_cast<uint32_t>(bias[gn]) - zp_term);
      const float cs = scales != nullptr ? scales[gn] : rp.scale;
      out[gm * n + gn] = qnn::requantize(v, rp, cs);
    }
  }
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
  const dim3 grid(static_cast<unsigned>((m + kBM - 1) / kBM),
                  static_cast<unsigned>((n + kBN - 1) / kBN));
  q8gemm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(bias), static_cast<const float*>(scales),
      static_cast<uint8_t*>(out), m, n, k, kzp_biased, rp);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* qnn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
