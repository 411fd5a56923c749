// q8bmm: batched uint8 A [G, M, K] x uint8 B [G, K, N] -> uint8 [G, M, N].
//
// The port of qnnpack_tpu/nn/gemm.py:q8bmm (an XLA op in the JAX package,
// with no Pallas form): both operands are activations, so neither side is
// prepacked and both zero points are dynamic terms of the epilogue.
//
//   acc[g, m, n] = sum_k A'[g, m, k] B'[g, k, n] - zb' * sum_k A'[g, m, k]
//                  - za' * sum_k B'[g, k, n] + K za' zb'        (mod 2^32)
//   out[g, m, n] = requantize(acc[g, m, n])   (any scheme, in registers)
//
// A' = A ^ 0x80 and B' = B ^ 0x80 are rebiased as they are loaded.  The row
// sum (zb' != 0) comes from the shared tile's __dp4a against 0x01010101; the
// column sum (za' != 0) is one more __dp4a per staged column and K step.
//
// What bounds it: BERT's attention products are small per batch entry
// (scores 128 x 64 x 128, context 128 x 128 x 64) and many (G = batch x
// heads): about 64 int8 ops per byte moved, below the card's ridge of about
// 590, so their bound is set by bytes; on __dp4a the CUDA cores, not the
// memory, are the limit.  Design: the 64 x 64 tile of igemm_tile.cuh with
// the batch entry as blockIdx.z (looped past 65535), B staged transposed
// into shared memory so that four consecutive k of one column form one
// word.  Tensor cores are work for a later change.
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
    q8bmm_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                 const float* __restrict__ scales, uint8_t* __restrict__ out,
                 int64_t g, int m, int n, int k, int za, int zb,
                 qnn::Requant rp) {
  __shared__ __align__(16) int8_t as[kTileM][kTileRow];
  __shared__ __align__(16) int8_t bs[kTileN][kTileRow];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * kTileM;
  const int n0 = blockIdx.y * kTileN;
  // Loader coordinates: A tile 64 rows x 32 bytes, 8 bytes of one row per
  // thread; B tile 32 k-rows x 64 columns, 8 columns of one k-row per thread.
  const int a_row = tid / 4;
  const int a_col = (tid % 4) * 8;
  const int b_row = tid / 8;
  const int b_col = (tid % 8) * 8;
  const int a_gm = m0 + a_row;
  const uint32_t kzz = static_cast<uint32_t>(k) * static_cast<uint32_t>(za) *
                       static_cast<uint32_t>(zb);

  for (int64_t z = blockIdx.z; z < g; z += gridDim.z) {
    const uint8_t* az = a + z * m * k;
    const uint8_t* bz = b + z * k * n;
    qnn::TileAcc t;
    qnn::tile_zero(t);
    int32_t col_sum[4] = {0, 0, 0, 0};

    for (int k0 = 0; k0 < k; k0 += kTileK) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int gk = k0 + a_col + j;
        int8_t v = 0;
        if (a_gm < m && gk < k) {
          v = static_cast<int8_t>(az[static_cast<int64_t>(a_gm) * k + gk] ^
                                  0x80);
        }
        as[a_row][a_col + j] = v;
      }
      const int b_gk = k0 + b_row;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int gn = n0 + b_col + j;
        int8_t v = 0;
        if (b_gk < k && gn < n) {
          v = static_cast<int8_t>(bz[static_cast<int64_t>(b_gk) * n + gn] ^
                                  0x80);
        }
        bs[b_col + j][b_row] = v;
      }
      __syncthreads();
      qnn::tile_step(as, bs, tx, ty, zb != 0, t);
      if (za != 0) {
#pragma unroll
        for (int kk = 0; kk < kTileK; kk += 4) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            col_sum[j] = __dp4a(
                *reinterpret_cast<const int*>(&bs[tx + 16 * j][kk]),
                0x01010101, col_sum[j]);
          }
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gm = m0 + ty + 16 * i;
      if (gm >= m) continue;
      const uint32_t row_term = static_cast<uint32_t>(zb) *
                                static_cast<uint32_t>(t.row_sum[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gn = n0 + tx + 16 * j;
        if (gn >= n) continue;
        const int32_t v = static_cast<int32_t>(
            static_cast<uint32_t>(t.acc[i][j]) - row_term -
            static_cast<uint32_t>(za) * static_cast<uint32_t>(col_sum[j]) +
            kzz);
        const float cs = scales != nullptr ? scales[gn] : rp.scale;
        out[(z * m + gm) * n + gn] = qnn::requantize(v, rp, cs);
      }
    }
  }
}

}  // namespace

extern "C" int qnn_q8bmm(int device, const void* a, const void* b,
                         const void* scales, void* out, int64_t g, int m,
                         int n, int k, int za, int zb, int scheme,
                         int multiplier, int shift, int zero_point, int qmin,
                         int qmax, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (g == 0 || m == 0 || n == 0) return 0;
  const qnn::Requant rp{scheme, multiplier, shift, zero_point, qmin, qmax,
                        scale};
  const dim3 grid(static_cast<unsigned>((m + kTileM - 1) / kTileM),
                  static_cast<unsigned>((n + kTileN - 1) / kTileN),
                  static_cast<unsigned>(g < 65535 ? g : 65535));
  q8bmm_kernel<<<grid, kTileThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
      static_cast<const float*>(scales), static_cast<uint8_t*>(out), g, m, n,
      k, za, zb, rp);
  return static_cast<int>(cudaGetLastError());
}
