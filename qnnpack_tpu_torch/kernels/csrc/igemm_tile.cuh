// The 64 x 64 __dp4a tile of q8bmm.cu, its only user (q8gemm.cu and
// q8conv.cu run on the tensor-core tile of imma_tile.cuh; moving q8bmm onto
// it is queued work).
//
// A block of 256 threads owns a 64 x 64 tile of the output; each thread
// holds 4 x 4 int32 accumulators (rows ty + 16 i, columns tx + 16 j) and,
// for kzp != 128, the 4 row sums.  Each 32-deep K step is staged in shared
// memory by the caller - A row-major, W transposed so that four
// consecutive k of one column form one 32-bit word - and `tile_step` runs
// it as __dp4a on the CUDA cores.  `tile_store` adds the folded bias and
// the zero-point term in uint32 (wrapping, as the reference's int32 sums
// do) and requantizes before the only store.
#pragma once

#include <cstdint>

#include "requant.cuh"

namespace qnn {

constexpr int kTileM = 64;
constexpr int kTileN = 64;
constexpr int kTileK = 32;
constexpr int kTileRow = kTileK + 4;  // 4 bytes of padding per row (banks)
constexpr int kTileThreads = 256;

struct TileAcc {
  int32_t acc[4][4];
  int32_t row_sum[4];
};

__device__ __forceinline__ void tile_zero(TileAcc& t) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    t.row_sum[i] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) t.acc[i][j] = 0;
  }
}

// One staged K step: as [kTileM][kTileRow] biased A, ws [kTileN][kTileRow]
// biased W transposed.
__device__ __forceinline__ void tile_step(const int8_t (*as)[kTileRow],
                                          const int8_t (*ws)[kTileRow],
                                          int tx, int ty, bool row_sums,
                                          TileAcc& t) {
#pragma unroll
  for (int kk = 0; kk < kTileK; kk += 4) {
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
      for (int j = 0; j < 4; ++j) {
        t.acc[i][j] = __dp4a(av[i], wv[j], t.acc[i][j]);
      }
    }
    if (row_sums) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        t.row_sum[i] = __dp4a(av[i], 0x01010101, t.row_sum[i]);
      }
    }
  }
}

// acc + bias' - kzp' * row_sum, requantized.  Tile column gn < n lands in
// output column col_base + gn of rows out_stride bytes apart, and reads the
// bias and the channel scale of that column: a GEMM passes (n, 0), group g
// of a grouped conv (groups * n, g * n).
__device__ __forceinline__ void tile_store(const TileAcc& t, int64_t m0,
                                           int n0, int64_t m, int n,
                                           int out_stride, int col_base,
                                           int tx, int ty,
                                           const int32_t* __restrict__ bias,
                                           const float* __restrict__ scales,
                                           int kzp_biased, const Requant& rp,
                                           uint8_t* __restrict__ out) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t gm = m0 + ty + 16 * i;
    if (gm >= m) continue;
    const uint32_t zp_term = static_cast<uint32_t>(kzp_biased) *
                             static_cast<uint32_t>(t.row_sum[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= n) continue;
      const int col = col_base + gn;
      const int32_t v = static_cast<int32_t>(
          static_cast<uint32_t>(t.acc[i][j]) +
          static_cast<uint32_t>(bias[col]) - zp_term);
      const float cs = scales != nullptr ? scales[col] : rp.scale;
      out[gm * out_stride + col] = requantize(v, rp, cs);
    }
  }
}

}  // namespace qnn
