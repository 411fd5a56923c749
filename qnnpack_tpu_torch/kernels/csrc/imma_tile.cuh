// The int8 tensor-core tile shared by q8gemm.cu, q8conv.cu and q8stem.cu.
//
// Both kernels compute, for a block's BM x BN tile of the output,
//
//   acc[m, n] = sum_k A[m, k] W'[k, n] + c[n] - kzp' * sum_k A[m, k]
//                                                        (mod 2^32)
//   out[m, n] = requantize(acc[m, n])
//
// with A the raw uint8 activations, W' the biased int8 weights and
// c[n] = bias'[n] - 128 colsum(W')[n] + 128 K kzp' folded at pack time
// (nn/packing.py), which is the reference's sum A'W' + bias' - kzp' sum A'
// with A' = A - 128.  So A needs no rebias: mma.sync m16n8k32 .u8.s8 takes
// it as it lies in memory, and its copy into shared memory is a pure
// cp.async.
//
// What bounds the tile on this card: the int8 tensor cores at the main
// paths' deep products (BERT's projections, ResNet-18's 3x3 bodies; the
// card's 1,979 TOP/s come only through wgmma, and this tile's mma.sync
// reached 290-450 TOP/s there on an H100 80GB HBM3 at 700 W,
// scripts/bench_imma.py), the bytes at K below about 200 (MobileNetV2's
// and ShuffleNet's 1x1 layers).  The tensor cores stay fed only while the
// copies overlap the products, and a launch fills the card only with
// enough blocks.  Design:
//   - a cp.async ring in dynamic shared memory, 4 stages of one 64-byte K
//     step (3 of 128 bytes in the deep 128 x 128 shape, 2 in q8stem.cu's
//     shapes, whose K is 2-4 steps); rows padded by 16
//     bytes so that ldmatrix.x4 reads eight 16-byte row segments from
//     eight distinct bank groups;
//   - W K-major (each output column's K bytes contiguous, zero past K), so
//     that B fragments come from ldmatrix without a transpose - the only
//     8-bit operand layout that wgmma also takes;
//   - the row sum, needed only when kzp' != 0, as one more mma per 16-row
//     slice and 32-deep K step against a B fragment of ones;
//   - four block shapes (128 x 128 with 64- or 128-byte stages, 128 x 64,
//     64 x 64) that the wrapper picks from M, N, K and the SM count
//     (kernels/q8gemm.py tile_plan), and split-K over blockIdx.z for the
//     launches that fill too few SMs: each split writes its int32 partial
//     tile to a scratch buffer, and the last block to arrive for a tile (a
//     counter per tile) adds the others in uint32 and runs the epilogue, so
//     a call stays one launch.  Integer sums wrap mod 2^32 in any order, so
//     the split is exact; the wrapper also splits any K deeper than
//     kMaxChainSteps steps, which keeps every int32 mma chain below 2^31
//     (|A W'| <= 255 * 128, times 65,536).  No mma uses .satfinite;
//   - the epilogue stages acc - kzp' * rowsum (uint32) in shared memory,
//     then each thread takes 16 columns of a row: adds c[n], calls
//     requantize() of requant.cuh and writes the 16 bytes with one store
//     where the output allows, so the requantization runs with the
//     accumulator registers already free.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "requant.cuh"

namespace qnn {
namespace imma {

// The K unit of the packing and of the wrapper's plan: K-major weight rows
// are padded to it, and splits are counted in it.
constexpr int kStepK = 64;
constexpr int kMaxChainSteps = 1024;  // 65,536 of K per int32 chain

template <int BM_, int BN_, int WM_, int WN_, int MIN_BLOCKS_,
          int STEP_ = kStepK, int STAGES_ = STEP_ == kStepK ? 4 : 3>
struct Tile {
  static constexpr int kStep = STEP_;  // bytes of K per ring stage
  static constexpr int kPitch = kStep + 16;  // shared row pitch (padding)
  static constexpr int kStages = STAGES_;
  static_assert(kStages >= 2, "the ring refills one stage while another "
                              "is read");
  static constexpr int kUnits = kStep / kStepK;  // plan units per stage
  static constexpr int BM = BM_;
  static constexpr int BN = BN_;
  static constexpr int WN = WN_;
  static constexpr int kThreads = WM_ * WN_ * 32;
  static constexpr int kMinBlocks = MIN_BLOCKS_;  // blocks an SM holds
  static constexpr int kWarpRows = BM / WM_;
  static constexpr int kWarpCols = BN / WN_;
  static constexpr int MT = kWarpRows / 16;  // m16 slices per warp
  static constexpr int NT = kWarpCols / 8;   // n8 slices per warp
  static constexpr int kStageBytes = (BM + BN) * kPitch;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kAccPitch = BN + 4;  // int32 staging row pitch
  // One scratch slot of split-K: the int32 tile, then its row sums.
  static constexpr int kSlot = BM * BN + BM;
  static_assert(NT % 2 == 0, "B fragments come two n8 slices at a time");
  // Dynamic shared memory: the ring, which the int32 tile reuses.
  static constexpr int kSmemBytes = BM * kAccPitch * 4 > kRingBytes
                                        ? BM * kAccPitch * 4
                                        : kRingBytes;
  static_assert(BM * kStep / 16 % kThreads == 0 &&
                    BN * kStep / 16 % kThreads == 0,
                "16-byte copies divide evenly among the threads");
};

// The wrapper's tile ids (kernels/q8gemm.py TILES).  Two blocks of 128 x
// 128 an SM (128 registers a thread, some spilled outside the K loop) ran
// faster than one block without spills at every main-path shape timed.
using Tile128x128 = Tile<128, 128, 4, 2, 2>;  // 8 warps of 32 x 64
using Tile128x64 = Tile<128, 64, 4, 1, 3>;    // 4 warps of 32 x 64
using Tile64x64 = Tile<64, 64, 2, 2, 4>;      // 4 warps of 32 x 32
using Tile128x128Deep = Tile<128, 128, 4, 2, 2, 128>;  // 128-byte K steps

// Split-K arguments of one launch; splits == 1 runs no reduction.
struct Split {
  int splits;
  int steps_per_split;
  int32_t* workspace;  // [tiles, splits, kSlot] int32
  int* counters;       // [tiles], all 0 between launches
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// W-byte asynchronous copy; `full` false zero-fills the destination (the
// source is not read).
template <int W>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool full) {
  const int n = full ? W : 0;
  if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(W), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// W bytes of `word` (one byte repeated) stored to shared memory.
template <int W>
__device__ __forceinline__ void fill(uint8_t* dst, uint32_t word) {
  if constexpr (W == 16) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(word, word, word, word);
  } else if constexpr (W == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(word, word);
  } else if constexpr (W == 4) {
    *reinterpret_cast<uint32_t*>(dst) = word;
  } else {
    *dst = static_cast<uint8_t>(word);
  }
}

// One element of a W-byte copy: asynchronous for W >= 4, a plain byte copy
// for W == 1 (cp.async copies 4, 8 or 16 bytes).
template <int W>
__device__ __forceinline__ void copy_in(uint8_t* dst, const uint8_t* src,
                                        bool full) {
  if constexpr (W == 1) {
    *dst = full ? *src : 0;
  } else {
    cp_async<W>(dst, src, full);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c += a (16 x 32 uint8, row) * b (32 x 8 int8, col), int32, wrapping.
__device__ __forceinline__ void mma_u8s8(int32_t (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's accumulators.  Fragment layout of m16n8: c[i][j][h * 2 + e] is
// row i * 16 + lane / 4 + 8 h, column j * 8 + 2 (lane % 4) + e of the
// warp's tile; rs[i][2 h] is the row sum of row i * 16 + lane / 4 + 8 h.
template <class T>
struct Acc {
  int32_t c[T::MT][T::NT][4];
  int32_t rs[T::MT][4];
};

template <class T>
__device__ __forceinline__ uint8_t* stage_a(uint8_t* ring, int slot) {
  return ring + slot * T::kStageBytes;
}

template <class T>
__device__ __forceinline__ uint8_t* stage_b(uint8_t* ring, int slot) {
  return ring + slot * T::kStageBytes + T::BM * T::kPitch;
}

// B tile: BN rows of K-major weights, kStep bytes each from `offset` on;
// `rows` of them exist and each holds `pitch` bytes (the rest are
// zero-filled).  Rows are 16-byte aligned and zero past K, so every copy
// is 16 bytes.
template <class T>
__device__ __forceinline__ void load_b(uint8_t* sb, const int8_t* w,
                                       int64_t pitch, int64_t offset,
                                       int rows) {
  constexpr int kPerRow = T::kStep / 16;
#pragma unroll
  for (int j = 0; j < T::BN * kPerRow / T::kThreads; ++j) {
    const int idx = threadIdx.x + j * T::kThreads;
    const int r = idx / kPerRow;
    const int col = (idx % kPerRow) * 16;
    const bool ok = r < rows && offset + col < pitch;
    const int8_t* src = ok ? w + r * pitch + offset + col : w;
    cp_async<16>(sb + r * T::kPitch + col, src, ok);
  }
}

// The products of one staged K step.
template <class T>
__device__ __forceinline__ void compute_stage(const uint8_t* sa,
                                              const uint8_t* sb, int warp_m,
                                              int warp_n, int lane,
                                              bool row_sums, Acc<T>& acc) {
#pragma unroll
  for (int kk = 0; kk < T::kStep; kk += 32) {
    uint32_t af[T::MT][4];
#pragma unroll
    for (int i = 0; i < T::MT; ++i) {
      const int row = warp_m * T::kWarpRows + i * 16 + (lane & 15);
      ldmatrix_x4(af[i], sa + row * T::kPitch + kk + (lane >> 4) * 16);
    }
    // B two n8 slices at a time: one ldmatrix.x4 gives both slices' two
    // k16 halves.
#pragma unroll
    for (int j = 0; j < T::NT; j += 2) {
      const int row =
          warp_n * T::kWarpCols + j * 8 + (lane & 7) + ((lane >> 4) << 3);
      uint32_t b[4];
      ldmatrix_x4(b, sb + row * T::kPitch + kk + ((lane >> 3) & 1) * 16);
#pragma unroll
      for (int i = 0; i < T::MT; ++i) {
        mma_u8s8(acc.c[i][j], af[i], b[0], b[1]);
        mma_u8s8(acc.c[i][j + 1], af[i], b[2], b[3]);
      }
    }
    if (row_sums) {
#pragma unroll
      for (int i = 0; i < T::MT; ++i) {
        mma_u8s8(acc.rs[i], af[i], 0x01010101u, 0x01010101u);
      }
    }
  }
}

// K steps [step0, step0 + nsteps) through the ring.  `ld.load(sa, sb,
// step)` issues the copies of one step (cp.async, or st.shared for values
// that do not come from memory); every thread commits one group a step, so
// wait_group<T::kStages - 2> finds the step about to be used complete.
template <class T, class Loader>
__device__ __forceinline__ void mainloop(const Loader& ld, uint8_t* ring,
                                         int step0, int nsteps,
                                         bool row_sums, Acc<T>& acc) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warp_m = warp / T::WN;
  const int warp_n = warp % T::WN;
#pragma unroll
  for (int i = 0; i < T::MT; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc.rs[i][e] = 0;
#pragma unroll
      for (int j = 0; j < T::NT; ++j) acc.c[i][j][e] = 0;
    }
  }
#pragma unroll
  for (int s = 0; s < T::kStages - 1; ++s) {
    if (s < nsteps) {
      ld.load(stage_a<T>(ring, s), stage_b<T>(ring, s), step0 + s);
    }
    cp_async_commit();
  }
  for (int t = 0; t < nsteps; ++t) {
    cp_async_wait<T::kStages - 2>();
    __syncthreads();
    // The slot refilled here was read in step t - 1, which every warp has
    // finished: the barrier above is behind it.
    const int next = t + T::kStages - 1;
    if (next < nsteps) {
      const int slot = next % T::kStages;
      ld.load(stage_a<T>(ring, slot), stage_b<T>(ring, slot), step0 + next);
    }
    cp_async_commit();
    const int slot = t % T::kStages;
    compute_stage<T>(stage_a<T>(ring, slot), stage_b<T>(ring, slot), warp_m,
                     warp_n, lane, row_sums, acc);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Split-K: store this split's partial tile, and return true in the last
// block to arrive for `tile`, with the other splits' partials added to
// `acc` (uint32, wrapping).  `flag` is a __shared__ int of the kernel.
template <class T>
__device__ __forceinline__ bool split_reduce(Acc<T>& acc, const Split& sp,
                                             int64_t tile, int split,
                                             int* flag) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = (warp / T::WN) * T::kWarpRows + (lane >> 2);
  const int col0 = (warp % T::WN) * T::kWarpCols + 2 * (lane & 3);
  int32_t* mine =
      sp.workspace + (tile * sp.splits + split) * static_cast<int64_t>(
                                                      T::kSlot);
#pragma unroll
  for (int i = 0; i < T::MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + i * 16 + 8 * h;
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
        *reinterpret_cast<int2*>(&mine[row * T::BN + col0 + j * 8]) =
            make_int2(acc.c[i][j][2 * h], acc.c[i][j][2 * h + 1]);
      }
      if (warp % T::WN == 0 && (lane & 3) == 0) {
        mine[T::BM * T::BN + row] = acc.rs[i][2 * h];
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    *flag = atomicAdd(&sp.counters[tile], 1) == sp.splits - 1;
  }
  __syncthreads();
  if (!*flag) return false;
  __threadfence();
  for (int s = 0; s < sp.splits; ++s) {
    if (s == split) continue;
    const int32_t* other =
        sp.workspace + (tile * sp.splits + s) * static_cast<int64_t>(
                                                    T::kSlot);
#pragma unroll
    for (int i = 0; i < T::MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + i * 16 + 8 * h;
#pragma unroll
        for (int j = 0; j < T::NT; ++j) {
          const int2 v = __ldcg(reinterpret_cast<const int2*>(
              &other[row * T::BN + col0 + j * 8]));
          acc.c[i][j][2 * h] = wrap_add(acc.c[i][j][2 * h], v.x);
          acc.c[i][j][2 * h + 1] = wrap_add(acc.c[i][j][2 * h + 1], v.y);
        }
        acc.rs[i][2 * h] =
            wrap_add(acc.rs[i][2 * h], __ldcg(&other[T::BM * T::BN + row]));
      }
    }
  }
  if (threadIdx.x == 0) sp.counters[tile] = 0;  // ready for the next launch
  return true;
}

// Pass 2 of the epilogue: each thread takes 16 columns of a staged row,
// adds c, requantizes with scheme S (fixed at compile time, so
// requantize()'s switch folds away) and stores the 16 bytes.  With
// ROW_SUMS, it also adds sum (y - 128) of its bytes to row_part[r] (shared
// memory, the block's partial row sums; only q8gemm.cu's row-sum producer
// compiles it).
template <class T, int S, bool ROW_SUMS = false>
__device__ __forceinline__ void store_rows(
    const uint32_t* stage, int64_t m0, int n0, int64_t m, int n,
    int64_t out_stride, int col_base, const int32_t* __restrict__ bias_c,
    const float* __restrict__ scales, const Requant& rp_in,
    uint8_t* __restrict__ out, int32_t* row_part) {
  Requant rp = rp_in;
  rp.scheme = S;
  constexpr int kSegs = T::BN / 16;
  for (int idx = threadIdx.x; idx < T::BM * kSegs; idx += T::kThreads) {
    const int r = idx / kSegs;
    const int c = (idx % kSegs) * 16;
    const int64_t gm = m0 + r;
    const int gn = n0 + c;
    if (gm >= m || gn >= n) continue;
    const int len = n - gn < 16 ? n - gn : 16;
    const int col = col_base + gn;
    uint32_t v[16];
    const uint4* src =
        reinterpret_cast<const uint4*>(stage + r * T::kAccPitch + c);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 x = src[q];
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
    if (len == 16 && reinterpret_cast<uintptr_t>(bias_c + col) % 16 == 0) {
      const int4* b4 = reinterpret_cast<const int4*>(bias_c + col);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int4 x = __ldg(b4 + q);
        v[4 * q] += static_cast<uint32_t>(x.x);
        v[4 * q + 1] += static_cast<uint32_t>(x.y);
        v[4 * q + 2] += static_cast<uint32_t>(x.z);
        v[4 * q + 3] += static_cast<uint32_t>(x.w);
      }
    } else {
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        if (b < len) v[b] += static_cast<uint32_t>(__ldg(bias_c + col + b));
      }
    }
    uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      const float cs = S == kFP32PerChannel && b < len
                           ? __ldg(scales + col + b)
                           : rp.scale;
      words[b / 4] |=
          static_cast<uint32_t>(requantize(static_cast<int32_t>(v[b]), rp,
                                           cs))
          << (8 * (b % 4));
    }
    if constexpr (ROW_SUMS) {
      int32_t sum = 0;
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        if (b < len) {
          sum += static_cast<int32_t>((words[b / 4] >> (8 * (b % 4))) & 0xFF) -
                 128;
        }
      }
      atomicAdd(row_part + r, sum);
    }
    uint8_t* dst = out + gm * out_stride + col;
    const auto addr = reinterpret_cast<uintptr_t>(dst);
    if (len == 16 && addr % 16 == 0) {
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(words[0], words[1], words[2], words[3]);
    } else {
      // Rows whose pitch or group offset is not a multiple of 16 (N = 60,
      // Ocpg = 20, 72...): whole words where the address allows.  The
      // indices stay compile-time, which keeps `words` in registers.
      const bool word_aligned = addr % 4 == 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (word_aligned && 4 * q + 4 <= len) {
          *reinterpret_cast<uint32_t*>(dst + 4 * q) = words[q];
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (4 * q + e < len) {
              dst[4 * q + e] = static_cast<uint8_t>(words[q] >> (8 * e));
            }
          }
        }
      }
    }
  }
}

// The output side of one tile.  Tile column gn < n lands in output column
// col_base + gn of rows out_stride bytes apart and reads c and the channel
// scale of that column: a GEMM passes (n, 0), group g of a grouped conv
// (groups * n, g * n).  The ring holds the staged tile.  ROW_SUMS adds the
// tile's row sums of y - 128 to row_part (see store_rows), which the
// caller zeroes before the call.
template <class T, bool ROW_SUMS = false>
__device__ __forceinline__ void epilogue(
    const Acc<T>& acc, uint8_t* ring, int64_t m0, int n0, int64_t m, int n,
    int64_t out_stride, int col_base, const int32_t* __restrict__ bias_c,
    const float* __restrict__ scales, int kzp_biased, const Requant& rp,
    uint8_t* __restrict__ out, int32_t* row_part = nullptr) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = (warp / T::WN) * T::kWarpRows + (lane >> 2);
  const int col0 = (warp % T::WN) * T::kWarpCols + 2 * (lane & 3);
  uint32_t* stage = reinterpret_cast<uint32_t*>(ring);
#pragma unroll
  for (int i = 0; i < T::MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + i * 16 + 8 * h;
      const uint32_t zp_term = static_cast<uint32_t>(kzp_biased) *
                               static_cast<uint32_t>(acc.rs[i][2 * h]);
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
        *reinterpret_cast<uint2*>(&stage[row * T::kAccPitch + col0 + j * 8]) =
            make_uint2(static_cast<uint32_t>(acc.c[i][j][2 * h]) - zp_term,
                       static_cast<uint32_t>(acc.c[i][j][2 * h + 1]) -
                           zp_term);
      }
    }
  }
  __syncthreads();
  switch (rp.scheme) {
    case kQ31:
      store_rows<T, kQ31, ROW_SUMS>(stage, m0, n0, m, n, out_stride, col_base,
                                    bias_c, scales, rp, out, row_part);
      break;
    case kFP32:
      store_rows<T, kFP32, ROW_SUMS>(stage, m0, n0, m, n, out_stride,
                                     col_base, bias_c, scales, rp, out,
                                     row_part);
      break;
    case kPrecise:
      store_rows<T, kPrecise, ROW_SUMS>(stage, m0, n0, m, n, out_stride,
                                        col_base, bias_c, scales, rp, out,
                                        row_part);
      break;
    case kGemmlowp:
      store_rows<T, kGemmlowp, ROW_SUMS>(stage, m0, n0, m, n, out_stride,
                                         col_base, bias_c, scales, rp, out,
                                         row_part);
      break;
    default:
      store_rows<T, kFP32PerChannel, ROW_SUMS>(stage, m0, n0, m, n,
                                               out_stride, col_base, bias_c,
                                               scales, rp, out, row_part);
  }
}

// The output side of a partial instance (q8gemm.cu, q8conv.cu): each tile
// element's acc - kzp' * rowsum (uint32, wrapping) stored as int32, with
// no c and no requantization, at output column col_base + gn of rows
// out_stride elements apart.  A caller sums the K slices' partials and
// then adds c and requantizes once (q8requant.cu).  Straight from the
// fragments: each quad of lanes stores 32 contiguous bytes of a row.
template <class T>
__device__ __forceinline__ void store_partial(
    const Acc<T>& acc, int64_t m0, int n0, int64_t m, int n,
    int64_t out_stride, int col_base, int kzp_biased,
    int32_t* __restrict__ out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = (warp / T::WN) * T::kWarpRows + (lane >> 2);
  const int col0 = (warp % T::WN) * T::kWarpCols + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < T::MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t gm = m0 + row0 + i * 16 + 8 * h;
      if (gm >= m) continue;
      const uint32_t zp_term = static_cast<uint32_t>(kzp_biased) *
                               static_cast<uint32_t>(acc.rs[i][2 * h]);
      int32_t* row = out + gm * out_stride + col_base;
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
        const int gn = n0 + col0 + j * 8;
        const int32_t v0 = static_cast<int32_t>(
            static_cast<uint32_t>(acc.c[i][j][2 * h]) - zp_term);
        const int32_t v1 = static_cast<int32_t>(
            static_cast<uint32_t>(acc.c[i][j][2 * h + 1]) - zp_term);
        if (gn + 1 < n && reinterpret_cast<uintptr_t>(row + gn) % 8 == 0) {
          *reinterpret_cast<int2*>(row + gn) = make_int2(v0, v1);
        } else {
          if (gn < n) row[gn] = v0;
          if (gn + 1 < n) row[gn + 1] = v1;
        }
      }
    }
  }
}

// Largest copy width in {16, 8, 4, 1} that both the base address and the
// row pitch (or channel run) `run` are multiples of.
inline int copy_width(const void* base, int64_t run) {
  const auto addr = reinterpret_cast<uintptr_t>(base);
  for (int w = 16; w >= 4; w >>= 1) {
    if (addr % w == 0 && run % w == 0) return w;
  }
  return 1;
}

// Opt both instances of a launcher into `bytes` of dynamic shared memory
// (above 48 KB needs it), once a device: bit d of `ready` (the launcher's
// own static) says device d is done.  A race only sets it twice.
template <class K>
inline cudaError_t allow_smem(K wide, K generic, int bytes, int device,
                              unsigned& ready) {
  const unsigned bit = device < 32 ? 1u << device : 0u;
  if (ready & bit) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      wide, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        generic, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  if (err == cudaSuccess) ready |= bit;
  return err;
}

}  // namespace imma
}  // namespace qnn
