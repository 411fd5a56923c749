// The warp-specialised int8 tensor-core tile of q8gemm.cu's wgmma instance.
//
// Computes, for each BM x BN tile of the output,
//
//   acc[m, n] = sum_k A[m, k] W'[k, n] + c[n] - kzp' * sum_k A[m, k]
//                                                        (mod 2^32)
//   out[m, n] = requantize(acc[m, n])
//
// as imma_tile.cuh does (A raw uint8 [M, K], W' the K-major biased int8
// weights [N, Kp], c folded at pack time), with Hopper's warpgroup MMA.
//
// What bounds it on this card: the int8 tensor cores, which reach their
// 1,979 TOP/s only through wgmma fed from shared memory by TMA.  The
// wrapper routes a launch here only where the GEMM does at least the
// card's ridge of int8 operations a byte (kernels/q8gemm.py wgmma_route),
// so the K loop has to keep the tensor cores busy, and the epilogue's
// requantization is the time they stand idle.  Design:
//   - a persistent grid, one 384-thread block an SM, that walks the output
//     tiles N-block fastest (the blocks in flight share A rows in L2);
//   - a ring of kStages stages of 128 bytes of K in dynamic shared memory,
//     each the A tile (BM rows) and the W tile (BN rows) as TMA writes
//     them with the 128-byte swizzle, which is the K-major layout wgmma
//     reads (integer wgmma takes K-major operands only; A [M, K] and
//     w_kmajor [N, Kp] are K-major as they lie, so nothing is repacked).
//     TMA zero-fills rows past M and N and K positions past K (and Kp),
//     which add nothing to the product or to the row sum;
//   - warpgroup 2 is the producer: one thread keeps the TMA loads of both
//     tiles in flight, a full and an empty mbarrier a stage, running ahead
//     across tile boundaries, so the next tile's loads overlap this tile's
//     epilogue; setmaxnreg gives it 40 registers and each consumer 232;
//   - warpgroups 0 and 1 consume 64 rows each: four wgmma m64nBNk32
//     .s32.u8.s8 a stage, one commit group a stage with the previous one
//     left in flight, the stage released once its group is done.  Where
//     kzp' != 0 a fifth m64n8k32 against a shared tile of ones gives the
//     row sum sum_k A (exact for any kzp');
//   - the accumulator fragment puts each thread's rows and columns where
//     mma.sync's m16n8 fragment does, warp w of a warpgroup on rows 16 w ..
//     16 w + 15: the epilogue adds c, subtracts kzp' * rowsum (uint32),
//     requantizes (requant.cuh requant_one: the fp32 schemes with one
//     conversion where requant_fp32 has three), and
//     writes the bytes to a staging tile in shared memory (16-byte chunks
//     swizzled by row, so the 2-byte writes of a warp's eight rows hit
//     distinct banks), from which each warpgroup stores its rows as
//     16-byte runs.  The epilogue overlaps no product: at BERT's K = 768 it
//     is about a third of the time (856-886 TOP/s at qkv, out and ffn1,
//     1,369 at ffn2's K = 3,072; the three-conversion requantization had
//     569-608 at K = 768; H100 80GB HBM3, 700 W,
//     scripts/bench_imma.py);
//   - every int32 chain is exact: the wrapper sends no K deeper than
//     kMaxChainSteps steps of 64 here, and no instruction saturates.
//
// The grouped instance (q8gemm.cu q8gemm_grouped_kernel, an expert
// layer's GEMMs) runs the same block over `experts` segments of A and of
// the output, `cap` rows each, with expert e's weights at rows e * N of W'
// and its c at e * N: each block reads the live row counts (written on the
// device by the routing) once and walks the live tiles of every expert in
// turn, so a grid sized for every row live spends nothing on the rest.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "requant.cuh"

namespace qnn {
namespace wgmma {

constexpr int BM = 128;           // two consumer warpgroups of 64 rows
constexpr int kStepBytes = 128;   // K bytes a stage: one 128-byte swizzle row
constexpr int kThreads = 384;     // consumers 0, 1; producer 2
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

template <int BN_, int STAGES_>
struct Tile {
  static constexpr int BN = BN_;
  static constexpr int kStages = STAGES_;
  static constexpr int kABytes = BM * kStepBytes;
  static constexpr int kBBytes = BN * kStepBytes;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kOnesBytes = 8 * kStepBytes;  // n8 x 128 of ones
  static constexpr int kOutBytes = BM * BN;          // the uint8 staging
  // 1024 bytes of slack: the ring must start on a 1024-byte boundary (the
  // swizzle's period), which dynamic shared memory does not promise.
  static constexpr int kSmemBytes = 1024 + kStages * kStageBytes +
                                    kOnesBytes + kOutBytes +
                                    2 * kStages * 8;
  static_assert(BN == 256, "mma_u8s8 and the staging swizzle (16 chunks "
                           "of 16 bytes a row) are written for N = 256");
  static_assert(kStageBytes % 1024 == 0, "stages stay 1024-byte aligned");
  static_assert(kSmemBytes <= 232448, "one block an SM");
};

// The C entry's tile id 4 (kernels/q8gemm.py TILES): 128 x 256, which ran
// 8-17% faster than 128 x 128 at each of BERT's four batch-128
// projections (H100 80GB HBM3, 700 W).
using Tile128x256 = Tile<256, 4>;

struct Args {
  CUtensorMap a_map;  // A [M, K] uint8, box 128 x BM, 128-byte swizzle
  CUtensorMap w_map;  // W' [N, Kp] int8, box 128 x BN, 128-byte swizzle
  const int32_t* bias_c;
  const float* scales;
  uint8_t* out;
  int m, n, kp, kzp_biased;
  int tiles_n, tiles;
  int pairs;  // bias_c and scales are 8-byte aligned: two a load
  Requant rp;
  // The grouped instance: `experts` segments of `cap` rows of A and of the
  // output, counts[e] of them live; expert e's weights are rows e * n of
  // W' and its c at bias_c + e * n.
  const int32_t* counts;
  int experts, cap;
};

constexpr int kMaxExperts = 32;  // of the grouped instance

// Where a tile of the walk lies: its first row of A and of the output, its
// first column, its first row of W', its c, and the end of its rows.
struct TileAt {
  int m0, n0, w_row;
  const int32_t* bias;
  int row_end;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the box of `map` at (c0 = K byte, c1 = row) into shared `dst`,
// completing `bytes` of `bar`'s transaction count.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Barrier `id` (1 + warpgroup) over one warpgroup's 128 threads.
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor of a K-major tile with the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO 64 in
// 16-byte units; LBO unused), base 1024-byte aligned.  A K offset of k
// bytes inside the row is + k / 16.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(64) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// d (+)= A (64 x 32 uint8, K-major, descriptor a) * B (N x 32 int8,
// K-major, descriptor b), int32, wrapping; `accumulate` 0 overwrites d.
// N = 256 for the products, 8 for the row sums.
// Fragment: d[4 j + 2 h + e] is row 16 warp + lane / 4 + 8 h, column
// 8 j + 2 (lane % 4) + e of the warpgroup's 64 x N tile.
template <int N>
__device__ __forceinline__ void mma_u8s8(int32_t (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate);

template <>
__device__ __forceinline__ void mma_u8s8<256>(int32_t (&d)[128], uint64_t a,
    uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.u8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_u8s8<8>(int32_t (&d)[4], uint64_t a,
    uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.u8.s8 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(a), "l"(b), "r"(accumulate));
}

// Pins the values of `d` between two asm statements: the compiler may not
// move a read of an accumulator above the wgmma_wait that completes it,
// nor a write below the wgmma that reads it.
template <int N>
__device__ __forceinline__ void fence_operands(int32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The epilogue's first pass: c added, kzp' * rowsum (zp0 for the thread's
// row r0, zp1 for r0 + 8) subtracted, requantized (requant_one<S>), and
// the bytes written to this warpgroup's staging rows (`stage`, 64 x BN;
// 16-byte chunk c of row r at chunk c ^ (r % 8)).  EDGE: the tile passes
// N, or c or the scales are not 8-byte aligned, so each column is checked
// and read alone; columns past N are computed from no c and never stored.
template <class T, int S, bool EDGE>
__device__ __forceinline__ void stage_tile(const int32_t (&acc)[T::BN / 2],
                                           uint32_t zp0, uint32_t zp1,
                                           uint8_t* stage, int n0,
                                           const int32_t* bias_c,
                                           const Args& p, int tid) {
  Requant rp = p.rp;
  if constexpr (S >= 0) rp.scheme = S;
  const bool channels = S == kFP32PerChannel ||
                        (S < 0 && rp.scheme == kFP32PerChannel);
  const float lo = static_cast<float>(rp.qmin - rp.zero_point);
  const float hi = static_cast<float>(rp.qmax - rp.zero_point);
  const int lane = tid & 31;
  const int q = lane & 3;
  const int r0 = (tid >> 5) * 16 + (lane >> 2);
  const int sw = r0 & 7;  // also (r0 + 8) % 8
  uint8_t* row0 = stage + r0 * T::BN;
  uint8_t* row1 = row0 + 8 * T::BN;
#pragma unroll
  for (int j = 0; j < T::BN / 8; ++j) {
    const int gn = n0 + j * 8 + 2 * q;
    int32_t b0 = 0, b1 = 0;
    float s0 = rp.scale, s1 = rp.scale;
    if constexpr (!EDGE) {
      const int2 b = __ldg(reinterpret_cast<const int2*>(bias_c + gn));
      b0 = b.x;
      b1 = b.y;
      if constexpr (S == kFP32PerChannel) {
        const float2 c = __ldg(reinterpret_cast<const float2*>(p.scales + gn));
        s0 = c.x;
        s1 = c.y;
      }
    } else {
      if (gn < p.n) {
        b0 = __ldg(bias_c + gn);
        if (channels) s0 = __ldg(p.scales + gn);
      }
      if (gn + 1 < p.n) {
        b1 = __ldg(bias_c + gn + 1);
        if (channels) s1 = __ldg(p.scales + gn + 1);
      }
    }
    const uint32_t c0 = static_cast<uint32_t>(b0);
    const uint32_t c1 = static_cast<uint32_t>(b1);
    const auto y = [&](int i, uint32_t c, uint32_t zp, float s) {
      return requant_one<S>(static_cast<uint32_t>(acc[i]) + c - zp, rp, s,
                            lo, hi);
    };
    const int off = (((j >> 1) ^ sw) << 4) + ((j & 1) << 3) + 2 * q;
    *reinterpret_cast<uint16_t*>(row0 + off) = static_cast<uint16_t>(
        y(4 * j, c0, zp0, s0) | (y(4 * j + 1, c1, zp0, s1) << 8));
    *reinterpret_cast<uint16_t*>(row1 + off) = static_cast<uint16_t>(
        y(4 * j + 2, c0, zp1, s0) | (y(4 * j + 3, c1, zp1, s1) << 8));
  }
}

// The epilogue's second pass: the warpgroup's staged rows (from row m0 of
// the output, up to row_end) stored as 16-byte runs, whole words or bytes
// at a ragged or unaligned end.
template <class T>
__device__ __forceinline__ void store_stage(const uint8_t* stage, int64_t m0,
                                            int n0, int64_t row_end,
                                            const Args& p, int tid) {
  constexpr int kChunks = T::BN / 16;
#pragma unroll
  for (int i = 0; i < 64 * kChunks / 128; ++i) {
    const int idx = tid + 128 * i;
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const int64_t gm = m0 + r;
    const int gn = n0 + c * 16;
    if (gm >= row_end || gn >= p.n) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(
        stage + r * T::BN + ((c ^ (r & 7)) << 4));
    uint8_t* dst = p.out + gm * p.n + gn;
    const int len = p.n - gn < 16 ? p.n - gn : 16;
    if (len == 16 && reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        if (b < len) {
          dst[b] = static_cast<uint8_t>(words[b / 4] >> (8 * (b % 4)));
        }
      }
    }
  }
}

// The first pass of the epilogue for a warpgroup's 64 rows: the scheme
// chosen once, the fast path where the tile lies within N with c (and the
// scales) 8-byte aligned.
template <class T>
__device__ __forceinline__ void epilogue_rows(const int32_t (&acc)[T::BN / 2],
                                              const int32_t (&rs)[4],
                                              bool row_sums, uint8_t* stage,
                                              int n0, const int32_t* bias_c,
                                              const Args& p, int tid) {
  const uint32_t kzp = static_cast<uint32_t>(p.kzp_biased);
  const uint32_t zp0 = row_sums ? kzp * static_cast<uint32_t>(rs[0]) : 0u;
  const uint32_t zp1 = row_sums ? kzp * static_cast<uint32_t>(rs[2]) : 0u;
  if (n0 + T::BN > p.n || !p.pairs) {
    stage_tile<T, -1, true>(acc, zp0, zp1, stage, n0, bias_c, p, tid);
    return;
  }
  switch (p.rp.scheme) {
    case kQ31:
      stage_tile<T, kQ31, false>(acc, zp0, zp1, stage, n0, bias_c, p,
                                 tid);
      break;
    case kFP32:
      stage_tile<T, kFP32, false>(acc, zp0, zp1, stage, n0, bias_c, p,
                                  tid);
      break;
    case kPrecise:
      stage_tile<T, kPrecise, false>(acc, zp0, zp1, stage, n0, bias_c, p,
                                     tid);
      break;
    case kGemmlowp:
      stage_tile<T, kGemmlowp, false>(acc, zp0, zp1, stage, n0, bias_c, p,
                                      tid);
      break;
    default:
      stage_tile<T, kFP32PerChannel, false>(acc, zp0, zp1, stage, n0,
                                            bias_c, p, tid);
  }
}

// Tile `tile` of the walk.  The plain instance walks the M x N tiles
// N-block fastest; the grouped one walks each expert's live tiles in turn,
// its tile counts `start` (start[e] tiles before expert e) read from
// counts once a block.
template <class T, bool kGrouped>
__device__ __forceinline__ TileAt tile_at(const Args& p, int tile,
                                          const int* start) {
  if constexpr (!kGrouped) {
    const int n0 = (tile % p.tiles_n) * T::BN;
    return {(tile / p.tiles_n) * BM, n0, n0, p.bias_c, p.m};
  } else {
    int e = 0;
    while (tile >= start[e + 1]) ++e;
    const int local = tile - start[e];
    const int n0 = (local % p.tiles_n) * T::BN;
    const int seg = e * p.cap;
    return {seg + (local / p.tiles_n) * BM, n0, e * p.n + n0,
            p.bias_c + static_cast<int64_t>(e) * p.n,
            seg + __ldg(p.counts + e)};
  }
}

// One block of the persistent grid; `raw` is the kernel's dynamic shared
// memory (T::kSmemBytes).  kGrouped: the grouped instance, whose tiles are
// the experts' live ones (tile_at), with `start` kMaxExperts + 1 ints of
// the kernel's shared memory.
template <class T, bool kGrouped = false>
__device__ __forceinline__ void run(const Args& p, uint8_t* raw,
                                    int* start = nullptr) {
  uint8_t* ring = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  uint8_t* ones = ring + T::kStages * T::kStageBytes;
  uint8_t* out_stage = ones + T::kOnesBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(out_stage + T::kOutBytes);
  uint64_t* empty = full + T::kStages;
  const int wg = threadIdx.x >> 7;
  const int ksteps = (p.kp + kStepBytes - 1) / kStepBytes;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < T::kOnesBytes / 16; i += kThreads) {
    reinterpret_cast<uint4*>(ones)[i] =
        make_uint4(0x01010101u, 0x01010101u, 0x01010101u, 0x01010101u);
  }
  if constexpr (kGrouped) {
    if (threadIdx.x == 0) {
      start[0] = 0;
      for (int e = 0; e < p.experts; ++e) {
        start[e + 1] = start[e] + (__ldg(p.counts + e) + BM - 1) / BM *
                                      p.tiles_n;
      }
    }
  }
  // The ones were written by the generic proxy; wgmma reads them through
  // the async proxy.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int tiles = kGrouped ? start[p.experts] : p.tiles;

  if (wg == 2) {
    // The producer: one thread issues every load of the block's tiles.
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      prefetch_map(&p.a_map);
      prefetch_map(&p.w_map);
      int s = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const TileAt at = tile_at<T, kGrouped>(p, tile, start);
        for (int ks = 0; ks < ksteps; ++ks) {
          mbar_wait(empty + s, phase ^ 1);
          uint8_t* sa = ring + s * T::kStageBytes;
          mbar_expect_tx(full + s, T::kStageBytes);
          tma_load(sa, &p.a_map, full + s, ks * kStepBytes, at.m0);
          tma_load(sa + T::kABytes, &p.w_map, full + s, ks * kStepBytes,
                   at.w_row);
          if (++s == T::kStages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // A consumer: 64 rows of every tile of the block.
    setmaxnreg_inc<kConsumerRegs>();
    const int tid = threadIdx.x & 127;
    const int lane = threadIdx.x & 31;
    const bool row_sums = p.kzp_biased != 0;
    const uint64_t ones_desc = sw128_desc(ones);
    uint8_t* stage = out_stage + wg * 64 * T::BN;
    int32_t acc[T::BN / 2];
    int32_t rs[4];
#pragma unroll
    for (int i = 0; i < T::BN / 2; ++i) acc[i] = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) rs[i] = 0;
    int s = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const TileAt at = tile_at<T, kGrouped>(p, tile, start);
      int prev = 0;
      for (int ks = 0; ks < ksteps; ++ks) {
        mbar_wait(full + s, phase);
        const uint8_t* sa = ring + s * T::kStageBytes;
        const uint64_t da = sw128_desc(sa + wg * 64 * kStepBytes);
        const uint64_t db = sw128_desc(sa + T::kABytes);
        fence_operands(acc);
        fence_operands(rs);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kStepBytes / 32; ++kk) {
          mma_u8s8<T::BN>(acc, da + 2 * kk, db + 2 * kk, ks > 0 || kk > 0);
        }
        if (row_sums) {
#pragma unroll
          for (int kk = 0; kk < kStepBytes / 32; ++kk) {
            mma_u8s8<8>(rs, da + 2 * kk, ones_desc + 2 * kk,
                        ks > 0 || kk > 0);
          }
        }
        wgmma_commit();
        fence_operands(acc);
        fence_operands(rs);
        if (ks > 0) {
          // The previous stage's products are done: release it.
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(empty + prev);
          __syncwarp();
        }
        prev = s;
        if (++s == T::kStages) {
          s = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_operands(acc);
      fence_operands(rs);
      if (lane == 0) mbar_arrive(empty + prev);
      __syncwarp();
      warpgroup_sync(1 + wg);  // the last tile's rows are stored
      epilogue_rows<T>(acc, rs, row_sums, stage, at.n0, at.bias, p, tid);
      warpgroup_sync(1 + wg);
      store_stage<T>(stage, at.m0 + 64 * wg, at.n0, at.row_end, p, tid);
    }
  }
}

// The host side.  cuTensorMapEncodeTiled is a driver function; it is
// looked up through the runtime (cudaGetDriverEntryPoint), so the library
// links against nothing more than the runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;  // a race only looks it up twice
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &sym, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(sym);
    }
  }
  return fn;
}

// The map of a row-major uint8 [rows, cols] matrix (cols a multiple of 16,
// base 16-byte aligned) in boxes of 128 bytes x box_rows, 128-byte
// swizzle, zero outside the matrix.
inline bool encode_rows(CUtensorMap* map, const void* base, int64_t cols,
                        int64_t rows, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {kStepBytes, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace wgmma
}  // namespace qnn
