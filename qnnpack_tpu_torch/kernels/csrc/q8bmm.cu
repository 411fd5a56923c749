// q8bmm: batched uint8 A [G, M, K] x uint8 B [G, K, N] -> uint8 [G, M, N],
// on strided operands, with Hopper's int8 tensor cores.
//
// The port of qnnpack_tpu/nn/gemm.py:q8bmm (an XLA op in the JAX package,
// with no Pallas form): both operands are activations, so neither side is
// prepacked and both zero points are dynamic terms of the epilogue.
//
//   acc[g, m, n] = sum_k A B - zb sum_k A - za sum_k B + K za zb   (mod 2^32)
//   out[g, m, n] = requantize(acc[g, m, n])   (any scheme, in registers)
//
// with A, B, za and zb the raw uint8 values.  That is the reference's
// sum (A' - za')(B' - zb') on biased int8, since A' - za' = A - za, so the
// operands are not rebiased: mma.sync m16n8k32 .u8.u8 takes them as they lie
// in memory, and their copies into shared memory are pure cp.async.  The
// row sum (zb != 0) is one more mma per 32-deep slice against a B fragment
// of ones, the column sum (za != 0) one against an A fragment of ones; each
// starts from zero and is added in uint32, so neither can overflow.  A
// u8 x u8 product chain passes 2^31 past K = 33,025: every int32 mma chain
// stops at 32,768 of K, and the chains are added in uint32.
//
// Operands are views (kernels/q8bmm.py decides the layout): A has K at
// stride 1; B is K-major (K at stride 1: each column's K bytes contiguous,
// BERT's key view) or N-major (N at stride 1: BERT's value view and any
// contiguous B); the output has N at stride 1 and any row stride, so BERT's
// context lands in its [B, S, H] buffer.  The batch index is z = z0 * g1 +
// z1 with a stride for each part, which covers [B, heads, ...] views.
//
// What bounds it on this card: BERT's attention products are small per
// batch entry (scores 128 x 64 x 128, context 128 x 128 x 64) and many
// (G = batch x 12 heads).  At batch 128 the 24 launches move 50.3 MB each
// (each input byte read once, each output byte written once), 0.361 ms at
// 3.35 TB/s, and do 77 G int8 operations, 0.039 ms at 1,979 TOP/s: bytes
// bound them.  Design: the copies stay wide and asynchronous, and enough
// blocks are in flight to cover their latency.
//   - One block computes a 128 x 64 output tile of one batch entry (8 warps
//     of 32 x 32), looping over batch entries past gridDim.z's 65,535.
//   - A and a K-major B go into shared memory by 16-byte cp.async (8, 4 or
//     1 bytes where the base, a stride or K is not a multiple of 16), into
//     rows padded to 80 bytes so that ldmatrix reads are conflict-free.
//   - An N-major B is read a word from each of four K rows a thread, the
//     4 x 4 bytes are transposed by __byte_perm, and the four K-major words
//     are stored to shared memory: thread t takes K quad t % 16 and N quad
//     t / 16, so each store instruction of a warp hits 32 distinct banks.
//     The global loads for step t + 1 are issued before step t's products
//     and stored after them.
//   - Two ring stages of 64 bytes of K; 35 KB of shared memory a block
//     (the epilogue's int32 tile reuses the ring).  The two instances of
//     the main paths (16-byte copies, K <= 32,768) take at most 85
//     registers, so three blocks share an SM; the generic instances, off
//     BERT's path, are left all the registers they ask for.
//   - The epilogue stages acc - zb * rowsum - za * colsum + K za zb in
//     shared memory; each thread then requantizes 16 columns of a row and
//     stores them with one 16-byte store where the address allows.
//
// MiMo-V2-Flash's masked attention is a kernel of its own,
// csrc/q8attn_masked.cu.
#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"
#include "imma_tile.cuh"

namespace {

namespace im = qnn::imma;

constexpr int kBM = 128;
constexpr int kBN = 64;
constexpr int kStep = 64;            // bytes of K a ring stage
constexpr int kPitch = kStep + 16;   // shared row pitch
constexpr int kThreads = 256;
constexpr int kWN = 2;               // warps along N (4 along M)
constexpr int kWarpRows = 32;
constexpr int kWarpCols = 32;
constexpr int kMT = kWarpRows / 16;  // m16 slices a warp
constexpr int kNT = kWarpCols / 8;   // n8 slices a warp
constexpr int kStageBytes = (kBM + kBN) * kPitch;
constexpr int kRingBytes = 2 * kStageBytes;
constexpr int kAccPitch = kBN + 4;   // uint32 staging row pitch
constexpr int kSmemBytes = kBM * kAccPitch * 4 > kRingBytes
                               ? kBM * kAccPitch * 4
                               : kRingBytes;
constexpr int kChainSteps = 32768 / kStep;  // K steps an int32 chain holds
constexpr uint32_t kOnes = 0x01010101u;
static_assert(kBN * kStep == kThreads * 16,
              "an N-major B stage is one 4 x 4 block a thread");

struct BmmArgs {
  const uint8_t* a;
  const uint8_t* b;
  const float* scales;
  uint8_t* out;
  int64_t g, g1;  // batch entries; z = z0 * g1 + z1
  int64_t sa0, sa1, lda;
  int64_t sb0, sb1, ldb;  // ldb: the stride of N (K-major) or of K
  int64_t so0, so1, ldo;
  int m, n, k, za, zb;
  int wa, wb;  // copy widths of A and B
  qnn::Requant rp;
};

// c += a (16 x 32 uint8, row) * b (32 x 8 uint8, col), int32.
__device__ __forceinline__ void mma_u8u8(int32_t (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a * b from a zero accumulator: one 32-deep slice of a row or column
// sum (at most 32 * 255).
__device__ __forceinline__ void mma_u8u8_fresh(int32_t (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(0));
}

// R rows of 64 bytes of K from k0 on; row r at base + r * ld.  Rows past
// `rows` and bytes past K are zero-filled (K % W == 0: whole chunks only).
template <int R, int W>
__device__ __forceinline__ void load_rows(uint8_t* s, const uint8_t* base,
                                          int64_t ld, int rows, int k,
                                          int k0) {
  constexpr int kPerRow = kStep / W;
  constexpr int kCount = R * kPerRow / kThreads;
  // Unrolled only for the wide copies: the byte loop's addresses would
  // otherwise be hoisted out of the K loop into registers.
#pragma unroll(W >= 8 ? kCount : 1)
  for (int j = 0; j < kCount; ++j) {
    const int idx = threadIdx.x + j * kThreads;
    const int r = idx / kPerRow;
    const int col = (idx % kPerRow) * W;
    const bool ok = r < rows && k0 + col < k;
    im::copy_in<W>(s + r * kPitch + col, ok ? base + r * ld + k0 + col : base,
                   ok);
  }
}

template <int R, bool kFast>
__device__ __forceinline__ void load_rows_w(uint8_t* s, const uint8_t* base,
                                            int64_t ld, int rows, int k,
                                            int k0, int w) {
  if constexpr (kFast) {
    load_rows<R, 16>(s, base, ld, rows, k, k0);
  } else {
    switch (w) {
      case 16:
        load_rows<R, 16>(s, base, ld, rows, k, k0);
        break;
      case 8:
        load_rows<R, 8>(s, base, ld, rows, k, k0);
        break;
      case 4:
        load_rows<R, 4>(s, base, ld, rows, k, k0);
        break;
      default:
        load_rows<R, 1>(s, base, ld, rows, k, k0);
    }
  }
}

// An N-major B: this thread's 4 K rows x 4 columns of the step at k0, one
// word a row (W = 4: the base, the strides and N are multiples of 4) or
// byte by byte (W = 1); zero past K and past `cols`.
template <int W>
__device__ __forceinline__ void load_bt(uint32_t (&v)[4], const uint8_t* base,
                                        int64_t ld, int cols, int k, int k0) {
  const int kq = (threadIdx.x % 16) * 4;
  const int nq = (threadIdx.x / 16) * 4;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gk = k0 + kq + r;
    const uint8_t* src = base + gk * ld + nq;
    if constexpr (W == 4) {
      v[r] = gk < k && nq < cols
                 ? __ldg(reinterpret_cast<const unsigned int*>(src))
                 : 0u;
    } else {
      uint32_t word = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (gk < k && nq + c < cols) {
          word |= static_cast<uint32_t>(src[c]) << (8 * c);
        }
      }
      v[r] = word;
    }
  }
}

// The 4 x 4 byte transpose of load_bt's words, stored K-major: column
// nq + c gets K bytes kq .. kq + 3.
__device__ __forceinline__ void store_bt(uint8_t* sb, const uint32_t (&v)[4]) {
  const int kq = (threadIdx.x % 16) * 4;
  const int nq = (threadIdx.x / 16) * 4;
  const uint32_t t0 = __byte_perm(v[0], v[1], 0x5140);
  const uint32_t t1 = __byte_perm(v[0], v[1], 0x7362);
  const uint32_t t2 = __byte_perm(v[2], v[3], 0x5140);
  const uint32_t t3 = __byte_perm(v[2], v[3], 0x7362);
  const uint32_t col[4] = {__byte_perm(t0, t2, 0x5410),
                           __byte_perm(t0, t2, 0x7632),
                           __byte_perm(t1, t3, 0x5410),
                           __byte_perm(t1, t3, 0x7632)};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    *reinterpret_cast<uint32_t*>(sb + (nq + c) * kPitch + kq) = col[c];
  }
}

// A warp's sums.  c[i][j][h * 2 + e] is row i * 16 + lane / 4 + 8 h, column
// j * 8 + 2 (lane % 4) + e of the warp's tile; rs[i][h] that row's sum of
// A, cs[j][e] that column's sum of B.
struct Frag {
  int32_t c[kMT][kNT][4];
};

__device__ __forceinline__ void compute_stage(const uint8_t* sa,
                                              const uint8_t* sb, int warp_m,
                                              int warp_n, int lane,
                                              bool row_sums, bool col_sums,
                                              Frag& acc, uint32_t (&rs)[kMT][2],
                                              uint32_t (&cs)[kNT][2]) {
  const uint32_t ones[4] = {kOnes, kOnes, kOnes, kOnes};
#pragma unroll
  for (int kk = 0; kk < kStep; kk += 32) {
    uint32_t af[kMT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      const int row = warp_m * kWarpRows + i * 16 + (lane & 15);
      im::ldmatrix_x4(af[i], sa + row * kPitch + kk + (lane >> 4) * 16);
    }
#pragma unroll
    for (int j = 0; j < kNT; j += 2) {
      const int row =
          warp_n * kWarpCols + j * 8 + (lane & 7) + ((lane >> 4) << 3);
      uint32_t b[4];
      im::ldmatrix_x4(b, sb + row * kPitch + kk + ((lane >> 3) & 1) * 16);
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        mma_u8u8(acc.c[i][j], af[i], b[0], b[1]);
        mma_u8u8(acc.c[i][j + 1], af[i], b[2], b[3]);
      }
      if (col_sums) {
        int32_t t[4];
        mma_u8u8_fresh(t, ones, b[0], b[1]);
        cs[j][0] += static_cast<uint32_t>(t[0]);
        cs[j][1] += static_cast<uint32_t>(t[1]);
        mma_u8u8_fresh(t, ones, b[2], b[3]);
        cs[j + 1][0] += static_cast<uint32_t>(t[0]);
        cs[j + 1][1] += static_cast<uint32_t>(t[1]);
      }
    }
    if (row_sums) {
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        int32_t t[4];
        mma_u8u8_fresh(t, af[i], kOnes, kOnes);
        rs[i][0] += static_cast<uint32_t>(t[0]);
        rs[i][1] += static_cast<uint32_t>(t[2]);
      }
    }
  }
}

// Each thread takes 16 columns of a staged row, requantizes them with
// scheme S (fixed at compile time, so requantize()'s switch folds away) and
// stores the 16 bytes.
template <int S>
__device__ __forceinline__ void store_rows(const uint32_t* stage, int m0,
                                           int n0, const BmmArgs& p,
                                           uint8_t* __restrict__ out) {
  qnn::Requant rp = p.rp;
  rp.scheme = S;
  constexpr int kSegs = kBN / 16;
  for (int idx = threadIdx.x; idx < kBM * kSegs; idx += kThreads) {
    const int r = idx / kSegs;
    const int c = (idx % kSegs) * 16;
    const int gm = m0 + r;
    const int gn = n0 + c;
    if (gm >= p.m || gn >= p.n) continue;
    const int len = p.n - gn < 16 ? p.n - gn : 16;
    uint32_t v[16];
    const uint4* src =
        reinterpret_cast<const uint4*>(stage + r * kAccPitch + c);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 x = src[q];
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
    uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      const float cs = S == qnn::kFP32PerChannel && b < len
                           ? __ldg(p.scales + gn + b)
                           : rp.scale;
      words[b / 4] |=
          static_cast<uint32_t>(qnn::requantize(static_cast<int32_t>(v[b]),
                                                rp, cs))
          << (8 * (b % 4));
    }
    uint8_t* dst = out + gm * p.ldo + gn;
    const auto addr = reinterpret_cast<uintptr_t>(dst);
    if (len == 16 && addr % 16 == 0) {
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(words[0], words[1], words[2], words[3]);
    } else {
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

// One block's tiles: the output tile (m0, n0) of every batch entry the
// block takes.  kKMajor: B has K at stride 1 (else N).  kFast: 16-byte
// copies of A and B (word loads of an N-major B) and K <= 32,768, so one
// int32 chain holds the whole product; otherwise the copy widths are read
// from the arguments and the chains are added in uint32 every 32,768 of K.
template <bool kKMajor, bool kFast>
__device__ __forceinline__ void bmm_tiles(const BmmArgs& p, uint8_t* smem,
                                          int m0, int n0) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warp_m = warp / kWN;
  const int warp_n = warp % kWN;
  const int nsteps = (p.k + kStep - 1) / kStep;
  const uint32_t kzz = static_cast<uint32_t>(p.k) *
                       static_cast<uint32_t>(p.za) *
                       static_cast<uint32_t>(p.zb);
  const bool row_sums = p.zb != 0;
  const bool col_sums = p.za != 0;

  for (int64_t z = blockIdx.z; z < p.g; z += gridDim.z) {
    const int64_t z0 = z / p.g1;
    const int64_t z1 = z % p.g1;
    const uint8_t* a = p.a + z0 * p.sa0 + z1 * p.sa1 + m0 * p.lda;
    const uint8_t* b = p.b + z0 * p.sb0 + z1 * p.sb1 +
                       (kKMajor ? n0 * p.ldb : static_cast<int64_t>(n0));
    uint8_t* out = p.out + z0 * p.so0 + z1 * p.so1;

    Frag acc;
    Frag total;  // kFast: unused, acc is the total
    uint32_t rs[kMT][2];
    uint32_t cs[kNT][2];
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      rs[i][0] = rs[i][1] = 0u;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc.c[i][j][e] = total.c[i][j][e] = 0;
      }
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) cs[j][0] = cs[j][1] = 0u;

    // One step's copies into ring slot `slot`: A and a K-major B by
    // cp.async; an N-major B into `bt`, stored after the step's products.
    uint32_t bt[4];
    auto load = [&](int slot, int step) {
      uint8_t* sa = smem + slot * kStageBytes;
      const int k0 = step * kStep;
      load_rows_w<kBM, kFast>(sa, a, p.lda, p.m - m0, p.k, k0, p.wa);
      if constexpr (kKMajor) {
        load_rows_w<kBN, kFast>(sa + kBM * kPitch, b, p.ldb, p.n - n0, p.k,
                                k0, p.wb);
      } else if (kFast || p.wb == 4) {
        load_bt<4>(bt, b, p.ldb, p.n - n0, p.k, k0);
      } else {
        load_bt<1>(bt, b, p.ldb, p.n - n0, p.k, k0);
      }
    };
    if (nsteps > 0) {
      load(0, 0);
      if constexpr (!kKMajor) store_bt(smem + kBM * kPitch, bt);
    }
    im::cp_async_commit();
    for (int t = 0; t < nsteps; ++t) {
      im::cp_async_wait<0>();
      // Step t's stage is complete and visible, and every warp is done
      // with step t - 1, whose slot the next copies refill.
      __syncthreads();
      const bool more = t + 1 < nsteps;
      if (more) load((t + 1) & 1, t + 1);
      im::cp_async_commit();
      uint8_t* sa = smem + (t & 1) * kStageBytes;
      compute_stage(sa, sa + kBM * kPitch, warp_m, warp_n, lane, row_sums,
                    col_sums, acc, rs, cs);
      if constexpr (!kKMajor) {
        if (more) {
          store_bt(smem + ((t + 1) & 1) * kStageBytes + kBM * kPitch, bt);
        }
      }
      if constexpr (!kFast) {
        if ((t + 1) % kChainSteps == 0 || !more) {
#pragma unroll
          for (int i = 0; i < kMT; ++i) {
#pragma unroll
            for (int j = 0; j < kNT; ++j) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                total.c[i][j][e] = qnn::wrap_add(total.c[i][j][e],
                                                 acc.c[i][j][e]);
                acc.c[i][j][e] = 0;
              }
            }
          }
        }
      }
    }
    im::cp_async_wait<0>();
    __syncthreads();  // the staged tile below reuses the ring

    const Frag& sum = kFast ? acc : total;
    uint32_t* stage = reinterpret_cast<uint32_t*>(smem);
    const int row0 = warp_m * kWarpRows + (lane >> 2);
    const int col0 = warp_n * kWarpCols + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + i * 16 + 8 * h;
        const uint32_t row_term = kzz - static_cast<uint32_t>(p.zb) * rs[i][h];
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          *reinterpret_cast<uint2*>(
              &stage[row * kAccPitch + col0 + j * 8]) = make_uint2(
              static_cast<uint32_t>(sum.c[i][j][2 * h]) + row_term -
                  static_cast<uint32_t>(p.za) * cs[j][0],
              static_cast<uint32_t>(sum.c[i][j][2 * h + 1]) + row_term -
                  static_cast<uint32_t>(p.za) * cs[j][1]);
        }
      }
    }
    __syncthreads();
    switch (p.rp.scheme) {
      case qnn::kQ31:
        store_rows<qnn::kQ31>(stage, m0, n0, p, out);
        break;
      case qnn::kFP32:
        store_rows<qnn::kFP32>(stage, m0, n0, p, out);
        break;
      case qnn::kPrecise:
        store_rows<qnn::kPrecise>(stage, m0, n0, p, out);
        break;
      case qnn::kGemmlowp:
        store_rows<qnn::kGemmlowp>(stage, m0, n0, p, out);
        break;
      default:
        store_rows<qnn::kFP32PerChannel>(stage, m0, n0, p, out);
    }
    __syncthreads();  // the next batch entry's copies reuse the stage
  }
}

template <bool kKMajor, bool kFast>
__global__ void __launch_bounds__(kThreads, kFast ? 3 : 1)
    q8bmm_kernel(const BmmArgs p) {
  __shared__ __align__(16) uint8_t smem[kSmemBytes];
  bmm_tiles<kKMajor, kFast>(p, smem, blockIdx.x * kBM, blockIdx.y * kBN);
}

template <bool kKMajor>
cudaError_t launch(const BmmArgs& p, bool fast, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((p.m + kBM - 1) / kBM),
                  static_cast<unsigned>((p.n + kBN - 1) / kBN),
                  static_cast<unsigned>(p.g < 65535 ? p.g : 65535));
  if (fast) {
    q8bmm_kernel<kKMajor, true><<<grid, kThreads, 0, stream>>>(p);
  } else {
    q8bmm_kernel<kKMajor, false><<<grid, kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// Element (z0 * g1 + z1, i, j) of A is at a + z0 sa0 + z1 sa1 + i lda + j;
// of B at b + z0 sb0 + z1 sb1 + i + j ldb (b_kmajor) or + i ldb + j; of the
// output at out + z0 so0 + z1 so1 + i ldo + j.  The wrapper
// (kernels/q8bmm.py) picks the layout; za and zb are the raw uint8 zero
// points.
extern "C" int qnn_q8bmm(int device, const void* a, const void* b,
                         const void* scales, void* out, int64_t g, int64_t g1,
                         int m, int n, int k, int64_t sa0, int64_t sa1,
                         int64_t lda, int64_t sb0, int64_t sb1, int64_t ldb,
                         int b_kmajor, int64_t so0, int64_t so1, int64_t ldo,
                         int za, int zb, int scheme, int multiplier,
                         int shift, int zero_point, int qmin, int qmax,
                         float scale, void* stream) {
  const qnn::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) {
    return static_cast<int>(guard.error());
  }
  if (g < 0 || g1 < 1 || g % g1 != 0 || m < 0 || n < 0 || k < 0 ||
      (b_kmajor != 0 && b_kmajor != 1) || za < 0 || za > 255 || zb < 0 ||
      zb > 255 || sa0 < 0 || sa1 < 0 || lda < 0 || sb0 < 0 || sb1 < 0 ||
      ldb < 0 || so0 < 0 || so1 < 0 || (m > 1 && ldo < n) ||
      (n + kBN - 1) / kBN > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (g == 0 || m == 0 || n == 0) return 0;
  // Copy widths: the largest that the base and every stride of the copied
  // rows (and K, or N for the N-major word loads) are multiples of.
  const int wa = im::copy_width(a, sa0 | sa1 | lda | k);
  const int wb = b_kmajor ? im::copy_width(b, sb0 | sb1 | ldb | k)
                          : (im::copy_width(b, sb0 | sb1 | ldb | n) >= 4 ? 4
                                                                         : 1);
  const BmmArgs p{static_cast<const uint8_t*>(a),
                  static_cast<const uint8_t*>(b),
                  static_cast<const float*>(scales),
                  static_cast<uint8_t*>(out),
                  g, g1, sa0, sa1, lda, sb0, sb1, ldb, so0, so1, ldo,
                  m, n, k, za, zb, wa, wb,
                  qnn::Requant{scheme, multiplier, shift, zero_point, qmin,
                               qmax, scale}};
  const bool fast =
      wa == 16 && wb == (b_kmajor ? 16 : 4) && k <= kChainSteps * kStep;
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(b_kmajor ? launch<true>(p, fast, s)
                                   : launch<false>(p, fast, s));
}
