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
// The masked instances (q8bmm_masked_kernel, kernels/q8bmm.py
// q8bmm_masked_cuda) are attention's products under a causal or banded
// mask with grouped-query attention (B's head z1 / grp): the scores leave
// out every tile with no pair of the mask (the causal triangle is walked
// tile by tile; a 128-key band takes 4 or 5 of a row tile's N tiles), the
// context skips the K steps outside its rows' keys and sets the
// probabilities outside each row's mask to za in shared memory.  They
// share bmm_tiles with q8bmm_kernel, whose instances compile with the mask
// and the head group folded away.  MiMo-V2-Flash's forward no longer runs
// them: they stay as the card's second witness for the fused kernel.
//
// The fused masked attention (q8bmm_masked_kernel on AttnArgs,
// kernels/q8bmm.py q8attn_masked_cuda) computes a layer's scores, masked
// softargmax and context in one launch, and never writes the [B, H, S, S]
// scores (17.2 GB at MiMo-V2-Flash's b4 full layer; the unfused path sent
// each through device memory three times).  Per row, over its valid keys:
//
//   m = max(x_j, sink)          x_j the requantized score q_i k_j
//   e_j = t[x_j + 255 - m]      s = sum_j e_j + t[sink + 255 - m]  (mod 2^32)
//   p_j = min((256 e_j + s / 2) / s, 255)
//   ctx = requant(sum_j p_j (v_j - 128))
//
// byte for byte the unfused kernels' result.  Flash attention's online
// rescaling (a running max, the partial sum and product rescaled when it
// rises) is not exact here: the table's entries are rounded, so
// t[x + 255 - m'] is no fixed multiple of t[x + 255 - m], and each p_j's
// rounding needs the final m and s.  So both are known before the first
// probability is formed: three sweeps over the row's key tiles recompute
// the scores on the tensor cores, the first taking the max of the int32
// accumulators (requantization does not decrease, so the max score is the
// max accumulator's, requantized once), the second summing the table's
// entries, the third forming the probabilities in registers as the A
// operand of the context's product.  Both statistics stay in the registers
// of the four threads that hold a row of wgmma's accumulator fragment
// (one more q k product than a two-sweep design with a per-row histogram
// of the scores in shared memory, which would cost a shared-memory atomic
// a score and 64 KB a warpgroup).  Design, for the card:
//   - one block takes 64 query rows of 4 heads that share a key/value head
//     (a warpgroup a head), and walks only the key tiles that hold a pair
//     of the mask (the causal triangle, or the band); blocks of the last
//     query rows, which hold the most keys, start first;
//   - the scores are wgmma m64n32k32 .s8.u8 products of Q' = q - 128 (in
//     shared memory) and raw K tiles (cp.async, two stages); an
//     accumulator plus the row's 1.5 * 2^23 - 128 sum q' is the float bits
//     of the exact sum (q - 128)(k - 128), so that the fp32
//     requantization needs no integer conversion;
//   - each K tile's keys are placed so that the accumulator fragment of
//     the scores is the A fragment of the probabilities: no shuffles;
//   - V tiles are fetched as they lie (cp.async) and transposed to
//     K-major int8 (v - 128) in shared memory, the B operand of the
//     context's wgmma m64n128k32 .u8.s8, whose probabilities come from
//     registers;
//   - the softargmax table has 16 copies in shared memory, one for each
//     lane of a half-warp, and each probability's divide is a
//     multiply-high by the row's reciprocal and one correction.
// What bounds it on the card: the arithmetic of the second and third
// sweeps (about 9 and 15 instructions a score) beside the three products,
// not the bytes.  At MiMo-V2-Flash's b4 x 8,192 it takes 27.1 ms a full
// layer and 2.8 ms a window layer, against 53.8 and 3.6 ms for the three
// unfused kernels (H100 80GB HBM3, 700 W); without the sweeps' arithmetic
// a full layer takes 13.9 ms.
#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"
#include "imma_tile.cuh"
#include "wgmma_tile.cuh"

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
  int grp;     // the masked instances: query heads a key/value head
  int window;  // the masked instances: 0 causal, else the band's keys
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

// The masks of q8bmm_masked_kernel (kernels/q8bmm.py SCORES, CONTEXT): the
// pairs (query i, key j) with j <= i, and with window W > 0 j > i - W.
// kNoMask is q8bmm_kernel's plain product.
enum Mask { kNoMask = 0, kScores = 1, kContext = 2 };

// The A tile of a context stage (the probabilities, K = the keys) with each
// byte outside its row's mask set to za, so that it adds nothing (and each
// past K, where B is zero-filled, to 0): rows m0 .., keys k0 .. k0 + kStep
// - 1.  32 bytes a thread.
__device__ __forceinline__ void mask_stage(uint8_t* sa, int m0, int k0,
                                           int k, int window, uint8_t za) {
  constexpr int kPerRow = kStep / 16;
  for (int idx = threadIdx.x; idx < kBM * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow;
    const int c = (idx % kPerRow) * 16;
    const int i = m0 + r;
    uint4* at = reinterpret_cast<uint4*>(sa + r * kPitch + c);
    uint4 v = *at;
    uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      const int j = k0 + c + b;
      if (j > i || (window > 0 && j <= i - window)) {
        const uint32_t fill = j < k ? za : 0u;
        w[b / 4] = (w[b / 4] & ~(0xFFu << (8 * (b % 4)))) |
                   (fill << (8 * (b % 4)));
      }
    }
    *at = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// One block's tiles: the output tile (m0, n0) of every batch entry the
// block takes.  kKMajor: B has K at stride 1 (else N).  kFast: 16-byte
// copies of A and B (word loads of an N-major B) and K <= 32,768, so one
// int32 chain holds the whole product; otherwise the copy widths are read
// from the arguments and the chains are added in uint32 every 32,768 of K.
// kMask: kScores leaves out the tiles with no pair of the mask (the caller
// maps the grid), kContext sums each row over its keys only (the K steps
// outside the block's rows' keys are skipped, the rest masked to za); both
// read B's head z1 / grp (grouped-query attention).
template <bool kKMajor, bool kFast, int kMask>
__device__ __forceinline__ void bmm_tiles(const BmmArgs& p, uint8_t* smem,
                                          int m0, int n0) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warp_m = warp / kWN;
  const int warp_n = warp % kWN;
  int step0 = 0;
  int nsteps = (p.k + kStep - 1) / kStep;
  uint32_t kzz = static_cast<uint32_t>(p.k) * static_cast<uint32_t>(p.za) *
                 static_cast<uint32_t>(p.zb);
  if constexpr (kMask == kContext) {
    // Rows m0 .. m0 + kBM - 1 read keys from m0 - W + 1 (or 0) to
    // m0 + kBM - 1; the steps wholly outside are skipped.
    const int lo = p.window > 0 ? max(0, m0 - p.window + 1) : 0;
    const int hi = min(p.k, m0 + kBM);
    step0 = lo / kStep;
    nsteps = (hi + kStep - 1) / kStep - step0;
    kzz = static_cast<uint32_t>(hi - step0 * kStep) *
          static_cast<uint32_t>(p.za) * static_cast<uint32_t>(p.zb);
  }
  const bool row_sums = p.zb != 0;
  const bool col_sums = p.za != 0;

  for (int64_t z = blockIdx.z; z < p.g; z += gridDim.z) {
    const int64_t z0 = z / p.g1;
    const int64_t z1 = z % p.g1;
    const int64_t zb1 = kMask == kNoMask ? z1 : z1 / p.grp;
    const uint8_t* a = p.a + z0 * p.sa0 + z1 * p.sa1 + m0 * p.lda;
    const uint8_t* b = p.b + z0 * p.sb0 + zb1 * p.sb1 +
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
      load(0, step0);
      if constexpr (!kKMajor) store_bt(smem + kBM * kPitch, bt);
    }
    im::cp_async_commit();
    for (int t = 0; t < nsteps; ++t) {
      im::cp_async_wait<0>();
      // Step t's stage is complete and visible, and every warp is done
      // with step t - 1, whose slot the next copies refill.
      __syncthreads();
      const bool more = t + 1 < nsteps;
      if (more) load((t + 1) & 1, step0 + t + 1);
      im::cp_async_commit();
      uint8_t* sa = smem + (t & 1) * kStageBytes;
      if constexpr (kMask == kContext) {
        const int k0 = (step0 + t) * kStep;
        if (k0 + kStep - 1 > m0 ||
            (p.window > 0 && k0 <= m0 + kBM - 1 - p.window)) {
          mask_stage(sa, m0, k0, p.k, p.window, static_cast<uint8_t>(p.za));
          __syncthreads();
        }
      }
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
  bmm_tiles<kKMajor, kFast, kNoMask>(p, smem, blockIdx.x * kBM,
                                     blockIdx.y * kBN);
}

// The causal scores' tiles, row tile j holding kRatio (j + 1) N tiles
// (those up to its last row): tile t of the triangle, row tile first, for
// t < kRatio J (J + 1) / 2.
constexpr int kRatio = kBM / kBN;
static_assert(kRatio == 2, "causal_tile counts two N tiles a row tile");

__device__ __forceinline__ void causal_tile(int64_t t, int& mt, int& nt) {
  // j (j + 1) <= t < (j + 1) (j + 2): j = floor((sqrt(4 t + 1) - 1) / 2).
  int64_t j = static_cast<int64_t>((sqrt(4.0 * t + 1.0) - 1.0) * 0.5);
  while (j * (j + 1) > t) --j;
  while ((j + 1) * (j + 2) <= t) ++j;
  mt = static_cast<int>(j);
  nt = static_cast<int>(t - j * (j + 1));
}

// The masked instances (16-byte copies, K <= 32,768).  kScores, causal:
// blockIdx.x walks the triangle of tiles that hold a pair of the mask
// (causal_tile), so no block is launched for a tile past the diagonal;
// banded: blockIdx.y is the row tile and blockIdx.x counts its N tiles from
// the first that holds a key of row m0's band, and a tile past the block's
// last row is left out.  kContext: blockIdx.y the row tile, blockIdx.x the
// N tile, so the blocks that share an A tile run together and it is read
// from L2 once.
template <bool kKMajor, int kMask>
__global__ void __launch_bounds__(kThreads, 3)
    q8bmm_masked_kernel(const BmmArgs p) {
  __shared__ __align__(16) uint8_t smem[kSmemBytes];
  int m0 = blockIdx.y * kBM;
  int n0 = blockIdx.x * kBN;
  if constexpr (kMask == kScores) {
    if (p.window > 0) {
      n0 += max(0, m0 - p.window + 1) / kBN * kBN;
    } else {
      int mt, nt;
      causal_tile(blockIdx.x, mt, nt);
      m0 = mt * kBM;
      n0 = nt * kBN;
    }
    if (n0 > m0 + kBM - 1 || n0 >= p.n || m0 >= p.m) return;
  }
  bmm_tiles<kKMajor, true, kMask>(p, smem, m0, n0);
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

// ---------------------------------------------------------------------------
// The fused masked attention (kernels/q8bmm.py q8attn_masked_cuda): the
// scores, the masked softargmax and the context of one layer in one launch,
// an instance of q8bmm_masked_kernel on AttnArgs (the header says why the
// row's max and sum take sweeps of their own).
namespace attn {

namespace wg = qnn::wgmma;

constexpr int kRows = 64;        // query rows a warpgroup: one head
constexpr int kKeys = 64;        // keys a tile
constexpr int kDv = 128;         // the value width, the context's N
constexpr int kCopies = 16;      // of the softargmax table, one a lane % 16
constexpr int kEntryShift = 6;   // log2 of an entry's copies' bytes
constexpr int kTableBytes = 256 * kCopies * 4;
constexpr int kCore = 128;       // a core matrix: 8 rows of 16 bytes
constexpr int kVGroup = 4 * kCore + 16;  // 8 value columns x 64 keys, padded
constexpr int kVBytes = (kDv / 8) * kVGroup;
constexpr int kKStages = 2;
constexpr int kNs = 32;          // keys a product of the scores
constexpr int kRawPitch = kDv + 16;      // a V tile as it lies, padded
constexpr int kRawBytes = kKeys * kRawPitch;
constexpr int kVStages = 3;
constexpr int kDq = 192;         // the query and key width
constexpr int kChunks = kDq / 16;
constexpr int kTileBytes = kKeys * kDq;  // a K tile, as a Q' tile
constexpr uint32_t kSbo = 8 * kDq;       // their 8-row stride
constexpr uint32_t kMagicBits = 0x4B400000u;  // 1.5 * 2^23 as a float
constexpr float kMagic = 12582912.0f;

// Heads a block, sharing the K and V tiles: four took 10% less time than
// two at MiMo-V2-Flash's b4 full layer (the tiles are read from L2 half as
// often), one block of 512 threads an SM.
constexpr int kHeads = 4;
constexpr int kBlockThreads = 128 * kHeads;
constexpr int kBlockSmem = kTableBytes + (kHeads + kKStages) * kTileBytes +
                           kVStages * kVBytes + 2 * kRawBytes;

struct AttnArgs {
  const uint8_t* q;
  const uint8_t* k;
  const uint8_t* v;
  uint8_t* out;
  const uint32_t* lut;
  const uint8_t* sinks;   // [heads], or null
  int64_t sq0, sq1, ldq;  // q [B, H, S, dq]: batch, head and row strides
  int64_t sk0, sk1, ldk;  // k [B, Hkv, dq, S]: batch, head and key strides
  int64_t sv0, sv1, ldv;  // v [B, Hkv, S, dv]
  int64_t so0, so1, ldo;  // out [B, H, S, dv]
  int batch, grp, groups, tiles_m, s, window;
  float scale, lo, hi;    // the scores' fp32 requantization, bounds less zp
  int zp;                 // the scores' zero point
  qnn::Requant ctx;       // the context's requantization
};

// Shared-memory descriptor of a K-major tile in the no-swizzle layout:
// core matrices of 8 rows x 16 bytes, `lbo` bytes apart along K and `sbo`
// bytes apart along the rows.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void fence_words(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d (+)= Q' (64 x 32 int8, descriptor a) K (32 keys x 32 uint8, descriptor
// b): one 32-byte step of 32 keys' scores.  Fragment: d[4 j + 2 h + e] is
// row 16 warp + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e.
__device__ __forceinline__ void mma_scores32(int32_t (&d)[16], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += P (64 x 32 uint8 in registers, the A fragment of mma.sync's
// m16n8k32 a warp) V' (128 value columns x 32 keys int8, descriptor b).
__device__ __forceinline__ void mma_context(int32_t (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
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
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The key that row n of a key tile in shared memory holds.  The scores'
// column n = 8 j + 2 t + e lands in thread t's registers, and the
// probabilities' A fragment wants there keys 4 t .. 4 t + 3 and 16 + 4 t
// .. of each 32-key step; so column 8 j + 2 t + e holds key 32 (j / 4) +
// 16 (j / 2 % 2) + 4 t + 2 (j % 2) + e, and V's keys stay in order.
__device__ __forceinline__ int kappa(int n) {
  const int j = n >> 3;
  return ((j >> 2) << 5) + (((j >> 1) & 1) << 4) + (((n >> 1) & 3) << 2) +
         ((j & 1) << 1) + (n & 1);
}

// kappa of column 8 j + 2 t + e, less 4 t.
__host__ __device__ constexpr int kap(int j, int e) {
  return ((j >> 2) << 5) + (((j >> 1) & 1) << 4) + ((j & 1) << 1) + e;
}

// The bits of 1.5 * 2^23 + x, x the requantized score less its zero point
// (requant.cuh requant_one's fp32 arithmetic); `off` is 1.5 * 2^23 less
// 128 sum q' as bits, so acc + off is the float 1.5 * 2^23 + the exact
// accumulator (|acc| <= dq 2^14 <= 2^22): no integer conversion.
__device__ __forceinline__ uint32_t score_bits(int32_t acc, uint32_t off,
                                               float scale, float lo,
                                               float hi) {
  const float f =
      __fsub_rn(__uint_as_float(static_cast<uint32_t>(acc) + off), kMagic);
  const float c = fminf(fmaxf(__fmul_rn(f, scale), lo), hi);
  return __float_as_uint(__fadd_rn(c, kMagic));
}

__device__ __forceinline__ uint32_t lds(uint32_t addr) {
  uint32_t v;
  asm("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// lds that the compiler may not execute where its condition is false.
__device__ __forceinline__ uint32_t lds_if(bool ok, uint32_t addr) {
  uint32_t v = 0u;
  if (ok) asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// y = min((256 e + s / 2) / s, 255) (mod 2^32 before the divide), by a
// reciprocal a row: m = floor(2^32 / s), q0 = umulhi(num, m) is q or q - 1.
// s = 0 takes m = 2^32 - 1 and half = 255, so that q = 256 e + 255 and y
// is 255, as the reference's 0xFFFFFFFF for a zero sum.
struct Div {
  uint32_t s, neg_s, m, half;
};

__device__ __forceinline__ Div row_div(uint32_t s) {
  if (s == 0) return {0u, 0u, 0xFFFFFFFFu, 255u};
  const uint32_t q = 0xFFFFFFFFu / s;
  const uint32_t m =
      s > 1 ? q + (0xFFFFFFFFu - q * s == s - 1) : 0xFFFFFFFFu;
  return {s, 0u - s, m, s >> 1};
}

__device__ __forceinline__ uint32_t norm(uint32_t e, const Div& d) {
  const uint32_t num = e * 256u + d.half;
  const uint32_t q0 = __umulhi(num, d.m);
  const uint32_t r = num + q0 * d.neg_s;
  uint32_t q;
  asm("{\n\t.reg .u32 t;\n\t"
      "sub.cc.u32 t, %1, %2;\n\t"         // borrow = r < s
      "subc.u32 %0, %3, 0xFFFFFFFF;\n\t"  // q0 + 1 - borrow
      "}"
      : "=r"(q)
      : "r"(r), "r"(d.s), "r"(q0));
  return q < 255u ? q : 255u;
}

// A thread's two rows: lane / 4 and lane / 4 + 8 of its warp's 16.
struct Rows {
  uint32_t off[2];  // score_bits' offset
  int32_t red[2];   // sweep 1: the accumulators' max over the valid keys;
                    // sweep 2: the table's entries, summed (mod 2^32)
  uint32_t tab[2];  // the row's table address, less (bits << kEntryShift)
  Div d[2];
};

// One sweep over a warp's 16 x 64 scores `acc`: kPhase 0 takes the rows'
// max, 1 their sums, 2 their probabilities into pa (the A fragments of the
// tile's two 32-key steps).  kEdge: the tile crosses the mask, so each
// score is checked: `dist` is the row less the tile's first key less 4 t.
template <int kPhase, bool kEdge, bool kBand>
__device__ __forceinline__ void sweep(const int32_t (&acc)[16], Rows& r,
                                      uint32_t (&pa)[4],
                                      const int (&dist)[2],
                                      const AttnArgs& p) {
#pragma unroll
  for (int j = 0; j < kNs / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int32_t a = acc[4 * j + 2 * h + e];
        bool ok = true;
        if constexpr (kEdge) {
          const int dd = dist[h] - kap(j, e);
          ok = dd >= 0 && (!kBand || dd < p.window);
        }
        if constexpr (kPhase == 0) {
          if (ok) r.red[h] = max(r.red[h], a);
        } else {
          const uint32_t bits = score_bits(a, r.off[h], p.scale, p.lo, p.hi);
          // A masked score is never looked up: its index may lie past the
          // table (it can exceed the row's max).
          const uint32_t addr = r.tab[h] + (bits << kEntryShift);
          const uint32_t ev = kEdge ? lds_if(ok, addr) : lds(addr);
          if constexpr (kPhase == 1) {
            r.red[h] = static_cast<int32_t>(static_cast<uint32_t>(r.red[h]) +
                                            ev);
          } else {
            y[e] = ok ? norm(ev, r.d[h]) : 0u;
          }
        }
      }
      if constexpr (kPhase == 2) {
        // A fragment register 2 (j / 2) + h, bytes 2 (j % 2) + e: key
        // 4 t + 2 (j % 2) + e (+ 16 for j >= 2).
        const uint32_t half = y[0] | (y[1] << 8);
        uint32_t& w = pa[((j >> 1) << 1) + h];
        w = (j & 1) ? (w | (half << 16)) : half;
      }
    }
  }
}

template <int kPhase, bool kBand>
__device__ __forceinline__ void sweep_tile(bool edge,
                                           const int32_t (&acc)[16], Rows& r,
                                           uint32_t (&pa)[4],
                                           const int (&dist)[2],
                                           const AttnArgs& p) {
  if (edge) {
    sweep<kPhase, true, kBand>(acc, r, pa, dist, p);
  } else {
    sweep<kPhase, false, kBand>(acc, r, pa, dist, p);
  }
}

}  // namespace attn

// One block: 64 query rows of kHeads heads that share a key/value head (one
// warpgroup a head) of one batch entry; blocks of the last query rows,
// which hold the most keys, first.  kBand: the window's band (else causal).
// Three sweeps over the block's key tiles, each recomputing the scores
// (wgmma, Q' from shared memory) 32 keys at a time: the rows' max, their
// sums, then the probabilities in registers as the A operand of the
// context's wgmma.  K tiles by cp.async, two stages; V tiles fetched as
// they lie two iterations ahead (two raw buffers) and transposed to K-major
// int8 one ahead (three stages).
template <bool kBand>
__global__ void __launch_bounds__(attn::kBlockThreads, 1)
    q8bmm_masked_kernel(const attn::AttnArgs p) {
  using namespace attn;
  constexpr int kVBlocks = (kKeys / 4) * (kDv / 4) / kBlockThreads;
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x;
  const int wgi = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  int64_t id = blockIdx.x;
  const int hg = static_cast<int>(id % p.groups);
  id /= p.groups;
  const int b = static_cast<int>(id % p.batch);
  const int m0 = (p.tiles_m - 1 - static_cast<int>(id / p.batch)) * kRows;
  const int head = hg * kHeads + wgi;
  const int kvh = hg * kHeads / p.grp;

  uint32_t* table = reinterpret_cast<uint32_t*>(smem);
  uint8_t* qs = smem + kTableBytes;
  uint8_t* ks = qs + kHeads * kTileBytes;
  uint8_t* vs = ks + kKStages * kTileBytes;
  uint8_t* raw = vs + kVStages * kVBytes;  // two V tiles as they lie

  const int lo_key = kBand ? max(0, m0 - p.window + 1) : 0;
  const int u0 = lo_key / kKeys;
  const int ntiles = min(m0 + kRows - 1, p.s - 1) / kKeys - u0 + 1;
  const int iters = 3 * ntiles;
  const uint8_t* kb = p.k + b * p.sk0 + kvh * p.sk1;
  const uint8_t* vb = p.v + b * p.sv0 + kvh * p.sv1;

  // The K tile of key tile u into stage `stage`, key kappa(n) at row n.
  const auto load_k = [&](int u, int stage) {
    const int k0 = (u0 + u) * kKeys;
    uint8_t* dst = ks + stage * kTileBytes;
#pragma unroll
    for (int i = 0; i < (kKeys * kChunks + kBlockThreads - 1) / kBlockThreads;
         ++i) {
      const int idx = tid + kBlockThreads * i;
      if (idx >= kKeys * kChunks) break;
      const int n = idx / (8 * kChunks) * 8 + (idx & 7);
      const int kc = (idx >> 3) % kChunks;
      const int key = k0 + kappa(n);
      const bool ok = key < p.s;
      im::cp_async<16>(dst + idx * 16, ok ? kb + key * p.ldk + kc * 16 : kb,
                       ok);
    }
  };
  // A thread's 4 x 4 blocks of a V tile: keys 4 q .. 4 q + 3, columns n0
  // .. n0 + 3; a warp's stores of one column hit 32 distinct banks.
  const auto v_block = [&](int u, int& grp8, int& n0, int& c16, int& q) {
    const int bi = tid + kBlockThreads * u;
    const int lb = bi & 31;
    const int w16 = bi >> 5;
    grp8 = (lb >> 3) + 4 * (w16 & 3);
    n0 = 8 * grp8 + 4 * ((lb >> 2) & 1);
    c16 = w16 >> 2;
    q = 4 * c16 + (lb & 3);
  };
  // Key tile u's V rows as they lie into raw buffer `buf` (no commit).
  const auto load_v = [&](int u, int buf) {
    const int k0 = (u0 + u) * kKeys;
    uint8_t* dst = raw + buf * kRawBytes;
#pragma unroll
    for (int i = 0; i < kKeys * kDv / 16 / kBlockThreads; ++i) {
      const int idx = tid + kBlockThreads * i;
      const int r = idx / (kDv / 16);
      const int c = idx % (kDv / 16);
      const bool ok = k0 + r < p.s;
      im::cp_async<16>(dst + r * kRawPitch + c * 16,
                       ok ? vb + (k0 + r) * p.ldv + c * 16 : vb, ok);
    }
  };
  // Raw buffer `buf` transposed to K-major and rebiased to int8 into V
  // stage `stage`.
  const auto store_v = [&](int buf, int stage) {
    const uint8_t* src = raw + buf * kRawBytes;
    uint8_t* dst = vs + stage * kVBytes;
#pragma unroll
    for (int i = 0; i < kVBlocks; ++i) {
      int grp8, n0, c16, q;
      v_block(i, grp8, n0, c16, q);
      uint32_t vw[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        vw[r] = *reinterpret_cast<const uint32_t*>(src + (4 * q + r) *
                                                   kRawPitch + n0);
      }
      const uint32_t t0 = __byte_perm(vw[0], vw[1], 0x5140);
      const uint32_t t1 = __byte_perm(vw[0], vw[1], 0x7362);
      const uint32_t t2 = __byte_perm(vw[2], vw[3], 0x5140);
      const uint32_t t3 = __byte_perm(vw[2], vw[3], 0x7362);
      const uint32_t col[4] = {__byte_perm(t0, t2, 0x5410),
                               __byte_perm(t0, t2, 0x7632),
                               __byte_perm(t1, t3, 0x5410),
                               __byte_perm(t1, t3, 0x7632)};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        *reinterpret_cast<uint32_t*>(dst + grp8 * kVGroup + c16 * kCore +
                                     ((n0 + c) & 7) * 16 + (q & 3) * 4) =
            col[c] ^ 0x80808080u;  // v - 128 as int8
      }
    }
  };

  load_k(0, 0);
  im::cp_async_commit();
  // The table, one copy a half-warp lane: entry i's 16 copies are 4 uint4
  // stores.
#pragma unroll 8
  for (int w4 = tid; w4 < 256 * kCopies / 4; w4 += kBlockThreads) {
    const uint32_t x = __ldg(p.lut + (w4 >> 2));
    reinterpret_cast<uint4*>(table)[w4] = make_uint4(x, x, x, x);
  }
  // Q' = q - 128 as int8, this warpgroup's head, in the K tiles' layout.
  uint8_t* qt = qs + wgi * kTileBytes;
  {
    const uint8_t* qb = p.q + b * p.sq0 + head * p.sq1;
#pragma unroll
    for (int i = 0; i < kRows * kChunks / 128; ++i) {
      const int idx = (tid & 127) + 128 * i;
      const int r = idx / (8 * kChunks) * 8 + (idx & 7);
      const int kc = (idx >> 3) % kChunks;
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < p.s) {
        w = __ldg(reinterpret_cast<const uint4*>(qb + (m0 + r) * p.ldq +
                                                 kc * 16));
      }
      *reinterpret_cast<uint4*>(qt + idx * 16) =
          make_uint4(w.x ^ 0x80808080u, w.y ^ 0x80808080u,
                     w.z ^ 0x80808080u, w.w ^ 0x80808080u);
    }
  }
  fence_proxy_async();
  __syncthreads();

  Rows rw;
  const int i0 = m0 + 16 * warp + g;  // the thread's row h = 0
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + g + 8 * h;
    int sum = 0;
#pragma unroll
    for (int kc = t; kc < kChunks; kc += 4) {
      const uint4 w = *reinterpret_cast<const uint4*>(
          qt + ((r >> 3) * 8 * kChunks + kc * 8 + (r & 7)) * 16);
      sum = __dp4a(static_cast<int>(w.x), 0x01010101, sum);
      sum = __dp4a(static_cast<int>(w.y), 0x01010101, sum);
      sum = __dp4a(static_cast<int>(w.z), 0x01010101, sum);
      sum = __dp4a(static_cast<int>(w.w), 0x01010101, sum);
    }
    sum += __shfl_xor_sync(0xFFFFFFFFu, sum, 1);
    sum += __shfl_xor_sync(0xFFFFFFFFu, sum, 2);
    // sum (q - 128)(k - 128) = sum q' k - 128 sum q'
    rw.off[h] = kMagicBits - 128u * static_cast<uint32_t>(sum);
    rw.red[h] = INT32_MIN;
  }
  const int sink = p.sinks != nullptr ? p.sinks[head] : -1;
  const uint32_t tbase = wg::smem_u32(table) + 4 * (lane % kCopies);
  const uint32_t qaddr = wg::smem_u32(qt);

  int32_t acc[16];
  int32_t o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0;
  uint32_t pa[4] = {0u, 0u, 0u, 0u};

  int phase = 0;
  int u = 0;  // the key tile of the sweep
  for (int it = 0; it < iters; ++it) {
    const int k0 = (u0 + u) * kKeys;
    const bool last = u + 1 == ntiles;  // of this sweep
    const int u_next = last ? 0 : u + 1;
    const int phase_next = phase + (last ? 1 : 0);
    im::cp_async_wait<0>();  // this iteration's K tile, the next one's V
    fence_proxy_async();
    // K(it) is complete; every warpgroup is done with the K stage the next
    // copies refill (read by the scores of it - 1, waited for), with the
    // raw V buffer they refill (transposed at it - 1) and with the V stage
    // (read two steps back) that store_v refills.
    __syncthreads();
    if (it + 1 < iters) load_k(u_next, (it + 1) & 1);
    // V is fetched two iterations ahead of its context, as it lies, and
    // transposed one ahead.
    if (it + 2 < iters && it + 2 >= 2 * ntiles) {
      load_v((it + 2) % ntiles, it & 1);
    }
    im::cp_async_commit();

    const uint32_t kaddr = wg::smem_u32(ks + (it & 1) * kTileBytes);
    const uint32_t vaddr = wg::smem_u32(vs + (it % kVStages) * kVBytes);
#pragma unroll
    for (int c = 0; c < kKeys / kNs; ++c) {
      // Keys 32 c .. 32 c + 31 of the tile: K rows 32 c .., V chunks 2 c.
      wg::wgmma_fence();
#pragma unroll
      for (int s = 0; s < kChunks / 2; ++s) {
        mma_scores32(acc, desc(qaddr + 2 * kCore * s, kCore, kSbo),
                     desc(kaddr + c * (kNs / 8) * kSbo + 2 * kCore * s,
                          kCore, kSbo),
                     s);
      }
      wg::wgmma_commit();
      if (c == 0 && it + 1 < iters && it + 1 >= 2 * ntiles) {
        store_v((it + 1) & 1, (it + 1) % kVStages);
      }
      wg::wgmma_wait<0>();  // also the context of the last 32 keys
      wg::fence_operands(acc);
      fence_words(pa);
      const int k0c = k0 + kNs * c;
      const bool edge = k0c + kNs - 1 > m0 ||
                        (kBand && k0c < m0 + kRows - p.window);
      const int dist[2] = {i0 - k0c - 4 * t, i0 + 8 - k0c - 4 * t};
      if (phase == 0) {
        sweep_tile<0, kBand>(edge, acc, rw, pa, dist, p);
      } else if (phase == 1) {
        sweep_tile<1, kBand>(edge, acc, rw, pa, dist, p);
      } else {
        sweep_tile<2, kBand>(edge, acc, rw, pa, dist, p);
        wg::wgmma_fence();
        mma_context(o, pa, desc(vaddr + 2 * kCore * c, kCore, kVGroup));
        wg::wgmma_commit();
      }
    }

    if (last && phase == 0) {
      // The rows' max: a quad's four threads hold a row.  Requantization
      // does not decrease, so the max score is the max accumulator's.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int32_t mx = rw.red[h];
        mx = max(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, 1));
        mx = max(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, 2));
        int m = static_cast<int>(score_bits(mx, rw.off[h], p.scale, p.lo,
                                            p.hi) -
                                 kMagicBits) +
                p.zp;
        m = max(m, sink);
        // index x + 255 - m = bits + (zp + 255 - m - kMagicBits)
        rw.tab[h] = tbase + ((static_cast<uint32_t>(p.zp + 255 - m) -
                              kMagicBits)
                             << kEntryShift);
        // The sum starts from the sink's entry, in one thread of the quad.
        rw.red[h] = sink >= 0 && t == 0
                        ? static_cast<int32_t>(
                              table[(sink + 255 - m) * kCopies +
                                    lane % kCopies])
                        : 0;
      }
    } else if (last && phase == 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t s = static_cast<uint32_t>(rw.red[h]);
        s += __shfl_xor_sync(0xFFFFFFFFu, s, 1);
        s += __shfl_xor_sync(0xFFFFFFFFu, s, 2);
        rw.d[h] = row_div(s);
      }
    }
    phase = phase_next;
    u = u_next;
  }
  wg::wgmma_wait<0>();
  wg::fence_operands(o);

  const qnn::Requant rp = p.ctx;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + 8 * h;
    if (i >= p.s) continue;
    uint8_t* row = p.out + b * p.so0 + head * p.so1 + i * p.ldo + 2 * t;
#pragma unroll
    for (int j = 0; j < kDv / 8; ++j) {
      const uint32_t y0 = qnn::requantize(o[4 * j + 2 * h], rp, rp.scale);
      const uint32_t y1 =
          qnn::requantize(o[4 * j + 2 * h + 1], rp, rp.scale);
      *reinterpret_cast<uint16_t*>(row + 8 * j) =
          static_cast<uint16_t>(y0 | (y1 << 8));
    }
  }
}

template <bool kBand>
cudaError_t launch_attn(const attn::AttnArgs& p, int device, int64_t blocks,
                        cudaStream_t stream) {
  static uint32_t ready = 0;  // devices whose attribute is set
  if (device < 0 || device >= 32) return cudaErrorInvalidDevice;
  if (!(ready & (1u << device))) {
    // Cast: the name is also the masked products' template.
    const cudaError_t err = cudaFuncSetAttribute(
        static_cast<void (*)(attn::AttnArgs)>(q8bmm_masked_kernel<kBand>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, attn::kBlockSmem);
    if (err != cudaSuccess) return err;
    ready |= 1u << device;
  }
  q8bmm_masked_kernel<kBand><<<static_cast<unsigned>(blocks),
                               attn::kBlockThreads, attn::kBlockSmem,
                               stream>>>(p);
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
                               qmax, scale},
                  1, 0};
  const bool fast =
      wa == 16 && wb == (b_kmajor ? 16 : 4) && k <= kChainSteps * kStep;
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(b_kmajor ? launch<true>(p, fast, s)
                                   : launch<false>(p, fast, s));
}

// The masked products of attention (kernels/q8bmm.py q8bmm_masked_cuda):
// mode 1 (kScores) the scores, A [.., M, K] x B [.., K, N] with M = N the
// sequence, computing only the tiles that hold a pair of the mask; mode 2
// (kContext) the context, A [.., M, K] the probabilities with K = M, each
// row summed over its keys only.  window 0: causal; W > 0: the W keys
// ending at the query.  B's batch entry is (z0, z1 / grp).  Strides as
// qnn_q8bmm's, with the 16-byte copies and K <= 32,768 of its fast path,
// and a per-tensor requantization.
extern "C" int qnn_q8bmm_masked(int device, const void* a, const void* b,
                                void* out, int64_t g, int64_t g1, int grp,
                                int m, int n, int k, int64_t sa0,
                                int64_t sa1, int64_t lda, int64_t sb0,
                                int64_t sb1, int64_t ldb, int b_kmajor,
                                int64_t so0, int64_t so1, int64_t ldo,
                                int za, int zb, int mode, int window,
                                int scheme, int multiplier, int shift,
                                int zero_point, int qmin, int qmax,
                                float scale, void* stream) {
  const qnn::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) {
    return static_cast<int>(guard.error());
  }
  if (g < 0 || g1 < 1 || g % g1 != 0 || grp < 1 || g1 % grp != 0 ||
      m < 0 || n < 0 || k < 0 || (b_kmajor != 0 && b_kmajor != 1) ||
      za < 0 || za > 255 || zb < 0 || zb > 255 || window < 0 ||
      (mode != kScores && mode != kContext) ||
      (mode == kScores ? m != n : m != k) ||
      scheme == qnn::kFP32PerChannel || sa0 < 0 || sa1 < 0 || lda < 0 ||
      sb0 < 0 || sb1 < 0 || ldb < 0 || so0 < 0 || so1 < 0 ||
      (m > 1 && ldo < n) || (m + kBM - 1) / kBM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (g == 0 || m == 0 || n == 0) return 0;
  const int wa = im::copy_width(a, sa0 | sa1 | lda | k);
  const int wb = b_kmajor ? im::copy_width(b, sb0 | sb1 | ldb | k)
                          : (im::copy_width(b, sb0 | sb1 | ldb | n) >= 4 ? 4
                                                                         : 1);
  if (wa != 16 || wb != (b_kmajor ? 16 : 4) || k > kChainSteps * kStep) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BmmArgs p{static_cast<const uint8_t*>(a),
                  static_cast<const uint8_t*>(b),
                  nullptr,
                  static_cast<uint8_t*>(out),
                  g, g1, sa0, sa1, lda, sb0, sb1, ldb, so0, so1, ldo,
                  m, n, k, za, zb, wa, wb,
                  qnn::Requant{scheme, multiplier, shift, zero_point, qmin,
                               qmax, scale},
                  grp, window};
  // The N tiles a row tile needs: all (the context), or the band's
  // (window scores); the causal scores walk their triangle in blockIdx.x.
  const int tiles_m = (m + kBM - 1) / kBM;
  int64_t tiles_n = (n + kBN - 1) / kBN;
  if (mode == kScores && window > 0) {
    tiles_n = min(tiles_n, int64_t{(kBM + window + kBN - 3) / kBN + 1});
  }
  const bool triangle = mode == kScores && window == 0;
  const dim3 grid(static_cast<unsigned>(
                      triangle ? int64_t{kRatio} * tiles_m * (tiles_m + 1) / 2
                               : tiles_n),
                  static_cast<unsigned>(triangle ? 1 : tiles_m),
                  static_cast<unsigned>(g < 65535 ? g : 65535));
  const auto s = static_cast<cudaStream_t>(stream);
  if (mode == kScores && b_kmajor) {
    q8bmm_masked_kernel<true, kScores><<<grid, kThreads, 0, s>>>(p);
  } else if (mode == kScores) {
    q8bmm_masked_kernel<false, kScores><<<grid, kThreads, 0, s>>>(p);
  } else if (b_kmajor) {
    q8bmm_masked_kernel<true, kContext><<<grid, kThreads, 0, s>>>(p);
  } else {
    q8bmm_masked_kernel<false, kContext><<<grid, kThreads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// The fused masked attention of one layer (kernels/q8bmm.py
// q8attn_masked_cuda): q [B, H, S, dq], k [B, Hkv, dq, S] and v
// [B, Hkv, S, dv] uint8 views at zero point 128 (query head h reads
// key/value head h / (H / Hkv)), the context into out [B, H, S, dv].  Each
// row's scores (fp32 requantization: scale, zp, qmin, qmax) over its keys
// (window 0: j <= i; W > 0: i - W < j <= i), the masked softargmax by `lut`
// (uint32 [256]) with the head's sink (`sinks` uint8 [H], or null) in the
// max and the sum, and the context over the valid keys, its
// requantization any per-tensor scheme.  dq 192 and dv 128 (MiMo-V2-Flash's
// heads), a multiple of 4 query heads a key/value head, S up to 32,768;
// every base and stride a multiple of 16 bytes.
extern "C" int qnn_q8attn_masked(int device, const void* q, const void* k,
                                 const void* v, void* out, const void* lut,
                                 const void* sinks, int batch, int heads,
                                 int kv_heads, int s, int dq, int dv,
                                 int64_t sq0, int64_t sq1, int64_t ldq,
                                 int64_t sk0, int64_t sk1, int64_t ldk,
                                 int64_t sv0, int64_t sv1, int64_t ldv,
                                 int64_t so0, int64_t so1, int64_t ldo,
                                 int zero_point, int window, float scale,
                                 int s_zero_point, int s_qmin, int s_qmax,
                                 int scheme, int multiplier, int shift,
                                 int c_zero_point, int c_qmin, int c_qmax,
                                 float c_scale, void* stream) {
  const qnn::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) {
    return static_cast<int>(guard.error());
  }
  const int64_t strides[12] = {sq0, sq1, ldq, sk0, sk1, ldk,
                               sv0, sv1, ldv, so0, so1, ldo};
  bool aligned = (reinterpret_cast<uintptr_t>(q) |
                  reinterpret_cast<uintptr_t>(k) |
                  reinterpret_cast<uintptr_t>(v) |
                  reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  for (const int64_t st : strides) {
    aligned = aligned && st >= 0 && st % 16 == 0;
  }
  if (batch < 0 || heads < 1 || kv_heads < 1 || heads % kv_heads != 0 ||
      heads / kv_heads % attn::kHeads != 0 ||
      s < 0 || s > 32768 || dq != attn::kDq || dv != attn::kDv ||
      zero_point != 128 || window < 0 || !aligned ||
      !(scale > 0.0f) || s_qmin < 0 || s_qmin > s_qmax || s_qmax > 255 ||
      lut == nullptr || scheme == qnn::kFP32PerChannel) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || s == 0) return 0;
  attn::AttnArgs p{static_cast<const uint8_t*>(q),
                   static_cast<const uint8_t*>(k),
                   static_cast<const uint8_t*>(v),
                   static_cast<uint8_t*>(out),
                   static_cast<const uint32_t*>(lut),
                   static_cast<const uint8_t*>(sinks),
                   sq0, sq1, ldq, sk0, sk1, ldk, sv0, sv1, ldv, so0, so1, ldo,
                   batch, heads / kv_heads, heads / attn::kHeads,
                   (s + attn::kRows - 1) / attn::kRows,
                   s, window,
                   scale,
                   static_cast<float>(s_qmin - s_zero_point),
                   static_cast<float>(s_qmax - s_zero_point),
                   s_zero_point,
                   qnn::Requant{scheme, multiplier, shift, c_zero_point,
                                c_qmin, c_qmax, c_scale}};
  const int64_t blocks =
      static_cast<int64_t>(p.tiles_m) * batch * p.groups;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      window > 0 ? launch_attn<true>(p, device, blocks, st)
                 : launch_attn<false>(p, device, blocks, st);
  return static_cast<int>(err);
}
