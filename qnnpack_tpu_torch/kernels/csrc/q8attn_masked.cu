// q8attn_masked: one layer's masked attention, fused: the scores, the
// masked softargmax and the context in one launch (kernels/q8bmm.py
// q8attn_masked_cuda, MiMo-V2-Flash's path).  The kernel is
// q8bmm_masked_kernel on AttnArgs, the name that
// benchmark/metrics/attn_roofline.offline.py finds it by in a trace.  It
// never writes the [B, H, S, S] scores (17.2 GB at MiMo-V2-Flash's b4 full
// layer; an unfused path would send each through device memory three
// times).  Per row, over its valid keys:
//
//   m = max(x_j, sink)          x_j the requantized score q_i k_j
//   e_j = t[x_j + 255 - m]      s = sum_j e_j + t[sink + 255 - m]  (mod 2^32)
//   p_j = min((256 e_j + s / 2) / s, 255)
//   ctx = requant(sum_j p_j (v_j - 128))
//
// byte for byte the three-step result (masked scores, softargmax,
// context) that tests/test_torch_mimo.py holds it to.  Flash attention's
// online rescaling (a running max, the partial sum and product rescaled
// when it rises) is not exact here: the table's entries are rounded, so
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
// unfused kernels that it replaced (H100 80GB HBM3, 700 W); without the
// sweeps' arithmetic a full layer takes 13.9 ms.
#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"
#include "imma_tile.cuh"
#include "wgmma_tile.cuh"

namespace {

namespace im = qnn::imma;

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
    const cudaError_t err = cudaFuncSetAttribute(
        q8bmm_masked_kernel<kBand>,
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
