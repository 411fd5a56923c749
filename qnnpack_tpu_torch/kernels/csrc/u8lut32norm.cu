// u8lut32norm: pass 2 of softargmax, [R, N] uint8 -> [R, N] uint8.
//
// The port of the normalize pass of qnnpack_tpu/nn/elementwise.py:
// u8softargmax (QNNPACK's u8lut32norm ukernel; no Pallas form in the JAX
// package).  Given each row's max (u8rmax.cu) and a 256-entry uint32 table:
//
//   e[i] = t[x[i] + 255 - rmax]        s = sum_i e[i]          (mod 2^32)
//   y[i] = min((256 e[i] + s / 2) / s, 255)       (uint32, wrapping)
//
// and y = 255 where s wraps to 0 (the GPU's uint32 x / 0 = 2^32 - 1, as
// the plain version has it).
//
// The divide.  The card has no integer divider, so a divide per element
// would cost a reciprocal and its corrections each time.  The divisor is
// the row's, so a row takes one uint32 divide, for the magic
// m = floor(2^32 / s) (2^32 - 1 for s = 1), and each element
// q0 = mulhi(n, m) and one correction, q = q0 + (n - q0 s >= s).  That is
// exact for every uint32 n: for s >= 2, m s > 2^32 - s, so
// n / s - n m / 2^32 < n / 2^32 < 1, and q0 is floor(n / s) or one less;
// for s = 1, q0 = n - 1 for n >= 1 and n - q0 s = 1.  n - q0 s <= n never
// wraps.  tests/test_torch_softargmax.py holds a numpy mirror of these
// steps against exact division and the JAX package's u32_div_floor.
//
// What bounds it: one byte read and one written per element (the memory;
// a device-to-device copy of BERT's b128 scores runs at about 85% of the
// card's 3.35 TB/s, scripts/bench_lut_table.py) against about ten 32-bit
// integer operations an element (the lookup's address, the sum,
// 256 e + s / 2, mulhi, the correction, the clamp and a share of the
// packing), which at the card's integer rate take about as long.
//
// Design (the row mapping of u8rows.cuh): L lanes a row, V bytes a lane at
// a time, 64-thread blocks.  Where a row fits its group in one vector a
// lane (N <= L V: BERT's 128-byte rows at 8 lanes of 16 bytes), a group
// takes 2 rows at a time, each row is read once, and each element is looked
// up once and kept in registers from the sum to the store; the next rows'
// loads are issued before this step's work, and a block's first loads
// before it fills its table.  Longer rows take a warp each and two passes,
// the second read served from L1/L2.  x <= rmax, so x + 255 - rmax adds to
// each byte of a word without a carry: one add offsets four indices.
// Stores are V bytes a lane.  The table is in shared memory, 1 KB a block:
// a copy for each lane, so that no two lanes of a warp share a bank (32 KB
// a block), was slower (scripts/bench_lut_table.py times the two).
#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"
#include "u8rows.cuh"

namespace {

using qnn_rows::Vec;

constexpr int kThreads = 64;
// Rows a lane group takes at a time where a row fits the group; rows that
// take a whole warp go one at a time.
template <int L>
constexpr int kRows = L == 32 ? 1 : 2;

// A row's divisor: the sum s, -s, its magic m, s / 2 and the fill (every
// bit set where s == 0, so that each output byte becomes 255).
struct RowDiv {
  uint32_t s, neg_s, m, half, fill;
};

__device__ __forceinline__ RowDiv row_div(uint32_t s) {
  const uint32_t q = 0xFFFFFFFFu / (s > 1 ? s : 1u);  // the row's one divide
  // m = floor(2^32 / s) = floor((2^32 - 1) / s) + [s divides 2^32] for
  // s >= 2, and 2^32 - 1 for s <= 1.
  const uint32_t m = s > 1 ? q + (0xFFFFFFFFu - q * s == s - 1) : 0xFFFFFFFFu;
  return {s, 0u - s, m, s >> 1, s == 0 ? 0xFFFFFFFFu : 0u};
}

// q0 + (r >= s), the correction taken from the borrow of r - s (two
// instructions, where a compare and a select take three).
__device__ __forceinline__ uint32_t add_not_below(uint32_t q0, uint32_t r,
                                                  uint32_t s) {
  uint32_t q;
  asm("{\n\t.reg .u32 t;\n\t"
      "sub.cc.u32 t, %1, %2;\n\t"         // borrow = r < s
      "subc.u32 %0, %3, 0xFFFFFFFF;\n\t"  // q0 + 1 - borrow
      "}"
      : "=r"(q)
      : "r"(r), "r"(s), "r"(q0));
  return q;
}

__device__ __forceinline__ uint32_t norm(uint32_t e, const RowDiv& d) {
  const uint32_t num = e * 256u + d.half;
  const uint32_t q0 = __umulhi(num, d.m);
  const uint32_t q = add_not_below(q0, num + q0 * d.neg_s, d.s);
  return q < 255u ? q : 255u;
}

// t[byte b of w], w holding indices (x + 255 - rmax) in its bytes.
__device__ __forceinline__ uint32_t look(const uint32_t* t, uint32_t w,
                                         int b) {
  return t[__byte_perm(w, 0, 0x4440 + b)];
}

// Looks up a lane's V bytes (offset by offw) into e; returns their sum.
template <int V>
__device__ __forceinline__ uint32_t look_vec(
    const uint32_t* t, const uint32_t (&w)[Vec<V>::kWords], uint32_t offw,
    uint32_t (&e)[V]) {
  uint32_t s = 0;
#pragma unroll
  for (int i = 0; i < Vec<V>::kWords; ++i) {
    const uint32_t idx = w[i] + offw;
#pragma unroll
    for (int b = 0; b < Vec<V>::kBytesPerWord; ++b) {
      e[i * Vec<V>::kBytesPerWord + b] = look(t, idx, b);
      s += e[i * Vec<V>::kBytesPerWord + b];
    }
  }
  return s;
}

// Normalizes e and stores the V output bytes at p.
template <int V>
__device__ __forceinline__ void norm_store(uint8_t* p, const uint32_t (&e)[V],
                                           const RowDiv& d) {
  uint32_t out[Vec<V>::kWords];
  if constexpr (V == 1) {
    out[0] = norm(e[0], d) | d.fill;
  } else {
#pragma unroll
    for (int i = 0; i < Vec<V>::kWords; ++i) {
      const uint32_t lo = __byte_perm(norm(e[4 * i], d), norm(e[4 * i + 1], d),
                                      0x0040);
      const uint32_t hi = __byte_perm(norm(e[4 * i + 2], d),
                                      norm(e[4 * i + 3], d), 0x0040);
      out[i] = __byte_perm(lo, hi, 0x5410) | d.fill;
    }
  }
  Vec<V>::store(p, out);
}

template <int L>
__device__ __forceinline__ uint32_t group_sum(uint32_t s) {
#pragma unroll
  for (int off = L / 2; off > 0; off /= 2) {
    s += __shfl_xor_sync(0xFFFFFFFFu, s, off);
  }
  return s;
}

// A lane's share of kR rows that fit their group: its vector of each and
// each row's index offset; `ok` where the row exists and holds the lane's
// vector.  xr points at the lane's vector of the first row.
template <int V, int kR>
struct Step {
  uint32_t w[kR][Vec<V>::kWords];
  uint32_t offw[kR];
  bool ok[kR];

  __device__ __forceinline__ void load(const uint8_t* xr, const uint8_t* rm,
                                       int64_t left, int n, bool mine) {
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      ok[k] = mine && k < left;
      if (ok[k]) {
        Vec<V>::load(xr + static_cast<int64_t>(k) * n, w[k]);
        offw[k] = (255u - rm[k]) * 0x01010101u;
      } else {
#pragma unroll
        for (int i = 0; i < Vec<V>::kWords; ++i) w[k][i] = 0;
        offw[k] = 0;
      }
    }
  }
};

template <int V, int L>
__global__ void __launch_bounds__(kThreads)
    u8lut32norm_kernel(const uint8_t* __restrict__ x,
                       const uint8_t* __restrict__ rmax,
                       const uint32_t* __restrict__ lut,
                       uint8_t* __restrict__ y, int64_t rows, int n) {
  constexpr int kR = kRows<L>;
  constexpr int kBlockRows = kThreads / L * kR;
  __shared__ __align__(16) uint32_t table[256];
  const int lig = threadIdx.x % L;  // lane in the row's group
  const int64_t step = static_cast<int64_t>(gridDim.x) * kBlockRows;
  int64_t first = static_cast<int64_t>(blockIdx.x) * kBlockRows;
  int64_t r0 = first + threadIdx.x / L * kR;  // the group's first row
  // Else L == 32 (row_instance_ok): a warp a row, in two passes.
  const bool one_pass = n <= L * V;
  const bool mine = lig * V < n;
  const uint8_t* xr = x + r0 * n + lig * V;

  // The first rows' loads go out before the table is filled, so that the
  // two latencies overlap.
  Step<V, kR> cur;
  if (one_pass) cur.load(xr, rmax + r0, rows - r0, n, mine);
  for (int i = threadIdx.x; i < 256; i += kThreads) table[i] = __ldg(lut + i);
  __syncthreads();
  const uint32_t* t = table;

  if (one_pass) {
    const int64_t step_bytes = step * n;
    uint8_t* yr = y + r0 * n + lig * V;
    for (; first < rows; first += step) {
      const bool more = first + step < rows;
      Step<V, kR> next;
      if (more) {
        next.load(xr + step_bytes, rmax + r0 + step, rows - r0 - step, n,
                  mine);
      }
      uint32_t e[kR][V];
      uint32_t s[kR];
#pragma unroll
      for (int k = 0; k < kR; ++k) {
        const uint32_t part = look_vec<V>(t, cur.w[k], cur.offw[k], e[k]);
        s[k] = group_sum<L>(cur.ok[k] ? part : 0u);
      }
#pragma unroll
      for (int k = 0; k < kR; ++k) {
        if (cur.ok[k]) {
          norm_store<V>(yr + static_cast<int64_t>(k) * n, e[k],
                        row_div(s[k]));
        }
      }
      if (!more) break;
      cur = next;
      xr += step_bytes;
      yr += step_bytes;
      r0 += step;
    }
  } else if constexpr (L == 32) {
    const int vecs = n / V;
    for (; r0 < rows; r0 += step) {
      const uint8_t* xw = x + r0 * n;
      uint8_t* yw = y + r0 * n;
      const uint32_t offw = (255u - rmax[r0]) * 0x01010101u;
      uint32_t s = 0;
#pragma unroll 4
      for (int j = lig; j < vecs; j += L) {
        uint32_t w[Vec<V>::kWords];
        uint32_t e[V];
        Vec<V>::load(xw + static_cast<int64_t>(j) * V, w);
        s += look_vec<V>(t, w, offw, e);
      }
      s = group_sum<L>(s);
      const RowDiv d = row_div(s);
#pragma unroll 4
      for (int j = lig; j < vecs; j += L) {
        uint32_t w[Vec<V>::kWords];
        uint32_t e[V];
        Vec<V>::load(xw + static_cast<int64_t>(j) * V, w);
        look_vec<V>(t, w, offw, e);
        norm_store<V>(yw + static_cast<int64_t>(j) * V, e, d);
      }
    }
  }
}

struct Launch {
  const uint8_t* x;
  const uint8_t* rmax;
  const uint32_t* lut;
  uint8_t* y;
  int64_t rows;
  int n;
  cudaStream_t stream;

  template <int V, int L>
  cudaError_t run() const {
    const unsigned grid = qnn_rows::grid_for(rows, kThreads / L * kRows<L>);
    u8lut32norm_kernel<V, L><<<grid, kThreads, 0, stream>>>(x, rmax, lut, y,
                                                            rows, n);
    return cudaGetLastError();
  }
};

}  // namespace

// vec and lanes: the instance kernels/vpu_ops.py:row_instance picked; one
// that n or the bases of x and y do not allow is refused.
extern "C" int qnn_u8lut32norm(int device, const void* x, const void* rmax,
                               const void* lut, void* y, int64_t rows, int n,
                               int vec, int lanes, void* stream) {
  const qnn::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) {
    return static_cast<int>(guard.error());
  }
  if (!qnn_rows::row_instance_ok(vec, lanes, n, x, y)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  const Launch launch{static_cast<const uint8_t*>(x),
                      static_cast<const uint8_t*>(rmax),
                      static_cast<const uint32_t*>(lut),
                      static_cast<uint8_t*>(y),
                      rows,
                      n,
                      static_cast<cudaStream_t>(stream)};
  return static_cast<int>(qnn_rows::dispatch(vec, lanes, launch));
}
