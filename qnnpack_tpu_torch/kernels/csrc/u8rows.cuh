// The row mapping of the uint8 row kernels, u8rmax.cu and u8lut32norm.cu.
//
// An instance is (V, L): a lane loads V bytes of a row at a time (16, 8 or
// 1), and a group of L lanes (a power of two up to 32) covers a row, so a
// warp holds 32 / L rows.  kernels/vpu_ops.py:row_instance picks it from N
// and the base addresses (V = 16 where N % 16 == 0 and every base is on a
// 16-byte boundary, else 8 on the same terms, else 1; L the least power of
// two that covers N / V vectors, at most 32); row_instance_ok below is the C
// entries' check of the same terms.  A group takes a few consecutive rows
// at a time and issues their loads before it works on any of them.  Rows
// longer than 32 * V bytes loop in the warp, V bytes a lane at a time.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace qnn_rows {

// V bytes as words: four words for 16 bytes, two for 8, one for 4, and for
// one byte a word holding it in its low 8 bits.  Loads go through the
// read-only path (ld.global.nc).
template <int V>
struct Vec;

template <>
struct Vec<16> {
  static constexpr int kWords = 4;
  static constexpr int kBytesPerWord = 4;
  __device__ static void load(const uint8_t* p, uint32_t (&w)[kWords]) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  }
  __device__ static void store(uint8_t* p, const uint32_t (&w)[kWords]) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Vec<8> {
  static constexpr int kWords = 2;
  static constexpr int kBytesPerWord = 4;
  __device__ static void load(const uint8_t* p, uint32_t (&w)[kWords]) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x;
    w[1] = v.y;
  }
  __device__ static void store(uint8_t* p, const uint32_t (&w)[kWords]) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  }
};

// (The row kernels take 16, 8 or 1 bytes; the pooling kernels,
// pool_tile.cuh, take 4 as well.)
template <>
struct Vec<4> {
  static constexpr int kWords = 1;
  static constexpr int kBytesPerWord = 4;
  __device__ static void load(const uint8_t* p, uint32_t (&w)[kWords]) {
    w[0] = __ldg(reinterpret_cast<const uint32_t*>(p));
  }
  __device__ static void store(uint8_t* p, const uint32_t (&w)[kWords]) {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  }
};

template <>
struct Vec<1> {
  static constexpr int kWords = 1;
  static constexpr int kBytesPerWord = 1;
  __device__ static void load(const uint8_t* p, uint32_t (&w)[kWords]) {
    w[0] = __ldg(p);
  }
  __device__ static void store(uint8_t* p, const uint32_t (&w)[kWords]) {
    *p = static_cast<uint8_t>(w[0]);
  }
};

__host__ __device__ inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Whether (vec, lanes) may run rows of n bytes at these bases: vec divides
// n and both bases, and lanes is 32 or covers the row (so that only a
// whole warp loops over a row).
inline bool row_instance_ok(int vec, int lanes, int n, const void* a,
                            const void* b) {
  const bool vec_ok = (vec == 16 || vec == 8 || vec == 1) && n >= 1 &&
                      n % vec == 0 && aligned(a, vec) && aligned(b, vec);
  const bool lanes_ok = lanes >= 1 && lanes <= 32 &&
                        (lanes & (lanes - 1)) == 0 &&
                        (lanes == 32 || n <= lanes * vec);
  return vec_ok && lanes_ok;
}

// Calls f.template run<V, L>() for the runtime instance (vec, lanes);
// cudaErrorInvalidValue for any other.
template <int V, class F>
cudaError_t dispatch_lanes(int lanes, const F& f) {
  switch (lanes) {
    case 1: return f.template run<V, 1>();
    case 2: return f.template run<V, 2>();
    case 4: return f.template run<V, 4>();
    case 8: return f.template run<V, 8>();
    case 16: return f.template run<V, 16>();
    case 32: return f.template run<V, 32>();
    default: return cudaErrorInvalidValue;
  }
}

template <class F>
cudaError_t dispatch(int vec, int lanes, const F& f) {
  switch (vec) {
    case 16: return dispatch_lanes<16>(lanes, f);
    case 8: return dispatch_lanes<8>(lanes, f);
    case 1: return dispatch_lanes<1>(lanes, f);
    default: return cudaErrorInvalidValue;
  }
}

// Blocks for `rows` at `block_rows` a block step (the kernels loop over
// further steps past the cap).
inline unsigned grid_for(int64_t rows, int64_t block_rows) {
  int64_t blocks = (rows + block_rows - 1) / block_rows;
  if (blocks > (int64_t{1} << 30)) blocks = int64_t{1} << 30;
  return static_cast<unsigned>(blocks);
}

}  // namespace qnn_rows
