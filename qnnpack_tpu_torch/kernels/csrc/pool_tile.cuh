// The thread mapping and window loads of the pooling kernels, u8maxpool.cu
// and q8avgpool.cu.
//
// An instance is (V, window).  A thread takes V bytes of channels (one
// channel vector: 16, 8, 4 or 1 bytes) of each of its outputs.  The window
// is one of three forms:
//   - k3x3s2: a compile-time 3 x 3 window at stride 2, dilation 1, any
//     padding (every pool of the port's main paths).  A thread makes
//     kOutputs adjacent outputs along W; outputs ox and ox + 1 share input
//     column 2 ox + 2, so it loads 3 rows x (2 kOutputs + 1) columns, all
//     of them before it works on any, and a tap outside the image is a
//     predicated load that yields 0;
//   - kAny: any window, stride, dilation and padding, one output a thread,
//     runtime tap loops; q8avgpool sums in 16-bit halves (exact up to
//     kHalfTaps taps);
//   - kAnyWide: as kAny, with q8avgpool's sums in 32 bits (any number of
//     taps); u8maxpool has no sums and takes kAny instead.
// kernels/pool.py:pool_instance picks the instance (V = 16 where C % 16 ==
// 0 and every base is on a 16-byte boundary, else 8, 4 or 1 on the same
// terms); instance_ok below is the C entries' check of the same terms.
//
// The grid needs no divide: blockIdx.z walks the images, blockIdx.y and
// threadIdx.z the output rows, blockIdx.x and threadIdx.y the column tiles
// (kOutputs or one output each) and threadIdx.x the channel vectors, each
// a loop where the grid or the block does not cover it.  Index arithmetic
// is 32-bit; offsets are 64-bit products (an image may pass 2^31 bytes).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "u8rows.cuh"

namespace qnn_pool {

using qnn_rows::Vec;

// The window forms, as kernels/pool.py:WINDOWS codes them.
constexpr int kAny = 0;
constexpr int k3x3s2 = 1;
constexpr int kAnyWide = 2;

constexpr int kThreads = 128;  // at most, a block
// Outputs a thread along W in k3x3s2: 2 beat 4 over the main paths' pools
// at batch 1 and 128 together (scripts/bench_pool.py).
constexpr int kOutputs = 2;
// Taps whose bytes a 16-bit half sums exactly: 257 * 255 < 2^16.
constexpr int kHalfTaps = 257;

struct Shape {
  int batch, height, width, channels, out_height, out_width;
  int pool_h, pool_w, stride_h, stride_w, pad_top, pad_left, dil_h, dil_w;
  int vecs;   // channels / V
  int tiles;  // column tiles a row: ceil(out_width / outputs a thread)
};

// Whether (vec, window) may run `s` at these bases: vec divides C and both
// bases; k3x3s2 needs that window, kAny at most kHalfTaps taps where
// `sums` (q8avgpool), kAnyWide `sums`.
inline bool instance_ok(int vec, int window, const Shape& s, const void* x,
                        const void* y, bool sums) {
  const bool vec_ok = (vec == 16 || vec == 8 || vec == 4 || vec == 1) &&
                      s.channels % vec == 0 && qnn_rows::aligned(x, vec) &&
                      qnn_rows::aligned(y, vec);
  switch (window) {
    case kAny:
      return vec_ok && (!sums || s.pool_h * s.pool_w <= kHalfTaps);
    case k3x3s2:
      return vec_ok && s.pool_h == 3 && s.pool_w == 3 && s.stride_h == 2 &&
             s.stride_w == 2 && s.dil_h == 1 && s.dil_w == 1;
    case kAnyWide:
      return vec_ok && sums;
    default:
      return false;
  }
}

// Calls f.template run<V, W>() for the runtime instance (vec, window);
// cudaErrorInvalidValue for any other.
template <int V, class F>
cudaError_t dispatch_window(int window, const F& f) {
  switch (window) {
    case kAny: return f.template run<V, kAny>();
    case k3x3s2: return f.template run<V, k3x3s2>();
    case kAnyWide: return f.template run<V, kAnyWide>();
    default: return cudaErrorInvalidValue;
  }
}

template <class F>
cudaError_t dispatch(int vec, int window, const F& f) {
  switch (vec) {
    case 16: return dispatch_window<16>(window, f);
    case 8: return dispatch_window<8>(window, f);
    case 4: return dispatch_window<4>(window, f);
    case 1: return dispatch_window<1>(window, f);
    default: return cudaErrorInvalidValue;
  }
}

// Outputs a thread along W for a window form.
__host__ __device__ constexpr int outputs_of(int window) {
  return window == k3x3s2 ? kOutputs : 1;
}

// s.vecs and s.tiles for V and the window, and the launch's grid and block:
// the channel vectors across threadIdx.x (up to kThreads), then as many
// column tiles and output rows as fill kThreads threads.
inline void plan(Shape& s, int vec, int window, dim3& grid, dim3& block) {
  const int n = outputs_of(window);
  s.vecs = s.channels / vec;
  s.tiles = (s.out_width + n - 1) / n;
  const int bx = s.vecs < kThreads ? s.vecs : kThreads;
  const int by = s.tiles < kThreads / bx ? s.tiles : kThreads / bx;
  int bz = kThreads / (bx * by);
  bz = bz < s.out_height ? bz : s.out_height;
  bz = bz < 64 ? bz : 64;
  const int rows = (s.out_height + bz - 1) / bz;
  block = dim3(bx, by, bz);
  grid = dim3((s.tiles + by - 1) / by, rows < 65535 ? rows : 65535,
              s.batch < 65535 ? s.batch : 65535);
}

// Calls f(in, out, iy0, ix0, outs) for every (image, output row, column
// tile, channel vector) of this thread: `in` the byte offset of the
// vector's channels in its image, `out` that of its first output, (iy0,
// ix0) the input pixel of its first output's top-left tap, `outs` its
// outputs inside the row (at most N).
template <int V, int N, class F>
__device__ __forceinline__ void walk(const Shape& s, F&& f) {
  const int tile = blockIdx.x * blockDim.y + threadIdx.y;
  if (tile >= s.tiles) return;
  const int ox0 = tile * N;
  const int outs = s.out_width - ox0 < N ? s.out_width - ox0 : N;
  const int64_t image_bytes =
      static_cast<int64_t>(s.height) * s.width * s.channels;
  const int64_t out_row_bytes =
      static_cast<int64_t>(s.out_width) * s.channels;
  for (int b = blockIdx.z; b < s.batch; b += gridDim.z) {
    for (int oy = blockIdx.y * blockDim.z + threadIdx.z; oy < s.out_height;
         oy += gridDim.y * blockDim.z) {
      const int64_t out = (static_cast<int64_t>(b) * s.out_height + oy) *
                              out_row_bytes +
                          static_cast<int64_t>(ox0) * s.channels;
      for (int v = threadIdx.x; v < s.vecs; v += blockDim.x) {
        f(b * image_bytes + v * V, out + v * V,
          oy * s.stride_h - s.pad_top, ox0 * s.stride_w - s.pad_left, outs);
      }
    }
  }
}

// The taps of one output of the generic window, whose top-left tap is
// (iy0, ix0): whether row ky and column kx of the window lie inside the
// image, and the address of tap (ky, kx).
struct Taps {
  const uint8_t* origin;  // tap (0, 0), wherever it lies
  int64_t row_step;       // bytes from one window row to the next
  int64_t col_step;       // bytes from one window column to the next
  int iy0, ix0, dil_h, dil_w, height, width;

  __device__ __forceinline__ Taps(const uint8_t* x, const Shape& s,
                                  int64_t in, int iy0_, int ix0_)
      : origin(x + in +
               static_cast<int64_t>(iy0_) * s.width * s.channels +
               static_cast<int64_t>(ix0_) * s.channels),
        row_step(static_cast<int64_t>(s.dil_h) * s.width * s.channels),
        col_step(static_cast<int64_t>(s.dil_w) * s.channels),
        iy0(iy0_), ix0(ix0_), dil_h(s.dil_h), dil_w(s.dil_w),
        height(s.height), width(s.width) {}

  __device__ __forceinline__ bool row_in(int ky) const {
    return static_cast<unsigned>(iy0 + ky * dil_h) <
           static_cast<unsigned>(height);
  }
  __device__ __forceinline__ bool col_in(int kx) const {
    return static_cast<unsigned>(ix0 + kx * dil_w) <
           static_cast<unsigned>(width);
  }
  __device__ __forceinline__ const uint8_t* at(int ky, int kx) const {
    return origin + ky * row_step + kx * col_step;
  }
};

// The 3 rows x (2 N + 1) columns of a thread's N outputs of the 3 x 3
// stride-2 window, V bytes each: all loads issued before any is used, a tap
// outside the image a predicated load that yields 0.  (Not through Taps:
// its runtime dilation took the 16-byte instance of u8maxpool from 80 to
// 128 registers and ResNet-18's b128 pool1 from 0.049 to 0.052 ms.)
template <int V, int N>
struct Window3x3s2 {
  static constexpr int kCols = 2 * N + 1;
  static constexpr int kWords = Vec<V>::kWords;
  uint32_t w[3][kCols][kWords];
  bool row_in[3];
  bool col_in[kCols];

  __device__ __forceinline__ void load(const uint8_t* __restrict__ x,
                                       const Shape& s, int64_t in, int iy0,
                                       int ix0) {
    const int64_t row_bytes = static_cast<int64_t>(s.width) * s.channels;
    const uint8_t* p = x + in + iy0 * row_bytes +
                       static_cast<int64_t>(ix0) * s.channels;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      row_in[ky] = static_cast<unsigned>(iy0 + ky) <
                   static_cast<unsigned>(s.height);
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      col_in[j] = static_cast<unsigned>(ix0 + j) <
                  static_cast<unsigned>(s.width);
    }
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
#pragma unroll
        for (int i = 0; i < kWords; ++i) w[ky][j][i] = 0;
        if (row_in[ky] && col_in[j]) {
          Vec<V>::load(p + ky * row_bytes + static_cast<int64_t>(j) *
                                                s.channels,
                       w[ky][j]);
        }
      }
    }
  }

  // Taps of output o inside the image.
  __device__ __forceinline__ int inside(int o) const {
    const int rows = row_in[0] + row_in[1] + row_in[2];
    return rows * (col_in[2 * o] + col_in[2 * o + 1] + col_in[2 * o + 2]);
  }
};

}  // namespace qnn_pool
