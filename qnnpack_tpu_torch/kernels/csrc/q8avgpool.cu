// q8avgpool: quantized average pooling, uint8 NHWC -> uint8 NHWC.
//
// Replaces the TPU kernel qnnpack_tpu/kernels/pool.py:q8avgpool_pallas (body
// _avgpool_kernel).
//
//   acc[b, y, x, c] = bias + sum_taps v(y*sh - pt + ky, x*sw - pl + kx, c)
//                     (int32, wrapping)
//   out[b, y, x, c] = avgpool_quantize(acc)      (64-bit product, -1 for
//                     negative values, rounding arithmetic shift, clamp)
//
// v is the input byte inside the image and the input zero point outside it,
// as nn/pool.py:q8avgpool2d pads (not 0, as max pooling does): the graph's
// bias is -izp*ph*pw, so a padded tap cancels exactly and the accumulator is
// the sum of (x - izp) over the real pixels.  Strides default to the pool
// size in the wrapper; there is no dilation.
//
// What bounds it: ph*pw adds per output byte against one byte written and
// 1/(sh*sw) of a byte read per output byte: memory bound (ShuffleNet's three
// strided shortcuts at b128 move 58 MB, 0.017 ms at 3.35 TB/s), if enough
// bytes are in flight and the integer work stays below the memory's time.
// Design (the instances and thread mapping of pool_tile.cuh, as
// u8maxpool.cu):
//   - a thread takes one channel vector of V = 16, 8, 4 or 1 bytes;
//   - the 3 x 3 stride-2 window (all three shortcuts) is a compile-time
//     instance: kOutputs = 2 adjacent outputs a thread from 3 rows x 5
//     columns of loads, all issued first, the shared column loaded once; a
//     padded tap is a predicated load that yields 0 and is counted;
//   - sums in 16-bit halves: a word's bytes 0 and 2 are w & 0x00FF00FF and
//     bytes 1 and 3 (w >> 8) & 0x00FF00FF, so a tap costs two adds a word
//     (first over each column's 3 rows, then over each output's 3 columns),
//     exact up to 257 taps (257 * 255 < 2^16); the generic instance sums in
//     halves up to 257 taps (kAny) and in 32 bits past that (kAnyWide, a
//     word at a time);
//   - each byte's sum leaves its half once, takes bias + outside*izp with a
//     uint32 wrap as the reference's int32 sum does, and is requantized by
//     requant.cuh:avgpool_requant (its int64 product is one IMAD.WIDE).
#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"
#include "pool_tile.cuh"
#include "requant.cuh"

namespace {

using qnn_pool::Shape;
using qnn_pool::Vec;

struct AvgParams {
  int32_t input_zero_point, bias, multiplier, shift, zero_point, lo, hi;
};

constexpr uint32_t kEvenBytes = 0x00FF00FFu;

// The sums of a word's B bytes, with `outside` padded taps, requantized and
// packed into the word.
template <int B>
__device__ __forceinline__ uint32_t requant_word(const uint32_t (&sums)[4],
                                                 int outside,
                                                 const AvgParams& p) {
  const uint32_t base = static_cast<uint32_t>(p.bias) +
                        static_cast<uint32_t>(outside) *
                            static_cast<uint32_t>(p.input_zero_point);
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < B; ++j) {
    word |= static_cast<uint32_t>(qnn::avgpool_requant(
                static_cast<int32_t>(sums[j] + base), p.multiplier, p.shift,
                p.zero_point, p.lo, p.hi))
            << (8 * j);
  }
  return word;
}

// A word's four byte sums from its 16-bit halves: `even` holds bytes 0 and
// 2, `odd` bytes 1 and 3.
__device__ __forceinline__ void unpack_halves(uint32_t even, uint32_t odd,
                                              uint32_t (&sums)[4]) {
  sums[0] = even & 0xFFFFu;
  sums[1] = odd & 0xFFFFu;
  sums[2] = even >> 16;
  sums[3] = odd >> 16;
}

// Word i of the V bytes at p (V = 1: the byte).
template <int V>
__device__ __forceinline__ uint32_t load_word(const uint8_t* p, int i) {
  if constexpr (V == 1) {
    return __ldg(p);
  } else {
    return __ldg(reinterpret_cast<const uint32_t*>(p) + i);
  }
}

template <int V, int kWindow>
__global__ void __launch_bounds__(qnn_pool::kThreads)
    q8avgpool_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
                     Shape s, AvgParams p) {
  constexpr int N = qnn_pool::outputs_of(kWindow);
  constexpr int kWords = Vec<V>::kWords;
  constexpr int kB = Vec<V>::kBytesPerWord;
  qnn_pool::walk<V, N>(s, [&](int64_t in, int64_t out, int iy0, int ix0,
                              int outs) {
    uint32_t q[N][kWords];
    uint32_t sums[4];
    if constexpr (kWindow == qnn_pool::k3x3s2) {
      qnn_pool::Window3x3s2<V, N> win;
      win.load(x, s, in, iy0, ix0);
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        uint32_t even[2 * N + 1], odd[2 * N + 1];
#pragma unroll
        for (int j = 0; j < 2 * N + 1; ++j) {
          even[j] = (win.w[0][j][i] & kEvenBytes) +
                    (win.w[1][j][i] & kEvenBytes) +
                    (win.w[2][j][i] & kEvenBytes);
          odd[j] = ((win.w[0][j][i] >> 8) & kEvenBytes) +
                   ((win.w[1][j][i] >> 8) & kEvenBytes) +
                   ((win.w[2][j][i] >> 8) & kEvenBytes);
        }
#pragma unroll
        for (int o = 0; o < N; ++o) {
          unpack_halves(even[2 * o] + even[2 * o + 1] + even[2 * o + 2],
                        odd[2 * o] + odd[2 * o + 1] + odd[2 * o + 2], sums);
          q[o][i] = requant_word<kB>(sums, 9 - win.inside(o), p);
        }
      }
    } else if constexpr (kWindow == qnn_pool::kAny) {
      // 16-bit halves of each word, the vector loaded once a tap.
      uint32_t even[kWords] = {}, odd[kWords] = {};
      int inside = 0;
      const qnn_pool::Taps taps(x, s, in, iy0, ix0);
      for (int ky = 0; ky < s.pool_h; ++ky) {
        if (!taps.row_in(ky)) continue;
        for (int kx = 0; kx < s.pool_w; ++kx) {
          if (!taps.col_in(kx)) continue;
          ++inside;
          uint32_t w[kWords];
          Vec<V>::load(taps.at(ky, kx), w);
#pragma unroll
          for (int i = 0; i < kWords; ++i) {
            even[i] += w[i] & kEvenBytes;
            odd[i] += (w[i] >> 8) & kEvenBytes;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        unpack_halves(even[i], odd[i], sums);
        q[0][i] = requant_word<kB>(sums, s.pool_h * s.pool_w - inside, p);
      }
    } else {
      // kAnyWide: a 32-bit sum a byte, one word at a time (four sums live).
      const qnn_pool::Taps taps(x, s, in, iy0, ix0);
#pragma unroll 1
      for (int i = 0; i < kWords; ++i) {
        sums[0] = sums[1] = sums[2] = sums[3] = 0;
        int inside = 0;
        for (int ky = 0; ky < s.pool_h; ++ky) {
          if (!taps.row_in(ky)) continue;
          for (int kx = 0; kx < s.pool_w; ++kx) {
            if (!taps.col_in(kx)) continue;
            ++inside;
            const uint32_t w = load_word<V>(taps.at(ky, kx), i);
#pragma unroll
            for (int j = 0; j < 4; ++j) sums[j] += (w >> (8 * j)) & 0xFFu;
          }
        }
        q[0][i] = requant_word<kB>(sums, s.pool_h * s.pool_w - inside, p);
      }
    }
#pragma unroll
    for (int o = 0; o < N; ++o) {
      if (o < outs) {
        Vec<V>::store(y + out + static_cast<int64_t>(o) * s.channels, q[o]);
      }
    }
  });
}

struct Launch {
  const uint8_t* x;
  uint8_t* y;
  Shape s;
  AvgParams p;
  cudaStream_t stream;

  template <int V, int kWindow>
  cudaError_t run() const {
    Shape shape = s;
    dim3 grid, block;
    qnn_pool::plan(shape, V, kWindow, grid, block);
    q8avgpool_kernel<V, kWindow><<<grid, block, 0, stream>>>(x, y, shape, p);
    return cudaGetLastError();
  }
};

}  // namespace

// vec and window: the instance kernels/pool.py:pool_instance picked; one
// that the shape or the bases do not allow is refused.
extern "C" int qnn_q8avgpool(int device, const void* x, void* y, int batch,
                             int height, int width, int channels,
                             int out_height, int out_width, int pool_h,
                             int pool_w, int stride_h, int stride_w,
                             int pad_top, int pad_left, int input_zero_point,
                             int bias, int multiplier, int shift,
                             int zero_point, int lo, int hi, int vec,
                             int window, void* stream) {
  const qnn::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) {
    return static_cast<int>(guard.error());
  }
  const Shape s{batch,    height,   width,    channels, out_height,
                out_width, pool_h,  pool_w,   stride_h, stride_w,
                pad_top,  pad_left, 1,        1,        0,
                0};
  if (!qnn_pool::instance_ok(vec, window, s, x, y, true)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<int64_t>(batch) * out_height * out_width * channels == 0) {
    return 0;
  }
  const Launch launch{static_cast<const uint8_t*>(x),
                      static_cast<uint8_t*>(y), s,
                      AvgParams{input_zero_point, bias, multiplier, shift,
                                zero_point, lo, hi},
                      static_cast<cudaStream_t>(stream)};
  return static_cast<int>(qnn_pool::dispatch(vec, window, launch));
}
