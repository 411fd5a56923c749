// u8maxpool: uint8 max pooling, NHWC, with a fused clamp.
//
// Replaces the TPU kernel qnnpack_tpu/kernels/pool.py:u8maxpool_pallas (body
// _maxpool_kernel).
//
//   out[b, y, x, c] = clamp(max_taps x[b, y*sh - pt + ky*dh,
//                                      x*sw - pl + kx*dw, c],
//                           output_min, output_max)
//
// A tap outside the image reads 0, the uint8 minimum, as the padding of
// nn/pool.py:u8maxpool2d does (not the zero point); the clamp applies after
// the max.
//
// What bounds it: one compare per tap and output byte against one byte
// written and 1/(sh*sw) of a byte read per output byte: memory bound
// (pool1 of ResNet-18 at b128 moves 129 MB, 0.038 ms at 3.35 TB/s), if
// enough bytes are in flight and the index arithmetic stays out of the
// way.  Design (the instances and thread mapping of pool_tile.cuh):
//   - a thread takes one channel vector of V = 16, 8, 4 or 1 bytes (C = 64,
//     240 and 480 take 16, C = 24 takes 8), so that neighbouring threads
//     read neighbouring vectors of a pixel and a warp's loads coalesce;
//   - the 3 x 3 stride-2 window of every main-path pool is a compile-time
//     instance: a thread makes kOutputs = 2 adjacent outputs, loads the 3
//     rows x 5 columns they cover (the shared column once) with every load
//     issued before the first max, takes each column's max over its 3 rows
//     and then each output's over its 3 columns, __vmaxu4 on the vectors'
//     words (four byte maxima a call), and clamps.  Staging a block's input
//     rows in shared memory and 4 outputs a thread were slower at
//     ResNet-18's b128 pool1 (scripts/bench_pool.py, PERF.md);
//   - any other window runs the generic instance: one output a thread, the
//     runtime tap loop;
//   - the grid gives each thread its image, output row, column tile and
//     channel vector with no divide (pool_tile.cuh:walk).
#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"
#include "pool_tile.cuh"

namespace {

using qnn_pool::Shape;
using qnn_pool::Vec;

template <int V, int kWindow>
__global__ void __launch_bounds__(qnn_pool::kThreads)
    u8maxpool_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
                     Shape s, uint32_t lo4, uint32_t hi4) {
  constexpr int N = qnn_pool::outputs_of(kWindow);
  constexpr int kWords = Vec<V>::kWords;
  qnn_pool::walk<V, N>(s, [&](int64_t in, int64_t out, int iy0, int ix0,
                              int outs) {
    uint32_t m[N][kWords];
    if constexpr (kWindow == qnn_pool::k3x3s2) {
      qnn_pool::Window3x3s2<V, N> win;
      win.load(x, s, in, iy0, ix0);
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        uint32_t col[2 * N + 1];
#pragma unroll
        for (int j = 0; j < 2 * N + 1; ++j) {
          col[j] = __vmaxu4(__vmaxu4(win.w[0][j][i], win.w[1][j][i]),
                            win.w[2][j][i]);
        }
#pragma unroll
        for (int o = 0; o < N; ++o) {
          m[o][i] = __vmaxu4(__vmaxu4(col[2 * o], col[2 * o + 1]),
                             col[2 * o + 2]);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kWords; ++i) m[0][i] = 0;
      const qnn_pool::Taps taps(x, s, in, iy0, ix0);
      for (int ky = 0; ky < s.pool_h; ++ky) {
        if (!taps.row_in(ky)) continue;
        for (int kx = 0; kx < s.pool_w; ++kx) {
          if (!taps.col_in(kx)) continue;
          uint32_t w[kWords];
          Vec<V>::load(taps.at(ky, kx), w);
#pragma unroll
          for (int i = 0; i < kWords; ++i) m[0][i] = __vmaxu4(m[0][i], w[i]);
        }
      }
    }
#pragma unroll
    for (int o = 0; o < N; ++o) {
      if (o < outs) {
#pragma unroll
        for (int i = 0; i < kWords; ++i) {
          m[o][i] = __vminu4(__vmaxu4(m[o][i], lo4), hi4);
        }
        Vec<V>::store(y + out + static_cast<int64_t>(o) * s.channels, m[o]);
      }
    }
  });
}

struct Launch {
  const uint8_t* x;
  uint8_t* y;
  Shape s;
  uint32_t lo4, hi4;
  cudaStream_t stream;

  template <int V, int kWindow>
  cudaError_t run() const {
    Shape shape = s;
    dim3 grid, block;
    qnn_pool::plan(shape, V, kWindow, grid, block);
    u8maxpool_kernel<V, kWindow == qnn_pool::k3x3s2 ? qnn_pool::k3x3s2
                                                    : qnn_pool::kAny>
        <<<grid, block, 0, stream>>>(x, y, shape, lo4, hi4);
    return cudaGetLastError();
  }
};

}  // namespace

// vec and window: the instance kernels/pool.py:pool_instance picked; one
// that the shape or the bases do not allow is refused.
extern "C" int qnn_u8maxpool(int device, const void* x, void* y, int batch,
                             int height, int width, int channels,
                             int out_height, int out_width, int pool_h,
                             int pool_w, int stride_h, int stride_w,
                             int pad_top, int pad_left, int dil_h, int dil_w,
                             int output_min, int output_max, int vec,
                             int window, void* stream) {
  const qnn::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) {
    return static_cast<int>(guard.error());
  }
  const Shape s{batch,    height,   width,    channels, out_height,
                out_width, pool_h,  pool_w,   stride_h, stride_w,
                pad_top,  pad_left, dil_h,    dil_w,    0,
                0};
  if (!qnn_pool::instance_ok(vec, window, s, x, y, false)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<int64_t>(batch) * out_height * out_width * channels == 0) {
    return 0;
  }
  const Launch launch{static_cast<const uint8_t*>(x),
                      static_cast<uint8_t*>(y), s,
                      static_cast<uint32_t>(output_min) * 0x01010101u,
                      static_cast<uint32_t>(output_max) * 0x01010101u,
                      static_cast<cudaStream_t>(stream)};
  return static_cast<int>(qnn_pool::dispatch(vec, window, launch));
}
