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
// 1/(sh*sw) of a byte read per output byte: memory bound.  Design: as
// u8maxpool.cu, one thread per output pixel x 4 channels, channels fastest
// across the threads so every tap's loads and the store are coalesced.
// With C % 4 == 0 each tap is one 32-bit load and the store one 32-bit
// word; otherwise the thread works byte by byte on its (up to) 4 channels.
// Out-of-image taps are only counted, and add izp once per tap at the end.
// Overlapping windows are re-read through L1/L2.
#include <cuda_runtime.h>

#include <cstdint>

#include "requant.cuh"

namespace {

constexpr int kThreads = 256;

struct PoolShape {
  int batch, height, width, channels;
  int out_height, out_width;
  int pool_h, pool_w;
  int stride_h, stride_w;
  int pad_top, pad_left;
};

struct AvgParams {
  int32_t input_zero_point, bias, multiplier, shift, zero_point, lo, hi;
};

__global__ void __launch_bounds__(kThreads)
    q8avgpool_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
                     PoolShape s, AvgParams p, bool vec4) {
  const int quads = (s.channels + 3) / 4;
  const int64_t total = static_cast<int64_t>(s.batch) * s.out_height *
                        s.out_width * quads;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       idx < total; idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int c0 = static_cast<int>(idx % quads) * 4;
    const int64_t pix = idx / quads;
    const int ox = static_cast<int>(pix % s.out_width);
    const int64_t rest = pix / s.out_width;
    const int oy = static_cast<int>(rest % s.out_height);
    const int64_t b = rest / s.out_height;
    const uint8_t* image = x + b * s.height * s.width * s.channels + c0;
    uint8_t* dst = y + pix * s.channels + c0;
    const int iy0 = oy * s.stride_h - s.pad_top;
    const int ix0 = ox * s.stride_w - s.pad_left;
    const int n = s.channels - c0 < 4 ? s.channels - c0 : 4;

    uint32_t acc[4] = {0, 0, 0, 0};
    int outside = 0;
    for (int ky = 0; ky < s.pool_h; ++ky) {
      const int iy = iy0 + ky;
      if (iy < 0 || iy >= s.height) {
        outside += s.pool_w;
        continue;
      }
      for (int kx = 0; kx < s.pool_w; ++kx) {
        const int ix = ix0 + kx;
        if (ix < 0 || ix >= s.width) {
          ++outside;
          continue;
        }
        const uint8_t* px =
            image + (static_cast<int64_t>(iy) * s.width + ix) * s.channels;
        if (vec4) {
          const uint32_t v = *reinterpret_cast<const uint32_t*>(px);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j] += (v >> (8 * j)) & 0xFFu;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j < n) acc[j] += px[j];
          }
        }
      }
    }
    const uint32_t base = static_cast<uint32_t>(p.bias) +
                          static_cast<uint32_t>(outside) *
                              static_cast<uint32_t>(p.input_zero_point);
    uint8_t q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      q[j] = qnn::avgpool_requant(static_cast<int32_t>(acc[j] + base),
                                  p.multiplier, p.shift, p.zero_point, p.lo,
                                  p.hi);
    }
    if (vec4) {
      *reinterpret_cast<uint32_t*>(dst) =
          static_cast<uint32_t>(q[0]) | (static_cast<uint32_t>(q[1]) << 8) |
          (static_cast<uint32_t>(q[2]) << 16) |
          (static_cast<uint32_t>(q[3]) << 24);
    } else {
      for (int j = 0; j < n; ++j) dst[j] = q[j];
    }
  }
}

}  // namespace

extern "C" int qnn_q8avgpool(int device, const void* x, void* y, int batch,
                             int height, int width, int channels,
                             int out_height, int out_width, int pool_h,
                             int pool_w, int stride_h, int stride_w,
                             int pad_top, int pad_left, int input_zero_point,
                             int bias, int multiplier, int shift,
                             int zero_point, int lo, int hi, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(batch) * out_height *
                        out_width * ((channels + 3) / 4);
  if (total == 0) return 0;
  const PoolShape s{batch,    height,   width,   channels, out_height,
                    out_width, pool_h,  pool_w,  stride_h, stride_w,
                    pad_top,  pad_left};
  const AvgParams p{input_zero_point, bias, multiplier, shift,
                    zero_point,       lo,   hi};
  const bool vec4 = channels % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(y) % 4 == 0;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;
  q8avgpool_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(y), s, p, vec4);
  return static_cast<int>(cudaGetLastError());
}
