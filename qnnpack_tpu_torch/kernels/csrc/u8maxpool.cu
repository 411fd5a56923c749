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
// (pool1 of ResNet-18 at b128 moves 129 MB).  Design: one thread per output
// pixel x 4 channels, channels fastest across the threads so every tap's
// loads and the store are coalesced.  With C % 4 == 0 each tap is one
// 32-bit load and one __vmaxu4 (four byte maxes in one instruction), the
// clamp two more, and the store one 32-bit word; otherwise the thread
// works byte by byte on its (up to) 4 channels.  Overlapping windows are
// re-read through L1/L2.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

struct PoolShape {
  int batch, height, width, channels;
  int out_height, out_width;
  int pool_h, pool_w;
  int stride_h, stride_w;
  int pad_top, pad_left;
  int dil_h, dil_w;
};

__global__ void __launch_bounds__(kThreads)
    u8maxpool_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
                     PoolShape s, int output_min, int output_max, bool vec4) {
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

    if (vec4) {
      uint32_t acc = 0;
      for (int ky = 0; ky < s.pool_h; ++ky) {
        const int iy = iy0 + ky * s.dil_h;
        if (iy < 0 || iy >= s.height) continue;
        for (int kx = 0; kx < s.pool_w; ++kx) {
          const int ix = ix0 + kx * s.dil_w;
          if (ix < 0 || ix >= s.width) continue;
          const uint32_t v = *reinterpret_cast<const uint32_t*>(
              image + (static_cast<int64_t>(iy) * s.width + ix) * s.channels);
          acc = __vmaxu4(acc, v);
        }
      }
      acc = __vmaxu4(acc, static_cast<uint32_t>(output_min) * 0x01010101u);
      acc = __vminu4(acc, static_cast<uint32_t>(output_max) * 0x01010101u);
      *reinterpret_cast<uint32_t*>(dst) = acc;
    } else {
      const int n = s.channels - c0 < 4 ? s.channels - c0 : 4;
      uint8_t acc[4] = {0, 0, 0, 0};
      for (int ky = 0; ky < s.pool_h; ++ky) {
        const int iy = iy0 + ky * s.dil_h;
        if (iy < 0 || iy >= s.height) continue;
        for (int kx = 0; kx < s.pool_w; ++kx) {
          const int ix = ix0 + kx * s.dil_w;
          if (ix < 0 || ix >= s.width) continue;
          const uint8_t* p =
              image + (static_cast<int64_t>(iy) * s.width + ix) * s.channels;
          for (int j = 0; j < n; ++j) acc[j] = p[j] > acc[j] ? p[j] : acc[j];
        }
      }
      for (int j = 0; j < n; ++j) {
        int v = acc[j] < output_min ? output_min : acc[j];
        v = v > output_max ? output_max : v;
        dst[j] = static_cast<uint8_t>(v);
      }
    }
  }
}

}  // namespace

extern "C" int qnn_u8maxpool(int device, const void* x, void* y, int batch,
                             int height, int width, int channels,
                             int out_height, int out_width, int pool_h,
                             int pool_w, int stride_h, int stride_w,
                             int pad_top, int pad_left, int dil_h, int dil_w,
                             int output_min, int output_max, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(batch) * out_height *
                        out_width * ((channels + 3) / 4);
  if (total == 0) return 0;
  const PoolShape s{batch,    height,   width,   channels, out_height,
                    out_width, pool_h,  pool_w,  stride_h, stride_w,
                    pad_top,  pad_left, dil_h,   dil_w};
  const bool vec4 = channels % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(y) % 4 == 0;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;
  u8maxpool_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(y), s,
      output_min, output_max, vec4);
  return static_cast<int>(cudaGetLastError());
}
