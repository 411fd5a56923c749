// q8dwconv: depthwise Kh x Kw convolution, uint8 NHWC -> uint8 NHWC.
//
// Replaces the TPU kernel qnnpack_tpu/kernels/q8dwconv.py:q8dwconv_pallas.
//
//   acc[b, y, x, c] = bias'[c] + sum_taps A'[b, iy, ix, c] * (W'[t, c] - kzp')
//   out             = requantize(acc)   (per-tensor or per-channel)
//
// A tap outside the image reads the biased input zero point, which is what
// the zero-point padding of nn/conv.py puts there.  Any stride, padding and
// dilation; the window is read straight from NHWC, so the TPU kernel's
// phase-plane and halo layout (kernels/_layout.py) has no counterpart.
//
// What bounds it: one multiply-add per tap and output byte, about 18 int
// operations per output byte against 1 + 1/stride^2 bytes moved - memory
// bound on the card.  Design: one thread per output element with channels
// contiguous across the threads of a warp, so each tap's loads and the
// output store are coalesced along C; the Kh*Kw taps of a 3x3 window are
// re-read from L1/L2 by the neighbouring outputs.
#include <cuda_runtime.h>

#include <cstdint>

#include "requant.cuh"

namespace {

constexpr int kThreads = 256;

struct DwShape {
  int batch, height, width, channels;
  int out_height, out_width;
  int kernel_h, kernel_w;
  int stride_h, stride_w;
  int pad_top, pad_left;
  int dil_h, dil_w;
};

__global__ void __launch_bounds__(kThreads)
    q8dwconv_kernel(const uint8_t* __restrict__ a,
                    const int8_t* __restrict__ w,
                    const int32_t* __restrict__ bias,
                    const float* __restrict__ scales,
                    uint8_t* __restrict__ out, DwShape s, int izp_biased,
                    int kzp_biased, qnn::Requant rp) {
  const int64_t total = static_cast<int64_t>(s.batch) * s.out_height *
                        s.out_width * s.channels;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       idx < total; idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(idx % s.channels);
    int64_t rest = idx / s.channels;
    const int ox = static_cast<int>(rest % s.out_width);
    rest /= s.out_width;
    const int oy = static_cast<int>(rest % s.out_height);
    const int b = static_cast<int>(rest / s.out_height);

    uint32_t acc = static_cast<uint32_t>(bias[c]);
    const uint8_t* image =
        a + static_cast<int64_t>(b) * s.height * s.width * s.channels + c;
    for (int ky = 0; ky < s.kernel_h; ++ky) {
      const int iy = oy * s.stride_h - s.pad_top + ky * s.dil_h;
      const bool row_in = iy >= 0 && iy < s.height;
      for (int kx = 0; kx < s.kernel_w; ++kx) {
        const int ix = ox * s.stride_w - s.pad_left + kx * s.dil_w;
        int32_t av = izp_biased;
        if (row_in && ix >= 0 && ix < s.width) {
          av = static_cast<int32_t>(
                   image[(static_cast<int64_t>(iy) * s.width + ix) *
                         s.channels]) -
               128;
        }
        const int32_t wd =
            static_cast<int32_t>(w[(ky * s.kernel_w + kx) * s.channels + c]) -
            kzp_biased;
        acc += static_cast<uint32_t>(av * wd);
      }
    }
    const float cs = scales != nullptr ? scales[c] : rp.scale;
    out[idx] = qnn::requantize(static_cast<int32_t>(acc), rp, cs);
  }
}

}  // namespace

extern "C" int qnn_q8dwconv(int device, const void* a, const void* w,
                            const void* bias, const void* scales, void* out,
                            int batch, int height, int width, int channels,
                            int out_height, int out_width, int kernel_h,
                            int kernel_w, int stride_h, int stride_w,
                            int pad_top, int pad_left, int dil_h, int dil_w,
                            int izp_biased, int kzp_biased, int scheme,
                            int multiplier, int shift, int zero_point,
                            int qmin, int qmax, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const DwShape s{batch,    height,   width,    channels, out_height,
                  out_width, kernel_h, kernel_w, stride_h, stride_w,
                  pad_top,  pad_left, dil_h,    dil_w};
  const int64_t total =
      static_cast<int64_t>(batch) * out_height * out_width * channels;
  if (total == 0) return 0;
  const qnn::Requant rp{scheme, multiplier, shift, zero_point, qmin, qmax,
                        scale};
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;
  q8dwconv_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(bias), static_cast<const float*>(scales),
      static_cast<uint8_t*>(out), s, izp_biased, kzp_biased, rp);
  return static_cast<int>(cudaGetLastError());
}
