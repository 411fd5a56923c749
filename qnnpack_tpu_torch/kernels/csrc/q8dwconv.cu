// q8dwconv: depthwise Kh x Kw convolution, uint8 NHWC -> uint8 NHWC.
//
// Replaces the TPU kernel qnnpack_tpu/kernels/q8dwconv.py:q8dwconv_pallas.
//
//   acc[b, y, x, c] = bias'[c] + sum_taps A'[b, iy, ix, c] * (W'[t, c] - kzp')
//                   = c[c] + sum_taps A[b, iy, ix, c] * wd[t, c]   (mod 2^32)
//   out             = requantize(acc)   (per-tensor or per-channel)
//
// with A the raw uint8 input, wd = W' - kzp' and c = bias' - 128 sum_t wd,
// the packed record's bias_c (nn/packing.py kmajor_bias with K = Kh*Kw), so
// the input needs no rebias.  A tap outside the image reads the raw input
// zero point, which is what the zero-point padding of nn/conv.py puts
// there.  Any window, stride, padding and dilation; the window is read
// straight from NHWC, so the TPU kernel's phase-plane and halo layout
// (kernels/_layout.py) has no counterpart.
//
// What bounds it on this card: the bytes, 1 + 1/stride^2 of input and one
// of output per output byte - 0.231 ms for MobileNetV2's 17 layers at
// batch 128 at 3.35 TB/s; their 2.65 G multiply-adds take about 0.18 ms at
// the int32 IMAD rate (about 15 T/s) and half that as fp32 FFMA.  Reaching
// either takes few instructions and many warps in flight per byte.
// Design:
//   - a thread makes a strip of 4 outputs along W for V channels: V = 4
//     (one 32-bit word a pixel) where C % 4 == 0 and the pointers are
//     aligned, else V = 1.  Sixteen channels a thread would hold 64
//     accumulators and a kernel row's 48 weights.  Latency, not issue,
//     limits this kernel, so registers are capped at 80 for three blocks
//     of 256 an SM (a few bytes spilled); strips of 2 or 8, and a cap of
//     64 registers or none, were slower on MobileNetV2's b128 layers (H100
//     80GB HBM3, 700 W; PERF.md);
//   - the thread splits its index once, with multiply-shift divisions whose
//     constants the host computes; the grid's y dimension walks the images,
//     and only the image's base offset is 64 bits;
//   - a 3 x 3 window at dilation 1 and stride 1 or 2 (every depthwise layer
//     of MobileNetV2 and ShuffleNet) runs an instance with the taps
//     unrolled: each input column of the strip's window is loaded once a
//     kernel row and feeds every output that reads it, 3 * stride + 3 loads
//     a row instead of 12, and the kernel row's weights (one 16-byte load a
//     tap from the record's float table w_dw, nn/conv.py) sit in registers;
//   - it accumulates in fp32: every product and partial sum is an integer of
//     magnitude at most 9 * 255 * 255 < 2^22, so FFMA is exact, and it
//     issues at twice IMAD's rate.  An input byte becomes a float with one
//     byte permute and one add (the bits of 2^23 + byte, less 2^23), and
//     the sum leaves fp32 the same way (add 1.5 * 2^23, take the low bits),
//     not through a conversion, which issues at 16 a clock an SM;
//   - the uint32 bias add wraps as the reference's int32 sum; the
//     requantization of requant.cuh (fp32: __fmul_rn and rintf) runs with
//     its scheme fixed per copy of the store loop, and V = 4 stores one word
//     a pixel;
//   - any other window, stride or dilation runs a generic instance: runtime
//     tap loops, integer multiply-adds (exact for any window).
#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"
#include "requant.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStrip = 4;  // outputs a thread along W
// Blocks an SM of the 3 x 3 instances: 80 registers.
constexpr int kMinBlocks = 3;

// n / d for any uint32 n as a multiply-high, an add and a shift (Granlund
// and Montgomery); `make` runs on the host.
struct FastDiv {
  uint32_t m;
  int l;

  static FastDiv make(uint32_t d) {
    int l = 0;
    while ((uint64_t{1} << l) < d) ++l;
    const uint64_t m =
        ((uint64_t{1} << 32) * ((uint64_t{1} << l) - d)) / d + 1;
    return FastDiv{static_cast<uint32_t>(m), l};
  }

  __device__ __forceinline__ uint32_t div(uint32_t n) const {
    return static_cast<uint32_t>(
        (static_cast<uint64_t>(__umulhi(n, m)) + n) >> l);
  }
};

struct DwArgs {
  const uint8_t* a;
  const int8_t* w;        // [Kh*Kw, C] W'
  const float* wf;        // [Kh*Kw, C] W' - kzp'
  const int32_t* bias_c;  // [C]
  const float* scales;    // [C] or null
  uint8_t* out;
  int batch, height, width, channels, out_height, out_width;
  int kernel_h, kernel_w, stride_h, stride_w, pad_top, pad_left, dil_h,
      dil_w;
  int izp, kzp_biased;
  int vecs, strips;      // C / V, ceil(Wo / kStrip)
  int per_image;         // out_height * strips * vecs threads
  FastDiv div_vecs, div_strips;
  qnn::Requant rp;
};

// V floats (or ints) at p: one 16-byte load for V = 4.
template <int V>
__device__ __forceinline__ void load4(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void load4(const int32_t* p, uint32_t (&v)[V]) {
  if constexpr (V == 4) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = static_cast<uint32_t>(x.x);
    v[1] = static_cast<uint32_t>(x.y);
    v[2] = static_cast<uint32_t>(x.z);
    v[3] = static_cast<uint32_t>(x.w);
  } else {
    v[0] = static_cast<uint32_t>(__ldg(p));
  }
}

// The V bytes of one pixel's channel run (V = 4: one aligned word).
template <int V>
__device__ __forceinline__ uint32_t load_px(const uint8_t* p) {
  if constexpr (V == 4) {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    return __ldg(p);
  }
}

// Byte E of x as an exact float: the bits of 2^23 + byte, less 2^23.
template <int E>
__device__ __forceinline__ float byte_float(uint32_t x) {
  return __fsub_rn(__uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440 + E)),
                   8388608.0f);
}

// An integer-valued float of magnitude below 2^22 as an int32: the low
// bits of x + 1.5 * 2^23.
__device__ __forceinline__ uint32_t float_int(float x) {
  return static_cast<uint32_t>(__float_as_int(__fadd_rn(x, 12582912.0f)) -
                               0x4B400000);
}

// Requantize the strip (acc holds the sum without c) and store its first
// `valid` pixels, pixel s at dst + s * C.
template <int SCHEME, int V>
__device__ __forceinline__ void store_strip(const uint32_t (&acc)[kStrip][V],
                                            const uint32_t (&bias)[V],
                                            const float (&cs)[V],
                                            const qnn::Requant& rp_in,
                                            uint8_t* dst, int channels,
                                            int valid) {
  qnn::Requant rp = rp_in;
  rp.scheme = SCHEME;  // requantize()'s switch folds away
#pragma unroll
  for (int s = 0; s < kStrip; ++s) {
    if (s < valid) {
      uint32_t word = 0;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const auto x = static_cast<int32_t>(acc[s][v] + bias[v]);
        word |= static_cast<uint32_t>(qnn::requantize(x, rp, cs[v]))
                << (8 * v);
      }
      if constexpr (V == 4) {
        *reinterpret_cast<uint32_t*>(dst + s * channels) = word;
      } else {
        dst[s * channels] = static_cast<uint8_t>(word);
      }
    }
  }
}

// Add c[] and requantize with the launch's scheme; reads c and the channel
// scales here, after the sums, which keeps them out of the sums' registers.
template <int V>
__device__ __forceinline__ void store_any(const DwArgs& p,
                                          const uint32_t (&acc)[kStrip][V],
                                          int c0, uint8_t* dst, int valid) {
  uint32_t bias[V];
  float cs[V];
  load4<V>(p.bias_c + c0, bias);
  if (p.scales != nullptr) {
    load4<V>(p.scales + c0, cs);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) cs[v] = p.rp.scale;
  }
  switch (p.rp.scheme) {
    case qnn::kQ31:
      store_strip<qnn::kQ31, V>(acc, bias, cs, p.rp, dst, p.channels, valid);
      break;
    case qnn::kFP32:
      store_strip<qnn::kFP32, V>(acc, bias, cs, p.rp, dst, p.channels, valid);
      break;
    case qnn::kPrecise:
      store_strip<qnn::kPrecise, V>(acc, bias, cs, p.rp, dst, p.channels,
                                    valid);
      break;
    case qnn::kGemmlowp:
      store_strip<qnn::kGemmlowp, V>(acc, bias, cs, p.rp, dst, p.channels,
                                     valid);
      break;
    default:
      store_strip<qnn::kFP32PerChannel, V>(acc, bias, cs, p.rp, dst,
                                           p.channels, valid);
  }
}

// The thread's (output row, strip, channel run) within an image, or false
// past the image's last one.
struct Where {
  int oy, ox0, c0;
};

template <int V>
__device__ __forceinline__ bool where(const DwArgs& p, Where& at) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= p.per_image) return false;
  const int rest = static_cast<int>(p.div_vecs.div(idx));
  at.c0 = (idx - rest * p.vecs) * V;
  at.oy = static_cast<int>(p.div_strips.div(rest));
  at.ox0 = (rest - at.oy * p.strips) * kStrip;
  return true;
}

// 3 x 3 window, dilation 1, stride STRIDE in both dimensions.
template <int V, int STRIDE>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    dw3x3_kernel(const DwArgs p) {
  constexpr int kCols = (kStrip - 1) * STRIDE + 3;
  Where at;
  if (!where<V>(p, at)) return;
  const uint32_t zp_word = static_cast<uint32_t>(p.izp) * 0x01010101u;
  const int iy0 = at.oy * STRIDE - p.pad_top;
  const int ix0 = at.ox0 * STRIDE - p.pad_left;
  const int64_t image_bytes =
      static_cast<int64_t>(p.height) * p.width * p.channels;
  const int64_t out_image =
      static_cast<int64_t>(p.out_height) * p.out_width * p.channels;
  const int out_offset =
      (at.oy * p.out_width + at.ox0) * p.channels + at.c0;
  const int valid = min(kStrip, p.out_width - at.ox0);

  for (int b = blockIdx.y; b < p.batch; b += gridDim.y) {
    const uint8_t* image = p.a + b * image_bytes + at.c0;
    float acc[kStrip][V];
#pragma unroll
    for (int s = 0; s < kStrip; ++s) {
#pragma unroll
      for (int v = 0; v < V; ++v) acc[s][v] = 0.0f;
    }
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      const int iy = iy0 + ky;
      const bool row_in = static_cast<unsigned>(iy) <
                          static_cast<unsigned>(p.height);
      float wt[3][V];
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        load4<V>(p.wf + (ky * 3 + kx) * p.channels + at.c0, wt[kx]);
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int ix = ix0 + j;
        const bool in = row_in && static_cast<unsigned>(ix) <
                                      static_cast<unsigned>(p.width);
        const uint32_t word =
            in ? load_px<V>(image + (iy * p.width + ix) * p.channels)
               : zp_word;
        float x[V];
        x[0] = byte_float<0>(word);
        if constexpr (V == 4) {
          x[1] = byte_float<1>(word);
          x[2] = byte_float<2>(word);
          x[3] = byte_float<3>(word);
        }
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const int d = j - kx;
          if (d >= 0 && d % STRIDE == 0 && d / STRIDE < kStrip) {
#pragma unroll
            for (int v = 0; v < V; ++v) {
              acc[d / STRIDE][v] =
                  __fmaf_rn(x[v], wt[kx][v], acc[d / STRIDE][v]);
            }
          }
        }
      }
    }
    uint32_t sum[kStrip][V];
#pragma unroll
    for (int s = 0; s < kStrip; ++s) {
#pragma unroll
      for (int v = 0; v < V; ++v) sum[s][v] = float_int(acc[s][v]);
    }
    store_any<V>(p, sum, at.c0, p.out + b * out_image + out_offset, valid);
  }
}

// Any window, stride and dilation; integer multiply-adds.
template <int V>
__global__ void __launch_bounds__(kThreads)
    dw_generic_kernel(const DwArgs p) {
  Where at;
  if (!where<V>(p, at)) return;
  const uint32_t zp_word = static_cast<uint32_t>(p.izp) * 0x01010101u;
  const int iy0 = at.oy * p.stride_h - p.pad_top;
  const int ix0 = at.ox0 * p.stride_w - p.pad_left;
  const int64_t image_bytes =
      static_cast<int64_t>(p.height) * p.width * p.channels;
  const int64_t out_image =
      static_cast<int64_t>(p.out_height) * p.out_width * p.channels;
  const int out_offset =
      (at.oy * p.out_width + at.ox0) * p.channels + at.c0;
  const int valid = min(kStrip, p.out_width - at.ox0);

  for (int b = blockIdx.y; b < p.batch; b += gridDim.y) {
    const uint8_t* image = p.a + b * image_bytes + at.c0;
    uint32_t acc[kStrip][V];
#pragma unroll
    for (int s = 0; s < kStrip; ++s) {
#pragma unroll
      for (int v = 0; v < V; ++v) acc[s][v] = 0u;
    }
    for (int ky = 0; ky < p.kernel_h; ++ky) {
      const int iy = iy0 + ky * p.dil_h;
      const bool row_in = static_cast<unsigned>(iy) <
                          static_cast<unsigned>(p.height);
      for (int kx = 0; kx < p.kernel_w; ++kx) {
        const int8_t* wrow =
            p.w + (ky * p.kernel_w + kx) * p.channels + at.c0;
        uint32_t wd[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          wd[v] = static_cast<uint32_t>(__ldg(wrow + v) - p.kzp_biased);
        }
#pragma unroll
        for (int s = 0; s < kStrip; ++s) {
          const int ix = ix0 + s * p.stride_w + kx * p.dil_w;
          const bool in = row_in && static_cast<unsigned>(ix) <
                                        static_cast<unsigned>(p.width);
          const uint32_t word =
              in ? load_px<V>(image + (iy * p.width + ix) * p.channels)
                 : zp_word;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            acc[s][v] += __byte_perm(word, 0u, 0x4440 + v) * wd[v];
          }
        }
      }
    }
    store_any<V>(p, acc, at.c0, p.out + b * out_image + out_offset, valid);
  }
}

template <int V>
cudaError_t launch(DwArgs p, int window, cudaStream_t stream) {
  p.vecs = p.channels / V;
  p.strips = (p.out_width + kStrip - 1) / kStrip;
  p.per_image = p.out_height * p.strips * p.vecs;
  p.div_vecs = FastDiv::make(static_cast<uint32_t>(p.vecs));
  p.div_strips = FastDiv::make(static_cast<uint32_t>(p.strips));
  const dim3 grid((p.per_image + kThreads - 1) / kThreads,
                  p.batch < 65535 ? p.batch : 65535);
  if (window == 0) {
    dw_generic_kernel<V><<<grid, kThreads, 0, stream>>>(p);
  } else if (window == 1) {
    dw3x3_kernel<V, 1><<<grid, kThreads, 0, stream>>>(p);
  } else {
    dw3x3_kernel<V, 2><<<grid, kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

bool aligned(const void* p, uintptr_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

}  // namespace

// `w` is W' [Kh*Kw, C] (int8), `wf` W' - kzp' [Kh*Kw, C] (float32) and
// `bias_c` the raw-input folded bias [C]; `izp` is the raw input zero
// point.  `vec` (4 or 1 channels a thread) and `window` (0: any window; 1
// or 2: 3 x 3 at dilation 1 and that stride in both dimensions) name the
// instance, which kernels/q8dwconv.py:dw_instance picks; a launch outside
// the named instance's contract is refused.
extern "C" int qnn_q8dwconv(int device, const void* a, const void* w,
                            const void* wf, const void* bias_c,
                            const void* scales, void* out, int batch,
                            int height, int width, int channels,
                            int out_height, int out_width, int kernel_h,
                            int kernel_w, int stride_h, int stride_w,
                            int pad_top, int pad_left, int dil_h, int dil_w,
                            int izp, int kzp_biased, int vec, int window,
                            int scheme, int multiplier, int shift,
                            int zero_point, int qmin, int qmax, float scale,
                            void* stream) {
  const qnn::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) {
    return static_cast<int>(guard.error());
  }
  if (static_cast<int64_t>(batch) * out_height * out_width * channels == 0) {
    return 0;
  }
  if (channels < 1 || kernel_h < 1 || kernel_w < 1 || stride_h < 1 ||
      stride_w < 1 || dil_h < 1 || dil_w < 1 ||
      static_cast<int64_t>(height) * width * channels >= (int64_t{1} << 31) ||
      static_cast<int64_t>(out_height) * (out_width + kStrip) * channels >=
          (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DwArgs p{static_cast<const uint8_t*>(a),
                 static_cast<const int8_t*>(w),
                 static_cast<const float*>(wf),
                 static_cast<const int32_t*>(bias_c),
                 static_cast<const float*>(scales),
                 static_cast<uint8_t*>(out),
                 batch, height, width, channels, out_height, out_width,
                 kernel_h, kernel_w, stride_h, stride_w, pad_top, pad_left,
                 dil_h, dil_w, izp, kzp_biased, 0, 0, 0, FastDiv{},
                 FastDiv{},
                 qnn::Requant{scheme, multiplier, shift, zero_point, qmin,
                              qmax, scale}};
  const bool is_3x3 = kernel_h == 3 && kernel_w == 3 && dil_h == 1 &&
                      dil_w == 1 && stride_h == window && stride_w == window;
  // Words of input and output; 16-byte loads of weights, c and scales.
  const bool words = channels % 4 == 0 && aligned(a, 4) && aligned(out, 4) &&
                     aligned(wf, 16) && aligned(bias_c, 16) &&
                     aligned(scales, 16);
  if (window < 0 || window > 2 || (window != 0 && !is_3x3) ||
      (vec != 1 && vec != 4) || (vec == 4 && !words)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(vec == 4 ? launch<4>(p, window, st)
                                   : launch<1>(p, window, st));
}
