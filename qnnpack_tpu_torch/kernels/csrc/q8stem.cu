// q8stem: stride-2 stem convolution from C_in <= 4 channels with kernel zero
// point 128, uint8 NHWC [B, H, W, C] x biased-int8 HWIO [Kh, Kw, C, O] ->
// uint8 NHWC [B, Ho, Wo, O].
//
// Replaces the TPU kernel qnnpack_tpu/kernels/q8stem.py:q8stem_pallas (body
// _kernel).
//
//   acc[b, y, x, o] = bias'[o] + sum_{ky, kx, c} A'[b, 2y - pt + ky,
//                                                  2x - pl + kx, c] W'[ky, kx, c, o]
//   out             = requantize(acc)   (any per-tensor scheme, or per-channel)
//
// kzp' = 0, so there is no row-sum term.  A tap outside the image reads the
// biased input zero point, the zero-point padding of nn/conv.py.
//
// Not carried over: the TPU kernel's 2x2 space-to-depth packing of the
// input (nn/conv.py:_stem_space_to_depth).  It exists to deepen the MXU's
// contraction from C_in = 3 to 16; here the window is read straight from
// NHWC.
//
// What bounds it: per output byte Kh*Kw*C multiply-adds (147 for the
// ResNet 7x7x3 stem) against one byte written and 3/4 of a byte read, so
// at the int8 tensor rate it is bound by bytes (122 MB, 0.036 ms at
// ResNet-18 b128), dominated by the output.  Design: the block stages the
// whole weight tensor in shared memory as 32-bit words [Kh][row words][O
// padded to 16], four consecutive (kx, c) bytes of one kernel row to a
// word (the 9,408 weight bytes of the ResNet stem take 10,752 bytes, the
// 864 of MobileNetV2's 1,152).  Each
// thread makes one output pixel x 16 output channels: per kernel row it
// packs its window row's Kw*C bytes into words and runs one __dp4a per word
// and channel, 16 int32 accumulators in registers, then requantizes and
// stores 16 bytes.  Neighbouring threads take neighbouring channel groups,
// then pixels, so stores are contiguous and the window loads of one pixel
// are shared through L1.  The grid is capped near the resident block count
// so each block stages the weights once for many pixels.
#include <cuda_runtime.h>

#include <cstdint>

#include "requant.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 16;  // output channels per thread

struct StemShape {
  int batch, height, width;
  int out_height, out_width, out_channels;
  int kernel_h, kernel_w;
  int pad_top, pad_left;
};

template <int C>
__global__ void __launch_bounds__(kThreads)
    q8stem_kernel(const uint8_t* __restrict__ a, const int8_t* __restrict__ w,
                  const int32_t* __restrict__ bias,
                  const float* __restrict__ scales, uint8_t* __restrict__ out,
                  StemShape s, int izp_biased, bool vec16, qnn::Requant rp) {
  extern __shared__ __align__(16) int32_t ws[];  // [Kh][row_words][o_pad]
  const int row_bytes = s.kernel_w * C;
  const int row_words = (row_bytes + 3) / 4;
  const int groups = (s.out_channels + kRun - 1) / kRun;
  const int o_pad = groups * kRun;

  const int n_words = s.kernel_h * row_words * o_pad;
  for (int i = threadIdx.x; i < n_words; i += blockDim.x) {
    const int o = i % o_pad;
    const int word = (i / o_pad) % row_words;
    const int ky = i / (o_pad * row_words);
    uint32_t v = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int byte = word * 4 + j;
      if (o < s.out_channels && byte < row_bytes) {
        const int kx = byte / C;
        const int c = byte - kx * C;
        const int8_t wv =
            w[((ky * s.kernel_w + kx) * C + c) * s.out_channels + o];
        v |= static_cast<uint32_t>(static_cast<uint8_t>(wv)) << (8 * j);
      }
    }
    ws[i] = static_cast<int32_t>(v);
  }
  __syncthreads();

  const uint32_t pad_byte = static_cast<uint8_t>(izp_biased);
  const int64_t total = static_cast<int64_t>(s.batch) * s.out_height *
                        s.out_width * groups;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       idx < total; idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int g = static_cast<int>(idx % groups);
    const int64_t pix = idx / groups;
    const int ox = static_cast<int>(pix % s.out_width);
    const int64_t rest = pix / s.out_width;
    const int oy = static_cast<int>(rest % s.out_height);
    const int64_t b = rest / s.out_height;
    const int iy0 = 2 * oy - s.pad_top;
    const int ix0 = 2 * ox - s.pad_left;
    const uint8_t* image = a + b * s.height * s.width * C;

    int32_t acc[kRun];
#pragma unroll
    for (int j = 0; j < kRun; ++j) acc[j] = 0;

    for (int ky = 0; ky < s.kernel_h; ++ky) {
      const int iy = iy0 + ky;
      const bool row_in = iy >= 0 && iy < s.height;
      const bool whole = row_in && ix0 >= 0 && ix0 + s.kernel_w <= s.width;
      const int64_t row_base =
          (static_cast<int64_t>(iy) * s.width + ix0) * C;
      const int32_t* wrow = ws + ky * row_words * o_pad + g * kRun;
      for (int word = 0; word < row_words; ++word) {
        uint32_t av = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int byte = word * 4 + j;
          if (byte < row_bytes) {
            const int ix = ix0 + byte / C;
            const bool in =
                whole || (row_in && ix >= 0 && ix < s.width);
            const uint32_t v = in ? (image[row_base + byte] ^ 0x80u)
                                  : pad_byte;
            av |= v << (8 * j);
          }
        }
        const int4* wv = reinterpret_cast<const int4*>(wrow + word * o_pad);
#pragma unroll
        for (int q = 0; q < kRun / 4; ++q) {
          const int4 w4 = wv[q];
          acc[4 * q + 0] = __dp4a(static_cast<int>(av), w4.x, acc[4 * q + 0]);
          acc[4 * q + 1] = __dp4a(static_cast<int>(av), w4.y, acc[4 * q + 1]);
          acc[4 * q + 2] = __dp4a(static_cast<int>(av), w4.z, acc[4 * q + 2]);
          acc[4 * q + 3] = __dp4a(static_cast<int>(av), w4.w, acc[4 * q + 3]);
        }
      }
    }

    const int o0 = g * kRun;
    uint8_t* dst = out + pix * s.out_channels + o0;
    uint32_t packed[kRun / 4] = {0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const int o = o0 + j;
      if (o < s.out_channels) {
        const int32_t v = static_cast<int32_t>(static_cast<uint32_t>(acc[j]) +
                                               static_cast<uint32_t>(bias[o]));
        const float cs = scales != nullptr ? scales[o] : rp.scale;
        const uint8_t q = qnn::requantize(v, rp, cs);
        if (vec16) {
          packed[j / 4] |= static_cast<uint32_t>(q) << (8 * (j % 4));
        } else {
          dst[j] = q;
        }
      }
    }
    if (vec16) {
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
  }
}

template <int C>
cudaError_t launch(const void* a, const void* w, const void* bias,
                   const void* scales, void* out, const StemShape& s,
                   int izp_biased, const qnn::Requant& rp,
                   cudaStream_t stream, int device) {
  const int row_words = (s.kernel_w * C + 3) / 4;
  const int o_pad = (s.out_channels + kRun - 1) / kRun * kRun;
  const size_t smem = static_cast<size_t>(s.kernel_h) * row_words * o_pad *
                      sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        q8stem_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int sms = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t total = static_cast<int64_t>(s.batch) * s.out_height *
                        s.out_width * (o_pad / kRun);
  int64_t blocks = (total + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * (2048 / kThreads);
  if (blocks > cap) blocks = cap;
  // 16-byte stores need O % 16 == 0 and an aligned output.
  const bool vec16 = s.out_channels % kRun == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
  q8stem_kernel<C><<<static_cast<unsigned>(blocks), kThreads, smem,
                     stream>>>(
      static_cast<const uint8_t*>(a), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(bias), static_cast<const float*>(scales),
      static_cast<uint8_t*>(out), s, izp_biased, vec16, rp);
  return cudaGetLastError();
}

}  // namespace

extern "C" int qnn_q8stem(int device, const void* a, const void* w,
                          const void* bias, const void* scales, void* out,
                          int batch, int height, int width, int channels,
                          int out_height, int out_width, int out_channels,
                          int kernel_h, int kernel_w, int pad_top,
                          int pad_left, int izp_biased, int scheme,
                          int multiplier, int shift, int zero_point, int qmin,
                          int qmax, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (static_cast<int64_t>(batch) * out_height * out_width * out_channels ==
      0) {
    return 0;
  }
  const StemShape s{batch,        height,   width,    out_height, out_width,
                    out_channels, kernel_h, kernel_w, pad_top,    pad_left};
  const qnn::Requant rp{scheme, multiplier, shift, zero_point, qmin, qmax,
                        scale};
  const auto st = static_cast<cudaStream_t>(stream);
  switch (channels) {
    case 1:
      err = launch<1>(a, w, bias, scales, out, s, izp_biased, rp, st, device);
      break;
    case 2:
      err = launch<2>(a, w, bias, scales, out, s, izp_biased, rp, st, device);
      break;
    case 3:
      err = launch<3>(a, w, bias, scales, out, s, izp_biased, rp, st, device);
      break;
    case 4:
      err = launch<4>(a, w, bias, scales, out, s, izp_biased, rp, st, device);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
