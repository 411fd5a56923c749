// q8conv: dense or grouped convolution as an implicit GEMM,
// uint8 NHWC [B, H, W, G*Icpg] x biased-int8 HWIO [Kh, Kw, Icpg, G*Ocpg]
// -> uint8 NHWC [B, Ho, Wo, G*Ocpg].
//
// Replaces the TPU kernel qnnpack_tpu/kernels/q8conv.py:q8conv_pallas (body
// _q8conv_kernel), which runs a dense conv as Kh*Kw per-tap MXU products over
// phase planes, and the grouped branches of qnnpack_tpu/nn/conv.py:
// q8conv2d_acc (split, einsum and feature_group_count), which the JAX
// package leaves to XLA.  Here group g (blockIdx.z) is one GEMM with
//
//   M = B*Ho*Wo output pixels, N = Ocpg, K = Kh*Kw*Icpg in the pack's
//   [kh, kw, c] order
//   acc[m, n] = sum_k A'[m, k] W'[k, g*Ocpg + n] - kzp' * sum_k A'[m, k]
//               + bias'[g*Ocpg + n]
//   out[m, g*Ocpg + n] = requantize(acc[m, n])   (any scheme, in registers)
//
// and the A tile is gathered from NHWC by (b, oy, ox) x (ky, kx, g*Icpg + c)
// as it is loaded: no im2col matrix exists.  The row sum runs over the
// group's own channels, as the JAX package's per-group window sums do.  A tap
// outside the image reads the biased input zero point, the value the
// zero-point padding of nn/conv.py puts there, so it enters the product and
// the row sum as the folded bias expects (count = Kh*Kw*Icpg).  The K loop
// runs over taps, then over the group's channels in steps of 32, so a step
// never straddles two taps and each loader thread finds its input pixel once
// per tap; channels past Icpg in a tap's last step hold biased 0 and meet
// zero weights.  G = 1 is the dense conv.
//
// What bounds it: the ResNet-18 bodies have K = 576..4608, far above the
// int8 ridge, so they are bound by operations (1,979 TOP/s on the int8
// tensor cores); ShuffleNet's grouped 1x1 layers (K = 20..320 per group) are
// bound by bytes.  Design: the 64 x 64 tile of igemm_tile.cuh, as in q8gemm
// (__dp4a on the CUDA cores, the row sum for kzp != 128 beside it), with
// 8-byte vector loads of A when Icpg % 8 == 0 (so every group's channel base
// is 8-byte aligned).  It sits far from the tensor-core bound, and a group
// narrower than 64 columns leaves part of each tile idle; mma.sync / wgmma
// and narrower tiles are work for a later change.
#include <cuda_runtime.h>

#include <cstdint>

#include "igemm_tile.cuh"

namespace {

using qnn::kTileK;
using qnn::kTileM;
using qnn::kTileN;
using qnn::kTileRow;
using qnn::kTileThreads;

struct ConvShape {
  int batch, height, width, channels;        // channels = groups * Icpg
  int out_height, out_width, out_channels;   // out_channels = groups * Ocpg
  int group_channels, group_out_channels;    // Icpg, Ocpg
  int kernel_h, kernel_w;
  int stride_h, stride_w;
  int pad_top, pad_left;
  int dil_h, dil_w;
};

__global__ void __launch_bounds__(kTileThreads)
    q8conv_kernel(const uint8_t* __restrict__ a, const int8_t* __restrict__ w,
                  const int32_t* __restrict__ bias,
                  const float* __restrict__ scales, uint8_t* __restrict__ out,
                  ConvShape s, int izp_biased, int kzp_biased, bool vec8,
                  qnn::Requant rp) {
  __shared__ __align__(16) int8_t as[kTileM][kTileRow];
  __shared__ __align__(16) int8_t ws[kTileN][kTileRow];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int64_t m = static_cast<int64_t>(s.batch) * s.out_height *
                    s.out_width;
  const int n = s.group_out_channels;
  const int c_in = s.group_channels;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kTileM;
  const int n0 = blockIdx.y * kTileN;
  const int group = blockIdx.z;
  const int w_col0 = group * n;  // the group's first column of W and out

  qnn::TileAcc t;
  qnn::tile_zero(t);

  // Loader coordinates: A tile 64 pixels x 32 channels, 8 channels of one
  // pixel per thread; W tile 32 k-rows x 64 columns, 8 columns per thread.
  const int a_row = tid / 4;
  const int a_col = (tid % 4) * 8;
  const int w_row = tid / 8;
  const int w_col = (tid % 8) * 8;

  // This thread's output pixel: its window origin, and its image from the
  // group's first channel on.
  const int64_t a_gm = m0 + a_row;
  const bool row_valid = a_gm < m;
  int iy0 = 0;
  int ix0 = 0;
  const uint8_t* image = a + group * c_in;
  if (row_valid) {
    const int ox = static_cast<int>(a_gm % s.out_width);
    const int64_t rest = a_gm / s.out_width;
    const int oy = static_cast<int>(rest % s.out_height);
    const int64_t b = rest / s.out_height;
    iy0 = oy * s.stride_h - s.pad_top;
    ix0 = ox * s.stride_w - s.pad_left;
    image += b * s.height * s.width * s.channels;
  }
  const int8_t pad_value = static_cast<int8_t>(izp_biased);

  for (int ky = 0; ky < s.kernel_h; ++ky) {
    const int iy = iy0 + ky * s.dil_h;
    for (int kx = 0; kx < s.kernel_w; ++kx) {
      const int ix = ix0 + kx * s.dil_w;
      const bool inside = row_valid && iy >= 0 && iy < s.height && ix >= 0 &&
                          ix < s.width;
      const uint8_t* pixel =
          image + (static_cast<int64_t>(inside ? iy : 0) * s.width +
                   (inside ? ix : 0)) * s.channels;
      const int64_t w_tap =
          static_cast<int64_t>(ky * s.kernel_w + kx) * c_in;
      for (int c0 = 0; c0 < c_in; c0 += kTileK) {
        const int c = c0 + a_col;
        if (vec8 && inside && c + 8 <= c_in) {
          const uint2 v = *reinterpret_cast<const uint2*>(pixel + c);
          *reinterpret_cast<uint32_t*>(&as[a_row][a_col]) = v.x ^ 0x80808080u;
          *reinterpret_cast<uint32_t*>(&as[a_row][a_col + 4]) =
              v.y ^ 0x80808080u;
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            int8_t v = 0;
            if (row_valid && c + j < c_in) {
              v = inside ? static_cast<int8_t>(pixel[c + j] ^ 0x80)
                         : pad_value;
            }
            as[a_row][a_col + j] = v;
          }
        }
        const int wc = c0 + w_row;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int gn = n0 + w_col + j;
          int8_t v = 0;
          if (wc < c_in && gn < n) {
            v = w[(w_tap + wc) * s.out_channels + w_col0 + gn];
          }
          ws[w_col + j][w_row] = v;
        }
        __syncthreads();
        qnn::tile_step(as, ws, tx, ty, kzp_biased != 0, t);
        __syncthreads();
      }
    }
  }
  qnn::tile_store(t, m0, n0, m, n, s.out_channels, w_col0, tx, ty, bias,
                  scales, kzp_biased, rp, out);
}

}  // namespace

extern "C" int qnn_q8conv(int device, const void* a, const void* w,
                          const void* bias, const void* scales, void* out,
                          int batch, int height, int width, int channels,
                          int out_height, int out_width, int out_channels,
                          int groups, int kernel_h, int kernel_w,
                          int stride_h, int stride_w, int pad_top,
                          int pad_left, int dil_h, int dil_w, int izp_biased,
                          int kzp_biased, int scheme, int multiplier,
                          int shift, int zero_point, int qmin, int qmax,
                          float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t m = static_cast<int64_t>(batch) * out_height * out_width;
  if (m == 0 || out_channels == 0) return 0;
  if (groups < 1 || channels % groups != 0 || out_channels % groups != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int icpg = channels / groups;
  const int ocpg = out_channels / groups;
  const ConvShape s{batch,     height,       width,    channels,
                    out_height, out_width,   out_channels,
                    icpg,      ocpg,         kernel_h, kernel_w,
                    stride_h,  stride_w,     pad_top,  pad_left,
                    dil_h,     dil_w};
  const qnn::Requant rp{scheme, multiplier, shift, zero_point, qmin, qmax,
                        scale};
  const bool vec8 = icpg % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 8 == 0;
  const dim3 grid(static_cast<unsigned>((m + kTileM - 1) / kTileM),
                  static_cast<unsigned>((ocpg + kTileN - 1) / kTileN),
                  static_cast<unsigned>(groups));
  q8conv_kernel<<<grid, kTileThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(bias), static_cast<const float*>(scales),
      static_cast<uint8_t*>(out), s, izp_biased, kzp_biased, vec8, rp);
  return static_cast<int>(cudaGetLastError());
}
