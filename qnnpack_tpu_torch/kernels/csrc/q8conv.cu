// q8conv: dense or grouped convolution as an implicit GEMM,
// uint8 NHWC [B, H, W, G*Icpg] x biased-int8 weights -> uint8 NHWC
// [B, Ho, Wo, G*Ocpg].
//
// Replaces the TPU kernel qnnpack_tpu/kernels/q8conv.py:q8conv_pallas (body
// _q8conv_kernel), which runs a dense conv as Kh*Kw per-tap MXU products over
// phase planes, and the grouped branches of qnnpack_tpu/nn/conv.py:
// q8conv2d_acc (split, einsum and feature_group_count), which the JAX
// package leaves to XLA.  Here group g is one GEMM with
//
//   M = B*Ho*Wo output pixels, N = Ocpg, K = Kh*Kw*Icpg in [kh, kw, c] order
//   acc[m, n] = sum_k A[m, k] W'[k, g*Ocpg + n] + c[g*Ocpg + n]
//               - kzp' * sum_k A[m, k]                         (mod 2^32)
//   out[m, g*Ocpg + n] = requantize(acc[m, n])   (any scheme, in registers)
//
// with c folded at pack time (nn/conv.py), and the A tile gathered from
// NHWC by (b, oy, ox) x (ky, kx, g*Icpg + c) as it is loaded: no im2col
// matrix exists.  The weights come K-major, [G*Ocpg, Kh*Kw, Icpg_p] with
// Icpg_p = Icpg rounded up to the 64-byte K step and zeros past Icpg.  The
// K loop runs over taps, then over the group's channels in stages of 64
// (or 128) bytes, so a stage never straddles two taps.  Three kinds of A chunk:
//   - inside the image: cp.async of 16, 8 or 4 bytes, the widest that Icpg
//     and the base address allow (plain byte copies for Icpg = 3, 5, 7...);
//   - outside the image: the raw input zero point, stored with st.shared,
//     the value the zero-point padding of nn/conv.py puts there and that
//     the folded bias counts (K = Kh*Kw*Icpg) - cp.async's zero fill would
//     give 0;
//   - channels past Icpg in a tap's last step: raw 0, which meets zero
//     weights and adds nothing to the row sum.
// The group is blockIdx.z / splits.  G = 1 is the dense conv.
//
// A second instance of each shape is the partial of input-channel-sharded
// tensor parallelism (parallel/mesh.py:conv_ic_tp): after the K loop (and
// split-K's reduction) it stores the raw int32 acc - kzp' * sum_k A over
// the record's taps and channels, [M, G*Ocpg], with no c and no
// requantization (imma_tile.cuh store_partial).  Its zero-point taps read
// izp on every shard and its row sum counts them, which is the unsharded
// window sum over the padded input; the channel slices' partials, summed
// in int32 across ranks, plus the full record's c, are acc mod 2^32.  A
// compile-time flag (PARTIAL), so the plain instances are unchanged.
//
// What bounds it: the ResNet-18 bodies have K = 576..4608, far above the
// int8 ridge, so they are bound by the tensor cores; ShuffleNet's grouped
// 1x1 layers (K = 20..320 a group) are bound by bytes.  Design: the
// tensor-core tile of imma_tile.cuh, as in q8gemm (u8 x s8 mma.sync fed by
// ldmatrix from a cp.async ring, four block shapes and split-K picked by
// the wrapper; 128-byte stages only where Icpg_p holds whole ones); a table
// of each block row's window origin in shared memory, so any copy width
// finds its pixel without a divide.  TMA cannot gather this tile: its
// out-of-bounds fill is 0, not the zero point.
#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"
#include "imma_tile.cuh"

namespace {

namespace im = qnn::imma;

constexpr int kOutside = -(1 << 29);  // window origin of a row past M

struct ConvArgs {
  const uint8_t* a;
  const int8_t* w;  // K-major [G*Ocpg, Kh*Kw, icpg_p]
  const int32_t* bias_c;
  const float* scales;
  uint8_t* out;
  int batch, height, width, channels;       // channels = groups * icpg
  int out_height, out_width, out_channels;  // out_channels = groups * ocpg
  int icpg, ocpg, icpg_p;
  int kernel_h, kernel_w, stride_h, stride_w, pad_top, pad_left, dil_h,
      dil_w;
  int izp, kzp_biased, copy_w;
  qnn::Requant rp;
  im::Split sp;
};

// The partial instance's arguments.
struct PartialConvArgs : ConvArgs {
  int32_t* acc_out;  // [M, out_channels] int32
};

// Each block row's window origin (iy0, ix0) and image base pixel b*H*W.
struct RowTable {
  const int* iy0;
  const int* ix0;
  const int* base;
};

// A tile of one K step: BM rows x 64 channels [c0, c0 + 64) of tap (dy, dx)
// (already scaled by the dilation); `image` is the group's first channel.
template <class T, int W>
__device__ __forceinline__ void load_a(uint8_t* sa, const uint8_t* image,
                                       const RowTable& rows, int height,
                                       int width, int channels, int icpg,
                                       int dy, int dx, int c0,
                                       uint32_t fill_word) {
  constexpr int kPerRow = T::kStep / W;
  // Unrolled only for the wide copies: the byte loop's 32 addresses would
  // otherwise be hoisted out of the K loop into registers.
#pragma unroll(W >= 8 ? T::BM * kPerRow / T::kThreads : 1)
  for (int j = 0; j < T::BM * kPerRow / T::kThreads; ++j) {
    const int idx = threadIdx.x + j * T::kThreads;
    const int r = idx / kPerRow;
    const int col = (idx % kPerRow) * W;
    uint8_t* dst = sa + r * T::kPitch + col;
    const int c = c0 + col;
    if (c >= icpg) {  // icpg % W == 0: whole chunks only
      im::fill<W>(dst, 0u);
      continue;
    }
    const int iy = rows.iy0[r] + dy;
    const int ix = rows.ix0[r] + dx;
    if (static_cast<unsigned>(iy) < static_cast<unsigned>(height) &&
        static_cast<unsigned>(ix) < static_cast<unsigned>(width)) {
      const int64_t pixel = rows.base[r] + static_cast<int64_t>(iy) * width +
                            ix;
      im::copy_in<W>(dst, image + pixel * channels + c, true);
    } else {
      im::fill<W>(dst, fill_word);
    }
  }
}

// W = 16: every in-image A copy is 16 bytes (the main paths' case,
// compiled on its own); W = 0: the width is `copy_w`.
template <class T, int W>
struct ConvLoader {
  const uint8_t* image;  // the group's first input channel
  const int8_t* w_rows;  // the weights' row g*Ocpg + n0
  RowTable rows;
  int height, width, channels, icpg, icpg_p, kernel_w, dil_h, dil_w;
  int steps_per_tap, taps, n_rows, copy_w;
  uint32_t fill_word;

  __device__ __forceinline__ void load(uint8_t* sa, uint8_t* sb,
                                       int step) const {
    const int tap = step / steps_per_tap;
    const int c0 = (step - tap * steps_per_tap) * T::kStep;
    const int ky = tap / kernel_w;
    const int dy = ky * dil_h;
    const int dx = (tap - ky * kernel_w) * dil_w;
    switch (W == 16 ? 16 : copy_w) {
      case 16:
        load_a<T, 16>(sa, image, rows, height, width, channels, icpg, dy, dx,
                      c0, fill_word);
        break;
      case 8:
        load_a<T, 8>(sa, image, rows, height, width, channels, icpg, dy, dx,
                     c0, fill_word);
        break;
      case 4:
        load_a<T, 4>(sa, image, rows, height, width, channels, icpg, dy, dx,
                     c0, fill_word);
        break;
      default:
        load_a<T, 1>(sa, image, rows, height, width, channels, icpg, dy, dx,
                     c0, fill_word);
    }
    im::load_b<T>(sb, w_rows, static_cast<int64_t>(taps) * icpg_p,
                  static_cast<int64_t>(tap) * icpg_p + c0, n_rows);
  }
};

template <class T, int W, bool PARTIAL, class Args>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
    q8conv_kernel(const Args p) {
  extern __shared__ __align__(16) uint8_t ring[];
  __shared__ int iy0[T::BM];
  __shared__ int ix0[T::BM];
  __shared__ int base[T::BM];
  __shared__ int flag;
  const int64_t m =
      static_cast<int64_t>(p.batch) * p.out_height * p.out_width;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * T::BM;
  const int n0 = blockIdx.y * T::BN;
  const int group = blockIdx.z / p.sp.splits;
  const int split = blockIdx.z % p.sp.splits;

  for (int r = threadIdx.x; r < T::BM; r += T::kThreads) {
    const int64_t gm = m0 + r;
    if (gm < m) {
      const int ox = static_cast<int>(gm % p.out_width);
      const int64_t rest = gm / p.out_width;
      const int oy = static_cast<int>(rest % p.out_height);
      const int b = static_cast<int>(rest / p.out_height);
      iy0[r] = oy * p.stride_h - p.pad_top;
      ix0[r] = ox * p.stride_w - p.pad_left;
      base[r] = b * p.height * p.width;
    } else {
      iy0[r] = kOutside;
      ix0[r] = kOutside;
      base[r] = 0;
    }
  }
  __syncthreads();

  const int taps = p.kernel_h * p.kernel_w;
  const int steps_per_tap = p.icpg_p / T::kStep;
  // The split's K units of 64 bytes, as ring stages of T::kStep bytes.
  const int units = taps * (p.icpg_p / im::kStepK);
  const int unit0 = split * p.sp.steps_per_split;
  const int nunits = min(p.sp.steps_per_split, units - unit0);
  const int step0 = unit0 / T::kUnits;
  const int nsteps = (nunits + T::kUnits - 1) / T::kUnits;
  const int row0 = group * p.ocpg + n0;
  const ConvLoader<T, W> ld{
      p.a + group * p.icpg,
      p.w + static_cast<int64_t>(row0) * taps * p.icpg_p,
      RowTable{iy0, ix0, base},
      p.height, p.width, p.channels, p.icpg, p.icpg_p, p.kernel_w, p.dil_h,
      p.dil_w, steps_per_tap, taps, p.ocpg - n0, p.copy_w,
      static_cast<uint32_t>(p.izp) * 0x01010101u};
  im::Acc<T> acc;
  im::mainloop<T>(ld, ring, step0, nsteps, p.kzp_biased != 0, acc);
  if (p.sp.splits > 1) {
    const int64_t tile =
        (static_cast<int64_t>(group) * gridDim.y + blockIdx.y) * gridDim.x +
        blockIdx.x;
    if (!im::split_reduce<T>(acc, p.sp, tile, split, &flag)) return;
  }
  if constexpr (PARTIAL) {
    im::store_partial<T>(acc, m0, n0, m, p.ocpg, p.out_channels,
                         group * p.ocpg, p.kzp_biased, p.acc_out);
  } else {
    im::epilogue<T>(acc, ring, m0, n0, m, p.ocpg, p.out_channels,
                    group * p.ocpg, p.bias_c, p.scales, p.kzp_biased, p.rp,
                    p.out);
  }
}

template <class T, bool PARTIAL, class Args>
cudaError_t launch(const Args& p, int groups, int device,
                   cudaStream_t stream) {
  static unsigned ready = 0;
  const cudaError_t err = im::allow_smem(
      q8conv_kernel<T, 16, PARTIAL, Args>, q8conv_kernel<T, 0, PARTIAL, Args>,
      T::kSmemBytes, device, ready);
  if (err != cudaSuccess) return err;
  const auto kernel = p.copy_w == 16 ? q8conv_kernel<T, 16, PARTIAL, Args>
                                     : q8conv_kernel<T, 0, PARTIAL, Args>;
  const int64_t m =
      static_cast<int64_t>(p.batch) * p.out_height * p.out_width;
  const dim3 grid(static_cast<unsigned>((m + T::BM - 1) / T::BM),
                  static_cast<unsigned>((p.ocpg + T::BN - 1) / T::BN),
                  static_cast<unsigned>(groups * p.sp.splits));
  kernel<<<grid, T::kThreads, T::kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

template <bool PARTIAL, class Args>
cudaError_t launch_tile(const Args& p, int groups, int tile, int device,
                        cudaStream_t s) {
  switch (tile) {
    case 0:
      return launch<im::Tile128x128, PARTIAL>(p, groups, device, s);
    case 1:
      return launch<im::Tile128x64, PARTIAL>(p, groups, device, s);
    case 2:
      return launch<im::Tile64x64, PARTIAL>(p, groups, device, s);
    case 3:  // a step never straddles two taps
      if (p.icpg_p % im::Tile128x128Deep::kStep ||
          (p.sp.splits > 1 &&
           p.sp.steps_per_split % im::Tile128x128Deep::kUnits)) {
        return cudaErrorInvalidValue;
      }
      return launch<im::Tile128x128Deep, PARTIAL>(p, groups, device, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The geometry and plan are usable (see qnn_q8conv); sets icpg and ocpg.
bool conv_ok(int batch, int height, int width, int channels,
             int out_channels, int groups, int kernel_h, int kernel_w,
             int icpg_p, int splits, int steps_per_split,
             const void* workspace, const void* counters, const void* w,
             int& icpg, int& ocpg) {
  if (groups < 1 || channels % groups != 0 || out_channels % groups != 0) {
    return false;
  }
  icpg = channels / groups;
  ocpg = out_channels / groups;
  const int steps = kernel_h * kernel_w * (icpg_p / im::kStepK);
  return icpg_p % im::kStepK == 0 && icpg_p >= icpg && steps >= 1 &&
         splits >= 1 && steps_per_split >= 1 &&
         steps_per_split <= im::kMaxChainSteps &&
         static_cast<int64_t>(splits) * steps_per_split >= steps &&
         (splits - 1) * steps_per_split < steps &&
         static_cast<int64_t>(groups) * splits <= 65535 &&
         static_cast<int64_t>(batch) * height * width < (int64_t{1} << 31) &&
         (splits == 1 || (workspace != nullptr && counters != nullptr)) &&
         reinterpret_cast<uintptr_t>(w) % 16 == 0;
}

}  // namespace

// tile, splits, workspace and counters as for qnn_q8gemm; `w` is K-major
// [out_channels, kernel_h * kernel_w, icpg_p]; `izp` the raw input zero
// point.
extern "C" int qnn_q8conv(int device, const void* a, const void* w,
                          const void* bias_c, const void* scales, void* out,
                          int batch, int height, int width, int channels,
                          int out_height, int out_width, int out_channels,
                          int groups, int kernel_h, int kernel_w,
                          int stride_h, int stride_w, int pad_top,
                          int pad_left, int dil_h, int dil_w, int izp,
                          int kzp_biased, int icpg_p, int tile, int splits,
                          int steps_per_split, void* workspace,
                          void* counters, int scheme, int multiplier,
                          int shift, int zero_point, int qmin, int qmax,
                          float scale, void* stream) {
  const qnn::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) {
    return static_cast<int>(guard.error());
  }
  const int64_t m = static_cast<int64_t>(batch) * out_height * out_width;
  if (m == 0 || out_channels == 0) return 0;
  int icpg = 0, ocpg = 0;
  if (!conv_ok(batch, height, width, channels, out_channels, groups,
               kernel_h, kernel_w, icpg_p, splits, steps_per_split,
               workspace, counters, w, icpg, ocpg)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ConvArgs p{
      static_cast<const uint8_t*>(a),
      static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(bias_c),
      static_cast<const float*>(scales),
      static_cast<uint8_t*>(out),
      batch, height, width, channels,
      out_height, out_width, out_channels,
      icpg, ocpg, icpg_p,
      kernel_h, kernel_w, stride_h, stride_w, pad_top, pad_left, dil_h,
      dil_w,
      izp, kzp_biased, im::copy_width(a, icpg),
      qnn::Requant{scheme, multiplier, shift, zero_point, qmin, qmax, scale},
      im::Split{splits, steps_per_split, static_cast<int32_t*>(workspace),
                static_cast<int*>(counters)}};
  return static_cast<int>(launch_tile<false>(
      p, groups, tile, device, static_cast<cudaStream_t>(stream)));
}

// The partial instance: acc_out [M, out_channels] int32 gets sum_k A W' -
// kzp' * sum_k A over the record's taps and channels (izp taps included,
// wrapping), with no c and no requantization; the other arguments as for
// qnn_q8conv.
extern "C" int qnn_q8conv_partial(int device, const void* a, const void* w,
                                  void* acc_out, int batch, int height,
                                  int width, int channels, int out_height,
                                  int out_width, int out_channels,
                                  int groups, int kernel_h, int kernel_w,
                                  int stride_h, int stride_w, int pad_top,
                                  int pad_left, int dil_h, int dil_w,
                                  int izp, int kzp_biased, int icpg_p,
                                  int tile, int splits, int steps_per_split,
                                  void* workspace, void* counters,
                                  void* stream) {
  const qnn::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) {
    return static_cast<int>(guard.error());
  }
  const int64_t m = static_cast<int64_t>(batch) * out_height * out_width;
  if (m == 0 || out_channels == 0) return 0;
  int icpg = 0, ocpg = 0;
  if (!conv_ok(batch, height, width, channels, out_channels, groups,
               kernel_h, kernel_w, icpg_p, splits, steps_per_split,
               workspace, counters, w, icpg, ocpg)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PartialConvArgs p{};
  static_cast<ConvArgs&>(p) = ConvArgs{
      static_cast<const uint8_t*>(a),
      static_cast<const int8_t*>(w),
      nullptr,
      nullptr,
      nullptr,
      batch, height, width, channels,
      out_height, out_width, out_channels,
      icpg, ocpg, icpg_p,
      kernel_h, kernel_w, stride_h, stride_w, pad_top, pad_left, dil_h,
      dil_w,
      izp, kzp_biased, im::copy_width(a, icpg),
      qnn::Requant{},
      im::Split{splits, steps_per_split, static_cast<int32_t*>(workspace),
                static_cast<int*>(counters)}};
  p.acc_out = static_cast<int32_t*>(acc_out);
  return static_cast<int>(launch_tile<true>(
      p, groups, tile, device, static_cast<cudaStream_t>(stream)));
}
