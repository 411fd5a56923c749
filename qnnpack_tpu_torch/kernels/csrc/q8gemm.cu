// q8gemm: uint8 A [M, K] x biased-int8 W [K, N] -> uint8 [M, N].
//
// Replaces the TPU kernels qnnpack_tpu/kernels/q8gemm_small.py:
// q8gemm_small_pallas (K untiled, per-tensor or per-channel requant) and
// qnnpack_tpu/kernels/q8gemm.py:q8gemm_pallas (K tiled, accumulator and row
// sum carried across K steps).  One kernel serves both contracts: the K loop
// runs inside the block (or inside each split of it), so nothing is carried
// between blocks except split-K's partial tiles.
//
//   acc[m, n] = sum_k A[m, k] W'[k, n] + c[n] - kzp' * sum_k A[m, k]
//   out[m, n] = requantize(acc[m, n])        (any scheme, in registers)
//
// with c[n] folded at pack time (nn/packing.py), which equals the
// reference's sum A'W' + bias' - kzp' sum A' mod 2^32 (A' = A - 128).  W
// comes K-major, [N, Kp] with Kp = K rounded up to the 64-byte K step and
// zeros past K.  A is read as it lies: 16-, 8- or 4-byte cp.async copies as
// far as the base address and K allow (plain byte copies otherwise), zero
// past M and K, so a ragged K position adds nothing to the product or to
// the row sum.
//
// What bounds it: MobileNetV2's and ShuffleNet's 1x1 layers (K 16..960)
// do fewer int8 operations a byte than the card's ridge (1,979 TOP/s over
// 3.35 TB/s, about 591) and are bound by memory; BERT's projections at
// batch 128 (K = 768, 3072; M = 16,384; 750-1,185 operations a byte) are
// bound by the tensor cores.  So there are two instances, and the wrapper
// (kernels/q8gemm.py wgmma_route) picks one by the launch's operations a
// byte, from its shape and the card's peaks:
//   - at or above the ridge, the wgmma instance of wgmma_tile.cuh (tile id
//     4): a persistent, warp-specialised block whose producer warp keeps
//     TMA loads in flight and whose two consumer warpgroups run wgmma, the
//     only way to the tensor cores' full rate.  It takes the plain
//     contract only, unsplit, with A 16-byte aligned and K % 16 == 0
//     (TMA's rules).  Its requantizing epilogue overlaps no product, which
//     bounds it at K = 768 (BERT's qkv, out and ffn1) more than the tensor
//     cores do;
//   - below it, and for every row-sum, partial or split launch, the
//     tensor-core tile of imma_tile.cuh (u8 x s8 mma.sync fed by ldmatrix
//     from a cp.async ring, four block shapes and split-K picked by the
//     wrapper), with an instance of its own for the 16-byte copies of the
//     main paths.  mma.sync reaches only a part of the tensor cores' rate
//     (340-490 TOP/s at BERT's batch-128 shapes), which the memory-bound
//     launches never need.
//
// Two more instances of each shape serve the row-sum pair of nn/gemm.py
// (the JAX package's q8gemm_row_sums_out / q8gemm_presummed):
//   - the producer's epilogue adds each tile's sum_n (y[m, n] - 128) of its
//     requantized bytes to an int32 [M] buffer (zeroed by the wrapper): a
//     block sums its rows in shared memory, then adds each row once with
//     one global atomic; under split-K only the block that finishes a tile
//     runs the epilogue;
//   - the consumer takes those sums rs[m] = sum_k (A[m, k] - 128) in place
//     of its row-sum mma: c assumes the raw sum A, which is rs[m] + 128 K
//     with the true K (zeros past K add nothing).
// A fourth instance of each shape is the partial of K-sharded tensor
// parallelism (parallel/mesh.py:gemm_kdim_tp): after the K loop (and
// split-K's reduction) it stores the raw int32 acc - kzp' * sum_k A over
// the record's K, [M, N], with no c and no requantization
// (imma_tile.cuh store_partial).  The K slices' partials, summed in int32
// across ranks, plus the full record's c, are acc mod 2^32; q8requant.cu
// then requantizes once.  All three are compile-time flags (RS), so the
// plain instances are unchanged.
#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"
#include "imma_tile.cuh"
#include "wgmma_tile.cuh"

namespace {

namespace im = qnn::imma;

// A tile: BM rows of A [M, K] from row m0, 64 bytes from k0 on.
template <class T, int W>
__device__ __forceinline__ void load_a(uint8_t* sa, const uint8_t* a,
                                       int64_t m, int k, int64_t m0, int k0) {
  constexpr int kPerRow = T::kStep / W;
  // Unrolled only for the wide copies: the byte loop's 32 addresses would
  // otherwise be hoisted out of the K loop into registers.
#pragma unroll(W >= 8 ? T::BM * kPerRow / T::kThreads : 1)
  for (int j = 0; j < T::BM * kPerRow / T::kThreads; ++j) {
    const int idx = threadIdx.x + j * T::kThreads;
    const int r = idx / kPerRow;
    const int col = (idx % kPerRow) * W;
    const int64_t gm = m0 + r;
    const int gk = k0 + col;
    const bool ok = gm < m && gk < k;  // K % W == 0: whole chunks only
    im::copy_in<W>(sa + r * T::kPitch + col, ok ? a + gm * k + gk : a, ok);
  }
}

struct GemmArgs {
  const uint8_t* a;
  const int8_t* w;  // K-major [N, kp]
  const int32_t* bias_c;
  const float* scales;
  uint8_t* out;
  int64_t m;
  int n, k, kp, width, kzp_biased;
  qnn::Requant rp;
  im::Split sp;
};

// The row-sum and partial instances' arguments (RS != kPlain).
enum RowSums { kPlain = 0, kProduce = 1, kConsume = 2, kPartial = 3 };
struct RowSumGemmArgs : GemmArgs {
  const int32_t* rs_in;  // kConsume: [M] sum_k (A - 128)
  int32_t* rs_out;       // kProduce: [M], zeroed; gets sum_n (y - 128)
};
struct PartialGemmArgs : GemmArgs {
  int32_t* acc_out;  // kPartial: [M, N] int32
};

// The wgmma instance's tile id, 128 x 256 (kernels/q8gemm.py TILES); 0-3
// are imma_tile.cuh's.
constexpr int kWgmmaTile = 4;

// W = 16: every A copy is 16 bytes (the main paths' case, compiled on its
// own so that it carries no other path); W = 0: the width is `width`.
template <class T, int W>
struct GemmLoader {
  const uint8_t* a;
  const int8_t* w_rows;  // row n0 of the K-major weights
  int64_t m, m0;
  int k, kp, rows, width;

  __device__ __forceinline__ void load(uint8_t* sa, uint8_t* sb,
                                       int step) const {
    const int k0 = step * T::kStep;
    switch (W == 16 ? 16 : width) {
      case 16:
        load_a<T, 16>(sa, a, m, k, m0, k0);
        break;
      case 8:
        load_a<T, 8>(sa, a, m, k, m0, k0);
        break;
      case 4:
        load_a<T, 4>(sa, a, m, k, m0, k0);
        break;
      default:
        load_a<T, 1>(sa, a, m, k, m0, k0);
    }
    im::load_b<T>(sb, w_rows, kp, k0, rows);
  }
};

template <class T, int W, int RS, class Args>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
    q8gemm_kernel(const Args p) {
  extern __shared__ __align__(16) uint8_t ring[];
  __shared__ int flag;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * T::BM;
  const int n0 = blockIdx.y * T::BN;
  const int split = blockIdx.z;
  // The split's K units of 64 bytes, as ring stages of T::kStep bytes.
  const int units = p.kp / im::kStepK;
  const int unit0 = split * p.sp.steps_per_split;
  const int nunits = min(p.sp.steps_per_split, units - unit0);
  const int step0 = unit0 / T::kUnits;
  const int nsteps = (nunits + T::kUnits - 1) / T::kUnits;
  const GemmLoader<T, W> ld{p.a,  p.w + static_cast<int64_t>(n0) * p.kp,
                            p.m,  m0,
                            p.k,  p.kp,
                            p.n - n0, p.width};
  im::Acc<T> acc;
  im::mainloop<T>(ld, ring, step0, nsteps,
                  RS != kConsume && p.kzp_biased != 0, acc);
  if (p.sp.splits > 1) {
    const int64_t tile =
        static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x;
    if (!im::split_reduce<T>(acc, p.sp, tile, split, &flag)) return;
  }
  if constexpr (RS == kPartial) {
    im::store_partial<T>(acc, m0, n0, p.m, p.n, p.n, 0, p.kzp_biased,
                         p.acc_out);
    return;
  }
  if constexpr (RS == kConsume) {
    // The epilogue's -kzp' * rowsum term, from the given sums (uint32).
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int row0 = (warp / T::WN) * T::kWarpRows + (lane >> 2);
#pragma unroll
    for (int i = 0; i < T::MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t gm = m0 + row0 + i * 16 + 8 * h;
        acc.rs[i][2 * h] =
            gm < p.m ? static_cast<int32_t>(
                           static_cast<uint32_t>(__ldg(p.rs_in + gm)) +
                           128u * static_cast<uint32_t>(p.k))
                     : 0;
      }
    }
  }
  if constexpr (RS == kProduce) {
    __shared__ int32_t row_part[T::BM];
    for (int r = threadIdx.x; r < T::BM; r += T::kThreads) row_part[r] = 0;
    im::epilogue<T, true>(acc, ring, m0, n0, p.m, p.n, p.n, 0, p.bias_c,
                          p.scales, p.kzp_biased, p.rp, p.out, row_part);
    __syncthreads();
    for (int r = threadIdx.x; r < T::BM; r += T::kThreads) {
      if (m0 + r < p.m) atomicAdd(p.rs_out + m0 + r, row_part[r]);
    }
  } else {
    im::epilogue<T>(acc, ring, m0, n0, p.m, p.n, p.n, 0, p.bias_c, p.scales,
                    p.kzp_biased, p.rp, p.out);
  }
}

template <class T, int RS, class Args>
cudaError_t launch(const Args& p, int device, cudaStream_t stream) {
  static unsigned ready = 0;
  const cudaError_t err = im::allow_smem(q8gemm_kernel<T, 16, RS, Args>,
                                         q8gemm_kernel<T, 0, RS, Args>,
                                         T::kSmemBytes, device, ready);
  if (err != cudaSuccess) return err;
  const auto kernel = p.width == 16 ? q8gemm_kernel<T, 16, RS, Args>
                                    : q8gemm_kernel<T, 0, RS, Args>;
  const dim3 grid(static_cast<unsigned>((p.m + T::BM - 1) / T::BM),
                  static_cast<unsigned>((p.n + T::BN - 1) / T::BN),
                  static_cast<unsigned>(p.sp.splits));
  kernel<<<grid, T::kThreads, T::kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

template <int RS, class Args>
cudaError_t launch_tile(const Args& p, int tile, int device,
                        cudaStream_t s) {
  switch (tile) {
    case 0:
      return launch<im::Tile128x128, RS>(p, device, s);
    case 1:
      return launch<im::Tile128x64, RS>(p, device, s);
    case 2:
      return launch<im::Tile64x64, RS>(p, device, s);
    case 3:
      if (p.sp.splits > 1 &&
          p.sp.steps_per_split % im::Tile128x128Deep::kUnits) {
        return cudaErrorInvalidValue;
      }
      return launch<im::Tile128x128Deep, RS>(p, device, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The wgmma instance (wgmma_tile.cuh): one persistent block an SM, at most
// one a tile.
template <int BN, int STAGES>
__global__ void __launch_bounds__(qnn::wgmma::kThreads, 1)
    q8gemm_kernel(const __grid_constant__ qnn::wgmma::Args p) {
  extern __shared__ __align__(16) uint8_t ring[];
  qnn::wgmma::run<qnn::wgmma::Tile<BN, STAGES>>(p, ring);
}

// The grouped instance (wgmma_tile.cuh run<T, true>): the experts' live
// tiles, their count read from the device.  A name of its own, so that a
// trace tells the experts' GEMMs from the dense projections.
template <int BN, int STAGES>
__global__ void __launch_bounds__(qnn::wgmma::kThreads, 1)
    q8gemm_grouped_kernel(const __grid_constant__ qnn::wgmma::Args p) {
  extern __shared__ __align__(16) uint8_t ring[];
  __shared__ int start[qnn::wgmma::kMaxExperts + 1];
  qnn::wgmma::run<qnn::wgmma::Tile<BN, STAGES>, true>(p, ring, start);
}

// A wgmma launch: kGrouped the grouped instance over `experts` segments
// of `cap` rows (g.m = experts * cap), whose live rows `counts` holds.
template <class T, bool kGrouped = false>
cudaError_t launch_wgmma(const GemmArgs& g, int device,
                         cudaStream_t stream,
                         const int32_t* counts = nullptr, int experts = 0,
                         int cap = 0) {
  namespace wg = qnn::wgmma;
  void (*kernel)(const wg::Args) = q8gemm_kernel<T::BN, T::kStages>;
  if constexpr (kGrouped) kernel = q8gemm_grouped_kernel<T::BN, T::kStages>;
  static unsigned ready = 0;
  static int sms[32] = {};
  if (device < 0 || device >= 32) return cudaErrorInvalidDevice;
  if (!(ready & (1u << device))) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms[device],
                                   cudaDevAttrMultiProcessorCount, device);
    }
    if (err != cudaSuccess) return err;
    ready |= 1u << device;  // a race only sets it twice
  }
  wg::Args p{};
  if (!wg::encode_rows(&p.a_map, g.a, g.k, g.m, wg::BM) ||
      !wg::encode_rows(&p.w_map, g.w, g.kp,
                       kGrouped ? int64_t{experts} * g.n : g.n, T::BN)) {
    return cudaErrorInvalidValue;
  }
  p.bias_c = g.bias_c;
  p.scales = g.scales;
  p.out = g.out;
  p.m = static_cast<int>(g.m);
  p.n = g.n;
  p.kp = g.kp;
  p.kzp_biased = g.kzp_biased;
  p.tiles_n = (g.n + T::BN - 1) / T::BN;
  const int64_t tiles = (g.m + wg::BM - 1) / wg::BM * p.tiles_n;
  if (tiles > INT32_MAX) return cudaErrorInvalidValue;
  p.tiles = static_cast<int>(tiles);
  p.pairs = reinterpret_cast<uintptr_t>(g.bias_c) % 8 == 0 &&
            reinterpret_cast<uintptr_t>(g.scales) % 8 == 0;
  p.rp = g.rp;
  p.counts = counts;
  p.experts = experts;
  p.cap = cap;
  const int grid = p.tiles < sms[device] ? p.tiles : sms[device];
  kernel<<<grid, wg::kThreads, T::kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

// The wgmma instance takes the plain contract, unsplit, A 16-byte aligned
// with K % 16 == 0 (copy width 16), M and the tile count within int.
bool wgmma_ok(const GemmArgs& g) {
  return g.sp.splits == 1 && g.width == 16 &&
         g.m <= (int64_t{1} << 31) - qnn::wgmma::BM;
}

// The launch plan and weights are usable: kp a whole number of K steps
// covering K, every split within one int32 chain and none empty, scratch
// for a split launch, 16-byte aligned weights.
bool plan_ok(const void* w, int k, int kp, int splits, int steps_per_split,
             const void* workspace, const void* counters) {
  const int steps = kp / im::kStepK;
  return kp % im::kStepK == 0 && kp >= k && steps >= 1 && splits >= 1 &&
         steps_per_split >= 1 && steps_per_split <= im::kMaxChainSteps &&
         static_cast<int64_t>(splits) * steps_per_split >= steps &&
         (splits - 1) * steps_per_split < steps &&
         (splits == 1 || (workspace != nullptr && counters != nullptr)) &&
         reinterpret_cast<uintptr_t>(w) % 16 == 0;
}

}  // namespace

// tile: 0 = 128 x 128, 1 = 128 x 64, 2 = 64 x 64, 3 = 128 x 128 with
// 128-byte stages, 4 = the wgmma instance's 128 x 256 (kernels/q8gemm.py
// TILES; tile 4 takes neither split nor row sums).
// splits > 1 needs `workspace` ([tiles, splits, BM * BN + BM] int32) and
// `counters` ([tiles] int32, all 0; left all 0).  At most one of
// `row_sums_in` (the consumer's [M] sums of A - 128) and `row_sums_out`
// (the producer's [M] int32 buffer, zeroed) is given.
extern "C" int qnn_q8gemm(int device, const void* a, const void* w,
                          const void* bias_c, const void* scales, void* out,
                          int64_t m, int n, int k, int kp, int kzp_biased,
                          int tile, int splits, int steps_per_split,
                          void* workspace, void* counters, int scheme,
                          int multiplier, int shift, int zero_point, int qmin,
                          int qmax, float scale, const void* row_sums_in,
                          void* row_sums_out, void* stream) {
  const qnn::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) {
    return static_cast<int>(guard.error());
  }
  if (m == 0 || n == 0) return 0;
  if (!plan_ok(w, k, kp, splits, steps_per_split, workspace, counters) ||
      (row_sums_in != nullptr && row_sums_out != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const GemmArgs p{static_cast<const uint8_t*>(a),
                   static_cast<const int8_t*>(w),
                   static_cast<const int32_t*>(bias_c),
                   static_cast<const float*>(scales),
                   static_cast<uint8_t*>(out),
                   m, n, k, kp, im::copy_width(a, k), kzp_biased,
                   qnn::Requant{scheme, multiplier, shift, zero_point, qmin,
                                qmax, scale},
                   im::Split{splits, steps_per_split,
                             static_cast<int32_t*>(workspace),
                             static_cast<int*>(counters)}};
  const auto s = static_cast<cudaStream_t>(stream);
  if (tile == kWgmmaTile) {
    return static_cast<int>(
        row_sums_in == nullptr && row_sums_out == nullptr && wgmma_ok(p)
            ? launch_wgmma<qnn::wgmma::Tile128x256>(p, device, s)
            : cudaErrorInvalidValue);
  }
  if (row_sums_in == nullptr && row_sums_out == nullptr) {
    return static_cast<int>(launch_tile<kPlain>(p, tile, device, s));
  }
  RowSumGemmArgs r;
  static_cast<GemmArgs&>(r) = p;
  r.rs_in = static_cast<const int32_t*>(row_sums_in);
  r.rs_out = static_cast<int32_t*>(row_sums_out);
  return static_cast<int>(
      row_sums_in != nullptr ? launch_tile<kConsume>(r, tile, device, s)
                             : launch_tile<kProduce>(r, tile, device, s));
}

// The partial instance: acc_out [M, N] int32 gets sum_k A W' - kzp' *
// sum_k A over the record's K (wrapping), with no c and no requantization;
// plan arguments as for qnn_q8gemm.
extern "C" int qnn_q8gemm_partial(int device, const void* a, const void* w,
                                  void* acc_out, int64_t m, int n, int k,
                                  int kp, int kzp_biased, int tile,
                                  int splits, int steps_per_split,
                                  void* workspace, void* counters,
                                  void* stream) {
  const qnn::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) {
    return static_cast<int>(guard.error());
  }
  if (m == 0 || n == 0) return 0;
  if (!plan_ok(w, k, kp, splits, steps_per_split, workspace, counters)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PartialGemmArgs p{};
  static_cast<GemmArgs&>(p) = GemmArgs{
      static_cast<const uint8_t*>(a),
      static_cast<const int8_t*>(w),
      nullptr,
      nullptr,
      nullptr,
      m, n, k, kp, im::copy_width(a, k), kzp_biased,
      qnn::Requant{},
      im::Split{splits, steps_per_split, static_cast<int32_t*>(workspace),
                static_cast<int*>(counters)}};
  p.acc_out = static_cast<int32_t*>(acc_out);
  return static_cast<int>(launch_tile<kPartial>(
      p, tile, device, static_cast<cudaStream_t>(stream)));
}

// The grouped instance of an expert layer (kernels/q8gemm.py
// q8gemm_grouped_cuda): A [experts * cap, K], expert e's rows at e * cap of
// which counts[e] (int32, on the device) are live; W' [experts * N, kp]
// and c [experts * N] each expert's K-major weights and c one after
// another; out [experts * cap, N], its live rows written.  The persistent
// grid is sized for every row live.  N % 256 == 0, K % 16 == 0, A 16-byte
// aligned, kp within one int32 chain, a per-tensor requantization.
extern "C" int qnn_q8gemm_grouped(int device, const void* a, const void* w,
                                  const void* bias_c, void* out,
                                  const void* counts, int experts, int cap,
                                  int n, int k, int kp, int kzp_biased,
                                  int scheme, int multiplier, int shift,
                                  int zero_point, int qmin, int qmax,
                                  float scale, void* stream) {
  const qnn::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) {
    return static_cast<int>(guard.error());
  }
  const int64_t m = static_cast<int64_t>(experts) * cap;
  if (experts < 1 || experts > qnn::wgmma::kMaxExperts || cap < 0 ||
      n < 1 || n % qnn::wgmma::Tile128x256::BN != 0 || k < 16 ||
      k % 16 != 0 || scheme == qnn::kFP32PerChannel || counts == nullptr ||
      m > (int64_t{1} << 31) - qnn::wgmma::BM ||
      !plan_ok(w, k, kp, 1, kp / im::kStepK, nullptr, nullptr) ||
      kp / im::kStepK > im::kMaxChainSteps ||
      im::copy_width(a, k) != 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return 0;
  const GemmArgs p{static_cast<const uint8_t*>(a),
                   static_cast<const int8_t*>(w),
                   static_cast<const int32_t*>(bias_c),
                   nullptr,
                   static_cast<uint8_t*>(out),
                   m, n, k, kp, 16, kzp_biased,
                   qnn::Requant{scheme, multiplier, shift, zero_point, qmin,
                                qmax, scale},
                   im::Split{1, kp / im::kStepK, nullptr, nullptr}};
  return static_cast<int>(launch_wgmma<qnn::wgmma::Tile128x256, true>(
      p, device, static_cast<cudaStream_t>(stream),
      static_cast<const int32_t*>(counts), experts, cap));
}

extern "C" const char* qnn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
