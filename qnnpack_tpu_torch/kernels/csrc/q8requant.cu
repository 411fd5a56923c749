// q8requant: int32 acc [M, N] + c [N] -> uint8 [M, N], requantized.
//
//   out[m, n] = requantize(acc[m, n] + c[n])     (any scheme; the sum wraps)
//
// The epilogue of K- and input-channel-sharded tensor parallelism
// (parallel/mesh.py:gemm_kdim_tp, conv_ic_tp): the ranks' partials (the
// partial instances of q8gemm.cu and q8conv.cu) are summed in int32 by an
// all-reduce, and this kernel adds the full record's c once and
// requantizes.  It replaces XLA's apply_requant(acc + bias) of the JAX
// package (qnnpack_tpu/parallel/mesh.py:160, :214), which has no Pallas
// form.  The arithmetic is requant.cuh's, with the bias added in uint32 as
// the reference's int32 sum wraps.
//
// What bounds it: bytes (5 of them an element: 4 read, 1 written; c and
// the channel scales stay in L1/L2).  Design: a thread takes 4 elements of
// one row: one 16-byte load of acc, one of c (and of the scales), one
// 4-byte store, where N % 4 == 0 and the pointers are aligned; otherwise
// one element a thread (odd N).  The scheme is a template argument, so
// requantize()'s switch folds away.
#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"
#include "requant.cuh"

namespace {

constexpr int kThreads = 256;

template <int S>
__device__ __forceinline__ uint8_t requant_at(int32_t acc, int32_t c,
                                              const float* scales, int col,
                                              const qnn::Requant& rp) {
  const float cs = S == qnn::kFP32PerChannel ? __ldg(scales + col) : rp.scale;
  return qnn::requantize(qnn::wrap_add(acc, c), rp, cs);
}

// Four elements a thread: N % 4 == 0, acc, c and scales 16-byte aligned,
// out 4-byte aligned.
template <int S>
__global__ void __launch_bounds__(kThreads)
    q8requant_vec4(const int32_t* __restrict__ acc,
                   const int32_t* __restrict__ bias_c,
                   const float* __restrict__ scales,
                   uint8_t* __restrict__ out, int64_t quads, int n,
                   qnn::Requant rp) {
  rp.scheme = S;
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= quads) return;
  const int col = static_cast<int>((4 * q) % n);
  const int4 a = __ldg(reinterpret_cast<const int4*>(acc) + q);
  const int4 c = __ldg(reinterpret_cast<const int4*>(bias_c + col));
  float4 cs = make_float4(rp.scale, rp.scale, rp.scale, rp.scale);
  if constexpr (S == qnn::kFP32PerChannel) {
    cs = __ldg(reinterpret_cast<const float4*>(scales + col));
  }
  const uint32_t word =
      static_cast<uint32_t>(qnn::requantize(qnn::wrap_add(a.x, c.x), rp,
                                            cs.x)) |
      static_cast<uint32_t>(qnn::requantize(qnn::wrap_add(a.y, c.y), rp,
                                            cs.y))
          << 8 |
      static_cast<uint32_t>(qnn::requantize(qnn::wrap_add(a.z, c.z), rp,
                                            cs.z))
          << 16 |
      static_cast<uint32_t>(qnn::requantize(qnn::wrap_add(a.w, c.w), rp,
                                            cs.w))
          << 24;
  reinterpret_cast<uint32_t*>(out)[q] = word;
}

// One element a thread: any N and alignment.
template <int S>
__global__ void __launch_bounds__(kThreads)
    q8requant_one(const int32_t* __restrict__ acc,
                  const int32_t* __restrict__ bias_c,
                  const float* __restrict__ scales,
                  uint8_t* __restrict__ out, int64_t total, int n,
                  qnn::Requant rp) {
  rp.scheme = S;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const int col = static_cast<int>(i % n);
  out[i] = requant_at<S>(__ldg(acc + i), __ldg(bias_c + col), scales, col,
                         rp);
}

template <int S>
cudaError_t launch(const int32_t* acc, const int32_t* bias_c,
                   const float* scales, uint8_t* out, int64_t total, int n,
                   const qnn::Requant& rp, bool vec4, cudaStream_t stream) {
  const int64_t work = vec4 ? total / 4 : total;
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks));
  if (vec4) {
    q8requant_vec4<S><<<grid, kThreads, 0, stream>>>(acc, bias_c, scales,
                                                     out, work, n, rp);
  } else {
    q8requant_one<S><<<grid, kThreads, 0, stream>>>(acc, bias_c, scales, out,
                                                    work, n, rp);
  }
  return cudaGetLastError();
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// acc int32 [M, N], bias_c int32 [N], scales float [N] (the per-channel
// scheme only), out uint8 [M, N]; the requantization fields as for
// qnn_q8gemm.
extern "C" int qnn_q8requant(int device, const void* acc, const void* bias_c,
                             const void* scales, void* out, int64_t m, int n,
                             int scheme, int multiplier, int shift,
                             int zero_point, int qmin, int qmax, float scale,
                             void* stream) {
  const qnn::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) {
    return static_cast<int>(guard.error());
  }
  if (m == 0 || n == 0) return 0;
  if (m < 0 || n < 0 ||
      (scheme == qnn::kFP32PerChannel && scales == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* a = static_cast<const int32_t*>(acc);
  const auto* c = static_cast<const int32_t*>(bias_c);
  const auto* sc = static_cast<const float*>(scales);
  auto* o = static_cast<uint8_t*>(out);
  const bool vec4 = n % 4 == 0 && aligned(acc, 16) && aligned(bias_c, 16) &&
                    aligned(out, 4) &&
                    (scheme != qnn::kFP32PerChannel || aligned(scales, 16));
  const qnn::Requant rp{scheme, multiplier, shift, zero_point, qmin, qmax,
                        scale};
  const int64_t total = m * n;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (scheme) {
    case qnn::kQ31:
      return static_cast<int>(
          launch<qnn::kQ31>(a, c, sc, o, total, n, rp, vec4, s));
    case qnn::kFP32:
      return static_cast<int>(
          launch<qnn::kFP32>(a, c, sc, o, total, n, rp, vec4, s));
    case qnn::kPrecise:
      return static_cast<int>(
          launch<qnn::kPrecise>(a, c, sc, o, total, n, rp, vec4, s));
    case qnn::kGemmlowp:
      return static_cast<int>(
          launch<qnn::kGemmlowp>(a, c, sc, o, total, n, rp, vec4, s));
    case qnn::kFP32PerChannel:
      return static_cast<int>(
          launch<qnn::kFP32PerChannel>(a, c, sc, o, total, n, rp, vec4, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
