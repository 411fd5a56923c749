// moe_combine: the held experts' outputs combined into each token's part
// of an expert layer's result (kernels/moe.py moe_combine_cuda):
//
//   acc_t = sum_k [slot_tk >= 0] w_tk (d[slot_tk] - z)      (int32)
//   out_t = requant(acc_t)              (fp32; z when no held expert)
//
// One thread takes 16 bytes of a token's row: a 16-byte read of each held
// expert's row, one 16-byte store; the token's slots and weights are read
// by each of its threads, from L1.  What bounds it: the bytes, about
// t k held / n rows of d read and t rows written.
#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"
#include "requant.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    moe_combine_kernel(const uint8_t* __restrict__ d,
                   const int32_t* __restrict__ slot,
                   const int32_t* __restrict__ wts, uint8_t* __restrict__ out,
                   int64_t t, int k, int h, qnn::Requant rq) {
  const int chunks = h / 16;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads +
                     threadIdx.x;
       idx < t * chunks; idx += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t tok = idx / chunks;
    const int c = static_cast<int>(idx % chunks);
    int32_t acc[16];
#pragma unroll
    for (int b = 0; b < 16; ++b) acc[b] = 0;
    for (int j = 0; j < k; ++j) {
      const int32_t s = __ldg(slot + tok * k + j);
      if (s < 0) continue;
      const int32_t w = __ldg(wts + tok * k + j);
      const uint4 v = *reinterpret_cast<const uint4*>(
          d + static_cast<int64_t>(s) * h + 16 * c);
      const uint32_t vw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        acc[b] += w * (static_cast<int32_t>((vw[b / 4] >> (8 * (b % 4))) &
                                            0xFFu) -
                       rq.zero_point);
      }
    }
    uint32_t y[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      y[b / 4] |= static_cast<uint32_t>(qnn::requant_fp32(acc[b], rq.scale,
                                                          rq))
                  << (8 * (b % 4));
    }
    *reinterpret_cast<uint4*>(out + tok * h + 16 * c) =
        make_uint4(y[0], y[1], y[2], y[3]);
  }
}

}  // namespace

// d uint8 [rows, h] (the held experts' segments), slot and wts int32
// [t, k] -> out uint8 [t, h]; h % 16 == 0, d and out on 16-byte
// boundaries; fp32 requantization with d's zero point.
extern "C" int qnn_moe_combine(int device, const void* d, const void* slot,
                               const void* wts, void* out, int64_t t, int k,
                               int h, int zero_point, int qmin, int qmax,
                               float scale, void* stream) {
  const qnn::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) {
    return static_cast<int>(guard.error());
  }
  if (t < 0 || k < 1 || h < 16 || h % 16 != 0 ||
      reinterpret_cast<uintptr_t>(d) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (t == 0) return 0;
  const int64_t blocks = (t * (h / 16) + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(blocks < 8192 ? blocks : 8192);
  moe_combine_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(d), static_cast<const int32_t*>(slot),
      static_cast<const int32_t*>(wts), static_cast<uint8_t*>(out), t, k, h,
      qnn::Requant{qnn::kFP32, 0, 0, zero_point, qmin, qmax, scale});
  return static_cast<int>(cudaGetLastError());
}
