// q8swiglu: the SwiGLU product of a fused gate | up projection
// (kernels/vpu_ops.py q8swiglu_cuda), uint8 rows [R, 2 W] -> [R, W]:
//
//   y = requant((silu[g] - z_silu) (u - z_up))     (fp32 requantization)
//
// with silu a 256-entry table on the gate's bytes.  With `counts` the rows
// are `experts` segments of `cap` rows of which the first counts[e] are
// live (an expert layer's rows, kernels/moe.py), read on the device: the
// grid is sized for the worst case, and each block walks the live rows
// only.  One thread takes 16 bytes of a row: one 16-byte read of the gate,
// one of the up, one 16-byte store.  The table is in shared memory.
#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"
#include "requant.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxExperts = 64;

__global__ void __launch_bounds__(kThreads)
    q8swiglu_kernel(const uint8_t* __restrict__ gu,
                    const uint8_t* __restrict__ silu,
                    uint8_t* __restrict__ out, int64_t rows, int width,
                    const int32_t* __restrict__ counts, int experts, int cap,
                    int z_silu, int z_up, qnn::Requant rq) {
  __shared__ uint8_t table[256];
  __shared__ int64_t start[kMaxExperts + 1];  // live rows before expert e
  for (int i = threadIdx.x; i < 256; i += kThreads) table[i] = silu[i];
  if (threadIdx.x == 0) {
    start[0] = 0;
    for (int e = 0; e < experts; ++e) start[e + 1] = start[e] + counts[e];
  }
  __syncthreads();
  const int64_t live = counts != nullptr ? start[experts] : rows;
  const int chunks = width / 16;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads +
                     threadIdx.x;
       idx < live * chunks; idx += static_cast<int64_t>(gridDim.x) * kThreads) {
    int64_t row = idx / chunks;
    const int c = static_cast<int>(idx % chunks);
    if (counts != nullptr) {
      int e = 0;
      while (row >= start[e + 1]) ++e;
      row = static_cast<int64_t>(e) * cap + (row - start[e]);
    }
    const uint8_t* g = gu + row * 2 * width + 16 * c;
    const uint4 gv = *reinterpret_cast<const uint4*>(g);
    const uint4 uv = *reinterpret_cast<const uint4*>(g + width);
    const uint32_t gw[4] = {gv.x, gv.y, gv.z, gv.w};
    const uint32_t uw[4] = {uv.x, uv.y, uv.z, uv.w};
    uint32_t y[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      const int sh = 8 * (b % 4);
      const int s = table[(gw[b / 4] >> sh) & 0xFFu] - z_silu;
      const int u = static_cast<int>((uw[b / 4] >> sh) & 0xFFu) - z_up;
      y[b / 4] |= static_cast<uint32_t>(qnn::requant_fp32(s * u, rq.scale,
                                                          rq))
                  << sh;
    }
    *reinterpret_cast<uint4*>(out + row * width + 16 * c) =
        make_uint4(y[0], y[1], y[2], y[3]);
  }
}

}  // namespace

// gu [rows, 2 width] -> out [rows, width]; width % 16 == 0, gu and out on
// 16-byte boundaries; counts (int32 [experts], or null for all rows live)
// with rows == experts * cap.
extern "C" int qnn_q8swiglu(int device, const void* gu, const void* silu,
                            void* out, int64_t rows, int width,
                            const void* counts, int experts, int cap,
                            int z_silu, int z_up, int zero_point,
                            float scale, void* stream) {
  const qnn::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) {
    return static_cast<int>(guard.error());
  }
  if (rows < 0 || width < 16 || width % 16 != 0 ||
      reinterpret_cast<uintptr_t>(gu) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      (counts != nullptr &&
       (experts < 1 || experts > kMaxExperts || cap < 0 ||
        rows != static_cast<int64_t>(experts) * cap))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  const int64_t work = rows * (width / 16);
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(blocks < 4096 ? blocks : 4096);
  q8swiglu_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(gu), static_cast<const uint8_t*>(silu),
      static_cast<uint8_t*>(out), rows, width,
      static_cast<const int32_t*>(counts), counts != nullptr ? experts : 0,
      cap, z_silu, z_up,
      qnn::Requant{qnn::kFP32, 0, 0, zero_point, 0, 255, scale});
  return static_cast<int>(cudaGetLastError());
}
