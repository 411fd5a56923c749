// q8rope: the partial rotary embedding of attention's queries and keys, in
// place on uint8 rows (kernels/vpu_ops.py q8rope_cuda).
//
// Row t of `x` (at x + t ld) holds `heads` heads of head_dim bytes from
// column 0 (the query heads, then the key heads, of a fused projection);
// its position is p = t % seq.  Dims i and i + half of each head, i < half,
// rotate by the fixed-point tables C, S [seq, half] (2^14 cos and sin):
//
//   y_i        = requant((x_i - z) C[p, i] - (x_{i+half} - z) S[p, i])
//   y_{i+half} = requant((x_{i+half} - z) C[p, i] + (x_i - z) S[p, i])
//
// (fp32 requantization at scale 2^-14, the input's zero point z; the
// products stay below 2^23, so each converts to float exactly); the other
// dims pass through.  One thread takes four i of one head: a word of each
// half, read and written once.  What bounds it: the bytes, 2 x 64 of each
// 192-byte head and a table row of 256 bytes that L1 serves to the heads
// of a row.
#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"
#include "requant.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    q8rope_kernel(uint8_t* __restrict__ x, const int32_t* __restrict__ cos_t,
                  const int32_t* __restrict__ sin_t, int64_t rows,
                  int64_t ld, int heads, int head_dim, int half, int seq,
                  qnn::Requant rq) {
  const int quads = half / 4;
  const int64_t total = rows * heads * quads;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads +
                     threadIdx.x;
       idx < total; idx += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t t = idx / (heads * quads);
    const int rem = static_cast<int>(idx % (heads * quads));
    const int q = rem % quads;
    const int p = static_cast<int>(t % seq);
    uint8_t* at = x + t * ld + (rem / quads) * head_dim + 4 * q;
    const uint32_t wa = *reinterpret_cast<const uint32_t*>(at);
    const uint32_t wb = *reinterpret_cast<const uint32_t*>(at + half);
    const int4 c = __ldg(reinterpret_cast<const int4*>(cos_t + p * half) + q);
    const int4 s = __ldg(reinterpret_cast<const int4*>(sin_t + p * half) + q);
    const int cs[4] = {c.x, c.y, c.z, c.w};
    const int ss[4] = {s.x, s.y, s.z, s.w};
    uint32_t ya = 0, yb = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int a = static_cast<int>((wa >> (8 * j)) & 0xFFu) - rq.zero_point;
      const int b = static_cast<int>((wb >> (8 * j)) & 0xFFu) - rq.zero_point;
      ya |= static_cast<uint32_t>(
                qnn::requant_fp32(a * cs[j] - b * ss[j], rq.scale, rq))
            << (8 * j);
      yb |= static_cast<uint32_t>(
                qnn::requant_fp32(b * cs[j] + a * ss[j], rq.scale, rq))
            << (8 * j);
    }
    *reinterpret_cast<uint32_t*>(at) = ya;
    *reinterpret_cast<uint32_t*>(at + half) = yb;
  }
}

}  // namespace

// x: rows [rows, >= heads * head_dim] at stride ld; cos, sin: int32
// [seq, half].  half % 4 == 0, head_dim, ld and x on 4-byte boundaries,
// half * 2 <= head_dim; fp32 requantization into [0, 255].
extern "C" int qnn_q8rope(int device, void* x, const void* cos,
                          const void* sin, int64_t rows, int64_t ld,
                          int heads, int head_dim, int half, int seq,
                          int zero_point, float scale, void* stream) {
  const qnn::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) {
    return static_cast<int>(guard.error());
  }
  if (rows < 0 || heads < 1 || half < 4 || half % 4 != 0 ||
      2 * half > head_dim || head_dim % 4 != 0 || ld % 4 != 0 ||
      ld < static_cast<int64_t>(heads) * head_dim || seq < 1 ||
      reinterpret_cast<uintptr_t>(x) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(cos) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(sin) % 16 != 0 || zero_point < 0 ||
      zero_point > 255) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  const int64_t work = rows * heads * (half / 4);
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(blocks < 65536 ? blocks
                                                             : 65536);
  q8rope_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(x), static_cast<const int32_t*>(cos),
      static_cast<const int32_t*>(sin), rows, ld, heads, head_dim, half, seq,
      qnn::Requant{qnn::kFP32, 0, 0, zero_point, 0, 255, scale});
  return static_cast<int>(cudaGetLastError());
}
