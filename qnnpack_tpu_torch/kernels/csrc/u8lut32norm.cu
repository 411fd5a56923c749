// u8lut32norm: pass 2 of softargmax, [R, N] uint8 -> [R, N] uint8.
//
// The port of the normalize pass of qnnpack_tpu/nn/elementwise.py:
// u8softargmax (QNNPACK's u8lut32norm ukernel; no Pallas form in the JAX
// package).  Given each row's max (u8rmax.cu) and a 256-entry uint32 table:
//
//   e[i] = t[x[i] + 255 - rmax]        s = sum_i e[i]          (mod 2^32)
//   y[i] = min((256 e[i] + s / 2) / s, 255)       (uint32, wrapping)
//
// Everything is uint32 arithmetic that wraps, as the reference's is; the
// divide is the hardware's uint32 divide (the JAX package's Barrett
// reciprocal is a TPU trick).
//
// What bounds it: one byte read and one written per element against a
// table lookup, an add, a multiply and a divide - memory bound, the divide
// close behind.  Design: the table in shared memory (1 KB a block), one warp
// a row, eight rows a block; the row is read twice (the sum, then the
// output; the second read hits L1/L2).  Where input and output rows start on
// a 4-byte boundary each lane takes whole words, the rest goes by bytes.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

__device__ __forceinline__ uint32_t norm(uint32_t e, uint32_t s,
                                         uint32_t half) {
  const uint32_t q = (e * 256u + half) / s;
  return q < 255u ? q : 255u;
}

__global__ void __launch_bounds__(kThreads)
    u8lut32norm_kernel(const uint8_t* __restrict__ x,
                       const uint8_t* __restrict__ rmax,
                       const uint32_t* __restrict__ lut,
                       uint8_t* __restrict__ y, int64_t rows, int n) {
  __shared__ uint32_t t[256];
  for (int i = threadIdx.x; i < 256; i += kThreads) t[i] = lut[i];
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kRowsPerBlock;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock +
                   threadIdx.x / 32;
       r < rows; r += step) {
    const uint8_t* xr = x + r * n;
    uint8_t* yr = y + r * n;
    // x <= rmax, so the index stays in the table; the mask only keeps a
    // wrong rmax inside shared memory.
    const uint32_t off = 255u - rmax[r];
    const bool vec = ((reinterpret_cast<uintptr_t>(xr) |
                       reinterpret_cast<uintptr_t>(yr)) & 3) == 0;
    const int words = vec ? n / 4 : 0;
    const unsigned* xw = reinterpret_cast<const unsigned*>(xr);

    uint32_t s = 0;
    for (int i = lane; i < words; i += 32) {
      const unsigned w = xw[i];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s += t[(((w >> (8 * b)) & 0xFFu) + off) & 0xFFu];
      }
    }
    for (int i = words * 4 + lane; i < n; i += 32) {
      s += t[(xr[i] + off) & 0xFFu];
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2) s += __shfl_xor_sync(0xFFFFFFFFu, s, o);

    const uint32_t half = s >> 1;
    unsigned* yw = reinterpret_cast<unsigned*>(yr);
    for (int i = lane; i < words; i += 32) {
      const unsigned w = xw[i];
      unsigned packed = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const uint32_t e = t[(((w >> (8 * b)) & 0xFFu) + off) & 0xFFu];
        packed |= norm(e, s, half) << (8 * b);
      }
      yw[i] = packed;
    }
    for (int i = words * 4 + lane; i < n; i += 32) {
      yr[i] = static_cast<uint8_t>(norm(t[(xr[i] + off) & 0xFFu], s, half));
    }
  }
}

}  // namespace

extern "C" int qnn_u8lut32norm(int device, const void* x, const void* rmax,
                               const void* lut, void* y, int64_t rows, int n,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows == 0) return 0;
  int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;
  u8lut32norm_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(rmax),
      static_cast<const uint32_t*>(lut), static_cast<uint8_t*>(y), rows, n);
  return static_cast<int>(cudaGetLastError());
}
