// moe_route: the routing of an expert layer held in part on this device
// (kernels/moe.py moe_route_cuda), two kernels.
//
// moe_route_kernel, one warp a token: the router's accumulator r = logits +
// bias_c (int32, wrapping) of each of the n experts, rho = requant(r)
// (fp32), sigma = lut[rho], and the top k by the key
//
//   (sigma + corr) << 41 | (r + 2^31) << 9 | (511 - e)      (largest first)
//
// (score, then accumulator, then the lower expert: every key differs), by
// k rounds of a warp maximum over the lanes' keys; then the weights
// w = min((256 sigma + S / 2) / S, 255) with S the chosen sigmas' sum (32
// each where S = 0).  It writes sel, wts and slot = -1 for each (t, k).
//
// moe_dispatch_kernel, a grid of held experts x kSlices blocks: block (e, g)
// numbers the tokens that chose expert first + e in token order (a block
// scan of 1,024 tokens at a time, over every token), block (e, 0) writes
// their slots e * t + position and counts[e], and block (e, g) copies the
// rows of the positions p = g mod kSlices into rows[e * t + p].  Every
// block reads the routing of all t tokens (sel, 32 bytes a token, from
// L2), so the numbering needs no second launch, and the copy of the held
// experts' rows (about t k held / n of them) is spread over the slices.
// The routing is read on the device only: a CUDA graph holds both
// launches whatever the tokens choose.
#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"
#include "requant.cuh"

namespace {

constexpr int kRouteThreads = 256;
constexpr int kDispatchThreads = 1024;
constexpr int kSlices = 16;
constexpr uint64_t kValid = 1ull << 63;  // set on every live key

template <int kPer>
__global__ void __launch_bounds__(kRouteThreads)
    moe_route_kernel(const int32_t* __restrict__ logits,
                 const int32_t* __restrict__ bias_c,
                 const int32_t* __restrict__ corr,
                 const uint8_t* __restrict__ lut, int32_t* __restrict__ sel,
                 int32_t* __restrict__ wts, int32_t* __restrict__ slot,
                 int64_t t, int n, int k, qnn::Requant rq) {
  const int lane = threadIdx.x & 31;
  const int64_t tok = static_cast<int64_t>(blockIdx.x) * (kRouteThreads / 32) +
                      (threadIdx.x >> 5);
  if (tok >= t) return;
  uint64_t key[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = lane + 32 * j;
    key[j] = 0;
    if (e < n) {
      const int32_t r = qnn::wrap_add(logits[tok * n + e], __ldg(bias_c + e));
      const int sig = __ldg(lut + qnn::requant_fp32(r, rq.scale, rq));
      key[j] = kValid |
               (static_cast<uint64_t>(sig + __ldg(corr + e) + 4) << 41) |
               (static_cast<uint64_t>(static_cast<uint32_t>(r) ^
                                      0x80000000u) << 9) |
               static_cast<uint64_t>(511 - e);
    }
  }
  int my_e = 0;
  int my_sig = 0;
  for (int kk = 0; kk < k; ++kk) {
    uint64_t best = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) best = key[j] > best ? key[j] : best;
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      const uint64_t other = __shfl_xor_sync(0xFFFFFFFFu, best, off);
      best = other > best ? other : best;
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (key[j] == best) key[j] = 0;  // keys differ: one lane holds it
    }
    const int e = 511 - static_cast<int>(best & 511u);
    if (lane == kk) {
      my_e = e;
      my_sig = static_cast<int>((best >> 41) & 0x3FFFFFu) - 4 -
               __ldg(corr + e);
    }
  }
  int total = lane < k ? my_sig : 0;
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    total += __shfl_xor_sync(0xFFFFFFFFu, total, off);
  }
  if (lane < k) {
    const uint32_t s = static_cast<uint32_t>(total);
    uint32_t w = 32;
    if (s > 0) {
      w = (256u * static_cast<uint32_t>(my_sig) + s / 2) / s;
      w = w < 255u ? w : 255u;
    }
    sel[tok * k + lane] = my_e;
    wts[tok * k + lane] = static_cast<int32_t>(w);
    slot[tok * k + lane] = -1;
  }
}

__global__ void __launch_bounds__(kDispatchThreads)
    moe_dispatch_kernel(const int32_t* __restrict__ sel,
                    int32_t* __restrict__ slot, int32_t* __restrict__ counts,
                    const uint8_t* __restrict__ x, uint8_t* __restrict__ rows,
                    int64_t t, int k, int first, int h) {
  __shared__ int warp_total[kDispatchThreads / 32];
  __shared__ int list[kDispatchThreads];   // the chunk's tokens, in order
  __shared__ int chunk_total;
  const int e = blockIdx.x;
  const int g = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int vecs = h / 16;
  const int64_t seg = static_cast<int64_t>(e) * t;  // the expert's rows
  int64_t running = 0;
  for (int64_t base = 0; base < t; base += kDispatchThreads) {
    const int64_t tok = base + threadIdx.x;
    int kk = -1;
    if (tok < t) {
      for (int j = 0; j < k; ++j) {
        if (sel[tok * k + j] == first + e) kk = j;
      }
    }
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, kk >= 0);
    if (lane == 0) warp_total[warp] = __popc(ballot);
    __syncthreads();
    if (threadIdx.x == 0) {
      int sum = 0;
      for (int w = 0; w < kDispatchThreads / 32; ++w) {
        const int c = warp_total[w];
        warp_total[w] = sum;
        sum += c;
      }
      chunk_total = sum;
    }
    __syncthreads();
    if (kk >= 0) {
      const int at = warp_total[warp] + __popc(ballot & ((1u << lane) - 1u));
      list[at] = static_cast<int>(tok);
      if (g == 0) {
        slot[tok * k + kk] = static_cast<int32_t>(seg + running + at);
      }
    }
    __syncthreads();
    // This slice's rows of the chunk: positions running + j, j = j0 mod
    // kSlices.
    const int n_chunk = chunk_total;
    const int j0 = static_cast<int>(((g - running) % kSlices + kSlices) %
                                    kSlices);
    const int mine = n_chunk > j0 ? (n_chunk - j0 + kSlices - 1) / kSlices
                                  : 0;
    for (int idx = threadIdx.x; idx < mine * vecs;
         idx += kDispatchThreads) {
      const int j = j0 + kSlices * (idx / vecs);
      const int c = idx % vecs;
      const uint4 v = *reinterpret_cast<const uint4*>(
          x + static_cast<int64_t>(list[j]) * h + 16 * c);
      *reinterpret_cast<uint4*>(rows + (seg + running + j) * h + 16 * c) = v;
    }
    running += n_chunk;
    __syncthreads();  // list and the totals are refilled next
  }
  if (g == 0 && threadIdx.x == 0) counts[e] = static_cast<int32_t>(running);
}

}  // namespace

// logits int32 [t, n] (the router's partial, to which bias_c [n] is
// added), corr int32 [n] in [-4, 2^22), lut uint8 [256], x uint8 [t, h] ->
// sel, wts, slot int32 [t, top_k], counts int32 [held], rows uint8
// [held * t, h].  n <= 512, top_k <= 32, h % 16 == 0, x and rows on
// 16-byte boundaries; fp32 requantization of the accumulator.
extern "C" int qnn_moe_route(int device, const void* logits,
                             const void* bias_c, const void* corr,
                             const void* lut, const void* x, void* sel,
                             void* wts, void* slot, void* counts,
                             void* rows, int64_t t, int n, int top_k,
                             int first, int held, int h, int zero_point,
                             int qmin, int qmax, float scale, void* stream) {
  const qnn::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) {
    return static_cast<int>(guard.error());
  }
  if (t < 0 || t > INT32_MAX / 8 || n < 1 || n > 512 || top_k < 1 ||
      top_k > 32 || top_k > n || first < 0 || held < 1 ||
      first + held > n || held > 65535 || h < 16 || h % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(rows) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (t == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const qnn::Requant rq{qnn::kFP32, 0, 0, zero_point, qmin, qmax, scale};
  const auto* lg = static_cast<const int32_t*>(logits);
  const auto* bc = static_cast<const int32_t*>(bias_c);
  const auto* cr = static_cast<const int32_t*>(corr);
  const auto* lt = static_cast<const uint8_t*>(lut);
  auto* sl = static_cast<int32_t*>(sel);
  auto* wt = static_cast<int32_t*>(wts);
  auto* st = static_cast<int32_t*>(slot);
  constexpr int kTokens = kRouteThreads / 32;  // a warp a token
  const unsigned grid = static_cast<unsigned>((t + kTokens - 1) / kTokens);
  if (n <= 256) {
    moe_route_kernel<8><<<grid, kRouteThreads, 0, s>>>(lg, bc, cr, lt, sl, wt,
                                                   st, t, n, top_k, rq);
  } else {
    moe_route_kernel<16><<<grid, kRouteThreads, 0, s>>>(lg, bc, cr, lt, sl, wt,
                                                    st, t, n, top_k, rq);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  moe_dispatch_kernel<<<dim3(held, kSlices), kDispatchThreads, 0, s>>>(
      sl, st, static_cast<int32_t*>(counts), static_cast<const uint8_t*>(x),
      static_cast<uint8_t*>(rows), t, top_k, first, h);
  return static_cast<int>(cudaGetLastError());
}
