// q8gavgpool: quantized global average pool, uint8 [B, S, C] -> uint8 [B, C].
//
// Replaces the TPU kernel qnnpack_tpu/kernels/pool.py:q8gavgpool_pallas:
//
//   acc[b, c] = sum_s x[b, s, c] + bias          (int32, wrapping)
//   y[b, c]   = avgpool_quantize(acc)            (64-bit product, -1 for
//               negative values, rounding arithmetic shift, low 32 bits)
//
// The JAX kernel adds bias + 128 S over biased int8; the sum of the raw
// bytes plus bias is the same value mod 2^32.
//
// What bounds it: S bytes read per output byte and one add each - memory
// bound (MobileNetV2's b128 pool reads 8.03 MB, 2.4 us at 3.35 TB/s).  At a
// few microseconds a launch, what decides its time is how many bytes are in
// flight at once.  Design:
//   - an instance is (V, sums): a thread takes one channel vector of V =
//     16, 8, 4 or 1 bytes (kernels/pool.py:gavgpool_instance: C % V == 0
//     and both bases aligned); sums "halves" for S <= kHalfRows, "wide"
//     for any S;
//   - the block's threadIdx.y row groups split the S rows: group g of R
//     takes rows g, g + R, g + 2R, ..., kBatch of them at a time, all their
//     loads issued before any is added;
//   - sums in 16-bit halves: a word's bytes 0 and 2 are w & 0x00FF00FF,
//     bytes 1 and 3 (w >> 8) & 0x00FF00FF, two adds a word and row, exact
//     up to kHalfRows rows (257 * 255 < 2^16); the wide instance moves its
//     halves into 32-bit sums every kFlushRows of its rows, so it takes any
//     S;
//   - the row groups meet in shared memory: halves, each word's two 16-bit
//     sums, which the groups add without a carry since S <= kHalfRows;
//     wide, 32-bit sums; word-major, so that neither the stores nor the
//     reads meet a bank conflict;
//   - then a thread takes one output word of its vector (4 channels, or
//     the byte where V = 1): the groups' sums plus the bias with a uint32
//     wrap, as the reference's int32 sum wraps, requantized
//     (requant.cuh:avgpool_requant), one 4-byte store;
//   - no divide: blockIdx.x walks the channel-vector tiles, blockIdx.y the
//     images (a loop past 65535); index arithmetic is 32-bit, offsets are
//     64-bit products (an image may pass 2^31 bytes).
#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"
#include "requant.cuh"
#include "u8rows.cuh"

namespace {

using qnn_rows::Vec;

constexpr int kThreads = 256;  // at most, a block
constexpr int kLanes = 32;     // channel vectors a block takes, at most
constexpr int kBatch = 8;      // rows a thread loads before it adds any
// Rows whose bytes a 16-bit half sums exactly: 257 * 255 < 2^16.
constexpr int kHalfRows = 257;
// Rows of a thread between two flushes of the wide instance's halves.
constexpr int kFlushRows = 32 * kBatch;
static_assert(kFlushRows <= kHalfRows, "a flush must come before a carry");
constexpr uint32_t kEvenBytes = 0x00FF00FFu;

// The sums instances, as kernels/pool.py:GAVG_SUMS codes them.
constexpr int kHalves = 0;
constexpr int kWide = 1;

struct Shape {
  int batch, rows, channels;
  int vecs;  // channels / V
};

struct Params {
  int32_t bias, multiplier, shift, zero_point, lo, hi;
};

// Adds the byte sums held in 16-bit halves to `sums`, V of them: `even`
// holds bytes 0 and 2 of each word, `odd` bytes 1 and 3.
template <int V, int W>
__device__ __forceinline__ void add_halves(const uint32_t (&even)[W],
                                           const uint32_t (&odd)[W],
                                           uint32_t (&sums)[V]) {
  if constexpr (V == 1) {
    sums[0] += even[0] & 0xFFFFu;
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      sums[4 * i] += even[i] & 0xFFFFu;
      sums[4 * i + 1] += odd[i] & 0xFFFFu;
      sums[4 * i + 2] += even[i] >> 16;
      sums[4 * i + 3] += odd[i] >> 16;
    }
  }
}

__device__ __forceinline__ uint8_t requant(uint32_t sum, const Params& p) {
  return qnn::avgpool_requant(
      static_cast<int32_t>(sum + static_cast<uint32_t>(p.bias)),
      p.multiplier, p.shift, p.zero_point, p.lo, p.hi);
}

template <int V, int kSums>
__global__ void __launch_bounds__(kThreads)
    q8gavgpool_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
                      Shape s, Params p) {
  constexpr int kWords = Vec<V>::kWords;
  // Words a thread leaves in shared memory: halves, its even words then
  // its odd words (the one word of a byte where V = 1), both sums of two
  // bytes that the row groups add without a carry (S <= kHalfRows); wide,
  // a 32-bit sum a byte.
  constexpr int kStaged = kSums == kWide ? V : (V == 1 ? 1 : 2 * kWords);
  // Word i of thread t at partial[i * threads + t]: consecutive lanes on
  // consecutive banks when they store and when they reduce.
  __shared__ uint32_t partial[kStaged * kThreads];
  const int bx = blockDim.x, groups = blockDim.y;
  const int threads = bx * groups;
  const int tid = threadIdx.y * bx + threadIdx.x;
  const int v = blockIdx.x * bx + threadIdx.x;
  const bool live = v < s.vecs;
  const int64_t image_bytes = static_cast<int64_t>(s.rows) * s.channels;
  const int step = kBatch * groups;
  for (int b = blockIdx.y; b < s.batch; b += gridDim.y) {
    if (live) {
      const uint8_t* col = x + b * image_bytes + static_cast<int64_t>(v) * V;
      uint32_t even[kWords] = {}, odd[kWords] = {};
      [[maybe_unused]] uint32_t sums[V] = {};  // wide
      [[maybe_unused]] int held = 0;  // rows in the halves, wide
      for (int r0 = threadIdx.y; r0 < s.rows; r0 += step) {
        uint32_t w[kBatch][kWords];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int r = r0 + k * groups;
#pragma unroll
          for (int i = 0; i < kWords; ++i) w[k][i] = 0;
          if (r < s.rows) {
            Vec<V>::load(col + static_cast<int64_t>(r) * s.channels, w[k]);
          }
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
#pragma unroll
          for (int i = 0; i < kWords; ++i) {
            even[i] += w[k][i] & kEvenBytes;
            odd[i] += (w[k][i] >> 8) & kEvenBytes;
          }
        }
        if constexpr (kSums == kWide) {
          held += kBatch;
          if (held == kFlushRows) {
            add_halves<V>(even, odd, sums);
#pragma unroll
            for (int i = 0; i < kWords; ++i) even[i] = odd[i] = 0;
            held = 0;
          }
        }
      }
      if constexpr (kSums == kWide) {
        add_halves<V>(even, odd, sums);
#pragma unroll
        for (int j = 0; j < V; ++j) partial[j * threads + tid] = sums[j];
      } else {
#pragma unroll
        for (int i = 0; i < kWords; ++i) {
          partial[i * threads + tid] = even[i];
          if constexpr (V > 1) partial[(kWords + i) * threads + tid] = odd[i];
        }
      }
    }
    __syncthreads();
    // Word i of the vector (4 channels; the byte where V = 1) from the row
    // groups' words, by the threadIdx.y groups in turn.
    if (live) {
      uint8_t* out = y + static_cast<int64_t>(b) * s.channels +
                     static_cast<int64_t>(v) * V;
      const uint32_t* lane = partial + threadIdx.x;
      for (int i = threadIdx.y; i < kWords; i += groups) {
        if constexpr (V == 1) {
          uint32_t sum = 0;
          for (int g = 0; g < groups; ++g) sum += lane[g * bx];
          *out = requant(sum, p);
        } else {
          uint32_t q[4];
          if constexpr (kSums == kWide) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              uint32_t sum = 0;
              for (int g = 0; g < groups; ++g) {
                sum += lane[(4 * i + j) * threads + g * bx];
              }
              q[j] = requant(sum, p);
            }
          } else {
            uint32_t e = 0, o = 0;
            for (int g = 0; g < groups; ++g) {
              e += lane[i * threads + g * bx];
              o += lane[(kWords + i) * threads + g * bx];
            }
            q[0] = requant(e & 0xFFFFu, p);
            q[1] = requant(o & 0xFFFFu, p);
            q[2] = requant(e >> 16, p);
            q[3] = requant(o >> 16, p);
          }
          reinterpret_cast<uint32_t*>(out)[i] =
              q[0] | (q[1] << 8) | (q[2] << 16) | (q[3] << 24);
        }
      }
    }
    __syncthreads();  // the next image reuses `partial`
  }
}

struct Launch {
  const uint8_t* x;
  uint8_t* y;
  Shape s;
  Params p;
  cudaStream_t stream;

  // The channel vectors across threadIdx.x (up to kLanes), as many row
  // groups as fill kThreads threads (at most one a row); a block per
  // vector tile and image.
  template <int V, int kSums>
  cudaError_t run() const {
    Shape shape = s;
    shape.vecs = s.channels / V;
    const int bx = shape.vecs < kLanes ? shape.vecs : kLanes;
    int by = kThreads / bx;
    by = by < s.rows ? by : s.rows;
    by = by > 1 ? by : 1;
    const dim3 grid((shape.vecs + bx - 1) / bx,
                    s.batch < 65535 ? s.batch : 65535);
    q8gavgpool_kernel<V, kSums><<<grid, dim3(bx, by), 0, stream>>>(
        x, y, shape, p);
    return cudaGetLastError();
  }
};

template <int V>
cudaError_t dispatch_sums(int sums, const Launch& f) {
  switch (sums) {
    case kHalves: return f.run<V, kHalves>();
    case kWide: return f.run<V, kWide>();
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// vec and sums: the instance kernels/pool.py:gavgpool_instance picked; vec
// must divide C and both bases, and "halves" takes at most kHalfRows rows.
extern "C" int qnn_q8gavgpool(int device, const void* x, void* y, int batch,
                              int rows, int channels, int bias, int multiplier,
                              int shift, int zero_point, int lo, int hi,
                              int vec, int sums, void* stream) {
  const qnn::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) {
    return static_cast<int>(guard.error());
  }
  const bool vec_ok = (vec == 16 || vec == 8 || vec == 4 || vec == 1) &&
                      channels % vec == 0 && qnn_rows::aligned(x, vec) &&
                      qnn_rows::aligned(y, vec);
  const bool sums_ok = sums == kWide || (sums == kHalves && rows <= kHalfRows);
  if (!vec_ok || !sums_ok || batch < 0 || rows < 0 || channels < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<int64_t>(batch) * channels == 0) return 0;
  const Launch launch{static_cast<const uint8_t*>(x),
                      static_cast<uint8_t*>(y),
                      Shape{batch, rows, channels, 0},
                      Params{bias, multiplier, shift, zero_point, lo, hi},
                      static_cast<cudaStream_t>(stream)};
  switch (vec) {
    case 16: return static_cast<int>(dispatch_sums<16>(sums, launch));
    case 8: return static_cast<int>(dispatch_sums<8>(sums, launch));
    case 4: return static_cast<int>(dispatch_sums<4>(sums, launch));
    default: return static_cast<int>(dispatch_sums<1>(sums, launch));
  }
}
