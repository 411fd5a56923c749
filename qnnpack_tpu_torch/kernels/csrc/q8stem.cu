// q8stem: stride-2 stem convolution from C_in <= 4 channels with kernel zero
// point 128, uint8 NHWC [B, H, W, C] x biased-int8 weights -> uint8 NHWC
// [B, Ho, Wo, O].
//
// Replaces the TPU kernel qnnpack_tpu/kernels/q8stem.py:q8stem_pallas (body
// _kernel).
//
//   acc[m, o] = sum_k A[m, k] W'[k, o] + c[o]            (mod 2^32)
//   out[m, o] = requantize(acc[m, o])   (any per-tensor scheme, or per-channel)
//
// an implicit GEMM with M = B*Ho*Wo output pixels, A the raw uint8 window of
// pixel m (the pixels 2y - pt + ky, 2x - pl + kx) and c = bias' - 128
// colsum(W'), the packed record's bias_c: kzp' = 0, so there is no row sum,
// and the input needs no rebias.  A tap outside the image reads the raw
// input zero point, the zero-point padding of nn/conv.py.
//
// Not carried over: the TPU kernel's 2x2 space-to-depth packing of the
// input (nn/conv.py:_stem_space_to_depth).  It exists to deepen the MXU's
// contraction from C_in = 3 to 16; here the K order is the kernel's own.
//
// What bounds it: per output byte Kh*Kw*C multiply-adds (147 for the
// ResNet 7x7x3 stem) against one byte written and 3/4 of a byte read, so at
// the int8 tensor rate it is bound by bytes (122 MB, 0.036 ms at ResNet-18
// b128), dominated by the output.  Design:
//   - the tensor-core tile of imma_tile.cuh (u8 x s8 mma.sync from a
//     cp.async ring, the shared epilogue) with a stem loader.  K is the
//     record's w_stem order (nn/conv.py): kernel row ky's Kw*C window bytes
//     at ky*Rs, zero up to Rs (a multiple of 32), so that a 64-byte K step
//     holds whole row segments - the ResNet stem's K = 147 takes 4 steps,
//     MobileNetV2's 27 takes 2;
//   - B comes from w_stem with cp.async, 16 bytes a copy;
//   - A cannot: a window row is Kw*C bytes at an odd offset.  A block
//     takes up to 128 pixels of one output row, whose windows read Kh
//     input rows of (2 * 127 + Kw) * C bytes (5.9 KB for the ResNet stem).
//     It first stages those rows in shared memory with 16-byte cp.async
//     copies of the aligned segments that hold image bytes, all in flight
//     at once, and writes the raw input zero point over the columns outside
//     the image (and whole rows outside it).  The loader then builds each
//     16-byte chunk of an A row from five aligned shared words and four
//     funnel shifts, and stores it with one st.shared.  Bytes past Kw*C of
//     a kernel row, or past the last one, meet zero weights.  A first
//     design read the window bytes from global memory in the loader; each
//     K step then waited on a load's latency, and the ResNet stem took
//     0.715 ms, MobileNetV2's 0.258 ms (H100 80GB HBM3, 700 W,
//     chip_smoke.py);
//   - the block is 128 pixels x 32 or 64 output channels (O = 24 and 32 take
//     the first, 64 the second, wider O more column blocks); K is at most
//     Kh * Rs, far below the split-K threshold, so no split.  Rows of Wo
//     not a multiple of 128 leave the last block of the row part empty
//     (112 of 128 at the main paths' Wo = 112).
#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"
#include "imma_tile.cuh"

namespace {

namespace im = qnn::imma;

constexpr int kMaxKernelH = 32;  // staged input rows a block holds

// 4 warps of 32 x 32 or 32 x 64.  K is 2 to 4 steps, so a 2-stage ring:
// the smaller shared footprint lets 7 (5) blocks share an SM, which beat 4
// stages and 4 (3) blocks (H100 80GB HBM3, 700 W; PERF.md).
using StemTile32 = im::Tile<128, 32, 4, 1, 7, im::kStepK, 2>;
using StemTile64 = im::Tile<128, 64, 4, 1, 5, im::kStepK, 2>;

struct StemArgs {
  const uint8_t* a;
  const uint8_t* a_end;  // one past the input's last byte
  const int8_t* w;  // w_stem [O, Kh * Rs]
  const int32_t* bias_c;
  const float* scales;
  uint8_t* out;
  int batch, height, width, channels;
  int out_height, out_width, out_channels;
  int kernel_h, kernel_w, pad_top, pad_left, izp, row_pitch;
  int stage_pitch;  // bytes a staged input row takes in shared memory
  qnn::Requant rp;
};

// The window columns a block's BM pixels read: 2 (BM - 1) + Kw.
template <class T>
__host__ __device__ __forceinline__ int span_cols(int kernel_w) {
  return 2 * (T::BM - 1) + kernel_w;
}

// Shared-memory bytes of a staged input row: a 0..15 byte lead (the row's
// offset from a 16-byte boundary), the span, and slack for the loader's
// last aligned words, which reach up to Rs + 20 bytes past the last
// pixel's window start.
template <class T>
int stage_pitch(int kernel_w, int channels, int row_pitch) {
  const int bytes = 16 + 2 * (T::BM - 1) * channels + row_pitch + 24;
  return (bytes + 15) / 16 * 16;
}

// One K step of A (from the staged rows) and B (cp.async from w_stem).
// Thread t fills 16-byte chunk t % 4 of rows t / 4 + (T::kThreads / 4) i.
template <class T>
struct StemLoader {
  const uint8_t* rows;  // staged input rows, stage_pitch apart
  const int* lead;      // each staged row's lead bytes
  const int8_t* w_rows;  // w_stem row n0
  int n_rows, channels, kernel_h, row_pitch, stage_pitch;

  __device__ __forceinline__ void load(uint8_t* sa, uint8_t* sb,
                                       int step) const {
    constexpr int kChunks = T::kStep / 16;
    static_assert(T::kThreads % kChunks == 0, "chunks divide the threads");
    const int chunk = threadIdx.x % kChunks;
    const int k0 = step * T::kStep + chunk * 16;
    const int ky = k0 / row_pitch;        // chunks never straddle rows
    const int j0 = k0 - ky * row_pitch;   // first byte in the window row
    const bool tap_row = ky < kernel_h;
    const uint8_t* src = rows + (tap_row ? ky * stage_pitch + lead[ky] : 0);
#pragma unroll
    for (int i = 0; i < T::BM * kChunks / T::kThreads; ++i) {
      const int r = threadIdx.x / kChunks + i * (T::kThreads / kChunks);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (tap_row) {
        // Pixel r's window row starts 2 r C bytes into the staged row.
        const uint8_t* p = src + 2 * r * channels + j0;
        const auto* word = reinterpret_cast<const uint32_t*>(
            reinterpret_cast<uintptr_t>(p) & ~uintptr_t{3});
        const int sh = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 3)
                       * 8;
        const uint32_t w0 = word[0], w1 = word[1], w2 = word[2],
                       w3 = word[3], w4 = word[4];
        v = make_uint4(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
                       __funnelshift_r(w2, w3, sh),
                       __funnelshift_r(w3, w4, sh));
      }
      *reinterpret_cast<uint4*>(sa + r * T::kPitch + chunk * 16) = v;
    }
    im::load_b<T>(sb, w_rows, static_cast<int64_t>(kernel_h) * row_pitch,
                  static_cast<int64_t>(step) * T::kStep, n_rows);
  }
};

// Stage the Kh input rows of output row `oy` from column ix0 on: image
// bytes by 16-byte cp.async, then the raw zero point over the columns and
// rows outside the image.  `lead` gets each row's lead bytes.  A segment
// that reaches past either end of the input tensor copies only the row's
// image bytes in it, byte by byte, so no read leaves the tensor.
template <class T>
__device__ __forceinline__ void stage_rows(const StemArgs& p, uint8_t* rows,
                                           int* lead, int b, int oy,
                                           int ix0) {
  const int span = span_cols<T>(p.kernel_w) * p.channels;
  const int segs = p.stage_pitch / 16;
  const int lo_col = max(ix0, 0);
  const int hi_col = min(ix0 + span_cols<T>(p.kernel_w), p.width);
  for (int idx = threadIdx.x; idx < p.kernel_h * segs; idx += T::kThreads) {
    const int ky = idx / segs;
    const int seg = idx - ky * segs;
    const int iy = 2 * oy - p.pad_top + ky;
    const int64_t row_px = (static_cast<int64_t>(b) * p.height + iy) *
                           p.width;
    // The staged row's first byte is image column ix0 of row iy.
    const uintptr_t start = reinterpret_cast<uintptr_t>(p.a) +
                            static_cast<uintptr_t>((row_px + ix0) *
                                                   p.channels);
    const uintptr_t base = start & ~uintptr_t{15};
    if (seg == 0) lead[ky] = static_cast<int>(start - base);
    if (static_cast<unsigned>(iy) >= static_cast<unsigned>(p.height) ||
        lo_col >= hi_col) {
      continue;
    }
    const uintptr_t first = reinterpret_cast<uintptr_t>(p.a) +
                            static_cast<uintptr_t>((row_px + lo_col) *
                                                   p.channels);
    const uintptr_t last = reinterpret_cast<uintptr_t>(p.a) +
                           static_cast<uintptr_t>((row_px + hi_col) *
                                                  p.channels);
    const uintptr_t src = (first & ~uintptr_t{15}) + 16 * seg;
    uint8_t* dst = rows + ky * p.stage_pitch + (src - base);
    if (src >= last) {
      continue;
    } else if (src >= reinterpret_cast<uintptr_t>(p.a) &&
               src + 16 <= reinterpret_cast<uintptr_t>(p.a_end)) {
      im::cp_async<16>(dst, reinterpret_cast<const void*>(src), true);
    } else {  // rare: a view's base, or a size not a multiple of 16
#pragma unroll 1
      for (int i = 0; i < 16; ++i) {
        if (src + i >= first && src + i < last) {
          dst[i] = __ldg(reinterpret_cast<const uint8_t*>(src + i));
        }
      }
    }
  }
  im::cp_async_commit();
  im::cp_async_wait<0>();
  __syncthreads();
  // Columns [0, left) and [right, span) of a row inside the image, and all
  // of a row outside it, read the zero point.
  const int left = (lo_col - ix0) * p.channels;
  const int right = max(left, (hi_col - ix0) * p.channels);
  const auto zp = static_cast<uint8_t>(p.izp);
  for (int ky = 0; ky < p.kernel_h; ++ky) {
    const int iy = 2 * oy - p.pad_top + ky;
    uint8_t* row = rows + ky * p.stage_pitch + lead[ky];
    if (static_cast<unsigned>(iy) >= static_cast<unsigned>(p.height)) {
      for (int j = threadIdx.x; j < span; j += T::kThreads) row[j] = zp;
    } else {
      for (int j = threadIdx.x; j < left; j += T::kThreads) row[j] = zp;
      for (int j = right + threadIdx.x; j < span; j += T::kThreads) {
        row[j] = zp;
      }
    }
  }
  __syncthreads();
}

template <class T>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
    q8stem_kernel(const StemArgs p) {
  extern __shared__ __align__(16) uint8_t ring[];
  __shared__ int lead[kMaxKernelH];
  // Block x: BM pixels from column ox0 of output row oy of image b.
  const int row_tiles = (p.out_width + T::BM - 1) / T::BM;
  const int tile = blockIdx.x % row_tiles;
  const int rest = blockIdx.x / row_tiles;
  const int oy = rest % p.out_height;
  const int b = rest / p.out_height;
  const int ox0 = tile * T::BM;
  const int n0 = blockIdx.y * T::BN;
  uint8_t* rows = ring + T::kSmemBytes;
  stage_rows<T>(p, rows, lead, b, oy, 2 * ox0 - p.pad_left);

  const int steps = (p.kernel_h * p.row_pitch + T::kStep - 1) / T::kStep;
  const StemLoader<T> ld{rows, lead,
                         p.w + static_cast<int64_t>(n0) * p.kernel_h *
                                   p.row_pitch,
                         p.out_channels - n0, p.channels, p.kernel_h,
                         p.row_pitch, p.stage_pitch};
  im::Acc<T> acc;
  im::mainloop<T>(ld, ring, 0, steps, false, acc);
  const int64_t m0 =
      (static_cast<int64_t>(b) * p.out_height + oy) * p.out_width + ox0;
  const int valid = min(T::BM, p.out_width - ox0);
  im::epilogue<T>(acc, ring, m0, n0, m0 + valid, p.out_channels,
                  p.out_channels, 0, p.bias_c, p.scales, 0, p.rp, p.out);
}

template <class T>
cudaError_t launch(StemArgs p, int device, cudaStream_t stream) {
  p.stage_pitch = stage_pitch<T>(p.kernel_w, p.channels, p.row_pitch);
  const int smem = T::kSmemBytes + p.kernel_h * p.stage_pitch;
  if (smem > 200 * 1024) return cudaErrorInvalidValue;
  // Opted in once a device at the largest size this launcher may take.
  static unsigned ready = 0;
  const cudaError_t err = im::allow_smem(q8stem_kernel<T>, q8stem_kernel<T>,
                                         200 * 1024, device, ready);
  if (err != cudaSuccess) return err;
  const int64_t blocks = static_cast<int64_t>(p.batch) * p.out_height *
                         ((p.out_width + T::BM - 1) / T::BM);
  if (blocks >= (int64_t{1} << 31)) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>((p.out_channels + T::BN - 1) / T::BN));
  q8stem_kernel<T><<<grid, T::kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// `w` is the record's w_stem [out_channels, kernel_h * row_pitch] (K-major,
// 16-byte aligned), `bias_c` its raw-input folded bias, `izp` the raw input
// zero point.  `tile` (32 or 64) names the block's output channels, which
// kernels/q8stem.py:stem_tile picks.
extern "C" int qnn_q8stem(int device, const void* a, const void* w,
                          const void* bias_c, const void* scales, void* out,
                          int batch, int height, int width, int channels,
                          int out_height, int out_width, int out_channels,
                          int kernel_h, int kernel_w, int pad_top,
                          int pad_left, int izp, int row_pitch, int tile,
                          int scheme, int multiplier, int shift,
                          int zero_point, int qmin, int qmax, float scale,
                          void* stream) {
  const qnn::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) {
    return static_cast<int>(guard.error());
  }
  if (static_cast<int64_t>(batch) * out_height * out_width * out_channels ==
      0) {
    return 0;
  }
  if (channels < 1 || channels > 4 || kernel_h < 1 || kernel_w < 1 ||
      kernel_h > kMaxKernelH || row_pitch % 32 != 0 ||
      row_pitch < kernel_w * channels ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      (tile != StemTile32::BN && tile != StemTile64::BN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const StemArgs p{static_cast<const uint8_t*>(a),
                   static_cast<const uint8_t*>(a) +
                       static_cast<int64_t>(batch) * height * width *
                           channels,
                   static_cast<const int8_t*>(w),
                   static_cast<const int32_t*>(bias_c),
                   static_cast<const float*>(scales),
                   static_cast<uint8_t*>(out),
                   batch, height, width, channels,
                   out_height, out_width, out_channels,
                   kernel_h, kernel_w, pad_top, pad_left, izp, row_pitch, 0,
                   qnn::Requant{scheme, multiplier, shift, zero_point, qmin,
                                qmax, scale}};
  const auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(tile == StemTile32::BN
                              ? launch<StemTile32>(p, device, st)
                              : launch<StemTile64>(p, device, st));
}
