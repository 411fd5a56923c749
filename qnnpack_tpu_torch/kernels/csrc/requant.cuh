// Requantization epilogues shared by the kernels: int32 accumulator -> uint8.
//
// Bit for bit the same arithmetic as qnnpack_tpu_torch/quant/requantize.py
// (and so as qnnpack_tpu/quant/requantize.py).  64-bit products are native
// int64; wherever the reference's int32 arithmetic wraps, the sum is taken
// in uint32 (signed overflow is undefined in C++, unsigned wraps).  The fp32
// scheme multiplies with __fmul_rn so that no FMA contraction can change a
// rounding, and rounds half to even with rintf, as lrintf does.
#pragma once

#include <cstdint>

namespace qnn {

enum Scheme : int32_t {
  kQ31 = 0,
  kFP32 = 1,
  kPrecise = 2,
  kGemmlowp = 3,
  kFP32PerChannel = 4,
};

// Per-tensor parameters of one requantization.  qmin/qmax are absolute
// uint8 bounds; `scale` is the float32-rounded scale of the fp32 schemes.
struct Requant {
  int32_t scheme;
  int32_t multiplier;
  int32_t shift;
  int32_t zero_point;
  int32_t qmin;
  int32_t qmax;
  float scale;
};

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t low32(int64_t v) {
  return static_cast<int32_t>(static_cast<uint32_t>(
      static_cast<uint64_t>(v)));
}

__device__ __forceinline__ uint8_t clamp_zp(int32_t scaled, int32_t lo,
                                            int32_t hi, int32_t zp) {
  scaled = scaled < lo ? lo : scaled;
  scaled = scaled > hi ? hi : scaled;
  return static_cast<uint8_t>(scaled + zp);
}

// q31: (x * m + 2^30) >> 31, then a shift rounding half away from zero.
__device__ __forceinline__ uint8_t requant_q31(int32_t x, const Requant& p) {
  const int64_t prod = static_cast<int64_t>(x) * p.multiplier + (1LL << 30);
  int32_t q = low32(prod >> 31);
  if (p.shift > 0) {
    const int32_t mask = static_cast<int32_t>((1u << p.shift) - 1u);
    const int32_t threshold = mask >> 1;
    const int32_t remainder = (q & mask) - (q < 0 ? 1 : 0);
    q = (q >> p.shift) + (remainder > threshold ? 1 : 0);
  }
  return clamp_zp(q, p.qmin - p.zero_point, p.qmax - p.zero_point,
                  p.zero_point);
}

// fp32: float multiply, round half to even, float clamp, integer zero point.
__device__ __forceinline__ uint8_t requant_fp32(int32_t x, float scale,
                                                const Requant& p) {
  float s = rintf(__fmul_rn(__int2float_rn(x), scale));
  const float lo = static_cast<float>(p.qmin - p.zero_point);
  const float hi = static_cast<float>(p.qmax - p.zero_point);
  s = fminf(fmaxf(s, lo), hi);
  return static_cast<uint8_t>(static_cast<int32_t>(s) + p.zero_point);
}

// precise: |x| * m + 2^(shift-1), logical shift, sign restored mod 2^32.
__device__ __forceinline__ uint8_t requant_precise(int32_t x,
                                                   const Requant& p) {
  const uint32_t xabs = x >= 0 ? static_cast<uint32_t>(x)
                               : 0u - static_cast<uint32_t>(x);
  const uint64_t prod = static_cast<uint64_t>(xabs) *
                            static_cast<uint32_t>(p.multiplier) +
                        (1ULL << (p.shift - 1));
  const uint32_t abs_scaled = static_cast<uint32_t>(prod >> p.shift);
  const int32_t scaled = static_cast<int32_t>(x >= 0 ? abs_scaled
                                                     : 0u - abs_scaled);
  return clamp_zp(scaled, p.qmin - p.zero_point, p.qmax - p.zero_point,
                  p.zero_point);
}

// gemmlowp: nudge, truncating divide by 2^31, rounding divide by 2^shift,
// zero point added (wrapping) before the clamp.
__device__ __forceinline__ uint8_t requant_gemmlowp(int32_t x,
                                                    const Requant& p) {
  const int64_t ab = static_cast<int64_t>(x) * p.multiplier +
                     (x < 0 ? -0x3FFFFFFFLL : 0x40000000LL);
  const bool frac = (ab & 0x7FFFFFFFLL) != 0;
  int32_t q = wrap_add(low32(ab >> 31), (ab < 0 && frac) ? 1 : 0);
  if (p.shift > 0) {
    const int32_t mask = static_cast<int32_t>((1u << p.shift) - 1u);
    const int32_t remainder = q & mask;
    const int32_t threshold = (mask >> 1) + (q < 0 ? 1 : 0);
    q = (q >> p.shift) + (remainder > threshold ? 1 : 0);
  }
  int32_t biased = wrap_add(q, p.zero_point);
  biased = biased < p.qmin ? p.qmin : biased;
  biased = biased > p.qmax ? p.qmax : biased;
  return static_cast<uint8_t>(biased);
}

// Any scheme; `channel_scale` is read by the per-channel fp32 scheme only.
__device__ __forceinline__ uint8_t requantize(int32_t x, const Requant& p,
                                              float channel_scale) {
  switch (p.scheme) {
    case kQ31:
      return requant_q31(x, p);
    case kFP32:
      return requant_fp32(x, p.scale, p);
    case kPrecise:
      return requant_precise(x, p);
    case kGemmlowp:
      return requant_gemmlowp(x, p);
    default:
      return requant_fp32(x, channel_scale, p);
  }
}

// requantize() for one accumulator x, the scheme S fixed at compile time
// (S < 0: rp.scheme, read at run time), as the wgmma epilogue takes it.
// The fp32 schemes take one conversion where requant_fp32 takes three (the
// card converts at an eighth of its float rate) and give its bytes: they
// clamp before rounding, which gives the same value because the bounds
// lo = qmin - zp and hi = qmax - zp are integers, and then a value within
// +-255 rounds half to even and becomes an integer in one float add of
// 1.5 * 2^23.
template <int S>
__device__ __forceinline__ uint32_t requant_one(uint32_t x, const Requant& rp,
                                                float scale, float lo,
                                                float hi) {
  if constexpr (S == kFP32 || S == kFP32PerChannel) {
    const float f = fminf(
        fmaxf(__fmul_rn(__int2float_rn(static_cast<int32_t>(x)), scale), lo),
        hi);
    return static_cast<uint32_t>(__float_as_int(__fadd_rn(f, 12582912.0f)) -
                                 0x4B400000 + rp.zero_point);
  } else {
    return requantize(static_cast<int32_t>(x), rp, scale);
  }
}

// Average-pool requantization (qnnp_avgpool_quantize): 64-bit product, -1
// for negative values, + 2^(shift-1), arithmetic shift, low 32 bits.  lo/hi
// are the output bounds less the zero point.
__device__ __forceinline__ uint8_t avgpool_requant(int32_t x,
                                                   int32_t multiplier,
                                                   int32_t shift, int32_t zp,
                                                   int32_t lo, int32_t hi) {
  const int64_t prod = static_cast<int64_t>(x) * multiplier -
                       (x < 0 ? 1 : 0) + (1LL << (shift - 1));
  return clamp_zp(low32(prod >> shift), lo, hi, zp);
}

}  // namespace qnn
