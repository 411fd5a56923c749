"""Requantization schemes: int32 accumulator -> uint8, in plain PyTorch.

The same five schemes as qnnpack_tpu/quant/requantize.py, bit for bit:

  - q31:      rounding-doubling high multiply, then a remainder-rounded
              shift (QNNPACK q31-scalar.c:17-138);
  - precise:  exact u32 x u32 -> u64 product, round half away from zero
              (precise-scalar.c:138-231);
  - fp32:     float32 multiply, round half to even (fp32-scalar.c:17-65);
  - gemmlowp: sign-dependent nudge, truncating division by 2^31,
              round-up-at-threshold divide by a power of two
              (gemmlowp-scalar.{c,h});
  - fp32 per output channel.

The JAX package builds its 64-bit products from 16-bit limbs because the
TPU has no int64; here every 64-bit intermediate is a native torch int64,
and `_wrap_i32` takes the low 32 bits wherever the JAX int32 arithmetic
wraps.  Every function runs on any device: the CUDA kernels in
qnnpack_tpu_torch/kernels/csrc/requant.cuh are held against them.
"""

from __future__ import annotations

import torch

from .params import (AddQuantParams, AvgPoolQuantParams, ClampParams,
                     FP32Params, GemmlowpParams, PerChannelFP32Params,
                     PreciseParams, Q31Params)


def _i64(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int64)


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """Value of the low 32 bits of an int64 tensor, as a signed int64."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def _clamp_bias_u8(scaled, smin: int, smax: int, zero_point: int):
    """Clamp to [smin, smax] then add zero point, returning uint8."""
    return (scaled.clamp(smin, smax) + zero_point).to(torch.uint8)


def round_shift_q31(q, shift: int, threshold: int, mask: int):
    """asr with round-half-away-from-zero via the remainder trick
    (q31-scalar.c:102-110)."""
    if shift == 0:
        return q
    remainder = (q & mask) - (q < 0).to(torch.int64)
    return (q >> shift) + (remainder > threshold).to(torch.int64)


def requantize_q31(x, params: Q31Params):
    """Q31 requantization: int32 tensor -> uint8 tensor."""
    x = _i64(x)
    q = _wrap_i32((x * params.multiplier + (1 << 30)) >> 31)
    scaled = round_shift_q31(q, params.shift, params.remainder_threshold,
                             params.remainder_mask)
    return _clamp_bias_u8(scaled, params.min_less_zero_point,
                          params.max_less_zero_point, params.zero_point)


def requantize_precise(x, params: PreciseParams):
    """Precise requantization: exact scale, round half away from zero."""
    x = _i64(x)
    abs_scaled = ((x.abs() * params.multiplier + (1 << (params.shift - 1)))
                  >> params.shift) & 0xFFFFFFFF
    scaled = _wrap_i32(torch.where(x >= 0, abs_scaled, -abs_scaled))
    return _clamp_bias_u8(scaled, params.qmin - params.zero_point,
                          params.qmax - params.zero_point, params.zero_point)


def _fp32_epilogue(x, scale: torch.Tensor, zero_point: int, qmin: int,
                   qmax: int):
    # A float32 tensor, never a Python float: a Python scalar may be
    # multiplied in double precision and round differently.
    scaled = _i64(x).to(torch.float32) * scale
    rounded = torch.round(scaled)  # half to even, as lrintf
    clamped = rounded.clamp(float(qmin - zero_point),
                            float(qmax - zero_point)).to(torch.int64)
    return (clamped + zero_point).to(torch.uint8)


def requantize_fp32(x, params: FP32Params):
    """fp32 requantization: float multiply, round half to even (lrintf)."""
    x = torch.as_tensor(x)
    scale = torch.tensor(params.scale, dtype=torch.float32, device=x.device)
    return _fp32_epilogue(x, scale, params.zero_point, params.qmin,
                          params.qmax)


def requantize_fp32_per_channel(x, params: PerChannelFP32Params):
    """Per-output-channel fp32 requantization; channels on the last axis."""
    x = torch.as_tensor(x)
    if x.shape[-1] != len(params.scales):
        raise ValueError(
            f"last axis {x.shape[-1]} != {len(params.scales)} channel scales")
    scale = torch.tensor(params.scales, dtype=torch.float32, device=x.device)
    return _fp32_epilogue(x, scale, params.zero_point, params.qmin,
                          params.qmax)


def requantize_gemmlowp(x, params: GemmlowpParams):
    """gemmlowp-semantics requantization."""
    x = _i64(x)
    # Sign-dependent nudge; multiplier > 0 so sign(x*m) == sign(x).
    nudge = torch.where(x < 0, -0x3FFFFFFF, 0x40000000)
    ab = x * params.multiplier + nudge
    # Truncating (toward-zero) division by 2^31, gemmlowp-scalar.h:41.
    q = _wrap_i32((ab >> 31)
                  + ((ab < 0) & ((ab & 0x7FFFFFFF) != 0)).to(torch.int64))
    # RoundingDivideByPOT: the threshold includes the sign
    # (gemmlowp-scalar.h:44-50).
    if params.shift > 0:
        mask = (1 << params.shift) - 1
        remainder = q & mask
        threshold = (mask >> 1) + (q < 0).to(torch.int64)
        q = (q >> params.shift) + (remainder > threshold).to(torch.int64)
    # gemmlowp adds the zero point before clamping (gemmlowp-scalar.c:59-70).
    biased = _wrap_i32(q + params.zero_point)
    return biased.clamp(params.qmin, params.qmax).to(torch.uint8)


def avgpool_quantize(x, params: AvgPoolQuantParams):
    """Average-pooling requantization of a bias-inclusive int32 accumulator.

    Mirrors qnnp_avgpool_quantize (requantization.h:482-498): signed 64-bit
    product, -1 for negative inputs, round-half-up arithmetic 64-bit shift,
    low 32 bits.
    """
    x = _i64(x)
    prod = (x * params.multiplier - (x < 0).to(torch.int64)
            + (1 << (params.shift - 1)))
    scaled = _wrap_i32(prod >> params.shift)
    return _clamp_bias_u8(scaled, params.output_min_less_zero_point,
                          params.output_max_less_zero_point,
                          params.output_zero_point)


def add_quantize(a, b, params: AddQuantParams):
    """Quantized elementwise add of two uint8 tensors.

    Mirrors qnnp_add_quantize (requantization.h:500-522): dual-multiplier
    accumulate in int32 (wrapping), remainder-rounded shift, clamp after the
    zero point.
    """
    acc = _wrap_i32(params.zero_point_product
                    + _i64(a) * params.a_multiplier
                    + _i64(b) * params.b_multiplier)
    remainder = (acc & params.remainder_mask) - (acc < 0).to(torch.int64)
    acc = (acc >> params.shift) + \
        (remainder > params.remainder_threshold).to(torch.int64)
    y = acc + params.y_zero_point
    y = torch.clamp(y, max=params.y_max)
    y = torch.clamp(y, min=params.y_min)
    return y.to(torch.uint8)


def clamp_u8(x, params: ClampParams):
    """uint8 clamp (u8clamp ukernel analogue)."""
    x = torch.as_tensor(x).to(torch.uint8)
    return x.clamp(params.output_min, params.output_max)
