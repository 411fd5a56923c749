"""Host-side quantization-parameter precomputation.

Converts float requantization scales into the exact fixed-point parameter
blocks the kernels consume.  The math mirrors, bit for bit, QNNPACK's
create-time precompute in src/qnnpack/requantization.h:
  - Q31 multiplier/shift:            requantization.h:56-120
  - conv quantization params:        requantization.h:122-198
  - avgpool bias/multiplier/shift:   requantization.h:200-303
  - add dual-multiplier params:      requantization.h:327-462
  - u8 clamping params:              requantization.h:305-325

A copy of qnnpack_tpu/quant/params.py, kept here so that this package
depends on nothing of the JAX package.  All fields are plain Python ints,
computed once when an operator is created.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def fp32_to_bits(x: float) -> int:
    """Bit pattern of a float32 as an unsigned int (fp16/bitcasts.h analogue)."""
    return int(np.float32(x).view(np.uint32))


def fp32_from_bits(bits: int) -> float:
    return float(np.uint32(bits).view(np.float32))


def _lrintf(x: float) -> int:
    """Round float to nearest integer, ties to even (C lrintf default mode)."""
    return int(np.rint(np.float32(x)))


@dataclasses.dataclass(frozen=True)
class Q31Params:
    """Q31 requantization parameters (requantization.h:22-54 scalar variant)."""

    multiplier: int  # in [0x40000000, 0x7FFFFF80]
    shift: int  # in [0, 31]
    remainder_mask: int
    remainder_threshold: int
    zero_point: int
    min_less_zero_point: int
    max_less_zero_point: int


def compute_q31_params(scale: float, zero_point: int, qmin: int = 0,
                       qmax: int = 255) -> Q31Params:
    """Mirror of qnnp_compute_scalar_requantization_params (requantization.h:22)."""
    scale = float(np.float32(scale))
    if not (scale < 1.0 and scale >= math.ldexp(1.0, -32)):
        raise ValueError(f"q31 requantization requires 2^-32 <= scale < 1.0, got {scale}")
    scale_bits = fp32_to_bits(scale)
    multiplier = ((scale_bits & 0x007FFFFF) | 0x00800000) << 7
    shift = 127 + 31 - 32 - (scale_bits >> 23)
    assert 0x40000000 <= multiplier <= 0x7FFFFF80
    assert 0 <= shift < 32
    remainder_mask = (1 << shift) - 1
    return Q31Params(
        multiplier=multiplier,
        shift=shift,
        remainder_mask=remainder_mask,
        remainder_threshold=remainder_mask >> 1,
        zero_point=int(zero_point),
        min_less_zero_point=int(qmin) - int(zero_point),
        max_less_zero_point=int(qmax) - int(zero_point),
    )


@dataclasses.dataclass(frozen=True)
class PreciseParams:
    """Precise (round-half-away-from-zero) requantization parameters.

    Mirrors the u64 variant setup in precise-scalar.c:151-158.
    """

    multiplier: int  # 24-bit, in [0x800000, 0xFFFFFF]
    shift: int  # in [24, 56)
    zero_point: int
    qmin: int
    qmax: int


def compute_precise_params(scale: float, zero_point: int, qmin: int = 0,
                           qmax: int = 255) -> PreciseParams:
    scale = float(np.float32(scale))
    if not (scale < 1.0 and scale >= math.ldexp(1.0, -32)):
        raise ValueError(f"precise requantization requires 2^-32 <= scale < 1.0, got {scale}")
    scale_bits = fp32_to_bits(scale)
    multiplier = (scale_bits & 0x007FFFFF) | 0x00800000
    shift = 127 + 23 - (scale_bits >> 23)
    assert 24 <= shift < 56
    return PreciseParams(multiplier=multiplier, shift=shift,
                         zero_point=int(zero_point), qmin=int(qmin), qmax=int(qmax))


@dataclasses.dataclass(frozen=True)
class FP32Params:
    """fp32 requantization: float multiply + round-half-even (fp32-scalar.c:17-65)."""

    scale: float
    zero_point: int
    qmin: int
    qmax: int


def compute_fp32_params(scale: float, zero_point: int, qmin: int = 0,
                        qmax: int = 255) -> FP32Params:
    return FP32Params(scale=float(np.float32(scale)), zero_point=int(zero_point),
                      qmin=int(qmin), qmax=int(qmax))


@dataclasses.dataclass(frozen=True)
class PerChannelFP32Params:
    """Per-output-channel fp32 requantization.

    QNNPACK is per-tensor only (one scale per operator,
    requantization.h:122-198); real quantized exports carry one kernel scale
    per output channel.  Scales are kept as a hashable tuple; the
    requantizer broadcasts them over the trailing (channel) axis.
    """

    scales: tuple  # per-channel float32 scales, length = output channels
    zero_point: int
    qmin: int
    qmax: int
    # The scales as a float32 tensor on the device that runs the kernel,
    # where their owner made one (ops/convolution.py:Convolution2D at
    # create); else the kernels' wrappers make it at launch.
    device_scales: object = dataclasses.field(default=None, compare=False,
                                              repr=False)


def compute_per_channel_fp32_params(scales, zero_point: int, qmin: int = 0,
                                    qmax: int = 255) -> PerChannelFP32Params:
    scales = tuple(float(np.float32(s)) for s in np.asarray(scales).ravel())
    if not scales:
        raise ValueError("per-channel requantization requires >= 1 scale")
    for s in scales:
        if not (s < 256.0 and s >= math.ldexp(1.0, -32)):
            raise ValueError(
                f"per-channel requantization requires 2^-32 <= scale < 256, got {s}")
    return PerChannelFP32Params(scales=scales, zero_point=int(zero_point),
                                qmin=int(qmin), qmax=int(qmax))


@dataclasses.dataclass(frozen=True)
class GemmlowpParams:
    """gemmlowp-semantics requantization (gemmlowp-scalar.c:19-78)."""

    multiplier: int  # bit pattern, may exceed 2^31 as unsigned
    shift: int  # in [0, 31]
    zero_point: int
    qmin: int
    qmax: int


def compute_gemmlowp_params(scale: float, zero_point: int, qmin: int = 0,
                            qmax: int = 255) -> GemmlowpParams:
    scale = float(np.float32(scale))
    if not (scale < 1.0 and scale >= math.ldexp(1.0, -32)):
        raise ValueError(f"gemmlowp requantization requires 2^-32 <= scale < 1.0, got {scale}")
    scale_bits = fp32_to_bits(scale)
    multiplier = ((scale_bits & 0x007FFFFF) | 0x00800000) << 7
    exponent = (scale_bits >> 23) - 127 - 23 - 7
    shift = -(32 - 1 + exponent)
    assert 0 <= shift < 32
    return GemmlowpParams(multiplier=multiplier, shift=shift,
                          zero_point=int(zero_point), qmin=int(qmin), qmax=int(qmax))


@dataclasses.dataclass(frozen=True)
class ConvQuantParams:
    """Conv/GEMM quantization block (requantization.h:122-198).

    The requantization part is identical to Q31Params; the zero points ride
    along so kernels and packers share one record.
    """

    input_zero_point: int
    kernel_zero_point: int
    requant: Q31Params
    # The fp32 path needs the raw combined scale as well.
    scale: float


def compute_conv_quant_params(input_zero_point: int, kernel_zero_point: int,
                              scale: float, output_zero_point: int,
                              output_min: int = 0,
                              output_max: int = 255) -> ConvQuantParams:
    return ConvQuantParams(
        input_zero_point=int(input_zero_point),
        kernel_zero_point=int(kernel_zero_point),
        requant=compute_q31_params(scale, output_zero_point, output_min, output_max),
        scale=float(np.float32(scale)),
    )


@dataclasses.dataclass(frozen=True)
class AvgPoolQuantParams:
    """Average-pooling quantization block (requantization.h:268-303 scalar).

    `input_zero_point` is carried explicitly so padded-window kernels can
    fill halo taps with it (QNNPACK reaches the same value through its
    zero-buffer rows, src/average-pooling.c:166-178)."""

    bias: int
    multiplier: int  # in [0x00800000, 0x00FFFFFF]
    shift: int  # in [16, 56)
    output_zero_point: int
    output_min_less_zero_point: int
    output_max_less_zero_point: int
    input_zero_point: int = 0


def compute_avgpool_quant_params(bias: int, scale: float, output_zero_point: int,
                                 output_min: int = 0,
                                 output_max: int = 255,
                                 input_zero_point: int = 0) -> AvgPoolQuantParams:
    scale = float(np.float32(scale))
    if not (scale >= math.ldexp(1.0, -32) and scale < 256.0):
        raise ValueError(f"avgpool requantization requires 2^-32 <= scale < 256, got {scale}")
    scale_bits = fp32_to_bits(scale)
    multiplier = (scale_bits & 0x007FFFFF) | 0x00800000
    shift = 127 + 23 - (scale_bits >> 23)
    assert 16 <= shift < 64
    return AvgPoolQuantParams(
        bias=int(bias),
        multiplier=multiplier,
        shift=shift,
        output_zero_point=int(output_zero_point),
        output_min_less_zero_point=int(output_min) - int(output_zero_point),
        output_max_less_zero_point=int(output_max) - int(output_zero_point),
        input_zero_point=int(input_zero_point),
    )


@dataclasses.dataclass(frozen=True)
class AddQuantParams:
    """Elementwise-add quantization block (requantization.h:416-462 scalar)."""

    zero_point_product: int
    a_multiplier: int
    b_multiplier: int
    shift: int  # in [13, 31]
    remainder_mask: int
    remainder_threshold: int
    y_zero_point: int
    y_min: int
    y_max: int


def compute_add_quant_params(a_zero_point: int, b_zero_point: int,
                             output_zero_point: int, a_output_scale: float,
                             b_output_scale: float, output_min: int = 0,
                             output_max: int = 255) -> AddQuantParams:
    """Mirror of qnnp_compute_scalar_add_quantization_params (requantization.h:416)."""
    a_output_scale = float(np.float32(a_output_scale))
    b_output_scale = float(np.float32(b_output_scale))
    for s in (a_output_scale, b_output_scale):
        if not (s >= math.ldexp(1.0, -14) and s < 256.0):
            raise ValueError(f"add requantization requires 2^-14 <= scale < 2^8, got {s}")

    max_output_scale = max(a_output_scale, b_output_scale)
    max_scale_bits = fp32_to_bits(max_output_scale)
    max_scale_exponent = (max_scale_bits >> 23) - 127
    shift = 21 - max_scale_exponent
    assert 13 <= shift < 32

    # Scale each multiplier by 2^shift via exponent manipulation
    # (requantization.h:442-443).
    a_multiplier = _lrintf(fp32_from_bits(fp32_to_bits(a_output_scale) + (shift << 23)))
    b_multiplier = _lrintf(fp32_from_bits(fp32_to_bits(b_output_scale) + (shift << 23)))
    assert max(a_multiplier, b_multiplier) >= 0x00200000
    assert a_multiplier < 0x00400000 and b_multiplier < 0x00400000

    remainder_mask = (1 << shift) - 1
    zero_point_product = -(a_multiplier * int(a_zero_point) +
                           b_multiplier * int(b_zero_point))
    return AddQuantParams(
        zero_point_product=zero_point_product,
        a_multiplier=a_multiplier,
        b_multiplier=b_multiplier,
        shift=shift,
        remainder_mask=remainder_mask,
        remainder_threshold=remainder_mask >> 1,
        y_zero_point=int(output_zero_point),
        y_min=int(output_min),
        y_max=int(output_max),
    )


@dataclasses.dataclass(frozen=True)
class ClampParams:
    """u8 clamping params (requantization.h:305-325)."""

    output_min: int
    output_max: int


def compute_u8_clamping_params(output_min: int, output_max: int) -> ClampParams:
    if output_min > output_max:
        raise ValueError("clamp requires output_min <= output_max")
    return ClampParams(output_min=int(output_min), output_max=int(output_max))
