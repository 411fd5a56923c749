"""Requantization scheme selection shared by all operators.

  - "q31"      bit-exact to QNNPACK's kernels
  - "fp32"     float multiply, lrintf numerics (fp32-scalar.c)
  - "precise"  exact round-half-away-from-zero
  - "gemmlowp" upstream gemmlowp semantics
"""

from __future__ import annotations

from ..quant import params as qparams
from ..quant import requantize as rq

SCHEMES = ("q31", "fp32", "precise", "gemmlowp")


def make_requant_params(scheme: str, scale: float, zero_point: int,
                        qmin: int = 0, qmax: int = 255):
    if scheme == "q31":
        return qparams.compute_q31_params(scale, zero_point, qmin, qmax)
    if scheme == "fp32":
        return qparams.compute_fp32_params(scale, zero_point, qmin, qmax)
    if scheme == "precise":
        return qparams.compute_precise_params(scale, zero_point, qmin, qmax)
    if scheme == "gemmlowp":
        return qparams.compute_gemmlowp_params(scale, zero_point, qmin, qmax)
    raise ValueError(f"unknown requantization scheme {scheme!r}; "
                     f"expected one of {SCHEMES}")


def apply_requant(acc, rparams):
    """Dispatch on the params dataclass type."""
    if isinstance(rparams, qparams.Q31Params):
        return rq.requantize_q31(acc, rparams)
    if isinstance(rparams, qparams.FP32Params):
        return rq.requantize_fp32(acc, rparams)
    if isinstance(rparams, qparams.PreciseParams):
        return rq.requantize_precise(acc, rparams)
    if isinstance(rparams, qparams.GemmlowpParams):
        return rq.requantize_gemmlowp(acc, rparams)
    if isinstance(rparams, qparams.PerChannelFP32Params):
        return rq.requantize_fp32_per_channel(acc, rparams)
    raise TypeError(f"not a requantization params type: {type(rparams)}")
