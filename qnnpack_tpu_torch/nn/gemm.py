"""Quantized GEMM: the compute core of FC / 1x1-conv / conv-as-GEMM.

QNNPACK's q8gemm contract (src/q8gemm/): uint8 activations x packed
weights -> int32 accumulator with zero-point algebra -> fused
requantization -> uint8.  `q8gemm` runs the CUDA kernel of
kernels/q8gemm.py on GPU tensors and its plain version on CPU tensors.
"""

from __future__ import annotations

from ..kernels.q8gemm import gemm_acc_plain, q8gemm_cuda
from .packing import PackedGemmWeights


def q8gemm_acc(a_u8, packed: PackedGemmWeights):
    """int32 accumulator of the quantized GEMM: [..., K] x [K, N] -> [..., N]
    (as an int64 tensor holding the wrapped int32 value).

    Identical to QNNPACK's accumulator sum_k (a - za)(w - zw) + bias."""
    return gemm_acc_plain(a_u8, packed.w, packed.bias_folded,
                          packed.kzp_biased)


def q8gemm(a_u8, packed: PackedGemmWeights, rparams):
    """Full quantized GEMM: uint8 [..., K] -> uint8 [..., N].

    The leading axes are viewed as one M axis (free for a contiguous
    tensor), so a 1x1 conv stays NHWC."""
    lead = a_u8.shape[:-1]
    y = q8gemm_cuda(a_u8.reshape(-1, a_u8.shape[-1]).contiguous(), packed,
                    rparams)
    return y.reshape(*lead, packed.n)
