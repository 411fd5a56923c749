"""Biased-int8 representation of asymmetric uint8.

Every uint8 tensor is re-biased by XOR 0x80 (value - 128) at the boundary
and the shifted zero points are carried through the same algebra:

    (a - za)(w - zw) == (a' - za')(w' - zw')
    where x' = x - 128 (int8) and z' = z - 128.

Integer arithmetic is exact, so accumulators - and therefore requantized
outputs - are identical to QNNPACK's.  Same encoding as
qnnpack_tpu/nn/dtypes.py.  The q8bmm kernel rebiases as it loads; the
q8gemm and q8conv kernels read raw uint8 activations and the packed
weights carry the difference (nn/packing.py `kmajor_bias`).
"""

from __future__ import annotations

import torch


def u8_to_biased_i8(x: torch.Tensor) -> torch.Tensor:
    """uint8 -> int8 with value shifted by -128 (one XOR and a view)."""
    return (x ^ 0x80).view(torch.int8)


def biased_zero_point(zero_point: int) -> int:
    """Shift a uint8 zero point into the biased-int8 domain."""
    return int(zero_point) - 128
