"""Quantized global average pooling.

QNNPACK's q8gavgpool contract; the reduction and its requantization run
in the kernel of kernels/pool.py on GPU tensors and in its plain version
on CPU tensors."""

from __future__ import annotations

from ..kernels.pool import q8gavgpool_cuda
from ..quant.params import AvgPoolQuantParams


def q8gavgpool(x_u8, params: AvgPoolQuantParams, axis=1):
    """Quantized global average pooling over `axis` (NWC width by default,
    matching qnnp_create_global_average_pooling_nwc_q8).

    params.bias must be -input_zero_point * reduced_size."""
    x = x_u8.movedim(axis, 1)
    rest = x.shape[2:]
    x3 = x.reshape(x.shape[0], x.shape[1], -1).contiguous()
    return q8gavgpool_cuda(x3, params).reshape(x.shape[0], *rest)
