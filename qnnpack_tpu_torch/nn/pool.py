"""Quantized pooling: max, average and global average.

QNNPACK's u8maxpool, q8avgpool and q8gavgpool contracts; each runs in its
kernel of kernels/pool.py on GPU tensors and in the kernel's plain version
on CPU tensors."""

from __future__ import annotations

from ..kernels.pool import q8avgpool_cuda, q8gavgpool_cuda, u8maxpool_cuda
from ..quant.params import AvgPoolQuantParams


def u8maxpool2d(x_u8, pool_size, strides=None, padding=((0, 0), (0, 0)),
                dilation=(1, 1)):
    """uint8 max pooling, NHWC (strides default to the pool size).

    Padding with 0, the uint8 minimum, is max-neutral whenever a window
    holds one real pixel, which the output-size formula guarantees; the
    clamp is the full range 0..255."""
    return u8maxpool_cuda(x_u8, pool_size, strides, padding,
                          dilation, 0, 255)


def q8avgpool2d(x_u8, params: AvgPoolQuantParams, pool_size, strides=None,
                padding=((0, 0), (0, 0))):
    """Quantized average pooling, NHWC -> uint8 (strides default to the
    pool size).

    params.bias must be -input_zero_point * pool_h * pool_w, so that padded
    taps (which read the input zero point, as the reference's zero buffer
    does) cancel exactly; the accumulator is then sum (x - izp) over the
    real pixels."""
    return q8avgpool_cuda(x_u8, params, pool_size, strides, padding)


def q8gavgpool(x_u8, params: AvgPoolQuantParams, axis=1):
    """Quantized global average pooling over `axis` (NWC width by default,
    matching qnnp_create_global_average_pooling_nwc_q8).

    params.bias must be -input_zero_point * reduced_size."""
    x = x_u8.movedim(axis, 1)
    rest = x.shape[2:]
    x3 = x.reshape(x.shape[0], x.shape[1], -1).contiguous()
    return q8gavgpool_cuda(x3, params).reshape(x.shape[0], *rest)
