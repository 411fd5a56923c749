"""Elementwise uint8 operators: the channel shuffle.

A port of qnnpack_tpu/nn/elementwise.py:x8zip.  It has no Pallas form in
the JAX package (qnnpack_tpu/kernels/__init__.py), so its port is a PyTorch
copy, as concatenation is.  Still to port from that module: the LUT
builders, x8lut and u8softargmax (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations


def x8zip(x_u8, groups: int):
    """Channel shuffle (QNNPACK's x8zip x2/x3/x4/xm, src/x8zip/).

    [..., groups * k] with group-major layout -> interleaved: output
    channel g + i * groups takes input channel g * k + i (channel-shuffle
    operator semantics, src/channel-shuffle.c).  Returns a contiguous
    tensor."""
    *lead, c = x_u8.shape
    if c % groups:
        raise ValueError(f"{c} channels do not divide into {groups} groups")
    k = c // groups
    return x_u8.reshape(*lead, groups, k).transpose(-1, -2).reshape(
        *lead, c).contiguous()
