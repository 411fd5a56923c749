"""Elementwise uint8 operators: the LUT ops, softargmax and the channel
shuffle.

A port of qnnpack_tpu/nn/elementwise.py.  The LUT builders are the same
host numpy math, bit for bit.  `x8lut` is a PyTorch index into the table
and `x8zip` a PyTorch copy: neither has a Pallas form in the JAX package
(qnnpack_tpu/kernels/vpu_ops.py).  `u8softargmax` is two kernels, as the
reference's softargmax is two passes: u8rmax (the row max), then
u8lut32norm (lookup, sum and normalize, in wrapping uint32).

Not carried over: `_lut256`, `_lut_factored`, `_lut_t16` and
`build_softargmax_lut_factored`, which are TPU lowerings of the same
256-entry lookup (one-hot dots on the MXU); u8lut32norm reads the table
from shared memory.  The divide is the JAX package's idea on the card's
terms: neither machine has an integer divider, so u8lut32norm divides once
a row, for a reciprocal m = floor(2^32 / s), and each element takes a
multiply-high and one correction (csrc/u8lut32norm.cu says why that is
exact).  The add and the clamp are the q8vadd and u8clamp kernels
(kernels/vpu_ops.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.vpu_ops import u8lut32norm_cuda, u8rmax_cuda


def build_sigmoid_lut(input_zero_point: int, input_scale: float,
                      output_min: int = 0, output_max: int = 255) -> np.ndarray:
    """256-entry uint8 sigmoid table (sigmoid.c:95-110).

    Requires output scale 1/256 and output zero point 0 (enforced by the
    operator layer, sigmoid.c:67-79)."""
    i = np.arange(256, dtype=np.int32)
    x = np.float32(input_scale) * (i - int(input_zero_point)).astype(np.float32)
    scaled = np.float32(256.0) / (np.float32(1.0) + np.exp(-x, dtype=np.float32))
    scaled = np.clip(scaled, np.float32(output_min), np.float32(output_max))
    return np.rint(scaled).astype(np.uint8)


def build_leaky_relu_lut(input_zero_point: int, input_output_scale: float,
                         negative_slope: float, output_zero_point: int,
                         output_min: int = 0, output_max: int = 255) -> np.ndarray:
    """256-entry uint8 leaky-ReLU table (leaky-relu.c:104-117)."""
    i = np.arange(256, dtype=np.int32)
    x = np.float32(input_output_scale) * (i - int(input_zero_point)).astype(np.float32)
    y = np.where(x < 0, x * np.float32(negative_slope), x).astype(np.float32)
    lo = np.float32(int(output_min) - int(output_zero_point))
    hi = np.float32(int(output_max) - int(output_zero_point))
    y = np.clip(y, lo, hi)
    return (np.rint(y).astype(np.int64) + int(output_zero_point)).astype(np.uint8)


def build_softargmax_lut(input_scale: float, channels: int) -> np.ndarray:
    """256-entry uint32 exp table (softargmax.c:86-91, double math)."""
    qscale = min(float(np.iinfo(np.uint32).max) / float(channels), 8388607.0)
    i = np.arange(256, dtype=np.int64)
    scaled = qscale * np.exp((i - 255).astype(np.float64) * float(input_scale))
    return np.rint(scaled).astype(np.uint64).astype(np.uint32)


def lut32_tensor(lut, device=None) -> torch.Tensor:
    """A numpy uint32 table as the int32 [256] tensor of its bits on
    `device`, as u8lut32norm takes it; such a tensor is returned as it is
    (moved to `device`)."""
    if isinstance(lut, np.ndarray):
        lut = torch.from_numpy(np.ascontiguousarray(lut, np.uint32)
                               .view(np.int32))
    return lut.to(device=device if device is not None else lut.device,
                  dtype=torch.int32)


def x8lut(x_u8, lut):
    """Byte-wise table lookup (x8lut ukernel analogue, src/x8lut/scalar.c):
    a PyTorch index into the 256-entry uint8 table, moved to x's device."""
    if isinstance(lut, np.ndarray):
        lut = torch.from_numpy(np.ascontiguousarray(lut, np.uint8))
    return lut.to(device=x_u8.device, dtype=torch.uint8)[x_u8.to(torch.int64)]


def u8softargmax(x_u8, lut_u32):
    """Quantized softmax over the last axis (compute_u8softargmax,
    operator-run.c:625-637 + u8lut32norm/scalar.c).

    Per row: m = max(x); e[i] = t[x[i] + 255 - m]; s = sum e;
    y[i] = min((e[i] * 256 + s/2) / s, 255), in wrapping uint32.  Two
    kernels on the GPU: u8rmax, then u8lut32norm."""
    *lead, n = x_u8.shape
    rows = x_u8.reshape(-1, n).contiguous()
    lut = lut32_tensor(lut_u32, rows.device)
    return u8lut32norm_cuda(rows, u8rmax_cuda(rows), lut).reshape(*lead, n)


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
