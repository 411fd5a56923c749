"""Elementwise operators: Add, Clamp, Sigmoid, LeakyReLU, SoftArgMax,
ChannelShuffle - a port of qnnpack_tpu/ops/elementwise.py.

Lifecycle and validation parity with src/add.c, src/clamp.c, src/sigmoid.c,
src/leaky-relu.c, src/softargmax.c and src/channel-shuffle.c: the same
messages and exception types as the JAX package.  All operate on [batch,
channels] (nc layout) like the reference, but take any leading shape with
channels last.  On the GPU: Add runs the q8vadd kernel, Clamp u8clamp,
SoftArgMax u8rmax and u8lut32norm; Sigmoid and LeakyReLU are x8lut and
ChannelShuffle x8zip (PyTorch index and copy: no Pallas form).
"""

from __future__ import annotations

import math

import torch

from ..kernels.vpu_ops import q8vadd_cuda, u8clamp_cuda
from ..nn.elementwise import (build_leaky_relu_lut, build_sigmoid_lut,
                              build_softargmax_lut, lut32_tensor,
                              u8softargmax, x8lut, x8zip)
from ..nn.packing import as_tensor
from ..quant.params import (compute_add_quant_params,
                            compute_u8_clamping_params)
from .base import (Operator, check, check_range, check_scale,
                   check_supported, check_zero_point)


class Add(Operator):
    """qnnp_create_add_nc_q8 (include/qnnpack.h:234-255; src/add.c:22-118)."""

    name = "add"

    def __init__(self, *, a_zero_point, a_scale, b_zero_point, b_scale,
                 sum_zero_point, sum_scale, output_min=0, output_max=255,
                 device="cuda"):
        check_scale(a_scale, "A")
        check_scale(b_scale, "B")
        check_scale(sum_scale, "output")
        check_zero_point(a_zero_point, "A")
        check_zero_point(b_zero_point, "B")
        check_zero_point(sum_zero_point, "output")
        check_range(output_min, output_max)
        a_output_scale = float(a_scale) / float(sum_scale)
        b_output_scale = float(b_scale) / float(sum_scale)
        for name, ratio in (("A", a_output_scale), ("B", b_output_scale)):
            check_supported(
                2.0**-14 <= ratio < 2.0**8,
                f"failed to create add operator with {ratio:.7g} {name}"
                f"-to-output scale ratio: scale ratio must be in "
                f"[2**-14, 2**8) range (add.c:57-71)")
        super().__init__(device)
        self.qparams = compute_add_quant_params(
            a_zero_point, b_zero_point, sum_zero_point, a_output_scale,
            b_output_scale, output_min, output_max)

    def _forward(self, a, b):
        return q8vadd_cuda(a.contiguous(), b.contiguous(), self.qparams)


class Clamp(Operator):
    """qnnp_create_clamp_nc_u8 (include/qnnpack.h:257-270; src/clamp.c:20-70)."""

    name = "clamp"

    def __init__(self, *, output_min=0, output_max=255, device="cuda"):
        check_range(output_min, output_max)
        super().__init__(device)
        self.qparams = compute_u8_clamping_params(output_min, output_max)

    def _forward(self, x):
        return u8clamp_cuda(x.contiguous(), self.qparams)


class _LutOperator(Operator):
    """Shared run path for 256-entry LUT operators (x8lut ukernel type)."""

    _tensors = ("lut",)

    def __init__(self, lut, device):
        super().__init__(device)
        self.lut = as_tensor(lut, torch.uint8, self.device)

    def _forward(self, x):
        return x8lut(x, self.lut)


class Sigmoid(_LutOperator):
    """qnnp_create_sigmoid_nc_q8 (include/qnnpack.h:272-289;
    src/sigmoid.c:20-123).  Output scale must be 1/256, zero point 0."""

    name = "sigmoid"

    def __init__(self, *, input_zero_point, input_scale, output_zero_point=0,
                 output_scale=1.0 / 256.0, output_min=0, output_max=255,
                 device="cuda"):
        check_scale(input_scale, "input")
        check_zero_point(input_zero_point, "input")
        check_range(output_min, output_max)
        check_supported(float(output_scale) == (1.0 / 256.0),
                        f"failed to create Sigmoid operator with "
                        f"{output_scale:.7g} output scale: only output scale "
                        f"of 1/256 is supported (sigmoid.c:68-73)")
        check_supported(output_zero_point == 0,
                        f"failed to create Sigmoid operator with "
                        f"{output_zero_point} output zero point: only output "
                        f"zero point of 0 is supported (sigmoid.c:75-80)")
        super().__init__(build_sigmoid_lut(input_zero_point, input_scale,
                                           output_min, output_max), device)


class LeakyReLU(_LutOperator):
    """qnnp_create_leaky_relu_nc_q8 (include/qnnpack.h:291-309;
    src/leaky-relu.c:20-130)."""

    name = "leaky_relu"

    def __init__(self, *, negative_slope, input_zero_point, input_scale,
                 output_zero_point, output_scale, output_min=0,
                 output_max=255, device="cuda"):
        check(negative_slope > 0.0 and math.isfinite(negative_slope),
              f"failed to create Leaky ReLU operator with {negative_slope:.7g} "
              f"negative slope: slope must be finite and positive")
        check_supported(negative_slope <= 1.0,
                        f"failed to create Leaky ReLU operator with "
                        f"{negative_slope:.7g} negative slope: slope must not "
                        f"exceed 1.0 (leaky-relu.c:35-40)")
        check_scale(input_scale, "input")
        check_scale(output_scale, "output")
        check_zero_point(input_zero_point, "input")
        check_zero_point(output_zero_point, "output")
        check_range(output_min, output_max)
        ratio = float(input_scale) / float(output_scale)
        check_supported(2.0**-8 <= ratio < 2.0**8,
                        f"failed to create Leaky ReLU operator with {ratio:.7g} "
                        f"input-to-output scale ratio: ratio must be in "
                        f"[2**-8, 2**8) range (leaky-relu.c:63-69)")
        super().__init__(build_leaky_relu_lut(
            input_zero_point, ratio, negative_slope, output_zero_point,
            output_min, output_max), device)


class SoftArgMax(Operator):
    """qnnp_create_softargmax_nc_q8 (include/qnnpack.h:311-325;
    src/softargmax.c:20-104).  Output scale must be 1/256, zero point 0."""

    name = "softargmax"
    _tensors = ("lut",)

    def __init__(self, *, channels, input_scale, output_zero_point=0,
                 output_scale=1.0 / 256.0, device="cuda"):
        check(channels > 0, "number of channels must be non-zero")
        check_scale(input_scale, "input")
        check_supported(float(output_scale) == (1.0 / 256.0),
                        f"failed to create Soft ArgMax operator with "
                        f"{output_scale:.7g} output scale: only output scale "
                        f"of 1/256 is supported (softargmax.c:56-63)")
        check_supported(output_zero_point == 0,
                        f"failed to create Soft ArgMax operator with "
                        f"{output_zero_point} output zero point: only output "
                        f"zero point of 0 is supported (softargmax.c:65-70)")
        super().__init__(device)
        self.channels = int(channels)
        # int32 [256] holding the uint32 table's bits, as u8lut32norm takes.
        self.lut = lut32_tensor(build_softargmax_lut(input_scale, channels),
                                self.device)

    def _forward(self, x):
        return u8softargmax(x, self.lut)


class ChannelShuffle(Operator):
    """qnnp_create_channel_shuffle_nc_x8 (include/qnnpack.h:220-232;
    src/channel-shuffle.c:21-96)."""

    name = "channel_shuffle"

    def __init__(self, *, groups, group_channels, device="cuda"):
        check(groups >= 2,
              f"failed to create channel shuffle operator with {groups} "
              f"groups: at least two groups required (channel-shuffle.c:33-38)")
        check(group_channels > 0, "group channels must be non-zero")
        super().__init__(device)
        self.groups = int(groups)
        self.group_channels = int(group_channels)

    def _forward(self, x):
        return x8zip(x, self.groups)
