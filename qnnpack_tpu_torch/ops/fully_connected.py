"""Fully-connected operator (qnnp_create_fully_connected_nc_q8,
include/qnnpack.h:118-140; src/fully-connected.c:25-160) - a port of
qnnpack_tpu/ops/fully_connected.py.

Like the reference, FC reuses the GEMM path directly (fully-connected.c
packs with pack_q8gemm_w and tags ukernel_type_gemm); input is
[batch, input_channels] uint8 (any leading shape, channels last)."""

from __future__ import annotations

import math

import torch

from ..nn.gemm import q8gemm
from ..nn.packing import as_tensor, pack_gemm_weights
from ..nn.requant_dispatch import make_requant_params
from .base import (Operator, check, check_range, check_scale,
                   check_supported, check_zero_point)


class FullyConnected(Operator):
    """kernel: uint8 [output_channels, input_channels]; requant: "q31" (the
    default), "fp32", "precise" or "gemmlowp".

    `use_pallas` is kept so that callers of the JAX operator keep working;
    it selects nothing here: every value (None, True, False) runs the one
    q8gemm kernel on the GPU, and its plain version only on CPU tensors."""

    name = "fully_connected"
    _tensors = ("packed",)

    def __init__(self, *, kernel, bias, input_zero_point, input_scale,
                 kernel_zero_point, kernel_scale, output_zero_point,
                 output_scale, output_min=0, output_max=255, requant="q31",
                 use_pallas=None, device="cuda"):
        kernel = as_tensor(kernel, torch.uint8)
        check(kernel.dim() == 2,
              "fully connected kernel must be [output_channels, input_channels]")
        check_scale(input_scale, "input")
        check_scale(kernel_scale, "kernel")
        check_scale(output_scale, "output")
        fc_scale = float(input_scale) * float(kernel_scale) / float(output_scale)
        check_supported(fc_scale < 1.0 and math.isfinite(fc_scale),
                        f"failed to create fully connected operator with "
                        f"{fc_scale:.7g} requantization scale: scale must be "
                        f"below 1.0 (fully-connected.c:85-92)")
        check_zero_point(input_zero_point, "input")
        check_zero_point(kernel_zero_point, "kernel")
        check_zero_point(output_zero_point, "output")
        check_range(output_min, output_max)
        rparams = make_requant_params(requant, fc_scale, output_zero_point,
                                      output_min, output_max)
        super().__init__(device)
        self.input_channels = int(kernel.shape[1])
        self.output_channels = int(kernel.shape[0])
        self.rparams = rparams
        self.packed = pack_gemm_weights(kernel, bias, input_zero_point,
                                        kernel_zero_point, device=self.device)
        self.use_pallas = use_pallas

    def _forward(self, x):
        return q8gemm(x, self.packed, self.rparams)
