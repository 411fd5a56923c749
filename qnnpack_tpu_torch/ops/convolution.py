"""Convolution operators: Convolution2D and Deconvolution2D - a port of
qnnpack_tpu/ops/convolution.py.

Lifecycle and validation parity with src/convolution.c: the same messages
and exception types as the JAX package.  The reference's create-time
ukernel-type dispatch (convolution.c:180-189) picks the kernel:
  - "gemm": a 1x1, stride-1, unpadded, undilated, ungrouped conv runs
    q8gemm on the NHWC input (nn/gemm.py:q8gemm);
  - "dwconv": one input and one output channel a group runs q8dwconv;
  - "conv": every other conv runs nn/conv.py:q8conv2d, which routes a
    dense conv to q8stem or q8conv (nn/conv.py:dense_conv_route) and a
    grouped one to q8conv.
Deconvolution2D (src/deconvolution.c) runs nn/conv.py:q8deconv2d on a
plan built at create (nn/conv.py:deconv_plan), so a run only launches.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..nn.conv import (deconv_lowering, deconv_output_dims, deconv_plan,
                       pack_conv_weights, q8conv2d, q8deconv2d)
from ..nn.gemm import q8gemm
from ..nn.packing import as_tensor, pack_gemm_weights
from ..nn.requant_dispatch import make_requant_params
from ..quant.params import compute_per_channel_fp32_params
from .base import (Operator, check, check_range, check_scale,
                   check_supported, check_zero_point)


def _validate_conv_args(kernel_size, strides, dilation, groups,
                        group_input_channels, group_output_channels,
                        input_scale, kernel_scale, output_scale, what):
    kh, kw = kernel_size
    check(kh > 0 and kw > 0,
          f"failed to create {what} with {kw}x{kh} kernel: "
          f"kernel dimensions must be non-zero")
    check(strides[0] > 0 and strides[1] > 0,
          f"failed to create {what} with {strides[1]}x{strides[0]} stride: "
          f"stride dimensions must be non-zero")
    check(dilation[0] > 0 and dilation[1] > 0,
          f"failed to create {what} with {dilation[1]}x{dilation[0]} dilation: "
          f"dilation dimensions must be non-zero")
    check(groups > 0, f"failed to create {what}: groups must be non-zero")
    check(group_input_channels > 0 and group_output_channels > 0,
          f"failed to create {what}: channels per group must be non-zero")
    check_scale(input_scale, "input")
    check_scale(kernel_scale, "kernel")
    check_scale(output_scale, "output")
    conv_scale = float(input_scale) * float(kernel_scale) / float(output_scale)
    check_supported(
        conv_scale < 1.0 and math.isfinite(conv_scale),
        f"failed to create {what} with {conv_scale:.7g} convolution scale: "
        f"convolution scale must be below 1.0 "
        f"(input_scale * kernel_scale / output_scale, convolution.c:161-168)")
    return conv_scale


class Convolution2D(Operator):
    """Quantized 2D convolution (qnnp_create_convolution2d_nhwc_q8,
    include/qnnpack.h:40-76; src/convolution.c:39-378).

    kernel: uint8 [O, Kh, Kw, Icpg], O = groups * group_output_channels.
    Input/output: uint8 NHWC.  requant: "q31" (the default), "fp32",
    "precise" or "gemmlowp"; per_channel_requant, one kernel scale per
    output channel, takes the per-channel fp32 scheme instead (and ignores
    kernel_scale); its scales go to the operator's device at create, with
    the packed weights.
    """

    name = "convolution2d"
    _tensors = ("packed", "rparams")

    def __init__(self, *, kernel, bias, input_zero_point, input_scale,
                 kernel_zero_point, kernel_scale, output_zero_point,
                 output_scale, padding=((0, 0), (0, 0)), strides=(1, 1),
                 dilation=(1, 1), groups=1, output_min=0, output_max=255,
                 requant="q31", per_channel_requant=None, device="cuda"):
        kernel = as_tensor(kernel, torch.uint8)
        o, kh, kw, icpg = kernel.shape
        check(o % groups == 0,
              f"failed to create convolution: {o} output channels do not "
              f"divide into {groups} groups")
        ocpg = o // groups
        conv_scale = _validate_conv_args(
            (kh, kw), strides, dilation, groups, icpg, ocpg,
            input_scale, kernel_scale, output_scale, "convolution")
        check_zero_point(input_zero_point, "input")
        check_zero_point(kernel_zero_point, "kernel")
        check_zero_point(output_zero_point, "output")
        check_range(output_min, output_max)
        if per_channel_requant is not None:
            # Per-output-channel kernel scales (TFLite per-channel / torch
            # per_channel_affine exports); each channel's conv scale must
            # pass the same < 1.0 gate.
            ch_scales = [float(input_scale) * float(s) / float(output_scale)
                         for s in per_channel_requant]
            check(len(ch_scales) == o,
                  f"per_channel_requant has {len(ch_scales)} scales for "
                  f"{o} output channels")
            for s in ch_scales:
                check_supported(
                    s < 1.0 and math.isfinite(s),
                    f"failed to create convolution with {s:.7g} per-channel "
                    f"convolution scale: scale must be below 1.0")
            rparams = compute_per_channel_fp32_params(
                ch_scales, output_zero_point, output_min, output_max)
        else:
            rparams = make_requant_params(requant, conv_scale,
                                          output_zero_point, output_min,
                                          output_max)
        super().__init__(device)
        self.padding = tuple((int(a), int(b)) for a, b in padding)
        self.strides = tuple(int(s) for s in strides)
        self.dilation = tuple(int(d) for d in dilation)
        self.groups = int(groups)
        self.kernel_size = (int(kh), int(kw))
        if per_channel_requant is not None:
            rparams = dataclasses.replace(rparams, device_scales=torch.tensor(
                rparams.scales, dtype=torch.float32, device=self.device))
        self.rparams = rparams
        # The ukernel type (convolution.c:180-189) picks the kernel.
        flat_pad = all(p == (0, 0) for p in self.padding)
        if ((kh, kw) == (1, 1) and self.strides == (1, 1) and flat_pad
                and self.dilation == (1, 1) and groups == 1):
            self.kernel_type = "gemm"
            self.packed = pack_gemm_weights(
                kernel.reshape(o, icpg), bias, input_zero_point,
                kernel_zero_point, device=self.device)
        else:
            self.kernel_type = ("dwconv" if groups > 1 and icpg == 1
                                and ocpg == 1 else "conv")
            self.packed = pack_conv_weights(
                kernel, bias, input_zero_point, kernel_zero_point, groups,
                device=self.device)

    def output_shape(self, input_shape):
        """(compute_output_dimension, convolution.c:29-37)."""
        b, h, w, c = input_shape
        kh, kw = self.kernel_size
        (pt, pb), (pl, pr) = self.padding
        eff_h = (kh - 1) * self.dilation[0] + 1
        eff_w = (kw - 1) * self.dilation[1] + 1
        ho = (h + pt + pb - eff_h) // self.strides[0] + 1
        wo = (w + pl + pr - eff_w) // self.strides[1] + 1
        o = self.packed.n if self.kernel_type == "gemm" else \
            self.packed.groups * self.packed.group_output_channels
        return (b, ho, wo, o)

    def _forward(self, x):
        if self.kernel_type == "gemm":
            return q8gemm(x, self.packed, self.rparams)
        return q8conv2d(x.contiguous(), self.packed, self.rparams,
                        self.strides, self.padding, self.dilation)


class Deconvolution2D(Operator):
    """Quantized transposed convolution (qnnp_create_deconvolution2d_nhwc_q8,
    include/qnnpack.h:78-116; src/deconvolution.c:38-210).

    kernel: uint8 [O, Kh, Kw, Icpg], O = groups * group_output_channels,
    packed flipped (transposed) on the operator's device with its
    DeconvPlan (nn/conv.py:deconv_lowering picks k == s, phase or dilated).
    A padding larger than the dilated lowering's effective kernel raises
    ValueError at the first run, as the JAX operator does."""

    name = "deconvolution2d"
    _tensors = ("packed",)

    def __init__(self, *, kernel, bias, input_zero_point, input_scale,
                 kernel_zero_point, kernel_scale, output_zero_point,
                 output_scale, padding=((0, 0), (0, 0)), adjustment=(0, 0),
                 strides=(1, 1), dilation=(1, 1), groups=1, output_min=0,
                 output_max=255, requant="q31", device="cuda"):
        kernel = as_tensor(kernel, torch.uint8)
        o, kh, kw, icpg = kernel.shape
        check(o % groups == 0,
              f"failed to create deconvolution: {o} output channels do not "
              f"divide into {groups} groups")
        conv_scale = _validate_conv_args(
            (kh, kw), strides, dilation, groups, icpg, o // groups,
            input_scale, kernel_scale, output_scale, "deconvolution")
        check_zero_point(output_zero_point, "output")
        check_range(output_min, output_max)
        super().__init__(device)
        self.padding = tuple((int(a), int(b)) for a, b in padding)
        self.adjustment = tuple(int(a) for a in adjustment)
        self.strides = tuple(int(s) for s in strides)
        self.dilation = tuple(int(d) for d in dilation)
        self.kernel_size = (int(kh), int(kw))
        self.rparams = make_requant_params(requant, conv_scale,
                                           output_zero_point, output_min,
                                           output_max)
        self.packed = pack_conv_weights(kernel, bias, input_zero_point,
                                        kernel_zero_point, groups,
                                        transposed=True, device=self.device)
        self.lowering = deconv_lowering(self.packed, self.strides,
                                        self.padding, self.adjustment,
                                        self.dilation)
        if self.lowering != "unsupported":
            deconv_plan(self.packed, self.rparams, self.strides,
                        self.padding, self.adjustment, self.dilation)

    def output_shape(self, input_shape):
        b, h, w, c = input_shape
        kh, kw = self.kernel_size
        (pt, pb), (pl, pr) = self.padding
        ho = deconv_output_dims(h, pt + pb, self.adjustment[0], kh,
                                self.dilation[0], self.strides[0])
        wo = deconv_output_dims(w, pl + pr, self.adjustment[1], kw,
                                self.dilation[1], self.strides[1])
        o = self.packed.groups * self.packed.group_output_channels
        return (b, ho, wo, o)

    def _forward(self, x):
        return q8deconv2d(x.contiguous(), self.packed, self.rparams,
                          self.strides, self.padding, self.adjustment,
                          self.dilation)
