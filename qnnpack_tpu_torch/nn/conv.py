"""Quantized convolution: dense, grouped and depthwise.

Zero-point algebra as in qnnpack_tpu/nn/conv.py: the input is padded with
the input zero point, so a padded tap adds exactly zero to
sum (a - za)(w - zw), like QNNPACK's zero buffer (src/convolution.c:330-339).

  - Depthwise (groups == channels, one channel per group) runs the q8dwconv
    kernel, which reads the window straight from NHWC.
  - Grouped (groups > 1, more than one channel per group) runs the q8conv
    kernel, one implicit GEMM per group.  The JAX package's split, einsum
    and feature_group_count lowerings are TPU forms of the same sums and
    are not carried over.
  - Dense (groups == 1) routes by `dense_conv_route`: the stem class
    (stride 2, C_in <= 4, kzp 128) to the q8stem kernel, every other dense
    conv to the q8conv kernel.  The plain version of both kernels is the
    zero-point-padded `im2col` (K ordered [kh, kw, cin] as the pack lays W
    out) times the packed weights viewed as [K, N], group by group.

Kernel layout: O x Kh x Kw x Icpg (uint8), QNNPACK's NHWC operator
convention.  Deconv and the TPU's phase layouts are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..kernels.q8conv import q8conv_cuda
from ..kernels.q8dwconv import q8dwconv_cuda
from ..kernels.q8stem import MAX_INPUT_CHANNELS, q8stem_cuda
from .dtypes import biased_zero_point, u8_to_biased_i8
from .packing import (PackedGemmWeights, as_tensor, fold_bias, round_up,
                      set_kernel_fields)

# The q8stem kernel's K order pads each kernel row to a multiple of this
# many bytes (two rows of a 3- or 7-wide RGB window fill one 64-byte step).
STEM_ROW_STEP = 32


@dataclasses.dataclass(frozen=True)
class PackedConvWeights:
    """Conv weights in HWIO int8 layout with folded bias.

    w:           int8 [Kh, Kw, Icpg, O] biased (value - 128), contiguous
    bias_folded: int32 [O]
    w_kmajor:    int8 [O, Kh*Kw, Icpg_p] w regrouped K-major, each tap's
                 channel run zero-padded to Icpg_p = Icpg rounded up to the
                 kernels' 64-byte K step (derived; nn/packing.py)
    bias_c:      int32 [O] kmajor_bias of bias_folded, K = Kh*Kw*Icpg
                 (derived)
    w_dw:        float32 [Kh*Kw, C] W' - kzp', the q8dwconv kernel's
                 weights, on a record with one channel per group (a
                 one-channel record of groups 1 too); None otherwise
                 (derived)
    w_stem:      int8 [O, Kh*Rs] of a record that can be a stem (groups 1,
                 Icpg <= 4): kernel row ky's Kw*Icpg bytes in [kx, c] order
                 at ky*Rs, zero up to Rs = Kw*Icpg rounded up to
                 STEM_ROW_STEP, the q8stem kernel's K order; None otherwise
                 (derived)
    """

    w: torch.Tensor
    bias_folded: torch.Tensor
    kernel_height: int
    kernel_width: int
    group_input_channels: int
    group_output_channels: int
    groups: int
    input_zero_point: int
    kernel_zero_point: int
    w_kmajor: torch.Tensor = dataclasses.field(init=False, repr=False,
                                               compare=False)
    bias_c: torch.Tensor = dataclasses.field(init=False, repr=False,
                                             compare=False)
    w_dw: torch.Tensor | None = dataclasses.field(init=False, repr=False,
                                                  compare=False)
    w_stem: torch.Tensor | None = dataclasses.field(init=False, repr=False,
                                                    compare=False)

    def __post_init__(self):
        kh, kw, icpg, o = self.w.shape
        wk = torch.zeros((o, kh * kw, round_up(icpg)), dtype=torch.int8,
                         device=self.w.device)
        wk[..., :icpg] = self.w.permute(3, 0, 1, 2).reshape(o, kh * kw, icpg)
        set_kernel_fields(self, wk,
                          self.w.to(torch.int64).sum(dim=(0, 1, 2)),
                          kh * kw * icpg)
        w_dw = w_stem = None
        if icpg == 1 and self.group_output_channels == 1:
            w_dw = (self.w.reshape(kh * kw, o).to(torch.float32)
                    - self.kzp_biased)
        if self.groups == 1 and icpg <= MAX_INPUT_CHANNELS:
            rs = round_up(kw * icpg, STEM_ROW_STEP)
            w_stem = torch.zeros((o, kh, rs), dtype=torch.int8,
                                 device=self.w.device)
            w_stem[..., :kw * icpg] = self.w.permute(3, 0, 1, 2).reshape(
                o, kh, kw * icpg)
            w_stem = w_stem.reshape(o, kh * rs)
        object.__setattr__(self, "w_dw", w_dw)
        object.__setattr__(self, "w_stem", w_stem)

    @property
    def izp_biased(self) -> int:
        return biased_zero_point(self.input_zero_point)

    @property
    def kzp_biased(self) -> int:
        return biased_zero_point(self.kernel_zero_point)

    def as_gemm(self) -> PackedGemmWeights:
        """The dense (groups = 1) weights as GEMM weights [Kh*Kw*Icpg, O]."""
        k = self.kernel_height * self.kernel_width * self.group_input_channels
        return PackedGemmWeights(
            w=self.w.reshape(k, -1), bias_folded=self.bias_folded, k=k,
            n=self.w.shape[-1], input_zero_point=self.input_zero_point,
            kernel_zero_point=self.kernel_zero_point)


def pack_conv_weights(kernel, bias, input_zero_point: int,
                      kernel_zero_point: int, groups: int = 1, *,
                      device=None) -> PackedConvWeights:
    """Pack conv weights (pack_q8conv_w analogue, pack.h:51-133).

    kernel: uint8 [O, Kh, Kw, Icpg] with O = groups * group_output_channels.
    """
    kernel = as_tensor(kernel, torch.uint8, device)
    o, kh, kw, icpg = kernel.shape
    if o % groups:
        raise ValueError("output channels must divide evenly into groups")
    if bias is None:
        bias = torch.zeros((o,), dtype=torch.int32, device=kernel.device)
    bias = as_tensor(bias, torch.int32, kernel.device)

    w = u8_to_biased_i8(kernel)  # [O, Kh, Kw, Icpg]
    w_sums = w.to(torch.int64).sum(dim=(1, 2, 3))  # [O]
    bias_folded = fold_bias(bias, w_sums, kh * kw * icpg, input_zero_point,
                            kernel_zero_point)
    return PackedConvWeights(
        w=w.permute(1, 2, 3, 0).contiguous(), bias_folded=bias_folded,
        kernel_height=int(kh), kernel_width=int(kw),
        group_input_channels=int(icpg), group_output_channels=int(o // groups),
        groups=int(groups), input_zero_point=int(input_zero_point),
        kernel_zero_point=int(kernel_zero_point))


def _pad_input(a_u8, padding, value: int):
    """Pad uint8 NHWC spatially with a constant (the input zero point)."""
    (pt, pb), (pl_, pr) = padding
    if pt == pb == pl_ == pr == 0:
        return a_u8
    return F.pad(a_u8, (0, 0, pl_, pr, pt, pb), value=value)


def im2col(a_u8, packed: PackedConvWeights, strides=(1, 1),
           padding=((0, 0), (0, 0)), dilation=(1, 1)):
    """Zero-point-padded patches [B*Ho*Wo, Kh*Kw*C], K ordered [kh, kw, c]."""
    a = _pad_input(a_u8, padding, packed.input_zero_point)
    b, hp, wp, c = a.shape
    kh, kw = packed.kernel_height, packed.kernel_width
    (sh, sw), (dh, dw) = strides, dilation
    ho = (hp - ((kh - 1) * dh + 1)) // sh + 1
    wo = (wp - ((kw - 1) * dw + 1)) // sw + 1
    taps = [a[:, ky * dh:ky * dh + (ho - 1) * sh + 1:sh,
              kx * dw:kx * dw + (wo - 1) * sw + 1:sw, :]
            for ky in range(kh) for kx in range(kw)]
    return torch.stack(taps, dim=3).reshape(b * ho * wo, kh * kw * c), \
        (b, ho, wo)


def dense_conv_route(packed: PackedConvWeights, strides,
                     dilation=(1, 1)) -> str:
    """Kernel of a dense (groups = 1) conv: "q8stem" or "q8conv".

    The JAX package's stem rule (qnnpack_tpu/nn/conv.py:
    _route_stem_pallas) without its backend and tuning gates: stride
    (2, 2), no dilation, a window of more than one tap, kzp == 128 and at
    most 4 input channels go to the stem kernel."""
    if (packed.groups == 1 and tuple(strides) == (2, 2)
            and tuple(dilation) == (1, 1)
            and packed.kernel_height * packed.kernel_width > 1
            and packed.kzp_biased == 0
            and packed.group_input_channels <= MAX_INPUT_CHANNELS):
        return "q8stem"
    return "q8conv"


def q8conv2d(a_u8, packed: PackedConvWeights, rparams, strides=(1, 1),
             padding=((0, 0), (0, 0)), dilation=(1, 1)):
    """Quantized 2D convolution: uint8 NHWC -> uint8 NHWC.

    Depthwise convs run q8dwconv, grouped ones q8conv, dense ones the
    kernel `dense_conv_route` names."""
    strides, dilation = tuple(strides), tuple(dilation)
    if (packed.groups > 1 and packed.group_input_channels == 1
            and packed.group_output_channels == 1):
        return q8dwconv_cuda(a_u8, packed, rparams, strides, padding,
                             dilation)
    if dense_conv_route(packed, strides, dilation) == "q8stem":
        return q8stem_cuda(a_u8, packed, rparams, padding)
    return q8conv_cuda(a_u8, packed, rparams, strides, padding, dilation)
