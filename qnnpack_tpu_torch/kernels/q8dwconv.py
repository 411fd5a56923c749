"""q8dwconv: the depthwise-conv kernel and its plain PyTorch version.

Port of qnnpack_tpu/kernels/q8dwconv.py:q8dwconv_pallas; the CUDA source,
with its design and what bounds it, is csrc/q8dwconv.cu.

`q8dwconv_cuda` takes the plain version for CPU tensors only.  For CUDA
tensors it launches the kernel or raises; there is no fallback.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..nn.requant_dispatch import apply_requant
from . import _build


def _check_depthwise(a_u8, packed):
    if packed.group_input_channels != 1 or packed.group_output_channels != 1:
        raise ValueError("depthwise conv requires one channel per group")
    if a_u8.dim() != 4 or a_u8.shape[3] != packed.groups:
        raise ValueError(f"input {tuple(a_u8.shape)} does not match "
                         f"{packed.groups} channels")


def q8dwconv_acc_plain(a_u8, packed, strides=(1, 1),
                       padding=((0, 0), (0, 0)), dilation=(1, 1)):
    """The plain version's int32 accumulator [B, Ho, Wo, C], as an int64
    tensor holding the wrapped value: bias' + sum_taps A'(tap) * (W'(tap) -
    kzp'), the input padded with the input zero point."""
    _check_depthwise(a_u8, packed)
    b, h, w, c = a_u8.shape
    kh, kw = packed.kernel_height, packed.kernel_width
    ho, wo = _build.out_dims(h, w, kh, kw, strides, padding, dilation)
    (pt, pb), (pl_, pr) = padding
    a = F.pad(a_u8, (0, 0, pl_, pr, pt, pb),
              value=packed.input_zero_point).to(torch.int64) - 128
    wd = packed.w.reshape(kh * kw, c).to(torch.int64) - packed.kzp_biased
    acc = packed.bias_folded.to(torch.int64).expand(b, ho, wo, c)
    sh, sw = strides
    dh, dw = dilation
    for ky in range(kh):
        for kx in range(kw):
            y0, x0 = ky * dh, kx * dw
            tap = a[:, y0:y0 + (ho - 1) * sh + 1:sh,
                    x0:x0 + (wo - 1) * sw + 1:sw, :]
            acc = acc + tap * wd[ky * kw + kx]
    return ((acc + 2**31) & 0xFFFFFFFF) - 2**31


def q8dwconv_plain(a_u8, packed, rparams, strides=(1, 1),
                   padding=((0, 0), (0, 0)), dilation=(1, 1)):
    """Plain version of the kernel: uint8 NHWC -> uint8 NHWC."""
    return apply_requant(q8dwconv_acc_plain(a_u8, packed, strides, padding,
                                            dilation), rparams)


# The window codes of csrc/q8dwconv.cu's entry.
WINDOWS = {"any": 0, "3x3s1": 1, "3x3s2": 2}


def dw_instance(c, kh, kw, strides, dilation, aligned=True):
    """The kernel instance of a launch: (channels a thread, window).
    Channels 4 where C % 4 == 0 and the pointers are aligned (the input and
    output to words, the record's tables to 16 bytes), else 1; window
    "3x3s1" or "3x3s2" (3 x 3, dilation 1, equal strides of 1 or 2) or
    "any"."""
    v = 4 if c % 4 == 0 and aligned else 1
    fast = ((kh, kw) == (3, 3) and tuple(dilation) == (1, 1)
            and strides[0] == strides[1] and strides[0] in (1, 2))
    return v, f"3x3s{strides[0]}" if fast else "any"


def q8dwconv_cuda(a_u8, packed, rparams, strides=(1, 1),
                  padding=((0, 0), (0, 0)), dilation=(1, 1)):
    """Quantized depthwise conv: uint8 NHWC -> uint8 NHWC.

    `packed` is an nn.conv.PackedConvWeights with groups == channels."""
    _check_depthwise(a_u8, packed)
    if a_u8.device.type == "cpu":
        return q8dwconv_plain(a_u8, packed, rparams, strides, padding,
                              dilation)
    _build.check_cuda("a", a_u8, torch.uint8, 4)
    _build.check_cuda("w", packed.w, torch.int8, 4)
    _build.check_cuda("w_dw", packed.w_dw, torch.float32, 2)
    _build.check_cuda("bias_c", packed.bias_c, torch.int32, 1)
    if packed.w.device != a_u8.device:
        raise ValueError(f"weights on {packed.w.device}, activations on "
                         f"{a_u8.device}")
    b, h, w, c = a_u8.shape
    kh, kw = packed.kernel_height, packed.kernel_width
    ho, wo = _build.out_dims(h, w, kh, kw, strides, padding, dilation)
    scales, rq = _build.requant_args(rparams, c, a_u8.device)
    out = torch.empty((b, ho, wo, c), dtype=torch.uint8, device=a_u8.device)
    aligned = (a_u8.data_ptr() % 4 == 0 and out.data_ptr() % 4 == 0
               and packed.w_dw.data_ptr() % 16 == 0
               and packed.bias_c.data_ptr() % 16 == 0
               and (scales is None or scales.data_ptr() % 16 == 0))
    vec, window = dw_instance(c, kh, kw, strides, dilation, aligned)
    _build.launch(
        "qnn_q8dwconv", a_u8.device.index or 0, a_u8.data_ptr(),
        packed.w.data_ptr(), packed.w_dw.data_ptr(), packed.bias_c.data_ptr(),
        None if scales is None else scales.data_ptr(), out.data_ptr(),
        b, h, w, c, ho, wo, kh, kw, strides[0], strides[1], padding[0][0],
        padding[1][0], dilation[0], dilation[1], packed.input_zero_point,
        packed.kzp_biased, vec, WINDOWS[window], *rq, _build.stream_of(a_u8))
    q8dwconv_cuda.launches += 1
    q8dwconv_cuda.instance = (vec, window)
    return out


q8dwconv_cuda.launches = 0
q8dwconv_cuda.instance = None  # (channels a thread, window) of the last launch
