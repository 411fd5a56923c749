"""q8stem: the stride-2 stem-conv kernel and its plain PyTorch version.

Port of qnnpack_tpu/kernels/q8stem.py:q8stem_pallas; the CUDA source, with
its design and what bounds it, is csrc/q8stem.cu.

The contract is the TPU kernel's: groups 1, stride 2 (fixed, so no stride
or dilation argument), kernel zero point 128, at most 4 input channels,
per-tensor or per-channel requantization.  Both versions raise on
anything else.  `q8stem_cuda` takes the plain version for CPU tensors
only.  For CUDA tensors it launches the kernel or raises; there is no
fallback.
"""

from __future__ import annotations

import torch

from . import _build
from .q8conv import check_conv, q8conv_plain

MAX_INPUT_CHANNELS = 4


def check_stem(a_u8, packed) -> None:
    """Raise unless (a_u8, packed) is inside the stem kernel's contract."""
    check_conv(a_u8, packed)
    if packed.groups != 1:
        raise ValueError(f"stem kernel requires groups == 1, got "
                         f"{packed.groups}")
    if packed.kzp_biased != 0:
        raise ValueError(f"stem kernel requires kernel_zero_point 128, got "
                         f"{packed.kernel_zero_point}")
    if packed.group_input_channels > MAX_INPUT_CHANNELS:
        raise ValueError(f"stem kernel takes at most {MAX_INPUT_CHANNELS} "
                         f"input channels, got "
                         f"{packed.group_input_channels}")


def q8stem_plain(a_u8, packed, rparams, padding=((0, 0), (0, 0))):
    """Plain version of the kernel: the dense conv at stride 2."""
    check_stem(a_u8, packed)
    return q8conv_plain(a_u8, packed, rparams, (2, 2), padding)


def stem_tile(out_channels: int) -> int:
    """Output channels of the kernel's block for a launch: 32 for O <= 32
    (O = 24 or 32 in one column block), else 64."""
    return 32 if out_channels <= 32 else 64


def q8stem_cuda(a_u8, packed, rparams, padding=((0, 0), (0, 0))):
    """Quantized stride-2 stem conv: uint8 NHWC -> uint8 NHWC."""
    check_stem(a_u8, packed)
    if a_u8.device.type == "cpu":
        return q8stem_plain(a_u8, packed, rparams, padding)
    _build.check_cuda("a", a_u8, torch.uint8, 4)
    _build.check_cuda("w_stem", packed.w_stem, torch.int8, 2)
    _build.check_cuda("bias_c", packed.bias_c, torch.int32, 1)
    if packed.w_stem.device != a_u8.device:
        raise ValueError(f"weights on {packed.w_stem.device}, activations "
                         f"on {a_u8.device}")
    b, h, w, c = a_u8.shape
    kh, kw = packed.kernel_height, packed.kernel_width
    o, k = packed.w_stem.shape
    row_pitch = k // kh
    if row_pitch * kh != k or row_pitch % 32 or row_pitch < kw * c:
        raise ValueError(f"w_stem shape {(o, k)} does not fit {kh}x{kw} "
                         f"taps of {c} channels")
    ho, wo = _build.out_dims(h, w, kh, kw, (2, 2), padding)
    scales, rq = _build.requant_args(rparams, o, a_u8.device)
    out = torch.empty((b, ho, wo, o), dtype=torch.uint8, device=a_u8.device)
    tile = stem_tile(o)
    _build.launch(
        "qnn_q8stem", a_u8.device.index or 0, a_u8.data_ptr(),
        packed.w_stem.data_ptr(), packed.bias_c.data_ptr(),
        None if scales is None else scales.data_ptr(), out.data_ptr(),
        b, h, w, c, ho, wo, o, kh, kw, padding[0][0], padding[1][0],
        packed.input_zero_point, row_pitch, tile, *rq,
        _build.stream_of(a_u8))
    q8stem_cuda.launches += 1
    q8stem_cuda.tile = tile
    return out


q8stem_cuda.launches = 0
q8stem_cuda.tile = None  # output channels of the last launch's block
