"""q8vadd: the quantized elementwise-add kernel and its plain version.

Port of qnnpack_tpu/kernels/vpu_ops.py:q8vadd_pallas; the CUDA source,
with its design and what bounds it, is csrc/q8vadd.cu.

`q8vadd_cuda` takes the plain version for CPU tensors only.  For CUDA
tensors it launches the kernel or raises; there is no fallback.
"""

from __future__ import annotations

import torch

from ..quant.params import AddQuantParams
from ..quant.requantize import add_quantize
from . import _build


def q8vadd_plain(a_u8, b_u8, params: AddQuantParams):
    """Plain version of the kernel: quant.requantize.add_quantize."""
    return add_quantize(a_u8, b_u8, params)


def q8vadd_cuda(a_u8, b_u8, params: AddQuantParams):
    """Quantized elementwise add of two uint8 tensors of one shape."""
    if a_u8.shape != b_u8.shape:
        raise ValueError(f"shapes differ: {tuple(a_u8.shape)} vs "
                         f"{tuple(b_u8.shape)}")
    if a_u8.device.type == "cpu" and b_u8.device.type == "cpu":
        return q8vadd_plain(a_u8, b_u8, params)
    _build.check_cuda("a", a_u8, torch.uint8, a_u8.dim())
    _build.check_cuda("b", b_u8, torch.uint8, b_u8.dim())
    if a_u8.device != b_u8.device:
        raise ValueError(f"a on {a_u8.device}, b on {b_u8.device}")
    out = torch.empty_like(a_u8)
    _build.launch(
        "qnn_q8vadd", a_u8.device.index or 0, a_u8.data_ptr(),
        b_u8.data_ptr(), out.data_ptr(), a_u8.numel(),
        params.zero_point_product, params.a_multiplier, params.b_multiplier,
        params.shift, params.y_zero_point, params.y_min, params.y_max,
        _build.stream_of(a_u8))
    q8vadd_cuda.launches += 1
    return out


q8vadd_cuda.launches = 0
