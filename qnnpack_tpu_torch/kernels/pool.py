"""q8gavgpool: the global average-pool kernel and its plain version.

Port of qnnpack_tpu/kernels/pool.py:q8gavgpool_pallas; the CUDA source,
with its design and what bounds it, is csrc/q8gavgpool.cu.

`q8gavgpool_cuda` takes the plain version for CPU tensors only.  For CUDA
tensors it launches the kernel or raises; there is no fallback.
"""

from __future__ import annotations

import torch

from ..quant.params import AvgPoolQuantParams
from ..quant.requantize import avgpool_quantize
from . import _build


def q8gavgpool_plain(x_u8, params: AvgPoolQuantParams):
    """Plain version of the kernel: [B, S, C] -> [B, C]."""
    acc = x_u8.to(torch.int64).sum(dim=1) + params.bias
    return avgpool_quantize(((acc + 2**31) & 0xFFFFFFFF) - 2**31, params)


def q8gavgpool_cuda(x_u8, params: AvgPoolQuantParams):
    """Quantized global average pooling uint8 [B, S, C] -> uint8 [B, C]."""
    if x_u8.dim() != 3:
        raise ValueError(f"expected [B, S, C], got {tuple(x_u8.shape)}")
    if x_u8.device.type == "cpu":
        return q8gavgpool_plain(x_u8, params)
    _build.check_cuda("x", x_u8, torch.uint8, 3)
    b, s, c = x_u8.shape
    out = torch.empty((b, c), dtype=torch.uint8, device=x_u8.device)
    _build.launch(
        "qnn_q8gavgpool", x_u8.device.index or 0, x_u8.data_ptr(),
        out.data_ptr(), b, s, c, params.bias, params.multiplier,
        params.shift, params.output_zero_point,
        params.output_min_less_zero_point,
        params.output_max_less_zero_point, _build.stream_of(x_u8))
    q8gavgpool_cuda.launches += 1
    return out


q8gavgpool_cuda.launches = 0
