"""Weight packing with zero-point/bias folding.

Produces a [K, N] biased-int8 matrix plus a folded int32 bias that absorbs
every static zero-point cross term (QNNPACK pack.h:24-43, rewritten in the
biased-int8 domain - see nn/dtypes.py):

    bias'[n] = bias[n] - za' * sum_k W'[k, n] + K * za' * zw'

The only dynamic correction left for the kernel epilogue is the per-row
activation sum times the kernel zero point; the CUDA GEMM kernel takes
that row sum itself, so the JAX package's `w_aug` (an MXU trick) is not
carried over.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .dtypes import biased_zero_point, u8_to_biased_i8


@dataclasses.dataclass(frozen=True)
class PackedGemmWeights:
    """GEMM/FC/1x1-conv weights.

    w:           int8 [K, N]  biased (value - 128), contiguous
    bias_folded: int32 [N]    bias with all static zero-point terms folded in
    k, n:        logical dims
    input_zero_point / kernel_zero_point: original uint8 zero points
    """

    w: torch.Tensor
    bias_folded: torch.Tensor
    k: int
    n: int
    input_zero_point: int
    kernel_zero_point: int

    @property
    def kzp_biased(self) -> int:
        return biased_zero_point(self.kernel_zero_point)


def as_tensor(x, dtype, device=None) -> torch.Tensor:
    """numpy array or tensor -> tensor of `dtype` on `device` (default: the
    tensor's own device, the CPU for numpy)."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.array(x, order="C", copy=True))
    x = torch.as_tensor(x)
    return x.to(device=device if device is not None else x.device,
                dtype=dtype)


def fold_bias(bias, w_sums: torch.Tensor, count: int, input_zero_point: int,
              kernel_zero_point: int) -> torch.Tensor:
    """bias - za' * sum(W') + count * za' * zw', wrapped to int32 as the
    JAX package's int32 arithmetic wraps."""
    za = biased_zero_point(input_zero_point)
    zw = biased_zero_point(kernel_zero_point)
    folded = bias.to(torch.int64) - za * w_sums + count * za * zw
    return (((folded + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def pack_gemm_weights(kernel, bias, input_zero_point: int,
                      kernel_zero_point: int, *, device=None
                      ) -> PackedGemmWeights:
    """Pack FC/GEMM weights (pack_q8gemm_w analogue, pack.h:12-49).

    kernel: uint8 [N, K] (FC layout: [output_channels][input_channels])
    bias:   int32 [N] (or None for zero bias)
    """
    kernel = as_tensor(kernel, torch.uint8, device)
    n, k = kernel.shape
    if bias is None:
        bias = torch.zeros((n,), dtype=torch.int32, device=kernel.device)
    bias = as_tensor(bias, torch.int32, kernel.device)

    w = u8_to_biased_i8(kernel).t().contiguous()  # [K, N] int8
    col_sums = w.to(torch.int64).sum(dim=0)  # [N]
    bias_folded = fold_bias(bias, col_sums, k, input_zero_point,
                            kernel_zero_point)
    return PackedGemmWeights(w=w, bias_folded=bias_folded, k=int(k), n=int(n),
                             input_zero_point=int(input_zero_point),
                             kernel_zero_point=int(kernel_zero_point))
