"""q8gemm: the quantized GEMM kernel and its plain PyTorch version.

Port of qnnpack_tpu/kernels/q8gemm_small.py:q8gemm_small_pallas and
qnnpack_tpu/kernels/q8gemm.py:q8gemm_pallas; the CUDA source, with its
design and what bounds it, is csrc/q8gemm.cu.

`q8gemm_cuda` takes the plain version for CPU tensors only.  For CUDA
tensors it launches the kernel or raises; there is no fallback.
"""

from __future__ import annotations

import torch

from ..nn.dtypes import u8_to_biased_i8
from ..nn.packing import PackedGemmWeights
from ..nn.requant_dispatch import apply_requant
from . import _build


def gemm_acc_plain(a_u8: torch.Tensor, w: torch.Tensor,
                   bias_folded: torch.Tensor, kzp_biased: int):
    """int32 accumulator [..., N] of uint8 [..., K] x biased int8 [K, N]:
    sum_k A'W' - kzp' * sum_k A' + bias', as an int64 tensor holding the
    wrapped int32 value.

    The product runs as a float64 matmul, which is exact here (every partial
    sum is an integer below 2^53) and runs on the CPU and the GPU alike."""
    a = u8_to_biased_i8(a_u8)
    acc = torch.matmul(a.to(torch.float64), w.to(torch.float64)).to(
        torch.int64)
    acc = acc + bias_folded.to(torch.int64)
    if kzp_biased != 0:
        row_sums = a.to(torch.int64).sum(dim=-1, keepdim=True)
        acc = acc - kzp_biased * row_sums
    return ((acc + 2**31) & 0xFFFFFFFF) - 2**31


def q8gemm_plain(a_u8: torch.Tensor, packed: PackedGemmWeights, rparams):
    """Plain version of the kernel: uint8 [M, K] -> uint8 [M, N]."""
    return apply_requant(gemm_acc_plain(a_u8, packed.w, packed.bias_folded,
                                        packed.kzp_biased), rparams)


def q8gemm_cuda(a_u8: torch.Tensor, packed: PackedGemmWeights, rparams):
    """Quantized GEMM uint8 [M, K] -> uint8 [M, N] (any requant scheme)."""
    if a_u8.dim() != 2 or a_u8.shape[1] != packed.k:
        raise ValueError(f"activations {tuple(a_u8.shape)} do not match "
                         f"K = {packed.k}")
    if a_u8.device.type == "cpu":
        return q8gemm_plain(a_u8, packed, rparams)
    _build.check_cuda("a", a_u8, torch.uint8, 2)
    _build.check_cuda("w", packed.w, torch.int8, 2)
    _build.check_cuda("bias_folded", packed.bias_folded, torch.int32, 1)
    if packed.w.device != a_u8.device:
        raise ValueError(f"weights on {packed.w.device}, activations on "
                         f"{a_u8.device}")
    if tuple(packed.w.shape) != (packed.k, packed.n):
        raise ValueError(f"w shape {tuple(packed.w.shape)} != "
                         f"{(packed.k, packed.n)}")
    m = a_u8.shape[0]
    scales, rq = _build.requant_args(rparams, packed.n, a_u8.device)
    out = torch.empty((m, packed.n), dtype=torch.uint8, device=a_u8.device)
    _build.launch(
        "qnn_q8gemm", a_u8.device.index or 0, a_u8.data_ptr(),
        packed.w.data_ptr(), packed.bias_folded.data_ptr(),
        None if scales is None else scales.data_ptr(), out.data_ptr(),
        m, packed.n, packed.k, packed.kzp_biased, *rq,
        _build.stream_of(a_u8))
    q8gemm_cuda.launches += 1
    return out


q8gemm_cuda.launches = 0
