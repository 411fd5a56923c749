"""q8bmm: the batched activation x activation GEMM kernel and its plain
PyTorch version.

Port of qnnpack_tpu/nn/gemm.py:q8bmm, which the JAX package leaves to XLA
(it has no Pallas form); the port runs it on a hand-written kernel, as it
runs every op of a path.  The CUDA source, with its design and what bounds
it, is csrc/q8bmm.cu.

`q8bmm_cuda` takes the plain version for CPU tensors only.  For CUDA
tensors it launches the kernel or raises; there is no fallback.
"""

from __future__ import annotations

import torch

from ..nn.dtypes import biased_zero_point, u8_to_biased_i8
from ..nn.requant_dispatch import apply_requant
from . import _build


def bmm_acc_plain(a_u8: torch.Tensor, b_u8: torch.Tensor, a_zero_point: int,
                  b_zero_point: int):
    """int32 accumulator [..., M, N] of uint8 [..., M, K] x uint8 [..., K, N]:
    sum_k (a - za)(b - zb) = A'B' - zb' rowsum(A') - za' colsum(B')
    + K za' zb' on biased int8, as an int64 tensor holding the wrapped int32
    value.

    The product runs as a float64 matmul, exact here (|sum| < 2^53)."""
    a = u8_to_biased_i8(a_u8)
    b = u8_to_biased_i8(b_u8)
    za = biased_zero_point(a_zero_point)
    zb = biased_zero_point(b_zero_point)
    k = a.shape[-1]
    acc = torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(
        torch.int64)
    acc = acc - zb * a.to(torch.int64).sum(dim=-1, keepdim=True)
    acc = acc - za * b.to(torch.int64).sum(dim=-2, keepdim=True)
    acc = acc + k * za * zb
    return ((acc + 2**31) & 0xFFFFFFFF) - 2**31


def q8bmm_plain(a_u8: torch.Tensor, b_u8: torch.Tensor, a_zero_point: int,
                b_zero_point: int, rparams):
    """Plain version of the kernel: uint8 [G, M, K] x [G, K, N] -> [G, M, N]."""
    return apply_requant(bmm_acc_plain(a_u8, b_u8, a_zero_point,
                                       b_zero_point), rparams)


def q8bmm_cuda(a_u8: torch.Tensor, b_u8: torch.Tensor, a_zero_point: int,
               b_zero_point: int, rparams):
    """Batched quantized matmul uint8 [G, M, K] x uint8 [G, K, N] -> uint8
    [G, M, N] (any requant scheme; a per-channel scale is per column N)."""
    if a_u8.dim() != 3 or b_u8.dim() != 3:
        raise ValueError(f"expected [G, M, K] and [G, K, N], got "
                         f"{tuple(a_u8.shape)} and {tuple(b_u8.shape)}")
    g, m, k = a_u8.shape
    if b_u8.shape[0] != g or b_u8.shape[1] != k:
        raise ValueError(f"operands {tuple(a_u8.shape)} and "
                         f"{tuple(b_u8.shape)} do not chain")
    if a_u8.device.type == "cpu" and b_u8.device.type == "cpu":
        return q8bmm_plain(a_u8, b_u8, a_zero_point, b_zero_point, rparams)
    _build.check_cuda("a", a_u8, torch.uint8, 3)
    _build.check_cuda("b", b_u8, torch.uint8, 3)
    if a_u8.device != b_u8.device:
        raise ValueError(f"a on {a_u8.device}, b on {b_u8.device}")
    n = b_u8.shape[2]
    za = biased_zero_point(a_zero_point)
    zb = biased_zero_point(b_zero_point)
    scales, rq = _build.requant_args(rparams, n, a_u8.device)
    out = torch.empty((g, m, n), dtype=torch.uint8, device=a_u8.device)
    _build.launch(
        "qnn_q8bmm", a_u8.device.index or 0, a_u8.data_ptr(), b_u8.data_ptr(),
        None if scales is None else scales.data_ptr(), out.data_ptr(), g, m,
        n, k, za, zb, *rq, _build.stream_of(a_u8))
    q8bmm_cuda.launches += 1
    return out


q8bmm_cuda.launches = 0
