"""q8requant: the requantization epilogue of sharded products, and its
plain PyTorch version.

uint8 [M, N] = requantize(acc[M, N] + c[N]) in any of the five schemes,
the int32 sum wrapping.  K- and input-channel-sharded tensor parallelism
(parallel/mesh.py:gemm_kdim_tp, conv_ic_tp) all-reduces the ranks' int32
partials (the partial instances of q8gemm and q8conv) and runs this once;
it replaces XLA's apply_requant(acc + bias) of the JAX package
(qnnpack_tpu/parallel/mesh.py:160, :214), which has no Pallas form.  The
CUDA source, with its design and what bounds it, is csrc/q8requant.cu.

`q8requant_cuda` takes the plain version for CPU tensors only.  For CUDA
tensors it launches the kernel or raises; there is no fallback.
"""

from __future__ import annotations

import torch

from ..nn.packing import wrap_int32
from ..nn.requant_dispatch import apply_requant
from . import _build


def q8requant_plain(acc: torch.Tensor, bias_c: torch.Tensor, rparams):
    """Plain version of the kernel: apply_requant of acc + c, wrapped to
    int32 as the reference's int32 sum wraps."""
    total = acc.to(torch.int64) + bias_c.to(torch.int64)
    return apply_requant(wrap_int32(total).to(torch.int64), rparams)


def q8requant_cuda(acc: torch.Tensor, bias_c: torch.Tensor, rparams):
    """int32 [M, N] + int32 [N] -> uint8 [M, N], requantized (any
    scheme)."""
    if acc.dim() != 2 or tuple(bias_c.shape) != (acc.shape[1],):
        raise ValueError(f"accumulator {tuple(acc.shape)} and bias "
                         f"{tuple(bias_c.shape)} do not match")
    if acc.device.type == "cpu":
        return q8requant_plain(acc, bias_c, rparams)
    _build.check_cuda("acc", acc, torch.int32, 2)
    _build.check_cuda("bias_c", bias_c, torch.int32, 1)
    if bias_c.device != acc.device:
        raise ValueError(f"bias on {bias_c.device}, accumulator on "
                         f"{acc.device}")
    m, n = acc.shape
    scales, rq = _build.requant_args(rparams, n, acc.device)
    out = torch.empty((m, n), dtype=torch.uint8, device=acc.device)
    _build.launch(
        "qnn_q8requant", acc.device.index or 0, acc.data_ptr(),
        bias_c.data_ptr(), None if scales is None else scales.data_ptr(),
        out.data_ptr(), m, n, *rq, _build.stream_of(acc))
    q8requant_cuda.launches += 1
    return out


q8requant_cuda.launches = 0
