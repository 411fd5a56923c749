"""Quantized GEMM: the compute core of FC / 1x1-conv / conv-as-GEMM.

QNNPACK's q8gemm contract (src/q8gemm/): uint8 activations x packed
weights -> int32 accumulator with zero-point algebra -> fused
requantization -> uint8.  `q8gemm` runs the CUDA kernel of
kernels/q8gemm.py on GPU tensors and its plain version on CPU tensors;
`q8bmm`, the activation x activation product of attention, runs the kernel
of kernels/q8bmm.py the same way.  The row-sum pair `q8gemm_row_sums_out` /
`q8gemm_presummed` runs the q8gemm kernel's producer and consumer
instances: the producer also returns its output's row sums, which are
exactly the kernel-zero-point term the next GEMM needs.  `q8gemm_partial`
runs its partial instance (a K slice's raw int32 sum) and `q8requant` the
q8requant kernel (bias and requantization of a summed accumulator), the
two halves of K-sharded tensor parallelism (parallel/mesh.py).

Not carried over: the TPU routing (`gemm_path`, `q8gemm_routed`).
"""

from __future__ import annotations

from ..kernels.q8bmm import bmm_acc_plain, q8bmm_cuda
from ..kernels.q8gemm import (gemm_acc_plain, q8gemm_cuda,
                              q8gemm_partial_cuda, q8gemm_presummed_cuda,
                              q8gemm_row_sums_cuda)
from ..kernels.q8requant import q8requant_cuda
from .packing import PackedGemmWeights
from .shard import ColumnShard


def q8gemm_acc(a_u8, packed: PackedGemmWeights):
    """int32 accumulator of the quantized GEMM: [..., K] x [K, N] -> [..., N]
    (as an int64 tensor holding the wrapped int32 value).

    Identical to QNNPACK's accumulator sum_k (a - za)(w - zw) + bias."""
    return gemm_acc_plain(a_u8, packed.w, packed.bias_folded,
                          packed.kzp_biased)


def q8gemm(a_u8, packed: PackedGemmWeights, rparams):
    """Full quantized GEMM: uint8 [..., K] -> uint8 [..., N].

    The leading axes are viewed as one M axis (free for a contiguous
    tensor), so a 1x1 conv stays NHWC.  A ColumnShard
    (parallel.shard_params) runs its rank's output columns and gathers
    every rank's."""
    if isinstance(packed, ColumnShard):
        return packed.run(q8gemm, a_u8, rparams)
    lead = a_u8.shape[:-1]
    y = q8gemm_cuda(a_u8.reshape(-1, a_u8.shape[-1]).contiguous(), packed,
                    rparams)
    return y.reshape(*lead, packed.n)


def q8gemm_partial(a_u8, packed: PackedGemmWeights):
    """The int32 partial of the GEMM over the record's K: uint8 [..., K] ->
    int32 [..., N], sum_k A W' - kzp' * sum_k A, with no bias and no
    requantization (q8gemm's partial instance).  K slices' partials,
    summed in int32, plus the full record's bias_c, requantized by
    q8requant, are q8gemm (parallel/mesh.py:gemm_kdim_tp)."""
    lead = a_u8.shape[:-1]
    acc = q8gemm_partial_cuda(a_u8.reshape(-1, a_u8.shape[-1]).contiguous(),
                              packed)
    return acc.reshape(*lead, packed.n)


def q8requant(acc_i32, bias_c, rparams):
    """uint8 [..., N] = requantize(acc + bias_c) in any scheme (the int32
    sum wraps): the q8requant kernel, the epilogue of a summed partial."""
    lead = acc_i32.shape[:-1]
    n = acc_i32.shape[-1]
    y = q8requant_cuda(acc_i32.reshape(-1, n).contiguous(), bias_c, rparams)
    return y.reshape(*lead, n)


def q8gemm_row_sums_out(a_u8, packed: PackedGemmWeights, rparams):
    """Producer half of the row-sum pair: (y_u8 [..., N], row_sums int32
    [...]) with row_sums[m] = sum_n (y[m, n] - 128), the biased row sums
    that the next GEMM's kernel-zero-point term needs (the reference's
    precompute, operator-run.c:711-768, one op earlier).  One q8gemm launch
    writes both."""
    lead = a_u8.shape[:-1]
    y, rs = q8gemm_row_sums_cuda(
        a_u8.reshape(-1, a_u8.shape[-1]).contiguous(), packed, rparams)
    return y.reshape(*lead, packed.n), rs.reshape(lead)


def q8gemm_presummed(a_u8, row_sums_i32, packed: PackedGemmWeights, rparams):
    """Consumer half: the quantized GEMM with the kernel-zero-point row
    sums given (q8gemm_row_sums_out's), bit-identical to q8gemm, since the
    row-sum term is the same integer."""
    lead = a_u8.shape[:-1]
    y = q8gemm_presummed_cuda(
        a_u8.reshape(-1, a_u8.shape[-1]).contiguous(),
        row_sums_i32.reshape(-1).contiguous(), packed, rparams)
    return y.reshape(*lead, packed.n)


def q8bmm_acc(a_u8, b_u8, a_zero_point: int, b_zero_point: int):
    """Dynamic quantized matmul accumulator, both operands activations:
    [..., M, K] x [..., K, N] -> [..., M, N], exactly sum_k (a - za)(b - zb)
    (as an int64 tensor holding the wrapped int32 value)."""
    return bmm_acc_plain(a_u8, b_u8, a_zero_point, b_zero_point)


def q8bmm(a_u8, b_u8, a_zero_point: int, b_zero_point: int, rparams,
          out=None):
    """Dynamic quantized batched matmul: uint8 [..., M, K] x uint8
    [..., K, N] -> uint8 [..., M, N]; both operands have the same leading
    axes.  One or two leading axes go to the kernel as they are, strided
    views included (kernels/q8bmm.py:bmm_layout), so no operand is copied;
    other ranks are viewed as one batch axis.  `out` (one or two leading
    axes) receives the result."""
    lead = a_u8.shape[:-2]
    if b_u8.shape[:-2] != lead:
        raise ValueError(f"leading axes differ: {tuple(a_u8.shape)} vs "
                         f"{tuple(b_u8.shape)}")
    if len(lead) in (1, 2):
        return q8bmm_cuda(a_u8, b_u8, a_zero_point, b_zero_point, rparams,
                          out=out)
    if out is not None:
        raise ValueError(f"out takes one or two leading axes, got "
                         f"{tuple(a_u8.shape)}")
    m, k = a_u8.shape[-2:]
    n = b_u8.shape[-1]
    y = q8bmm_cuda(a_u8.reshape(-1, m, k), b_u8.reshape(-1, k, n),
                   a_zero_point, b_zero_point, rparams)
    return y.reshape(*lead, m, n)
