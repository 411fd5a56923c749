"""Weight packing with zero-point/bias folding.

Produces a [K, N] biased-int8 matrix plus a folded int32 bias that absorbs
every static zero-point cross term (QNNPACK pack.h:24-43, rewritten in the
biased-int8 domain - see nn/dtypes.py):

    bias'[n] = bias[n] - za' * sum_k W'[k, n] + K * za' * zw'

The only dynamic correction left for the kernel epilogue is the per-row
activation sum times the kernel zero point; the CUDA GEMM kernel takes
that row sum itself, so the JAX package's `w_aug` (an MXU trick) is not
carried over.

Beside `w` (the JAX package's layout, which the plain versions and the
parity tests read) every packed record holds what the tensor-core kernels
read, derived once at construction: `w_kmajor`, the weights K-major (each
output column's K bytes contiguous, zero-padded to the kernels' 64-byte K
step), and `bias_c`, the folded bias of the raw-uint8 form of the sum
(`kmajor_bias`).  Nothing is transposed or padded on the launch path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .dtypes import biased_zero_point, u8_to_biased_i8

# K step of the tensor-core kernels (csrc/imma_tile.cuh kStepK): K-major
# weight rows are padded with zeros to a multiple of it.
K_STEP = 64


def round_up(x: int, step: int = K_STEP) -> int:
    return -(-max(int(x), 1) // step) * step


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32, wrapped mod 2^32 as the JAX package's int32 math."""
    return (((x + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def kmajor_bias(bias_folded: torch.Tensor, w_sums: torch.Tensor, k: int,
                kzp_biased: int) -> torch.Tensor:
    """c = bias' - 128 * sum(W') + 128 * K * kzp' (int32, wrapped).

    With A' = A - 128 the reference's sum_k A'W' + bias' - kzp' sum_k A'
    equals sum_k A W' + c - kzp' sum_k A mod 2^32, so a kernel can take
    the raw uint8 A as it lies in memory."""
    c = (bias_folded.to(torch.int64) - 128 * w_sums.to(torch.int64)
         + 128 * k * kzp_biased)
    return wrap_int32(c)


def set_kernel_fields(record, w_kmajor: torch.Tensor,
                      w_sums: torch.Tensor, k: int) -> None:
    """Set the kernels' fields of a frozen packed record."""
    object.__setattr__(record, "w_kmajor", w_kmajor)
    object.__setattr__(record, "bias_c", kmajor_bias(
        record.bias_folded, w_sums, k, record.kzp_biased))


@dataclasses.dataclass(frozen=True)
class PackedGemmWeights:
    """GEMM/FC/1x1-conv weights.

    w:           int8 [K, N]  biased (value - 128), contiguous
    bias_folded: int32 [N]    bias with all static zero-point terms folded in
    k, n:        logical dims
    input_zero_point / kernel_zero_point: original uint8 zero points
    w_kmajor:    int8 [N, Kp] w transposed, zero past K (derived)
    bias_c:      int32 [N]    kmajor_bias of bias_folded (derived)
    tp_slices:   the tensor-parallel slices of this record built so far
                 (nn/shard.py, parallel/mesh.py), keyed by kind, shard
                 count and index; empty at construction
    """

    w: torch.Tensor
    bias_folded: torch.Tensor
    k: int
    n: int
    input_zero_point: int
    kernel_zero_point: int
    w_kmajor: torch.Tensor = dataclasses.field(init=False, repr=False,
                                               compare=False)
    bias_c: torch.Tensor = dataclasses.field(init=False, repr=False,
                                             compare=False)
    tp_slices: dict = dataclasses.field(init=False, repr=False,
                                        compare=False)

    def __post_init__(self):
        wk = torch.zeros((self.n, round_up(self.k)), dtype=torch.int8,
                         device=self.w.device)
        wk[:, :self.k] = self.w.t()
        set_kernel_fields(self, wk, self.w.to(torch.int64).sum(dim=0),
                          self.k)
        object.__setattr__(self, "tp_slices", {})

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
    return wrap_int32(bias.to(torch.int64) - za * w_sums + count * za * zw)


def pack_gemm_weights(kernel, bias, input_zero_point: int,
                      kernel_zero_point: int, *, device=None
                      ) -> PackedGemmWeights:
    """Pack FC/GEMM weights (pack_q8gemm_w analogue, pack.h:12-49).

    kernel: uint8 [N, K] (FC layout: [output_channels][input_channels])
    bias:   int32 [N] (or None for zero bias)

    Recorded as one span setup.pack (utils/profiling.py).
    """
    from ..utils import profiling
    with profiling.span("setup.pack"):
        kernel = as_tensor(kernel, torch.uint8, device)
        n, k = kernel.shape
        if bias is None:
            bias = torch.zeros((n,), dtype=torch.int32, device=kernel.device)
        bias = as_tensor(bias, torch.int32, kernel.device)

        w = u8_to_biased_i8(kernel).t().contiguous()  # [K, N] int8
        col_sums = w.to(torch.int64).sum(dim=0)  # [N]
        bias_folded = fold_bias(bias, col_sums, k, input_zero_point,
                                kernel_zero_point)
        return PackedGemmWeights(
            w=w, bias_folded=bias_folded, k=int(k), n=int(n),
            input_zero_point=int(input_zero_point),
            kernel_zero_point=int(kernel_zero_point))


@dataclasses.dataclass(frozen=True)
class PackedGroupedWeights:
    """The weights of E experts that one grouped GEMM launch runs, each an
    [N, K] FC kernel packed as PackedGemmWeights packs it, stacked:

    w:           int8 [E, K, N]  biased (value - 128), for the plain path
    bias_folded: int32 [E, N]
    w_kmajor:    int8 [E * N, Kp] every expert's K-major rows, one after
                 another (expert e's at rows e * N)
    bias_c:      int32 [E * N]    kmajor_bias of each expert's bias_folded
    """

    w: torch.Tensor
    bias_folded: torch.Tensor
    w_kmajor: torch.Tensor
    bias_c: torch.Tensor
    experts: int
    k: int
    n: int
    input_zero_point: int
    kernel_zero_point: int

    @property
    def kzp_biased(self) -> int:
        return biased_zero_point(self.kernel_zero_point)


def pack_grouped_weights(kernels, input_zero_point: int,
                         kernel_zero_point: int, *, device=None
                         ) -> PackedGroupedWeights:
    """Pack E experts' FC kernels, uint8 [E, N, K], with zero biases, for
    q8gemm's grouped instance.  Recorded as one span setup.pack."""
    from ..utils import profiling
    with profiling.span("setup.pack"):
        kernels = as_tensor(kernels, torch.uint8, device)
        e, n, k = kernels.shape
        w = u8_to_biased_i8(kernels).transpose(1, 2).contiguous()  # [E,K,N]
        w_sums = w.to(torch.int64).sum(dim=1)                       # [E, N]
        bias_folded = fold_bias(torch.zeros_like(w_sums), w_sums, k,
                                input_zero_point, kernel_zero_point)
        wk = torch.zeros((e * n, round_up(k)), dtype=torch.int8,
                         device=kernels.device)
        wk[:, :k] = u8_to_biased_i8(kernels).reshape(e * n, k)
        kzp = biased_zero_point(kernel_zero_point)
        return PackedGroupedWeights(
            w=w, bias_folded=bias_folded, w_kmajor=wk,
            bias_c=kmajor_bias(bias_folded, w_sums, k, kzp).reshape(-1),
            experts=int(e), k=int(k), n=int(n),
            input_zero_point=int(input_zero_point),
            kernel_zero_point=int(kernel_zero_point))
