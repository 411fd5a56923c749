"""Output-channel slices of packed records, and the column shard that
q8gemm and q8conv2d run as one rank of a tensor-parallel group.

The JAX package shards a record's output channels by placing its arrays
with a NamedSharding (qnnpack_tpu/parallel/mesh.py:shard_params) and lets
XLA insert the all-gathers.  Here the slices are packed records of their
own: a `ChannelSlice` holds the record of one rank's output channels
(packed once, with its own w_kmajor and bias_c) and, for a grouped or
depthwise conv, the input channels of its groups.  A `ColumnShard`, what
parallel.shard_params puts in place of a record, adds the "model" group:
nn/gemm.py:q8gemm and nn/conv.py:q8conv2d launch on the slice and
all-gather the channels (`ColumnShard.run`).

Slices are built once per (record, shards, index) and held by the record
(`tp_slices`), as deconv plans are: a CUDA-graph capture must find them
built, since a graph keeps the addresses of what it launched on.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..quant.params import PerChannelFP32Params


def cached_slice(packed, key, build):
    """packed.tp_slices[key], built by build() on first use.  A CUDA-graph
    capture must find it built (its eager warm-up builds it)."""
    got = packed.tp_slices.get(key)
    if got is not None:
        return got
    if packed.w.device.type == "cuda" and \
            torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"the {key[0]} slice of a record is built outside "
                           "a CUDA-graph capture: run the forward once "
                           "eagerly first")
    got = build()
    packed.tp_slices[key] = got
    return got


def check_device(t: torch.Tensor, device_type: str, what: str) -> None:
    """Raise unless `t` lies on a device of the group's type: a CUDA
    tensor never goes through gloo, a CPU tensor never through NCCL."""
    if t.device.type != device_type:
        raise ValueError(f"{what}: a {t.device.type} tensor on a "
                         f"{device_type} mesh")


@dataclasses.dataclass(frozen=True, eq=False)
class ChannelSlice:
    """Output channels [out0, out1) of a record as a record of their own
    (`record`), with the input channels [in0, in1) its groups read (None:
    every input channel, a dense conv or a GEMM), and the per-channel
    requantizations of those columns (`local_rparams`)."""

    record: object
    out0: int
    out1: int
    in0: int | None
    in1: int | None
    rparams: dict = dataclasses.field(default_factory=dict, repr=False)

    def local_input(self, x: torch.Tensor) -> torch.Tensor:
        if self.in0 is None:
            return x
        return x[..., self.in0:self.in1].contiguous()

    def local_rparams(self, rparams):
        """`rparams` for these columns: per-channel scales sliced once per
        requantization and kept here, on the record's device; any other
        scheme as it is."""
        if not isinstance(rparams, PerChannelFP32Params):
            return rparams
        got = self.rparams.get(rparams)
        if got is not None:
            return got
        dev = self.record.w.device
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("per-channel scales of a column slice are "
                               "sliced outside a CUDA-graph capture: run "
                               "the forward once eagerly first")
        scales = rparams.scales[self.out0:self.out1]
        got = PerChannelFP32Params(
            scales=scales, zero_point=rparams.zero_point, qmin=rparams.qmin,
            qmax=rparams.qmax, device_scales=torch.tensor(
                scales, dtype=torch.float32, device=dev))
        self.rparams[rparams] = got
        return got


def channel_slice(packed, shards: int, index: int) -> ChannelSlice:
    """Slice `index` of `shards` equal output-channel slices of a
    PackedGemmWeights or PackedConvWeights (a grouped or depthwise conv's
    by whole groups), held by the record."""
    from .conv import PackedConvWeights  # nn.conv imports this module
    from .packing import PackedGemmWeights

    def build():
        bias = packed.bias_folded
        if isinstance(packed, PackedGemmWeights):
            cols = packed.n // shards
            o0 = index * cols
            return ChannelSlice(PackedGemmWeights(
                w=packed.w[:, o0:o0 + cols].contiguous(),
                bias_folded=bias[o0:o0 + cols].contiguous(), k=packed.k,
                n=cols, input_zero_point=packed.input_zero_point,
                kernel_zero_point=packed.kernel_zero_point),
                o0, o0 + cols, None, None)
        if not isinstance(packed, PackedConvWeights):
            raise TypeError(f"not a packed record: {type(packed)}")
        groups = packed.groups // shards if packed.groups > 1 else 1
        ocpg = (packed.group_output_channels if packed.groups > 1
                else packed.group_output_channels // shards)
        cols = groups * ocpg
        o0 = index * cols
        in0 = in1 = None
        if packed.groups > 1:
            in0 = index * groups * packed.group_input_channels
            in1 = in0 + groups * packed.group_input_channels
        return ChannelSlice(PackedConvWeights(
            w=packed.w[..., o0:o0 + cols].contiguous(),
            bias_folded=bias[o0:o0 + cols].contiguous(),
            kernel_height=packed.kernel_height,
            kernel_width=packed.kernel_width,
            group_input_channels=packed.group_input_channels,
            group_output_channels=ocpg, groups=groups,
            input_zero_point=packed.input_zero_point,
            kernel_zero_point=packed.kernel_zero_point),
            o0, o0 + cols, in0, in1)

    return cached_slice(packed, ("columns", shards, index), build)


@dataclasses.dataclass(frozen=True, eq=False)
class ColumnShard:
    """One rank's output channels of a record under output-channel tensor
    parallelism: the slice it computes (`part`), the record's full channel
    count `n`, and the "model" group (`group`, of `device_type`) whose
    ranks hold the other slices in rank order."""

    part: ChannelSlice
    n: int
    shards: int
    index: int
    group: object
    device_type: str

    def run(self, fn, x, rparams, *args):
        """fn(local input, slice record, local rparams, *args) on this
        rank's slice, then the channels of every rank gathered: the
        record's full output, the same bytes on every rank."""
        y = fn(self.part.local_input(x), self.part.record,
               self.part.local_rparams(rparams), *args)
        return self.gather(y)

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        check_device(y, self.device_type, "column shard all-gather")
        y = y.contiguous()
        parts = [torch.empty_like(y) for _ in range(self.shards)]
        dist.all_gather(parts, y, group=self.group)
        return torch.cat(parts, dim=-1)
