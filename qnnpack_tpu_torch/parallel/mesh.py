"""Device-mesh scaling on torch.distributed: the counterpart of
qnnpack_tpu/parallel/mesh.py.

One process drives one device.  A mesh is a
torch.distributed.device_mesh.DeviceMesh with the axes ("data", "model"),
the counterpart of jax.sharding.Mesh; `make_mesh(device="cuda")` builds it
over NCCL, `device="cpu"` over gloo, and a collective on a tensor of the
other device type raises.

Where the JAX functions run a `shard_map` body on each input's shard, the
port's functions run that body in each rank: an input that the JAX
in_specs shard arrives as this rank's shard, an input they replicate
arrives whole, and a result is what the JAX out_specs say (a replicated
one whole on every rank, a sharded one this rank's shard).

  - "data":  batch-sharded inference (DP): `batch_sharding(mesh).shard(x)`
    gives this rank its rows, `.gather(y)` every rank's;
  - "model": tensor parallelism, two layouts:
      (a) output channels (`shard_params`): each rank holds a
          `ColumnShard`, its slice of a record's output channels packed as
          a record of its own; nn.gemm.q8gemm and nn.conv.q8conv2d launch
          on the slice and all-gather the channels (the all-gathers that
          XLA inserts for the JAX package);
      (b) contraction dim (`gemm_kdim_tp`, `conv_ic_tp`): each rank's
          K slice runs the partial instance of q8gemm or q8conv (int32,
          no bias, no requantization), the partials are all-reduced in
          int32, and the q8requant kernel adds the full record's bias_c
          and requantizes once.  Integer sums wrap mod 2^32 in any order,
          so sharding never changes bits.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..device import resolve_device
from ..nn.conv import PackedConvWeights, q8conv2d_partial
from ..nn.gemm import q8gemm_partial, q8requant
from ..nn.packing import PackedGemmWeights
from ..nn.shard import ColumnShard, cached_slice, channel_slice, check_device
from .multihost import ensure_world

AXES = ("data", "model")


def make_mesh(n_data: int | None = None, n_model: int = 1, *,
              device="cuda"):
    """A ("data", "model") DeviceMesh over every rank of the world, NCCL
    for device="cuda" (raises without a GPU) and gloo for "cpu".  A
    process with no world yet gets the one distributed_init reads from the
    environment, or a world of itself."""
    dev = resolve_device(device)
    world = ensure_world(dev.type)
    if n_data is None:
        n_data = world // n_model
    assert n_data * n_model == world, (
        f"{world} devices do not factor into data={n_data} x "
        f"model={n_model}")
    return init_device_mesh(dev.type, (n_data, n_model), mesh_dim_names=AXES)


def axis_of(mesh, axis: str):
    """(size, this rank's index, process group) of mesh axis `axis`."""
    return mesh.size(mesh.mesh_dim_names.index(axis)), \
        mesh.get_local_rank(axis), mesh.get_group(axis)


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors of `mesh` lie on: the CPU for a gloo
    mesh, the current CUDA device for an NCCL one."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def to_device(tree, device):
    """`tree` (records, tensors, and lists, tuples and dicts of them) on
    `device`: a packed record is packed again from its tensors there (its
    derived fields with it); one already there is kept as it is."""
    device = torch.device(device)
    if isinstance(tree, (PackedGemmWeights, PackedConvWeights)):
        if tree.w.device == device:
            return tree
        return dataclasses.replace(tree, w=tree.w.to(device),
                                   bias_folded=tree.bias_folded.to(device))
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(t, device) for t in tree)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree


def _shardable(p, n_model: int) -> bool:
    """Only shard channel dims that divide the model axis; grouped and
    depthwise conv channel blocks must not split a group (the JAX rule)."""
    if n_model == 1:
        return False
    if isinstance(p, PackedGemmWeights):
        return p.n % n_model == 0
    if isinstance(p, PackedConvWeights):
        if p.groups > 1:
            return p.groups % n_model == 0
        return p.group_output_channels % n_model == 0
    return False


def shard_params(params, mesh):
    """A packed-params list placed for `mesh`: each record on this rank's
    device, and each shardable one replaced by the ColumnShard of this
    rank's output channels on the "model" axis (the JAX package's
    NamedSharding of w and bias_folded over "model").  The JAX package
    drops a record's single-pass `w_aug` column here; the port's records
    have none, so nothing else changes."""
    n_model, index, group = axis_of(mesh, "model")
    dev = mesh_device(mesh)
    out = []
    for p in params:
        p = to_device(p, dev)
        if _shardable(p, n_model):
            n = p.n if isinstance(p, PackedGemmWeights) else \
                p.groups * p.group_output_channels
            p = ColumnShard(channel_slice(p, n_model, index), n, n_model,
                            index, group, mesh.device_type)
        out.append(p)
    return out


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """Rows sharded over the "data" axis: the counterpart of a
    NamedSharding(mesh, P("data")) for device_put (`shard`) and for
    reading a global array back (`gather`)."""

    mesh: object

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This data rank's rows of the whole batch `x`."""
        n, index, _ = axis_of(self.mesh, "data")
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} does not divide over {n} "
                             "'data' shards")
        rows = x.shape[0] // n
        return x[index * rows:(index + 1) * rows].contiguous()

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        """Every data rank's rows, in rank order: the whole batch."""
        n, _, group = axis_of(self.mesh, "data")
        check_device(y, self.mesh.device_type, "batch gather")
        y = y.contiguous()
        parts = [torch.empty_like(y) for _ in range(n)]
        dist.all_gather(parts, y, group=group)
        return torch.cat(parts)


def batch_sharding(mesh) -> BatchSharding:
    """NHWC (or NC) input sharded along batch over the "data" axis."""
    return BatchSharding(mesh)


def sharded_inference_fn(forward, mesh):
    """forward(params, x) for mesh execution: fn(params, x_local) ->
    y_local for this data rank's rows (batch_sharding(mesh).shard's),
    params as shard_params placed them.  It runs eagerly: a "model" axis
    of more than one rank all-gathers inside the forward, and a
    collective is not captured into a CUDA graph here."""
    def fn(params, x_local):
        check_device(x_local, mesh.device_type, "sharded forward input")
        return forward(params, x_local)

    return fn


# --- K-dim tensor parallelism: int32 all-reduce before requantization -----

def gemm_k_slice(packed: PackedGemmWeights, shards: int, index: int):
    """K rows [index K/n, (index + 1) K/n) of the weights as a record of
    their own (its bias is unused: the partial instance adds none), built
    once per (record, shards, index) and held by the record."""
    ks = packed.k // shards

    def build():
        return PackedGemmWeights(
            w=packed.w[index * ks:(index + 1) * ks].contiguous(),
            bias_folded=torch.zeros(packed.n, dtype=torch.int32,
                                    device=packed.w.device),
            k=ks, n=packed.n, input_zero_point=packed.input_zero_point,
            kernel_zero_point=packed.kernel_zero_point)

    return cached_slice(packed, ("k", shards, index), build)


def conv_c_slice(packed: PackedConvWeights, shards: int, index: int):
    """Input channels [index C/n, (index + 1) C/n) of a dense conv's
    weights as a record of their own, held by the record."""
    cs = packed.group_input_channels // shards

    def build():
        return PackedConvWeights(
            w=packed.w[:, :, index * cs:(index + 1) * cs].contiguous(),
            bias_folded=torch.zeros(packed.w.shape[-1], dtype=torch.int32,
                                    device=packed.w.device),
            kernel_height=packed.kernel_height,
            kernel_width=packed.kernel_width, group_input_channels=cs,
            group_output_channels=packed.group_output_channels, groups=1,
            input_zero_point=packed.input_zero_point,
            kernel_zero_point=packed.kernel_zero_point)

    return cached_slice(packed, ("c", shards, index), build)


def all_reduce_int32(acc: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum `acc` (int32) over mesh axis `axis`, in place; int32 sums wrap
    mod 2^32 on both backends."""
    check_device(acc, mesh.device_type, "int32 all-reduce")
    _, _, group = axis_of(mesh, axis)
    dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
    return acc


def gemm_kdim_tp(a_u8, packed: PackedGemmWeights, rparams, mesh,
                 axis: str = "model"):
    """Quantized GEMM with the contraction dim sharded over `axis`.

    a_u8 is this rank's K slice [M, K/n] of the activations; packed the
    whole record.  Each rank runs q8gemm's partial instance on its K
    slice of the weights (gemm_k_slice), the int32 partials are summed
    over `axis`, and q8requant adds the record's bias_c and requantizes
    once: bit-identical to nn.gemm.q8gemm.  The output [M, N] is whole on
    every rank of `axis`."""
    n_shards, index, _ = axis_of(mesh, axis)
    if packed.k % n_shards != 0:
        raise ValueError(
            f"K={packed.k} does not divide over {n_shards} '{axis}' shards")
    acc = q8gemm_partial(a_u8, gemm_k_slice(packed, n_shards, index))
    return q8requant(all_reduce_int32(acc, mesh, axis), packed.bias_c,
                     rparams)


def conv_ic_tp(a_u8, packed: PackedConvWeights, rparams, mesh,
               axis: str = "model", strides=(1, 1),
               padding=((0, 0), (0, 0)), dilation=(1, 1)):
    """Quantized conv with input channels sharded over `axis` (ungrouped).

    a_u8 is this rank's channel slice [B, H, W, C/n].  The same contract
    as gemm_kdim_tp on q8conv's partial instance: every rank's zero-point
    taps read izp and its row sums count them, so the sum over ranks is
    the unsharded window sum.  The output is whole on every rank."""
    if packed.groups != 1:
        raise ValueError("conv_ic_tp shards input channels; grouped conv "
                         "shards over groups instead (parallel/expert.py)")
    n_shards, index, _ = axis_of(mesh, axis)
    if packed.group_input_channels % n_shards != 0:
        raise ValueError(
            f"input channels {packed.group_input_channels} do not divide "
            f"over {n_shards} '{axis}' shards")
    acc = q8conv2d_partial(a_u8, conv_c_slice(packed, n_shards, index),
                           strides, padding, dilation)
    return q8requant(all_reduce_int32(acc, mesh, axis), packed.bias_c,
                     rparams)
