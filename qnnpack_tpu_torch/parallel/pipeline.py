"""Pipeline parallelism: stage-partitioned execution with microbatching
(the counterpart of qnnpack_tpu/parallel/pipeline.py).

Each rank of a mesh axis holds one stage's packed parameters.  The fill
and drain schedule of the JAX package runs n_micro + n_stages - 1 ticks;
at tick t stage s applies its block to microbatch t - s, taken from the
input (stage 0) or received from stage s - 1, and sends the result down
the chain with torch.distributed point to point.  A stage skips its
bubble ticks (the JAX package computes them and discards the result).
Integer activations move losslessly between stages, so a pipelined int8
model is bit-identical to its single-device execution.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..nn.shard import check_device
from .mesh import axis_of


def stack_stage_params(per_stage_params):
    """The stages' parameters, one entry a stage (the rank of stage s takes
    entry s).  The JAX package stacks them into one pytree with a leading
    stage dim; a packed record's derived fields are its own, so the port
    keeps the stages apart."""
    return tuple(per_stage_params)


def pipeline_apply(stage_fn, stacked_params, x_micro, mesh,
                   axis: str = "model"):
    """Run microbatches through a chain of shape-uniform stages.

    stage_fn:       (stage_params, x) -> y with y.shape == x.shape
    stacked_params: stack_stage_params of mesh.shape[axis] stages
    x_micro:        [n_micro, microbatch, ...] input microbatches, whole on
                    every rank
    Returns [n_micro, microbatch, ...] outputs (order preserved) on every
    rank, broadcast from the last stage."""
    n_stages, s, group = axis_of(mesh, axis)
    if len(stacked_params) != n_stages:
        raise ValueError(f"{len(stacked_params)} stages for {n_stages} "
                         f"'{axis}' ranks")
    check_device(x_micro, mesh.device_type, "pipeline")
    ranks = dist.get_process_group_ranks(group)
    params = stacked_params[s]
    n_micro = x_micro.shape[0]
    outputs = torch.empty_like(x_micro)
    for t in range(n_micro + n_stages - 1):
        k = t - s
        if not 0 <= k < n_micro:
            continue  # a bubble tick of this stage
        if s == 0:
            x_in = x_micro[k]
        else:
            x_in = torch.empty_like(x_micro[k])
            dist.recv(x_in, ranks[s - 1], group=group)
        y = stage_fn(params, x_in)
        if s < n_stages - 1:
            dist.send(y.contiguous(), ranks[s + 1], group=group)
        else:
            outputs[k] = y
    dist.broadcast(outputs, ranks[-1], group=group)
    return outputs
