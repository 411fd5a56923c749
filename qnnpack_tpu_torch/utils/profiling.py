"""Profiling: device traces and per-op analytic cost counters.

A port of qnnpack_tpu/utils/profiling.py.  `trace()` wraps torch.profiler
(CPU and CUDA activity) and writes a Chrome trace; `graph_cost()` counts
the MACs and bytes of each layer of a models.graph.GraphSpec - the
roofline numerators, counted as the JAX package counts them.
"""

from __future__ import annotations

import contextlib
import dataclasses
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(log_dir, device="cuda"):
    """Profile the block with torch.profiler (CPU activity, and CUDA
    activity on a card) and write its Chrome trace to
    `log_dir`/trace.json on exit; yields the profiler, whose
    key_averages() sum the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


@dataclasses.dataclass
class OpCost:
    name: str
    macs: int  # multiply-accumulates
    bytes_accessed: int

    @property
    def flops(self) -> int:
        return 2 * self.macs


def _conv_out(size, k, pad, stride, dilation=1):
    eff = (k - 1) * dilation + 1
    return (size + pad[0] + pad[1] - eff) // stride + 1


def graph_cost(spec, input_shape) -> list[OpCost]:
    """Per-layer MACs/bytes for a models.graph.GraphSpec forward at
    `input_shape` (NHWC uint8)."""
    costs = []
    b, h, w, c = input_shape
    env = {}
    for (tag, name, payload), raw in zip(spec.layers, spec.raw_weights):
        if tag == "save":
            env[payload] = (h, w, c)
        elif tag == "load":
            h, w, c = env[payload]
        elif tag == "split":
            slot, ch = payload
            env[slot] = (h, w, ch)
            c = c - ch
        elif tag == "concat":
            c = sum(env[s][2] for s in payload)
            h, w, _ = env[payload[0]]
            # Zero traffic in the lower bound, as the JAX package counts
            # it: a concat can be elided if its producers write into
            # slices of the joint buffer.  The port's concat is a copy
            # today, so this bound does not count what it moves.
        elif tag in ("conv", "deconv"):
            cs = payload[0] if tag == "deconv" else payload
            kernel, bias = raw
            if kernel.ndim == 2:  # FC stored as [O, K] (mobilenet_v2 head)
                o, kh, kw, icpg = kernel.shape[0], 1, 1, kernel.shape[1]
            else:
                o, kh, kw, icpg = kernel.shape
            if tag == "deconv":
                ho = cs.strides[0] * (h - 1) + kh - sum(cs.padding[0])
                wo = cs.strides[1] * (w - 1) + kw - sum(cs.padding[1])
            else:
                ho = _conv_out(h, kh, cs.padding[0], cs.strides[0])
                wo = _conv_out(w, kw, cs.padding[1], cs.strides[1])
            macs = b * ho * wo * o * kh * kw * icpg
            bytes_ = (b * h * w * c) + kernel.size + (b * ho * wo * o)
            costs.append(OpCost(name, macs, bytes_))
            h, w, c = ho, wo, o
        elif tag == "gemm":
            kernel, bias = raw
            o = kernel.shape[0]
            m = b * h * w if c else b
            macs = m * o * kernel.size // o
            costs.append(OpCost(name, macs, m * kernel.size // o + kernel.size
                                + m * o))
            c = o
        elif tag == "maxpool":
            pool, strides, padding = payload
            hi, wi = h, w
            h = _conv_out(h, pool[0], padding[0], strides[0])
            w = _conv_out(w, pool[1], padding[1], strides[1])
            # Read the whole input, write the output.
            costs.append(OpCost(name, 0, b * hi * wi * c + b * h * w * c))
        elif tag == "avgpool":
            qp, pool, strides, padding = payload
            hi, wi = h, w
            h = _conv_out(h, pool[0], padding[0], strides[0])
            w = _conv_out(w, pool[1], padding[1], strides[1])
            costs.append(OpCost(name, 0, b * hi * wi * c + b * h * w * c))
        elif tag == "gap":
            costs.append(OpCost(name, 0, b * h * w * c + b * c))
            h = w = 1
        elif tag in ("add", "softargmax"):
            # add: two inputs and one output, 3 buffer passes.
            costs.append(OpCost(name, 0, 3 * b * h * w * c))
        elif tag == "shuffle":
            # Zero traffic in the lower bound, as the JAX package counts
            # it: a static permutation can be folded into its neighbours'
            # indexing.  The port's x8zip is a copy today (not counted).
            pass
        elif tag == "flatten":
            c, h, w = h * w * c, 1, 1
    return costs


def total_cost(spec, input_shape) -> OpCost:
    per_op = graph_cost(spec, input_shape)
    return OpCost("total", sum(o.macs for o in per_op),
                  sum(o.bytes_accessed for o in per_op))
