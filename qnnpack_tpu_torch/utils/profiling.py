"""Profiling: the port's spans and counters, device traces and per-op
analytic cost counters.

`span(name)` and `count(name)` are the program's one recorder of where the
host's time goes.  A span records the host clock (time.perf_counter_ns)
at its start and end; its parent is the span open on the same thread, so
spans nest, and each is aggregated under its path, the chain of the names
that enclose it ("graph.capture/library.load").  The recorder keeps, for
each path, the calls, the total time and the self time (the total less
what its child spans cover), and for each counter its sum - aggregates
only, never one record per call, so its memory grows with the number of
paths the code names and not with the calls.  `totals()`, `counters()`,
`span_total()` and `reset()` read and clear them from any thread.

A span never waits for the device.  While a torch profiler is on (this
module's `trace()`, or any torch.profiler.profile), each span also opens
torch.profiler.record_function("qnnpack::<name>"), so the program's spans
land in the same Chrome trace, on the same clock, as the kernels, copies
and CUDA runtime calls they enclose; the time a span spends opening and
closing its range is in no span's self time.  With no profiler on, a span
costs two clock reads and one update of the aggregates, and a span opened
with `traced_only=True` (the detail of a hot path) costs one check and
records nothing.

The spans and counters the port records:
  library.load   kernels/_build.load_library: finding, building and loading
                 the kernel library; its child library.build when nvcc runs
  setup.pack     nn/packing.pack_gemm_weights, nn/conv.pack_conv_weights:
                 one a packed record
  graph.capture  ops/base.capture: initialize, the eager warm-up run and
                 its synchronize, the capture and the graph's
                 instantiation; counter graph.captures
  runtime.call   ops/base GraphRunner.__call__, a call that replays a
                 graph, only while a profiler is on (a hot path): with its
                 children the input copy (runtime.copy_in), graph.replay()
                 (runtime.replay) and the output clone (runtime.clone_out),
                 and before it JitForward's key walk over the parameters
                 (runtime.key)
  counters q8gemm.launches and q8gemm.wgmma
                 kernels/q8gemm._launch: every launch of q8gemm's plain or
                 row-sum instances, and those that took the wgmma instance
                 (kernels/q8gemm.py wgmma_route); counted when launched,
                 so an eager run and a capture count and a replay does not
  attn.rope, attn.masked, moe.route, moe.experts, moe.combine
                 models/mimo_v2_flash.py: the rotary embedding, the fused
                 masked attention, the router and dispatch,
                 the held experts' grouped GEMMs and SwiGLU, the combine;
                 seen at the warm-up and the capture (a replay runs no
                 Python), and as qnnpack:: ranges under a profiler
  counters moe.grouped_launches and moe.grid_rows
                 kernels/q8gemm.q8gemm_grouped_cuda, kernels/moe.
                 moe_route_cuda: counted only while a graph is captured,
                 the grouped GEMM's launches and the rows an expert
                 layer's worst-case grid covers (held experts x tokens)
  device counter moe.routed_rows (and moe.routed_rows.l<layer>)
                 the held experts' live rows of the last forward, written
                 by moe_route's kernel into a buffer of the model's spec
                 (`watch`); read, with one device-to-host copy, only when
                 counters() is called

A port of qnnpack_tpu/utils/profiling.py besides.  `trace()` wraps
torch.profiler (CPU and CUDA activity) and writes a Chrome trace;
`graph_cost()` counts the MACs and bytes of each layer of a
models.graph.GraphSpec - the roofline numerators, counted as the JAX
package counts them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from pathlib import Path

import torch

PREFIX = "qnnpack::"   # of a span's range in a torch.profiler trace
_profiler_enabled = torch._C._autograd._profiler_enabled
_UNTRACED = contextlib.nullcontext()   # a traced_only span, no profiler on


@dataclasses.dataclass(frozen=True)
class SpanTotal:
    """The aggregate of one span path."""
    calls: int
    total_s: float
    self_s: float


class _Span:
    """One open span (Recorder.span)."""

    __slots__ = ("rec", "name", "stack", "path", "t0", "child_ns",
                 "annotation")

    def __init__(self, rec: "Recorder", name: str):
        self.rec = rec
        self.name = name

    def __enter__(self):
        self.stack = stack = self.rec._stack()
        parent = stack[-1] if stack else None
        self.path = parent.path + "/" + self.name if parent else self.name
        self.child_ns = 0   # the children's time, their ranges' included
        self.annotation = None
        if _profiler_enabled():
            t = time.perf_counter_ns()
            self.annotation = torch.profiler.record_function(
                PREFIX + self.name)
            self.annotation.__enter__()
            if parent is not None:
                parent.child_ns += time.perf_counter_ns() - t
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        elapsed = end - self.t0
        stack = self.stack
        stack.pop()
        parent = stack[-1] if stack else None
        if parent is not None:
            parent.child_ns += elapsed
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
            if parent is not None:
                parent.child_ns += time.perf_counter_ns() - end
        self.rec._add(self.path, elapsed, elapsed - self.child_ns)
        return False


class Recorder:
    """Spans and counters, aggregated by path; thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._spans: dict = {}      # path -> [calls, total_ns, self_ns]
        self._counts: dict = {}
        self._watched: dict = {}    # name -> a device tensor to sum

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _add(self, path: str, total_ns: int, self_ns: int) -> None:
        with self._lock:
            agg = self._spans.get(path)
            if agg is None:
                self._spans[path] = [1, total_ns, self_ns]
            else:
                agg[0] += 1
                agg[1] += total_ns
                agg[2] += self_ns

    def span(self, name: str, traced_only: bool = False):
        """A context manager that records the block as span `name`; with
        `traced_only`, only while a torch profiler is on."""
        if traced_only and not _profiler_enabled():
            return _UNTRACED
        return _Span(self, name)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def totals(self) -> dict:
        """{path: SpanTotal} of every span path recorded."""
        with self._lock:
            return {p: SpanTotal(c, t * 1e-9, s * 1e-9)
                    for p, (c, t, s) in self._spans.items()}

    def watch(self, name: str, tensor: torch.Tensor) -> None:
        """Make `name` a device counter: counters() reports the sum of
        `tensor` as it is then (the latest watch of a name holds)."""
        with self._lock:
            self._watched[name] = tensor

    def counters(self) -> dict:
        """Every counter, and the device counters read now (a copy from
        the device, which waits for the work queued before it)."""
        with self._lock:
            out = dict(self._counts)
            watched = dict(self._watched)
        for name, tensor in watched.items():
            out[name] = int(tensor.sum())
        return out

    def reset(self) -> None:
        """Drop every aggregate and counter (spans still open are recorded
        when they end)."""
        with self._lock:
            self._spans.clear()
            self._counts.clear()
            self._watched.clear()

    def span_total(self, name: str, less: tuple = ()):
        """(calls, seconds) of the spans named `name` that no span of that
        name encloses, less the time of the spans named in `less` nested
        in them (the outermost of those); None when no span `name` was
        recorded."""
        calls, seconds, found = 0, 0.0, False
        for path, t in self.totals().items():
            parts = path.split("/")
            if name not in parts:
                continue
            at = parts.index(name)
            inner = parts[at + 1:]
            if not inner:
                found = True
                calls += t.calls
                seconds += t.total_s
            elif inner[-1] in less and not set(inner[:-1]) & set(less):
                seconds -= t.total_s
        return (calls, seconds) if found else None


RECORDER = Recorder()   # the process's recorder, which the port writes to
span = RECORDER.span
count = RECORDER.count
watch = RECORDER.watch
totals = RECORDER.totals
counters = RECORDER.counters
reset = RECORDER.reset
span_total = RECORDER.span_total


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
