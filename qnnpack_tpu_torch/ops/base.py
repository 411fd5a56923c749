"""Operator lifecycle: a port of qnnpack_tpu/ops/base.py.

QNNPACK's create -> setup -> run -> delete lifecycle
(include/qnnpack.h:40-332) maps onto:

  create -> validate params (the same self-explaining rejection messages
            and exception types as the JAX package), precompute
            quantization params and tables, and put them on `device`
            (the GPU unless the caller asks for the CPU)
  setup  -> `op.lower(*inputs)` captures the run at those shapes as a
            CUDA graph (`jit_forward`; the JAX package's per-shape jit
            trace), on the GPU only
  run    -> `op(*inputs)`: a replay of the graph where the operator was
            lowered at those shapes; else the kernels (the plain path on
            the CPU), eagerly.  A graph of one operator is no faster than
            its launches: the copy into its input buffer and the clone of
            its output cost more device time than the host time it saves
            (PERF.md, phase 6 of chip_smoke.py), so capture is the
            caller's choice, as for any forward
  delete -> `op.delete()` releases the operator's device tensors and its
            graphs; a deleted operator raises UninitializedError when run

`jit_forward(fn)` is the counterpart of `jax.jit(fn)` for any forward:
the whole call captured once per input shape and replayed as one launch.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import math
import threading
import weakref

import torch

from ..device import resolve_device
from ..status import (InvalidParameterError, UninitializedError,
                      UnsupportedParameterError)
from ..utils.profiling import count, span


def check(cond: bool, message: str):
    """Validation with reference-style diagnostics (every rejected parameter
    explains itself; cf. convolution.c:76-168)."""
    if not cond:
        raise InvalidParameterError(message)


def check_supported(cond: bool, message: str):
    if not cond:
        raise UnsupportedParameterError(message)


def check_scale(scale: float, name: str):
    check(scale > 0.0 and math.isfinite(scale),
          f"failed to create operator with {scale:.7g} {name} scale: "
          f"scale must be finite and positive")


def check_range(output_min: int, output_max: int):
    check(0 <= output_min <= 255 and 0 <= output_max <= 255
          and output_min <= output_max,
          f"failed to create operator with [{output_min}, {output_max}] "
          f"output range: range min must be below range max within [0, 255]")


def check_zero_point(zp: int, name: str):
    check(0 <= zp <= 255,
          f"failed to create operator with {zp} {name} zero point: "
          f"zero point must be in [0, 255]")


class Operator:
    """Base operator.  A subclass validates its parameters, then calls
    `super().__init__(device)`, builds its tables on `self.device` and
    implements `_forward`; `_tensors` names the attributes that `delete`
    releases.  A run replays the graph of `jit_forward(self._forward)` at
    the shapes the operator was lowered at, and runs eagerly at others."""

    name = "operator"
    _tensors: tuple = ()

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._deleted = False
        self._jitted = jit_forward(self._forward)

    def _forward(self, *inputs):
        raise NotImplementedError

    def _check_inputs(self, inputs):
        if self._deleted:
            raise UninitializedError(
                f"failed to run {self.name} operator: it has been deleted")
        for x in inputs:
            if not isinstance(x, torch.Tensor) or x.dtype != torch.uint8:
                raise TypeError(f"{self.name} operator takes uint8 tensors, "
                                f"got {type(x).__name__}")
            if x.device.type != self.device.type:
                raise ValueError(f"{self.name} operator lives on "
                                 f"{self.device}, input on {x.device}")

    def __call__(self, *inputs):
        self._check_inputs(inputs)
        runner = self._jitted.cached(*inputs)
        return self._forward(*inputs) if runner is None else runner(*inputs)

    def lower(self, *example_inputs) -> "GraphRunner":
        """Capture the run at the example inputs' shapes (the JAX `lower`):
        returns the CUDA-graph runner, which later runs at those shapes
        replay.  GPU operators only."""
        self._check_inputs(example_inputs)
        return self._jitted.lower(*example_inputs)

    def delete(self):
        """Parity with qnnp_delete_operator (operator-delete.c): releases
        the operator's device tensors and its captured graphs."""
        self._jitted.clear()
        for attr in self._tensors:
            setattr(self, attr, None)
        self._deleted = True


# ------------------------------------------------------------ jit_forward
_NUMBERS = (bool, int, float, complex)
_SCALARS = (str, bytes, type(None), enum.Enum, torch.dtype, torch.device)


def _param_key(obj, memo: dict):
    """What a non-input argument adds to a call's key.  A graph bakes in the
    addresses of the tensors it read and the scalars that its launches
    read on the host (requant multipliers, say), so the key holds:
      - a tensor as its (data_ptr, shape, dtype);
      - a number with its type, and any other scalar as itself;
      - a list, tuple or dict (by its keys and values), and a dataclass
        that is not frozen, by its items, walked on every call, since they
        can be replaced;
      - anything else by identity: a frozen dataclass (the packed records
        and requant params) cannot be given new fields, so a record with
        other tensors or scalars is another object.  The memo keeps each
        such object alive, so its id is not reused.  A new object misses
        the cache; one changed in place (a numpy array, say) is not seen.
    """
    if isinstance(obj, torch.Tensor):
        return (obj.data_ptr(), tuple(obj.shape), obj.dtype)
    if id(obj) in memo:
        return id(obj)
    if isinstance(obj, _NUMBERS):
        return (type(obj), obj)
    if isinstance(obj, _SCALARS):
        return obj
    if isinstance(obj, (list, tuple)):
        return (type(obj), tuple([_param_key(v, memo) for v in obj]))
    if isinstance(obj, dict):
        return (dict, tuple([(k, _param_key(v, memo))
                             for k, v in obj.items()]))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type) and \
            not obj.__dataclass_params__.frozen:
        return (type(obj), tuple([_param_key(getattr(obj, f.name), memo)
                                  for f in dataclasses.fields(obj)]))
    memo.setdefault(id(obj), obj)
    return id(obj)


def _map_tensors(fn, out):
    """`fn` applied to a tensor, or to each tensor of a tuple or list."""
    if isinstance(out, torch.Tensor):
        return fn(out)
    if isinstance(out, (tuple, list)):
        return type(out)(_map_tensors(fn, o) for o in out)
    raise TypeError(f"a captured forward returns tensors, got "
                    f"{type(out).__name__}")


@dataclasses.dataclass
class Capture:
    """One captured CUDA graph: `output` is its static output, `launches`
    the kernel launches that its capture recorded (kernels.launch_counts'
    difference across it; a replay adds none), `counters` the split-K
    counters of its q8gemm and q8conv launches, its own."""

    graph: "torch.cuda.CUDAGraph"
    output: object
    launches: dict
    counters: torch.Tensor


def capture(run, device) -> Capture:
    """Capture `run()` (no arguments; it launches on the current stream) as
    a CUDA graph on `device`.

    Before the capture: the kernel library is built (config.initialize),
    and `run` runs once, eagerly, on the capture stream - the warm-up that
    fills every cache a launch reads (per-channel scales, SM counts, each
    kernel's shared-memory attribute) outside the capture.  During it, the
    split-K counters of every launch are the graph's own
    (kernels/q8gemm.py:graph_counters), so two graphs replayed at once on
    two streams never share a counter.  Recorded as the span graph.capture
    and the counter graph.captures (utils/profiling.py)."""
    from ..config import initialize
    from ..kernels import launch_counts
    from ..kernels.q8gemm import graph_counters, new_counters

    with span("graph.capture"), torch.no_grad():
        initialize(device)
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            run()
        stream.synchronize()
        counters = new_counters(device)
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        with graph_counters(counters), torch.cuda.graph(
                graph, stream=stream, capture_error_mode="thread_local"):
            output = run()
        after = launch_counts()
    count("graph.captures")
    return Capture(graph, output, {k: after[k] - before[k] for k in after},
                   counters)


class GraphRunner:
    """A forward captured at one key: each call copies the inputs into the
    graph's static input buffers, replays the graph and returns a clone of
    its static output, so an output the caller keeps is never overwritten
    by the next call (JAX returns a fresh array too).  Calls on several
    streams or threads run one after another: each waits on the device for
    the last replay to end.  While a profiler is on, a call is recorded as
    the span runtime.call, with runtime.copy_in, runtime.replay and
    runtime.clone_out inside it (utils/profiling.py); with none on, a
    call records nothing (a b1 call is ~0.1 ms of host work)."""

    def __init__(self, fn, args, input_index):
        device = args[input_index[0]].device
        self.device = device
        with torch.inference_mode(False):
            self.inputs = [args[i].clone() for i in input_index]
        call = list(args)
        for i, buf in zip(input_index, self.inputs):
            call[i] = buf
        cap = capture(lambda: fn(*call), device)
        self.graph, self.output = cap.graph, cap.output
        self.launches, self.counters = cap.launches, cap.counters
        self._done = torch.cuda.Event()
        self._lock = threading.Lock()

    def __call__(self, *inputs):
        stream = torch.cuda.current_stream(self.device)
        with span("runtime.call", traced_only=True), self._lock, \
                torch.no_grad():
            stream.wait_event(self._done)
            with span("runtime.copy_in", traced_only=True):
                for buf, x in zip(self.inputs, inputs):
                    buf.copy_(x)
            with span("runtime.replay", traced_only=True):
                self.graph.replay()
            with span("runtime.clone_out", traced_only=True):
                out = _map_tensors(torch.clone, self.output)
            self._done.record(stream)
        return out


# Every JitForward alive, for clear_all_graphs.
_JIT_FORWARDS = weakref.WeakSet()


class JitForward:
    """`fn` run as one CUDA graph per key (see jit_forward)."""

    def __init__(self, fn):
        self.fn = fn
        self.graphs: dict = {}
        self._memo: dict = {}
        self._lock = threading.Lock()
        functools.update_wrapper(self, fn)
        _JIT_FORWARDS.add(self)

    def key(self, *args) -> tuple:
        """The cache key of a call: each tensor argument's shape, dtype and
        device, and for every other argument (the parameters) the tensors,
        scalars and records inside it (_param_key).  A graph bakes in the
        addresses and the host-side values it read, so a call with new
        parameters misses the cache and never replays the old ones."""
        return tuple((tuple(a.shape), a.dtype, a.device)
                     if isinstance(a, torch.Tensor)
                     else _param_key(a, self._memo) for a in args)

    def _runner(self, args, input_index) -> GraphRunner:
        with span("runtime.key", traced_only=True):
            key = self.key(*args)
        with self._lock:
            runner = self.graphs.get(key)
            if runner is None:
                runner = GraphRunner(self.fn, args, input_index)
                self.graphs[key] = runner
        return runner

    @staticmethod
    def _inputs(args):
        index = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
        on = {args[i].device.type for i in index}
        if len(on) > 1:
            raise ValueError(f"inputs on several devices: {sorted(on)}")
        return index, on == {"cuda"}

    def __call__(self, *args):
        index, cuda = self._inputs(args)
        if not cuda or torch.cuda.is_current_stream_capturing():
            # CPU inputs run eagerly; inside another capture, the calls
            # are that graph's.
            return self.fn(*args)
        return self._runner(args, index)(*(args[i] for i in index))

    def cached(self, *args):
        """The runner already captured for a call at `args`, or None (also
        on CPU inputs and inside another capture)."""
        if not self.graphs or torch.cuda.is_current_stream_capturing() \
                or not self._inputs(args)[1]:
            return None
        return self.graphs.get(self.key(*args))

    def lower(self, *args) -> GraphRunner:
        """Capture the call at `args` (if not cached) and return its
        runner."""
        index, cuda = self._inputs(args)
        if not cuda:
            raise ValueError("a CUDA graph is captured from CUDA inputs")
        return self._runner(args, index)

    def clear(self):
        """Drop every captured graph (the JAX `clear_cache`)."""
        with self._lock:
            self.graphs.clear()
            self._memo.clear()


def clear_all_graphs() -> int:
    """Drop the captured graphs of every JitForward alive (the JAX
    `jax.clear_caches()`), as after a device restart; returns how many
    forwards were cleared."""
    forwards = list(_JIT_FORWARDS)
    for jf in forwards:
        jf.clear()
    return len(forwards)


def jit_forward(fn) -> JitForward:
    """The port's jax.jit(fn): a callable with fn's signature that, on CUDA
    inputs, captures one torch.cuda.CUDAGraph per key (JitForward.key:
    input shapes, dtypes and device, and the tensors, scalars and records
    among the other arguments) after an eager warm-up, and replays it; a
    capture that fails raises.  The tensor arguments are the inputs,
    copied into the graph's buffers on each call; everything else is
    passed as captured.  What fn reads from its closure is not in the key:
    it is baked into each graph and must not change while the graphs live.
    On CPU inputs it calls fn eagerly."""
    return fn if isinstance(fn, JitForward) else JitForward(fn)
