"""Low-noise device-time measurement: a port of qnnpack_tpu/utils/timing.py.

1. The per-launch host cost is measured directly, once a device: the median
   and p10-p90 spread of 15 synchronized launches of a trivial op on an
   8 x 128 uint8 tensor (`dispatch_overhead`).  It sizes the noise floor;
   it is not subtracted from workload timings.
2. The workload runs in loops of n and 2n calls; the time per call is
   (median t(2n) - median t(n)) / n, which cancels the launch cost of a
   loop.  On CUDA tensors each loop is one captured CUDA graph (the
   jitted lax.scan's counterpart), replayed between two CUDA events; on
   CPU tensors the loops run eagerly, timed with perf_counter.  A CUDA
   tensor never takes the eager route: if the capture fails, the
   measurement raises.  n is a power of two, sized so that the difference
   is at least max(min_seconds, 50x the launch spread).
3. The difference must be positive, and the relative spread of the
   interleaved runs comes with every value.

Four perturbed copies of the input (XOR with 0..3 for integers, + 0..3
times 1e-6 for floats) are made before the loops and used in turn, so no
two neighbouring calls read the same bytes.  `chain=True` feeds each output
into the next call instead (same shape and dtype); `chain=False` adds a sum
of each output (int32, or float32 for floats) into an accumulator on the
device, so every output is written.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import statistics
import time

import torch


@dataclasses.dataclass(frozen=True)
class Measurement:
    seconds: float          # device time per call (two-point method)
    dispersion: float       # summed (max-min) spread of both loops / delta
    n_iters: int            # shorter loop length n (the other loop is 2n)
    samples: tuple          # differenced per-call samples (t2n_k - tn_k)/n

    def rate(self, items_per_iter: float) -> float:
        return items_per_iter / self.seconds


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@functools.cache
def _dispatch_overhead(device: torch.device) -> tuple:
    x = torch.zeros((8, 128), dtype=torch.uint8, device=device)
    x.add(1)
    _sync(device)
    ts = []
    for _ in range(15):
        t0 = time.perf_counter()
        x.add(1)
        _sync(device)
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[7], ts[13] - ts[1]


def dispatch_overhead(device="cuda") -> tuple:
    """(median, p90-p10 spread) in seconds of one synchronized launch of a
    trivial op (+1 on an 8 x 128 uint8 tensor) on `device`."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _dispatch_overhead(device)


def _leaves(x) -> list:
    return list(x) if isinstance(x, (tuple, list)) else [x]


def _perturbed(x) -> list:
    """Four copies of `x` (a tensor or a tuple of tensors), the i-th XOR i
    (integers) or + i * 1e-6 (floats)."""
    def one(t, i):
        if t.dtype.is_floating_point:
            return t + i * 1e-6
        return t ^ i
    if isinstance(x, (tuple, list)):
        return [type(x)(one(t, i) for t in x) for i in range(4)]
    return [one(x, i) for i in range(4)]


def _run_loop(fn, copies, n: int, chain: bool, acc: dict):
    if chain:
        v = copies[0]
        for _ in range(n):
            v = fn(v)
        return v
    for i in range(n):
        for leaf in _leaves(fn(copies[i & 3])):
            dtype = (torch.float32 if leaf.dtype.is_floating_point
                     else torch.int32)
            acc[dtype].add_(leaf.sum(dtype=dtype))
    return acc


class _Loop:
    """n calls of fn: a captured CUDA graph on a CUDA device, else an eager
    loop.  Calling it runs the loop once and returns its seconds."""

    def __init__(self, fn, copies, n, chain, device):
        self.device = device
        acc = {dt: torch.zeros((), dtype=dt, device=device)
               for dt in (torch.int32, torch.float32)}
        self.run = lambda: _run_loop(fn, copies, n, chain, acc)
        if device.type == "cuda":
            from ..ops.base import capture
            self.graph = capture(self.run, device).graph
            self.graph.replay()   # first replay uploads the graph
        else:
            self.run()
        _sync(device)

    def __call__(self) -> float:
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            self.run()
            return time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        self.graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3


def measure_loop(fn, x, *, chain: bool = False, min_seconds: float = 0.3,
                 repeats: int = 5, max_iters: int = 1 << 17,
                 min_iters: int = 4,
                 est_seconds: float | None = None) -> Measurement:
    """Time per call of ``fn(x)`` on x's device; see the module doc.

    ``x`` is a tensor or a tuple of tensors (fn unpacks it).
    ``est_seconds``: the caller's estimate of the time per call, used to
    size n without a calibration step (a 2x-off estimate only moves n one
    power of two)."""
    device = _leaves(x)[0].device
    _, spread = dispatch_overhead(device)
    target = max(min_seconds, 50.0 * spread)
    with torch.no_grad():
        copies = _perturbed(x)

        def build(n):
            return _Loop(fn, copies, n, chain, device)

        if est_seconds is not None:
            est = max(est_seconds, 1e-9)
        else:
            # Calibrate: difference two short loops.
            n_cal = 256
            c1, c2 = build(n_cal), build(2 * n_cal)
            t1 = min(c1() for _ in range(2))
            t2 = min(c2() for _ in range(2))
            est = max((t2 - t1) / n_cal, 1e-9)
            del c1, c2

        for _ in range(4):
            n = 1 << max(math.ceil(math.log2(target / est)), 2)
            n = max(min(n, max_iters), min_iters)
            lo, hi = build(n), build(2 * n)
            # Interleave to decorrelate drift between the two loop lengths.
            ts_lo, ts_hi = [], []
            for _ in range(repeats):
                ts_lo.append(lo())
                ts_hi.append(hi())
            del lo, hi
            delta = statistics.median(ts_hi) - statistics.median(ts_lo)
            jitter = ((max(ts_lo) - min(ts_lo))
                      + (max(ts_hi) - min(ts_hi))) / 2
            # Accept when the difference clears the sizing target, or when
            # it clears both 10x the run-to-run jitter and 50x the launch
            # spread.
            floor = min(target, max(50.0 * spread, 10 * jitter))
            if n >= max_iters or (delta > 0 and delta >= floor):
                break
            # Too small against the noise: re-estimate, longer loop.
            est = max(delta / n, est / 8, 1e-9)

    if delta <= 0:
        raise RuntimeError(
            f"non-positive marginal time {delta:.3e}s between n={n} and "
            f"n={2 * n}; launch cost dominates - raise min_seconds or "
            f"max_iters")
    dispersion = ((max(ts_hi) - min(ts_hi))
                  + (max(ts_lo) - min(ts_lo))) / delta
    return Measurement(seconds=delta / n, dispersion=dispersion, n_iters=n,
                       samples=tuple((h - l) / n
                                     for h, l in zip(ts_hi, ts_lo)))
