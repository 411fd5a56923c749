"""The traced run: torch.profiler over the measured window, reduced to what
the per-layer metrics read.

The profiler (CPU and CUDA activity) runs around the whole window; a
`bench.window` range marks the window itself.  Its Chrome trace is written
under the run's temporary directory, read back and deleted.  The reduction
works on the trace's event list:

  - busy: the union of the device's kernels, copies and fills inside the
    window (one card; overlapping streams count once);
  - device time by operation: kernels by their function name, copies by
    kind, clipped to the window;
  - idle gaps: the stretches of the window with nothing on the device,
    named by the host call that launched the next device operation
    (`cudaGraphLaunch -> q8gemm_kernel`) and summed by name.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import re
import tempfile

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_s: dict      # short name -> seconds in the window
    kernel_s: dict      # kernels only: short name -> seconds
    idle_gaps: dict     # label -> seconds

    def top(self, table: dict, n: int = 10) -> list:
        return [[k, v] for k, v in sorted(table.items(),
                                          key=lambda kv: -kv[1])[:n]]


@functools.lru_cache(maxsize=4096)
def short_name(name: str) -> str:
    """A kernel's function name without return type, namespaces, template
    arguments or parameters ("void (anonymous namespace)::q8gemm_kernel<
    ...>(...)" -> "q8gemm_kernel"); a copy or fill keeps its name."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = re.sub(r"^void\s+", "", name.strip())
    name = name.replace("(anonymous namespace)::", "")
    m = re.match(r"[A-Za-z_][\w:]*", name)
    return name if m is None else m.group(0).split("::")[-1]


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events: list) -> TraceSummary:
    """Reduce a Chrome-trace event list (times in microseconds) to the
    window's busy time, device time by operation and idle gaps."""
    spans = [e for e in events if e.get("name") == WINDOW
             and e.get("ph") == "X" and e.get("cat") != "gpu_user_annotation"]
    if not spans:
        raise ValueError(f"no {WINDOW!r} range in the trace")
    w0 = float(spans[0]["ts"])
    w1 = w0 + float(spans[0]["dur"])
    host = {}
    for e in events:
        if e.get("cat") in HOST_CATS and "correlation" in e.get("args", {}):
            host[e["args"]["correlation"]] = e["name"]
    device_s, kernel_s, ops = {}, {}, []
    for e in events:
        if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        name = short_name(e["name"])
        device_s[name] = device_s.get(name, 0.0) + (b - a) * 1e-6
        if e["cat"] == "kernel":
            kernel_s[name] = kernel_s.get(name, 0.0) + (b - a) * 1e-6
        launcher = host.get(e.get("args", {}).get("correlation"), "host")
        ops.append((a, b, f"{launcher} -> {name}"))
    busy = _union([[a, b] for a, b, _ in ops])
    gaps = {}
    ops.sort()
    at, i = w0, 0
    for a, b in busy:
        if a > at:
            while i < len(ops) and ops[i][0] < a:
                i += 1
            label = ops[i][2] if i < len(ops) else "host"
            gaps[label] = gaps.get(label, 0.0) + (a - at) * 1e-6
        at = b
    if w1 > at:
        gaps["window end"] = gaps.get("window end", 0.0) + (w1 - at) * 1e-6
    return TraceSummary(window_s=(w1 - w0) * 1e-6,
                        busy_s=sum(b - a for a, b in busy) * 1e-6,
                        device_s=device_s, kernel_s=kernel_s, idle_gaps=gaps)


class Tracer:
    """Profile a block on the card when `enabled`; `window()` marks the
    measured window inside it; `summary` is set on exit."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.summary = None
        self._prof = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.__enter__()
        return self

    def window(self):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(WINDOW)

    def __exit__(self, *exc):
        if not self.enabled:
            return False
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self._prof = None
        self.summary = summarize(events)
        return False
