"""Serving runtime: continuous batching, health checks and metrics, on the
GPU.  A port of qnnpack_tpu/serving.py.

  - InferenceServer: requests arrive one sample at a time, a dispatcher
    thread coalesces everything pending (up to max_batch) into one device
    step, pads it to a bucket size, and fans the result rows back out
    through futures.  Each bucket runs through ops.base.jit_forward: one
    CUDA graph per bucket, captured at its first use (or by warmup()),
    so every step replays a cached graph, as every JAX step hits a cached
    jit executable.  A failed step fails every future of its batch, so a
    caller that reads each result sees the error.
  - Admission control: the submit queue is bounded and submit() rejects
    with ServerOverloadedError instead of blocking when it is full.
  - HealthMonitor: heartbeat failure detection - a probe runs a tiny op
    on each device every interval; a failed or late probe marks the
    system unhealthy and calls a recovery callback.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from .device import resolve_device
from .ops.base import jit_forward
from .utils.logging import log_error, log_info


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class ServerOverloadedError(RuntimeError):
    """submit() admission rejection: the bounded request queue is full."""


@dataclasses.dataclass
class ServerStats:
    requests: int = 0
    batches: int = 0
    rows_computed: int = 0
    rows_useful: int = 0
    rejected: int = 0  # admission-control rejections (queue full)
    # Sliding window: percentiles over the most recent max_latency_samples
    # completions, so a long-lived server's memory stays bounded.
    max_latency_samples: int = 65536
    latencies_ms: "collections.deque" = None  # set in __post_init__

    def __post_init__(self):
        if self.latencies_ms is None:
            self.latencies_ms = collections.deque(
                maxlen=self.max_latency_samples)

    @property
    def occupancy(self) -> float:
        """Useful rows / computed rows (padding waste complement)."""
        return self.rows_useful / max(self.rows_computed, 1)

    def latency_percentile(self, p: float) -> float:
        if not self.latencies_ms:
            return 0.0
        return float(np.percentile(np.asarray(self.latencies_ms), p))


class InferenceServer:
    """Continuous-batching server around forward(x) -> y on `device`.

    forward takes a uint8 tensor [n, *sample_shape] on the device and
    returns a tensor whose first axis is n; on the GPU it runs as one CUDA
    graph per bucket (jit_forward), so it must be capturable.  With
    `params`, the server calls forward(params, x) and the parameters are
    part of each graph's key (JitForward.key): a record replaced in them,
    or a scalar changed, misses and is captured anew.  Without, whatever
    forward closes over is baked into each bucket's graph at its capture
    and must stay as it is while the server lives."""

    def __init__(self, forward, sample_shape, *, params=None, device="cuda",
                 max_batch: int = 64, buckets=None, max_queue: int = 1024,
                 batch_timeout_s: float = 0.002):
        self._forward = jit_forward(forward)
        self._params = () if params is None else (params,)
        self._device = resolve_device(device)
        self._sample_shape = tuple(sample_shape)
        if buckets is None:
            buckets = []
            b = 1
            while b < max_batch:
                buckets.append(b)
                b *= 2
            buckets.append(max_batch)
        self._buckets = sorted(set(buckets))
        self._max_batch = self._buckets[-1]
        self._queue: queue.Queue = queue.Queue(maxsize=max_queue)
        self._batch_timeout_s = batch_timeout_s
        self.stats = ServerStats()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        name="qnnpack-torch-dispatcher",
                                        daemon=True)
        self._started = False
        self._lock = threading.Lock()

    # -- client API -------------------------------------------------------
    def start(self):
        if not self._started:
            self._started = True
            self._thread.start()
        return self

    def stop(self):
        """Stop the dispatcher and release the buckets' graphs."""
        self._stop.set()
        if self._started:
            self._thread.join(timeout=5.0)
        self._forward.clear()

    def __enter__(self):
        return self.start()

    def warmup(self):
        """Run every bucket once on zeros, which on the GPU captures each
        bucket's graph ahead of traffic."""
        with torch.inference_mode():
            for b in self._buckets:
                self._forward(*self._params, torch.zeros(
                    (b,) + self._sample_shape, dtype=torch.uint8,
                    device=self._device))
        return self

    @property
    def captured(self) -> list:
        """The buckets whose graphs are captured (a key's last part is
        the batch's shape, dtype and device)."""
        return sorted(key[-1][0][0] for key in self._forward.graphs)

    def __exit__(self, *exc):
        self.stop()

    def submit(self, x: np.ndarray, *, block: bool = False) -> Future:
        """Enqueue one sample of sample_shape; returns a Future of its
        result row.  When the bounded queue is full the request is rejected
        with ServerOverloadedError; block=True waits for room instead."""
        if tuple(x.shape) != self._sample_shape:
            raise ValueError(
                f"sample shape {x.shape} != expected {self._sample_shape}")
        fut: Future = Future()
        item = (np.asarray(x), time.perf_counter(), fut)
        try:
            if block:
                self._queue.put(item)
            else:
                self._queue.put_nowait(item)
        except queue.Full:
            with self._lock:
                self.stats.rejected += 1
            raise ServerOverloadedError(
                f"request queue full ({self._queue.maxsize} pending); "
                "shed or retry with backoff") from None
        return fut

    def infer(self, x: np.ndarray, timeout: float = 60.0):
        """Blocking single-sample call: waits for room in the queue rather
        than rejecting (a caller already blocking on the result wants
        backpressure, not an error)."""
        return self.submit(x, block=True).result(timeout=timeout)

    # -- dispatcher -------------------------------------------------------
    def _drain(self):
        """Collect everything pending (>=1, <= max_batch), waiting briefly
        so concurrent arrivals coalesce."""
        items = []
        try:
            items.append(self._queue.get(timeout=0.05))
        except queue.Empty:
            return items
        deadline = time.perf_counter() + self._batch_timeout_s
        while len(items) < self._max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                items.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return items

    def _dispatch_loop(self):
        while not self._stop.is_set():
            items = self._drain()
            if not items:
                continue
            n = len(items)
            b = _bucket(n, self._buckets)
            batch = np.zeros((b,) + self._sample_shape, np.uint8)
            for i, (x, _, _) in enumerate(items):
                batch[i] = x
            try:
                with torch.inference_mode():
                    y = self._forward(*self._params, torch.from_numpy(
                        batch).to(self._device))
                    y = y.cpu().numpy()
            except Exception as exc:  # noqa: BLE001 - fan failure out
                log_error("serving batch failed: %s", exc, exc_info=True)
                for _, _, fut in items:
                    fut.set_exception(exc)
                continue
            now = time.perf_counter()
            with self._lock:
                self.stats.requests += n
                self.stats.batches += 1
                self.stats.rows_computed += b
                self.stats.rows_useful += n
                for _, t0, _ in items:
                    self.stats.latencies_ms.append((now - t0) * 1e3)
            for i, (_, _, fut) in enumerate(items):
                fut.set_result(y[i])


class HealthMonitor:
    """Heartbeat failure detector for the serving devices.

    Probes each device of `devices` (every CUDA device by default) every
    `interval_s` with a tiny computation - an 8-element int32 tensor whose
    sum is read back to the host; if the probe raises or takes longer than
    `deadline_s`, the monitor marks the system unhealthy and calls
    `on_failure` (e.g. re-create the server)."""

    def __init__(self, *, interval_s: float = 5.0, deadline_s: float = 30.0,
                 on_failure=None, devices=None):
        self._interval_s = interval_s
        self._deadline_s = deadline_s
        self._on_failure = on_failure
        if devices is None:
            resolve_device("cuda")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        self._devices = [resolve_device(d) for d in devices]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="qnnpack-torch-heartbeat",
                                        daemon=True)
        self.healthy = True
        self.probes = 0
        self.failures = 0

    def probe_once(self) -> bool:
        """One synchronous heartbeat: a device round trip of a tiny op."""
        t0 = time.perf_counter()
        try:
            for d in self._devices:
                int(torch.ones((8,), dtype=torch.int32, device=d).sum())
            ok = (time.perf_counter() - t0) <= self._deadline_s
        except Exception as exc:  # noqa: BLE001 - any device error = failure
            log_error("heartbeat probe failed: %s", exc)
            ok = False
        self.probes += 1
        if not ok:
            self.failures += 1
            if self.healthy:
                self.healthy = False
                log_error("device marked UNHEALTHY after failed heartbeat")
                if self._on_failure is not None:
                    self._on_failure()
        else:
            if not self.healthy:
                log_info("device recovered; marking healthy")
            self.healthy = True
        return ok

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=self._interval_s + 1.0)

    def _loop(self):
        while not self._stop.wait(self._interval_s):
            self.probe_once()
