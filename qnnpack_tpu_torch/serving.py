"""Serving runtime: continuous batching and metrics, on the GPU.

A port of qnnpack_tpu/serving.py's InferenceServer: requests arrive one
sample at a time, a dispatcher thread coalesces everything pending (up to
max_batch) into one device step, pads it to a bucket size, and fans the
result rows back out through futures.  A failed step fails every future of
its batch, so a caller that reads each result sees the error.

Admission control: the submit queue is bounded and submit() rejects with
ServerOverloadedError instead of blocking when it is full.
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
from .utils.logging import log_error


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
    returns a tensor whose first axis is n."""

    def __init__(self, forward, sample_shape, *, device="cuda",
                 max_batch: int = 64, buckets=None, max_queue: int = 1024,
                 batch_timeout_s: float = 0.002):
        self._forward = forward
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
        self._stop.set()
        if self._started:
            self._thread.join(timeout=5.0)

    def __enter__(self):
        return self.start()

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
                    y = self._forward(torch.from_numpy(batch).to(self._device))
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
