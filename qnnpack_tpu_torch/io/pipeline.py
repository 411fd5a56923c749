"""Input pipeline: prefetched, preprocessed uint8 batches onto the device -
a port of qnnpack_tpu/io/pipeline.py.

Host work (resize + quantize) runs in the native C++ thread pool
(native/image_prep.cpp) on a worker thread, which also stages each batch
onto the device: a pinned host copy, then a non-blocking copy on a side
stream of the prefetcher's own.  The consumer's stream waits on an event
recorded after that copy, so batch N+1's preprocessing and host-to-device
copy overlap the device's work on batch N.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from ..device import resolve_device
from .native import resize_quantize_batch


class BatchPrefetcher:
    """Wrap a host-batch iterator with a background thread that
    preprocesses batches and stages them onto `device` (default: the GPU;
    device="cpu" hands over CPU tensors)."""

    def __init__(self, source: Iterable[np.ndarray],
                 preprocess: Callable[[np.ndarray], np.ndarray] | None = None,
                 prefetch: int = 2, device="cuda"):
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self._device = dev
        self._stream = (torch.cuda.Stream(device=dev) if dev.type == "cuda"
                        else None)
        self._source = iter(source)
        self._preprocess = preprocess or (lambda x: x)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _stage(self, batch):
        """(tensor on the device, the copy's event or None)."""
        host = torch.from_numpy(np.ascontiguousarray(self._preprocess(batch)))
        if self._stream is None:
            return host.to(self._device), None
        # The caching host allocator keeps a pinned block from reuse until
        # the copies recorded on it have ended.
        host = host.pin_memory()
        with torch.cuda.device(self._device), torch.cuda.stream(self._stream):
            staged = host.to(self._device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        return staged, done

    def _worker(self):
        try:
            for batch in self._source:
                self._q.put(self._stage(batch))
        except Exception as e:  # surface errors on the consumer side
            self._q.put(e)
        finally:
            self._q.put(None)

    def __iter__(self) -> Iterator:
        return self

    def __next__(self) -> torch.Tensor:
        item = self._q.get()
        if item is None:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        staged, done = item
        if done is not None:
            # The consumer's stream reads the batch only after the copy;
            # the side stream's allocation is not reused before that
            # stream's reads end.
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(done)
            staged.record_stream(consumer)
        return staged


def image_pipeline(float_batches: Iterable[np.ndarray], target_hw,
                   scale: float, zero_point: int, prefetch: int = 2,
                   device="cuda") -> BatchPrefetcher:
    """Resize+quantize float NHWC batches in native threads and prefetch the
    uint8 result to the device."""
    return BatchPrefetcher(
        float_batches,
        preprocess=lambda b: resize_quantize_batch(b, target_hw, scale,
                                                   zero_point),
        prefetch=prefetch, device=device)
