"""The traffic loops: how a mix drives the program under test.

A traffic mix's `loop` names one of these:

  - "closed_batch": one caller runs the captured forward
    (`ops.base.jit_forward`) back to back at `batch` samples, on a ring of
    `ring_batches` distinct seeded batches that live on the device.  The
    window ends with a device synchronize; the outputs of the last pass
    over the ring are checked.
  - "open_arrivals": single-sample requests to `serving.InferenceServer`
    on the schedule of schedule.arrivals, from a generator thread of this
    process, drawn from a host ring of `ring_requests` seeded samples.
    When the schedule has sent its last request the window waits, up to
    `drain_s`, until every accepted request is answered, and its clock is
    read after that wait: every request sent counts, over all that time,
    so work still queued at the schedule's end is neither dropped nor
    counted as done early.  A request is timed from when it was due to
    when its result reaches the client (its future's callback).  A seeded
    sample of `check_requests` is kept for the check; a kept request that
    the server accepted and never answered (or answered with an error) is
    missing.  A rejected request is a failure, not a wrong answer.

Each loop's `prepare` is set-up (inputs, capture, a warm pass of every
shape the window uses); `measure` is the window; `check_data` gives the
inputs and outputs of what the window produced, stacked, and how many
kept answers never came.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from . import schedule


@dataclasses.dataclass
class Window:
    """What one measured window did."""
    seconds: float          # host time of the window
    samples: int            # samples completed
    steps: int              # device steps (forwards) run
    attempted: int
    failed: int
    latencies_ms: np.ndarray | None = None
    stats: dict | None = None   # ServerStats counters over the window
    load: dict | None = None    # the generator's own record


def seeded_inputs(shape: tuple, seed: int, device) -> torch.Tensor:
    """Uniform uint8 inputs of `shape` drawn on `device` from the run's
    seed, in one call."""
    gen = torch.Generator(device=device)
    gen.manual_seed(schedule.sub_seed(seed, "inputs"))
    return torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8,
                         device=device)


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ClosedBatch:
    def __init__(self, mix, sample_shape, forward, params, device, seed):
        from qnnpack_tpu_torch.ops.base import jit_forward
        self.batch, ring = mix["batch"], mix["ring_batches"]
        self.ring = seeded_inputs((ring, self.batch) + sample_shape, seed,
                                  device)
        self.run = jit_forward(forward)
        self.params = params
        self.device = device
        self.outputs = [None] * ring

    def prepare(self):
        with torch.inference_mode():
            self.run(self.params, self.ring[0])
        _synchronize(self.device)

    def measure(self, seconds: float, tracer) -> Window:
        ring, steps = len(self.outputs), 0
        with torch.inference_mode(), tracer.window():
            t0 = time.perf_counter()
            while True:
                i = steps % ring
                self.outputs[i] = self.run(self.params, self.ring[i])
                steps += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            _synchronize(self.device)
            t1 = time.perf_counter()
        n = steps * self.batch
        return Window(seconds=t1 - t0, samples=n, steps=steps, attempted=n,
                      failed=0)

    def check_data(self):
        done = [i for i, y in enumerate(self.outputs) if y is not None]
        return (self.ring[done].flatten(0, 1),
                torch.stack([self.outputs[i] for i in done]).flatten(0, 1), 0)

    def release(self):
        self.run.clear()
        self.ring = self.params = None


class OpenArrivals:
    def __init__(self, mix, sample_shape, forward, params, device, seed):
        from qnnpack_tpu_torch.serving import InferenceServer
        self.mix, self.seed, self.device = mix, seed, device
        self.server = InferenceServer(forward, sample_shape, params=params,
                                      device=device, **mix["server"])
        self.ring = seeded_inputs((mix["ring_requests"],) + sample_shape,
                                  seed, device).cpu().numpy()
        self.kept, self.missing = {}, []

    def prepare(self):
        """Capture every bucket, then send each bucket's size of requests
        at once through the dispatcher, so the window's first batches find
        their copies and graphs warm."""
        self.server.warmup()
        self.server.start()
        for b in self.mix["server"]["buckets"]:
            futs = [self.server.submit(self.ring[i % len(self.ring)],
                                       block=True) for i in range(b)]
            for f in futs:
                f.result(timeout=60)

    def measure(self, seconds: float, tracer, rate: float | None = None
                ) -> Window:
        mix = dict(self.mix, rate_per_s=rate or self.mix["rate_per_s"])
        offsets = schedule.arrivals(mix, seconds, self.seed)
        n = len(offsets)
        pick = schedule.rng(self.seed, "requests")
        image = pick.integers(0, len(self.ring), n)
        keep = set(pick.choice(n, min(n, mix["check_requests"]),
                               replace=False).tolist())
        done = np.full(n, np.nan)
        sent = np.full(n, np.nan)
        failed = np.zeros(n, bool)
        rejected = np.zeros(n, bool)
        state = dict(answered=0, accepted=0)
        lock = threading.Lock()
        kept = {}

        def on_done(j, fut):
            t = time.perf_counter()
            if fut.exception() is not None:
                failed[j] = True
            else:
                done[j] = t
            with lock:
                if j in keep and not failed[j]:
                    kept[j] = np.array(fut.result())
                state["answered"] += 1

        def generate(t0):
            from qnnpack_tpu_torch.serving import ServerOverloadedError
            for j in range(n):
                wait = t0 + offsets[j] - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                sent[j] = time.perf_counter()
                try:
                    fut = self.server.submit(self.ring[image[j]])
                except ServerOverloadedError:
                    failed[j] = rejected[j] = True
                    continue
                with lock:
                    state["accepted"] += 1
                fut.add_done_callback(lambda f, j=j: on_done(j, f))

        counters = ("requests", "batches", "rows_computed", "rows_useful",
                    "rejected")

        def read_stats():
            return {k: getattr(self.server.stats, k) for k in counters}

        stats0 = read_stats()
        with tracer.window():
            t0 = time.perf_counter()
            gen = threading.Thread(target=generate, args=(t0,),
                                   name="bench-generator")
            gen.start()
            gen.join()
            t1 = time.perf_counter()
            deadline = t1 + mix["drain_s"]
            while time.perf_counter() < deadline:
                with lock:
                    if state["answered"] >= state["accepted"]:
                        break
                time.sleep(0.005)
            t_end = time.perf_counter()
        with lock:
            self.kept = {j: (self.ring[image[j]], y) for j, y in kept.items()}
            self.missing = sorted(j for j in keep - set(kept)
                                  if not rejected[j])
            lost = np.isnan(done) & ~failed
            failed |= lost
            stats1 = read_stats()
        starts = t0 + offsets
        lat = np.where(failed, t_end - starts, done - starts) * 1e3
        late = (sent - starts) * 1e3
        return Window(
            seconds=t_end - t0, samples=int((~failed).sum()),
            steps=stats1["batches"] - stats0["batches"], attempted=n,
            failed=int(failed.sum()), latencies_ms=lat,
            stats={k: stats1[k] - stats0[k] for k in counters},
            load=dict(rate_per_s=mix["rate_per_s"], sent=n,
                      send_s=t1 - t0, drain_s=t_end - t1,
                      late_p50_ms=float(np.nanpercentile(late, 50)),
                      late_p95_ms=float(np.nanpercentile(late, 95)),
                      late_max_ms=float(np.nanmax(late))))

    def check_data(self):
        js = sorted(self.kept)
        xs = torch.from_numpy(np.stack([self.kept[j][0] for j in js]))
        ys = torch.from_numpy(np.stack([self.kept[j][1] for j in js]))
        return xs, ys, len(self.missing)

    def release(self):
        self.server.stop()
        self.server = None


LOOPS = {"closed_batch": ClosedBatch, "open_arrivals": OpenArrivals}
