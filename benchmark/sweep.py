"""Offer a serving cell's mix at several rates: its knee and its capacity.

    python3 benchmark/sweep.py --workload <serve cell> --seed <n> \
        --seconds <s> --rates <r1> <r2> ...

Sets the cell up once and offers each rate in turn for --seconds on its
open-loop schedule, printing one JSON line a rate: requests sent, failed
(rejected, errored or unanswered), the share answered, p50 and p95 latency,
the mean batch, how late the generator ran, `completed_per_s` (requests
answered over the time until the last was answered, the loop's drain
included), and `growth_ms`, the median latency of the window's last
quarter of requests less that of its second quarter (a queue that grows
through the window shows there), and `sustained`: nothing failed, at least
99% was answered, and `growth_ms` stayed under half of the second
quarter's median (a queue that grows from the start reads more).  Run it
three times or more, each in its own process and with its own seed.  The
knee is the highest rate of the grid that every run sustained, with every
lower rate of the grid; `completed_per_s` at rates above it is what the server
completes under a queue that grows.  A mix's rate is set by hand from
these readings: this script writes nothing.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import importlib

    import numpy as np
    import torch

    from benchmark import harness, loops, schedule
    from benchmark.trace import Tracer

    cell = harness.load_cell(harness.load_benchmark(ROOT), args.workload,
                             ROOT)
    if cell.mix["loop"] != "open_arrivals":
        print(f"sweep: {cell.name} is not an open-loop cell", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    ref = importlib.import_module(f"benchmark.reference.{cell.config}")
    system = importlib.import_module(f"benchmark.systems.{cell.config}")
    gen = torch.Generator(device=device)
    gen.manual_seed(schedule.sub_seed(args.seed, "weights"))
    forward, params = system.build(
        cell.cfg, ref.draw_weights(cell.cfg, gen, device), device)
    loop = loops.OpenArrivals(cell.mix, tuple(ref.sample_shape(cell.cfg)),
                              forward, params, device, args.seed)
    loop.prepare()
    print(json.dumps(dict(card=harness.card_record(device),
                          workload=cell.name)), flush=True)
    try:
        for rate in args.rates:
            w = loop.measure(args.seconds, Tracer(False), rate=rate)
            lat = w.latencies_ms
            q = len(lat) // 4
            base = float(np.median(lat[q:2 * q]))
            growth = float(np.median(lat[3 * q:])) - base
            s = w.stats
            answered = (w.attempted - w.failed) / w.attempted
            p50 = float(np.percentile(lat, 50))
            print(json.dumps(dict(
                rate_per_s=rate, sent=w.attempted, failed=w.failed,
                rejected=s["rejected"], answered=answered, p50_ms=p50,
                p95_ms=float(np.percentile(lat, 95)),
                batch_mean=s["requests"] / max(s["batches"], 1),
                completed_per_s=w.samples / w.seconds,
                drain_s=w.load["drain_s"],
                growth_ms=growth, late_p95_ms=w.load["late_p95_ms"],
                sustained=bool(w.failed == 0 and answered >= 0.99
                               and growth < 0.5 * base))),
                flush=True)
            time.sleep(1.0)
    finally:
        loop.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
