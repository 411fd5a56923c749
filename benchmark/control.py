"""The check's control: the plain reference with its kernels at the lower
precision the configuration names (`control_weight_bits`, 4 for int8), put
in the program's place, at a cell's own sizes and inputs.

    python3 benchmark/control.py --workload <cell> --seeds <n> <n> ...

For each seed it draws the cell's weights and the inputs its check
compares (a closed-loop cell's whole ring, an open-loop cell's
`check_requests` requests from its ring), runs the reference at 8 and at
the control's bits, and prints one JSON line: the output bytes compared
and the control's `mismatched_bytes`, the number the run's check holds at
0.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark import harness, loops, schedule

    cell = harness.load_cell(harness.load_benchmark(ROOT), args.workload,
                             ROOT)
    device = torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")
    ref = importlib.import_module(f"benchmark.reference.{cell.config}")
    shape = tuple(ref.sample_shape(cell.cfg))
    bits = cell.cfg["control_weight_bits"]
    for seed in args.seeds:
        t0 = time.perf_counter()
        gen = torch.Generator(device=device)
        gen.manual_seed(schedule.sub_seed(seed, "weights"))
        weights = ref.draw_weights(cell.cfg, gen, device)
        mix = cell.mix
        if mix["loop"] == "closed_batch":
            xs = loops.seeded_inputs(
                (mix["ring_batches"], mix["batch"]) + shape, seed,
                device).flatten(0, 1)
        else:
            ring = loops.seeded_inputs((mix["ring_requests"],) + shape, seed,
                                       device)
            pick = schedule.rng(seed, "control")
            xs = ring[torch.from_numpy(pick.integers(
                0, len(ring), mix["check_requests"])).to(device)]
        ys = torch.cat([ref.forward(cell.cfg, weights, xs[i:i + 32], bits)
                        for i in range(0, len(xs), 32)])
        bad = harness.compare(ref, cell.cfg, weights, xs, ys, device)
        print(json.dumps(dict(workload=cell.name, seed=seed,
                              weight_bits=bits, compared_bytes=ys.numel(),
                              mismatched_bytes=bad,
                              seconds=time.perf_counter() - t0,
                              device=harness.card_record(device))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
