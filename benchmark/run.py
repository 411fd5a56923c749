"""Run one cell of the benchmark once and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is a `workloads` entry of BENCHMARK.json.  The run builds the
configuration's weights and inputs from the seed, sets the program
(qnnpack_tpu_torch) up and warms it, measures for --seconds, checks what
the window produced against the plain reference, and prints one JSON line
last on standard output: the cell's end-to-end metrics, or with --trace 1
its per-layer metrics from a torch.profiler trace of the window.  The
numbers compared in the check are the last lines of standard error.

It needs as many CUDA devices as the cell asks for; without them, or if
JAX or the JAX package were loaded, it exits non-zero and prints no
result.  Build and kernel caches stay inside the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = Path(__file__).resolve().parent / ".cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark import harness

    bench = harness.load_benchmark(ROOT)
    cell = harness.load_cell(bench, args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"run: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result, lines = harness.run_cell(
        cell, args.seed, args.seconds, bool(args.trace),
        torch.device("cuda", 0), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"run: JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    print("\n".join(lines), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
