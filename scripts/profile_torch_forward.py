#!/usr/bin/env python3
"""Where the time of the port's MobileNetV2 forward goes, on the GPU.

    python3 scripts/profile_torch_forward.py [--batches 1 128] [--iters 20]

Runs qnnpack_tpu_torch's seed-0 MobileNetV2 1.0_224 forward under
torch.profiler (CPU and CUDA activity) and prints, per batch size: the host
wall time per forward, the device time per forward summed over kernels, the
device idle share (1 - device time / wall time: one stream, so kernels do
not overlap), and the device time by kernel name.  Writes the same to
chiprun_out/profile_torch_forward.json.  Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def device_us(evt):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return getattr(evt, attr)
    return 0.0


def profile_batch(torch, fn, params, batch, iters):
    from torch.profiler import ProfilerActivity, profile

    x = torch.from_numpy(np.random.default_rng(batch).integers(
        0, 256, (batch, 224, 224, 3), dtype=np.int64).astype(np.uint8)).cuda()
    with torch.inference_mode():
        for _ in range(3):
            fn(params, x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(params, x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    by_name = {}
    for evt in prof.key_averages():
        us = device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.key] = by_name.get(evt.key, 0.0) + us / 1e3 / iters
    device_ms = sum(by_name.values())
    return dict(batch=batch, iters=iters, wall_ms=wall_ms,
                device_ms=device_ms,
                idle_share=max(0.0, 1.0 - device_ms / wall_ms),
                by_kernel=dict(sorted(by_name.items(),
                                      key=lambda kv: -kv[1])))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 128])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_torch_forward: no CUDA GPU available", file=sys.stderr)
        return 2
    from qnnpack_tpu_torch.entry import entry

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}")
    fn, (params, _) = entry()
    results = []
    for batch in args.batches:
        r = profile_batch(torch, fn, params, batch,
                          max(2, args.iters // max(1, batch // 16)))
        results.append(r)
        print(f"batch {batch}: wall {r['wall_ms']:.3f} ms/forward, device "
              f"{r['device_ms']:.3f} ms, idle share {r['idle_share']:.3f}")
        for name, ms in list(r["by_kernel"].items())[:8]:
            print(f"    {ms:9.4f} ms  {name[:90]}")
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "profile_torch_forward.json").write_text(
        json.dumps(dict(card=smi, results=results), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
