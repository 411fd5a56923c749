#!/usr/bin/env python3
"""Multi-card run of the port's parallel layer (qnnpack_tpu_torch.parallel).

    torchrun --nproc-per-node 4 parallel_smoke.py            # NCCL, a card a rank
    torchrun --nproc-per-node 4 parallel_smoke.py --device cpu --small
                                                    # the same code on gloo, tiny

Each rank joins the world through parallel.distributed_init (torchrun's
variables; on the card cuda:LOCAL_RANK) and holds every sharded result
against the unsharded one computed on its own device, byte for byte:

  - MobileNetV2 1.0_224 at batch 128 (entry(), seed 0; --small: the tiny
    MobileNetV2 of tests/test_parallel.py) through make_mesh + shard_params
    + sharded_inference_fn + batch_sharding on the meshes (n, 1), (1, n)
    and (2, n/2): DP, output-channel TP (ColumnShard all-gathers) and both;
  - gemm_kdim_tp at the MobileNetV2 head's b128 shape (6272x320->1280) and
    conv_ic_tp at ResNet-18's 3x3 256->256 conv at 14x14, b128, kzp 128
    and 103 (int32 all-reduce of the partial instances, then q8requant);
  - spatial_conv2d (halo rows by batch_isend_irecv), pipeline_apply (n
    stages by send/recv, the output broadcast) and grouped_conv2d_ep;
  - SliceRecovery: the (n/2, 2) sharded forward again after recover();
  - on the card, each rank launches q8gemm on tensors on the next card
    and checks that its current device is still its own (qnn::DeviceGuard
    restores the caller's device).

It also times (a host clock around one call that ends in a synchronize and
a barrier, median of 5, the slowest rank's) the sharded forward on each
mesh beside one card's forward of the whole batch, and the K- and
input-channel-TP products beside the unsharded kernel.  Rank 0 prints the card line
(nvidia-smi name and power limit), one JSON object and, last,
{"ok": true|false, ...}; the exit code is 1 on any mismatch.  The JSON also
goes to chiprun_out/parallel_smoke.json.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--small", action="store_true",
                    help="tiny sizes (a CPU rehearsal)")
    args = ap.parse_args()

    import torch
    import torch.distributed as dist

    from qnnpack_tpu_torch import kernels as K
    from qnnpack_tpu_torch import parallel as P
    from qnnpack_tpu_torch.entry import entry
    from qnnpack_tpu_torch.models.mobilenet_v2 import (build_mobilenet_v2,
                                                       mobilenet_v2_forward)
    from qnnpack_tpu_torch.nn.conv import pack_conv_weights, q8conv2d
    from qnnpack_tpu_torch.nn.gemm import q8gemm
    from qnnpack_tpu_torch.nn.packing import pack_gemm_weights
    from qnnpack_tpu_torch.nn.requant_dispatch import make_requant_params

    if not P.distributed_init(device=args.device):
        print("parallel_smoke: run me under torchrun with more than one "
              "process", file=sys.stderr)
        return 2
    rank, n = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if args.device == "cuda" else torch.device("cpu")
    rng = np.random.default_rng(14)
    small = args.small
    failures, result = [], {"ranks": n, "device": str(dev)}

    def u8(*shape):
        return torch.from_numpy(rng.integers(
            0, 256, shape, dtype=np.int64).astype(np.uint8)).to(dev)

    def check(label, got, want):
        if not torch.equal(got, want):
            failures.append(label)
        if rank == 0:
            print(f"  {label:60s} "
                  + ("equal" if torch.equal(got, want) else "DIFFERS"),
                  flush=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dist.barrier()

    def time_ms(fn, reps=5):
        """Median over `reps` of one call, behind a barrier, the slowest
        rank's."""
        fn()
        times = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        t = torch.tensor([statistics.median(times)], dtype=torch.float64,
                         device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t[0])

    rp = make_requant_params("fp32", 2e-4, 128, 128, 188)
    p1 = ((1, 1), (1, 1))
    if small:
        params, spec = build_mobilenet_v2(
            np.random.default_rng(21), input_size=32, num_classes=16,
            requant="fp32", cfg=[(1, 8, 1, 1), (6, 16, 2, 2)],
            stem_channels=8, head_channels=64, device=dev)

        def fn(p, v):
            return mobilenet_v2_forward(p, spec, v)
        xb = u8(8, 32, 32, 3)
    else:
        fn, (params, _) = entry(device=dev)
        xb = u8(128, 224, 224, 3)
    times = {}
    with torch.inference_mode():
        want = fn(params, xb)
        meshes = [(n, 1), (1, n)] + ([(2, n // 2)] if n % 2 == 0 else [])
        times["one card b{} ms".format(xb.shape[0])] = time_ms(
            lambda: fn(params, xb))
        for n_data, n_model in meshes:
            mesh = P.make_mesh(n_data, n_model, device=args.device)
            sharded = P.shard_params(params, mesh)
            fwd = P.sharded_inference_fn(fn, mesh)
            bs = P.batch_sharding(mesh)
            xs = bs.shard(xb)
            K.reset_launch_counts()
            got = bs.gather(fwd(sharded, xs))
            sync()
            launches = {k: v for k, v in K.launch_counts().items() if v}
            check(f"MobileNetV2 b{xb.shape[0]} on ({n_data}, {n_model})",
                  got, want)
            result[f"launches ({n_data}, {n_model})"] = launches
            times[f"sharded ({n_data}, {n_model}) ms"] = time_ms(
                lambda: bs.gather(fwd(sharded, xs)))

        grid = P.make_mesh(1, n, device=args.device)
        m, k, c_out = (98, 320, 64) if small else (6272, 320, 1280)
        bsz, h, w, c, o = (2, 6, 6, 16, 8) if small else (128, 14, 14, 256,
                                                         256)
        index = grid.get_local_rank("model")
        for izp, kzp in ((128, 128), (121, 103)):
            a = u8(m, k)
            packed = pack_gemm_weights(u8(c_out, k), None, izp, kzp,
                                       device=dev)
            ks = k // n
            a_local = a[:, index * ks:(index + 1) * ks].contiguous()
            check(f"gemm_kdim_tp {m}x{k}->{c_out} kzp {kzp}",
                  P.gemm_kdim_tp(a_local, packed, rp, grid),
                  q8gemm(a, packed, rp))
            x = u8(bsz, h, w, c)
            cpacked = pack_conv_weights(u8(o, 3, 3, c), None, izp, kzp,
                                        device=dev)
            cs = c // n
            x_local = x[..., index * cs:(index + 1) * cs].contiguous()
            check(f"conv_ic_tp {bsz}x{h}x{w}x{c}->{o} kzp {kzp}",
                  P.conv_ic_tp(x_local, cpacked, rp, grid, padding=p1),
                  q8conv2d(x, cpacked, rp, padding=p1))
            if kzp == 128:
                times["q8gemm one card ms"] = time_ms(
                    lambda: q8gemm(a, packed, rp))
                times[f"gemm_kdim_tp {n} ms"] = time_ms(
                    lambda: P.gemm_kdim_tp(a_local, packed, rp, grid))
                times["q8conv one card ms"] = time_ms(
                    lambda: q8conv2d(x, cpacked, rp, padding=p1))
                times[f"conv_ic_tp {n} ms"] = time_ms(
                    lambda: P.conv_ic_tp(x_local, cpacked, rp, grid,
                                         padding=p1))

        x = u8(2, 16, 16, 8) if small else u8(32, 28, 28, 64)
        cpacked = pack_conv_weights(u8(x.shape[-1], 3, 3, x.shape[-1]), None,
                                    121, 103, device=dev)
        band = x.shape[1] // n
        check("spatial_conv2d 3x3 pad 1, H over the ranks",
              P.spatial_conv2d(x[:, index * band:(index + 1) * band]
                               .contiguous(), cpacked, rp, grid,
                               axis="model", padding=p1),
              q8conv2d(x, cpacked, rp, padding=p1)[
                  :, index * band:(index + 1) * band])

        dim, mb, n_micro = (32, 4, 4) if small else (512, 128, 8)
        stages = [pack_gemm_weights(u8(dim, dim), None, 121, 103, device=dev)
                  for _ in range(n)]
        x_micro = u8(n_micro, mb, dim)
        seq = []
        for v in x_micro:
            for s in stages:
                v = q8gemm(v, s, rp)
            seq.append(v)
        check(f"pipeline_apply {n} stages x {n_micro} microbatches",
              P.pipeline_apply(lambda p, v: q8gemm(v, p, rp),
                               P.stack_stage_params(stages), x_micro, grid),
              torch.stack(seq))

        groups = 2 * n
        gx = u8(2, 8, 8, groups * 4) if small else u8(32, 28, 28, groups * 48)
        icpg = gx.shape[-1] // groups
        gpacked = pack_conv_weights(u8(groups * icpg, 1, 1, icpg), None, 128,
                                    128, groups, device=dev)
        cs = gx.shape[-1] // n
        check(f"grouped_conv2d_ep {groups} groups",
              P.grouped_conv2d_ep(gx[..., index * cs:(index + 1) * cs]
                                  .contiguous(), gpacked, rp, grid),
              q8conv2d(gx, gpacked, rp)[..., index * cs:(index + 1) * cs])

        if n % 2 == 0:
            rec = P.SliceRecovery.snapshot(params, P.shard_params, n_model=2,
                                           device=args.device)
            rec.device_params = None
            again = rec.recover()
            bs = P.batch_sharding(rec.mesh)
            check("SliceRecovery.recover, then the (n/2, 2) forward",
                  bs.gather(P.sharded_inference_fn(fn, rec.mesh)(
                      again, bs.shard(xb))), want)

        if dev.type == "cuda" and torch.cuda.device_count() > 1:
            other = torch.device("cuda", (dev.index + 1)
                                 % torch.cuda.device_count())
            kernel, a = u8(64, 96).cpu(), u8(300, 96).cpu()
            got = K.q8gemm_cuda(a.to(other), pack_gemm_weights(
                kernel, None, 121, 103, device=other), rp)
            restored = torch.cuda.current_device() == dev.index
            if not restored:
                failures.append("device guard")
            check(f"q8gemm on {other} from {dev}; current device kept: "
                  f"{restored}", got.cpu(), K.q8gemm_plain(
                      a, pack_gemm_weights(kernel, None, 121, 103), rp))
            result["device guard restored"] = restored
    sync()
    result["times"] = times
    fails = torch.tensor([len(failures)], device=dev)
    dist.all_reduce(fails)
    ok = int(fails[0]) == 0
    if rank == 0:
        if dev.type == "cuda":
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True).stdout.strip().splitlines()[0]
            result["card"] = smi
            result["kind"] = torch.cuda.get_device_name(0)
        result["failures"] = failures
        out = Path("chiprun_out")
        out.mkdir(exist_ok=True)
        (out / "parallel_smoke.json").write_text(json.dumps(result, indent=1))
        print(json.dumps(result))
        if dev.type == "cuda":
            print(result["card"])
        print(json.dumps({"ok": ok, "device": {
            "platform": "gpu" if dev.type == "cuda" else "cpu",
            "kind": result.get("kind", "cpu"), "count": n}}), flush=True)
    P.distributed_shutdown()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
