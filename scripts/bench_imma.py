#!/usr/bin/env python3
"""Time the q8gemm and q8conv kernels (qnnpack_tpu_torch) at main-path
shapes on one CUDA GPU, beside one library call on the same inputs:
torch._int_mm on the (im2col) matrices, float32 F.conv2d for the grouped
convs.

    python3 scripts/bench_imma.py [--check] [--tiles] [--instances]

--check first runs chip_smoke.py's phase 2 (every kernel against its plain
version, q8gemm's wgmma instance among them); --tiles also times each
batch-128 shape that stays on mma.sync under every mma.sync block shape
of kernels/q8gemm.py TILES, without split-K.  --instances times only
BERT's projections on q8gemm's two instances (below).  Prints the card
(nvidia-smi name and power limit), each kernel instance's registers and
spills from ptxas, then one line per shape: the kernel's route (wgmma or
mma.sync, as kernels/q8gemm.py wgmma_route decides) and plan (block
shape, split-K), ms (CUDA events, median of windows, as
chip_smoke.time_ms), int8 TOP/s, the share of the bound max(bytes /
3.35 TB/s, ops / 1979 TOP/s) and the library call's ms.  Then BERT's four
projections at each batch of BERT_BATCHES through the C entry qnn_q8gemm
directly, on the mma.sync instance with the plan tile_plan gives it and
on the wgmma instance (128 x 256), timed in turns (mma.sync, wgmma,
wgmma, mma.sync; means of the two times of each), their outputs held
equal, each with its route and the faster instance.  Writes the rows to
chiprun_out/bench_imma.json.  Needs a GPU; exits non-zero without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (label, M, K, N): BERT-base s128 projections at batch 128 and 1, and
# MobileNetV2's largest 1x1 layers at batch 128.
GEMMS = [
    ("bert b128 qkv", 16384, 768, 2304),
    ("bert b128 out", 16384, 768, 768),
    ("bert b128 ffn1", 16384, 768, 3072),
    ("bert b128 ffn2", 16384, 3072, 768),
    ("bert b1 qkv", 128, 768, 2304),
    ("bert b1 ffn2", 128, 3072, 768),
    ("mnv2 b128 expand 16->96", 1605632, 16, 96),
    ("mnv2 b128 project 144->24", 401408, 144, 24),
    ("mnv2 b128 head 320->1280", 6272, 320, 1280),
    ("shufflenet b128 st0u0_g1 24->60", 401408, 24, 60),
]
# BERT-base's projections (name, K, N) and the batches of s128 rows at
# which --instances times them: InferenceServer's default buckets from 8,
# where a projection first reaches the H100's ridge, and the benchmark's
# 128.
BERT_PROJECTIONS = (("qkv", 768, 2304), ("out", 768, 768),
                    ("ffn1", 768, 3072), ("ffn2", 3072, 768))
BERT_BATCHES = (8, 16, 32, 64, 128)
# (label, B, H, W, C, O, k, stride, padding, groups): ResNet-18's dense
# bodies and ShuffleNet v1 g3's grouped 1x1 layers.
P1 = ((1, 1), (1, 1))
S2 = ((0, 1), (0, 1))
P0 = ((0, 0), (0, 0))
CONVS = [
    ("resnet b128 s0 3x3 56x56x64", 128, 56, 56, 64, 64, 3, 1, P1, 1),
    ("resnet b128 s1a 3x3 s2 56x56x64->128", 128, 56, 56, 64, 128, 3, 2, S2,
     1),
    ("resnet b128 s1 3x3 28x28x128", 128, 28, 28, 128, 128, 3, 1, P1, 1),
    ("resnet b128 s2 3x3 14x14x256", 128, 14, 14, 256, 256, 3, 1, P1, 1),
    ("resnet b128 s3 3x3 7x7x512", 128, 7, 7, 512, 512, 3, 1, P1, 1),
    ("resnet b1 s3 3x3 7x7x512", 1, 7, 7, 512, 512, 3, 1, P1, 1),
    ("resnet b1 s0 3x3 56x56x64", 1, 56, 56, 64, 64, 3, 1, P1, 1),
    ("shufflenet b128 st0u0_g2 28x28x60 g3", 128, 28, 28, 60, 216, 1, 1, P0,
     3),
    ("shufflenet b128 st0u1_g1 28x28x240 g3", 128, 28, 28, 240, 60, 1, 1,
     P0, 3),
    ("shufflenet b128 st1u0_g1 28x28x240 g3", 128, 28, 28, 240, 120, 1, 1,
     P0, 3),
]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench_imma: no CUDA GPU available", file=sys.stderr)
        return 2
    import chip_smoke
    from chip_smoke import (card_peaks, conv2d_yardstick, conv_plan,
                            int_mm_yardstick, plan_tag, q8gemm_plan, time_ms)
    from qnnpack_tpu_torch import kernels as K
    from qnnpack_tpu_torch.kernels import _build
    from qnnpack_tpu_torch.kernels import q8gemm as gemm_mod
    from qnnpack_tpu_torch.nn.conv import im2col, pack_conv_weights
    from qnnpack_tpu_torch.nn.packing import pack_gemm_weights
    from qnnpack_tpu_torch.nn.requant_dispatch import make_requant_params
    from qnnpack_tpu_torch.utils import profiling

    HBM_BYTES_PER_S, INT8_OPS_PER_S = card_peaks()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    _build.load_library()
    nvcc_seconds = (profiling.span_total("library.build") or (0, 0.0))[1]
    print(f"nvcc {nvcc_seconds:.1f} s")
    name = ""
    ptxas = []
    for line in _build.build_log.splitlines():
        if "Compiling entry" in line:
            name = line.split("'")[1]
        elif ("q8gemm_kernel" in name or "q8conv_kernel" in name) and (
                "registers" in line or "spill" in line):
            ptxas.append(f"{name}: {line.strip()}")
            print(f"  {name[-60:]}: {line.strip()}")
    if "--check" in sys.argv:
        err = {n: 0 for n in K.KERNELS}
        chip_smoke.check_kernels(torch, err)
        print(f"phase 2 equal: {err}", flush=True)
    if "--instances" in sys.argv:
        rows = time_instances(torch, time_ms, INT8_OPS_PER_S)
        write(dict(card=smi, ptxas=ptxas, instances=rows))
        return 0

    # The float32 library products must sum the integers exactly.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(5)
    cuda = torch.device("cuda")
    rp = make_requant_params("fp32", 0.0021, 128)
    rows = []
    real_plan = gemm_mod.tile_plan

    def forced(tile):
        """tile_plan with block shape `tile` wherever it would not split
        (the C entry refuses 128-byte stages a conv's taps cannot hold)."""
        def plan(m, n, steps, groups, sms, deep=True):
            t, splits, per = real_plan(m, n, steps, groups, sms, deep)
            return (tile, 1, steps) if splits == 1 else (t, splits, per)
        return plan

    def report(kernel, label, plan, fn, lib, nbytes, ops):
        if ("--tiles" in sys.argv and "b1 " not in label
                and "wgmma" not in plan):  # --instances times those
            for t in range(gemm_mod.WGMMA_TILE):  # splits kept at 1
                gemm_mod.tile_plan = forced(t)
                try:
                    ms = f"{time_ms(fn, torch):.4f} ms"
                except RuntimeError as e:
                    ms = f"refused ({str(e)[:40]})"
                print(f"    tile {t}: {ms}", flush=True)
            gemm_mod.tile_plan = real_plan
        ms = time_ms(fn, torch)
        lib_ms = time_ms(lib, torch) if lib is not None else None
        bound = max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3
        route = "wgmma" if "wgmma" in plan else "mma.sync"
        rows.append(dict(kernel=kernel, label=label, route=route, plan=plan,
                         ms=ms, tops=ops / ms / 1e9, bound_ms=bound,
                         bound_share=bound / ms, library_ms=lib_ms))
        lib_txt = "-" if lib_ms is None else f"{lib_ms:.4f}"
        print(f"  {kernel} {label:40s} {route:8s} {plan:24s} {ms:8.4f} ms "
              f"{ops / ms / 1e9:7.1f} TOP/s  {bound / ms:6.1%} of bound  "
              f"library {lib_txt} ms", flush=True)

    with torch.inference_mode():
        for label, m, k, n in GEMMS:
            a = torch.randint(0, 256, (m, k), dtype=torch.uint8, device=cuda)
            kernel = rng.integers(0, 256, (n, k), dtype=np.int64).astype(
                np.uint8)
            p = pack_gemm_weights(kernel, None, 128, 128, device=cuda)
            report("q8gemm", f"{label} {m}x{k}->{n}",
                   plan_tag(q8gemm_plan(m, n, k, sms)),
                   lambda a=a, p=p: K.q8gemm_cuda(a, p, rp),
                   int_mm_yardstick(torch, a, p.w),
                   m * k + k * n + 4 * n + m * n, 2 * m * n * k)
            del a
        for label, b, h, w, c, o, k, s, pad, g in CONVS:
            a = torch.randint(0, 256, (b, h, w, c), dtype=torch.uint8,
                              device=cuda)
            kernel = rng.integers(0, 256, (o, k, k, c // g), dtype=np.int64
                                  ).astype(np.uint8)
            p = pack_conv_weights(kernel, None, 128, 128, g, device=cuda)
            out = K.q8conv_cuda(a, p, rp, (s, s), pad)
            m = out.numel() // o
            if g == 1:
                cols, _ = im2col(a, p, (s, s), pad)
                lib = int_mm_yardstick(torch, cols, p.as_gemm().w)
                del cols
            else:  # float32 grouped conv, as chip_smoke.py times it
                lib = conv2d_yardstick(torch, a, p, (s, s), pad)
            report("q8conv", f"{label} ->{o}",
                   plan_tag(conv_plan(p, m, sms)),
                   lambda a=a, p=p, s=s, pad=pad: K.q8conv_cuda(
                       a, p, rp, (s, s), pad),
                   lib, a.numel() + p.w.numel() + 4 * o + m * o,
                   2 * m * o * k * k * c // g)
            del a, lib
            torch.cuda.empty_cache()
    instances = time_instances(torch, time_ms, INT8_OPS_PER_S)
    write(dict(card=smi, ptxas=ptxas, rows=rows, instances=instances))
    return 0


def write(record: dict) -> None:
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "bench_imma.json").write_text(json.dumps(record, indent=1))


def entry_call(torch, a, p, rp, plan):
    """A function that runs q8gemm's C entry on `plan` ([tile, splits,
    steps per split, workspace ptr, counters ptr], kernels/q8gemm.py
    plan_launch) into one output, as the wrapper would launch it."""
    from qnnpack_tpu_torch.kernels import _build
    scales, rq = _build.requant_args(rp, p.n, a.device)
    out = torch.empty((a.shape[0], p.n), dtype=torch.uint8, device=a.device)
    args = (a.device.index or 0, a.data_ptr(), p.w_kmajor.data_ptr(),
            p.bias_c.data_ptr(), None if scales is None else scales.data_ptr(),
            out.data_ptr(), a.shape[0], p.n, p.k, p.w_kmajor.shape[1],
            p.kzp_biased, *plan, *rq, None, None, _build.stream_of(a))

    def run():
        _build.launch("qnn_q8gemm", *args)
        return out
    return run


def time_instances(torch, time_ms, int8_ops_per_s):
    """BERT's four projections at each batch of BERT_BATCHES on q8gemm's
    two instances through the C entry, in turns: the mma.sync instance on
    the plan tile_plan gives it (block shape, split-K) and the wgmma
    instance (128 x 256, a persistent block an SM); with the number of
    wgmma tiles, the route the wrapper takes (wgmma_route) and which
    instance was faster."""
    from qnnpack_tpu_torch.kernels import _build
    from qnnpack_tpu_torch.kernels import q8gemm as G
    from qnnpack_tpu_torch.nn.packing import K_STEP, pack_gemm_weights
    from qnnpack_tpu_torch.nn.requant_dispatch import make_requant_params

    rng = np.random.default_rng(18)
    cuda = torch.device("cuda")
    ridge = G._ridge(cuda)
    rp = make_requant_params("fp32", 0.0021, 128)
    bm, bn = G.TILES[G.WGMMA_TILE]
    rows = []
    total = {}
    with torch.inference_mode():
        for name, k, n in BERT_PROJECTIONS:
            kernel = rng.integers(0, 256, (n, k), dtype=np.int64).astype(
                np.uint8)
            p = pack_gemm_weights(kernel, None, 128, 128, device=cuda)
            steps = p.w_kmajor.shape[1] // K_STEP
            for batch in BERT_BATCHES:
                m = 128 * batch
                a = torch.randint(0, 256, (m, k), dtype=torch.uint8,
                                  device=cuda)
                work, mma_plan = G.plan_launch(cuda, _build.stream_of(a), m,
                                               n, steps)
                plans = {"mma.sync": mma_plan,
                         "wgmma": [G.WGMMA_TILE, 1, steps, 0, 0]}
                runs = {i: entry_call(torch, a, p, rp, plan)
                        for i, plan in plans.items()}
                outs = {i: runs[i]().clone() for i in runs}
                if not torch.equal(outs["wgmma"], outs["mma.sync"]):
                    raise AssertionError(f"{name} b{batch}: wgmma != "
                                         "mma.sync")
                times = {i: [] for i in runs}
                for i in ("mma.sync", "wgmma", "wgmma", "mma.sync"):
                    times[i].append(time_ms(runs[i], torch))
                ms = {i: sum(v) / len(v) for i, v in times.items()}
                ops = 2 * m * n * k
                tiles = -(-m // bm) * -(-n // bn)
                route = G.wgmma_route(m, n, k, steps, ridge, a.data_ptr())
                row = dict(
                    label=f"bert b{batch} {name} {m}x{k}->{n}", batch=batch,
                    ops_per_byte=ops / (m * k + k * n + m * n),
                    wgmma_tiles=tiles, route="wgmma" if route else "mma.sync",
                    faster=min(ms, key=ms.get),
                    **{i: dict(plan=plans[i][:3], ms=ms[i],
                               tops=ops / ms[i] / 1e9,
                               bound_share=ops / int8_ops_per_s * 1e3 / ms[i])
                       for i in ms})
                rows.append(row)
                for i in ms:
                    total[(batch, i)] = total.get((batch, i), 0.0) + ms[i]
                print(f"  {row['label']:32s} {row['ops_per_byte']:6.0f} "
                      f"op/B {tiles:4d} tiles  route {row['route']:8s} "
                      + "  ".join(f"{i} {ms[i]:.4f} ms ({ops / ms[i] / 1e9:.0f}"
                                  f" TOP/s)" for i in ms)
                      + f"  faster {row['faster']}", flush=True)
                del a, outs, runs, work
                torch.cuda.empty_cache()
    for batch in BERT_BATCHES:
        rows.append(dict(label=f"bert b{batch} sum of the four",
                         **{i: dict(ms=total[(batch, i)])
                            for i in ("mma.sync", "wgmma")}))
        print(f"  bert b{batch} sum of the four: " + "  ".join(
            f"{i} {total[(batch, i)]:.4f} ms" for i in ("mma.sync", "wgmma")),
            flush=True)
    return rows


if __name__ == "__main__":
    sys.exit(main())
