#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (qnnpack_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA GPU (built for sm_90a: an H100) and nvcc; exits non-zero
without them.  Phases, each of which raises on any failure:

  1. print the card (nvidia-smi name and power limit) and versions, build
     the four CUDA kernels from qnnpack_tpu_torch/kernels/csrc/;
  2. hold every kernel against its plain PyTorch version, run on CPU copies
     of the same inputs, at the main path's shapes plus kzp != 128, q31,
     precise, gemmlowp and per-channel cases: torch.equal, zero tolerance
     (the integer math is exact);
  3. build MobileNetV2 1.0_224 (seed 0, fp32 requant, batch 1) through
     qnnpack_tpu_torch.entry: the forward on the card must equal the plain
     CPU forward byte for byte;
  4. count kernel launches over one forward: q8gemm 36, q8dwconv 17,
     q8vadd 10, q8gavgpool 1;
  5. serve 16 single-image requests through qnnpack_tpu_torch.serving
     .InferenceServer; every answer must equal its row of a direct batch
     forward;
  6. time with CUDA events (warm-up, median of repeats): forward img/s at
     batch 1 and 128, and each kernel at every main-path shape beside its
     bound max(bytes / 3.35 TB/s, int8 ops / 1979 TOP/s), its plain version
     on the card and, for q8gemm, torch._int_mm (a yardstick only); at each
     of those shapes the kernel's output must equal its plain version's.

Prints the {"kernels": [...]} line, the nvidia-smi line and, last,
{"ok": true, "device": {...}}.  Per-shape timings go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12    # H100 SXM data sheet, dense int8 tensor rate
EXPECTED_LAUNCHES = {"q8gemm": 36, "q8dwconv": 17, "q8vadd": 10,
                     "q8gavgpool": 1}
SOURCES = {
    "q8gemm": ("qnnpack_tpu_torch/kernels/csrc/q8gemm.cu",
               "qnnpack_tpu/kernels/q8gemm_small.py:134"),
    "q8dwconv": ("qnnpack_tpu_torch/kernels/csrc/q8dwconv.cu",
                 "qnnpack_tpu/kernels/q8dwconv.py:95"),
    "q8vadd": ("qnnpack_tpu_torch/kernels/csrc/q8vadd.cu",
               "qnnpack_tpu/kernels/vpu_ops.py:89"),
    "q8gavgpool": ("qnnpack_tpu_torch/kernels/csrc/q8gavgpool.cu",
                   "qnnpack_tpu/kernels/pool.py:165"),
}


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------- timing
def time_ms(fn, torch, repeats=5, queued=True):
    """Median ms per call over `repeats` CUDA-event windows, after warm-up.

    queued=True times the device: each window starts behind a device-side
    sleep long enough for the host to enqueue all of the window's launches,
    so a kernel shorter than its host launch cost is timed back to back,
    not at the host's launch rate.  queued=False times what a caller sees,
    host launch costs included."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    est_ms = (time.perf_counter() - t0) * 1e3
    reps = max(1, min(100, int(10.0 / max(est_ms, 1e-3))))
    sleep_cycles = int(min(50.0, 1.5 * reps * est_ms + 0.5) * 2e6)
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def compare(torch, err, name, label, got, want, quiet=False):
    """Raise unless the kernel's output `got` equals the plain `want`
    exactly; records the max |err| of kernel `name` in `err`."""
    got = got.to(want.device)
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name} {label}: {tuple(got.shape)} "
                             f"{got.dtype} vs {tuple(want.shape)} "
                             f"{want.dtype}")
    diff = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
    err[name] = max(err[name], diff)
    if not torch.equal(got, want):
        raise AssertionError(f"{name} {label}: kernel != plain, "
                             f"max |err| {diff}")
    if not quiet:
        log(f"  {name:10s} {label:44s} equal")


# ------------------------------------------------------ phase 2: kernels
def check_kernels(torch, err):
    """Each kernel vs its plain version on CPU copies of the same inputs."""
    from qnnpack_tpu_torch import kernels as K
    from qnnpack_tpu_torch.nn.conv import pack_conv_weights
    from qnnpack_tpu_torch.nn.packing import pack_gemm_weights
    from qnnpack_tpu_torch.nn.requant_dispatch import make_requant_params
    from qnnpack_tpu_torch.quant.params import (
        compute_add_quant_params, compute_avgpool_quant_params,
        compute_per_channel_fp32_params)

    rng = np.random.default_rng(1234)
    cuda = torch.device("cuda")
    relu6 = dict(qmin=128, qmax=188)

    def u8(*shape):
        return rng.integers(0, 256, shape, dtype=np.int64).astype(np.uint8)

    def check(name, label, got, want):
        compare(torch, err, name, label, got, want)

    # q8gemm: (label, M, K, N, izp, kzp, scheme or "pc", rp kwargs)
    gemm_cases = [
        ("stem im2col 12544x27->32", 12544, 27, 32, 128, 128, "fp32", relu6),
        ("expand 12544x16->96", 12544, 16, 96, 128, 128, "fp32", relu6),
        ("project 49x960->160", 49, 960, 160, 128, 128, "fp32", {}),
        ("head 49x320->1280", 49, 320, 1280, 128, 128, "fp32", relu6),
        ("fc 1x1280->1000", 1, 1280, 1000, 128, 128, "fp32", {}),
        ("fc 128x1280->1000", 128, 1280, 1000, 128, 128, "fp32", {}),
        ("kzp 103, q31 300x77->50", 300, 77, 50, 121, 103, "q31", {}),
        ("kzp 90, precise 65x200->70", 65, 200, 70, 7, 90, "precise", {}),
        ("kzp 200, gemmlowp 130x33->129", 130, 33, 129, 250, 200,
         "gemmlowp", {}),
        ("per-channel kzp 99 257x40->72", 257, 40, 72, 121, 99, "pc", {}),
        ("ragged 1x1->1", 1, 1, 1, 121, 103, "fp32", {}),
        ("ragged kzp 77, q31 67x961->65", 67, 961, 65, 3, 77, "q31", {}),
        ("ragged 130x5->1", 130, 5, 1, 128, 128, "fp32", relu6),
    ]
    for label, m, k, n, izp, kzp, scheme, rkw in gemm_cases:
        kernel, bias = u8(n, k), rng.integers(-9000, 9000, n).astype(np.int32)
        if scheme == "pc":
            rp = compute_per_channel_fp32_params(
                rng.uniform(1e-4, 2e-3, n), 117)
        else:
            rp = make_requant_params(scheme, 0.0037, 117, **rkw)
        a = torch.from_numpy(u8(m, k))
        want = K.q8gemm_plain(a, pack_gemm_weights(kernel, bias, izp, kzp),
                              rp)
        got = K.q8gemm_cuda(a.to(cuda), pack_gemm_weights(
            kernel, bias, izp, kzp, device=cuda), rp)
        check("q8gemm", label, got, want)

    # q8dwconv: (label, B, H, W, C, stride, padding, dilation, izp, kzp,
    # scheme)
    dw_cases = [
        ("112x112x96 s2 pad(0,1)", 1, 112, 112, 96, 2, ((0, 1), (0, 1)), 1,
         128, 128, "fp32"),
        ("14x14x576 s1 pad 1", 1, 14, 14, 576, 1, ((1, 1), (1, 1)), 1,
         128, 128, "fp32"),
        ("kzp 103, q31 13x11x24 s1", 1, 13, 11, 24, 1, ((1, 1), (1, 1)), 1,
         121, 103, "q31"),
        ("per-channel kzp 90 14x14x40 s2", 1, 14, 14, 40, 2,
         ((1, 1), (1, 1)), 1, 121, 90, "pc"),
        ("dilation 2 gemmlowp 12x10x16", 1, 12, 10, 16, 2, ((2, 2), (2, 2)),
         2, 7, 200, "gemmlowp"),
        ("batch 3, precise 9x7x33 s2 pad(0,1)", 3, 9, 7, 33, 2,
         ((0, 1), (0, 1)), 1, 250, 140, "precise"),
    ]
    for label, bsz, h, w, c, s, pad, d, izp, kzp, scheme in dw_cases:
        kernel = u8(c, 3, 3, 1)
        bias = rng.integers(-9000, 9000, c).astype(np.int32)
        if scheme == "pc":
            rp = compute_per_channel_fp32_params(
                rng.uniform(1e-3, 2e-2, c), 117)
        else:
            rp = make_requant_params(scheme, 0.0037, 117)
        a = torch.from_numpy(u8(bsz, h, w, c))
        args = dict(strides=(s, s), padding=pad, dilation=(d, d))
        want = K.q8dwconv_plain(
            a, pack_conv_weights(kernel, bias, izp, kzp, groups=c), rp,
            **args)
        got = K.q8dwconv_cuda(a.to(cuda), pack_conv_weights(
            kernel, bias, izp, kzp, groups=c, device=cuda), rp, **args)
        check("q8dwconv", label, got, want)

    for label, shape, params in [
            ("1x56x56x24 residual", (1, 56, 56, 24),
             compute_add_quant_params(128, 128, 128, 1.0, 1.0)),
            ("zp 10/200, scales .125/1.75", (3, 7, 11, 5),
             compute_add_quant_params(10, 200, 128, 0.125, 1.75, 20, 240))]:
        a, b = torch.from_numpy(u8(*shape)), torch.from_numpy(u8(*shape))
        check("q8vadd", label, K.q8vadd_cuda(a.to(cuda), b.to(cuda), params),
                K.q8vadd_plain(a, b, params))

    for label, shape, params in [
            ("1x49x1280", (1, 49, 1280), compute_avgpool_quant_params(
                -128 * 49, 1.0 / 49, 128, input_zero_point=128)),
            ("128x49x1280", (128, 49, 1280), compute_avgpool_quant_params(
                -128 * 49, 1.0 / 49, 128, input_zero_point=128)),
            ("3x9x33 scale 3.7 zp 7", (3, 9, 33), compute_avgpool_quant_params(
                -7 * 9, 3.7 / 9, 100, 20, 230, input_zero_point=7))]:
        x = torch.from_numpy(u8(*shape))
        check("q8gavgpool", label, K.q8gavgpool_cuda(x.to(cuda), params),
                K.q8gavgpool_plain(x, params))
    torch.cuda.synchronize()


# ------------------------------------------------ phase 6: main-path calls
def main_path_calls(torch, params, spec, batch, rng):
    """Yield one record per kernel launch of the forward at `batch`: its
    kernel, a label, closures running the kernel, the plain version and the
    library yardstick on the card, and the bytes and ops of the work."""
    from qnnpack_tpu_torch import kernels as K
    from qnnpack_tpu_torch.nn.conv import im2col
    from qnnpack_tpu_torch.nn.dtypes import u8_to_biased_i8

    dev = torch.device("cuda")
    shape = (batch, 224, 224, 3)

    def u8(*s):
        return torch.from_numpy(
            rng.integers(0, 256, s, dtype=np.int64).astype(np.uint8)).to(dev)

    def gemm_call(label, a, packed, rp):
        m, k = a.shape
        n = packed.n
        lib = None
        if m > 16 and n % 8 == 0:
            a8 = u8_to_biased_i8(a)
            if k % 8:
                pad = 8 - k % 8
                a8 = torch.nn.functional.pad(a8, (0, pad))
                w8 = torch.nn.functional.pad(packed.w, (0, 0, 0, pad))
            else:
                w8 = packed.w
            # cuBLASLt's int8 GEMM takes the second operand column-major.
            w8 = w8.t().contiguous().t()
            lib = (lambda a8=a8, w8=w8: torch._int_mm(a8, w8))
        return dict(kernel="q8gemm", label=f"{label} {m}x{k}->{n}",
                    run=lambda: K.q8gemm_cuda(a, packed, rp),
                    plain=lambda: K.q8gemm_plain(a, packed, rp), library=lib,
                    bytes=m * k + k * n + 4 * n + m * n, ops=2 * m * n * k)

    for (tag, name, layer), p in zip(spec.layers, params):
        if tag == "save":
            continue
        if tag == "add":
            a, b = u8(*shape), u8(*shape)
            n = a.numel()
            yield dict(kernel="q8vadd", label=f"{name} {shape}",
                       run=lambda a=a, b=b, l=layer: K.q8vadd_cuda(a, b, l),
                       plain=lambda a=a, b=b, l=layer: K.q8vadd_plain(a, b, l),
                       library=None, bytes=3 * n, ops=4 * n)
        elif tag == "gap":
            bsz, h, w, c = shape
            x = u8(bsz, h * w, c)
            yield dict(kernel="q8gavgpool", label=f"{name} {tuple(x.shape)}",
                       run=lambda x=x, l=layer: K.q8gavgpool_cuda(x, l),
                       plain=lambda x=x, l=layer: K.q8gavgpool_plain(x, l),
                       library=None, bytes=x.numel() + bsz * c, ops=x.numel())
            shape = (bsz, c)
        elif layer.kind == "gemm":
            a = u8(*shape)
            a2 = a.reshape(-1, shape[-1])
            yield gemm_call(name, a2, p, layer.rparams)
            shape = shape[:-1] + (p.n,)
        elif layer.kind == "dwconv":
            bsz, h, w, c = shape
            (pt, pb), (pl_, pr) = layer.padding
            s = layer.strides[0]
            ho, wo = (h + pt + pb - 3) // s + 1, (w + pl_ + pr - 3) // s + 1
            x = u8(*shape)
            kw_ = dict(strides=layer.strides, padding=layer.padding)
            yield dict(
                kernel="q8dwconv", label=f"{name} {shape} s{s}",
                run=lambda x=x, p=p, l=layer, kw_=kw_: K.q8dwconv_cuda(
                    x, p, l.rparams, **kw_),
                plain=lambda x=x, p=p, l=layer, kw_=kw_: K.q8dwconv_plain(
                    x, p, l.rparams, **kw_),
                library=None, bytes=x.numel() + 9 * c + 4 * c + bsz * ho * wo * c,
                ops=2 * 9 * bsz * ho * wo * c)
            shape = (bsz, ho, wo, c)
        else:  # dense conv: the stem, im2col + q8gemm
            x = u8(*shape)
            cols, (bsz, ho, wo) = im2col(x, p, layer.strides, layer.padding)
            yield gemm_call(name, cols, p.as_gemm(), layer.rparams)
            shape = (bsz, ho, wo, p.w.shape[-1])


def time_main_path(torch, params, spec, batch, rng, err):
    """Time every kernel launch of the forward at `batch`, its plain version
    and yardstick; each kernel's output must equal its plain version's."""
    rows = []
    for call in main_path_calls(torch, params, spec, batch, rng):
        compare(torch, err, call["kernel"], call["label"], call["run"](),
                call["plain"](), quiet=True)
        row = dict(kernel=call["kernel"], label=call["label"],
                   bytes=call["bytes"], ops=call["ops"],
                   ms=time_ms(call["run"], torch),
                   plain_ms=time_ms(call["plain"], torch, repeats=3),
                   library_ms=(time_ms(call["library"], torch)
                               if call["library"] is not None else None))
        rows.append(row)
    return rows


def summarize(rows, name):
    mine = [r for r in rows if r["kernel"] == name]
    total_bytes = sum(r["bytes"] for r in mine)
    total_ops = sum(r["ops"] for r in mine)
    t_bytes = total_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = total_ops / INT8_OPS_PER_S * 1e3
    lib = [r["library_ms"] for r in mine]
    return dict(
        ms=sum(r["ms"] for r in mine),
        plain_ms=sum(r["plain_ms"] for r in mine),
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=(sum(lib) if all(v is not None for v in lib) else None),
        shapes=len(mine))


def forward_ips(torch, fn, params, x, iters):
    def run():
        for _ in range(iters):
            fn(params, x)
    ms = time_ms(run, torch, repeats=5, queued=False)
    return x.shape[0] * iters / (ms / 1e3), ms / iters


# ------------------------------------------------------------------ main
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 2
    from qnnpack_tpu_torch import kernels as K
    from qnnpack_tpu_torch.entry import entry
    from qnnpack_tpu_torch.kernels import _build
    from qnnpack_tpu_torch.models.mobilenet_v2 import build_mobilenet_v2
    from qnnpack_tpu_torch.serving import InferenceServer

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[1] card: {smi}")
    log(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, {kind}")
    t0 = time.perf_counter()
    _build.load_library()
    log(f"    kernels built in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds:.1f} s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"    ptxas: {line.strip()}")

    log("[2] kernels against their plain versions (CPU copies, torch.equal)")
    max_err = {name: 0 for name in K.KERNELS}
    check_kernels(torch, max_err)

    log("[3] MobileNetV2 1.0_224 fp32, seed 0, batch 1: card vs CPU plain")
    with torch.inference_mode():
        fn, (params, x) = entry()
        fn_cpu, (params_cpu, x_cpu) = entry(device="cpu")
        y = fn(params, x)
        y_cpu = fn_cpu(params_cpu, x_cpu)
        if y.shape != (1, 1000) or y.dtype != torch.uint8:
            raise AssertionError(f"logits {tuple(y.shape)} {y.dtype}")
        if not torch.equal(y.cpu(), y_cpu):
            diff = (y.cpu().int() - y_cpu.int()).abs()
            raise AssertionError(f"forward differs in {int((diff > 0).sum())}"
                                 f" logits, max |err| {int(diff.max())}")
        if int(y_cpu.max()) == int(y_cpu.min()):
            raise AssertionError("logits are constant")
        log(f"    equal; logits min {int(y_cpu.min())} max {int(y_cpu.max())}")

        log("[4] launches over one forward (main path)")
        K.reset_launch_counts()
        fn(params, x)
        torch.cuda.synchronize()
        launches = K.launch_counts()
        log(f"    {launches}")
        if launches != EXPECTED_LAUNCHES:
            raise AssertionError(f"launches {launches} != {EXPECTED_LAUNCHES}")

    log("[5] InferenceServer: 16 single-image requests")
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (16, 224, 224, 3),
                          dtype=np.int64).astype(np.uint8)
    with torch.inference_mode():
        direct = fn(params, torch.from_numpy(images).cuda()).cpu().numpy()
    K.reset_launch_counts()
    server = InferenceServer(lambda xb: fn(params, xb), (224, 224, 3),
                             max_batch=8)
    with server:
        futures = [server.submit(img, block=True) for img in images]
        answers = [f.result(timeout=300) for f in futures]
    torch.cuda.synchronize()
    served = K.launch_counts()
    for i, ans in enumerate(answers):
        if not np.array_equal(ans, direct[i]):
            raise AssertionError(f"served answer {i} != batch forward row")
    batches = server.stats.batches
    if served != {k: v * batches for k, v in EXPECTED_LAUNCHES.items()}:
        raise AssertionError(f"served launches {served} for {batches} "
                             "batches")
    log(f"    16 answers equal the batch forward; {batches} batches, "
        f"launches {served}, p50 latency "
        f"{server.stats.latency_percentile(50):.2f} ms")

    log("[6] timings (CUDA events, median of repeats)")
    with torch.inference_mode():
        ips1, ms1 = forward_ips(torch, fn, params, x, iters=20)
        xb = torch.from_numpy(rng.integers(0, 256, (128, 224, 224, 3),
                                           dtype=np.int64).astype(np.uint8)).cuda()
        ips128, ms128 = forward_ips(torch, fn, params, xb, iters=3)
        del xb
        log(f"    forward batch 1: {ms1:.3f} ms, {ips1:.1f} img/s")
        log(f"    forward batch 128: {ms128:.3f} ms, {ips128:.1f} img/s")
        # The same seed-0 model as entry(), built again for its spec.
        params, spec = build_mobilenet_v2(np.random.default_rng(0),
                                          device="cuda")
        per_batch = {}
        for batch in (1, 128):
            rows = time_main_path(torch, params, spec, batch,
                                  np.random.default_rng(batch), max_err)
            per_batch[batch] = rows
            for name in K.KERNELS:
                s = summarize(rows, name)
                lib = ("-" if s["library_ms"] is None
                       else f"{s['library_ms']:.4f}")
                log(f"    b{batch:<3d} {name:10s} {s['shapes']:2d} launches: "
                    f"{s['ms']:.4f} ms, bound {s['bound_ms']:.4f} ms "
                    f"({s['bound_by']}), plain {s['plain_ms']:.4f} ms, "
                    f"_int_mm {lib} ms")

    kernels_line = []
    for name in K.KERNELS:
        s = summarize(per_batch[128], name)
        source, replaces = SOURCES[name]
        kernels_line.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=max_err[name],
            ms=s["ms"], plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
            bound_by=s["bound_by"], library_ms=s["library_ms"]))

    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(dict(
        card=smi, torch=torch.__version__, cuda=torch.version.cuda,
        forward={"b1_ms": ms1, "b1_img_per_s": ips1, "b128_ms": ms128,
                 "b128_img_per_s": ips128},
        launches_per_forward=launches, served_batches=batches,
        kernels=kernels_line,
        per_shape={str(b): rows for b, rows in per_batch.items()}),
        indent=1))
    log("    per-shape times: chiprun_out/chip_smoke.json "
        "(kernel ms in the line below are per batch-128 forward)")
    print(json.dumps({"kernels": kernels_line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
