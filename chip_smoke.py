#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (qnnpack_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA GPU (built for sm_90a: an H100) and nvcc; exits non-zero
without them.  Two main paths, each through qnnpack_tpu_torch.entry (seed
0, fp32 requant, 224): MobileNetV2 1.0_224 and ResNet-18 through the graph
runtime.  Phases, each of which raises on any failure:

  1. print the card (nvidia-smi name and power limit) and versions, build
     the seven CUDA kernels from qnnpack_tpu_torch/kernels/csrc/;
  2. hold every kernel against its plain PyTorch version, run on CPU copies
     of the same inputs, at the main paths' shapes plus kzp != 128, q31,
     precise, gemmlowp, per-channel, ragged-channel and odd-size cases:
     torch.equal, zero tolerance (the integer math is exact);
  3. for each model, batch 1: the forward on the card must equal the plain
     CPU forward byte for byte;
  4. for each model, count kernel launches over one forward (counts set to
     0 just before it, read just after):
       MobileNetV2  q8gemm 35, q8stem 1, q8dwconv 17, q8vadd 10, q8gavgpool 1
       ResNet-18    q8stem 1, u8maxpool 1, q8conv 19, q8vadd 8,
                    q8gavgpool 1, q8gemm 1;
  5. serve single-image requests through qnnpack_tpu_torch.serving
     .InferenceServer (16 MobileNetV2, 8 ResNet-18); every answer must
     equal its row of a direct batch forward;
  6. time with CUDA events (warm-up, median of repeats): each model's
     forward img/s at batch 1 and 128, and every kernel launch of each
     forward, on that layer's real input, beside its bound
     max(bytes / 3.35 TB/s, int8 ops / 1979 TOP/s), its plain version on
     the card and a library yardstick (torch._int_mm on the im2col matrix,
     product only, for q8gemm, q8conv and q8stem; none for the others:
     F.max_pool2d, for one, has no uint8 kernel on the card); each
     launch's output must equal its plain version's.  The MobileNetV2 stem's old route (im2col
     + q8gemm) is timed beside q8stem at its shape.

Prints the {"kernels": [...]} line (launches over one batch-1 forward of
each path, times summed over one batch-128 forward of each path), the
nvidia-smi line and, last, {"ok": true, "device": {...}}.  Per-shape
timings go to chiprun_out/chip_smoke.json.
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
EXPECTED_LAUNCHES = {
    "mobilenet_v2": {"q8gemm": 35, "q8dwconv": 17, "q8vadd": 10,
                     "q8gavgpool": 1, "q8conv": 0, "q8stem": 1,
                     "u8maxpool": 0},
    "resnet18": {"q8gemm": 1, "q8dwconv": 0, "q8vadd": 8, "q8gavgpool": 1,
                 "q8conv": 19, "q8stem": 1, "u8maxpool": 1},
}
SERVED = {"mobilenet_v2": 16, "resnet18": 8}
SOURCES = {
    "q8gemm": ("qnnpack_tpu_torch/kernels/csrc/q8gemm.cu",
               "qnnpack_tpu/kernels/q8gemm_small.py:134"),
    "q8dwconv": ("qnnpack_tpu_torch/kernels/csrc/q8dwconv.cu",
                 "qnnpack_tpu/kernels/q8dwconv.py:95"),
    "q8vadd": ("qnnpack_tpu_torch/kernels/csrc/q8vadd.cu",
               "qnnpack_tpu/kernels/vpu_ops.py:89"),
    "q8gavgpool": ("qnnpack_tpu_torch/kernels/csrc/q8gavgpool.cu",
                   "qnnpack_tpu/kernels/pool.py:165"),
    "q8conv": ("qnnpack_tpu_torch/kernels/csrc/q8conv.cu",
               "qnnpack_tpu/kernels/q8conv.py:80"),
    "q8stem": ("qnnpack_tpu_torch/kernels/csrc/q8stem.cu",
               "qnnpack_tpu/kernels/q8stem.py:109"),
    "u8maxpool": ("qnnpack_tpu_torch/kernels/csrc/u8maxpool.cu",
                  "qnnpack_tpu/kernels/pool.py:62"),
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

    def rparams(scheme, n, rkw):
        if scheme == "pc":
            return compute_per_channel_fp32_params(
                rng.uniform(1e-4, 2e-3, n), 117)
        return make_requant_params(scheme, 0.0037, 117, **rkw)

    # q8gemm: (label, M, K, N, izp, kzp, scheme or "pc", rp kwargs)
    gemm_cases = [
        ("expand 12544x16->96", 12544, 16, 96, 128, 128, "fp32", relu6),
        ("project 49x960->160", 49, 960, 160, 128, 128, "fp32", {}),
        ("head 49x320->1280", 49, 320, 1280, 128, 128, "fp32", relu6),
        ("fc 1x1280->1000", 1, 1280, 1000, 128, 128, "fp32", {}),
        ("fc 128x512->1000", 128, 512, 1000, 128, 128, "fp32", {}),
        ("kzp 103, q31 300x77->50", 300, 77, 50, 121, 103, "q31", {}),
        ("kzp 90, precise 65x200->70", 65, 200, 70, 7, 90, "precise", {}),
        ("kzp 200, gemmlowp 130x33->129", 130, 33, 129, 250, 200,
         "gemmlowp", {}),
        ("per-channel kzp 99 257x40->72", 257, 40, 72, 121, 99, "pc", {}),
        ("ragged 1x1->1", 1, 1, 1, 121, 103, "fp32", {}),
        ("ragged kzp 77, q31 67x961->65", 67, 961, 65, 3, 77, "q31", {}),
    ]
    for label, m, k, n, izp, kzp, scheme, rkw in gemm_cases:
        kernel, bias = u8(n, k), rng.integers(-9000, 9000, n).astype(np.int32)
        rp = rparams(scheme, n, rkw)
        a = torch.from_numpy(u8(m, k))
        want = K.q8gemm_plain(a, pack_gemm_weights(kernel, bias, izp, kzp),
                              rp)
        got = K.q8gemm_cuda(a.to(cuda), pack_gemm_weights(
            kernel, bias, izp, kzp, device=cuda), rp)
        check("q8gemm", label, got, want)

    # q8conv: (label, B, H, W, C, O, k, stride, padding, dilation, izp,
    # kzp, scheme, rp kwargs)
    s2 = ((0, 1), (0, 1))
    p1 = ((1, 1), (1, 1))
    p0 = ((0, 0), (0, 0))
    conv_cases = [
        ("s0 3x3 56x56x64->64", 1, 56, 56, 64, 64, 3, 1, p1, 1, 128, 128,
         "fp32", relu6),
        ("s1a 3x3 s2 56x56x64->128", 1, 56, 56, 64, 128, 3, 2, s2, 1, 128,
         128, "fp32", relu6),
        ("proj 1x1 s2 56x56x64->128", 1, 56, 56, 64, 128, 1, 2, p0, 1, 128,
         128, "fp32", {}),
        ("s3 3x3 7x7x512->512", 1, 7, 7, 512, 512, 3, 1, p1, 1, 128, 128,
         "fp32", {}),
        ("mnv2 stem 3x3 s2 224x224x3->32", 1, 224, 224, 3, 32, 3, 2, s2, 1,
         128, 128, "fp32", relu6),
        ("kzp 103, q31, izp 121 13x11x24->40", 2, 13, 11, 24, 40, 3, 1, p1,
         1, 121, 103, "q31", {}),
        ("kzp 90, precise C=5 K=45 s2", 3, 9, 7, 5, 70, 3, 2, s2, 1, 7, 90,
         "precise", {}),
        ("kzp 200, gemmlowp dil 2 12x10x16->33", 1, 12, 10, 16, 33, 3, 1,
         ((2, 2), (2, 2)), 2, 250, 200, "gemmlowp", {}),
        ("per-channel kzp 99 C=3 s2 17x17->72", 2, 17, 17, 3, 72, 3, 2, s2,
         1, 121, 99, "pc", {}),
        ("ragged C=20 K=180 5x5 s1 11x9->65", 1, 11, 9, 20, 65, 3, 1, p1,
         1, 3, 77, "q31", {}),
    ]
    for (label, bsz, h, w, c, o, k, s, pad, d, izp, kzp, scheme,
         rkw) in conv_cases:
        kernel = u8(o, k, k, c)
        bias = rng.integers(-9000, 9000, o).astype(np.int32)
        rp = rparams(scheme, o, rkw)
        a = torch.from_numpy(u8(bsz, h, w, c))
        args = dict(strides=(s, s), padding=pad, dilation=(d, d))
        want = K.q8conv_plain(a, pack_conv_weights(kernel, bias, izp, kzp),
                              rp, **args)
        got = K.q8conv_cuda(a.to(cuda), pack_conv_weights(
            kernel, bias, izp, kzp, device=cuda), rp, **args)
        check("q8conv", label, got, want)

    # q8stem (stride 2, kzp 128): (label, B, H, W, C, O, k, padding, izp,
    # scheme, rp kwargs)
    stem_cases = [
        ("resnet 7x7 224x224x3->64", 1, 224, 224, 3, 64, 7,
         ((2, 3), (2, 3)), 128, "fp32", {"qmin": 128}),
        ("mnv2 3x3 224x224x3->32", 1, 224, 224, 3, 32, 3, s2, 128, "fp32",
         relu6),
        ("per-channel izp 121 7x7 19x21x3->32", 2, 19, 21, 3, 32, 7,
         ((2, 3), (2, 3)), 121, "pc", {}),
        ("q31 odd 23x17x4->24 5x5", 3, 23, 17, 4, 24, 5, ((2, 2), (2, 2)),
         121, "q31", {}),
        ("C=1 O=8 15x15 pad 1", 1, 15, 15, 1, 8, 3, p1, 7, "gemmlowp", {}),
    ]
    for label, bsz, h, w, c, o, k, pad, izp, scheme, rkw in stem_cases:
        kernel = u8(o, k, k, c)
        bias = rng.integers(-9000, 9000, o).astype(np.int32)
        rp = rparams(scheme, o, rkw)
        a = torch.from_numpy(u8(bsz, h, w, c))
        want = K.q8stem_plain(a, pack_conv_weights(kernel, bias, izp, 128),
                              rp, pad)
        got = K.q8stem_cuda(a.to(cuda), pack_conv_weights(
            kernel, bias, izp, 128, device=cuda), rp, pad)
        check("q8stem", label, got, want)

    # q8dwconv: (label, B, H, W, C, stride, padding, dilation, izp, kzp,
    # scheme)
    dw_cases = [
        ("112x112x96 s2 pad(0,1)", 1, 112, 112, 96, 2, s2, 1, 128, 128,
         "fp32"),
        ("14x14x576 s1 pad 1", 1, 14, 14, 576, 1, p1, 1, 128, 128, "fp32"),
        ("kzp 103, q31 13x11x24 s1", 1, 13, 11, 24, 1, p1, 1, 121, 103,
         "q31"),
        ("per-channel kzp 90 14x14x40 s2", 1, 14, 14, 40, 2, p1, 1, 121, 90,
         "pc"),
        ("dilation 2 gemmlowp 12x10x16", 1, 12, 10, 16, 2, ((2, 2), (2, 2)),
         2, 7, 200, "gemmlowp"),
        ("batch 3, precise 9x7x33 s2 pad(0,1)", 3, 9, 7, 33, 2, s2, 1, 250,
         140, "precise"),
    ]
    for label, bsz, h, w, c, s, pad, d, izp, kzp, scheme in dw_cases:
        kernel = u8(c, 3, 3, 1)
        bias = rng.integers(-9000, 9000, c).astype(np.int32)
        rp = rparams(scheme, c, {})
        a = torch.from_numpy(u8(bsz, h, w, c))
        args = dict(strides=(s, s), padding=pad, dilation=(d, d))
        want = K.q8dwconv_plain(
            a, pack_conv_weights(kernel, bias, izp, kzp, groups=c), rp,
            **args)
        got = K.q8dwconv_cuda(a.to(cuda), pack_conv_weights(
            kernel, bias, izp, kzp, groups=c, device=cuda), rp, **args)
        check("q8dwconv", label, got, want)

    # u8maxpool: (label, shape, pool, strides, padding, dilation, clamp)
    pool_cases = [
        ("resnet pool1 112x112x64 3x3 s2", (1, 112, 112, 64), (3, 3),
         (2, 2), s2, (1, 1), (0, 255)),
        ("squeezenet 111x111x96 3x3 s2", (1, 111, 111, 96), (3, 3), (2, 2),
         p0, (1, 1), (0, 255)),
        ("vgg 2x2 s2 14x14x512", (2, 14, 14, 512), (2, 2), (2, 2), p0,
         (1, 1), (0, 255)),
        ("clamp 20/250 odd 13x11x17", (2, 13, 11, 17), (3, 3), (2, 2), p1,
         (1, 1), (20, 250)),
        ("clamp 20/250 C=3 dil 2 12x9", (3, 12, 9, 3), (3, 2), (1, 2),
         ((2, 1), (0, 2)), (2, 1), (20, 250)),
    ]
    for label, shape, pool, strides, pad, dil, (lo, hi) in pool_cases:
        x = torch.from_numpy(u8(*shape))
        check("u8maxpool", label,
              K.u8maxpool_cuda(x.to(cuda), pool, strides, pad, dil, lo, hi),
              K.u8maxpool_plain(x, pool, strides, pad, dil, lo, hi))

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
            ("128x49x512", (128, 49, 512), compute_avgpool_quant_params(
                -128 * 49, 1.0 / 49, 128, input_zero_point=128)),
            ("3x9x33 scale 3.7 zp 7", (3, 9, 33), compute_avgpool_quant_params(
                -7 * 9, 3.7 / 9, 100, 20, 230, input_zero_point=7))]:
        x = torch.from_numpy(u8(*shape))
        check("q8gavgpool", label, K.q8gavgpool_cuda(x.to(cuda), params),
              K.q8gavgpool_plain(x, params))
    torch.cuda.synchronize()


# ------------------------------------------------ phase 6: main-path calls
def traced_inputs(model, params, spec, x):
    """Run one forward layer by layer; yield (tag, name, layer, packed,
    input, residual) for every layer, with the layer's real input (for an
    add, `layer` is its AddQuantParams and `residual` the saved operand)."""
    if model == "mobilenet_v2":
        from qnnpack_tpu_torch.models.mobilenet_v2 import apply_layer
        residual = None
        for (tag, name, layer), p in zip(spec.layers, params):
            yield tag, name, layer, p, x, residual
            x, residual = apply_layer(tag, layer, p, x, residual)
        return
    from qnnpack_tpu_torch.models.graph import _graph_layer
    env = {}
    for (tag, name, payload), p in zip(spec.layers, params):
        if tag == "add":
            yield tag, name, payload[1], p, x, env[payload[0]]
        else:
            yield tag, name, payload, p, x, None
        x = _graph_layer(tag, payload, p, x, env)


def int_mm_yardstick(torch, a, w):
    """torch._int_mm of biased uint8 A [M, K] by int8 W [K, N] (the
    product only), K padded to a multiple of 8; None where cuBLASLt's int8
    GEMM does not take the shape."""
    from qnnpack_tpu_torch.nn.dtypes import u8_to_biased_i8
    m, k = a.shape
    if m <= 16 or w.shape[1] % 8:
        return None
    a8 = u8_to_biased_i8(a)
    if k % 8:
        a8 = torch.nn.functional.pad(a8, (0, 8 - k % 8))
        w = torch.nn.functional.pad(w, (0, 0, 0, 8 - k % 8))
    # cuBLASLt's int8 GEMM takes the second operand column-major.
    w8 = w.t().contiguous().t()
    return lambda: torch._int_mm(a8, w8)


def kernel_calls(torch, model, params, spec, x):
    """One record per kernel launch of the forward on `x`: its kernel, a
    label, closures running the kernel, the plain version and the library
    yardstick on the card, and the bytes and ops of the work."""
    from qnnpack_tpu_torch import kernels as K
    from qnnpack_tpu_torch.nn.conv import dense_conv_route, im2col

    for tag, name, layer, p, a, other in traced_inputs(model, params, spec,
                                                       x):
        if tag == "add":
            n = a.numel()
            yield dict(kernel="q8vadd", label=f"{name} {tuple(a.shape)}",
                       run=lambda a=a, b=other, l=layer: K.q8vadd_cuda(a, b, l),
                       plain=lambda a=a, b=other, l=layer: K.q8vadd_plain(
                           a, b, l),
                       library=None, bytes=3 * n, ops=4 * n)
        elif tag == "gap":
            bsz, h, w, c = a.shape
            a3 = a.reshape(bsz, h * w, c)
            yield dict(kernel="q8gavgpool", label=f"{name} {tuple(a3.shape)}",
                       run=lambda a3=a3, q=layer: K.q8gavgpool_cuda(a3, q),
                       plain=lambda a3=a3, q=layer: K.q8gavgpool_plain(a3, q),
                       library=None, bytes=a3.numel() + bsz * c,
                       ops=a3.numel())
        elif tag == "maxpool":
            pool, strides, padding = layer
            out = K.u8maxpool_cuda(a, pool, strides, padding)
            # No yardstick: F.max_pool2d has no uint8 kernel on the card.
            yield dict(kernel="u8maxpool",
                       label=f"{name} {tuple(a.shape)} {pool} s{strides[0]}",
                       run=lambda a=a, l=layer: K.u8maxpool_cuda(a, *l),
                       plain=lambda a=a, l=layer: K.u8maxpool_plain(a, *l),
                       library=None, bytes=a.numel() + out.numel(),
                       ops=out.numel() * pool[0] * pool[1])
        elif tag == "gemm" or (tag == "conv" and layer.kind == "gemm"):
            a2 = a.reshape(-1, a.shape[-1])
            m, k = a2.shape
            yield dict(kernel="q8gemm", label=f"{name} {m}x{k}->{p.n}",
                       run=lambda a2=a2, p=p, l=layer: K.q8gemm_cuda(
                           a2, p, l.rparams),
                       plain=lambda a2=a2, p=p, l=layer: K.q8gemm_plain(
                           a2, p, l.rparams),
                       library=int_mm_yardstick(torch, a2, p.w),
                       bytes=m * k + k * p.n + 4 * p.n + m * p.n,
                       ops=2 * m * p.n * k)
        elif tag == "conv" and p.groups > 1:  # depthwise
            c = a.shape[-1]
            kw_ = dict(strides=layer.strides, padding=layer.padding)
            out = K.q8dwconv_cuda(a, p, layer.rparams, **kw_)
            taps = p.kernel_height * p.kernel_width
            yield dict(
                kernel="q8dwconv",
                label=f"{name} {tuple(a.shape)} s{layer.strides[0]}",
                run=lambda a=a, p=p, l=layer, kw_=kw_: K.q8dwconv_cuda(
                    a, p, l.rparams, **kw_),
                plain=lambda a=a, p=p, l=layer, kw_=kw_: K.q8dwconv_plain(
                    a, p, l.rparams, **kw_),
                library=None,
                bytes=a.numel() + (taps + 4) * c + out.numel(),
                ops=2 * taps * out.numel())
        elif tag == "conv":  # dense
            kernel = dense_conv_route(p, layer.strides)
            cols, _ = im2col(a, p, layer.strides, layer.padding)
            m, k = cols.shape
            o = p.w.shape[-1]
            if kernel == "q8stem":
                run = (lambda a=a, p=p, l=layer: K.q8stem_cuda(
                    a, p, l.rparams, l.padding))
                plain = (lambda a=a, p=p, l=layer: K.q8stem_plain(
                    a, p, l.rparams, l.padding))
            else:
                run = (lambda a=a, p=p, l=layer: K.q8conv_cuda(
                    a, p, l.rparams, l.strides, l.padding))
                plain = (lambda a=a, p=p, l=layer: K.q8conv_plain(
                    a, p, l.rparams, l.strides, l.padding))
            yield dict(
                kernel=kernel,
                label=f"{name} {tuple(a.shape)} {p.kernel_height}x"
                      f"{p.kernel_width} s{layer.strides[0]} ->{o}",
                run=run, plain=plain,
                library=int_mm_yardstick(torch, cols, p.as_gemm().w),
                bytes=a.numel() + p.w.numel() + 4 * o + m * o,
                ops=2 * m * o * k,
                old_route=(lambda a=a, p=p, l=layer: K.q8gemm_cuda(
                    im2col(a, p, l.strides, l.padding)[0], p.as_gemm(),
                    l.rparams)) if kernel == "q8stem" else None)
            del cols


def time_main_path(torch, model, params, spec, x, err, plain_repeats):
    """Time every kernel launch of the forward on `x`, its plain version
    and yardstick; each kernel's output must equal its plain version's."""
    rows = []
    for call in kernel_calls(torch, model, params, spec, x):
        compare(torch, err, call["kernel"], call["label"], call["run"](),
                call["plain"](), quiet=True)
        row = dict(kernel=call["kernel"], label=call["label"],
                   bytes=call["bytes"], ops=call["ops"],
                   ms=time_ms(call["run"], torch),
                   plain_ms=time_ms(call["plain"], torch,
                                    repeats=plain_repeats),
                   library_ms=(time_ms(call["library"], torch)
                               if call["library"] is not None else None))
        if call.get("old_route") is not None:
            row["old_route_ms"] = time_ms(call["old_route"], torch)
        rows.append(row)
        torch.cuda.empty_cache()
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
        library_ms=(sum(lib) if mine and all(v is not None for v in lib)
                    else None),
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
        if "registers" in line or "spill" in line or "---" in line:
            log(f"    ptxas: {line.strip()}")

    log("[2] kernels against their plain versions (CPU copies, torch.equal)")
    max_err = {name: 0 for name in K.KERNELS}
    check_kernels(torch, max_err)

    models = {}
    launches = {}
    with torch.inference_mode():
        for model in EXPECTED_LAUNCHES:
            log(f"[3] {model} 224 fp32, seed 0, batch 1: card vs CPU plain")
            fn, (params, x) = entry(model=model)
            fn_cpu, (params_cpu, x_cpu) = entry(device="cpu", model=model)
            models[model] = (fn, params, x)
            y = fn(params, x)
            y_cpu = fn_cpu(params_cpu, x_cpu)
            del params_cpu
            if y.shape != (1, 1000) or y.dtype != torch.uint8:
                raise AssertionError(f"logits {tuple(y.shape)} {y.dtype}")
            if not torch.equal(y.cpu(), y_cpu):
                diff = (y.cpu().int() - y_cpu.int()).abs()
                raise AssertionError(
                    f"forward differs in {int((diff > 0).sum())} logits, "
                    f"max |err| {int(diff.max())}")
            if int(y_cpu.max()) == int(y_cpu.min()):
                raise AssertionError("logits are constant")
            log(f"    equal; logits min {int(y_cpu.min())} max "
                f"{int(y_cpu.max())}")

            log(f"[4] {model}: launches over one forward (main path)")
            K.reset_launch_counts()
            fn(params, x)
            torch.cuda.synchronize()
            launches[model] = K.launch_counts()
            log(f"    {launches[model]}")
            if launches[model] != EXPECTED_LAUNCHES[model]:
                raise AssertionError(f"launches {launches[model]} != "
                                     f"{EXPECTED_LAUNCHES[model]}")

    rng = np.random.default_rng(7)
    served_batches = {}
    latency = {}
    for model, count in SERVED.items():
        fn, params, _ = models[model]
        log(f"[5] {model} InferenceServer: {count} single-image requests")
        images = rng.integers(0, 256, (count, 224, 224, 3),
                              dtype=np.int64).astype(np.uint8)
        with torch.inference_mode():
            direct = fn(params, torch.from_numpy(images).cuda()).cpu().numpy()
        K.reset_launch_counts()
        server = InferenceServer(lambda xb, fn=fn, p=params: fn(p, xb),
                                 (224, 224, 3), max_batch=8)
        with server:
            futures = [server.submit(img, block=True) for img in images]
            answers = [f.result(timeout=300) for f in futures]
        torch.cuda.synchronize()
        served = K.launch_counts()
        for i, ans in enumerate(answers):
            if not np.array_equal(ans, direct[i]):
                raise AssertionError(f"served answer {i} != batch forward "
                                     "row")
        batches = server.stats.batches
        want = {k: v * batches for k, v in EXPECTED_LAUNCHES[model].items()}
        if served != want:
            raise AssertionError(f"served launches {served} for {batches} "
                                 "batches")
        served_batches[model] = batches
        latency[model] = server.stats.latency_percentile(50)
        log(f"    {count} answers equal the batch forward; {batches} "
            f"batches, launches {served}, p50 latency {latency[model]:.2f} "
            "ms")

    log("[6] timings (CUDA events, median of repeats)")
    forward = {}
    per_shape = {}
    with torch.inference_mode():
        for model, (fn, params, x) in models.items():
            ips1, ms1 = forward_ips(torch, fn, params, x, iters=20)
            xb = torch.from_numpy(rng.integers(
                0, 256, (128, 224, 224, 3),
                dtype=np.int64).astype(np.uint8)).cuda()
            ips128, ms128 = forward_ips(torch, fn, params, xb, iters=3)
            forward[model] = {"b1_ms": ms1, "b1_img_per_s": ips1,
                              "b128_ms": ms128, "b128_img_per_s": ips128}
            log(f"    {model} forward batch 1: {ms1:.3f} ms, {ips1:.1f} "
                "img/s")
            log(f"    {model} forward batch 128: {ms128:.3f} ms, "
                f"{ips128:.1f} img/s")
            for batch, xin in ((1, x), (128, xb)):
                rows = time_main_path(torch, model, params, fn.spec, xin,
                                      max_err, 3 if batch == 1 else 1)
                per_shape[f"{model} b{batch}"] = rows
                for name in K.KERNELS:
                    s = summarize(rows, name)
                    if not s["shapes"]:
                        continue
                    lib = ("-" if s["library_ms"] is None
                           else f"{s['library_ms']:.4f}")
                    log(f"    {model} b{batch:<3d} {name:10s} "
                        f"{s['shapes']:2d} launches: {s['ms']:.4f} ms, "
                        f"bound {s['bound_ms']:.4f} ms ({s['bound_by']}), "
                        f"plain {s['plain_ms']:.4f} ms, library {lib} ms")
                for r in rows:
                    if "old_route_ms" in r:
                        log(f"    {model} b{batch} stem {r['label']}: "
                            f"q8stem {r['ms']:.4f} ms, old route im2col + "
                            f"q8gemm {r['old_route_ms']:.4f} ms")
            del xb
            torch.cuda.empty_cache()

    b128 = [r for key, rows in per_shape.items() if key.endswith("b128")
            for r in rows]
    kernels_line = []
    for name in K.KERNELS:
        s = summarize(b128, name)
        source, replaces = SOURCES[name]
        kernels_line.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(launches[m][name] for m in launches),
            launches_by_path={m: launches[m][name] for m in launches},
            max_abs_err=max_err[name], ms=s["ms"], plain_ms=s["plain_ms"],
            bound_ms=s["bound_ms"], bound_by=s["bound_by"],
            library_ms=s["library_ms"]))

    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(dict(
        card=smi, torch=torch.__version__, cuda=torch.version.cuda,
        forward=forward, launches_per_forward=launches,
        served_batches=served_batches, served_p50_ms=latency,
        kernels=kernels_line, per_shape=per_shape), indent=1))
    log("    per-shape times: chiprun_out/chip_smoke.json "
        "(kernel ms in the line below are summed over one batch-128 "
        "forward of each path)")
    print(json.dumps({"kernels": kernels_line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
