#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (qnnpack_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA GPU (built for sm_90a: an H100), nvcc and a host C/C++
compiler; exits non-zero without them.  Eight main paths: five models
through qnnpack_tpu_torch.entry (seed 0, fp32 requant) - MobileNetV2
1.0_224, ResNet-18 and ShuffleNet v1 (groups = 3) through the graph
runtime at 224, the ENet-style segmentation net (its three deconvs) at
256, and the int8 BERT-base encoder at sequence 128 - the
lifecycle API's operators (qnnpack_tpu_torch.ops), and the two bundled
int8 TFLite models (assets/mobilenet_v2_int8.tflite, assets/
squeezenet_v11_int8.tflite) through qnnpack_tpu_torch.io.import_tflite
and the graph runtime.  Phases, each of which raises on any failure:

  1. print the card (nvidia-smi name and power limit) and versions, build
     the eighteen CUDA kernel sources from qnnpack_tpu_torch/kernels/csrc/;
  2. hold every kernel against its plain PyTorch version, run on CPU copies
     of the same inputs, at the main paths' shapes plus kzp != 128, q31,
     precise, gemmlowp, per-channel, ragged-channel, odd-size, grouped
     (g = 2, 3, 4, 8), izp != 128, all three q8bmm zero-point cases, odd N
     and rows off a 4-byte boundary; for q8gemm and q8conv every block
     shape and split-K plan of kernels/q8gemm.py:tile_plan (each must be
     exercised), K = 1 to 70,000 (sums past 2^31), bases 8 bytes off 16,
     split-K q8gemm launches in flight on two streams at once, q8gemm's
     wgmma instance (check_wgmma: BERT's four b128 projections, ragged M
     and N, kzp' 0 and 103, all five schemes, a CUDA-graph replay, each
     launch counted in the recorder's q8gemm.wgmma); every
     instance of q8dwconv (4 or 1 channels a thread x 3x3 stride 1, 3x3
     stride 2 or any window) and both block shapes of q8stem must run, as
     the wrappers record what each launch named to its kernel
     (q8dwconv_cuda.instance, q8stem_cuda.tile); q8bmm on strided views
     (BERT's scores and context at batch 1 as views of a real qkv tensor,
     the context written through out=, the tiny config's dh = 16 at stride
     96, bases 8 bytes off 16, K-major B with za != 0, K = 70,000 with sums
     past 2^31); q8vadd on all 65,536 (a, b) pairs under three parameter
     sets, 1, 15, 16 and 17 bytes and a base 1 byte off 16; u8rmax and
     u8lut32norm on every instance of kernels/vpu_ops.py:row_instance (16,
     8 or 1 bytes a lane, 1 to 32 lanes a row; each must run, as the
     wrappers record it in u8rmax_cuda.instance / u8lut32norm_cuda.instance)
     at N = 1 to 4096, R = 1,537, bases 1, 2, 4 and 8 bytes off, BERT's
     196,608 x 128 b128 scores, tables past 2^31 and rows whose sum wraps
     to 0 (all 255); u8maxpool and q8avgpool on every instance of
     kernels/pool.py:pool_instance (16, 8, 4 or 1 bytes a thread x the
     3x3 stride-2 window or any window, and for q8avgpool any window with
     32-bit sums; each must run, as the wrappers record it in
     u8maxpool_cuda.instance / q8avgpool_cuda.instance) at the b128
     main-path shapes (ResNet-18's and ShuffleNet's pool1, ShuffleNet's
     three shortcut avgpools), bases 1, 4 and 8 bytes off 16, C = 3 to
     512, 2x2 s2, 3x3 s1 pad 1, dilation 2, clamp 20/250, izp 0, 7 and
     250, 16x16 and 17x17 avg windows, all-255 and all-0 windows and a
     bias whose sums wrap int32; q8gavgpool on every instance of
     kernels/pool.py:gavgpool_instance (16, 8, 4 or 1 bytes a thread x
     sums in 16-bit halves or 32 bits; each must run, as the wrapper
     records it in q8gavgpool_cuda.instance) at the three b128 model pools,
     bases 1, 4 and 8 bytes off 16, C = 1 to 1,280, S = 257, 258 and
     4,096, all-255 and all-0 rows and a bias whose sum wraps int32:
     torch.equal, zero tolerance (the integer math is exact).  Then
     deconvolution (check_deconvs): ENet's three k == s deconvs (each
     plan's q8gemm launch against its plain version, then the whole
     deconv) and nn/conv.py:q8deconv2d at every lowering (k == s with
     groups 1 and 2, the phases with padding and adjustment, k < s, a
     depthwise deconv on q8dwconv, stride 1, dilation 2 at stride 2) at
     zero points (121, 103), card == CPU, each launching what its plan
     names; the row-sum pair (check_row_sums: q8gemm's producer and
     consumer instances, y, rs and the consumer's output each equal to
     their plain versions and to plain q8gemm, kzp != 128 on both stages,
     each stage split over K and not, BERT's b128 out -> ffn1 chain timed
     beside plain q8gemm); the float ops (check_float_ops: sgemm, hgemm,
     sconv2d, sdwconv2d on the card against their CPU run, within
     tests/test_float_ops.py's tolerances);
  3. for each model, batch 1: the forward on the card must equal the plain
     CPU forward byte for byte (logits [1, 1000] for the classifiers,
     [1, 256, 256, 12] for ENet, hidden states [1, 128, 768] for BERT,
     not constant);
  4. for each model, count kernel launches over one forward (counts set to
     0 just before it, read just after):
       MobileNetV2  q8gemm 35, q8stem 1, q8dwconv 17, q8vadd 10, q8gavgpool 1
       ResNet-18    q8stem 1, u8maxpool 1, q8conv 19, q8vadd 8,
                    q8gavgpool 1, q8gemm 1
       ShuffleNet   q8stem 1, u8maxpool 1, q8gemm 2, q8conv 31 (grouped),
                    q8dwconv 16, q8avgpool 3, q8vadd 13, q8gavgpool 1
       ENet         q8stem 1, q8conv 11, q8gemm 19 (16 1x1 convs and the
                    3 deconvs), q8vadd 7 (plus 3 depth-to-space copies)
       BERT         q8gemm 48, q8bmm 24, u8rmax 12, u8lut32norm 12,
                    q8vadd 24
     and every other kernel 0; and under torch.profiler one BERT forward
     must launch no CUDA kernel that is not the port's (no head-transpose
     or other copy);
  5. serve single-sample requests through qnnpack_tpu_torch.serving
     .InferenceServer (16 MobileNetV2, 8 ResNet-18, 8 ShuffleNet, 8 ENet,
     8 BERT);
     every answer must equal its row of a direct batch forward; the server
     runs each bucket as a CUDA graph captured at first use, so the
     launches are 2 x the forward's per bucket captured (warm-up and
     capture) and none for a replay;
  6. the lifecycle operators (Add, Clamp, Sigmoid, LeakyReLU, SoftArgMax,
     ChannelShuffle; Convolution2D at each kernel type - 1x1 gemm,
     depthwise, dense 3x3 with dilation 2, grouped, the stem class at kzp
     128 and 103 - under every requant scheme and per-channel;
     FullyConnected at use_pallas=False and at odd K and N; MaxPooling2D,
     AveragePooling2D and GlobalAveragePooling with and without a range,
     17x17 average windows, global widths 49, 258 and 1,000;
     Deconvolution2D at each lowering - k == s, the phases of a 3x3
     stride-2 deconv with padding and adjustment, a stride-1 3x3 - at
     zero points (128, 128) and (121, 103) under q31 and fp32, a grouped
     k == s deconv at kzp 103 and a k < s one), created on the
     card, each lowered at its shape (Operator.lower captures, the run
     replays; unlowered, an operator runs eagerly, and Clamp at another
     shape must launch once): each output must equal its CPU run, each
     capture must launch its kernel once, all captures together exactly
     OPS_LAUNCHES (2 x with the warm-ups; the kernels line counts the
     captures', one run), and a second run replays with no launch and the
     same bytes; ten operators are timed as a graph (copy in, replay,
     clone) and eagerly, on the device and as a caller sees it; each
     lowering's Deconvolution2D (q31, kzp 103) is timed whole, its kernel
     launches alone and its copies alone; u8clamp is
     timed on a 128x56x56x96 tensor beside torch.clamp;
  7. the imported TFLite models (per-layer zero points, add rescales and
     per-channel scales): each imported with device="cuda" and "cpu"; 4
     synth_images (seed 17) quantized as ACCURACY.json's flow does
     (quantize_input, + 128) go onto the card through io.BatchPrefetcher,
     and each model's card forward must equal its CPU forward byte for
     byte; one batch-1 forward launches exactly IMPORTED_LAUNCHES (counts
     set to 0 just before, read just after) and misses the per-channel
     scale cache (_build._channel_scales) not once, as every scale lies on
     the card since the import; the native library (built from native/)
     resizes and quantizes a batch through io.image_pipeline within one
     quantum of its numpy version; 8 single-sample requests to the imported
     MobileNetV2 through InferenceServer each equal their batch-forward
     row.  Phase 8 times both as it times the five models;
  8. time with CUDA events (warm-up, median of repeats) the launch floor
     (a one-element zero_(), printed beside each q8gavgpool launch), each
     model's
     forward samples/s at batch 1 and 128, and every kernel launch of each
     forward, on that layer's real input, beside its bound
     max(bytes / 3.35 TB/s, int8 ops / 1979 TOP/s), its plain version on
     the card and one library call that computes the same product or
     reduction without requantization, on inputs already in its dtype and
     layout (conversion not timed; TF32 off, so float32 sums of integers
     below 2^24 are exact): torch._int_mm on the im2col matrix for q8gemm,
     dense q8conv and q8stem; F.conv2d in float32 (channels-last, groups =
     G) for grouped q8conv and q8dwconv; F.max_pool2d on float16 for
     u8maxpool; F.avg_pool2d in float32 with divisor 1 for q8avgpool;
     torch.sum to int32 for q8gavgpool; torch.bmm in float32 for q8bmm;
     torch.amax on uint8 for u8rmax; none for q8vadd (no one call computes
     add_quantize's two rescales and clamp) and u8lut32norm (no one call
     does the table lookup, the row sum and the uint32 divide).  Each
     launch's output must equal its plain version's; each q8gemm and
     q8conv row also holds its plan, TOP/s and share of its bound.  The
     MobileNetV2 stem's old route (im2col + q8gemm) is timed beside q8stem
     at its shape, and the data movement outside the kernels (the channel
     shuffles and concats, ENet's depth-to-space copies) as a sum per
     forward.  BERT's q8bmm runs on the forward's own views of the qkv
     output;
  9. captured forwards: config.initialize(); for each of the seven paths
     (the five models and the two imports) at batch 1 and 128, the forward
     through ops.base.jit_forward (one CUDA graph) must equal the eager
     forward byte for byte on two inputs, and its capture must launch the
     path's EXPECTED_LAUNCHES / IMPORTED_LAUNCHES; eager and captured
     forwards are timed in turns, with their rates and busy shares (phase
     8's kernel times summed over the forward's time); two graphs of four
     split-K q8gemm launches each, replayed at once on two streams for 40
     rounds, must equal their eager bytes; utils.timing's
     dispatch_overhead() and a measure_loop of MobileNetV2's b128
     classifier q8gemm beside its phase-8 time; InferenceServer.warmup()
     captures every bucket, and phase 5's requests must then get the same
     answers with no launch; HealthMonitor.probe_once() on the card;
     MiMo-V2-Flash's block (check_mimo) at its published widths, one b1
     forward eager and captured on two inputs, byte for byte, its capture
     launching MIMO_LAUNCHES and routing the same rows;
  10. the parallel layer (qnnpack_tpu_torch.parallel, check_parallel):
     the partial instances of q8gemm.cu and q8conv.cu (int32 sum_k A W' -
     kzp' sum_k A, no bias, no requantization) against their plain
     versions at every block shape and split-K plan, K = 70,000 with sums
     past +-2^31, kzp 128 and != 128, izp taps; q8requant against its
     plain version under the five schemes at N = 1,280, odd N and a base
     4 bytes off 16, with wrapping biases; the shard arithmetic of
     gemm_kdim_tp and conv_ic_tp for n = 2 and 4 on one card (each
     slice's partial launch, summed in int32 on the card, then q8requant)
     equal to unsharded q8gemm and q8conv at MobileNetV2's b128 head
     (6272x320->1280) and ResNet-18's 3x3 256->256 conv at 14x14, b128;
     then on a one-rank NCCL mesh (make_mesh(device="cuda")):
     MobileNetV2 1.0_224 b128 through shard_params + sharded_inference_fn
     + batch_sharding equal to entry's forward, gemm_kdim_tp and
     conv_ic_tp at those shapes (kzp 128 and 103), spatial_conv2d,
     pipeline_apply and grouped_conv2d_ep equal to their unsharded
     products; one run of the main path (the sharded forward,
     gemm_kdim_tp, conv_ic_tp; counts set to 0 just before) must launch
     PARALLEL_LAUNCHES.  Timed: each partial instance beside its plain
     kernel in turns, with its bound, plain version and _int_mm; q8requant
     against its bound by bytes; the sharded forward against entry's,
     eager and captured.  The process group is destroyed at the end (no
     phase forks after it).

Prints the {"kernels": [...]} line (launches over one batch-1 forward of
each path, launches_by_path beside them; times summed over one batch-128
forward of each of the five entry models; u8clamp's over the lifecycle run
and the 128x56x56x96 tensor; the partial instances' and q8requant's over
phase 10's main path at b128), the nvidia-smi line
and, last, {"ok": true, "device": {...}}.  Per-shape timings, nvcc's time,
the ptxas lines, phase 9's numbers (forward[model]: b1_graph_ms,
b128_graph_ms, ...; timing), the row-sum pair's times (row_sums) and the
deconv lowerings' (deconv_ops) and phase 10's (parallel) go to
chiprun_out/chip_smoke.json.  The
bounds divide by the card's data-sheet peaks from config.tune_params().
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from qnnpack_tpu_torch.kernels import KERNELS

# The card's data-sheet peaks, from the port's tuning table
# (qnnpack_tpu_torch/config.py); main() sets them through card_peaks().
HBM_BYTES_PER_S = None
INT8_OPS_PER_S = None


def _counts(**nonzero):
    return {name: nonzero.get(name, 0) for name in KERNELS}


EXPECTED_LAUNCHES = {
    "mobilenet_v2": _counts(q8gemm=35, q8dwconv=17, q8vadd=10, q8gavgpool=1,
                            q8stem=1),
    "resnet18": _counts(q8gemm=1, q8vadd=8, q8gavgpool=1, q8conv=19,
                        q8stem=1, u8maxpool=1),
    "shufflenet_v1_g3": _counts(q8gemm=2, q8dwconv=16, q8vadd=13,
                                q8gavgpool=1, q8conv=31, q8stem=1,
                                u8maxpool=1, q8avgpool=3),
    "enet_seg": _counts(q8stem=1, q8conv=11, q8gemm=19, q8vadd=7),
    "bert_base_s128": _counts(q8gemm=48, q8bmm=24, u8rmax=12, u8lut32norm=12,
                              q8vadd=24),
}
# ENet's 16 1x1 convs and its three 2x2 stride-2 deconvs (the k == s
# lowering: one q8gemm launch and a depth-to-space copy each) make its 19
# q8gemm launches; its 11 other convs (the 2x2 stride-2 downsamples and
# the 3x3 bodies) run on q8conv, the 3-channel stride-2 stem on q8stem.
# One batch-1 forward of each imported TFLite model (phase 7): every 1x1
# stride-1 conv and the FC on q8gemm, the depthwise convs on q8dwconv, the
# 3x3 convs of SqueezeNet's fire modules on q8conv; its 8 concats are
# PyTorch copies.
IMPORTED = {
    "mobilenet_v2_tflite": "assets/mobilenet_v2_int8.tflite",
    "squeezenet_v11_tflite": "assets/squeezenet_v11_int8.tflite",
}
IMPORTED_LAUNCHES = {
    "mobilenet_v2_tflite": _counts(q8gemm=35, q8stem=1, q8dwconv=17,
                                   q8vadd=10, q8gavgpool=1),
    "squeezenet_v11_tflite": _counts(q8stem=1, q8gemm=17, q8conv=8,
                                     u8maxpool=3, q8gavgpool=1),
}
IMPORTED_SERVED = {"mobilenet_v2_tflite": 8}
# One b1 forward of MiMo-V2-Flash's block (models/mimo_v2_flash.py, seven
# layers, six of them expert layers): per layer qkv and o on q8gemm, q8rope,
# the fused masked attention (scores, softargmax and context in one
# q8attn_masked launch) and two adds; layer 0's gate|up and down on q8gemm
# and q8swiglu; each expert layer's router on q8gemm_partial, moe_route
# (its two kernels), two grouped launches, q8swiglu and moe_combine.
MIMO_LAUNCHES = _counts(q8gemm=16, q8gemm_partial=6, q8gemm_grouped=12,
                        q8attn_masked=7, q8rope=7, q8swiglu=7, moe_route=12,
                        moe_combine=6, q8vadd=14)
MIMO_KERNELS = tuple(name for name in KERNELS if MIMO_LAUNCHES[name])
# One run of phase 6's lifecycle operators (ops_cases).
OPS_LAUNCHES = _counts(q8gemm=11, q8dwconv=5, q8vadd=1, q8gavgpool=3,
                       q8conv=32, q8stem=2, u8maxpool=2, q8avgpool=2,
                       u8rmax=1, u8lut32norm=1, u8clamp=1)
SERVED = {"mobilenet_v2": 16, "resnet18": 8, "shufflenet_v1_g3": 8,
          "enet_seg": 8, "bert_base_s128": 8}
# Timed rows that are not kernels.
DATA_MOVEMENT = ("x8zip", "concat", "depth_to_space")
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
    "q8avgpool": ("qnnpack_tpu_torch/kernels/csrc/q8avgpool.cu",
                  "qnnpack_tpu/kernels/pool.py:117"),
    # q8bmm and u8lut32norm replace XLA code of the JAX package (no Pallas
    # form): the port runs every op of a path on a kernel.
    "q8bmm": ("qnnpack_tpu_torch/kernels/csrc/q8bmm.cu",
              "qnnpack_tpu/nn/gemm.py:241"),
    "u8rmax": ("qnnpack_tpu_torch/kernels/csrc/u8rmax.cu",
               "qnnpack_tpu/kernels/vpu_ops.py:117"),
    "u8lut32norm": ("qnnpack_tpu_torch/kernels/csrc/u8lut32norm.cu",
                    "qnnpack_tpu/nn/elementwise.py:207"),
    "u8clamp": ("qnnpack_tpu_torch/kernels/csrc/u8clamp.cu",
                "qnnpack_tpu/kernels/vpu_ops.py:105"),
    # The partial instances and q8requant replace the XLA bodies of the JAX
    # package's K- and input-channel-sharded TP (no Pallas form).
    "q8gemm_partial": ("qnnpack_tpu_torch/kernels/csrc/q8gemm.cu",
                       "qnnpack_tpu/parallel/mesh.py:153"),
    "q8conv_partial": ("qnnpack_tpu_torch/kernels/csrc/q8conv.cu",
                       "qnnpack_tpu/parallel/mesh.py:200"),
    "q8requant": ("qnnpack_tpu_torch/kernels/csrc/q8requant.cu",
                  "qnnpack_tpu/parallel/mesh.py:160"),
    # MiMo-V2-Flash's block has no counterpart in the JAX package.
    "q8gemm_grouped": ("qnnpack_tpu_torch/kernels/csrc/q8gemm.cu", "none"),
    "q8rope": ("qnnpack_tpu_torch/kernels/csrc/q8rope.cu", "none"),
    "q8swiglu": ("qnnpack_tpu_torch/kernels/csrc/q8swiglu.cu", "none"),
    "moe_route": ("qnnpack_tpu_torch/kernels/csrc/moe_route.cu", "none"),
    "moe_combine": ("qnnpack_tpu_torch/kernels/csrc/moe_combine.cu",
                    "none"),
    "q8attn_masked": ("qnnpack_tpu_torch/kernels/csrc/q8attn_masked.cu",
                      "none"),
}


def log(msg):
    print(msg, flush=True)


def card_peaks():
    """(device-memory bytes/s, dense int8 ops/s) of the card, from
    config.tune_params(); raises for a card the table has no peaks for."""
    from qnnpack_tpu_torch import config
    tp = config.tune_params()
    if not (tp.hbm_gbps and tp.int8_peak_tops):
        raise RuntimeError(f"no data-sheet peaks for {tp.generation!r}")
    return tp.hbm_gbps * 1e9, tp.int8_peak_tops * 1e12


def gemm_plan(m, n, k, groups, sms):
    """The q8gemm wrapper's (tile, splits, steps per split) for M x K x N."""
    from qnnpack_tpu_torch.kernels.q8gemm import tile_plan
    from qnnpack_tpu_torch.nn.packing import K_STEP, round_up
    return tile_plan(m, n, round_up(k) // K_STEP, groups, sms)


def q8gemm_plan(m, n, k, sms):
    """The plan of a plain q8gemm launch of M x K x N on the card, A
    16-byte aligned: the wgmma instance's where kernels/q8gemm.py
    wgmma_route sends it, gemm_plan's otherwise."""
    from qnnpack_tpu_torch.config import tune_params
    from qnnpack_tpu_torch.kernels.q8gemm import (WGMMA_TILE, ridge_of,
                                                  wgmma_route)
    from qnnpack_tpu_torch.nn.packing import K_STEP, round_up
    steps = round_up(k) // K_STEP
    if wgmma_route(m, n, k, steps, ridge_of(tune_params())):
        return WGMMA_TILE, 1, steps
    return gemm_plan(m, n, k, 1, sms)


def conv_plan(p, m, sms):
    """The q8conv wrapper's plan for packed conv `p` over M output pixels."""
    from qnnpack_tpu_torch.kernels.q8conv import conv_steps
    from qnnpack_tpu_torch.kernels.q8gemm import tile_plan
    steps, deep = conv_steps(p)
    return tile_plan(m, p.group_output_channels, steps, p.groups, sms, deep)


def dw_tag(inst):
    """The q8dwconv instance as [4 ch, 3x3s1]."""
    v, window = inst
    return f"[{v} ch, {window}]"


def plan_tag(plan):
    from qnnpack_tpu_torch.kernels.q8gemm import DEEP_TILE, TILES, WGMMA_TILE
    tile, splits, _ = plan
    bm, bn = TILES[tile]
    return (f"[{bm}x{bn}" + (" deep" if tile == DEEP_TILE else "")
            + (" wgmma" if tile == WGMMA_TILE else "")
            + (f", split {splits}]" if splits > 1 else "]"))


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
    if torch.equal(got, want):
        diff = 0
    else:
        diff = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        raise AssertionError(f"{name} {label}: kernel != plain, "
                             f"max |err| {diff}")
    err[name] = max(err[name], diff)
    if not quiet:
        log(f"  {name:10s} {label:44s} equal")


# ------------------------------------------------------ phase 2: kernels
def check_kernels(torch, err):
    """Each kernel vs its plain version on CPU copies of the same inputs."""
    from qnnpack_tpu_torch import kernels as K
    from qnnpack_tpu_torch.kernels._build import out_dims
    from qnnpack_tpu_torch.kernels.vpu_ops import ROW_VECS
    from qnnpack_tpu_torch.models.mimo_v2_flash import MimoConfig
    from qnnpack_tpu_torch.nn.conv import pack_conv_weights
    from qnnpack_tpu_torch.nn.elementwise import (build_softargmax_lut,
                                                  lut32_tensor)
    from qnnpack_tpu_torch.nn.packing import pack_gemm_weights
    from qnnpack_tpu_torch.nn.requant_dispatch import make_requant_params
    from qnnpack_tpu_torch.quant.params import (
        compute_add_quant_params, compute_avgpool_quant_params,
        compute_per_channel_fp32_params, compute_u8_clamping_params)

    rng = np.random.default_rng(1234)
    cuda = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    relu6 = dict(qmin=128, qmax=188)

    def u8(*shape):
        return rng.integers(0, 256, shape, dtype=np.int64).astype(np.uint8)

    def check(name, label, got, want):
        compare(torch, err, name, label, got, want)

    def placed(x, offset):
        """`x` on the card at `offset` bytes past an aligned allocation."""
        buf = torch.empty(x.numel() + offset, dtype=torch.uint8, device=cuda)
        view = buf[offset:].view(x.shape)
        view.copy_(x)
        return view

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
    # The tensor-core tile's edges (csrc/imma_tile.cuh): K = 1, 16, 24 (8-byte
    # copies), 77 (byte copies); K deeper than the ring; M < 16, 49, 128;
    # N = 1, 20, 65; each block shape and split-K (the plan is logged);
    # kzp != 128 under all five schemes, with and without split-K.
    gemm_cases += [
        ("K=24 8-byte copies 3136x24->144", 3136, 24, 144, 128, 128,
         "fp32", relu6),
        ("M=5 N=20 K=16", 5, 16, 20, 121, 103, "q31", {}),
        ("bert ffn2 b1 128x3072->768 (split-K)", 128, 3072, 768, 128, 128,
         "fp32", {}),
        ("bert qkv b8 1024x768->2304", 1024, 768, 2304, 128, 128, "fp32",
         {}),
        ("16384x320->256 (128x128)", 16384, 320, 256, 121, 103, "q31", {}),
        ("16384x512->256 deep, below the ridge", 16384, 512, 256, 121, 103,
         "fp32", {}),
        ("K=960 deep, ragged last stage 16384x960->144", 16384, 960, 144,
         128, 128, "fp32", relu6),
        ("49x4608->65 kzp 90 gemmlowp (split-K, row sums)", 49, 4608, 65,
         7, 90, "gemmlowp", {}),
        ("128x3072->1 kzp 200 precise", 128, 3072, 1, 250, 200, "precise",
         {}),
        ("kzp 140, fp32 200x96->20", 200, 96, 20, 3, 140, "fp32", {}),
        ("per-channel kzp 60 split-K 64x2048->200", 64, 2048, 200, 121, 60,
         "pc", {}),
        ("q31 kzp 10 N=65 K=77 4000 rows", 4000, 77, 65, 250, 10, "q31",
         {}),
    ]
    plans = set()
    for label, m, k, n, izp, kzp, scheme, rkw in gemm_cases:
        kernel, bias = u8(n, k), rng.integers(-9000, 9000, n).astype(np.int32)
        rp = rparams(scheme, n, rkw)
        a = torch.from_numpy(u8(m, k))
        want = K.q8gemm_plain(a, pack_gemm_weights(kernel, bias, izp, kzp),
                              rp)
        got = K.q8gemm_cuda(a.to(cuda), pack_gemm_weights(
            kernel, bias, izp, kzp, device=cuda), rp)
        plan = q8gemm_plan(m, n, k, sms)
        plans.add(("q8gemm", plan[0], plan[1] > 1))
        check("q8gemm", f"{label} {plan_tag(plan)}", got, want)

    # A base address 8 bytes off a 16-byte boundary (8-byte copies).
    kernel = u8(96, 144)
    a = torch.from_numpy(u8(500, 144))
    check("q8gemm", "base + 8 bytes 500x144->96 (8-byte copies)",
          K.q8gemm_cuda(placed(a, 8), pack_gemm_weights(
              kernel, None, 121, 103, device=cuda), rparams("q31", 96, {})),
          K.q8gemm_plain(a, pack_gemm_weights(kernel, None, 121, 103),
                         rparams("q31", 96, {})))

    # K = 70,000 with every product at an extreme: each column's sum passes
    # +-2^31, so the int32 chains must wrap, not saturate; the plan splits
    # K past 65,536 and adds the parts in uint32.  A scale of 2^-25 keeps
    # the outputs off the clamp, so a wrong accumulator shows.
    m, k, n = 1088, 70000, 256
    kernel = np.zeros((n, k), np.uint8)
    kernel[1::2] = 255
    a = torch.full((m, k), 255, dtype=torch.uint8)
    a[1::3] = torch.from_numpy(u8(len(range(1, m, 3)), k))
    rp = make_requant_params("fp32", 2.0**-25, 128)
    plan = gemm_plan(m, n, k, 1, sms)
    if plan[1] < 2:
        raise AssertionError(f"K = {k} not split: {plan}")
    check("q8gemm", f"K=70000 extremes, wrap mod 2^32 {plan_tag(plan)}",
          K.q8gemm_cuda(a.to(cuda), pack_gemm_weights(
              kernel, None, 255, 0, device=cuda), rp),
          K.q8gemm_plain(a, pack_gemm_weights(kernel, None, 255, 0), rp))
    del a, kernel
    check_two_streams(torch, err, u8, sms)
    check_wgmma(torch, err, u8)

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
    conv_cases += [
        ("b32 3x3 28x28x128->128 (128x128 deep)", 32, 28, 28, 128, 128, 3,
         1, p1, 1, 121, 103, "fp32", relu6),
        ("b32 3x3 s2 56x56x64->128 (128x128)", 32, 56, 56, 64, 128, 3, 2, s2,
         1, 128, 128, "fp32", relu6),
        ("s3 3x3 7x7x512 kzp 90 per-channel (split-K, row sums)", 1, 7, 7,
         512, 512, 3, 1, p1, 1, 121, 90, "pc", {}),
        ("C=7 O=1 5x5 izp 250 kzp 0 q31", 2, 9, 10, 7, 1, 5, 1,
         ((2, 2), (2, 2)), 1, 250, 0, "q31", {}),
    ]
    for (label, bsz, h, w, c, o, k, s, pad, d, izp, kzp, scheme,
         rkw) in conv_cases:
        kernel = u8(o, k, k, c)
        bias = rng.integers(-9000, 9000, o).astype(np.int32)
        rp = rparams(scheme, o, rkw)
        a = torch.from_numpy(u8(bsz, h, w, c))
        args = dict(strides=(s, s), padding=pad, dilation=(d, d))
        packed = pack_conv_weights(kernel, bias, izp, kzp)
        want = K.q8conv_plain(a, packed, rp, **args)
        got = K.q8conv_cuda(a.to(cuda), pack_conv_weights(
            kernel, bias, izp, kzp, device=cuda), rp, **args)
        ho, wo = out_dims(h, w, k, k, (s, s), pad, (d, d))
        plan = conv_plan(packed, bsz * ho * wo, sms)
        plans.add(("q8conv", plan[0], plan[1] > 1))
        check("q8conv", f"{label} {plan_tag(plan)}", got, want)

    # An input 8 bytes off a 16-byte boundary (8-byte copies of 64 channels).
    kernel, a = u8(64, 3, 3, 64), torch.from_numpy(u8(2, 14, 14, 64))
    check("q8conv", "base + 8 bytes 3x3 pad 1 14x14x64 izp 121 kzp 103",
          K.q8conv_cuda(placed(a, 8), pack_conv_weights(
              kernel, None, 121, 103, device=cuda), rparams("q31", 64, {}),
              padding=p1),
          K.q8conv_plain(a, pack_conv_weights(kernel, None, 121, 103),
                         rparams("q31", 64, {}), padding=p1))

    # grouped q8conv: (label, B, H, W, groups, Icpg, Ocpg, k, stride,
    # padding, izp, kzp, scheme, rp kwargs); the ShuffleNet v1 g3 shapes,
    # then g = 2, 4, 8 shapes of the same builder (qnnpack_tpu/models/
    # zoo.py:247) and the edge cases.
    grouped_cases = [
        ("g3 st0u0_g2 28x28 20->72 (Icpg % 8 != 0)", 1, 28, 28, 3, 20, 72,
         1, 1, p0, 128, 128, "fp32", {}),
        ("g3 st0_g1 28x28 80->20", 1, 28, 28, 3, 80, 20, 1, 1, p0, 128, 128,
         "fp32", {"qmin": 128}),
        ("g3 st0_g2 28x28 20->80", 1, 28, 28, 3, 20, 80, 1, 1, p0, 128, 128,
         "fp32", {}),
        ("g3 st1u0_g1 28x28 80->40", 1, 28, 28, 3, 80, 40, 1, 1, p0, 128,
         128, "fp32", {"qmin": 128}),
        ("g3 st1_g2 14x14 40->160", 1, 14, 14, 3, 40, 160, 1, 1, p0, 128,
         128, "fp32", {}),
        ("g3 st2_g1 7x7 320->80", 1, 7, 7, 3, 320, 80, 1, 1, p0, 128, 128,
         "fp32", {"qmin": 128}),
        ("g3 st2u0_g2 b8 7x7 80->160", 8, 7, 7, 3, 80, 160, 1, 1, p0, 128,
         128, "fp32", {}),
        ("g2 st1_g1 14x14 200->50", 1, 14, 14, 2, 200, 50, 1, 1, p0, 128,
         128, "fp32", {"qmin": 128}),
        ("g4 st0_g1 28x28 68->17", 1, 28, 28, 4, 68, 17, 1, 1, p0, 128, 128,
         "fp32", {"qmin": 128}),
        ("g8 st2_g2 7x7 48->192", 2, 7, 7, 8, 48, 192, 1, 1, p0, 128, 128,
         "fp32", {}),
        ("g8 st0_g1 28x28 48->12", 1, 28, 28, 8, 48, 12, 1, 1, p0, 128, 128,
         "fp32", {"qmin": 128}),
        ("g3 kzp 103, q31, izp 121 Icpg 20", 2, 9, 11, 3, 20, 24, 1, 1, p0,
         121, 103, "q31", {}),
        ("g4 per-channel kzp 99 Icpg 12", 1, 10, 9, 4, 12, 33, 1, 1, p0,
         121, 99, "pc", {}),
        ("g2 precise kzp 90 Icpg 7", 3, 6, 7, 2, 7, 65, 1, 1, p0, 7, 90,
         "precise", {}),
        ("g8 gemmlowp kzp 200 Icpg 16", 1, 8, 8, 8, 16, 9, 1, 1, p0, 250,
         200, "gemmlowp", {}),
        ("g3 3x3 pad 1 izp 121 kzp 77 Icpg 5", 2, 11, 9, 3, 5, 7, 3, 1, p1,
         121, 77, "q31", {}),
        ("g2 3x3 s2 pad(0,1) izp 7 Icpg 40", 1, 13, 12, 2, 40, 70, 3, 2, s2,
         7, 128, "fp32", {}),
        ("g3 3x3 pad 1 izp 121 Icpg 20 (4-byte copies)", 2, 10, 9, 3, 20,
         24, 3, 1, p1, 121, 103, "gemmlowp", {}),
        ("g2 3x3 pad 1 izp 250 Icpg 40 (8-byte copies)", 1, 12, 11, 2, 40,
         65, 3, 1, p1, 250, 128, "precise", {}),
        ("g3 st1_g2 b128 14x14 40->160", 128, 14, 14, 3, 40, 160, 1, 1, p0,
         128, 128, "fp32", {}),
        ("g3 st0_g1 b128 28x28 80->20 (128x64)", 128, 28, 28, 3, 80, 20, 1,
         1, p0, 128, 128, "fp32", {"qmin": 128}),
    ]
    for (label, bsz, h, w, g, icpg, ocpg, k, s, pad, izp, kzp, scheme,
         rkw) in grouped_cases:
        kernel = u8(g * ocpg, k, k, icpg)
        bias = rng.integers(-9000, 9000, g * ocpg).astype(np.int32)
        rp = rparams(scheme, g * ocpg, rkw)
        a = torch.from_numpy(u8(bsz, h, w, g * icpg))
        args = dict(strides=(s, s), padding=pad)
        packed = pack_conv_weights(kernel, bias, izp, kzp, g)
        want = K.q8conv_plain(a, packed, rp, **args)
        got = K.q8conv_cuda(a.to(cuda), pack_conv_weights(
            kernel, bias, izp, kzp, g, device=cuda), rp, **args)
        ho, wo = out_dims(h, w, k, k, (s, s), pad)
        plan = conv_plan(packed, bsz * ho * wo, sms)
        plans.add(("q8conv", plan[0], plan[1] > 1))
        check("q8conv", f"{label} {plan_tag(plan)}", got, want)
    # Split-K serves only launches that fill under half the SMs, which
    # run the 64 x 64 shape (or a K past 65,536, checked above).
    want_plans = {(name, tile, tile == 2 and split)
                  for name in ("q8gemm", "q8conv") for tile in range(4)
                  for split in (False, True)}
    if not want_plans <= plans:
        raise AssertionError(f"plans not covered: {want_plans - plans}")

    # q8stem (stride 2, kzp 128): (label, B, H, W, C, O, k, padding, izp,
    # scheme, rp kwargs).  O = 24 and 32 take the 128 x 32 block, 64 and
    # 100 (two column blocks) the 128 x 64 one; C = 1..4, odd sizes, a
    # window row of 36 bytes (9 x 4, K rows of 64).
    stem_cases = [
        ("resnet 7x7 224x224x3->64", 1, 224, 224, 3, 64, 7,
         ((2, 3), (2, 3)), 128, "fp32", {"qmin": 128}),
        ("mnv2 3x3 224x224x3->32", 1, 224, 224, 3, 32, 3, s2, 128, "fp32",
         relu6),
        ("shufflenet 3x3 224x224x3->24 izp 121 precise", 1, 224, 224, 3, 24,
         3, p1, 121, "precise", {}),
        ("per-channel izp 121 7x7 19x21x3->32", 2, 19, 21, 3, 32, 7,
         ((2, 3), (2, 3)), 121, "pc", {}),
        ("q31 odd 23x17x4->24 5x5", 3, 23, 17, 4, 24, 5, ((2, 2), (2, 2)),
         121, "q31", {}),
        ("C=1 O=8 15x15 pad 1", 1, 15, 15, 1, 8, 3, p1, 7, "gemmlowp", {}),
        ("C=2 O=64 7x7 odd 17x15 per-channel izp 7", 2, 17, 15, 2, 64, 7,
         ((3, 3), (3, 3)), 7, "pc", {}),
        ("C=4 O=100 3x3 9x11 q31 izp 250", 1, 9, 11, 4, 100, 3, s2, 250,
         "q31", {}),
        ("C=4 9x9 (36-byte rows) 21x19->16 izp 121", 1, 21, 19, 4, 16, 9,
         ((4, 4), (4, 4)), 121, "fp32", {}),
        ("C=1 O=32 7x7 izp 0 gemmlowp 5x31", 2, 5, 31, 1, 32, 7,
         ((3, 3), (0, 6)), 0, "gemmlowp", {}),
    ]
    stem_tiles = set()
    for label, bsz, h, w, c, o, k, pad, izp, scheme, rkw in stem_cases:
        kernel = u8(o, k, k, c)
        bias = rng.integers(-9000, 9000, o).astype(np.int32)
        rp = rparams(scheme, o, rkw)
        a = torch.from_numpy(u8(bsz, h, w, c))
        want = K.q8stem_plain(a, pack_conv_weights(kernel, bias, izp, 128),
                              rp, pad)
        got = K.q8stem_cuda(a.to(cuda), pack_conv_weights(
            kernel, bias, izp, 128, device=cuda), rp, pad)
        stem_tiles.add(K.q8stem_cuda.tile)
        check("q8stem", f"{label} [128x{K.q8stem_cuda.tile}]", got, want)
    # A base 5 bytes off 16 and a tensor that ends off 16: the staged
    # segments at both ends are copied byte by byte.
    kernel, a = u8(32, 3, 3, 3), torch.from_numpy(u8(1, 13, 11, 3))
    rp = rparams("q31", 32, {})
    check("q8stem", "base + 5 bytes 13x11x3->32 pad 1",
          K.q8stem_cuda(placed(a, 5), pack_conv_weights(
              kernel, None, 121, 128, device=cuda), rp, p1),
          K.q8stem_plain(a, pack_conv_weights(kernel, None, 121, 128), rp,
                         p1))
    if stem_tiles != {32, 64}:
        raise AssertionError(f"q8stem block shapes run: {stem_tiles}")

    # q8dwconv: (label, B, H, W, C, k, stride, padding, dilation, izp, kzp,
    # scheme).  C = 96, 40, 144, 960 take 4 channels a thread, C = 33 one;
    # Wo = 7, 11, 13, 14 end in a part strip.
    p2 = ((2, 2), (2, 2))
    dw_cases = [
        ("112x112x96 s2 pad(0,1)", 1, 112, 112, 96, 3, 2, s2, 1, 128, 128,
         "fp32"),
        ("14x14x576 s1 pad 1", 1, 14, 14, 576, 3, 1, p1, 1, 128, 128,
         "fp32"),
        ("kzp 103, q31 13x11x24 s1", 1, 13, 11, 24, 3, 1, p1, 1, 121, 103,
         "q31"),
        ("per-channel kzp 90 14x14x40 s2", 1, 14, 14, 40, 3, 2, p1, 1, 121,
         90, "pc"),
        ("dilation 2 gemmlowp 12x10x16", 1, 12, 10, 16, 3, 2, p2, 2, 7, 200,
         "gemmlowp"),
        ("batch 3, precise 9x7x33 s2 pad(0,1)", 3, 9, 7, 33, 3, 2, s2, 1,
         250, 140, "precise"),
        ("kzp 10 fp32 7x7x960 s1", 2, 7, 7, 960, 3, 1, p1, 1, 121, 10,
         "fp32"),
        ("shufflenet 28x28x60 s1", 4, 28, 28, 60, 3, 1, p1, 1, 128, 128,
         "fp32"),
        ("shufflenet 56x56x60 s2 kzp 77 q31", 2, 56, 56, 60, 3, 2, p1, 1,
         121, 77, "q31"),
        ("9x13x33 s1 kzp 200 gemmlowp (Wo 13)", 2, 9, 13, 33, 3, 1, p1, 1,
         3, 200, "gemmlowp"),
        ("5x5 C=33 pad 2 per-channel kzp 60", 2, 11, 13, 33, 5, 1, p2, 1,
         121, 60, "pc"),
        ("5x5 C=60 s2 q31 kzp 200 izp 7", 1, 15, 14, 60, 5, 2, p2, 1, 7, 200,
         "q31"),
        ("dilation 2 C=33 s1 precise kzp 90", 1, 12, 11, 33, 3, 1, p2, 2,
         250, 90, "precise"),
        ("b10 56x56x144 s1 pad 1", 10, 56, 56, 144, 3, 1, p1, 1,
         128, 128, "fp32"),
        ("b16 112x112x96 s2 pad(0,1) kzp 140", 16, 112, 112,
         96, 3, 2, s2, 1, 121, 140, "fp32"),
        ("b12 56x56x33 s1 q31 kzp 77", 12, 56, 56, 33, 3, 1, p1,
         1, 121, 77, "q31"),
        ("b48 56x56x33 s2 per-channel", 48, 56, 56, 33, 3, 2,
         s2, 1, 128, 128, "pc"),
        ("C=1 (groups 1) 9x8 s1 q31 kzp 103", 2, 9, 8, 1, 3, 1, p1, 1, 121,
         103, "q31"),
    ]
    dw_seen = set()
    for (label, bsz, h, w, c, k, s, pad, d, izp, kzp,
         scheme) in dw_cases:
        kernel = u8(c, k, k, 1)
        bias = rng.integers(-9000, 9000, c).astype(np.int32)
        rp = rparams(scheme, c, {})
        a = torch.from_numpy(u8(bsz, h, w, c))
        args = dict(strides=(s, s), padding=pad, dilation=(d, d))
        want = K.q8dwconv_plain(
            a, pack_conv_weights(kernel, bias, izp, kzp, groups=c), rp,
            **args)
        got = K.q8dwconv_cuda(a.to(cuda), pack_conv_weights(
            kernel, bias, izp, kzp, groups=c, device=cuda), rp, **args)
        dw_seen.add(K.q8dwconv_cuda.instance)
        check("q8dwconv", f"{label} {dw_tag(K.q8dwconv_cuda.instance)}",
              got, want)
    # A base one byte off a word: byte loads for C % 4 == 0.
    kernel, a = u8(96, 3, 3, 1), torch.from_numpy(u8(2, 15, 14, 96))
    rp = rparams("q31", 96, {})
    args = dict(strides=(2, 2), padding=s2)
    got = K.q8dwconv_cuda(placed(a, 1), pack_conv_weights(
        kernel, None, 121, 103, groups=96, device=cuda), rp, **args)
    dw_seen.add(K.q8dwconv_cuda.instance)
    check("q8dwconv", f"base + 1 byte 15x14x96 s2 "
          f"{dw_tag(K.q8dwconv_cuda.instance)}", got,
          K.q8dwconv_plain(a, pack_conv_weights(kernel, None, 121, 103,
                                                groups=96), rp, **args))
    want_dw = {(v, window) for v in (4, 1)
               for window in ("3x3s1", "3x3s2", "any")}
    if dw_seen != want_dw:
        raise AssertionError(f"q8dwconv instances not run: "
                             f"{want_dw - dw_seen}")

    check_pools(torch, err, u8, placed)

    # q8vadd: every (a, b) pair as a 256 x 256 tensor under BERT's
    # parameters, the zp 10/200 set and the largest shift (31); sizes about
    # a 16-byte vector, a base 1 byte off 16 (byte path), and the shapes of
    # BERT's and ShuffleNet's adds.
    bert_add = compute_add_quant_params(128, 128, 128, 1.0, 1.0)
    zp_add = compute_add_quant_params(10, 200, 128, 0.125, 1.75, 20, 240)
    wide_add = compute_add_quant_params(77, 1, 250, 2**-10, 1e-4)
    if wide_add.shift != 31:
        raise AssertionError(f"large-shift set has shift {wide_add.shift}")
    pa = torch.arange(256, dtype=torch.uint8)[:, None].expand(256, 256)
    pairs = (pa.contiguous(), pa.t().contiguous())
    vadd_cases = [
        ("all 65,536 pairs, BERT's params", pairs, 0, bert_add),
        ("all 65,536 pairs, zp 10/200, scales .125/1.75", pairs, 0, zp_add),
        ("all 65,536 pairs, shift 31", pairs, 0, wide_add),
        ("1 byte", (1,), 0, zp_add),
        ("15 bytes", (15,), 0, zp_add),
        ("16 bytes", (16,), 0, wide_add),
        ("17 bytes", (17,), 0, bert_add),
        ("base + 1 byte 4099", (4099,), 1, zp_add),
        ("1x56x56x24 residual", (1, 56, 56, 24), 0, bert_add),
        ("zp 10/200 3x7x11x5", (3, 7, 11, 5), 0, zp_add),
        ("bert b1 1x128x768", (1, 128, 768), 0, bert_add),
        ("shufflenet 1x28x28x240", (1, 28, 28, 240), 0, bert_add),
    ]
    for label, shape, offset, params in vadd_cases:
        if isinstance(shape, tuple) and isinstance(shape[0], torch.Tensor):
            a, b = shape
        else:
            a, b = torch.from_numpy(u8(*shape)), torch.from_numpy(u8(*shape))
        check("q8vadd", label, K.q8vadd_cuda(placed(a, offset),
                                             placed(b, offset), params),
              K.q8vadd_plain(a, b, params))

    check_gavgpool(torch, err, u8, placed)

    # q8bmm: (label, G, M, K, N, za, zb, scheme); BERT's two products at
    # batch 1 (za = zb = 128: both biased zero points 0; za = 0: the column
    # sum), then the other zero-point terms, the schemes, ragged edges and
    # a batch past gridDim.z's 65535.
    bmm_cases = [
        ("scores 12x[128x64]x[64x128] za=zb=128", 12, 128, 64, 128, 128,
         128, "fp32"),
        ("context 12x[128x128]x[128x64] za=0 zb=128", 12, 128, 128, 64, 0,
         128, "fp32"),
        ("za 37 zb 201 q31 5x33x70x9", 5, 33, 70, 9, 37, 201, "q31"),
        ("za 0 zb 128 precise 3x65x200x70", 3, 65, 200, 70, 0, 128,
         "precise"),
        ("za 128 zb 0 gemmlowp 2x17x33x129", 2, 17, 33, 129, 128, 0,
         "gemmlowp"),
        ("za 0 zb 0 fp32 7x40x50x30", 7, 40, 50, 30, 0, 0, "fp32"),
        ("per-channel za 37 zb 201 4x64x96x72", 4, 64, 96, 72, 37, 201,
         "pc"),
        ("ragged 1x1x1x1 za 37 zb 201", 1, 1, 1, 1, 37, 201, "fp32"),
        ("G 70000 2x3x5 za 37 zb 201 q31", 70000, 2, 3, 5, 37, 201, "q31"),
    ]
    for label, g, m, k, n, za, zb, scheme in bmm_cases:
        rp = rparams(scheme, n, {})
        a, b = torch.from_numpy(u8(g, m, k)), torch.from_numpy(u8(g, k, n))
        check("q8bmm", label,
              K.q8bmm_cuda(a.to(cuda), b.to(cuda), za, zb, rp),
              K.q8bmm_plain(a, b, za, zb, rp))
    check_bmm_views(torch, err, u8, rparams)

    # u8rmax and u8lut32norm: (label, R, N, offset of the rows, scale);
    # BERT's score rows, odd N (rows off the 4-byte boundary), rows of 0
    # and of 255, and base pointers off by one and two bytes; then every
    # instance and row mapping of csrc/u8rows.cuh (kernels/vpu_ops.py:
    # row_instance): 16, 8 (N % 16 == 8 or a base 8 bytes off 16) and 1
    # byte a lane, each at 1 to 32 lanes a row, rows longer than a warp's
    # reach (two passes in u8lut32norm), R off the rows a block, bases 1,
    # 2, 4 and 8 bytes off, and BERT's whole b128 score tensor.
    row_cases = [
        ("scores b1 1536x128", 1536, 128, 0, 0.05),
        ("N=1 37x1", 37, 1, 0, 0.1),
        ("N=3 41x3", 41, 3, 0, 0.5),
        ("N=301 29x301, rows of 0 and 255", 29, 301, 0, 1.0),
        ("base + 1 byte 64x128", 64, 128, 1, 0.05),
        ("base + 2 bytes N=4096 5x4096", 5, 4096, 2, 0.01),
        ("N=2 1537x2", 1537, 2, 0, 0.5),
        ("N=6 1537x6", 1537, 6, 0, 0.5),
        ("N=10 1537x10", 1537, 10, 0, 0.5),
        ("N=8 1537x8", 1537, 8, 0, 0.5),
        ("N=16 1537x16", 1537, 16, 0, 0.5),
        ("N=24 1537x24", 1537, 24, 0, 0.5),
        ("N=32 1537x32", 1537, 32, 0, 0.5),
        ("N=40 1537x40", 1537, 40, 0, 0.1),
        ("N=64 1537x64", 1537, 64, 0, 0.1),
        ("N=128 1537x128", 1537, 128, 0, 0.05),
        ("N=256 1537x256", 1537, 256, 0, 0.05),
        ("N=512 1537x512", 1537, 512, 0, 0.02),
        ("N=520 1537x520", 1537, 520, 0, 0.02),
        ("N=1000 1537x1000 (SoftArgMax)", 1537, 1000, 0, 0.01),
        ("N=4096 77x4096", 77, 4096, 0, 0.01),
        ("base + 4 bytes 1537x128", 1537, 128, 4, 0.05),
        ("base + 8 bytes N=16 1537x16", 1537, 16, 8, 0.5),
        ("base + 8 bytes 1537x128", 1537, 128, 8, 0.05),
        ("base + 8 bytes 333x1000", 333, 1000, 8, 0.01),
        ("scores b128 196608x128", 196608, 128, 0, 0.05),
    ]
    row_seen = {"u8rmax": set(), "u8lut32norm": set()}

    def rows_tag(name):
        vec, lanes = K.KERNELS[name].instance
        row_seen[name].add((vec, lanes))
        return f"[{vec} B x {lanes} lanes]"

    for label, r, n, offset, scale in row_cases:
        x = torch.from_numpy(u8(r, n))
        x[0] = 0
        x[-1] = 255
        rmax = K.u8rmax_plain(x)
        got = K.u8rmax_cuda(placed(x, offset))
        check("u8rmax", f"{label} {rows_tag('u8rmax')}", got, rmax)
        lut = lut32_tensor(build_softargmax_lut(scale, n))
        got = K.u8lut32norm_cuda(placed(x, offset), rmax.to(cuda),
                                 lut.to(cuda))
        check("u8lut32norm", f"{label} {rows_tag('u8lut32norm')}", got,
              K.u8lut32norm_plain(x, rmax, lut))
    # Tables past 2^31: the sum and 256 e wrap in uint32 (bytes, then 16).
    wrap = lut32_tensor(rng.integers(2**31, 2**32, 256, dtype=np.uint64)
                        .astype(np.uint32))
    for r, n in ((19, 130), (1537, 128)):
        x = torch.from_numpy(u8(r, n))
        rmax = K.u8rmax_plain(x)
        got = K.u8lut32norm_cuda(x.to(cuda), rmax.to(cuda), wrap.to(cuda))
        check("u8lut32norm", f"table past 2^31 (uint32 wrap) {r}x{n} "
              f"{rows_tag('u8lut32norm')}", got,
              K.u8lut32norm_plain(x, rmax, wrap))
    # N t[255] = 2^32 (N = 4096, scale 0.01): rows all at their max sum to
    # 0 mod 2^32, and every output byte of them is 255.
    x = torch.full((9, 4096), 255, dtype=torch.uint8)
    x[3, :100] = 17
    x[5] = torch.from_numpy(u8(4096))
    rmax = K.u8rmax_plain(x)
    lut = lut32_tensor(build_softargmax_lut(0.01, 4096))
    got = K.u8lut32norm_cuda(x.to(cuda), rmax.to(cuda), lut.to(cuda))
    check("u8lut32norm", f"sum wraps to 0, 9x4096 "
          f"{rows_tag('u8lut32norm')}", got,
          K.u8lut32norm_plain(x, rmax, lut))
    if not bool((got[[0, 1, 2, 4, 6, 7, 8]] == 255).all()):
        raise AssertionError("u8lut32norm: a row whose sum wraps to 0 "
                             "is not all 255")
    want_rows = {(vec, lanes) for vec in ROW_VECS
                 for lanes in (1, 2, 4, 8, 16, 32)}
    for name, seen in row_seen.items():
        if not want_rows <= seen:
            raise AssertionError(f"{name} instances not run: "
                                 f"{sorted(want_rows - seen)}")

    # u8clamp: (label, shape, offset, clamp); sizes about a 16-byte
    # vector, a tail, a base off the 16-byte boundary, and the timed
    # 128x56x56x96 tensor.
    clamp_cases = [
        ("1 byte", (1,), 0, (20, 200)),
        ("15 bytes", (15,), 0, (20, 200)),
        ("16 bytes", (16,), 0, (0, 255)),
        ("17 bytes", (17,), 0, (128, 128)),
        ("3x7x11x5", (3, 7, 11, 5), 0, (20, 200)),
        ("base + 1 byte 4097", (4097,), 1, (20, 200)),
        ("1000003 bytes", (1000003,), 0, (7, 250)),
        ("128x56x56x96", (128, 56, 56, 96), 0, (20, 200)),
    ]
    for label, shape, offset, (lo, hi) in clamp_cases:
        x = torch.from_numpy(u8(*shape))
        params = compute_u8_clamping_params(lo, hi)
        check("u8clamp", label, K.u8clamp_cuda(placed(x, offset), params),
              K.u8clamp_plain(x, params))
    check_mimo_kernels(torch, err, MimoConfig(), cuda)
    torch.cuda.synchronize()


# Phase 2's fused attention rows (check_fused_attention), written to
# chip_smoke.json.
MIMO_ATTENTION = []


def check_fused_attention(torch, err, tag, q, k, v, rps, lut, window, sinks,
                          rpc, chunk):
    """The fused masked attention (q8attn_masked) on views q, k, v of one
    qkv buffer against its plain version (`chunk` heads at a time), timed
    beside its bound: q, k and v read once (K and V once a key/value
    head), the context written once, and the scores' and the context's
    products over the mask's pairs."""
    from qnnpack_tpu_torch.kernels.q8bmm import (q8attn_masked_cuda,
                                                 q8attn_masked_plain)

    b, nh, s, dq = q.shape
    nkv, dv = k.shape[1], v.shape[-1]
    group = nh // nkv
    zp = 128
    args = (zp, rps, lut, window, sinks, rpc)

    def fused():
        return q8attn_masked_cuda(q, k, v, *args)

    def part(h0, h1):
        kv = slice(h0 // group, h0 // group + 1)
        return q8attn_masked_plain(q[:, h0:h1], k[:, kv], v[:, kv], zp, rps,
                                   lut, window,
                                   None if sinks is None else sinks[h0:h1],
                                   rpc)
    got = fused()
    compare(torch, err, "q8attn_masked", f"{tag}: fused vs plain", got,
            by_heads(torch, (b, nh, s, dv), part, chunk))
    del got
    torch.cuda.empty_cache()
    pairs = b * nh * (s * (s + 1) // 2 if not window else
                      window * (window + 1) // 2 + (s - window) * window)
    t_bytes = b * s * (nh * dq + nkv * (dq + dv) + nh * dv) / HBM_BYTES_PER_S
    t_ops = 2 * pairs * (dq + dv) / INT8_OPS_PER_S
    row = dict(label=tag, fused_ms=time_ms(fused, torch),
               bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    MIMO_ATTENTION.append(row)
    log(f"    q8attn_masked {tag}: {row['fused_ms']:.3f} ms, bound "
        f"{row['bound_ms']:.3f} ms ({row['bound_by']})")
    torch.cuda.empty_cache()


def check_mimo_kernels(torch, err, cfg, dev):
    """MiMo-V2-Flash's kernels against their plain versions on random
    inputs at the shapes of a b1 forward of the block `cfg`
    (models/mimo_v2_flash.py MimoConfig), on device `dev`, the plain
    versions there too (their int64 products over 8,192 keys would take
    the CPU minutes): q8rope on a full and a window layer's qkv rows; the
    fused attention of two key/value heads' query heads on the same views,
    causal, and banded with sinks (check_fused_attention); moe_route of every
    token over the router's experts with tied scores; q8gemm's grouped
    instance for the experts' gate|up and down with segments of 0, 1,
    127, 129 and every row live; q8swiglu on them; and moe_combine."""
    from qnnpack_tpu_torch.kernels import moe
    from qnnpack_tpu_torch.kernels.q8gemm import (q8gemm_grouped_cuda,
                                                  q8gemm_grouped_plain)
    from qnnpack_tpu_torch.kernels.vpu_ops import (q8rope_cuda, q8rope_plain,
                                                   q8swiglu_cuda,
                                                   q8swiglu_plain)
    from qnnpack_tpu_torch.models.mimo_v2_flash import (quantization_scales,
                                                        rope_tables,
                                                        sigmoid_lut, silu_lut)
    from qnnpack_tpu_torch.nn.elementwise import (build_softargmax_lut,
                                                  lut32_tensor)
    from qnnpack_tpu_torch.nn.packing import pack_grouped_weights
    from qnnpack_tpu_torch.nn.requant_dispatch import make_requant_params

    gen = torch.Generator(device=dev).manual_seed(19)
    s, dq, dv, h = cfg.seq_len, cfg.qk_dim, cfg.v_dim, cfg.hidden
    scales = quantization_scales(cfg)
    zp = 128

    def u8(*shape):
        return torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8,
                             device=dev)

    def rq(scale):
        return make_requant_params("fp32", scale, zp)

    # (label, key/value heads of the layer kind, window, RoPE theta,
    # context scale): two key/value heads and their query heads.
    for label, kv, window, theta, ctx_scale in (
            ("full", cfg.kv_full, 0, cfg.theta_full,
             scales["context_full_scale"]),
            ("window", cfg.kv_window, cfg.window, cfg.theta_window,
             scales["context_window_scale"])):
        nkv = 2
        nh = nkv * cfg.heads // kv
        group = nh // nkv
        chunk = math.gcd(group, 4)
        tag = f"{label} {nh}/{nkv} heads S={s}"
        cols = (nh + nkv) * dq
        qkv = u8(s, cols + nkv * dv)
        c, sn = (torch.from_numpy(t).to(dev)
                 for t in rope_tables(theta, s, cfg.rot_dim))
        rope = (c, sn, nh + nkv, dq, s, rq(2.0 ** -14))
        want = q8rope_plain(qkv, *rope)
        compare(torch, err, "q8rope", f"{tag} qkv {tuple(qkv.shape)}",
                q8rope_cuda(qkv, *rope)[:, :cols], want)
        rows = qkv.view(1, s, -1)
        q = rows[..., :nh * dq].view(1, s, nh, dq).permute(0, 2, 1, 3)
        k = rows[..., nh * dq:cols].view(1, s, nkv, dq).permute(0, 2, 3, 1)
        v = rows[..., cols:].view(1, s, nkv, dv).permute(0, 2, 1, 3)
        rps = rq(scales["scores_scale"])
        sinks = u8(nh) if window else None
        lut = lut32_tensor(build_softargmax_lut(
            scales["softmax_input_scale"], window + 1 if window else s), dev)
        rpc = rq(ctx_scale)
        check_fused_attention(torch, err, tag, q, k, v, rps, lut, window,
                              sinks, rpc, chunk)
        # Again on the spread of the block's products (24 steps), where the
        # rows' probabilities spread rather than saturate.
        qkv[:, :cols].copy_(torch.randint(100, 157, (s, cols), generator=gen,
                                          dtype=torch.uint8, device=dev))
        check_fused_attention(torch, err, f"{tag}, products' spread", q, k,
                              v, rps, lut, window, sinks, rpc, chunk)
        del qkv, rows, q, k, v
        torch.cuda.empty_cache()

    # The routing: a quarter of the experts tie on the logit of expert 0,
    # and the first hundred tokens share one row of logits.
    r_n, e, top = cfg.router_experts, cfg.experts_held, cfg.top_k
    x = u8(s, h)
    logits = torch.randint(-2**20, 2**20, (s, r_n), generator=gen,
                           dtype=torch.int32, device=dev)
    logits[:, r_n // 4:r_n // 2] = logits[:, :1]
    logits[:100] = logits[:1]
    bias_c = torch.randint(-2**20, 2**20, (r_n,), generator=gen,
                           dtype=torch.int32, device=dev)
    corr = torch.randint(-4, 5, (r_n,), generator=gen, dtype=torch.int32,
                         device=dev)
    args = (logits, bias_c, corr,
            torch.from_numpy(sigmoid_lut(scales["sigmoid_input_scale"])).to(
                dev), rq(scales["router_scale"]), x, top, 0, e)
    got, want = moe.moe_route_cuda(*args), moe.moe_route_plain(*args)
    live = moe.live_rows(want.counts, s)
    for name in ("sel", "wts", "slot", "counts"):
        compare(torch, err, "moe_route", f"{s} tokens top {top} of {r_n} "
                f"with ties: {name}", getattr(got, name), getattr(want, name))
    compare(torch, err, "moe_route", f"{s} tokens: the {int(live.sum())} "
            f"live rows of {e} experts", got.rows[live], want.rows[live])

    # The grouped GEMMs on segments of every live count that matters: none,
    # one, either side of a 128-row tile, and every row.
    counts = torch.tensor([s, 0, 1, 127, 129, s // 8, s - 1, s // 2],
                          dtype=torch.int32, device=dev)[:e]
    live = moe.live_rows(counts, s)
    silu = torch.from_numpy(silu_lut(scales["silu_input_scale"])).to(dev)
    w = cfg.expert_ffn
    a = u8(e * s, h)
    for label, n, kk, key in (("gate|up", 2 * w, h, "expert_gate_up_scale"),
                              ("down", h, w, "expert_down_scale")):
        packed = pack_grouped_weights(u8(e, n, kk), zp, zp, device=dev)
        rp = rq(scales[key])
        a = a[:, :kk].contiguous()
        y = q8gemm_grouped_cuda(a, packed, counts, s, rp)
        compare(torch, err, "q8gemm_grouped",
                f"{label} {e}x[{s}]x{kk}->{n}, counts "
                f"{counts.tolist()}", y[live],
                q8gemm_grouped_plain(a, packed, counts, s, rp)[live])
        if label == "gate|up":
            sw = (silu, w, zp, zp, rq(scales["swiglu_scale"]), counts, s)
            compare(torch, err, "q8swiglu", f"{e}x[{s}]x{n} live rows",
                    q8swiglu_cuda(y, *sw)[live], q8swiglu_plain(y, *sw)[live])
        del packed, y
    dd = u8(e * s, h)
    rpm = rq(1.0 / 256.0)
    compare(torch, err, "moe_combine", f"{s}x{h} of the routing above",
            moe.moe_combine_cuda(dd, got.slot, got.wts, rpm),
            moe.moe_combine_plain(dd, got.slot, got.wts, rpm))
    del a, dd, x, logits, got, want
    torch.cuda.empty_cache()

def pool_tag(fn):
    """The u8maxpool / q8avgpool instance of the last launch as [16 B,
    3x3s2]."""
    vec, window = fn.instance
    return f"[{vec} B, {window}]"


def check_pools(torch, err, u8, placed):
    """u8maxpool and q8avgpool against their plain versions: the b128
    main-path shapes, bases 1, 4 and 8 bytes off 16, C = 3 to 512, other
    windows, strides, dilation, clamps and input zero points, all-255 and
    all-0 windows, sums that wrap int32; every instance of kernels/pool.py:
    pool_instance must run, as the wrappers record it in
    u8maxpool_cuda.instance / q8avgpool_cuda.instance."""
    from qnnpack_tpu_torch import kernels as K
    from qnnpack_tpu_torch.kernels.pool import POOL_VECS
    from qnnpack_tpu_torch.quant.params import compute_avgpool_quant_params

    s2, p1, p0 = ((0, 1), (0, 1)), ((1, 1), (1, 1)), ((0, 0), (0, 0))
    seen = {"u8maxpool": set(), "q8avgpool": set()}

    def check(name, label, x, offset, run, plain):
        got = run(placed(x, offset))
        fn = K.KERNELS[name]
        seen[name].add(fn.instance)
        compare(torch, err, name, f"{label} {pool_tag(fn)}", got, plain(x))

    # u8maxpool: (label, shape, pool, strides, padding, dilation, clamp,
    # base offset, fill or None for random bytes)
    max_cases = [
        ("resnet pool1 112x112x64 3x3 s2", (1, 112, 112, 64), (3, 3),
         (2, 2), s2, (1, 1), (0, 255), 0, None),
        ("resnet b128 pool1 128x112x112x64", (128, 112, 112, 64), (3, 3),
         (2, 2), s2, (1, 1), (0, 255), 0, None),
        ("shufflenet b128 pool1 128x112x112x24", (128, 112, 112, 24),
         (3, 3), (2, 2), s2, (1, 1), (0, 255), 0, None),
        ("squeezenet 111x111x96 3x3 s2", (1, 111, 111, 96), (3, 3), (2, 2),
         p0, (1, 1), (0, 255), 0, None),
        ("vgg 2x2 s2 14x14x512", (2, 14, 14, 512), (2, 2), (2, 2), p0,
         (1, 1), (0, 255), 0, None),
        ("clamp 20/250 odd 13x11x17", (2, 13, 11, 17), (3, 3), (2, 2), p1,
         (1, 1), (20, 250), 0, None),
        ("clamp 20/250 C=3 dil 2 12x9", (3, 12, 9, 3), (3, 2), (1, 2),
         ((2, 1), (0, 2)), (2, 1), (20, 250), 0, None),
        ("base + 8 bytes 29x31x64 3x3 s2", (2, 29, 31, 64), (3, 3), (2, 2),
         s2, (1, 1), (0, 255), 8, None),
        ("base + 4 bytes 29x31x64 3x3 s2", (2, 29, 31, 64), (3, 3), (2, 2),
         s2, (1, 1), (0, 255), 4, None),
        ("base + 1 byte 29x31x64 3x3 s2", (2, 29, 31, 64), (3, 3), (2, 2),
         s2, (1, 1), (0, 255), 1, None),
        ("C=5 3x3 s2 pad(0,1) 15x17", (2, 15, 17, 5), (3, 3), (2, 2), s2,
         (1, 1), (0, 255), 0, None),
        ("C=24 3x3 s2 pad(0,1) 15x17", (2, 15, 17, 24), (3, 3), (2, 2), s2,
         (1, 1), (0, 255), 0, None),
        ("C=240 3x3 s2 pad(0,1) 15x17", (2, 15, 17, 240), (3, 3), (2, 2),
         s2, (1, 1), (0, 255), 0, None),
        ("C=480 3x3 s2 pad 1 clamp 20/250", (2, 15, 17, 480), (3, 3),
         (2, 2), p1, (1, 1), (20, 250), 0, None),
        ("C=512 3x3 s2 pad(0,1) 15x17", (2, 15, 17, 512), (3, 3), (2, 2),
         s2, (1, 1), (0, 255), 0, None),
        ("C=24 3x3 s1 pad 1 15x17", (2, 15, 17, 24), (3, 3), (1, 1), p1,
         (1, 1), (0, 255), 0, None),
        ("C=12 2x2 s2 14x14", (2, 14, 14, 12), (2, 2), (2, 2), p0, (1, 1),
         (0, 255), 0, None),
        ("C=24 dil 2 3x3 s1 15x17", (2, 15, 17, 24), (3, 3), (1, 1), p0,
         (2, 2), (0, 255), 0, None),
        ("base + 4 bytes C=64 3x3 s1 pad 1 clamp", (2, 15, 17, 64), (3, 3),
         (1, 1), p1, (1, 1), (20, 250), 4, None),
        ("C=17 3x3 s1 pad 1 15x17", (2, 15, 17, 17), (3, 3), (1, 1), p1,
         (1, 1), (0, 255), 0, None),
        ("all 255, 3x3 s2 29x31x64", (2, 29, 31, 64), (3, 3), (2, 2), s2,
         (1, 1), (0, 255), 0, 255),
        ("all 0, 3x3 s2 clamp 20/250 29x31x24", (2, 29, 31, 24), (3, 3),
         (2, 2), s2, (1, 1), (20, 250), 0, 0),
    ]
    for (label, shape, pool, strides, pad, dil, (lo, hi), offset,
         fill) in max_cases:
        x = (torch.from_numpy(u8(*shape)) if fill is None
             else torch.full(shape, fill, dtype=torch.uint8))
        check("u8maxpool", label, x, offset,
              lambda xc, a=(pool, strides, pad, dil, lo, hi):
              K.u8maxpool_cuda(xc, *a),
              lambda xp, a=(pool, strides, pad, dil, lo, hi):
              K.u8maxpool_plain(xp, *a))

    # q8avgpool: (label, shape, pool, strides, padding, izp, scale, output
    # zp, clamp, base offset, fill or None, bias or None for -izp * taps,
    # as the graph sets it).
    wrap_bias = 2**31 - 1000
    avg_cases = [
        ("shufflenet st0u0 56x56x24 3x3 s2", (1, 56, 56, 24), (3, 3),
         (2, 2), s2, 128, 1 / 9, 128, (0, 255), 0, None, None),
        ("shufflenet st1u0 28x28x240 3x3 s2", (1, 28, 28, 240), (3, 3),
         (2, 2), s2, 128, 1 / 9, 128, (0, 255), 0, None, None),
        ("shufflenet st2u0 14x14x480 3x3 s2", (1, 14, 14, 480), (3, 3),
         (2, 2), s2, 128, 1 / 9, 128, (0, 255), 0, None, None),
        ("b128 st0u0 128x56x56x24", (128, 56, 56, 24), (3, 3), (2, 2), s2,
         128, 1 / 9, 128, (0, 255), 0, None, None),
        ("b128 st1u0 128x28x28x240", (128, 28, 28, 240), (3, 3), (2, 2), s2,
         128, 1 / 9, 128, (0, 255), 0, None, None),
        ("b128 st2u0 128x14x14x480", (128, 14, 14, 480), (3, 3), (2, 2), s2,
         128, 1 / 9, 128, (0, 255), 0, None, None),
        ("izp 7, 2x2 s2 unpadded 10x8x12", (2, 10, 8, 12), (2, 2), (2, 2),
         p0, 7, 0.25, 100, (0, 255), 0, None, None),
        ("izp 250, 3x3 s1 pad 1 9x7x16", (2, 9, 7, 16), (3, 3), (1, 1), p1,
         250, 1 / 9, 3, (0, 255), 0, None, None),
        ("odd 11x13, C=5, izp 121 s2 pad(0,1)", (3, 11, 13, 5), (3, 3),
         (2, 2), s2, 121, 0.37, 117, (0, 255), 0, None, None),
        ("clamp 20/250 13x11x17", (2, 13, 11, 17), (3, 3), (2, 2), s2, 128,
         1 / 9, 128, (20, 250), 0, None, None),
        ("base + 8 bytes 15x17x240 3x3 s2", (2, 15, 17, 240), (3, 3), (2, 2),
         s2, 128, 1 / 9, 128, (0, 255), 8, None, None),
        ("base + 4 bytes 15x17x240 3x3 s2", (2, 15, 17, 240), (3, 3), (2, 2),
         s2, 128, 1 / 9, 128, (0, 255), 4, None, None),
        ("base + 1 byte 15x17x240 3x3 s2", (2, 15, 17, 240), (3, 3), (2, 2),
         s2, 128, 1 / 9, 128, (0, 255), 1, None, None),
        ("izp 0, C=64 3x3 s2 pad(0,1) 15x17", (2, 15, 17, 64), (3, 3),
         (2, 2), s2, 0, 1 / 9, 128, (0, 255), 0, None, None),
        ("izp 7, C=3 3x3 s2 pad 1 15x17", (2, 15, 17, 3), (3, 3), (2, 2), p1,
         7, 0.2, 60, (0, 255), 0, None, None),
        ("izp 250, C=512 3x3 s2 pad(0,1) 15x17", (2, 15, 17, 512), (3, 3),
         (2, 2), s2, 250, 1 / 9, 128, (0, 255), 0, None, None),
        ("izp 0, C=24 3x3 s1 pad 1 15x17", (2, 15, 17, 24), (3, 3), (1, 1),
         p1, 0, 1 / 9, 128, (0, 255), 0, None, None),
        ("C=17 2x2 s2 14x14", (2, 14, 14, 17), (2, 2), (2, 2), p0, 121,
         0.25, 117, (0, 255), 0, None, None),
        ("16x16 s4 all 255 izp 0 C=64 (256 taps)", (2, 20, 24, 64), (16, 16),
         (4, 4), p0, 0, 1 / 256, 0, (0, 255), 0, 255, None),
        ("16x16 s1 pad 1 izp 250 C=24", (2, 18, 19, 24), (16, 16), (1, 1),
         p1, 250, 1 / 256, 128, (0, 255), 0, None, None),
        ("16x16 s2 izp 7 C=3", (2, 19, 21, 3), (16, 16), (2, 2), s2, 7,
         1 / 256, 128, (0, 255), 0, None, None),
        ("17x17 s1 all 255 izp 0 C=64 (289 taps)", (2, 19, 18, 64), (17, 17),
         (1, 1), p0, 0, 1 / 289, 0, (0, 255), 0, 255, None),
        ("17x17 s2 pad 1 izp 250 C=24", (2, 21, 20, 24), (17, 17), (2, 2),
         p1, 250, 1 / 289, 128, (0, 255), 0, None, None),
        ("17x17 s1 izp 7 C=12", (2, 18, 19, 12), (17, 17), (1, 1), p0, 7,
         1 / 289, 100, (0, 255), 0, None, None),
        ("17x17 s3 all 0 izp 255 C=5", (2, 20, 23, 5), (17, 17), (3, 3), s2,
         255, 1 / 289, 128, (0, 255), 0, 0, None),
        ("all 0, izp 255, 3x3 s2 clamp 20/250 29x31x24", (2, 29, 31, 24),
         (3, 3), (2, 2), s2, 255, 1 / 9, 128, (20, 250), 0, 0, None),
        ("bias past 2^31 wraps, all 255 3x3 s2 29x31x64", (2, 29, 31, 64),
         (3, 3), (2, 2), s2, 0, 2**-20, 128, (0, 255), 0, 255, wrap_bias),
        ("bias past 2^31 wraps, 17x17 s1 C=24", (2, 19, 18, 24), (17, 17),
         (1, 1), p0, 0, 2**-20, 128, (0, 255), 0, None, wrap_bias),
    ]
    for (label, shape, pool, strides, pad, izp, scale, zp, (lo, hi), offset,
         fill, bias) in avg_cases:
        if bias is None:
            bias = -izp * pool[0] * pool[1]
        params = compute_avgpool_quant_params(bias, scale, zp, lo, hi,
                                              input_zero_point=izp)
        x = (torch.from_numpy(u8(*shape)) if fill is None
             else torch.full(shape, fill, dtype=torch.uint8))
        check("q8avgpool", label, x, offset,
              lambda xc, a=(params, pool, strides, pad):
              K.q8avgpool_cuda(xc, *a),
              lambda xp, a=(params, pool, strides, pad):
              K.q8avgpool_plain(xp, *a))

    want = {"u8maxpool": {(v, w) for v in POOL_VECS
                          for w in ("3x3s2", "any")},
            "q8avgpool": {(v, w) for v in POOL_VECS
                          for w in ("3x3s2", "any", "any32")}}
    for name, instances in want.items():
        if seen[name] != instances:
            raise AssertionError(f"{name} instances not run: "
                                 f"{sorted(instances - seen[name])}")


def check_gavgpool(torch, err, u8, placed):
    """q8gavgpool against its plain version: the three b128 main-path pools
    (and MobileNetV2's at batch 1), every instance of kernels/pool.py:
    gavgpool_instance (16, 8, 4 or 1 bytes a thread x sums in 16-bit halves
    or 32 bits; each must run, as the wrapper records it in
    q8gavgpool_cuda.instance) at bases 1, 4 and 8 bytes off 16, C = 1, 3,
    33, 512, 960 and 1,280, S = 257 (halves exactly full), 258 and 4,096
    (32-bit sums, a flush of the halves), all-255 and all-0 rows, a bias
    whose sum wraps int32, and input zero points 7 and 121 with an output
    range of 20..230 (output zero point 100; at 121 the clamp binds at both
    ends)."""
    from qnnpack_tpu_torch import kernels as K
    from qnnpack_tpu_torch.kernels.pool import GAVG_SUMS, POOL_VECS
    from qnnpack_tpu_torch.quant.params import compute_avgpool_quant_params

    seen = set()
    # (label, shape, base offset, fill or None, ((bias, scale, output zero
    # point[, output min, output max]), input zero point) or None for
    # ((-128 * S, 1 / S, 128), 128))
    wrap = ((2**31 - 5000, 2**-20, 128), 128)
    cases = [
        ("mobilenet b128 128x49x1280", (128, 49, 1280), 0, None, None),
        ("resnet18 b128 128x49x512", (128, 49, 512), 0, None, None),
        ("shufflenet b128 128x49x960", (128, 49, 960), 0, None, None),
        ("mobilenet b1 1x49x1280", (1, 49, 1280), 0, None, None),
        ("C=1 5x49x1", (5, 49, 1), 0, None, None),
        ("C=3 4x49x3", (4, 49, 3), 0, None, None),
        ("C=33 3x9x33", (3, 9, 33), 0, None, None),
        ("base + 8 bytes 3x49x960", (3, 49, 960), 8, None, None),
        ("base + 4 bytes 3x49x1280", (3, 49, 1280), 4, None, None),
        ("base + 1 byte 3x49x512", (3, 49, 512), 1, None, None),
        ("all 255, S=257 3x257x512", (3, 257, 512), 0, 255, None),
        ("all 255, S=258 3x258x512", (3, 258, 512), 0, 255, None),
        ("S=258, base + 8 bytes 2x258x40", (2, 258, 40), 8, None, None),
        ("S=258, base + 4 bytes 2x258x36", (2, 258, 36), 4, None, None),
        ("S=258, C=33 2x258x33", (2, 258, 33), 0, None, None),
        ("all 255, S=4096 2x4096x512", (2, 4096, 512), 0, 255, None),
        ("S=4096, C=3 base + 1 2x4096x3", (2, 4096, 3), 1, None, None),
        ("all 0, S=257 C=24 3x257x24", (3, 257, 24), 0, 0, None),
        ("bias wraps int32, all 255 4x49x64", (4, 49, 64), 0, 255, wrap),
        ("bias wraps int32, S=1000 2x1000x16", (2, 1000, 16), 0, 255, wrap),
        ("scale 3.7 zp 7 -> 100, range 20..230 3x9x33", (3, 9, 33), 0, None,
         ((-7 * 9, 3.7 / 9, 100, 20, 230), 7)),
        ("zp 121 -> 100, range 20..230 bound at both ends 4x49x1280",
         (4, 49, 1280), 0, None, ((-121 * 49, 3.7 / 9, 100, 20, 230), 121)),
        ("S=1 70000x1x4 (images past gridDim.y)", (70000, 1, 4), 0, None,
         None),
    ]
    for label, shape, offset, fill, qp in cases:
        s = shape[1]
        args, izp = qp or ((-128 * s, 1.0 / s, 128), 128)
        params = compute_avgpool_quant_params(*args, input_zero_point=izp)
        x = (torch.from_numpy(u8(*shape)) if fill is None
             else torch.full(shape, fill, dtype=torch.uint8))
        got = K.q8gavgpool_cuda(placed(x, offset), params)
        vec, sums = K.q8gavgpool_cuda.instance
        seen.add((vec, sums))
        want = K.q8gavgpool_plain(x, params)
        compare(torch, err, "q8gavgpool", f"{label} [{vec} B, {sums}]", got,
                want)
        if qp is wrap and not bool((want == 0).all()):
            raise AssertionError(f"q8gavgpool {label}: the wrapping bias "
                                 "does not requantize to 0")
        if "both ends" in label and (int(want.min()),
                                     int(want.max())) != (20, 230):
            raise AssertionError(f"q8gavgpool {label}: the range does not "
                                 "bind at both ends")
    want = {(v, w) for v in POOL_VECS for w in GAVG_SUMS}
    if seen != want:
        raise AssertionError(f"q8gavgpool instances not run: "
                             f"{sorted(want - seen)}")


def check_bmm_views(torch, err, u8, rparams):
    """q8bmm on strided views: BERT's scores and context at batch 1 from a
    real [1, 128, 3, 12, 64] qkv tensor (K-major k, N-major v, the context
    written through out= into a [1, 128, 768] buffer), the tiny config's
    dh = 16 at row stride 96, bases 8 bytes off 16, a K-major B with za != 0
    and K = 70,000 with za = zb = 0, whose sums pass 2^31."""
    from qnnpack_tpu_torch import kernels as K
    from qnnpack_tpu_torch.kernels.q8bmm import bmm_layout
    from qnnpack_tpu_torch.models.bert import head_views
    from qnnpack_tpu_torch.nn.requant_dispatch import make_requant_params
    cuda = torch.device("cuda")

    def check(label, a, b, za, zb, rp, kmajor):
        a_card, b_card = a.to(cuda), b.to(cuda)  # strides kept
        if bmm_layout(a_card, b_card)[4] != kmajor:
            raise AssertionError(f"q8bmm {label}: B not read as labelled")
        compare(torch, err, "q8bmm", label,
                K.q8bmm_cuda(a_card, b_card, za, zb, rp),
                K.q8bmm_plain(a, b, za, zb, rp))

    def views(bsz, s, nh, dh, offset=0):
        """(q, k, v) views of one qkv tensor on the card and on the CPU."""
        qkv = torch.from_numpy(u8(bsz * s, 3 * nh * dh))
        on_card = torch.empty(qkv.numel() + offset, dtype=torch.uint8,
                              device=cuda)[offset:].view(qkv.shape)
        on_card.copy_(qkv)
        return (head_views(on_card, bsz, s, nh, dh),
                head_views(qkv, bsz, s, nh, dh))

    for label, (bsz, s, nh, dh), offset in [
            ("bert b1", (1, 128, 12, 64), 0),
            ("tiny dh 16 stride 96", (2, 16, 2, 16), 0),
            ("base + 8 bytes bert b1", (1, 128, 12, 64), 8)]:
        (q, k, v), (qc, kc, vc) = views(bsz, s, nh, dh, offset)
        probs_shape = torch.empty((bsz, nh, s, s), dtype=torch.uint8,
                                  device=cuda)
        if not bmm_layout(q, k)[4] or bmm_layout(probs_shape, v)[4]:
            raise AssertionError(f"{label}: k not K-major or v not N-major")
        for scheme in ("fp32", "q31"):
            rp = rparams(scheme, s, {})
            want = K.q8bmm_plain(qc, kc, 128, 128, rp)
            got = K.q8bmm_cuda(q, k, 128, 128, rp)
            compare(torch, err, "q8bmm", f"{label} scores views {scheme}",
                    got, want)
            probs = torch.from_numpy(u8(bsz, nh, s, s))
            rp = rparams(scheme, dh, {})
            want = K.q8bmm_plain(probs, vc, 0, 128, rp)
            ctx = torch.empty((bsz, s, nh * dh), dtype=torch.uint8,
                              device=cuda)
            view = ctx.view(bsz, s, nh, dh).permute(0, 2, 1, 3)
            K.q8bmm_cuda(probs.to(cuda), v, 0, 128, rp, out=view)
            compare(torch, err, "q8bmm", f"{label} context out= {scheme}",
                    ctx, want.permute(0, 2, 1, 3).reshape(ctx.shape))

    # A K-major B (a transposed [G, N, K]) with za != 0: the column sums.
    a = torch.from_numpy(u8(6, 70, 96))
    b = torch.from_numpy(u8(6, 40, 96)).transpose(1, 2)
    check("K-major B za 37 zb 201 per-channel 6x70x96x40", a, b, 37, 201,
          rparams("pc", 40, {}), True)
    check("K-major B za 200 zb 0 q31 ragged 3x33x77x9", a[:3, :33, :77],
          torch.from_numpy(u8(3, 9, 77)).transpose(1, 2), 200, 0,
          rparams("q31", 9, {}), True)

    # K = 70,000 at za = zb = 0: every column of b is 255 or random, every
    # other row of a 255, so the sums pass 2^31 and the int32 chains must be
    # added in uint32.  A scale of 2^-25 keeps the outputs off the clamp.
    g, m, k, n = 2, 33, 70000, 40
    a = torch.full((g, m, k), 255, dtype=torch.uint8)
    a[:, 1::2] = torch.from_numpy(u8(g, len(range(1, m, 2)), k))
    b = torch.full((g, n, k), 255, dtype=torch.uint8)
    b[:, 1::3] = torch.from_numpy(u8(g, len(range(1, n, 3)), k))
    rp = make_requant_params("fp32", 2.0**-25, 128)
    check("K=70000 za=zb=0 K-major B, sums past 2^31", a,
          b.transpose(1, 2), 0, 0, rp, True)
    check("K=70000 za=zb=0 N-major B, sums past 2^31", a,
          b.transpose(1, 2).contiguous(), 0, 0, rp, False)


def check_two_streams(torch, err, u8, sms, rounds=40):
    """Split-K q8gemm launches in flight on two streams at once (BERT's
    ffn2 at batch 1, 128x3072->768): each stream counts its tiles' splits
    on counters of its own, so every output equals the plain version."""
    from qnnpack_tpu_torch import kernels as K
    from qnnpack_tpu_torch.nn.packing import pack_gemm_weights
    from qnnpack_tpu_torch.nn.requant_dispatch import make_requant_params

    m, k, n = 128, 3072, 768
    plan = gemm_plan(m, n, k, 1, sms)
    if plan[1] < 2:
        raise AssertionError(f"{m}x{k}->{n} not split: {plan}")
    kernel = u8(n, k)
    bias = np.arange(-n // 2, n - n // 2, dtype=np.int32) * 37
    rp = make_requant_params("fp32", 0.0037, 117)
    cuda = torch.device("cuda")
    packed = pack_gemm_weights(kernel, bias, 128, 128, device=cuda)
    inputs = [torch.from_numpy(u8(m, k)) for _ in range(2)]
    wants = [K.q8gemm_plain(x, pack_gemm_weights(kernel, bias, 128, 128), rp)
             for x in inputs]
    xs = [x.to(cuda) for x in inputs]
    streams = [torch.cuda.Stream() for _ in inputs]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(rounds):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(K.q8gemm_cuda(xs[i], packed, rp))
    torch.cuda.synchronize()
    for i, want in enumerate(wants):
        for got in outs[i]:
            compare(torch, err, "q8gemm", f"stream {i}", got, want,
                    quiet=True)
    label = f"two streams x {rounds} ffn2 b1 {plan_tag(plan)}"
    log(f"  {'q8gemm':10s} {label:44s} equal")


def check_deconvs(torch, err, rng):
    """Deconvolution on the card against the CPU, byte for byte: ENet's
    three k == s deconvs at batch 1 (each plan record's q8gemm launch
    against its plain version, then the whole deconv), and a deconv at
    every lowering of nn/conv.py:deconv_lowering (k == s with groups 1 and
    2; phases with padding and adjustment, k < s, a depthwise deconv on
    q8dwconv; stride 1, dilation 2, stride 2 with dilation 2) at zero
    points (121, 103), each launching the kernels its plan names."""
    from qnnpack_tpu_torch import kernels as K
    from qnnpack_tpu_torch.nn.conv import (deconv_lowering, deconv_plan,
                                           pack_conv_weights, q8deconv2d)
    from qnnpack_tpu_torch.nn.requant_dispatch import make_requant_params
    cuda = torch.device("cuda")

    def pair(o, kh, kw, icpg, groups, izp, kzp):
        kernel = rng.integers(0, 256, (o, kh, kw, icpg), dtype=np.int64
                              ).astype(np.uint8)
        bias = rng.integers(-5000, 5000, (o,), dtype=np.int64).astype(
            np.int32)
        return [pack_conv_weights(kernel, bias, izp, kzp, groups,
                                  transposed=True, device=d)
                for d in (cuda, "cpu")]

    # ENet's upsamples at 256: (label, H = W, Cin, O), fp32, zps 128.
    rp = make_requant_params("fp32", 0.002, 128, 128, 255)
    for label, hw, cin, o in (("dec1_up", 16, 128, 64),
                              ("dec2_up", 32, 64, 16),
                              ("classifier", 64, 16, 12)):
        p, p_cpu = pair(o, 2, 2, cin, 1, 128, 128)
        a = torch.from_numpy(rng.integers(0, 256, (1, hw, hw, cin),
                                          dtype=np.int64).astype(np.uint8))
        g = deconv_plan(p, rp, (2, 2)).record
        g_cpu = deconv_plan(p_cpu, rp, (2, 2)).record
        a2 = a.reshape(-1, cin)
        compare(torch, err, "q8gemm",
                f"enet {label} deconv {a2.shape[0]}x{cin}->{g.n}",
                K.q8gemm_cuda(a2.to(cuda), g, rp),
                K.q8gemm_plain(a2, g_cpu, rp))
        got = q8deconv2d(a.to(cuda), p, rp, (2, 2))
        if not torch.equal(got.cpu(), q8deconv2d(a, p_cpu, rp, (2, 2))):
            raise AssertionError(f"enet {label} deconv: card != CPU")
        log(f"  {'deconv':10s} {'enet ' + label + ' k_eq_s':44s} equal")
    # (label, B, H, W, Cin, O, k, groups, strides, padding, adjustment,
    #  dilation, scheme, expected launches)
    cases = [
        ("k_eq_s", 2, 9, 7, 32, 40, 2, 1, (2, 2), 0, 0, 1, "q31",
         dict(q8gemm=1)),
        ("k_eq_s g2 3x3 s3", 2, 5, 6, 16, 24, 3, 2, (3, 3), 0, 0, 1, "fp32",
         dict(q8conv=1)),
        ("phase 3x3 s2 pad 1 adj 1", 2, 9, 8, 24, 32, 3, 1, (2, 2), 1, 1, 1,
         "q31", dict(q8conv=4)),
        ("phase k < s 2x2 s3", 1, 7, 6, 8, 12, 2, 1, (3, 3), 0, 0, 1,
         "fp32", dict(q8conv=4)),
        ("phase g2 s(3,2)", 2, 6, 5, 16, 12, 3, 2, (3, 2), 1, 1, 1, "q31",
         dict(q8conv=6)),
        ("phase depthwise", 2, 9, 9, 24, 24, 3, 24, (2, 2), 1, 0, 1,
         "gemmlowp", dict(q8dwconv=4)),
        ("dilated s1 3x3 pad 1", 2, 9, 9, 16, 24, 3, 1, (1, 1), 1, 0, 1,
         "fp32", dict(q8conv=1)),
        ("dilated d2 s2", 1, 6, 7, 8, 8, 3, 1, (2, 2), 0, 0, 2, "precise",
         dict(q8conv=1)),
    ]
    for (label, b, h, w, cin, o, k, groups, strides, pad, adj, dil, scheme,
         launches) in cases:
        p, p_cpu = pair(o, k, k, cin // groups, groups, 121, 103)
        geom = (strides, ((pad, pad), (pad, pad)), (adj, adj), (dil, dil))
        rp = make_requant_params(scheme, 0.0008, 117)
        lowering = deconv_lowering(p, *geom)
        if lowering != label.split()[0]:
            raise AssertionError(f"deconv {label}: lowering {lowering}")
        a = torch.from_numpy(rng.integers(0, 256, (b, h, w, cin),
                                          dtype=np.int64).astype(np.uint8))
        deconv_plan(p, rp, *geom)
        K.reset_launch_counts()
        got = q8deconv2d(a.to(cuda), p, rp, *geom)
        ran = {n: v for n, v in K.launch_counts().items() if v}
        if ran != launches:
            raise AssertionError(f"deconv {label}: launched {ran}, not "
                                 f"{launches}")
        compare(torch, err, list(launches)[0], f"deconv {label}", got,
                q8deconv2d(a, p_cpu, rp, *geom))


def check_row_sums(torch, err, u8, sms):
    """The row-sum pair (nn/gemm.py:q8gemm_row_sums_out ->
    q8gemm_presummed) on the card: the producer's y and rs and the
    consumer's output each equal their plain versions (on the card), and
    the consumer's output equals plain q8gemm on y, with kzp != 128 on both
    stages.  Chains: a small odd one, BERT's b1 out -> ffn1 (the producer
    split over K) and ffn1 -> ffn2 (the consumer split), and b128 out ->
    ffn1, where the consumer runs at ffn1's shape (M = 16,384, K = 768,
    N = 3,072), which is then timed beside plain q8gemm, and the producer
    beside q8gemm at out's.  Returns the timing row."""
    from qnnpack_tpu_torch import kernels as K
    from qnnpack_tpu_torch.kernels import q8gemm as G
    from qnnpack_tpu_torch.nn.packing import pack_gemm_weights
    from qnnpack_tpu_torch.nn.requant_dispatch import make_requant_params
    cuda = torch.device("cuda")
    splits = set()
    timing = {}
    for label, m, k, n1, n2 in (("odd", 17, 33, 29, 45),
                                ("b1 out->ffn1", 128, 768, 768, 3072),
                                ("b1 ffn1->ffn2", 128, 768, 3072, 768),
                                ("b128 out->ffn1", 16384, 768, 768, 3072)):
        p1 = pack_gemm_weights(u8(n1, k), np.arange(n1, dtype=np.int32) * 3,
                               121, 103, device=cuda)
        p2 = pack_gemm_weights(u8(n2, n1), None, 117, 99, device=cuda)
        rp1 = make_requant_params("fp32", 0.0008, 117)
        rp2 = make_requant_params("q31", 0.0006, 121)
        for stage, (mm, kk, nn) in (("producer", (m, k, n1)),
                                    ("consumer", (m, n1, n2))):
            plan = gemm_plan(mm, nn, kk, 1, sms)
            splits.add((stage, plan[1] > 1))
        x = torch.from_numpy(u8(m, k)).to(cuda)
        y, rs = G.q8gemm_row_sums_cuda(x, p1, rp1)
        compare(torch, err, "q8gemm", f"row sums {label} producer y", y,
                K.q8gemm_plain(x, p1, rp1))
        if not torch.equal(rs, G.row_sums_plain(y)):
            raise AssertionError(f"row sums {label}: producer rs != plain")
        z = G.q8gemm_presummed_cuda(y, rs, p2, rp2)
        compare(torch, err, "q8gemm", f"row sums {label} consumer", z,
                G.q8gemm_presummed_plain(y, rs, p2, rp2))
        compare(torch, err, "q8gemm", f"row sums {label} consumer == q8gemm",
                z, K.q8gemm_plain(y, p2, rp2))
        if label.startswith("b128"):
            # Each instance beside the plain one, in turns (plain, row
            # sums, row sums, plain), means of the pairs.
            timing = dict(
                label=f"{m}x{k}->{n1} producer, {m}x{n1}->{n2} consumer")
            for name, plain, rowsum in (
                    ("producer", lambda: K.q8gemm_cuda(x, p1, rp1),
                     lambda: G.q8gemm_row_sums_cuda(x, p1, rp1)),
                    ("consumer", lambda: K.q8gemm_cuda(y, p2, rp2),
                     lambda: G.q8gemm_presummed_cuda(y, rs, p2, rp2))):
                t = [time_ms(fn, torch) for fn in (plain, rowsum, rowsum,
                                                   plain)]
                timing[f"{name}_ms"] = (t[1] + t[2]) / 2
                timing[f"q8gemm_{name}_shape_ms"] = (t[0] + t[3]) / 2
            log(f"    row-sum pair b128: producer {timing['producer_ms']:.4f}"
                f" ms (q8gemm {timing['q8gemm_producer_shape_ms']:.4f}) at "
                f"{m}x{k}->{n1}; consumer {timing['consumer_ms']:.4f} ms "
                f"(q8gemm {timing['q8gemm_consumer_shape_ms']:.4f}) at "
                f"ffn1's {m}x{n1}->{n2}")
    want = {(s, b) for s in ("producer", "consumer") for b in (False, True)}
    if splits != want:
        raise AssertionError(f"row-sum chains split {sorted(splits)}, want "
                             "each stage split and unsplit")
    return timing


def check_wgmma(torch, err, u8):
    """q8gemm's wgmma instance (csrc/wgmma_tile.cuh) on the card: each
    launch must route there (the recorder's counter q8gemm.wgmma) and
    equal q8gemm_plain, run on the card (its float64 product is exact),
    byte for byte.  BERT's four b128 projections; ragged M (16,383 and
    16,385 rows), N = 776 (ends inside a block) and K = 1,040 (a last
    stage of 16 bytes, the rest zero-filled by TMA); kzp' 0 and 103
    (kernel zero points 128 and 231); all five requant schemes,
    per-channel scales among them; and one launch captured in a CUDA graph
    and replayed on fresh inputs."""
    from qnnpack_tpu_torch import kernels as K
    from qnnpack_tpu_torch.kernels.q8gemm import WGMMA_TILE
    from qnnpack_tpu_torch.nn.packing import pack_gemm_weights
    from qnnpack_tpu_torch.nn.requant_dispatch import make_requant_params
    from qnnpack_tpu_torch.quant.params import compute_per_channel_fp32_params
    from qnnpack_tpu_torch.utils import profiling
    cuda = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def rparams(scheme, n, **kw):
        if scheme == "pc":
            return compute_per_channel_fp32_params(
                np.random.default_rng(n).uniform(2e-5, 4e-4, n), 117)
        return make_requant_params(scheme, 0.00011, 117, **kw)

    def routed():
        return profiling.counters().get("q8gemm.wgmma", 0)

    # (label, M, K, N, izp, kzp, scheme, rp kwargs)
    cases = [
        ("bert b128 qkv", 16384, 768, 2304, 128, 128, "fp32", {}),
        ("bert b128 out", 16384, 768, 768, 128, 128, "fp32", {}),
        ("bert b128 ffn1", 16384, 768, 3072, 128, 128, "fp32",
         dict(qmin=128)),
        ("bert b128 ffn2", 16384, 3072, 768, 128, 128, "fp32", {}),
        ("bert b8 ffn2, 24 tiles kzp' 103", 1024, 3072, 768, 121, 231,
         "q31", {}),
        ("ragged M 16383 kzp' 103 q31", 16383, 768, 768, 121, 231, "q31",
         {}),
        ("ragged M 16385 kzp' 103 precise", 16385, 768, 768, 7, 231,
         "precise", {}),
        ("N 776 kzp' 0 gemmlowp", 16384, 768, 776, 250, 128, "gemmlowp",
         {}),
        ("N 776 M 16385 kzp' 103 per-channel", 16385, 768, 776, 121, 231,
         "pc", {}),
        ("K 1040 kzp' 103 fp32", 16384, 1040, 1024, 3, 231, "fp32", {}),
        ("q31 kzp' 0 ffn2", 16384, 3072, 768, 128, 128, "q31", {}),
        ("gemmlowp kzp' 103 ffn1", 16384, 768, 3072, 250, 231, "gemmlowp",
         {}),
    ]
    for label, m, k, n, izp, kzp, scheme, rkw in cases:
        kernel = u8(n, k)
        bias = np.random.default_rng(m + n).integers(
            -90000, 90000, n).astype(np.int32)
        p = pack_gemm_weights(kernel, bias, izp, kzp, device=cuda)
        rp = rparams(scheme, n, **rkw)
        a = torch.from_numpy(u8(m, k)).to(cuda)
        before = routed()
        got = K.q8gemm_cuda(a, p, rp)
        if routed() != before + 1:
            raise AssertionError(f"q8gemm wgmma {label}: not routed to the "
                                 "wgmma instance")
        plan = q8gemm_plan(m, n, k, sms)
        compare(torch, err, "q8gemm", f"wgmma {label} {plan_tag(plan)}",
                got, K.q8gemm_plain(a, p, rp))
        if plan[0] != WGMMA_TILE:
            raise AssertionError(f"q8gemm wgmma {label}: plan {plan}")
        del a, got
    # Captured once, replayed on two fresh inputs.
    m, k, n = 16385, 768, 776
    p = pack_gemm_weights(u8(n, k), None, 121, 231, device=cuda)
    rp = rparams("q31", n)
    x = torch.from_numpy(u8(m, k)).to(cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K.q8gemm_cuda(x, p, rp)   # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = routed()
    with torch.cuda.graph(graph):
        y = K.q8gemm_cuda(x, p, rp)
    if routed() != before + 1:
        raise AssertionError("q8gemm wgmma graph: capture not routed")
    for trial in range(2):
        fresh = torch.from_numpy(u8(m, k)).to(cuda)
        x.copy_(fresh)
        graph.replay()
        compare(torch, err, "q8gemm",
                f"wgmma graph replay {trial} {m}x{k}->{n}", y,
                K.q8gemm_plain(fresh, p, rp))
    del graph, x, y
    torch.cuda.empty_cache()


def check_float_ops(torch, rng):
    """nn/float_ops.py on the card against its CPU run, at tests/
    test_float_ops.py's shapes and within its tolerances (fp32: rtol and
    atol 1e-5 for the GEMM, 1e-4 for the convs; bf16: rtol 1/128, atol
    1/64)."""
    from qnnpack_tpu_torch.nn import float_ops as FO

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    def close(label, fn, args, kwargs, rtol, atol):
        got = fn(*[a.cuda() for a in args], **kwargs)
        want = fn(*args, **kwargs)
        if got.device.type != "cuda" or got.dtype != want.dtype:
            raise AssertionError(f"{label}: {got.device} {got.dtype}")
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().numpy(), rtol=rtol,
                                   atol=atol, err_msg=label)
        diff = float((got.float().cpu() - want.float()).abs().max())
        log(f"  {'float':10s} {label:44s} within tolerance (max |err| "
            f"{diff:.3g})")

    clamp = dict(output_min=-1.0, output_max=1.0)
    for m, n, k in ((1, 8, 8), (5, 17, 23), (32, 128, 64)):
        close(f"sgemm {m}x{k}->{n} clamp 1", FO.sgemm,
              (normal(m, k), normal(k, n), normal(n)), clamp, 1e-5, 1e-5)
    close("sgemm 4x16->8", FO.sgemm, (normal(4, 16), normal(16, 8)), {},
          1e-5, 1e-6)
    for m, n, k in ((8, 8, 8), (16, 64, 32)):
        close(f"hgemm {m}x{k}->{n}", FO.hgemm,
              (normal(m, k), normal(k, n), normal(n)), {}, 1 / 128, 1 / 64)
    for groups in (1, 4):
        close(f"sconv2d 2x9x9x8 3x3 s2 g{groups}", FO.sconv2d,
              (normal(2, 9, 9, 8), normal(3, 3, 8 // groups, 12)),
              dict(strides=(2, 2), padding=((1, 1), (1, 1)), groups=groups),
              1e-4, 1e-4)
    close("sdwconv2d 2x8x8x16 3x3", FO.sdwconv2d,
          (normal(2, 8, 8, 16), normal(3, 3, 16)),
          dict(padding=((1, 1), (1, 1))), 1e-4, 1e-4)


# ------------------------------------------------ phase 6: main-path calls
def traced_inputs(model, params, spec, x):
    """Run one forward layer by layer; yield (tag, name, layer, packed,
    input, other) for every layer, with the layer's real input (for an add,
    `layer` is its AddQuantParams and `other` the saved operand; for a
    concat, `other` is the list of its parts)."""
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
        elif tag == "concat":
            yield tag, name, payload, p, x, [env[s] for s in payload]
        else:
            yield tag, name, payload, p, x, None
        x = _graph_layer(tag, payload, p, x, env)


def int_mm_yardstick(torch, a, w):
    """torch._int_mm of biased uint8 A [M, K] by int8 W [K, N] (the
    product only), K and N padded with zeros to multiples of 8; None where
    cuBLASLt's int8 GEMM does not take the shape (M <= 16)."""
    from qnnpack_tpu_torch.nn.dtypes import u8_to_biased_i8
    F = torch.nn.functional
    m, k = a.shape
    if m <= 16:
        return None
    a8 = F.pad(u8_to_biased_i8(a), (0, -k % 8))
    w = F.pad(w, (0, -w.shape[1] % 8, 0, -k % 8))
    # cuBLASLt's int8 GEMM takes the second operand column-major.
    w8 = w.t().contiguous().t()
    return lambda: torch._int_mm(a8, w8)


def _nchw_view(torch, a, padding, value, dtype):
    """NHWC uint8 `a` padded spatially with `value` and cast to `dtype`, as
    an NCHW tensor in channels-last memory (built before timing)."""
    (pt, pb), (pl_, pr) = padding
    a = torch.nn.functional.pad(a, (0, 0, pl_, pr, pt, pb), value=value)
    return a.to(dtype).permute(0, 3, 1, 2)


def conv2d_yardstick(torch, a, p, strides, padding):
    """F.conv2d in float32 (TF32 off), groups = p.groups, of the biased,
    zero-point-padded input by the biased weights, channels-last: the
    product only.  Every sum is an integer below 2^24, so float32 holds it
    exactly."""
    from qnnpack_tpu_torch.nn.dtypes import u8_to_biased_i8
    xf = _nchw_view(torch, u8_to_biased_i8(a), padding, p.izp_biased,
                    torch.float32)
    wf = p.w.float().permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    return lambda: torch.nn.functional.conv2d(xf, wf, stride=tuple(strides),
                                              groups=p.groups)


def bert_calls(torch, params, spec, x):
    """kernel_calls' records for the BERT encoder, walking its forward
    (models/bert.py:bert_encoder_forward) layer by layer: each record's
    `run` gives the input of the next.  q8bmm runs on the forward's own
    views of the qkv output and writes the context through out= into a
    [B, S, H] buffer, as the forward does: there is no head-transpose copy
    to time."""
    from qnnpack_tpu_torch import kernels as K
    from qnnpack_tpu_torch.models.bert import ACT_ZP, head_views
    from qnnpack_tpu_torch.nn.dtypes import u8_to_biased_i8
    cfg = spec["cfg"]
    b, s, h = x.shape
    nh, dh = cfg.heads, cfg.head_dim

    def gemm(name, a2, p, rp):
        m, k = a2.shape
        return dict(kernel="q8gemm", label=f"{name} {m}x{k}->{p.n}",
                    plan=plan_tag(q8gemm_plan(m, p.n, k, sms)),
                    run=lambda: K.q8gemm_cuda(a2, p, rp),
                    plain=lambda: K.q8gemm_plain(a2, p, rp),
                    library=int_mm_yardstick(torch, a2, p.w),
                    bytes=m * k + k * p.n + 4 * p.n + m * p.n,
                    ops=2 * m * p.n * k)

    def bmm(name, a4, b4, za, zb, rp, out=None):
        *lead, m, k = a4.shape
        n = b4.shape[-1]
        g = lead[0] * lead[1]
        # The yardstick's float32 operands are contiguous copies, made
        # here, outside the timed window.
        af = u8_to_biased_i8(a4).float().reshape(g, m, k)
        bf = u8_to_biased_i8(b4).float().reshape(g, k, n)
        return dict(kernel="q8bmm",
                    label=f"{name} {g}x[{m}x{k}]x[{k}x{n}] za {za} zb {zb}",
                    run=lambda: K.q8bmm_cuda(a4, b4, za, zb, rp, out=out),
                    plain=lambda: K.q8bmm_plain(a4, b4, za, zb, rp),
                    library=lambda: torch.bmm(af, bf),
                    bytes=g * (m * k + k * n + m * n), ops=2 * g * m * n * k)

    def vadd(name, a, r, qp):
        n = a.numel()
        return dict(kernel="q8vadd", label=f"{name} {tuple(a.shape)}",
                    run=lambda: K.q8vadd_cuda(a, r, qp),
                    plain=lambda: K.q8vadd_plain(a, r, qp), library=None,
                    bytes=3 * n, ops=4 * n)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lut = spec["softargmax_lut"]
    for i, layer in enumerate(params):
        resid = x
        rec = gemm(f"l{i}.qkv", x.reshape(b * s, h), layer["qkv"],
                   spec["rp_proj"])
        yield rec
        q, k, v = head_views(rec["run"](), b, s, nh, dh)
        rec = bmm(f"l{i}.scores", q, k, ACT_ZP, ACT_ZP, spec["rp_scores"])
        yield rec
        rows = rec["run"]().reshape(-1, s)
        r, n = rows.shape
        yield dict(kernel="u8rmax", label=f"l{i}.rmax {r}x{n}",
                   run=lambda rows=rows: K.u8rmax_cuda(rows),
                   plain=lambda rows=rows: K.u8rmax_plain(rows),
                   library=lambda rows=rows: torch.amax(rows, dim=-1),
                   bytes=r * n + r, ops=r * n)
        rmax = K.u8rmax_cuda(rows)
        rec = dict(kernel="u8lut32norm",
                   label=f"l{i}.lut32norm {r}x{n}",
                   run=lambda rows=rows, rmax=rmax: K.u8lut32norm_cuda(
                       rows, rmax, lut),
                   plain=lambda rows=rows, rmax=rmax: K.u8lut32norm_plain(
                       rows, rmax, lut),
                   library=None, bytes=2 * r * n + r + 4 * 256,
                   ops=6 * r * n)
        yield rec
        probs = rec["run"]().reshape(b, nh, s, s)
        ctx = torch.empty((b, s, h), dtype=torch.uint8, device=x.device)
        rec = bmm(f"l{i}.context", probs, v, 0, ACT_ZP, spec["rp_ctx"],
                  out=ctx.view(b, s, nh, dh).permute(0, 2, 1, 3))
        yield rec
        rec["run"]()
        rec = gemm(f"l{i}.out", ctx.reshape(b * s, h), layer["out"],
                   spec["rp_proj"])
        yield rec
        rec = vadd(f"l{i}.add_attn", rec["run"]().reshape(b, s, h), resid,
                   spec["add"])
        yield rec
        x = rec["run"]()
        rec = gemm(f"l{i}.ffn1", x.reshape(b * s, h), layer["ffn1"],
                   spec["rp_relu"])
        yield rec
        rec = gemm(f"l{i}.ffn2", rec["run"](), layer["ffn2"], spec["rp_proj"])
        yield rec
        rec = vadd(f"l{i}.add_ffn", rec["run"]().reshape(b, s, h), x,
                   spec["add"])
        yield rec
        x = rec["run"]()


def by_heads(torch, shape, part, chunk):
    """A uint8 tensor of `shape` [B, H, ...] filled `chunk` heads at a
    time by part(h0, h1) (heads h0 .. h1 - 1): a plain version of an
    attention kernel in parts whose int64 temporaries fit the card."""
    out = None
    for h0 in range(0, shape[1], chunk):
        y = part(h0, h0 + chunk)
        if out is None:
            out = torch.empty(shape, dtype=torch.uint8, device=y.device)
        out[:, h0:h0 + chunk] = y
    return out


def mimo_calls(torch, params, spec, x, y):
    """kernel_calls' records for MiMo-V2-Flash's block, walking its forward
    (models/mimo_v2_flash.py:mimo_forward) layer by layer, each kernel's
    output the next one's input; the walk must end at the forward's output
    `y`.  An in-place kernel (q8rope) is timed on a fresh copy of its
    input each call, less the copy's own time (`less`: its time depends on
    the data, and a second pass over its own output would be timed on
    other data), and `got` is its output on the forward's input; `view`
    keeps what both outputs specify (the experts' live rows; the routing's
    four tensors and live rows as bytes).  The fused attention's
    (q8attn_masked) plain version runs four heads at a time.  Bytes and
    operations are counted as the benchmark's reference counts them (each input read
    once, K and V once a key/value head, only the mask's pairs), but for
    the fused attention, which writes no scores, the expert kernels at the
    rows routed here."""
    from qnnpack_tpu_torch import kernels as K
    from qnnpack_tpu_torch.kernels import moe
    from qnnpack_tpu_torch.kernels.q8bmm import q8attn_masked_plain
    from qnnpack_tpu_torch.kernels.q8gemm import q8gemm_grouped_plain
    from qnnpack_tpu_torch.kernels.vpu_ops import q8rope_plain, q8swiglu_plain
    from qnnpack_tpu_torch.models.mimo_v2_flash import ACT_ZP, WINDOW
    cfg = spec["cfg"]
    b, s, h = x.shape
    t = b * s
    nh, dq, dv, rot = cfg.heads, cfg.qk_dim, cfg.v_dim, cfg.rot_dim
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rp = spec["rp"]

    def gemm(name, a2, p, rparams):
        m, k = a2.shape
        return dict(kernel="q8gemm", label=f"{name} {m}x{k}->{p.n}",
                    plan=plan_tag(q8gemm_plan(m, p.n, k, sms)),
                    run=lambda: K.q8gemm_cuda(a2, p, rparams),
                    plain=lambda: K.q8gemm_plain(a2, p, rparams),
                    library=int_mm_yardstick(torch, a2, p.w),
                    bytes=m * k + k * p.n + 4 * p.n + m * p.n,
                    ops=2 * m * p.n * k)

    def vadd(name, a, r):
        n = a.numel()
        return dict(kernel="q8vadd", label=f"{name} {tuple(a.shape)}",
                    run=lambda: K.q8vadd_cuda(a, r, spec["add"]),
                    plain=lambda: K.q8vadd_plain(a, r, spec["add"]),
                    library=None, bytes=3 * n, ops=4 * n)

    def grouped(name, a2, p, counts, rows, live, rparams):
        return dict(kernel="q8gemm_grouped",
                    label=f"{name} {p.experts}x[{t}]x{p.k}->{p.n}, "
                          f"{rows} rows live",
                    run=lambda: K.q8gemm_grouped_cuda(a2, p, counts, t,
                                                      rparams),
                    plain=lambda: q8gemm_grouped_plain(a2, p, counts, t,
                                                       rparams),
                    view=lambda y: y[live], library=None,
                    bytes=rows * p.k + p.experts * p.n * (p.k + 4)
                    + rows * p.n, ops=2 * rows * p.n * p.k)

    x2 = x.reshape(t, h)
    for i, p in enumerate(params):
        kind = cfg.pattern[i]
        window = cfg.window if kind == WINDOW else 0
        nkv = cfg.kv_heads(i)
        group = nh // nkv
        chunk = math.gcd(group, 4)
        cols = (nh + nkv) * dq
        rec = gemm(f"l{i}.qkv", x2, p["qkv"], rp["qkv"])
        yield rec
        qkv = rec["run"]()
        width = qkv.shape[1]
        cos, sin = spec["rope"][kind]
        rope_args = (cos, sin, nh + nkv, dq, s, spec["rp_rope"])
        rotated = K.q8rope_cuda(qkv.clone(), *rope_args)
        scratch = qkv.clone()
        yield dict(kernel="q8rope",
                   label=f"l{i}.rope {t}x{nh + nkv}x{dq}, {rot} rotated",
                   run=lambda: K.q8rope_cuda(scratch.copy_(qkv), *rope_args),
                   less=lambda: scratch.copy_(qkv),
                   got=lambda: rotated[:, :cols],
                   plain=lambda: q8rope_plain(qkv, *rope_args), library=None,
                   bytes=2 * t * (nh + nkv) * rot + 8 * s * (rot // 2),
                   ops=0)
        del qkv, scratch
        rows = rotated.view(b, s, width)
        q = rows[..., :nh * dq].view(b, s, nh, dq).permute(0, 2, 1, 3)
        k = rows[..., nh * dq:cols].view(b, s, nkv, dq).permute(0, 2, 3, 1)
        v = rows[..., cols:].view(b, s, nkv, dv).permute(0, 2, 1, 3)
        pr = b * nh * (s * (s + 1) // 2 if not window else
                       window * (window + 1) // 2 + (s - window) * window)
        mask = f"{nh}/{nkv} heads, " + (f"band {window}" if window
                                        else "causal")
        lut, sink = spec["softmax_lut"][kind], p.get("sink")
        rp_ctx = rp["context_window" if window else "context_full"]
        ctx = torch.empty((b, s, nh * dv), dtype=torch.uint8,
                          device=x.device)
        cview = ctx.view(b, s, nh, dv).permute(0, 2, 1, 3)
        args = (ACT_ZP, rp["scores"], lut, window, sink, rp_ctx)

        def attention_part(h0, h1):
            kv = slice(h0 // group, h0 // group + 1)
            return q8attn_masked_plain(
                q[:, h0:h1], k[:, kv], v[:, kv], ACT_ZP, rp["scores"], lut,
                window, None if sink is None else sink[h0:h1], rp_ctx)
        # The bound counts the work alone: q, k and v read once (K and V
        # once a key/value head), the context written once, and the scores'
        # and the context's products over the mask's pairs.
        yield dict(kernel="q8attn_masked",
                   label=f"l{i}.attention [{s}x{dq}]x[{dq}x{s}]x[{s}x{dv}] "
                         f"{mask}" + (", sinks" if sink is not None else ""),
                   run=lambda: K.q8attn_masked_cuda(q, k, v, *args,
                                                    out=cview),
                   plain=lambda: by_heads(torch, (b, nh, s, dv),
                                          attention_part, chunk),
                   library=None,
                   bytes=t * (nh + nkv) * dq + t * nkv * dv + t * nh * dv,
                   ops=2 * pr * (dq + dv))
        K.q8attn_masked_cuda(q, k, v, *args, out=cview)
        del rotated, rows, q, k, v
        torch.cuda.empty_cache()
        rec = gemm(f"l{i}.o", ctx.view(t, nh * dv), p["o"], rp["o"])
        yield rec
        rec = vadd(f"l{i}.attn_add", rec["run"](), x2)
        yield rec
        x2 = rec["run"]()
        if not cfg.moe[i]:
            f = cfg.ffn
            rec = gemm(f"l{i}.gate_up", x2, p["gate_up"], rp["gate_up"])
            yield rec
            gu = rec["run"]()
            swiglu = (spec["silu_lut"], f, ACT_ZP, ACT_ZP, rp["swiglu"])
            yield dict(kernel="q8swiglu", label=f"l{i}.swiglu {t}x{2 * f}",
                       run=lambda: K.q8swiglu_cuda(gu, *swiglu),
                       plain=lambda: q8swiglu_plain(gu, *swiglu),
                       library=None, bytes=3 * t * f, ops=0)
            rec = gemm(f"l{i}.down", K.q8swiglu_cuda(gu, *swiglu),
                       p["down"], rp["down"])
            yield rec
            ffn = rec["run"]()
        else:
            r_n, e, w = cfg.router_experts, cfg.experts_held, cfg.expert_ffn
            router = p["router"]
            yield dict(kernel="q8gemm_partial",
                       label=f"l{i}.router {t}x{h}->{r_n} int32",
                       run=lambda: K.q8gemm_partial_cuda(x2, router),
                       plain=lambda: K.partial_acc_plain(
                           x2, router.w, router.kzp_biased).to(torch.int32),
                       library=None, bytes=t * h + r_n * h + 4 * t * r_n,
                       ops=2 * t * r_n * h)
            route_args = (K.q8gemm_partial_cuda(x2, router), router.bias_c,
                          p["corr"], spec["sigmoid_lut"], rp["router"], x2,
                          cfg.top_k, cfg.first_expert, e)
            route = moe.moe_route_cuda(*route_args)
            counts = route.counts
            routed = int(counts.sum())
            live = moe.live_rows(counts, t)

            def routing(r):
                return torch.cat(
                    [u.contiguous().view(torch.uint8).flatten()
                     for u in (r.sel, r.wts, r.slot, r.counts)]
                    + [r.rows[live].flatten()])
            yield dict(kernel="moe_route",
                       label=f"l{i}.route {t} tokens, top {cfg.top_k} of "
                             f"{r_n}, {routed} rows to experts "
                             f"{cfg.first_expert}-{cfg.first_expert + e - 1}",
                       run=lambda: moe.moe_route_cuda(*route_args),
                       got=lambda: route,
                       plain=lambda: moe.moe_route_plain(*route_args),
                       view=routing, library=None,
                       bytes=4 * t * r_n + 4 * r_n + 12 * t * cfg.top_k
                       + 2 * routed * h, ops=0)
            rec = grouped(f"l{i}.expert_gate_up", route.rows, p["gate_up"],
                          counts, routed, live, rp["expert_gate_up"])
            yield rec
            gu = rec["run"]()
            swiglu = (spec["silu_lut"], w, ACT_ZP, ACT_ZP, rp["swiglu"],
                      counts, t)
            yield dict(kernel="q8swiglu",
                       label=f"l{i}.expert_swiglu {e}x[{t}]x{2 * w}, "
                             f"{routed} rows live",
                       run=lambda: K.q8swiglu_cuda(gu, *swiglu),
                       plain=lambda: q8swiglu_plain(gu, *swiglu),
                       view=lambda y: y[live], library=None,
                       bytes=routed * 3 * w, ops=0)
            rec = grouped(f"l{i}.expert_down", K.q8swiglu_cuda(gu, *swiglu),
                          p["down"], counts, routed, live,
                          rp["expert_down"])
            yield rec
            d = rec["run"]()
            combine = (d, route.slot, route.wts, spec["rp_combine"])
            yield dict(kernel="moe_combine",
                       label=f"l{i}.combine {t}x{h}, {routed} rows",
                       run=lambda: K.moe_combine_cuda(*combine),
                       plain=lambda: moe.moe_combine_plain(*combine),
                       library=None,
                       bytes=routed * h + t * h + 8 * t * cfg.top_k, ops=0)
            ffn = K.moe_combine_cuda(*combine)
            del gu, d, route, route_args, combine
        rec = vadd(f"l{i}.ffn_add", ffn, x2)
        yield rec
        x2 = rec["run"]()
        del ffn
        torch.cuda.empty_cache()
    if not torch.equal(x2.view(b, s, h), y):
        raise AssertionError("mimo_calls: the walk ends off the forward's "
                             "output")


def kernel_calls(torch, model, params, spec, x):
    """One record per kernel launch of the forward on `x`: its kernel, a
    label, closures running the kernel, the plain version and the library
    yardstick on the card, and the bytes and ops of the work.  The channel
    shuffles and concats get records too (kernel "x8zip" / "concat", with
    `run` only): data movement outside the kernels."""
    from qnnpack_tpu_torch import kernels as K
    from qnnpack_tpu_torch.nn.conv import (deconv_plan, dense_conv_route,
                                           depth_to_space, im2col)
    from qnnpack_tpu_torch.nn.elementwise import x8zip
    from qnnpack_tpu_torch.nn.packing import PackedGemmWeights
    F = torch.nn.functional

    if model == "bert_base_s128":
        yield from bert_calls(torch, params, spec, x)
        return
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for tag, name, layer, p, a, other in traced_inputs(model, params, spec,
                                                       x):
        if tag == "add":
            n = a.numel()
            yield dict(kernel="q8vadd", label=f"{name} {tuple(a.shape)}",
                       run=lambda a=a, b=other, l=layer: K.q8vadd_cuda(a, b, l),
                       plain=lambda a=a, b=other, l=layer: K.q8vadd_plain(
                           a, b, l),
                       library=None, bytes=3 * n, ops=4 * n)
        elif tag == "deconv":
            # ENet's deconvs: the k == s lowering, groups 1 (one q8gemm
            # launch on the plan's phase-major weights, then the
            # depth-to-space copy).
            cs, adj = layer
            plan = deconv_plan(p, cs.rparams, cs.strides, cs.padding, adj)
            if plan.lowering != "k_eq_s" or p.groups != 1:
                raise AssertionError(f"{name}: {plan.lowering} deconv, "
                                     f"groups {p.groups}")
            g, a2 = plan.record, a.reshape(-1, a.shape[-1])
            m, k = a2.shape
            yield dict(kernel="q8gemm", label=f"{name} deconv {m}x{k}->{g.n}",
                       plan=plan_tag(q8gemm_plan(m, g.n, k, sms)),
                       run=lambda a2=a2, g=g, r=cs.rparams: K.q8gemm_cuda(
                           a2, g, r),
                       plain=lambda a2=a2, g=g, r=cs.rparams: K.q8gemm_plain(
                           a2, g, r),
                       library=int_mm_yardstick(torch, a2, g.w),
                       bytes=m * k + k * g.n + 4 * g.n + m * g.n,
                       ops=2 * m * g.n * k)
            y = K.q8gemm_cuda(a2, g, cs.rparams).reshape(*a.shape[:3], g.n)
            yield dict(kernel="depth_to_space",
                       label=f"{name} {tuple(y.shape)} s{cs.strides[0]}",
                       run=lambda y=y, st=cs.strides: depth_to_space(
                           y, st[0], st[1], 1),
                       bytes=2 * y.numel())
        elif tag == "shuffle":
            yield dict(kernel="x8zip", label=f"{name} {tuple(a.shape)}",
                       run=lambda a=a, g=layer: x8zip(a, g),
                       bytes=2 * a.numel())
        elif tag == "concat":
            yield dict(kernel="concat",
                       label=f"{name} {[t.shape[-1] for t in other]}",
                       run=lambda parts=other: torch.cat(parts, dim=-1),
                       bytes=2 * sum(t.numel() for t in other))
        elif tag == "gap":
            bsz, h, w, c = a.shape
            a3 = a.reshape(bsz, h * w, c)
            yield dict(kernel="q8gavgpool", label=f"{name} {tuple(a3.shape)}",
                       run=lambda a3=a3, q=layer: K.q8gavgpool_cuda(a3, q),
                       plain=lambda a3=a3, q=layer: K.q8gavgpool_plain(a3, q),
                       library=lambda a3=a3: a3.sum(dim=1, dtype=torch.int32),
                       bytes=a3.numel() + bsz * c, ops=a3.numel())
        elif tag == "maxpool":
            pool, strides, padding = layer
            out = K.u8maxpool_cuda(a, pool, strides, padding)
            xh = _nchw_view(torch, a, padding, 0, torch.float16)
            yield dict(kernel="u8maxpool",
                       label=f"{name} {tuple(a.shape)} {pool} s{strides[0]}",
                       plan=pool_tag(K.u8maxpool_cuda),
                       run=lambda a=a, l=layer: K.u8maxpool_cuda(a, *l),
                       plain=lambda a=a, l=layer: K.u8maxpool_plain(a, *l),
                       library=lambda xh=xh, l=layer: F.max_pool2d(
                           xh, l[0], l[1]),
                       bytes=a.numel() + out.numel(),
                       ops=out.numel() * pool[0] * pool[1])
        elif tag == "avgpool":
            qp, pool, strides, padding = layer
            out = K.q8avgpool_cuda(a, qp, pool, strides, padding)
            xf = _nchw_view(torch, a, padding, qp.input_zero_point,
                            torch.float32)
            yield dict(kernel="q8avgpool",
                       label=f"{name} {tuple(a.shape)} {pool} s{strides[0]}",
                       plan=pool_tag(K.q8avgpool_cuda),
                       run=lambda a=a, l=layer: K.q8avgpool_cuda(a, *l),
                       plain=lambda a=a, l=layer: K.q8avgpool_plain(a, *l),
                       library=lambda xf=xf, l=layer: F.avg_pool2d(
                           xf, l[1], l[2], divisor_override=1),
                       bytes=a.numel() + out.numel(),
                       ops=out.numel() * pool[0] * pool[1])
        elif (tag == "gemm" or isinstance(p, PackedGemmWeights)
              or (tag == "conv" and layer.kind == "gemm")):
            a2 = a.reshape(-1, a.shape[-1])
            m, k = a2.shape
            yield dict(kernel="q8gemm", label=f"{name} {m}x{k}->{p.n}",
                       plan=plan_tag(q8gemm_plan(m, p.n, k, sms)),
                       run=lambda a2=a2, p=p, l=layer: K.q8gemm_cuda(
                           a2, p, l.rparams),
                       plain=lambda a2=a2, p=p, l=layer: K.q8gemm_plain(
                           a2, p, l.rparams),
                       library=int_mm_yardstick(torch, a2, p.w),
                       bytes=m * k + k * p.n + 4 * p.n + m * p.n,
                       ops=2 * m * p.n * k)
        elif (tag == "conv" and p.groups > 1
              and p.group_input_channels == p.group_output_channels == 1):
            c = a.shape[-1]
            kw_ = dict(strides=layer.strides, padding=layer.padding)
            out = K.q8dwconv_cuda(a, p, layer.rparams, **kw_)
            taps = p.kernel_height * p.kernel_width
            yield dict(
                kernel="q8dwconv",
                label=f"{name} {tuple(a.shape)} s{layer.strides[0]}",
                plan=dw_tag(K.q8dwconv_cuda.instance),
                run=lambda a=a, p=p, l=layer, kw_=kw_: K.q8dwconv_cuda(
                    a, p, l.rparams, **kw_),
                plain=lambda a=a, p=p, l=layer, kw_=kw_: K.q8dwconv_plain(
                    a, p, l.rparams, **kw_),
                library=conv2d_yardstick(torch, a, p, layer.strides,
                                         layer.padding),
                bytes=a.numel() + (taps + 4) * c + out.numel(),
                ops=2 * taps * out.numel())
        elif tag == "conv":  # dense or grouped
            kernel = dense_conv_route(p, layer.strides)
            k = p.kernel_height * p.kernel_width * p.group_input_channels
            o = p.w.shape[-1]
            out = K.q8conv_cuda(a, p, layer.rparams, layer.strides,
                                layer.padding)
            m = out.numel() // o
            if p.groups > 1:
                library = conv2d_yardstick(torch, a, p, layer.strides,
                                           layer.padding)
            else:
                cols, _ = im2col(a, p, layer.strides, layer.padding)
                library = int_mm_yardstick(torch, cols, p.as_gemm().w)
                del cols
            old_route = plan = None
            if kernel == "q8stem":
                K.q8stem_cuda(a, p, layer.rparams, layer.padding)
                plan = f"[128x{K.q8stem_cuda.tile}]"
                run = (lambda a=a, p=p, l=layer: K.q8stem_cuda(
                    a, p, l.rparams, l.padding))
                plain = (lambda a=a, p=p, l=layer: K.q8stem_plain(
                    a, p, l.rparams, l.padding))
                # The GEMM form of the weights is packed here, outside the
                # timed window, as a model would pack it once.
                old_route = (lambda a=a, g=p.as_gemm(), p=p, l=layer:
                             K.q8gemm_cuda(im2col(a, p, l.strides,
                                                  l.padding)[0], g,
                                           l.rparams))
            else:
                run = (lambda a=a, p=p, l=layer: K.q8conv_cuda(
                    a, p, l.rparams, l.strides, l.padding))
                plain = (lambda a=a, p=p, l=layer: K.q8conv_plain(
                    a, p, l.rparams, l.strides, l.padding))
                plan = plan_tag(conv_plan(p, m, sms))
            yield dict(
                kernel=kernel,
                label=f"{name} {tuple(a.shape)} {p.kernel_height}x"
                      f"{p.kernel_width} s{layer.strides[0]} g{p.groups} "
                      f"->{o}",
                plan=plan, run=run, plain=plain, library=library,
                bytes=a.numel() + p.w.numel() + 4 * o + m * o,
                ops=2 * m * o * k, old_route=old_route)


def time_main_path(torch, model, params, spec, x, err, plain_repeats):
    """Time every kernel launch of the forward on `x`, its plain version
    and yardstick; each kernel's output must equal its plain version's.
    Data movement (shuffles, concats) is timed alone."""
    return time_calls(torch, kernel_calls(torch, model, params, spec, x),
                      err, plain_repeats)


def time_calls(torch, calls, err, plain_repeats):
    """time_main_path's rows of the records `calls`: a record's output
    (`got`, or else `run`'s) must equal its plain version's, both through
    its `view` where it has one; its time is run's, less that of its
    `less` where it has one."""
    rows = []
    for call in calls:
        if call["kernel"] in DATA_MOVEMENT:
            rows.append(dict(kernel=call["kernel"], label=call["label"],
                             bytes=call["bytes"],
                             ms=time_ms(call["run"], torch)))
            continue
        view = call.get("view") or (lambda y: y)
        compare(torch, err, call["kernel"], call["label"],
                view((call.get("got") or call["run"])()),
                view(call["plain"]()), quiet=True)
        torch.cuda.empty_cache()
        row = dict(kernel=call["kernel"], label=call["label"],
                   bytes=call["bytes"], ops=call["ops"],
                   ms=time_ms(call["run"], torch) - (
                       time_ms(call["less"], torch) if "less" in call
                       else 0.0),
                   plain_ms=time_ms(call["plain"], torch,
                                    repeats=plain_repeats),
                   library_ms=(time_ms(call["library"], torch)
                               if call["library"] is not None else None))
        if call.get("old_route") is not None:
            row["old_route_ms"] = time_ms(call["old_route"], torch)
        if call.get("plan") is not None:
            row["plan"] = call["plan"]
        if call["kernel"] in ("q8gemm", "q8conv", "q8stem", "q8gemm_grouped",
                              "q8attn_masked"):
            bound_ms = max(row["bytes"] / HBM_BYTES_PER_S,
                           row["ops"] / INT8_OPS_PER_S) * 1e3
            row.update(tops=row["ops"] / (row["ms"] * 1e-3) / 1e12,
                       bound_share=bound_ms / row["ms"])
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


def check_output(torch, model, y, y_cpu):
    """Raise unless the card's batch-1 output `y` has the model's shape and
    equals the CPU forward's `y_cpu` byte for byte, and is not constant."""
    want = {"bert_base_s128": (1, 128, 768),
            "enet_seg": (1, 256, 256, 12)}.get(model, (1, 1000))
    if tuple(y.shape) != want or y.dtype != torch.uint8:
        raise AssertionError(f"{model} output {tuple(y.shape)} {y.dtype}, "
                             f"want {want} uint8")
    if not torch.equal(y.cpu(), y_cpu):
        diff = (y.cpu().int() - y_cpu.int()).abs()
        raise AssertionError(
            f"{model} forward differs in {int((diff > 0).sum())} values, "
            f"max |err| {int(diff.max())}")
    if int(y_cpu.max()) == int(y_cpu.min()):
        raise AssertionError(f"{model} output is constant")
    log(f"    equal; output min {int(y_cpu.min())} max {int(y_cpu.max())}, "
        f"{len(torch.unique(y_cpu))} distinct values")


def check_only_port_kernels(torch, fn, params, x, expected):
    """One forward under torch.profiler: every CUDA kernel it launches must
    be one of the port's (a __global__ function named <kernel>_kernel in
    kernels/csrc/), and their number must equal the launch counts, which
    also shows that the profiler saw the device.  So no copy or other
    PyTorch kernel runs between the port's kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    own = tuple(f"{name}_kernel" for name in KERNELS) + (
        "dw3x3_kernel", "dw_generic_kernel", "q8bmm_masked_kernel")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(params, x)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    foreign = sorted({name for name in kernels
                      if not any(sym in name for sym in own)})
    ours = sum(1 for name in kernels if any(sym in name for sym in own))
    log(f"    profiler: {len(kernels)} kernels, {ours} of the port's, "
        f"{len(foreign)} other")
    if foreign:
        raise AssertionError(f"kernels not of the port: {foreign[:8]}")
    if ours != sum(expected.values()):
        raise AssertionError(f"profiler saw {ours} of the port's kernels, "
                             f"launch counts say {sum(expected.values())}")


PROFILE_FLAG = "--profile-bert-b1"


def profile_bert_b1() -> int:
    """The child process of phase 4's profiler check: BERT's batch-1
    forward, once to warm up, then under check_only_port_kernels.  It runs
    in a process of its own so that the profiler's tracing cannot touch the
    launches that phase 7 times."""
    import torch
    from qnnpack_tpu_torch.entry import entry
    model = "bert_base_s128"
    with torch.inference_mode():
        fn, (params, x) = entry(model=model)
        fn(params, x)
        torch.cuda.synchronize()
        check_only_port_kernels(torch, fn, params, x,
                                EXPECTED_LAUNCHES[model])
    return 0


def run_profiled_bert_b1():
    """Phase 4's profiler check, in a child process (profile_bert_b1)."""
    res = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          PROFILE_FLAG], capture_output=True, text=True,
                         timeout=600, cwd=Path(__file__).resolve().parent)
    for line in res.stdout.splitlines():
        log(line)
    if res.returncode != 0:
        raise AssertionError(f"profiled BERT forward failed (rc "
                             f"{res.returncode}):\n{res.stderr[-3000:]}")


def ops_cases(torch, rng):
    """Phase 6's operators: (operator, create kwargs, inputs, the launches
    one run of it makes).  Convolution2D at each kernel type (1x1 gemm,
    depthwise, dense 3x3 with dilation 2, grouped, the stem class at kzp 128
    and at kzp 103), under every requant scheme and per-channel;
    FullyConnected at use_pallas=False (which still launches q8gemm) and at
    odd K and N; the pools with and without a range, AveragePooling2D at
    17x17 (32-bit sums), GlobalAveragePooling at widths 49, 258 (with a
    range) and 1,000; Deconvolution2D at each lowering (k == s as ENet's
    first upsample at batch 4, the phases of a 3x3 stride-2 deconv with
    padding and adjustment, a stride-1 3x3) at zero points (128, 128) and
    (121, 103) under q31 and fp32, a grouped k == s deconv at kzp 103 and
    a k < s one (2x2 stride 3: five of its nine phases take no tap)."""
    def u8(*shape):
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.int64)
                                .astype(np.uint8))

    def weights(shape, n, k, kzp=103):
        return dict(
            kernel=rng.integers(0, 256, shape, dtype=np.int64)
            .astype(np.uint8),
            bias=rng.integers(-5000, 5000, (n,), dtype=np.int64)
            .astype(np.int32),
            input_zero_point=121, input_scale=0.9, kernel_zero_point=kzp,
            kernel_scale=1.1, output_zero_point=117,
            output_scale=0.9 * 1.1 * k**0.5 / 0.0116)

    def conv(o, kh, kw, icpg, scheme, kzp=103, **kw_):
        out = dict(weights((o, kh, kw, icpg), o, kh * kw * icpg, kzp), **kw_)
        if scheme == "pc":
            out["per_channel_requant"] = [
                float(v) for v in rng.uniform(0.5, 2.0, o) * 1.1]
        else:
            out["requant"] = scheme
        return out

    def deconv(o, kh, kw, icpg, scheme, zps, **kw_):
        return dict(weights((o, kh, kw, icpg), o, kh * kw * icpg, zps[1]),
                    input_zero_point=zps[0], requant=scheme, **kw_)

    add = dict(a_zero_point=10, a_scale=0.25, b_zero_point=200, b_scale=0.75,
               sum_zero_point=128, sum_scale=0.5)
    avg = dict(input_zero_point=121, input_scale=0.7, output_zero_point=77,
               output_scale=0.5)
    schemes = ("q31", "fp32", "precise", "gemmlowp", "pc")
    p1, s2 = ((1, 1), (1, 1)), ((0, 1), (0, 1))
    return [
        ("Add", add, [u8(128, 1000), u8(128, 1000)], dict(q8vadd=1)),
        ("Clamp", dict(output_min=20, output_max=200), [u8(128, 56, 56, 96)],
         dict(u8clamp=1)),
        ("Sigmoid", dict(input_zero_point=121, input_scale=0.25),
         [u8(64, 333)], {}),
        ("LeakyReLU", dict(negative_slope=0.01, input_zero_point=121,
                           input_scale=0.25, output_zero_point=100,
                           output_scale=0.5), [u8(64, 333)], {}),
        ("SoftArgMax", dict(channels=1000, input_scale=0.1), [u8(128, 1000)],
         dict(u8rmax=1, u8lut32norm=1)),
        ("ChannelShuffle", dict(groups=3, group_channels=80),
         [u8(128, 28, 28, 240)], {}),
        *[("Convolution2D", conv(96, 1, 1, 64, r), [u8(4, 28, 28, 64)],
           dict(q8gemm=1)) for r in schemes],
        *[("Convolution2D", conv(96, 3, 3, 1, r, groups=96, padding=p1,
                                 strides=(2, 2) if r == "q31" else (1, 1)),
           [u8(4, 28, 28, 96)], dict(q8dwconv=1)) for r in schemes],
        *[("Convolution2D", conv(64, 3, 3, 32, r, padding=((2, 2), (2, 2)),
                                 dilation=(2, 2)), [u8(4, 28, 28, 32)],
           dict(q8conv=1)) for r in schemes],
        ("Convolution2D", conv(48, 3, 3, 16, "q31", groups=3, padding=p1),
         [u8(4, 28, 28, 48)], dict(q8conv=1)),
        *[("Convolution2D", conv(32, 3, 3, 3, r, kzp=128, strides=(2, 2),
                                 padding=s2), [u8(4, 112, 112, 3)],
           dict(q8stem=1)) for r in ("q31", "pc")],
        ("Convolution2D", conv(32, 3, 3, 3, "fp32", strides=(2, 2),
                               padding=s2), [u8(4, 112, 112, 3)],
         dict(q8conv=1)),
        ("FullyConnected", dict(weights((1000, 1280), 1000, 1280),
                                use_pallas=False), [u8(128, 1280)],
         dict(q8gemm=1)),
        ("FullyConnected", dict(weights((37, 1001), 37, 1001),
                                requant="precise", output_min=20,
                                output_max=240), [u8(33, 1001)],
         dict(q8gemm=1)),
        ("MaxPooling2D", dict(pool_size=(3, 3), strides=(2, 2), padding=s2),
         [u8(16, 112, 112, 64)], dict(u8maxpool=1)),
        ("MaxPooling2D", dict(pool_size=(3, 3), strides=(2, 2), padding=p1,
                              output_min=20, output_max=250),
         [u8(4, 28, 28, 24)], dict(u8maxpool=1)),
        ("AveragePooling2D", dict(avg, pool_size=(3, 3), strides=(2, 2),
                                  padding=s2), [u8(16, 28, 28, 240)],
         dict(q8avgpool=1)),
        ("AveragePooling2D", dict(avg, pool_size=(17, 17), strides=(1, 1),
                                  output_min=10, output_max=240),
         [u8(4, 20, 21, 24)], dict(q8avgpool=1)),
        *[("GlobalAveragePooling", dict(avg, channels=c, **rng_),
           [u8(b, width, c)], dict(q8gavgpool=1))
          for b, width, c, rng_ in (
              (128, 49, 1280, {}),
              (4, 258, 40, dict(output_min=80, output_max=90)),
              (4, 1000, 17, {}))],
        *[("Deconvolution2D", deconv(64, 2, 2, 128, r, zps, strides=(2, 2)),
           [u8(4, 16, 16, 128)], dict(q8gemm=1))
          for zps in ((128, 128), (121, 103)) for r in ("q31", "fp32")],
        *[("Deconvolution2D", deconv(32, 3, 3, 64, r, zps, strides=(2, 2),
                                     padding=p1, adjustment=(1, 1)),
           [u8(4, 28, 28, 64)], dict(q8conv=4))
          for zps in ((128, 128), (121, 103)) for r in ("q31", "fp32")],
        *[("Deconvolution2D", deconv(32, 3, 3, 32, r, zps, padding=p1),
           [u8(4, 28, 28, 32)], dict(q8conv=1))
          for zps in ((128, 128), (121, 103)) for r in ("q31", "fp32")],
        ("Deconvolution2D", deconv(48, 2, 2, 32, "fp32", (121, 103),
                                   groups=2, strides=(2, 2)),
         [u8(4, 16, 16, 64)], dict(q8conv=1)),
        ("Deconvolution2D", deconv(16, 2, 2, 32, "q31", (121, 103),
                                   strides=(3, 3)),
         [u8(4, 14, 14, 32)], dict(q8conv=4)),
    ]


def check_ops(torch, err):
    """Phase 6: the lifecycle operators created on the card against the same
    operators on the CPU, byte for byte.  Each is lowered at its input's
    shape (Operator.lower: an eager warm-up and the capture), so its run
    replays the graph; at a shape it was not lowered at, it runs eagerly
    (Clamp on half the rows).  The launches of all of them
    (counts set to 0 just before, read just after) must be 2 x OPS_LAUNCHES
    (warm-up and capture; a replay launches nothing), and each capture's
    own launches that operator's kernel once; a second run replays every
    graph with no launch and the same bytes.  Ten of them are timed as a
    graph and eagerly (time_ops_graph), and u8clamp on a 128x56x56x96
    tensor beside torch.clamp.  Returns (the captures' launches, one run
    of the operators: OPS_LAUNCHES; u8clamp's timing row; the graph and
    eager rows)."""
    from qnnpack_tpu_torch import kernels as K
    from qnnpack_tpu_torch import ops

    cases = ops_cases(torch, np.random.default_rng(99))
    cuda = torch.device("cuda")
    on_card = [(name, getattr(ops, name)(**kw, device=cuda),
                [x.to(cuda) for x in xs]) for name, kw, xs, _ in cases]
    torch.cuda.synchronize()
    K.reset_launch_counts()
    outputs, own = [], []
    for _, op, xs in on_card:
        own.append({k: v for k, v in op.lower(*xs).launches.items() if v})
        outputs.append(op(*xs))
    torch.cuda.synchronize()
    counts = K.launch_counts()
    log(f"    one run of the {len(cases)} operators (warm-up + capture): "
        f"{counts}")
    if counts != {k: 2 * v for k, v in OPS_LAUNCHES.items()}:
        raise AssertionError(f"operator launches {counts} != 2 x "
                             f"{OPS_LAUNCHES}")
    captured = {k: sum(m.get(k, 0) for m in own) for k in OPS_LAUNCHES}
    if captured != OPS_LAUNCHES:
        raise AssertionError(f"captured launches {captured} != "
                             f"{OPS_LAUNCHES}")
    K.reset_launch_counts()
    again = [op(*xs) for _, op, xs in on_card]
    torch.cuda.synchronize()
    if set(K.launch_counts().values()) != {0}:
        raise AssertionError(f"replays launched {K.launch_counts()}")
    for (name, _, _, _), first, second in zip(cases, outputs, again):
        if not torch.equal(first, second):
            raise AssertionError(f"ops.{name}: second replay != first")
    log("    a second run replays every graph: no launch, equal bytes")
    clamp, x = on_card[1][1], on_card[1][2][0]
    K.reset_launch_counts()
    half = clamp(x[:64])
    torch.cuda.synchronize()
    if K.launch_counts() != _counts(u8clamp=1) or \
            not torch.equal(half, outputs[1][:64]):
        raise AssertionError(f"Clamp at a shape not lowered: launches "
                             f"{K.launch_counts()}, or bytes differ")
    log("    Clamp at a shape it was not lowered at: one eager u8clamp "
        "launch, the graph's bytes")
    for (name, kw, xs, launched), (_, op, _), got, mine in zip(
            cases, on_card, outputs, own):
        label = f"ops.{name} {tuple(xs[0].shape)}"
        if name == "Convolution2D":
            label += f" {op.kernel_type} " + (
                "pc" if "per_channel_requant" in kw else kw["requant"])
        elif name == "Deconvolution2D":
            label += (f" {op.lowering} {kw['requant']} zps "
                      f"{kw['input_zero_point']},{kw['kernel_zero_point']}")
        elif name == "FullyConnected":
            label += f" use_pallas={op.use_pallas}"
        if mine != launched:
            raise AssertionError(f"{label}: launched {mine}, not {launched}")
        want = getattr(ops, name)(**kw, device="cpu")(*xs)
        if launched:
            # SoftArgMax's output is u8lut32norm's.
            compare(torch, err, list(launched)[-1], label, got, want)
        elif not torch.equal(got.cpu(), want):
            raise AssertionError(f"{label}: card != CPU")
        else:
            log(f"  {'(torch)':11s} {label:44s} equal")

    graph_rows = time_ops_graph(torch, cases, on_card, own)
    deconv_rows = time_deconv_ops(torch, cases, on_card)

    n = x.numel()
    lo, hi = clamp.qparams.output_min, clamp.qparams.output_max
    row = dict(kernel="u8clamp", label=f"ops.Clamp {tuple(x.shape)}",
               bytes=2 * n, ops=2 * n,
               ms=time_ms(lambda: K.u8clamp_cuda(x, clamp.qparams), torch),
               plain_ms=time_ms(lambda: K.u8clamp_plain(x, clamp.qparams),
                                torch),
               library_ms=time_ms(lambda: torch.clamp(x, lo, hi), torch))
    log(f"    u8clamp {tuple(x.shape)}: {row['ms']:.4f} ms, bound "
        f"{2 * n / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes), plain "
        f"{row['plain_ms']:.4f} ms, torch.clamp {row['library_ms']:.4f} ms")
    for _, op, _ in on_card:
        op.delete()
    return captured, [row], graph_rows, deconv_rows


def time_deconv_ops(torch, cases, on_card):
    """Each Deconvolution2D of phase 6 at q31, zero points (121, 103),
    timed eagerly on the device (queued) as a whole and in its parts
    (nn/conv.py): the kernel launches alone (deconv_launches on the
    prepared input) and the lowering's copies alone (deconv_input's
    dilation where there is one, and deconv_output's depth-to-space or
    phase interleave).  Returns the rows."""
    from qnnpack_tpu_torch.nn.conv import (deconv_input, deconv_launches,
                                           deconv_output, deconv_plan)
    rows = []
    log("    Deconvolution2D eager, device ms (queued): whole run = kernel "
        "launches + copies")
    for (name, kw, _, launched), (_, op, xs) in zip(cases, on_card):
        if name != "Deconvolution2D" or kw["requant"] != "q31" or \
                kw["kernel_zero_point"] == 128:
            continue
        x = xs[0]
        b, h, w, _ = x.shape
        plan = deconv_plan(op.packed, op.rparams, op.strides, op.padding,
                           op.adjustment, op.dilation)
        a_in = deconv_input(x, op.packed, plan)
        ys = deconv_launches(a_in, op.packed, op.rparams, plan, h, w)
        out = deconv_output(ys, op.packed, plan, b, h, w)
        row = dict(
            label=f"ops.Deconvolution2D {tuple(x.shape)} {plan.lowering}",
            lowering=plan.lowering, launches=launched,
            out_bytes=out.numel(),
            ms=time_ms(lambda: op._forward(x), torch),
            launches_ms=time_ms(lambda: deconv_launches(
                a_in, op.packed, op.rparams, plan, h, w), torch),
            copies_ms=time_ms(lambda: (deconv_input(x, op.packed, plan),
                                       deconv_output(ys, op.packed, plan, b,
                                                     h, w)), torch))
        rows.append(row)
        log(f"      {row['label']:48s} {row['ms']:.4f} ms = launches "
            f"{row['launches_ms']:.4f} ({launched}) + copies "
            f"{row['copies_ms']:.4f} (output {out.numel()} bytes)")
    return rows


# Phase 6's operators timed as a graph and eagerly (indices into ops_cases):
# Add, Clamp, Sigmoid (a PyTorch table lookup), SoftArgMax (two launches),
# ChannelShuffle (PyTorch copies), the 1x1 gemm and dense dilated 3x3
# convs (q31), the 1000 x 1280 FC, the 16x112x112x64 max pool and the
# 128x49x1280 global average pool.
OPS_TIMED = (0, 1, 2, 4, 5, 6, 16, 25, 27, 31)


def time_ops_graph(torch, cases, on_card, own):
    """What a CUDA graph does to one operator's run: the operator's graph
    runner (Operator.lower: a copy into the graph's input buffer, the
    replay, a clone of its output) against the same run made eagerly
    (op._forward), each timed on the device (queued: launches back to
    back) and as a caller sees it (host costs included).  Returns the
    rows."""
    rows = []
    log("    operator runs, graph (copy in, replay, clone) vs eager; device "
        "ms (queued) and caller ms (host included):")
    for i in OPS_TIMED:
        name, kw, xs, _ = cases[i]
        op, dxs = on_card[i][1], on_card[i][2]
        runner = op.lower(*dxs)
        label = f"ops.{name} {tuple(dxs[0].shape)}"
        if name == "Convolution2D":
            label += f" {op.kernel_type}"
        row = dict(label=label, launches=sum(own[i].values()), bytes=sum(
            x.numel() for x in dxs) + op._forward(*dxs).numel())
        for mode, fn in (("graph", lambda: runner(*dxs)),
                         ("eager", lambda: op._forward(*dxs))):
            row[f"{mode}_ms"] = time_ms(fn, torch)
            row[f"{mode}_call_ms"] = time_ms(fn, torch, queued=False)
        rows.append(row)
        log(f"      {label:40s} {row['launches']} launch(es): graph "
            f"{row['graph_ms']:.4f} / {row['graph_call_ms']:.4f} ms, eager "
            f"{row['eager_ms']:.4f} / {row['eager_call_ms']:.4f} ms")
    return rows


def serve_and_check(torch, name, fn, params, samples, expected,
                    warm=False):
    """Serve `samples` one request each through InferenceServer; every
    answer must equal its row of one direct batch forward.  The server runs
    each bucket as a CUDA graph: a bucket's first step captures it (an
    eager warm-up and the capture, each launching `expected`) and later
    steps replay it (no launch).  With `warm`, InferenceServer.warmup()
    captures every bucket first, and the requests then launch nothing.
    Returns (answers, batches, p50 latency ms)."""
    from qnnpack_tpu_torch import kernels as K
    from qnnpack_tpu_torch.serving import InferenceServer
    with torch.inference_mode():
        direct = fn(params, torch.from_numpy(samples).cuda()).cpu().numpy()
    server = InferenceServer(fn, samples.shape[1:], params=params,
                             max_batch=8)
    if warm:
        server.warmup()
        if server.captured != [1, 2, 4, 8]:
            raise AssertionError(f"{name}: warmup captured buckets "
                                 f"{server.captured}")
    torch.cuda.synchronize()
    K.reset_launch_counts()
    with server:
        futures = [server.submit(x, block=True) for x in samples]
        answers = [f.result(timeout=300) for f in futures]
        captured = len(server.captured)
    torch.cuda.synchronize()
    served = K.launch_counts()
    for i, ans in enumerate(answers):
        if not np.array_equal(ans, direct[i]):
            raise AssertionError(f"{name}: served answer {i} != batch "
                                 "forward row")
    batches = server.stats.batches
    new = 0 if warm else captured
    want = {k: 2 * v * new for k, v in expected.items()}
    if served != want:
        raise AssertionError(f"{name}: served launches {served} for "
                             f"{batches} batches, {new} buckets captured")
    latency = server.stats.latency_percentile(50)
    log(f"    {len(samples)} answers equal the batch forward; {batches} "
        f"batches, {captured} bucket graphs"
        + (" captured by warmup()" if warm else " captured on first use")
        + f", launches {served}, p50 latency {latency:.2f} ms")
    return answers, batches, latency


def check_imported(torch):
    """Phase 7: the bundled TFLite models imported onto the card against
    their CPU imports.  Returns {model: (fn, params, x batch 1)}, their
    launch counts, served batches and p50 latencies."""
    from qnnpack_tpu_torch import kernels as K
    from qnnpack_tpu_torch.io import BatchPrefetcher, image_pipeline
    from qnnpack_tpu_torch.io.accuracy import quantize_input, synth_images
    from qnnpack_tpu_torch.io.native import resize_quantize_plain
    from qnnpack_tpu_torch.io.tflite_import import import_tflite
    from qnnpack_tpu_torch.kernels import _build
    from qnnpack_tpu_torch.models.graph import graph_forward

    root = Path(__file__).resolve().parent
    images = synth_images(4, seed=17)
    models, launches, served, latency = {}, {}, {}, {}
    for name, asset in IMPORTED.items():
        log(f"[7] {name}: {asset} imported on the card and on the CPU")
        params, spec, meta = import_tflite(root / asset, device="cuda")
        params_cpu, spec_cpu, _ = import_tflite(root / asset, device="cpu")
        izp, scale = meta["input_zero_point"], meta["input_scale"]

        def to_u8(batch, scale=scale, izp=izp):
            q = quantize_input(batch, scale, izp - 128)
            return (q.astype(np.int16) + 128).astype(np.uint8)

        staged = list(BatchPrefetcher([images], preprocess=to_u8))
        if len(staged) != 1 or staged[0].device.type != "cuda":
            raise AssertionError(f"prefetcher gave {staged}")
        x4 = staged[0]

        def fn(p, x, spec=spec):
            return graph_forward(p, spec, x)

        fn.spec = spec
        misses = _build._channel_scales.cache_info().misses
        with torch.inference_mode():
            y4 = fn(params, x4)
            y4_cpu = graph_forward(params_cpu, spec_cpu, torch.from_numpy(
                to_u8(images)))
            if tuple(y4.shape) != (4, 1000) or y4.dtype != torch.uint8:
                raise AssertionError(f"{name} output {tuple(y4.shape)} "
                                     f"{y4.dtype}")
            if not torch.equal(y4.cpu(), y4_cpu):
                diff = (y4.cpu().int() - y4_cpu.int()).abs()
                raise AssertionError(
                    f"{name} batch-4 forward differs in "
                    f"{int((diff > 0).sum())} values, max |err| "
                    f"{int(diff.max())}")
            if any(len(torch.unique(row)) < 2 for row in y4_cpu):
                raise AssertionError(f"{name}: a constant output row")
            log(f"    batch 4 through BatchPrefetcher: card equals CPU; "
                f"top-1 {y4_cpu.argmax(dim=1).tolist()}")
            x1 = x4[:1].contiguous()
            K.reset_launch_counts()
            y1 = fn(params, x1)
            torch.cuda.synchronize()
            launches[name] = K.launch_counts()
        new_misses = _build._channel_scales.cache_info().misses - misses
        log(f"    launches over one batch-1 forward: {launches[name]}")
        if launches[name] != IMPORTED_LAUNCHES[name]:
            raise AssertionError(f"launches {launches[name]} != "
                                 f"{IMPORTED_LAUNCHES[name]}")
        if not torch.equal(y1, y4[:1]):
            raise AssertionError(f"{name}: batch-1 forward != row 0 of "
                                 "batch 4")
        if new_misses:
            raise AssertionError(f"{name}: {new_misses} per-channel scale "
                                 "cache misses (scales not on the card)")
        log("    per-channel scales: no _channel_scales miss (device_scales)")
        models[name] = (fn, params, x1)
        if name in IMPORTED_SERVED:
            log(f"[7] {name} InferenceServer: {IMPORTED_SERVED[name]} "
                "single-sample requests")
            samples = to_u8(synth_images(IMPORTED_SERVED[name], seed=18))
            _, served[name], latency[name] = serve_and_check(
                torch, name, fn, params, samples, IMPORTED_LAUNCHES[name])
        del params_cpu

    log("[7] io.image_pipeline: native resize + quantize onto the card")
    small = [synth_images(2, size=s, seed=19) for s in (160, 97)]
    got = list(image_pipeline(small, (224, 224), 0.0078431, 128))
    for src, g in zip(small, got):
        want = resize_quantize_plain(src, (224, 224), 0.0078431, 128)
        diff = np.abs(g.cpu().numpy().astype(np.int32) - want)
        if g.device.type != "cuda" or diff.max() > 1 or \
                (diff != 0).mean() >= 0.01:
            raise AssertionError(
                f"image_pipeline {src.shape}: max |err| {diff.max()}, "
                f"{(diff != 0).mean():.4f} of bytes differ")
        log(f"    {src.shape} -> {tuple(g.shape)} on {g.device}: within "
            f"one quantum of the numpy version ({(diff != 0).mean():.5f} "
            "of bytes differ)")
    return models, launches, served, latency


# ----------------------------------------- phase 9: captured forwards
def check_captured(torch, models, per_shape, forward, rng):
    """Each path's forward as CUDA graphs (ops.base.jit_forward) at batch 1
    and 128: the captured forward must equal the eager one byte for byte
    on two inputs (the second call copies new bytes into the graph's
    input buffer; the first call's output, a clone, must survive it), and
    its capture must launch the path's EXPECTED_LAUNCHES.  Both forwards
    are timed as a caller sees them (host launch costs included, as phase
    8 times forwards), in turns: eager, graph, graph, eager.  The busy
    share is phase 8's per-launch device times of that forward, summed,
    over the forward's time.  Each path's graphs are released before the
    next path's."""
    from qnnpack_tpu_torch.entry import input_shape
    from qnnpack_tpu_torch.ops.base import jit_forward

    expected = dict(EXPECTED_LAUNCHES, **IMPORTED_LAUNCHES)
    for model, (fn, params, _) in models.items():
        unit = "seq" if model == "bert_base_s128" else "img"
        for batch, iters in ((1, 20), (128, 3)):
            jf = jit_forward(fn)
            xs = [torch.from_numpy(rng.integers(
                0, 256, (batch,) + input_shape(model),
                dtype=np.int64).astype(np.uint8)).cuda() for _ in range(2)]
            with torch.inference_mode():
                want = [fn(params, x) for x in xs]
                runner = jf.lower(params, xs[0])
                got = [jf(params, x) for x in xs]
                torch.cuda.synchronize()
                for i, (g, w) in enumerate(zip(got, want)):
                    if not torch.equal(g, w):
                        diff = (g.int() - w.int()).abs()
                        raise AssertionError(
                            f"{model} b{batch} input {i}: captured forward "
                            f"differs in {int((diff > 0).sum())} values, "
                            f"max |err| {int(diff.max())}")
                if torch.equal(want[0], want[1]):
                    raise AssertionError(f"{model} b{batch}: two inputs, "
                                         "one output")
                if runner.launches != expected[model]:
                    raise AssertionError(
                        f"{model} b{batch}: capture launched "
                        f"{runner.launches}, not {expected[model]}")
                if len(jf.graphs) != 1:
                    raise AssertionError(f"{model} b{batch}: "
                                         f"{len(jf.graphs)} graphs")
                e1 = forward_ips(torch, fn, params, xs[0], iters)
                g1 = forward_ips(torch, jf, params, xs[0], iters)
                g2 = forward_ips(torch, jf, params, xs[0], iters)
                e2 = forward_ips(torch, fn, params, xs[0], iters)
            eager_ms = (e1[1] + e2[1]) / 2
            graph_ms = (g1[1] + g2[1]) / 2
            kernels_ms = sum(r["ms"] for r in per_shape[f"{model} b{batch}"])
            row = forward[model]
            row.update({
                f"b{batch}_eager_ms": eager_ms,
                f"b{batch}_eager_per_s": batch / (eager_ms * 1e-3),
                f"b{batch}_graph_ms": graph_ms,
                f"b{batch}_graph_per_s": batch / (graph_ms * 1e-3),
                f"b{batch}_kernels_ms": kernels_ms,
                f"b{batch}_eager_busy": kernels_ms / eager_ms,
                f"b{batch}_graph_busy": kernels_ms / graph_ms})
            log(f"    {model} b{batch}: captured == eager on two inputs, "
                f"capture launches as EXPECTED; eager {eager_ms:.3f} ms "
                f"({batch / (eager_ms * 1e-3):.1f} {unit}/s, busy "
                f"{kernels_ms / eager_ms:.2f}), graph {graph_ms:.3f} ms "
                f"({batch / (graph_ms * 1e-3):.1f} {unit}/s, busy "
                f"{kernels_ms / graph_ms:.2f}), kernels {kernels_ms:.3f} ms")
            del runner, got, want, xs
            jf.clear()
            torch.cuda.empty_cache()


def check_mimo(torch, rng, err):
    """MiMo-V2-Flash's block at its published widths (entry(model=
    "mimo_v2_flash"): seven layers, 8 of 256 experts, sequence 8,192), one
    b1 forward eager and captured (ops.base.jit_forward) on two inputs:
    the captured outputs must equal the eager ones byte for byte, the
    capture must launch MIMO_LAUNCHES, and the held experts' routed rows
    (the device counter moe.routed_rows) must be those of the eager run.
    Both forwards are timed in turns, eager, graph, graph, eager.  Then
    every launch of the b1 forward is checked against its plain version
    and timed (mimo_calls, time_calls).  Returns (forward row, the
    capture's launches, per-launch rows)."""
    from qnnpack_tpu_torch import kernels as K
    from qnnpack_tpu_torch.entry import entry, input_shape
    from qnnpack_tpu_torch.ops.base import jit_forward
    from qnnpack_tpu_torch.utils import profiling

    fn, (params, x) = entry(model="mimo_v2_flash")
    xs = [x, torch.from_numpy(rng.integers(
        0, 256, (1,) + input_shape("mimo_v2_flash"),
        dtype=np.int64).astype(np.uint8)).cuda()]
    jf = jit_forward(fn)
    with torch.inference_mode():
        K.reset_launch_counts()
        want = []
        routed = []
        for xi in xs:
            want.append(fn(params, xi))
            routed.append(profiling.counters()["moe.routed_rows"])
        if K.launch_counts() != {k: 2 * v for k, v in
                                 MIMO_LAUNCHES.items()}:
            raise AssertionError(f"mimo eager launches {K.launch_counts()}")
        runner = jf.lower(params, xs[0])
        got = []
        for xi, r in zip(xs, routed):
            got.append(jf(params, xi))
            torch.cuda.synchronize()
            if profiling.counters()["moe.routed_rows"] != r:
                raise AssertionError("mimo: captured routing differs")
        for i, (g, w) in enumerate(zip(got, want)):
            if not torch.equal(g, w):
                raise AssertionError(
                    f"mimo b1 input {i}: captured forward differs in "
                    f"{int((g != w).sum())} bytes")
        if torch.equal(want[0], want[1]):
            raise AssertionError("mimo b1: two inputs, one output")
        if runner.launches != MIMO_LAUNCHES:
            raise AssertionError(f"mimo capture launched {runner.launches}, "
                                 f"not {MIMO_LAUNCHES}")
        e1 = forward_ips(torch, fn, params, xs[0], 3)
        g1 = forward_ips(torch, jf, params, xs[0], 3)
        g2 = forward_ips(torch, jf, params, xs[0], 3)
        e2 = forward_ips(torch, fn, params, xs[0], 3)
    launches = dict(runner.launches)
    y = want[0]
    del runner, got, want
    jf.clear()
    torch.cuda.empty_cache()
    with torch.inference_mode():
        rows = time_calls(torch, mimo_calls(torch, params, fn.spec, xs[0],
                                            y), err, 1)
    kernels_ms = sum(r["ms"] for r in rows)
    row = dict(b1_eager_ms=(e1[1] + e2[1]) / 2,
               b1_graph_ms=(g1[1] + g2[1]) / 2, routed_rows=routed,
               b1_kernels_ms=kernels_ms)
    row["b1_graph_busy"] = kernels_ms / row["b1_graph_ms"]
    log(f"    mimo_v2_flash b1: captured == eager on two inputs, capture "
        f"launches MIMO_LAUNCHES, routed rows {routed} (8,192 tokens x 8 "
        f"x 8 / 256 = 2,048 expected a layer); eager "
        f"{row['b1_eager_ms']:.3f} ms, graph {row['b1_graph_ms']:.3f} ms; "
        f"each of its {len(rows)} kernel calls equals its plain version, "
        f"kernels {kernels_ms:.3f} ms (busy {row['b1_graph_busy']:.2f})")
    for name in MIMO_KERNELS:
        sm = summarize(rows, name)
        log(f"    mimo_v2_flash b1 {name:16s} {sm['shapes']:3d} calls: "
            f"{sm['ms']:.4f} ms, bound {sm['bound_ms']:.4f} ms "
            f"({sm['bound_by']}), plain {sm['plain_ms']:.4f} ms")
    del xs, params, y
    torch.cuda.empty_cache()
    return row, launches, rows


def check_runtime_spans(torch, models, rng, steps=20) -> dict:
    """A MobileNetV2 b128 jit_forward loop under utils/profiling.trace():
    every call is a qnnpack::runtime.key range (the key walk) followed by
    a qnnpack::runtime.call range holding runtime.copy_in, runtime.replay
    and runtime.clone_out, on the caller's thread; every replay holds the
    step's cudaGraphLaunch, whose kernels start on the card after it, on
    the trace's one timeline.  Returns the recorder's runtime spans over
    the loop (calls, mean host us, mean self us a call)."""
    from qnnpack_tpu_torch.entry import input_shape
    from qnnpack_tpu_torch.ops.base import jit_forward
    from qnnpack_tpu_torch.utils import profiling

    fn, params, _ = models["mobilenet_v2"]
    x = torch.from_numpy(rng.integers(
        0, 256, (128,) + input_shape("mobilenet_v2"),
        dtype=np.int64).astype(np.uint8)).cuda()
    jf = jit_forward(fn)
    out = Path("chiprun_out") / "runtime_spans"
    with torch.inference_mode():
        jf(params, x)
        torch.cuda.synchronize()
        before = profiling.totals()
        with profiling.trace(out):
            for _ in range(steps):
                jf(params, x)
            torch.cuda.synchronize()
        after = profiling.totals()
    jf.clear()
    events = json.loads((out / "trace.json").read_text())["traceEvents"]
    # A range's host side; the profiler adds a gpu_user_annotation copy of
    # a range that launched device work, on the card's track.
    xs = [e for e in events if e.get("ph") == "X"
          and e.get("cat") != "gpu_user_annotation"]

    def named(name):
        return [e for e in xs if e["name"] == name]

    def inside(a, b):
        return (a["tid"] == b["tid"] and b["ts"] <= a["ts"]
                and a["ts"] + a["dur"] <= b["ts"] + b["dur"])

    calls = named(profiling.PREFIX + "runtime.call")
    if len(calls) != steps:
        raise AssertionError(f"{len(calls)} runtime.call ranges for {steps} "
                             "calls")
    for child in ("copy_in", "replay", "clone_out"):
        ranges = named(profiling.PREFIX + "runtime." + child)
        if len(ranges) != steps or not all(
                any(inside(r, c) for c in calls) for r in ranges):
            raise AssertionError(f"runtime.{child}: {len(ranges)} ranges, "
                                 "not one inside each runtime.call")
    keys = sorted(named(profiling.PREFIX + "runtime.key"),
                  key=lambda e: e["ts"])
    calls.sort(key=lambda e: e["ts"])
    if len(keys) != steps or not all(
            k["tid"] == c["tid"] and k["ts"] + k["dur"] <= c["ts"]
            for k, c in zip(keys, calls)):
        raise AssertionError(f"runtime.key: {len(keys)} ranges, not one "
                             "before each runtime.call")
    replays = named(profiling.PREFIX + "runtime.replay")
    launches = [e for e in named("cudaGraphLaunch")
                if any(inside(e, r) for r in replays)]
    if len(launches) != steps:
        raise AssertionError(f"{len(launches)} cudaGraphLaunch inside the "
                             f"{steps} runtime.replay ranges")
    starts = {}
    for e in xs:
        if e.get("cat") == "kernel":
            c = e.get("args", {}).get("correlation")
            starts[c] = min(starts.get(c, e["ts"]), e["ts"])
    for e in launches:
        first = starts.get(e["args"]["correlation"])
        if first is None or first < e["ts"]:
            raise AssertionError("a graph launch's kernels are missing or "
                                 "start before it on the trace's timeline")
    spans = {}
    for path, t in after.items():
        if not path.startswith("runtime."):
            continue
        t0 = before.get(path, profiling.SpanTotal(0, 0.0, 0.0))
        n = t.calls - t0.calls
        if n == 0:   # a capture of the set-up before the loop
            continue
        spans[path] = dict(calls=n, us=(t.total_s - t0.total_s) * 1e6 / n,
                           self_us=(t.self_s - t0.self_s) * 1e6 / n)
    return spans


def check_two_graphs(torch, err, u8, sms, rounds=40):
    """Two CUDA graphs, each a chain of four split-K q8gemm launches
    (BERT's out projection at batch 1, 128x768->768) under weights of its
    own, replayed at once on two streams for `rounds` rounds.  Each graph
    counts its splits on counters of its own (ops.base.capture), so every
    output equals its eager bytes (the counterpart of check_two_streams
    for graphs)."""
    from qnnpack_tpu_torch import kernels as K
    from qnnpack_tpu_torch.nn.packing import pack_gemm_weights
    from qnnpack_tpu_torch.nn.requant_dispatch import make_requant_params
    from qnnpack_tpu_torch.ops.base import jit_forward

    m, k, n = 128, 768, 768
    plan = gemm_plan(m, n, k, 1, sms)
    if plan[1] < 2:
        raise AssertionError(f"{m}x{k}->{n} not split: {plan}")
    rp = make_requant_params("fp32", 0.0074, 117)
    cuda = torch.device("cuda")

    def chain(p):
        def run(a):
            for _ in range(4):
                a = K.q8gemm_cuda(a, p, rp)
            return a
        return run

    fns = [chain(pack_gemm_weights(
        u8(n, k), np.arange(n, dtype=np.int32) * (7 + i), 128, 128,
        device=cuda)) for i in range(2)]
    xs = [torch.from_numpy(u8(m, k)).to(cuda) for _ in fns]
    wants = [f(x) for f, x in zip(fns, xs)]
    jfs = [jit_forward(f) for f in fns]
    runners = [jf.lower(x) for jf, x in zip(jfs, xs)]
    if runners[0].counters.data_ptr() == runners[1].counters.data_ptr():
        raise AssertionError("two graphs share their split-K counters")
    for r in runners:
        if r.launches["q8gemm"] != 4:
            raise AssertionError(f"capture launched {r.launches}")
    streams = [torch.cuda.Stream() for _ in fns]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(rounds):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(jfs[i](xs[i]))
    torch.cuda.synchronize()
    for i, want in enumerate(wants):
        for got in outs[i]:
            compare(torch, err, "q8gemm", f"graph {i}", got, want,
                    quiet=True)
    label = f"two graphs x {rounds} 4 x out b1 {plan_tag(plan)}"
    log(f"  {'q8gemm':10s} {label:44s} equal")
    for jf in jfs:
        jf.clear()


def check_measure_loop(torch, models, per_shape, rng):
    """dispatch_overhead() and one measure_loop of MobileNetV2's b128
    classifier q8gemm launch (captured loops of n and 2n calls, each
    call's output summed into an int32, and the launches alone), beside
    phase 8's CUDA-event time of the same launch; then MobileNetV2's b128
    q8gavgpool and the launch floor (a one-element zero_()) as loops of
    launches in a graph."""
    from qnnpack_tpu_torch import kernels as K
    from qnnpack_tpu_torch.nn.packing import PackedGemmWeights
    from qnnpack_tpu_torch.utils.timing import dispatch_overhead, measure_loop

    med, spread = dispatch_overhead()
    log(f"    dispatch_overhead(): median {med * 1e3:.4f} ms, p10-p90 spread "
        f"{spread * 1e3:.4f} ms (15 synchronized +1 launches on 8x128 "
        "uint8)")
    fn, params, _ = models["mobilenet_v2"]
    xb = torch.from_numpy(rng.integers(0, 256, (128, 224, 224, 3),
                                       dtype=np.int64).astype(np.uint8)).cuda()
    last = None
    with torch.inference_mode():
        for _, name, layer, p, a, _ in traced_inputs(
                "mobilenet_v2", params, fn.spec, xb):
            if isinstance(p, PackedGemmWeights):
                last = (name, layer, p, a.reshape(-1, a.shape[-1]))
    name, layer, p, a2 = last
    label = f"{name} {a2.shape[0]}x{a2.shape[1]}->{p.n}"
    ms8 = next(r["ms"] for r in per_shape["mobilenet_v2 b128"]
               if r["label"] == label)
    meas = measure_loop(lambda v: K.q8gemm_cuda(v, p, layer.rparams), a2,
                        min_seconds=0.05, est_seconds=ms8 * 1e-3)
    # The same launches alone: chained through a tuple that carries the
    # input along, so no sum runs between them.
    alone = measure_loop(
        lambda t: (t[0], K.q8gemm_cuda(t[0], p, layer.rparams)),
        (a2, K.q8gemm_cuda(a2, p, layer.rparams)), chain=True,
        min_seconds=0.05, est_seconds=ms8 * 1e-3)
    log(f"    measure_loop q8gemm {label}: {meas.seconds * 1e3:.5f} ms "
        f"(n = {meas.n_iters}, dispersion {meas.dispersion:.3f}; each call "
        f"also sums its output), {alone.seconds * 1e3:.5f} ms alone; "
        f"phase 8 CUDA events {ms8:.5f} ms")
    # q8gavgpool launches alone in a graph, beside one-element zero_()
    # launches: what a launch costs inside a graph.
    gap = next(r for r in per_shape["mobilenet_v2 b128"]
               if r["kernel"] == "q8gavgpool")
    qp = next(layer for tag, _, layer in fn.spec.layers if tag == "gap")
    a3 = torch.from_numpy(rng.integers(0, 256, (128, 49, 1280),
                                       dtype=np.int64).astype(np.uint8)).cuda()
    y3 = K.q8gavgpool_cuda(a3, qp)
    gav = measure_loop(lambda t: (t[0], K.q8gavgpool_cuda(t[0], qp)),
                       (a3, y3), chain=True, min_seconds=0.05,
                       est_seconds=gap["ms"] * 1e-3)
    one = torch.zeros(1, dtype=torch.uint8, device="cuda")
    flo = measure_loop(lambda v: v.zero_(), one, chain=True,
                       min_seconds=0.05, est_seconds=2e-6)
    log(f"    measure_loop q8gavgpool {gap['label']}: "
        f"{gav.seconds * 1e3:.5f} ms in a graph (phase 8 CUDA events "
        f"{gap['ms']:.5f}); one-element zero_() in a graph "
        f"{flo.seconds * 1e3:.5f} ms")
    return dict(dispatch_overhead_ms=med * 1e3,
                dispatch_spread_ms=spread * 1e3, measure_loop_label=label,
                measure_loop_ms=meas.seconds * 1e3,
                measure_loop_n=meas.n_iters,
                measure_loop_dispersion=meas.dispersion,
                measure_loop_alone_ms=alone.seconds * 1e3, phase8_ms=ms8, gavgpool_label=gap["label"],
                gavgpool_graph_ms=gav.seconds * 1e3,
                gavgpool_phase8_ms=gap["ms"],
                zero_graph_ms=flo.seconds * 1e3)


# ------------------------------------------------------------------ main
# ------------------------------------------------ phase 10: parallel layer
# One run of phase 10's main path: the one-rank NCCL mesh's MobileNetV2
# b128 forward (shard_params + sharded_inference_fn), gemm_kdim_tp at the
# MobileNetV2 head's b128 shape and conv_ic_tp at ResNet-18's 3x3 256->256
# conv at 14x14, b128.
PARALLEL_LAUNCHES = _counts(q8gemm=35, q8stem=1, q8dwconv=17, q8vadd=10,
                            q8gavgpool=1, q8gemm_partial=1, q8conv_partial=1,
                            q8requant=2)
HEAD = (128 * 7 * 7, 320, 1280)  # M, K, N of MobileNetV2's b128 head
RESNET_CONV = (128, 14, 14, 256, 256)  # B, H, W, C, O of a 3x3 s1 pad 1


def partial_plan(name, packed, m, sms):
    if name == "q8gemm_partial":
        return gemm_plan(m, packed.n, packed.k, 1, sms)
    return conv_plan(packed, m, sms)


def check_partials(torch, err, u8, sms):
    """q8gemm's and q8conv's partial instances against their plain versions
    (int32, torch.equal) at every block shape and split-K plan, K = 70,000
    with sums past +-2^31, kzp 128 and != 128, bases 8 bytes off 16, izp
    taps; q8requant under the five schemes at N = 1,280 (16-byte loads),
    odd N and a base 4 bytes off 16 (one element a thread), with biases
    that wrap the sum."""
    from qnnpack_tpu_torch import kernels as K
    from qnnpack_tpu_torch.kernels._build import out_dims
    from qnnpack_tpu_torch.nn.conv import pack_conv_weights
    from qnnpack_tpu_torch.nn.packing import pack_gemm_weights
    from qnnpack_tpu_torch.nn.requant_dispatch import make_requant_params
    from qnnpack_tpu_torch.quant.params import compute_per_channel_fp32_params

    cuda = torch.device("cuda")
    plans = set()

    def placed(x, offset):
        buf = torch.empty(x.numel() * x.element_size() + offset,
                          dtype=torch.uint8, device=cuda)
        view = buf[offset:].view(x.dtype).view(x.shape)
        view.copy_(x)
        return view

    # (label, M, K, N, izp, kzp, base offset)
    for label, m, k, n, izp, kzp, off in [
            ("head b128 6272x320->1280", *HEAD, 128, 128, 0),
            ("head b128 kzp 103", *HEAD, 121, 103, 0),
            ("head K/4 6272x80->1280 kzp 103", 6272, 80, 1280, 121, 103, 0),
            ("head b1 49x320->1280 kzp 103", 49, 320, 1280, 121, 103, 0),
            ("20000x64->64 kzp 90", 20000, 64, 64, 7, 90, 0),
            ("bert out 16384x768->768", 16384, 768, 768, 128, 128, 0),
            ("128x3072->768 kzp 200 (split-K)", 128, 3072, 768, 250, 200, 0),
            ("ragged 67x961->65 kzp 77", 67, 961, 65, 3, 77, 0),
            ("base + 8 bytes 500x144->96 kzp 103", 500, 144, 96, 121, 103,
             8)]:
        kernel, a = u8(n, k), torch.from_numpy(u8(m, k))
        packed = pack_gemm_weights(kernel, None, izp, kzp)
        want = K.q8gemm_partial_cuda(a, packed)
        got = K.q8gemm_partial_cuda(placed(a.to(cuda), off) if off else
                                    a.to(cuda), pack_gemm_weights(
                                        kernel, None, izp, kzp, device=cuda))
        plan = gemm_plan(m, n, k, 1, sms)
        plans.add(("q8gemm_partial", plan[0], plan[1] > 1))
        compare(torch, err, "q8gemm_partial", f"{label} {plan_tag(plan)}",
                got, want)
    # K = 70,000 at the extremes: every column's sum passes +-2^31.
    m, k, n = 1088, 70000, 256
    kernel = np.zeros((n, k), np.uint8)
    kernel[1::2] = 255
    a = torch.full((m, k), 255, dtype=torch.uint8)
    a[1::3] = torch.from_numpy(u8(len(range(1, m, 3)), k))
    for kzp in (0, 128):
        plan = gemm_plan(m, n, k, 1, sms)
        compare(torch, err, "q8gemm_partial",
                f"K=70000 kzp {kzp} extremes, wrap {plan_tag(plan)}",
                K.q8gemm_partial_cuda(a.to(cuda), pack_gemm_weights(
                    kernel, None, 255, kzp, device=cuda)),
                K.q8gemm_partial_cuda(a, pack_gemm_weights(kernel, None, 255,
                                                           kzp)))
    del a, kernel

    p1, s2 = ((1, 1), (1, 1)), ((0, 1), (0, 1))
    # (label, B, H, W, C, O, k, stride, padding, dilation, izp, kzp)
    for (label, bsz, h, w, c, o, k, s, pad, d, izp, kzp) in [
            ("resnet b128 3x3 14x14x256->256", *RESNET_CONV[:3], 256, 256, 3,
             1, p1, 1, 128, 128),
            ("resnet b128 kzp 103 izp 121", *RESNET_CONV[:3], 256, 256, 3, 1,
             p1, 1, 121, 103),
            ("resnet C/4 14x14x64->256 kzp 103", *RESNET_CONV[:3], 64, 256,
             3, 1, p1, 1, 121, 103),
            ("b32 3x3 28x28x64->64 kzp 90", 32, 28, 28, 64, 64, 3, 1, p1, 1,
             7, 90),
            ("7x7x512 kzp 90 (split-K)", 1, 7, 7, 512, 512, 3, 1, p1, 1, 121,
             90),
            ("1x1 s2 56x56x64->128 kzp 103", 1, 56, 56, 64, 128, 1, 2,
             ((0, 0), (0, 0)), 1, 121, 103),
            ("izp 121 kzp 103 13x11x24->40", 2, 13, 11, 24, 40, 3, 1, p1, 1,
             121, 103),
            ("C=5 s2 pad (0,1) kzp 90", 3, 9, 7, 5, 70, 3, 2, s2, 1, 7, 90),
            ("dil 2 12x10x16->33 kzp 200", 1, 12, 10, 16, 33, 3, 1,
             ((2, 2), (2, 2)), 2, 250, 200)]:
        kernel, a = u8(o, k, k, c), torch.from_numpy(u8(bsz, h, w, c))
        args = dict(strides=(s, s), padding=pad, dilation=(d, d))
        packed = pack_conv_weights(kernel, None, izp, kzp)
        ho, wo = out_dims(h, w, k, k, (s, s), pad, (d, d))
        plan = conv_plan(packed, bsz * ho * wo, sms)
        plans.add(("q8conv_partial", plan[0], plan[1] > 1))
        compare(torch, err, "q8conv_partial", f"{label} {plan_tag(plan)}",
                K.q8conv_partial_cuda(a.to(cuda), pack_conv_weights(
                    kernel, None, izp, kzp, device=cuda), **args),
                K.q8conv_partial_cuda(a, packed, **args))
    want_plans = {(name, tile, tile == 2 and split)
                  for name in ("q8gemm_partial", "q8conv_partial")
                  for tile in range(4) for split in (False, True)}
    if not want_plans <= plans:
        raise AssertionError(f"plans not covered: {want_plans - plans}")

    rng = np.random.default_rng(77)
    for scheme in ("q31", "fp32", "precise", "gemmlowp", "pc"):
        for m, n, off in ((6272, 1280, 0), (33, 37, 0), (64, 1280, 4)):
            acc = torch.from_numpy(rng.integers(
                -2**31, 2**31, (m, n), dtype=np.int64).astype(np.int32))
            bias = torch.from_numpy(rng.integers(
                -2**31, 2**31, n, dtype=np.int64).astype(np.int32))
            acc[0] = 2**31 - 5
            bias[:4] = torch.tensor([2**31 - 1, -2**31, 7, -9])
            rp = (compute_per_channel_fp32_params(
                rng.uniform(1e-9, 1e-8, n), 117) if scheme == "pc" else
                make_requant_params(scheme, 3e-9, 117))
            compare(torch, err, "q8requant",
                    f"{scheme} {m}x{n}" + (f" base + {off}" if off else ""),
                    K.q8requant_cuda(placed(acc.to(cuda), off) if off else
                                     acc.to(cuda), bias.to(cuda), rp),
                    K.q8requant_cuda(acc, bias, rp))


def check_shard_arithmetic(torch, err, u8):
    """For n = 2 and 4 on one card: each K (or input-channel) slice's
    partial launch on its slice record (parallel/mesh.py gemm_k_slice,
    conv_c_slice), summed in int32 on the card, then q8requant with the
    whole record's bias_c, must equal the unsharded q8gemm / q8conv bytes;
    at the head and ResNet-18 shapes, kzp 128 and 103."""
    from qnnpack_tpu_torch import kernels as K
    from qnnpack_tpu_torch.nn.conv import (pack_conv_weights,
                                           q8conv2d_partial)
    from qnnpack_tpu_torch.nn.gemm import q8gemm_partial, q8requant
    from qnnpack_tpu_torch.nn.packing import pack_gemm_weights
    from qnnpack_tpu_torch.nn.requant_dispatch import make_requant_params
    from qnnpack_tpu_torch.parallel.mesh import conv_c_slice, gemm_k_slice

    cuda = torch.device("cuda")
    m, k, n = HEAD
    bsz, h, w, c, o = RESNET_CONV
    rp = make_requant_params("fp32", 2e-4, 128, 128, 188)
    for izp, kzp in ((128, 128), (121, 103)):
        a = torch.from_numpy(u8(m, k)).to(cuda)
        packed = pack_gemm_weights(u8(n, k), np.arange(n, dtype=np.int32),
                                   izp, kzp, device=cuda)
        want = K.q8gemm_cuda(a, packed, rp)
        x = torch.from_numpy(u8(bsz, h, w, c)).to(cuda)
        cpacked = pack_conv_weights(u8(o, 3, 3, c), None, izp, kzp,
                                    device=cuda)
        cwant = K.q8conv_cuda(x, cpacked, rp, padding=((1, 1), (1, 1)))
        for shards in (2, 4):
            ks, cs = k // shards, c // shards
            total = sum(q8gemm_partial(a[:, i * ks:(i + 1) * ks].contiguous(),
                                       gemm_k_slice(packed, shards, i))
                        for i in range(shards))
            compare(torch, err, "q8requant",
                    f"head {m}x{k}->{n} as {shards} K slices, kzp {kzp}",
                    q8requant(total, packed.bias_c, rp), want)
            total = sum(q8conv2d_partial(
                x[..., i * cs:(i + 1) * cs].contiguous(),
                conv_c_slice(cpacked, shards, i), padding=((1, 1), (1, 1)))
                for i in range(shards))
            compare(torch, err, "q8requant",
                    f"resnet 3x3 {c}->{o} as {shards} C slices, kzp {kzp}",
                    q8requant(total.reshape(-1, o), cpacked.bias_c,
                              rp).reshape(cwant.shape), cwant)
        del a, x, packed, cpacked


def check_parallel(torch, err, models, rng):
    """Phase 10: the parallel layer on the card.  The partial instances and
    q8requant against their plain versions; the shard arithmetic of K and
    input-channel TP for n = 2 and 4 on one card; then a one-rank NCCL mesh
    (make_mesh(device="cuda"), the only mesh one card allows): the
    MobileNetV2 b128 forward through shard_params + sharded_inference_fn
    equal to entry's forward, gemm_kdim_tp and conv_ic_tp (kzp 128 and
    103) equal to q8gemm / q8conv, spatial_conv2d, pipeline_apply and
    grouped_conv2d_ep equal to their unsharded convs and GEMMs; one run of
    the main path launches PARALLEL_LAUNCHES.  Timed: the partial
    instances beside plain q8gemm / q8conv in turns, q8requant against its
    bound, and the sharded forward against entry's, eager and captured.
    The world is torn down at the end."""
    from qnnpack_tpu_torch import kernels as K
    from qnnpack_tpu_torch import parallel as P
    from qnnpack_tpu_torch.nn.conv import im2col, pack_conv_weights, q8conv2d
    from qnnpack_tpu_torch.nn.gemm import q8gemm
    from qnnpack_tpu_torch.nn.packing import pack_gemm_weights
    from qnnpack_tpu_torch.nn.requant_dispatch import make_requant_params
    from qnnpack_tpu_torch.ops.base import jit_forward

    cuda = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def u8(*shape):
        return rng.integers(0, 256, shape, dtype=np.int64).astype(np.uint8)

    def equal(label, got, want):
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: sharded != unsharded")
        log(f"  {label:58s} equal")

    check_partials(torch, err, u8, sms)
    check_shard_arithmetic(torch, err, u8)

    mesh = P.make_mesh(device="cuda")
    log(f"    one-rank mesh: {mesh}, backend "
        f"{torch.distributed.get_backend()}")
    fn, params, _ = models["mobilenet_v2"]
    xb = torch.from_numpy(u8(128, 224, 224, 3)).to(cuda)
    sharded = P.shard_params(params, mesh)
    fwd = P.sharded_inference_fn(fn, mesh)
    bs = P.batch_sharding(mesh)
    m, k, n = HEAD
    head_a = torch.from_numpy(u8(m, k)).to(cuda)
    bsz, h, w, c, o = RESNET_CONV
    conv_x = torch.from_numpy(u8(bsz, h, w, c)).to(cuda)
    rp = make_requant_params("fp32", 2e-4, 128, 128, 188)
    p1 = ((1, 1), (1, 1))
    heads = {kzp: pack_gemm_weights(u8(n, k), None, izp, kzp, device=cuda)
             for izp, kzp in ((128, 128), (121, 103))}
    convs = {kzp: pack_conv_weights(u8(o, 3, 3, c), None, izp, kzp,
                                    device=cuda)
             for izp, kzp in ((128, 128), (121, 103))}
    with torch.inference_mode():
        want = fn(params, xb)
        got = bs.gather(fwd(sharded, bs.shard(xb)))
        equal("MobileNetV2 b128 sharded (one-rank mesh) vs entry", got, want)
        for kzp in (128, 103):
            equal(f"gemm_kdim_tp head kzp {kzp}",
                  P.gemm_kdim_tp(head_a, heads[kzp], rp, mesh),
                  q8gemm(head_a, heads[kzp], rp))
            equal(f"conv_ic_tp resnet 3x3 kzp {kzp}",
                  P.conv_ic_tp(conv_x, convs[kzp], rp, mesh, padding=p1),
                  q8conv2d(conv_x, convs[kzp], rp, padding=p1))
        equal("spatial_conv2d resnet 3x3 on 'data'",
              P.spatial_conv2d(conv_x, convs[103], rp, mesh, axis="data",
                               padding=p1),
              q8conv2d(conv_x, convs[103], rp, padding=p1))
        stage = pack_gemm_weights(u8(512, 512), None, 121, 103, device=cuda)
        x_micro = torch.from_numpy(u8(4, 128, 512)).to(cuda)
        equal("pipeline_apply one stage 4 x 128x512",
              P.pipeline_apply(lambda p, v: q8gemm(v, p, rp),
                               P.stack_stage_params([stage]), x_micro, mesh),
              torch.stack([q8gemm(v, stage, rp) for v in x_micro]))
        grouped = pack_conv_weights(u8(60, 1, 1, 80), None, 128, 128, 3,
                                    device=cuda)
        gx = torch.from_numpy(u8(128, 28, 28, 240)).to(cuda)
        equal("grouped_conv2d_ep g3 28x28 80->20",
              P.grouped_conv2d_ep(gx, grouped, rp, mesh),
              q8conv2d(gx, grouped, rp))

        K.reset_launch_counts()
        bs.gather(fwd(sharded, bs.shard(xb)))
        P.gemm_kdim_tp(head_a, heads[128], rp, mesh)
        P.conv_ic_tp(conv_x, convs[128], rp, mesh, padding=p1)
        torch.cuda.synchronize()
        launches = K.launch_counts()
        log(f"    main path launches: {launches}")
        if launches != PARALLEL_LAUNCHES:
            raise AssertionError(f"launches {launches} != "
                                 f"{PARALLEL_LAUNCHES}")

        # Times, in turns (plain kernel, partial, partial, plain kernel).
        head, conv = heads[128], convs[128]
        t = {}
        for name, run in (
                ("q8gemm", lambda: K.q8gemm_cuda(head_a, head, rp)),
                ("q8gemm_partial", lambda: K.q8gemm_partial_cuda(head_a,
                                                                 head)),
                ("q8gemm_partial 2", lambda: K.q8gemm_partial_cuda(head_a,
                                                                   head)),
                ("q8gemm 2", lambda: K.q8gemm_cuda(head_a, head, rp)),
                ("q8conv", lambda: K.q8conv_cuda(conv_x, conv, rp,
                                                 padding=p1)),
                ("q8conv_partial", lambda: K.q8conv_partial_cuda(
                    conv_x, conv, padding=p1)),
                ("q8conv_partial 2", lambda: K.q8conv_partial_cuda(
                    conv_x, conv, padding=p1)),
                ("q8conv 2", lambda: K.q8conv_cuda(conv_x, conv, rp,
                                                   padding=p1))):
            t[name] = time_ms(run, torch)
        acc = K.q8gemm_partial_cuda(head_a, head)
        cacc = K.q8conv_partial_cuda(conv_x, conv, padding=p1).reshape(-1, o)
        rows = {}
        cols, _ = im2col(conv_x, conv, (1, 1), p1)
        # (name, M, K, N, input bytes, ...): each input read once, the
        # int32 output written once.
        for name, mm, kk, nn, a_bytes, plain, library in (
                ("q8gemm_partial", m, k, n, head_a.numel(),
                 lambda: K.partial_acc_plain(head_a, head.w, head.kzp_biased),
                 int_mm_yardstick(torch, head_a, head.w)),
                ("q8conv_partial", bsz * h * w, 9 * c, o, conv_x.numel(),
                 lambda: K.q8conv_partial_plain(conv_x, conv, padding=p1),
                 int_mm_yardstick(torch, cols, conv.as_gemm().w))):
            nbytes = a_bytes + kk * nn + 4 * mm * nn
            ops = 2 * mm * nn * kk
            bound = max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3
            rows[name] = dict(
                ms=(t[name] + t[name + " 2"]) / 2,
                plain_ms=time_ms(plain, torch, repeats=1),
                library_ms=time_ms(library, torch), bound_ms=bound,
                bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                          >= ops / INT8_OPS_PER_S else "operations"),
                plan=plan_tag(partial_plan(
                    name, head if name == "q8gemm_partial" else conv, mm,
                    sms)))
            base = name.split("_")[0]
            rows[name]["kernel_ms"] = (t[base] + t[base + " 2"]) / 2
        rq = {}
        for label, a_i32, bias in (("head", acc, head.bias_c),
                                   ("resnet", cacc, conv.bias_c)):
            mm, nn = a_i32.shape
            rq[label] = dict(
                ms=time_ms(lambda: K.q8requant_cuda(a_i32, bias, rp), torch),
                plain_ms=time_ms(lambda: K.q8requant_plain(a_i32, bias, rp),
                                 torch, repeats=1),
                bound_ms=(5 * mm * nn + 4 * nn) / HBM_BYTES_PER_S * 1e3)
        rows["q8requant"] = dict(
            {key: rq["head"][key] + rq["resnet"][key]
             for key in ("ms", "plain_ms", "bound_ms")},
            bound_by="bytes", library_ms=None, head=rq["head"],
            resnet=rq["resnet"])
        e1 = forward_ips(torch, fn, params, xb, 3)
        s1 = forward_ips(torch, lambda p, v: fwd(p, v), sharded, xb, 3)
        s2 = forward_ips(torch, lambda p, v: fwd(p, v), sharded, xb, 3)
        e2 = forward_ips(torch, fn, params, xb, 3)
        jf_e, jf_s = jit_forward(fn), jit_forward(fwd)
        if not torch.equal(jf_s(sharded, xb), want) or \
                not torch.equal(jf_e(params, xb), want):
            raise AssertionError("captured sharded forward != entry's")
        ge1 = forward_ips(torch, jf_e, params, xb, 3)
        gs1 = forward_ips(torch, jf_s, sharded, xb, 3)
        gs2 = forward_ips(torch, jf_s, sharded, xb, 3)
        ge2 = forward_ips(torch, jf_e, params, xb, 3)
        jf_e.clear()
        jf_s.clear()
    forward = dict(entry_eager_ms=(e1[1] + e2[1]) / 2,
                   sharded_eager_ms=(s1[1] + s2[1]) / 2,
                   entry_graph_ms=(ge1[1] + ge2[1]) / 2,
                   sharded_graph_ms=(gs1[1] + gs2[1]) / 2)
    for name in ("q8gemm_partial", "q8conv_partial"):
        r = rows[name]
        log(f"    {name} {r['plan']}: {r['ms']:.4f} ms (plain kernel in "
            f"turns {r['kernel_ms']:.4f} ms), bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms")
    for label, r in rq.items():
        log(f"    q8requant {label}: {r['ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms (bytes, {r['bound_ms'] / r['ms']:.0%}), "
            f"plain {r['plain_ms']:.4f} ms")
    log("    MobileNetV2 b128 sharded vs entry: eager "
        f"{forward['sharded_eager_ms']:.3f} vs "
        f"{forward['entry_eager_ms']:.3f} ms, captured "
        f"{forward['sharded_graph_ms']:.3f} vs "
        f"{forward['entry_graph_ms']:.3f} ms")
    P.distributed_shutdown()
    return launches, rows, forward


def main() -> int:
    global HBM_BYTES_PER_S, INT8_OPS_PER_S
    if set(SOURCES) != set(KERNELS):
        print(f"chip_smoke: SOURCES and kernels.KERNELS differ in "
              f"{sorted(set(SOURCES) ^ set(KERNELS))}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 2
    from qnnpack_tpu_torch import kernels as K
    from qnnpack_tpu_torch.config import initialize
    from qnnpack_tpu_torch.entry import entry, input_shape
    from qnnpack_tpu_torch.kernels import _build
    from qnnpack_tpu_torch.serving import HealthMonitor
    from qnnpack_tpu_torch.utils import profiling

    HBM_BYTES_PER_S, INT8_OPS_PER_S = card_peaks()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[1] card: {smi}")
    log(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, {kind}; data-sheet peaks "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, {INT8_OPS_PER_S / 1e12:.0f} "
        "int8 TOP/s (config.tune_params)")
    t0 = time.perf_counter()
    _build.load_library()
    nvcc_seconds = (profiling.span_total("library.build") or (0, 0.0))[1]
    log(f"    kernels built in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {nvcc_seconds:.1f} s)")
    ptxas = [line.strip() for line in _build.build_log.splitlines()
             if "registers" in line or "spill" in line or "---" in line
             or "Compiling entry" in line]
    for line in ptxas:
        log(f"    ptxas: {line}")

    log("[2] kernels against their plain versions (CPU copies, torch.equal)")
    max_err = {name: 0 for name in K.KERNELS}
    check_kernels(torch, max_err)
    rng2 = np.random.default_rng(4321)
    check_deconvs(torch, max_err, rng2)
    row_sum_timing = check_row_sums(
        torch, max_err, lambda *shape: rng2.integers(
            0, 256, shape, dtype=np.int64).astype(np.uint8),
        torch.cuda.get_device_properties(0).multi_processor_count)
    check_float_ops(torch, rng2)

    models = {}
    launches = {}
    with torch.inference_mode():
        for model in EXPECTED_LAUNCHES:
            shape = (1,) + input_shape(model)
            log(f"[3] {model} {shape} fp32, seed 0, batch 1: card vs CPU "
                "plain")
            fn, (params, x) = entry(model=model)
            fn_cpu, (params_cpu, x_cpu) = entry(device="cpu", model=model)
            models[model] = (fn, params, x)
            y = fn(params, x)
            y_cpu = fn_cpu(params_cpu, x_cpu)
            del params_cpu
            check_output(torch, model, y, y_cpu)

            log(f"[4] {model}: launches over one forward (main path)")
            K.reset_launch_counts()
            fn(params, x)
            torch.cuda.synchronize()
            launches[model] = K.launch_counts()
            log(f"    {launches[model]}")
            if launches[model] != EXPECTED_LAUNCHES[model]:
                raise AssertionError(f"launches {launches[model]} != "
                                     f"{EXPECTED_LAUNCHES[model]}")
            if model == "bert_base_s128":
                run_profiled_bert_b1()

    rng = np.random.default_rng(7)
    served_batches = {}
    latency = {}
    served = {}
    for model, count in SERVED.items():
        fn, params, _ = models[model]
        log(f"[5] {model} InferenceServer: {count} single-sample requests")
        samples = rng.integers(0, 256, (count,) + input_shape(model),
                               dtype=np.int64).astype(np.uint8)
        answers, served_batches[model], latency[model] = serve_and_check(
            torch, model, fn, params, samples, EXPECTED_LAUNCHES[model])
        served[model] = (samples, answers)

    log("[6] lifecycle operators on the card against their CPU runs")
    per_shape = {}
    launches["ops"], per_shape["ops b128"], ops_graph, deconv_rows = \
        check_ops(torch, max_err)

    imported, imported_launches, imported_served, imported_latency = \
        check_imported(torch)
    models.update(imported)
    launches.update(imported_launches)
    served_batches.update(imported_served)
    latency.update(imported_latency)

    log("[8] timings (CUDA events, median of repeats)")
    # The float32 library products must sum the integers exactly.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # What the card takes a launch for next to no work: a one-element
    # zero_(), timed as every kernel is.
    one = torch.zeros(1, dtype=torch.uint8, device="cuda")
    floor_ms = time_ms(one.zero_, torch)
    log(f"    launch floor (one-element zero_()): {floor_ms:.4f} ms")
    forward = {}
    with torch.inference_mode():
        for model, (fn, params, x) in models.items():
            unit = "seq" if model == "bert_base_s128" else "img"
            ips1, ms1 = forward_ips(torch, fn, params, x, iters=20)
            xb = torch.from_numpy(rng.integers(
                0, 256, (128,) + input_shape(model),
                dtype=np.int64).astype(np.uint8)).cuda()
            ips128, ms128 = forward_ips(torch, fn, params, xb, iters=3)
            forward[model] = {"unit": unit, "b1_ms": ms1, "b1_per_s": ips1,
                              "b128_ms": ms128, "b128_per_s": ips128}
            log(f"    {model} forward batch 1: {ms1:.3f} ms, {ips1:.1f} "
                f"{unit}/s")
            log(f"    {model} forward batch 128: {ms128:.3f} ms, "
                f"{ips128:.1f} {unit}/s")
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
                    log(f"    {model} b{batch:<3d} {name:11s} "
                        f"{s['shapes']:3d} launches: {s['ms']:.4f} ms, "
                        f"bound {s['bound_ms']:.4f} ms ({s['bound_by']}), "
                        f"plain {s['plain_ms']:.4f} ms, library {lib} ms")
                moved = [r for r in rows if r["kernel"] in DATA_MOVEMENT]
                if moved:
                    moved_ms = sum(r["ms"] for r in moved)
                    fwd_ms = forward[model][f"b{batch}_ms"]
                    forward[model][f"b{batch}_data_movement_ms"] = moved_ms
                    log(f"    {model} b{batch:<3d} data movement outside the "
                        f"kernels ({len(moved)} copies): {moved_ms:.4f} ms, "
                        f"{moved_ms / fwd_ms:.1%} of the forward")
                for r in rows:
                    if r["kernel"] == "q8gavgpool":
                        bound = r["bytes"] / HBM_BYTES_PER_S * 1e3
                        log(f"    {model} b{batch} q8gavgpool {r['label']}: "
                            f"{r['ms']:.4f} ms, bound {bound:.5f} ms "
                            f"({bound / r['ms']:.0%}), launch floor "
                            f"{floor_ms:.4f} ms")
                    if "old_route_ms" in r:
                        log(f"    {model} b{batch} stem {r['label']}: "
                            f"q8stem {r['ms']:.4f} ms, old route im2col + "
                            f"q8gemm {r['old_route_ms']:.4f} ms")
            del xb
            torch.cuda.empty_cache()

    log("[9] captured forwards (CUDA graphs, ops.base.jit_forward)")
    log(f"    initialize(): {initialize()}")
    check_captured(torch, models, per_shape, forward, rng)
    (forward["mimo_v2_flash"], launches["mimo_v2_flash"],
     per_shape["mimo_v2_flash b1"]) = check_mimo(torch, rng, max_err)
    runtime_spans = check_runtime_spans(torch, models, rng)
    call = runtime_spans["runtime.call"]
    log("[9] mobilenet_v2 b128 jit_forward under profiling.trace(): each "
        "call a qnnpack::runtime.call range with its three children after "
        "its runtime.key, each "
        "cudaGraphLaunch inside runtime.replay before its kernels; host "
        f"{call['us']:.1f} us a call (profiler on; "
        "chiprun_out/runtime_spans/trace.json)")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    check_two_graphs(torch, max_err, lambda *shape: rng.integers(
        0, 256, shape, dtype=np.int64).astype(np.uint8), sms)
    timing = check_measure_loop(torch, models, per_shape, rng)
    for model, (samples, answers) in served.items():
        fn, params, _ = models[model]
        log(f"[9] {model} InferenceServer.warmup(), then phase 5's "
            f"{len(samples)} requests")
        again, _, _ = serve_and_check(torch, model, fn, params, samples,
                                      EXPECTED_LAUNCHES[model], warm=True)
        if any(not np.array_equal(a, b) for a, b in zip(again, answers)):
            raise AssertionError(f"{model}: warm server's answers != "
                                 "phase 5's")
        log("    the same answers as phase 5")
    if HealthMonitor().probe_once() is not True:
        raise AssertionError("HealthMonitor probe on the card failed")
    log(f"[9] HealthMonitor.probe_once() on {torch.cuda.device_count()} "
        "card(s): True")

    log("[10] the parallel layer: partial instances, q8requant, shard "
        "arithmetic, a one-rank NCCL mesh")
    launches["parallel"], parallel_rows, parallel_forward = check_parallel(
        torch, max_err, models, rng)

    b128 = [r for key, rows in per_shape.items() if key.endswith("b128")
            and key.split()[0] not in IMPORTED for r in rows]
    kernels_line = []
    for name in K.KERNELS:
        s = parallel_rows.get(name)
        if s is None:
            s = summarize(b128, name)
            if not s["shapes"]:
                s = summarize(per_shape["mimo_v2_flash b1"], name)
            if not s["shapes"]:
                # Checked in phase 2 but on no timed path of this run.
                s = dict(s, ms=None, plain_ms=None, bound_ms=None,
                         bound_by=None)
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
        nvcc_seconds=nvcc_seconds, ptxas=ptxas, runtime_spans=runtime_spans,
        launch_floor_ms=floor_ms, forward=forward, timing=timing,
        ops_graph=ops_graph, row_sums=row_sum_timing,
        parallel=dict(rows=parallel_rows, forward=parallel_forward),
        deconv_ops=deconv_rows,
        launches_per_forward=launches,
        served_batches=served_batches, served_p50_ms=latency,
        kernels=kernels_line, per_shape=per_shape,
        mimo_attention=MIMO_ATTENTION), indent=1))
    log("    per-shape times: chiprun_out/chip_smoke.json "
        "(kernel ms in the line below are summed over one batch-128 "
        "forward of each path; u8clamp's are the lifecycle phase's, and "
        "those of the kernels only MiMo-V2-Flash runs its b1 forward's)")
    print(json.dumps({"kernels": kernels_line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(profile_bert_b1() if sys.argv[1:] == [PROFILE_FLAG] else main())
