#!/usr/bin/env python3
"""Time the pooling kernels of qnnpack_tpu_torch (u8maxpool, q8avgpool,
q8gavgpool) at the main paths' shapes on one CUDA GPU, beside variants of
their design and, optionally, an older tree's kernels.

    python3 scripts/bench_pool.py [--parent DIR]

Shapes: ResNet-18's and ShuffleNet v1 g3's pool1 (3x3 stride 2, padding
(0,1) on 112x112x64 and 112x112x24), ShuffleNet's three shortcut avgpools
(3x3 stride 2 on 56x56x24, 28x28x240, 14x14x480) and the global average
pools of MobileNetV2, ResNet-18 and ShuffleNet (49 rows of 1280, 512 and
960 channels), at batch 128 and at batch 1.
Builds, each from the sources of the checkout:
  - "shipped": csrc/u8maxpool.cu, csrc/q8avgpool.cu and csrc/q8gavgpool.cu
    as they are (2 outputs a thread in the 3x3 stride-2 instance);
  - the variants of TILE_VARIANTS below, each the same sources with a text
    edit of a copy of pool_tile.cuh in the build directory: 4 outputs a
    thread (kOutputs = 4), blocks of up to 256 threads (kThreads = 256,
    which gives a block 2 output rows at ResNet-18's pool1 and 3 at
    ShuffleNet's), and one output row a block (more, smaller blocks where
    a row takes few threads);
  - "staged rows" (u8maxpool only): STAGED_SOURCE below, a kernel that
    copies a block's three input rows into shared memory before any thread
    reads a window, as the alternative to re-reading shared columns through
    L1;
  - the q8gavgpool variants of GAVG_VARIANTS below, text edits of a copy
    of q8gavgpool.cu: at most 16 channel vectors a block (kLanes = 16:
    twice the blocks, each with twice the row groups), blocks of at
    most 128 threads (kThreads = 128: 4 row groups of 32 vectors), and the
    wide instance where the shipped one takes halves ("gavg wide only":
    32-bit sums at 49 rows, the halves flushed once);
  - "parent" with --parent DIR: DIR/qnnpack_tpu_torch/kernels/csrc/
    u8maxpool.cu, q8avgpool.cu and q8gavgpool.cu with the C signatures of
    DIR/qnnpack_tpu_torch/kernels/_build.py (an entry of the shipped
    signature takes the shipped instance; a shorter one, as before the
    pools had instances, none), e.g. `git archive <commit>
    qnnpack_tpu_torch/kernels | tar -x -C DIR`.
Every build's output is held equal to the plain version.  Prints the card
(nvidia-smi name and power limit), ptxas's registers and spills, and one
line per kernel, shape and build: ms (CUDA events, median of windows, as
chip_smoke.time_ms; the builds in turns, forward then backward) beside the
bound, bytes / 3.35 TB/s; beside each q8gavgpool shape, the launch floor,
a one-element zero_() timed in the same turns.  Writes the rows to
chiprun_out/bench_pool.json.
Needs a GPU and nvcc; exits non-zero without them.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

S2 = ((0, 1), (0, 1))
# (label, kernel, input shape at batch 1); every one a 3x3 stride-2
# window, pad (0,1); each runs at batch 128 and at batch 1.
POOLS = [
    ("resnet18 pool1", "u8maxpool", (112, 112, 64)),
    ("shufflenet pool1", "u8maxpool", (112, 112, 24)),
    ("shufflenet st0u0", "q8avgpool", (56, 56, 24)),
    ("shufflenet st1u0", "q8avgpool", (28, 28, 240)),
    ("shufflenet st2u0", "q8avgpool", (14, 14, 480)),
]
SHAPES = [(f"{label} b{bsz}", kernel, (bsz, *hwc)) for bsz in (128, 1)
          for label, kernel, hwc in POOLS]
# (label, [B, S, C]) of the models' global average pools.
GAVG_SHAPES = [(f"{model} b{bsz}", (bsz, 49, c)) for bsz in (128, 1)
               for model, c in (("mobilenet_v2", 1280), ("resnet18", 512),
                                ("shufflenet", 960))]

# Variant name -> (shipped text, variant text) pairs, each of which must
# occur once in pool_tile.cuh.
TILE_VARIANTS = {
    "4 outputs": [("constexpr int kOutputs = 2;",
                   "constexpr int kOutputs = 4;")],
    "256 threads": [("constexpr int kThreads = 128;",
                     "constexpr int kThreads = 256;")],
    "1 row a block": [("int bz = kThreads / (bx * by);", "int bz = 1;")],
}

# q8gavgpool variant name -> (shipped text, variant text) pairs, each of
# which must occur once in q8gavgpool.cu.
GAVG_VARIANTS = {
    "gavg 16 lanes": [("constexpr int kLanes = 32;",
                       "constexpr int kLanes = 16;")],
    "gavg 128 threads": [("constexpr int kThreads = 256;",
                          "constexpr int kThreads = 128;")],
    "gavg wide only": [("case kHalves: return f.run<V, kHalves>();",
                        "case kHalves: return f.run<V, kWide>();")],
}

# u8maxpool's 3x3 stride-2 window with the block's three input rows staged
# in shared memory: a block is one output row of one image (grid: Ho x B),
# its threads the shipped instance's (channel vectors x column tiles of 2
# outputs); each thread loads its share of the three rows (16 bytes at a
# time, up to 4 a row in flight), the block syncs, and each thread reads
# its windows from shared memory.  Needs W * C % 16 == 0.
STAGED_SOURCE = r"""
#include <cuda_runtime.h>

#include <cstdint>

#include "u8rows.cuh"

namespace {

using qnn_rows::Vec;
constexpr int kN = 2;

template <int V>
__global__ void __launch_bounds__(128)
    staged_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
                  int height, int width, int channels, int out_height,
                  int out_width, int pad_top, int pad_left, uint32_t lo4,
                  uint32_t hi4) {
  extern __shared__ __align__(16) uint8_t rows[];
  const int oy = blockIdx.x, b = blockIdx.y;
  const int row_bytes = width * channels;
  const int row16 = row_bytes / 16;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int iy0 = oy * 2 - pad_top;
  const uint8_t* image = x + static_cast<int64_t>(b) * height * row_bytes;
  for (int base = 0; base < row16; base += 4 * nthreads) {
    uint4 v[3][4];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const bool row_in =
          static_cast<unsigned>(iy0 + r) < static_cast<unsigned>(height);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = base + k * nthreads + tid;
        v[r][k] = make_uint4(0, 0, 0, 0);
        if (row_in && i < row16) {
          v[r][k] = __ldg(reinterpret_cast<const uint4*>(
              image + static_cast<int64_t>(iy0 + r) * row_bytes) + i);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = base + k * nthreads + tid;
        if (i < row16) {
          reinterpret_cast<uint4*>(rows + r * row_bytes)[i] = v[r][k];
        }
      }
    }
  }
  __syncthreads();
  const int c = threadIdx.x * V;
  const int tiles = (out_width + kN - 1) / kN;
  for (int tile = threadIdx.y; tile < tiles; tile += blockDim.y) {
    const int ox0 = tile * kN;
    const int ix0 = ox0 * 2 - pad_left;
    constexpr int kW = Vec<V>::kWords;
    uint32_t col[2 * kN + 1][kW];
#pragma unroll
    for (int j = 0; j < 2 * kN + 1; ++j) {
      const int ix = ix0 + j;
      const bool in = static_cast<unsigned>(ix) < static_cast<unsigned>(width);
#pragma unroll
      for (int i = 0; i < kW; ++i) col[j][i] = 0;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        if (in) {
          const uint32_t* p = reinterpret_cast<const uint32_t*>(
              rows + r * row_bytes + ix * channels + c);
#pragma unroll
          for (int i = 0; i < kW; ++i) col[j][i] = __vmaxu4(col[j][i], p[i]);
        }
      }
    }
#pragma unroll
    for (int o = 0; o < kN; ++o) {
      if (ox0 + o < out_width) {
        uint32_t m[kW];
#pragma unroll
        for (int i = 0; i < kW; ++i) {
          m[i] = __vmaxu4(__vmaxu4(col[2 * o][i], col[2 * o + 1][i]),
                          col[2 * o + 2][i]);
          m[i] = __vminu4(__vmaxu4(m[i], lo4), hi4);
        }
        Vec<V>::store(y + ((static_cast<int64_t>(b) * out_height + oy) *
                               out_width + ox0 + o) * channels + c, m);
      }
    }
  }
}

}  // namespace

extern "C" int qnn_u8maxpool_staged(int device, const void* x, void* y,
                                    int batch, int height, int width,
                                    int channels, int out_height,
                                    int out_width, int pad_top, int pad_left,
                                    int vec, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((width * channels) % 16 != 0 || channels % vec != 0 ||
      (vec != 16 && vec != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vecs = channels / vec, tiles = (out_width + kN - 1) / kN;
  const int by = tiles < 128 / vecs ? tiles : 128 / vecs;
  const dim3 grid(out_height, batch), block(vecs, by);
  const int smem = 3 * width * channels;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto x8 = static_cast<const uint8_t*>(x);
  const auto y8 = static_cast<uint8_t*>(y);
  const uint32_t lo4 = 0, hi4 = 0xFFFFFFFFu;
  if (vec == 16) {
    staged_kernel<16><<<grid, block, smem, s>>>(x8, y8, height, width,
        channels, out_height, out_width, pad_top, pad_left, lo4, hi4);
  } else {
    staged_kernel<8><<<grid, block, smem, s>>>(x8, y8, height, width,
        channels, out_height, out_width, pad_top, pad_left, lo4, hi4);
  }
  return static_cast<int>(cudaGetLastError());
}
"""

_P, _I = ctypes.c_void_p, ctypes.c_int
POOL_ENTRIES = ("qnn_u8maxpool", "qnn_q8avgpool", "qnn_q8gavgpool")
STAGED_SIGNATURE = [_I, _P, _P] + [_I] * 9 + [_P]


def build(sources, out, include):
    """nvcc `sources` (with `include` on the include path) into the shared
    library `out`; returns ptxas's register and spill lines."""
    from qnnpack_tpu_torch.kernels import _build
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
           str(include), "-o", str(out), *map(str, sources)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}")
    return [ln.strip() for ln in proc.stdout.splitlines()
            if "Compiling entry" in ln or "registers" in ln or "spill" in ln]


def load(path, signatures):
    lib = ctypes.CDLL(str(path))
    for name, argtypes in signatures.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def parent_signatures(root):
    """The pool entries' signatures of the tree at `root`, from its
    kernels/_build.py (which imports nothing outside the standard
    library)."""
    spec = importlib.util.spec_from_file_location(
        "parent_build", root / "qnnpack_tpu_torch" / "kernels" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {name: mod.SIGNATURES[name] for name in POOL_ENTRIES}


def edited(text, edits, what):
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{what} no longer holds {old!r} once")
        text = text.replace(old, new)
    return text


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="root of an older tree whose pool kernels to time "
                         "beside these")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_pool: no CUDA GPU available", file=sys.stderr)
        return 2
    from chip_smoke import card_peaks, time_ms
    from qnnpack_tpu_torch.kernels import _build

    from qnnpack_tpu_torch.kernels.pool import (GAVG_SUMS, WINDOWS,
                                                gavgpool_instance,
                                                pool_instance,
                                                q8avgpool_plain,
                                                q8gavgpool_plain,
                                                u8maxpool_plain)
    from qnnpack_tpu_torch.quant.params import compute_avgpool_quant_params
    HBM_BYTES_PER_S, _ = card_peaks()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)

    csrc = _build.CSRC
    pools = ("u8maxpool.cu", "q8avgpool.cu")
    shipped_sig = {n: _build.SIGNATURES[n]
                   for n in ("qnn_u8maxpool", "qnn_q8avgpool")}
    gavg_sig = {"qnn_q8gavgpool": _build.SIGNATURES["qnn_q8gavgpool"]}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=_build.BUILD_DIR))
    staged_cu = tmp / "u8maxpool_staged.cu"
    staged_cu.write_text(STAGED_SOURCE)
    builds = {"shipped": ([csrc / n for n in pools + ("q8gavgpool.cu",)],
                          {**shipped_sig, **gavg_sig})}
    for i, (variant, edits) in enumerate(TILE_VARIANTS.items()):
        vdir = tmp / f"variant{i}"
        vdir.mkdir()
        for name in pools:
            shutil.copy(csrc / name, vdir / name)
        (vdir / "pool_tile.cuh").write_text(edited(
            (csrc / "pool_tile.cuh").read_text(), edits, "pool_tile.cuh"))
        builds[variant] = ([vdir / n for n in pools], shipped_sig)
    for i, (variant, edits) in enumerate(GAVG_VARIANTS.items()):
        source = tmp / f"q8gavgpool_variant{i}.cu"
        source.write_text(edited((csrc / "q8gavgpool.cu").read_text(),
                                 edits, "q8gavgpool.cu"))
        builds[variant] = ([source], gavg_sig)
    builds["staged rows"] = ([staged_cu],
                             {"qnn_u8maxpool_staged": STAGED_SIGNATURE})
    if args.parent is not None:
        parent_csrc = (args.parent / "qnnpack_tpu_torch" / "kernels"
                       / "csrc")
        builds["parent"] = ([parent_csrc / n
                             for n in pools + ("q8gavgpool.cu",)],
                            parent_signatures(args.parent))
    libs, ptxas = {}, {}
    # Whether each build's pool entries take an instance.
    instanced = {name: {e: len(sig.get(e, ())) == len(_build.SIGNATURES[e])
                        for e in POOL_ENTRIES}
                 for name, (_, sig) in builds.items()}
    for name, (sources, sig) in builds.items():
        out = tmp / f"build{len(libs)}.so"
        ptxas[name] = build(sources, out, csrc)
        libs[name] = load(out, sig)
        for ln in ptxas[name]:
            print(f"  ptxas [{name}] {ln}", flush=True)

    rng = np.random.default_rng(9)
    cuda = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    order = list(libs)
    rows_out = []
    for label, kernel, shape in SHAPES:
        bsz, h, w, c = shape
        x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.int64)
                             .astype(np.uint8)).to(cuda)
        ho, wo = _build.out_dims(h, w, 3, 3, (2, 2), S2)
        y = torch.empty((bsz, ho, wo, c), dtype=torch.uint8, device=cuda)
        vec, window = pool_instance(c, (3, 3), (2, 2), (1, 1), x.data_ptr(),
                                    y.data_ptr(), sums=kernel == "q8avgpool")
        geometry = [0, x.data_ptr(), y.data_ptr(), bsz, h, w, c, ho, wo, 3,
                    3, 2, 2, 0, 0]
        if kernel == "u8maxpool":
            want = u8maxpool_plain(x, (3, 3), (2, 2), S2)
            tail = [1, 1, 0, 255]
        else:
            qp = compute_avgpool_quant_params(-128 * 9, 1 / 9, 128,
                                              input_zero_point=128)
            want = q8avgpool_plain(x, qp, (3, 3), (2, 2), S2)
            tail = [qp.input_zero_point, qp.bias, qp.multiplier, qp.shift,
                    qp.output_zero_point, qp.output_min_less_zero_point,
                    qp.output_max_less_zero_point]
        calls = {}
        for name, lib in libs.items():
            if not hasattr(lib, f"qnn_{kernel}") and name != "staged rows":
                continue
            if name == "staged rows":
                if kernel != "u8maxpool":
                    continue
                fn, call_args = lib.qnn_u8maxpool_staged, [
                    0, x.data_ptr(), y.data_ptr(), bsz, h, w, c, ho, wo, 0,
                    0, vec, stream]
            elif not instanced[name][f"qnn_{kernel}"]:
                fn = getattr(lib, f"qnn_{kernel}")
                call_args = geometry + tail + [stream]
            else:
                fn = getattr(lib, f"qnn_{kernel}")
                call_args = geometry + tail + [vec, WINDOWS[window], stream]

            def call(fn=fn, call_args=call_args, name=name):
                code = fn(*call_args)
                if code:
                    raise RuntimeError(f"{kernel} [{name}]: CUDA error {code}")
            y.zero_()
            call()
            torch.cuda.synchronize()
            if not torch.equal(y, want):
                raise AssertionError(f"{kernel} [{name}] {label}: kernel != "
                                     f"plain")
            calls[name] = call
        nbytes = x.numel() + y.numel()
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        times = {name: [] for name in calls}
        for name in [n for n in order if n in calls] + \
                [n for n in reversed(order) if n in calls]:
            times[name].append(time_ms(calls[name], torch))
        for name, ts in times.items():
            ms = statistics.median(ts)
            rows_out.append(dict(kernel=kernel, shape=label,
                                 input=list(shape), build=name,
                                 instance=[vec, window], ms=ms, runs=ts,
                                 bound_ms=bound))
            print(f"  {kernel:9s} {label:22s} [{name:14s}] {ms:.4f} ms "
                  f"({', '.join(f'{t:.4f}' for t in ts)}), bound "
                  f"{bound:.4f} ms ({bound / ms:.0%})", flush=True)
        del x, y, want
        torch.cuda.empty_cache()
    one = torch.zeros(1, dtype=torch.uint8, device=cuda)
    for label, shape in GAVG_SHAPES:
        bsz, s, c = shape
        x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.int64)
                             .astype(np.uint8)).to(cuda)
        y = torch.empty((bsz, c), dtype=torch.uint8, device=cuda)
        qp = compute_avgpool_quant_params(-128 * s, 1 / s, 128,
                                          input_zero_point=128)
        want = q8gavgpool_plain(x, qp)
        vec, sums = gavgpool_instance(c, s, x.data_ptr(), y.data_ptr())
        head = [0, x.data_ptr(), y.data_ptr(), bsz, s, c, qp.bias,
                qp.multiplier, qp.shift, qp.output_zero_point,
                qp.output_min_less_zero_point,
                qp.output_max_less_zero_point]
        calls = {"launch floor": one.zero_}
        for name, lib in libs.items():
            if not hasattr(lib, "qnn_q8gavgpool"):
                continue
            tail = ([vec, GAVG_SUMS[sums], stream]
                    if instanced[name]["qnn_q8gavgpool"] else [stream])

            def call(fn=lib.qnn_q8gavgpool, call_args=head + tail,
                     name=name):
                code = fn(*call_args)
                if code:
                    raise RuntimeError(f"q8gavgpool [{name}]: CUDA error "
                                       f"{code}")
            y.zero_()
            call()
            torch.cuda.synchronize()
            if not torch.equal(y, want):
                raise AssertionError(f"q8gavgpool [{name}] {label}: kernel "
                                     f"!= plain")
            calls[name] = call
        bound = (x.numel() + y.numel()) / HBM_BYTES_PER_S * 1e3
        times = {name: [] for name in calls}
        for name in list(calls) + list(reversed(calls)):
            times[name].append(time_ms(calls[name], torch))
        floor = statistics.median(times["launch floor"])
        for name, ts in times.items():
            ms = statistics.median(ts)
            rows_out.append(dict(kernel="q8gavgpool", shape=label,
                                 input=list(shape), build=name,
                                 instance=[vec, sums], ms=ms, runs=ts,
                                 bound_ms=bound, floor_ms=floor))
            print(f"  q8gavgpool {label:22s} [{name:16s}] {ms:.4f} ms "
                  f"({', '.join(f'{t:.4f}' for t in ts)}), bound "
                  f"{bound:.5f} ms ({bound / ms:.0%}), launch floor "
                  f"{floor:.4f} ms", flush=True)
        del x, y, want
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "bench_pool.json").write_text(json.dumps(
        dict(card=card.strip(), ptxas=ptxas, rows=rows_out), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
