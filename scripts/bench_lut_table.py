#!/usr/bin/env python3
"""Time softargmax's two row kernels (qnnpack_tpu_torch) at BERT-base
s128's batch-128 score shape (196,608 rows of 128 bytes) and at the
lifecycle SoftArgMax's 128 x 1000, on one CUDA GPU, and u8lut32norm's
1 KB shared table against a copy of the table for each lane of a warp.

    python3 scripts/bench_lut_table.py

Builds csrc/u8rmax.cu and csrc/u8lut32norm.cu as shipped, and a variant of
u8lut32norm.cu with its table spread (SPREAD_TABLE below: 32 KB a block,
entry i of lane l at 32 i + l so that no two lanes share a bank, 256-thread
blocks, as many blocks as are resident so that each fills its table once),
written to the build directory.  Every build's output is held equal to the
plain version.  Prints the card (nvidia-smi name and power limit), each
build's registers from ptxas, and one line per kernel and shape: ms (CUDA
events, median of windows, as chip_smoke.time_ms; the two tables in turns,
1 KB, spread, spread, 1 KB) and the bound (bytes / 3.35 TB/s), with a
device-to-device torch copy of the input (y.copy_(x)) as the yardstick of
the bytes u8lut32norm moves.  Writes the rows to
chiprun_out/bench_lut_table.json.  Needs a GPU and nvcc; exits non-zero
without them.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SHAPES = [("bert b128 scores", 196608, 128, 0.05),
          ("SoftArgMax 128x1000", 128, 1000, 0.01)]

# (shipped text, variant text): each must occur once in u8lut32norm.cu.
SPREAD_TABLE = [
    ("constexpr int kThreads = 64;", "constexpr int kThreads = 256;"),
    ("__shared__ __align__(16) uint32_t table[256];",
     "__shared__ __align__(16) uint32_t table[256 * 32];"),
    ("for (int i = threadIdx.x; i < 256; i += kThreads) "
     "table[i] = __ldg(lut + i);",
     "for (int i = threadIdx.x; i < 256 * 8; i += kThreads) {\n"
     "    const uint32_t v = __ldg(lut + i / 8);\n"
     "    reinterpret_cast<uint4*>(table)[i] = make_uint4(v, v, v, v);\n"
     "  }"),
    ("const uint32_t* t = table;",
     "const uint32_t* t = table + threadIdx.x % 32;"),
    ("return t[__byte_perm(w, 0, 0x4440 + b)];",
     "return t[__byte_perm(w, 0, 0x4440 + b) * 32];"),
    ("const unsigned grid = qnn_rows::grid_for(rows, kThreads / L * "
     "kRows<L>);",
     "unsigned grid = qnn_rows::grid_for(rows, kThreads / L * kRows<L>);\n"
     "    int dev = 0, sms = 0, per_sm = 0;\n"
     "    cudaGetDevice(&dev);\n"
     "    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);\n"
     "    cudaOccupancyMaxActiveBlocksPerMultiprocessor(\n"
     "        &per_sm, u8lut32norm_kernel<V, L>, kThreads, 0);\n"
     "    if (grid > unsigned(sms * per_sm)) grid = unsigned(sms * per_sm);"),
]


def spread_source(shipped: str) -> str:
    for old, new in SPREAD_TABLE:
        if shipped.count(old) != 1:
            raise RuntimeError(f"u8lut32norm.cu no longer holds {old!r} once")
        shipped = shipped.replace(old, new)
    return shipped


def build(sources, out):
    """nvcc `sources` (with csrc/ on the include path) into the shared
    library `out`; returns ptxas's lines."""
    from qnnpack_tpu_torch.kernels import _build
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
           str(_build.CSRC), "-o", str(out), *map(str, sources)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}")
    return [ln for ln in proc.stdout.splitlines() if "registers" in ln]


def load(path):
    from qnnpack_tpu_torch.kernels import _build
    lib = ctypes.CDLL(str(path))
    for name in ("qnn_u8rmax", "qnn_u8lut32norm"):
        if hasattr(lib, name):
            getattr(lib, name).argtypes = _build.SIGNATURES[name]
            getattr(lib, name).restype = ctypes.c_int
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench_lut_table: no CUDA GPU available", file=sys.stderr)
        return 2
    from chip_smoke import card_peaks, time_ms
    from qnnpack_tpu_torch.kernels import _build

    from qnnpack_tpu_torch.kernels.vpu_ops import (row_instance,
                                                   u8lut32norm_plain,
                                                   u8rmax_plain)
    from qnnpack_tpu_torch.nn.elementwise import (build_softargmax_lut,
                                                  lut32_tensor)
    HBM_BYTES_PER_S, _ = card_peaks()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)

    csrc = _build.CSRC
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=_build.BUILD_DIR))
    spread_cu = tmp / "u8lut32norm_spread.cu"
    spread_cu.write_text(spread_source((csrc / "u8lut32norm.cu").read_text()))
    ptxas = {"1 KB table": build([csrc / "u8rmax.cu", csrc / "u8lut32norm.cu"],
                                 tmp / "shipped.so"),
             "spread table": build([spread_cu], tmp / "spread.so")}
    libs = {"1 KB table": load(tmp / "shipped.so"),
            "spread table": load(tmp / "spread.so")}
    for name, lines in ptxas.items():
        for ln in lines:
            print(f"  ptxas [{name}] {ln.strip()}", flush=True)

    rng = np.random.default_rng(7)
    cuda = torch.device("cuda")
    rows_out = []

    def record(kernel, build_name, label, inst, ms, nbytes):
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        rows_out.append(dict(kernel=kernel, build=build_name, shape=label,
                             instance=inst, ms=ms, bound_ms=bound))
        print(f"  {kernel:11s} [{build_name:12s}] {label:22s} {ms:.4f} ms, "
              f"bound {bound:.4f} ms ({bound / ms:.0%})", flush=True)

    for label, r, n, scale in SHAPES:
        x_cpu = torch.from_numpy(rng.integers(0, 256, (r, n), dtype=np.int64)
                                 .astype(np.uint8))
        x = x_cpu.to(cuda)
        lut = lut32_tensor(build_softargmax_lut(scale, n), cuda)
        want_max = u8rmax_plain(x_cpu)
        want = u8lut32norm_plain(x_cpu, want_max, lut.cpu())
        rmax = want_max.to(cuda)
        ymax = torch.empty((r,), dtype=torch.uint8, device=cuda)
        y = torch.empty_like(x)
        stream = torch.cuda.current_stream().cuda_stream
        inst = row_instance(n, x.data_ptr(), y.data_ptr())

        def checked(fn, code_name):
            def call():
                code = fn()
                if code:
                    raise RuntimeError(f"{code_name}: CUDA error {code}")
            return call

        # The yardstick of the bytes alone: a device-to-device copy of x.
        record("copy_", "torch", label, None,
               time_ms(lambda: y.copy_(x), torch), 2 * r * n)
        lib = libs["1 KB table"]
        rmax_call = checked(lambda: lib.qnn_u8rmax(
            0, x.data_ptr(), ymax.data_ptr(), r, n, *inst, stream),
            "qnn_u8rmax")
        rmax_call()
        torch.cuda.synchronize()
        if not torch.equal(ymax.cpu(), want_max):
            raise AssertionError(f"u8rmax {label}: kernel != plain")
        record("u8rmax", "shipped", label, list(inst),
               time_ms(rmax_call, torch), r * n + r)
        for build_name in ("1 KB table", "spread table", "spread table",
                           "1 KB table"):
            norm_call = checked(
                lambda lib=libs[build_name]: lib.qnn_u8lut32norm(
                    0, x.data_ptr(), rmax.data_ptr(), lut.data_ptr(),
                    y.data_ptr(), r, n, *inst, stream), "qnn_u8lut32norm")
            y.zero_()
            norm_call()
            torch.cuda.synchronize()
            if not torch.equal(y.cpu(), want):
                raise AssertionError(f"u8lut32norm [{build_name}] {label}: "
                                     f"kernel != plain")
            record("u8lut32norm", build_name, label, list(inst),
                   time_ms(norm_call, torch), 2 * r * n + r + 4 * 256)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "bench_lut_table.json").write_text(json.dumps(
        dict(card=card.strip(), ptxas=ptxas, rows=rows_out), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
