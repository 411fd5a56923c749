#!/usr/bin/env python3
"""Time the fused masked attention (csrc/q8attn_masked.cu) alone at
MiMo-V2-Flash's b4 x 8,192 full and window layers on one CUDA GPU, beside
the same kernel with its sweeps' arithmetic stripped.

    python3 scripts/bench_fused_attention.py [--parent DIR]

Builds q8attn_masked.cu as shipped and a variant without the three sweeps'
arithmetic (STRIP_SWEEPS below: text edits of the shipped source, written
to the build directory; its output is wrong and never compared), each into
a library of its own with ptxas's registers and spills of both instances.
With --parent, also another tree's q8attn_masked.cu and its stripped
variant (DIR holds that tree's csrc/, e.g. unpacked with `git archive
<commit> qnnpack_tpu_torch/kernels/csrc | tar -x -C _archive/parent`),
held byte-equal to the shipped kernel (chip_smoke.py holds the shipped
kernel to its plain version at these shapes).  Times
the builds in turns (CUDA events, chip_smoke.time_ms), then prints, for
each layer, the hidden-arithmetic share

    (t_products + A - t_full) / A

with t_full, t_products the shipped kernel's times with and without the
arithmetic and A the parent's arithmetic time (its two times' difference;
without --parent, LOCKSTEP_ARITH_MS).  Writes the rows to
chiprun_out/bench_fused_attention.json.  Needs a GPU and nvcc; exits
non-zero without them.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (shipped text, variant text): each must occur once in q8attn_masked.cu.
STRIP_SWEEPS = [
    (f"sweep_tile<{k}, kBand>(edge, acc, rw, pa, dist, p);",
     "(void)edge; (void)dist;") for k in range(3)]

# The arithmetic time of a layer alone at b4 x 8,192 with the four
# warpgroups in lockstep: the kernel's time less its time without the
# sweeps' arithmetic (full 27.07 - 13.89 ms, window 2.81 - 1.37 ms; H100
# 80GB HBM3, 700 W).
LOCKSTEP_ARITH_MS = {"full": 27.07 - 13.89, "window": 2.81 - 1.37}


def edited(shipped: str, edits) -> str:
    for old, new in edits:
        if shipped.count(old) != 1:
            raise RuntimeError(f"q8attn_masked.cu no longer holds {old!r} "
                               f"once")
        shipped = shipped.replace(old, new)
    return shipped


def stripped_source(shipped: str) -> str:
    """q8attn_masked.cu without its sweeps' arithmetic: the same copies,
    barriers and products, no score read after its product."""
    return edited(shipped, STRIP_SWEEPS)


def ptxas_instances(log: str) -> dict:
    """ptxas's registers and spill bytes of q8bmm_masked_kernel's two
    instances ("causal", "band") in nvcc's -Xptxas -v output `log`."""
    out = {}
    kind = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\S+?)'?(?: for|$)", line.strip())
        if m:
            name = m.group(1)
            kind = None
            if "q8bmm_masked_kernel" in name:
                kind = "band" if "ILb1E" in name else "causal"
            continue
        if kind is None:
            continue
        row = out.setdefault(kind, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            row["spill_stores"] = int(m.group(1))
            row["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            row["registers"] = int(m.group(1))
    return out


def build_variants(sources: dict, build_dir: Path) -> dict:
    """Each of `sources` ({name: (text of a q8attn_masked.cu, a directory
    searched for its headers first, or None)}) built into a library of its
    own in `build_dir`, all nvcc processes at once; returns {name:
    (ctypes library, ptxas_instances)}."""
    from qnnpack_tpu_torch.kernels import _build
    procs = {}
    for i, (name, (text, include)) in enumerate(sources.items()):
        cu, so = build_dir / f"v{i}.cu", build_dir / f"v{i}.so"
        cu.write_text(text)
        incs = [] if include is None else ["-I", str(include)]
        procs[name] = (so, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", *incs, "-I",
             str(_build.CSRC), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.qnn_q8attn_masked.argtypes = _build.SIGNATURES[
            "qnn_q8attn_masked"]
        lib.qnn_q8attn_masked.restype = ctypes.c_int
        out[name] = (lib, ptxas_instances(log))
    return out


class _OneEntry:
    """The kernel library as kernels/_build.py:launch sees it, with
    qnn_q8attn_masked from another build."""

    def __init__(self, lib):
        self.qnn_q8attn_masked = lib.qnn_q8attn_masked

    @staticmethod
    def qnn_error_string(code):
        return f"CUDA error {code} in a q8attn_masked.cu variant".encode()


@contextlib.contextmanager
def attention_from(lib):
    """kernels/q8bmm.py:q8attn_masked_cuda launching `lib`'s kernel (a
    build_variant library) while the context is open."""
    from qnnpack_tpu_torch.kernels import _build
    saved = _build._lib
    _build._lib = _OneEntry(lib)
    try:
        yield
    finally:
        _build._lib = saved


def layer_inputs(torch, cfg, kind: str, batch: int, dev, seed: int = 22):
    """Inputs of one attention layer of MiMo-V2-Flash (`cfg`, a
    models/mimo_v2_flash.py MimoConfig) at `batch` x cfg.seq_len: q, k, v
    views of one qkv buffer as the forward lays them out, q and k on the
    spread of the block's products (bytes 100..156), v uniform, the
    scales of quantization_scales, and for the window layer random sinks.
    Returns the arguments of q8attn_masked_cuda after q, k, v."""
    from qnnpack_tpu_torch.models.mimo_v2_flash import quantization_scales
    from qnnpack_tpu_torch.nn.elementwise import (build_softargmax_lut,
                                                  lut32_tensor)
    from qnnpack_tpu_torch.nn.requant_dispatch import make_requant_params

    gen = torch.Generator(device=dev).manual_seed(seed)
    s, dq, dv, nh = cfg.seq_len, cfg.qk_dim, cfg.v_dim, cfg.heads
    nkv = cfg.kv_full if kind == "full" else cfg.kv_window
    window = 0 if kind == "full" else cfg.window
    scales = quantization_scales(cfg)
    cols = (nh + nkv) * dq
    qkv = torch.randint(0, 256, (batch, s, cols + nkv * dv), generator=gen,
                        dtype=torch.uint8, device=dev)
    qkv[..., :cols] = torch.randint(100, 157, (batch, s, cols),
                                    generator=gen, dtype=torch.uint8,
                                    device=dev)
    q = qkv[..., :nh * dq].view(batch, s, nh, dq).permute(0, 2, 1, 3)
    k = qkv[..., nh * dq:cols].view(batch, s, nkv, dq).permute(0, 2, 3, 1)
    v = qkv[..., cols:].view(batch, s, nkv, dv).permute(0, 2, 1, 3)
    sinks = (torch.randint(0, 256, (nh,), generator=gen, dtype=torch.uint8,
                           device=dev) if window else None)
    lut = lut32_tensor(build_softargmax_lut(
        scales["softmax_input_scale"], window + 1 if window else s), dev)
    ctx = scales["context_full_scale" if kind == "full"
                 else "context_window_scale"]
    return (q, k, v, 128, make_requant_params("fp32", scales["scores_scale"],
                                              128),
            lut, window, sinks, make_requant_params("fp32", ctx, 128))


def hidden_share(t_full: float, t_products: float, arith: float) -> float:
    """The share of the arithmetic time `arith` that runs under the
    products: (t_products + arith - t_full) / arith."""
    return (t_products + arith - t_full) / arith


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a directory holding another q8attn_masked.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_fused_attention: no CUDA GPU available",
              file=sys.stderr)
        return 2
    from chip_smoke import time_ms
    from qnnpack_tpu_torch.kernels import _build
    from qnnpack_tpu_torch.kernels.q8bmm import q8attn_masked_cuda
    from qnnpack_tpu_torch.models.mimo_v2_flash import MimoConfig

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    shipped = (_build.CSRC / "q8attn_masked.cu").read_text()
    sources = {"shipped": (shipped, None),
               "shipped stripped": (stripped_source(shipped), None)}
    if args.parent:
        old = (args.parent / "q8attn_masked.cu").read_text()
        sources["parent"] = (old, args.parent)
        sources["parent stripped"] = (stripped_source(old), args.parent)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=_build.BUILD_DIR))
    built = build_variants(sources, tmp)
    libs = {name: lib for name, (lib, _) in built.items()}
    ptxas = {name: regs for name, (_, regs) in built.items()}
    for name, regs in ptxas.items():
        print(f"  ptxas [{name}] {regs}", flush=True)

    cfg = MimoConfig()
    dev = torch.device("cuda")
    rows = []
    for kind in ("full", "window"):
        attn = layer_inputs(torch, cfg, kind, 4, dev)
        outs = {}
        for name, lib in libs.items():
            if "stripped" not in name:
                with attention_from(lib):
                    outs[name] = q8attn_masked_cuda(*attn)
        first = outs.pop("shipped")
        for name, y in outs.items():
            if not torch.equal(y, first):
                raise AssertionError(f"{kind}: [{name}] != [shipped]")
        del first, outs
        torch.cuda.empty_cache()
        times = {name: [] for name in libs}
        order = list(libs) + list(reversed(libs))
        for name in order:
            with attention_from(libs[name]):
                times[name].append(
                    time_ms(lambda: q8attn_masked_cuda(*attn), torch))
        for name, ts in times.items():
            print(f"  {kind} b4 [{name:16s}] "
                  + ", ".join(f"{t:.3f}" for t in ts) + " ms", flush=True)
        best = {name: min(ts) for name, ts in times.items()}
        arith = LOCKSTEP_ARITH_MS[kind]
        row = dict(layer=kind, ms=times, lockstep_arith_ms=arith,
                   hidden_share_lockstep_a=hidden_share(
                       best["shipped"], best["shipped stripped"], arith))
        if args.parent:
            a = best["parent"] - best["parent stripped"]
            row["parent_arith_ms"] = a
            row["hidden_share"] = hidden_share(
                best["shipped"], best["shipped stripped"], a)
        rows.append(row)
        print(f"  {kind} (the best of each build): " + ", ".join(
            f"{key} {val:.3f}" for key, val in row.items()
            if isinstance(val, float)), flush=True)
        del attn
        torch.cuda.empty_cache()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "bench_fused_attention.json").write_text(json.dumps(
        dict(card=card.strip(), ptxas=ptxas, rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
