"""Build and load the CUDA kernels of kernels/csrc/.

Every csrc/*.cu is compiled by its own nvcc process, all started together,
for sm_90a (Hopper); the objects are linked into one shared library with a
plain C interface, loaded with ctypes.  The library lands in
qnnpack_tpu_torch/_build/ (listed in .gitignore) under a name keyed by a
hash of the sources and flags, so a change to any source rebuilds it and an
unchanged tree reuses it.  Nothing is built when a module is imported: the
first launch builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float

# argtypes of every C entry point; each returns a cudaError_t as int.
SIGNATURES = {
    "qnn_q8gemm": [_I, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _I,
                   _I, _I, _I, _P, _P,
                   _I, _I, _I, _I, _I, _I, _F, _P, _P, _P],
    "qnn_q8dwconv": [_I, _P, _P, _P, _P, _P, _P] + [_I] * 18
                    + [_I] * 6 + [_F, _P],
    "qnn_q8vadd": [_I, _P, _P, _P, _I64] + [_I] * 7 + [_P],
    "qnn_q8gavgpool": [_I, _P, _P] + [_I] * 11 + [_P],
    "qnn_q8conv": [_I, _P, _P, _P, _P, _P] + [_I] * 19
                  + [_I, _I, _I, _P, _P] + [_I] * 6 + [_F, _P],
    "qnn_q8stem": [_I, _P, _P, _P, _P, _P] + [_I] * 14
                  + [_I] * 6 + [_F, _P],
    "qnn_u8maxpool": [_I, _P, _P] + [_I] * 18 + [_P],
    "qnn_q8avgpool": [_I, _P, _P] + [_I] * 21 + [_P],
    "qnn_q8bmm": [_I, _P, _P, _P, _P, _I64, _I64, _I, _I, _I]
                 + [_I64] * 6 + [_I] + [_I64] * 3 + [_I] * 2 + [_I] * 6
                 + [_F, _P],
    "qnn_u8clamp": [_I, _P, _P, _I64, _I, _I, _P],
    "qnn_u8rmax": [_I, _P, _P, _I64, _I, _I, _I, _P],
    "qnn_u8lut32norm": [_I, _P, _P, _P, _P, _I64, _I, _I, _I, _P],
    "qnn_q8gemm_partial": [_I, _P, _P, _P, _I64, _I, _I, _I, _I,
                           _I, _I, _I, _P, _P, _P],
    "qnn_q8conv_partial": [_I, _P, _P, _P] + [_I] * 19
                          + [_I, _I, _I, _P, _P, _P],
    "qnn_q8requant": [_I, _P, _P, _P, _P, _I64, _I] + [_I] * 6 + [_F, _P],
    "qnn_q8bmm_masked": [_I, _P, _P, _P, _I64, _I64, _I, _I, _I, _I]
                        + [_I64] * 6 + [_I] + [_I64] * 3 + [_I] * 4
                        + [_I] * 6 + [_F, _P],
    "qnn_q8attn_masked": [_I] + [_P] * 6 + [_I] * 6 + [_I64] * 12
                         + [_I, _I, _F] + [_I] * 3 + [_I] * 6 + [_F, _P],
    "qnn_u8softmax_masked": [_I, _P, _P, _P, _I64, _I, _I64, _I, _I, _P],
    "qnn_q8gemm_grouped": [_I, _P, _P, _P, _P, _P] + [_I] * 6 + [_I] * 6
                          + [_F, _P],
    "qnn_q8rope": [_I, _P, _P, _P, _I64, _I64] + [_I] * 5 + [_F, _P],
    "qnn_q8swiglu": [_I, _P, _P, _P, _I64, _I, _P] + [_I] * 5 + [_F, _P],
    "qnn_moe_route": [_I] + [_P] * 10 + [_I64] + [_I] * 8 + [_F, _P],
    "qnn_moe_combine": [_I, _P, _P, _P, _P, _I64] + [_I] * 5 + [_F, _P],
}

_lock = threading.Lock()
_lib = None
build_log = ""


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("qnnpack_tpu_torch: nvcc not found (needed to build "
                       "the CUDA kernels); put it on PATH or set CUDA_HOME")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libqnnpack_kernels_{h.hexdigest()[:16]}.so"


def build(path: Path) -> str:
    """Compile every .cu in parallel and link `path`; returns nvcc's log."""
    nvcc = find_nvcc()
    cu, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in cu]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o",
             str(obj)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for src, obj in zip(cu, objs)]
        logs, failed = [], []
        for src, proc in zip(cu, procs):
            out, _ = proc.communicate()
            logs.append(f"--- {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) + "\n"
                               + "\n".join(logs))
        tmp_so = Path(tmp) / path.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_so), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("linking the kernel library failed\n"
                               + link.stdout)
        os.replace(tmp_so, path)
    return "\n".join(logs)


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use.  The first call records the
    span library.load, with library.build inside it when nvcc runs."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    from ..utils import profiling
    with profiling.span("library.load"), _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            with profiling.span("library.build"):
                build_log = build(path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.qnn_error_string.argtypes = [ctypes.c_int]
        lib.qnn_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def launch(name: str, *args) -> None:
    """Call C entry `name`; raises if the launch reported a CUDA error."""
    lib = load_library()
    code = getattr(lib, name)(*args)
    if code != 0:
        msg = lib.qnn_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")


def stream_of(t) -> int:
    """Handle of PyTorch's current stream on `t`'s device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=256)
def _channel_scales(scales: tuple, device):
    """Per-channel scales on `device`, cached; a miss copies them from
    pageable host memory.  Never read during a CUDA-graph capture (see
    requant_args)."""
    import torch
    return torch.tensor(scales, dtype=torch.float32, device=device)


def requant_args(rparams, channels: int, device):
    """(scales tensor or None, [scheme, multiplier, shift, zero_point, qmin,
    qmax, scale]) for a requant params record - the qnn::Requant fields of
    csrc/requant.cuh.  Per-channel scales come from the params'
    device_scales where it lies on `device`, with no copy; else from
    _channel_scales.  During a capture only device_scales will do: a miss
    would copy from pageable memory, which a capture refuses, and a hit
    would leave the graph holding the address of a cached tensor it does
    not own, which the cache may free and reuse while the graph lives."""
    import torch

    from ..quant import params as qp
    if isinstance(rparams, qp.Q31Params):
        zp = rparams.zero_point
        return None, [0, rparams.multiplier, rparams.shift, zp,
                      rparams.min_less_zero_point + zp,
                      rparams.max_less_zero_point + zp, 0.0]
    if isinstance(rparams, qp.FP32Params):
        return None, [1, 0, 0, rparams.zero_point, rparams.qmin,
                      rparams.qmax, rparams.scale]
    if isinstance(rparams, qp.PreciseParams):
        return None, [2, rparams.multiplier, rparams.shift,
                      rparams.zero_point, rparams.qmin, rparams.qmax, 0.0]
    if isinstance(rparams, qp.GemmlowpParams):
        return None, [3, rparams.multiplier, rparams.shift,
                      rparams.zero_point, rparams.qmin, rparams.qmax, 0.0]
    if isinstance(rparams, qp.PerChannelFP32Params):
        if len(rparams.scales) != channels:
            raise ValueError(f"{len(rparams.scales)} channel scales for "
                             f"{channels} output channels")
        scales = rparams.device_scales
        if scales is None or scales.device != torch.device(device):
            if torch.device(device).type == "cuda" and \
                    torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "per-channel scales not on the launch's device "
                    f"({device}) during a CUDA graph capture: give the "
                    "params device_scales there (PerChannelFP32Params."
                    "device_scales)")
            scales = _channel_scales(rparams.scales, device)
        return (scales, [4, 0, 0, rparams.zero_point, rparams.qmin,
                         rparams.qmax, 0.0])
    raise TypeError(f"not a requantization params type: {type(rparams)}")


def out_dims(h: int, w: int, kh: int, kw: int, strides, padding,
             dilation=(1, 1)):
    """(Ho, Wo) of a Kh x Kw window op over an H x W input."""
    (pt, pb), (pl_, pr) = padding
    ho = (h + pt + pb - ((kh - 1) * dilation[0] + 1)) // strides[0] + 1
    wo = (w + pl_ + pr - ((kw - 1) * dilation[1] + 1)) // strides[1] + 1
    return ho, wo


def check_cuda(name: str, t, dtype, ndim: int) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` and rank."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be on a CUDA device, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have rank {ndim}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
