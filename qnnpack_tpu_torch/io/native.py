"""ctypes bindings for the native host library - a port of
qnnpack_tpu/io/native.py.

The library holds C requantization oracles (true C int64 / lrintf
semantics, for test cross-checks) and the multithreaded C++ image
preprocessing.  Its sources are the repository's `native/requant_oracle.c`
and `native/image_prep.cpp`, built with the flags of `native/Makefile`
into qnnpack_tpu_torch/_build/ under a name keyed by a hash of the sources
and flags (nothing is written into `native/`).  The build happens at the
first call, never at import.  Where it cannot be built the functions raise:
the numpy forms are separate plain versions (`resize_quantize_plain`,
`quantize_plain`, `dequantize_plain`), never a silent fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("requant_oracle.c", "image_prep.cpp")
# native/Makefile's CFLAGS, CXXFLAGS and LDFLAGS.
CFLAGS = ("-O3", "-fPIC", "-Wall", "-fvisibility=hidden")
CXXFLAGS = CFLAGS + ("-std=c++17",)
LDFLAGS = ("-shared", "-pthread", "-lm")
SCHEMES = ("q31", "precise", "fp32", "gemmlowp")

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CFLAGS + CXXFLAGS + LDFLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / f"libqnnpack_native_{h.hexdigest()[:16]}.so"


def _compiler(env: str, default: str) -> str:
    cc = os.environ.get(env) or shutil.which(default)
    if not cc:
        raise RuntimeError(f"qnnpack_tpu_torch: no {default} found to build "
                           f"the native library (set {env})")
    return cc


def build(path: Path) -> None:
    """Compile the two sources and link `path`."""
    cc, cxx = _compiler("CC", "gcc"), _compiler("CXX", "g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (Path(name).stem + ".o") for name in SOURCES]
        steps = [[cc, *CFLAGS, "-c", str(NATIVE_DIR / SOURCES[0]), "-o",
                  str(objs[0])],
                 [cxx, *CXXFLAGS, "-c", str(NATIVE_DIR / SOURCES[1]), "-o",
                  str(objs[1])],
                 [cxx, *map(str, objs), *LDFLAGS, "-o",
                  str(Path(tmp) / path.name)]]
        for cmd in steps:
            try:
                res = subprocess.run(cmd, capture_output=True, text=True,
                                     timeout=300)
            except (OSError, subprocess.SubprocessError) as e:
                raise RuntimeError("building the native library failed: "
                                   + " ".join(cmd) + f"\n{e}") from e
            if res.returncode != 0:
                raise RuntimeError("building the native library failed: "
                                   + " ".join(cmd) + "\n" + res.stdout
                                   + res.stderr)
        os.replace(Path(tmp) / path.name, path)


def get_lib() -> ctypes.CDLL:
    """The native library, built on first use; raises where it cannot be
    built."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            build(path)
        lib = ctypes.CDLL(str(path))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        for scheme in SCHEMES:
            fn = getattr(lib, f"qt_requantize_{scheme}")
            fn.argtypes = [ctypes.c_size_t, i32p, ctypes.c_float,
                           ctypes.c_uint8, ctypes.c_uint8, ctypes.c_uint8,
                           u8p]
            fn.restype = None
        lib.qt_resize_quantize_batch.argtypes = [
            f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int]
        lib.qt_resize_quantize_batch.restype = None
        lib.qt_quantize.argtypes = [f32p, ctypes.c_size_t, u8p,
                                    ctypes.c_float, ctypes.c_int]
        lib.qt_quantize.restype = None
        lib.qt_dequantize.argtypes = [u8p, ctypes.c_size_t, f32p,
                                      ctypes.c_float, ctypes.c_int]
        lib.qt_dequantize.restype = None
        _lib = lib
        return lib


def native_available() -> bool:
    """Whether the library loads (building it if needed)."""
    try:
        get_lib()
    except (RuntimeError, OSError):
        return False
    return True


def _as_ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def c_requantize(scheme: str, x: np.ndarray, scale: float, zero_point: int,
                 qmin: int = 0, qmax: int = 255) -> np.ndarray:
    """Run the C oracle for `scheme` on an int32 array."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}; expected one of "
                         f"{SCHEMES}")
    lib = get_lib()
    x = np.ascontiguousarray(x, dtype=np.int32)
    out = np.empty(x.shape, np.uint8)
    getattr(lib, f"qt_requantize_{scheme}")(
        x.size, _as_ptr(x, ctypes.c_int32), np.float32(scale), zero_point,
        qmin, qmax, _as_ptr(out, ctypes.c_uint8))
    return out


def resize_quantize_batch(images: np.ndarray, out_hw, scale: float,
                          zero_point: int) -> np.ndarray:
    """Bilinear-resize a float32 NHWC batch and quantize it to uint8 NHWC,
    in the library's thread pool."""
    images = np.ascontiguousarray(images, dtype=np.float32)
    b, h, w, c = images.shape
    oh, ow = out_hw
    lib = get_lib()
    out = np.empty((b, oh, ow, c), np.uint8)
    lib.qt_resize_quantize_batch(
        _as_ptr(images, ctypes.c_float), b, h, w, c,
        _as_ptr(out, ctypes.c_uint8), oh, ow, np.float32(scale), zero_point)
    return out


def resize_quantize_plain(images, out_hw, scale, zero_point):
    """The numpy version of resize_quantize_batch (align-corners bilinear,
    then round half to even): equal to it within one quantum, as the
    library multiplies by 1/scale where this divides."""
    images = np.ascontiguousarray(images, dtype=np.float32)
    b, h, w, c = images.shape
    oh, ow = out_hw
    fy = (np.arange(oh) * ((h - 1) / (oh - 1) if oh > 1 else 0.0))
    fx = (np.arange(ow) * ((w - 1) / (ow - 1) if ow > 1 else 0.0))
    y0 = fy.astype(np.int32)
    x0 = fx.astype(np.int32)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (fy - y0).astype(np.float32)[None, :, None, None]
    wx = (fx - x0).astype(np.float32)[None, None, :, None]
    p00 = images[:, y0][:, :, x0]
    p01 = images[:, y0][:, :, x1]
    p10 = images[:, y1][:, :, x0]
    p11 = images[:, y1][:, :, x1]
    top = p00 + (p01 - p00) * wx
    bot = p10 + (p11 - p10) * wx
    resized = top + (bot - top) * wy
    q = np.rint((resized / np.float32(scale)).astype(np.float32)) + zero_point
    return np.clip(q, 0, 255).astype(np.uint8)


def quantize(x: np.ndarray, scale: float, zero_point: int) -> np.ndarray:
    """float32 -> uint8 quantization in the library."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    lib = get_lib()
    out = np.empty(x.shape, np.uint8)
    lib.qt_quantize(_as_ptr(x, ctypes.c_float), x.size,
                    _as_ptr(out, ctypes.c_uint8), np.float32(scale),
                    zero_point)
    return out


def quantize_plain(x: np.ndarray, scale: float, zero_point: int) -> np.ndarray:
    """The numpy version of quantize (divides where the library multiplies
    by 1/scale)."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    q = np.rint(x / np.float32(scale)) + zero_point
    return np.clip(q, 0, 255).astype(np.uint8)


def dequantize(x: np.ndarray, scale: float, zero_point: int) -> np.ndarray:
    """uint8 -> float32 in the library."""
    x = np.ascontiguousarray(x, dtype=np.uint8)
    lib = get_lib()
    out = np.empty(x.shape, np.float32)
    lib.qt_dequantize(_as_ptr(x, ctypes.c_uint8), x.size,
                      _as_ptr(out, ctypes.c_float), np.float32(scale),
                      zero_point)
    return out


def dequantize_plain(x: np.ndarray, scale: float,
                     zero_point: int) -> np.ndarray:
    """The numpy version of dequantize."""
    x = np.ascontiguousarray(x, dtype=np.uint8)
    return ((x.astype(np.int32) - zero_point).astype(np.float32)
            * np.float32(scale))
