"""Elementwise and row kernels and their plain versions: q8vadd, u8clamp,
u8rmax and u8lut32norm.

Ports of qnnpack_tpu/kernels/vpu_ops.py:q8vadd_pallas, u8clamp_pallas and
u8rmax_pallas, and of the normalize pass of qnnpack_tpu/nn/elementwise.py:
u8softargmax (u8lut32norm, which has no Pallas form).  The CUDA sources,
with their design and what bounds them, are csrc/q8vadd.cu, csrc/u8clamp.cu,
csrc/u8rmax.cu and csrc/u8lut32norm.cu; the two row kernels share the row
mapping of csrc/u8rows.cuh, whose instance `row_instance` picks.

Each `*_cuda` wrapper takes the plain version for CPU tensors only.  For
CUDA tensors it launches the kernel or raises; there is no fallback.
"""

from __future__ import annotations

import torch

from ..quant.params import AddQuantParams, ClampParams
from ..quant.requantize import add_quantize, clamp_u8
from . import _build


def q8vadd_plain(a_u8, b_u8, params: AddQuantParams):
    """Plain version of the kernel: quant.requantize.add_quantize."""
    return add_quantize(a_u8, b_u8, params)


def q8vadd_cuda(a_u8, b_u8, params: AddQuantParams):
    """Quantized elementwise add of two uint8 tensors of one shape."""
    if a_u8.shape != b_u8.shape:
        raise ValueError(f"shapes differ: {tuple(a_u8.shape)} vs "
                         f"{tuple(b_u8.shape)}")
    if a_u8.device.type == "cpu" and b_u8.device.type == "cpu":
        return q8vadd_plain(a_u8, b_u8, params)
    _build.check_cuda("a", a_u8, torch.uint8, a_u8.dim())
    _build.check_cuda("b", b_u8, torch.uint8, b_u8.dim())
    if a_u8.device != b_u8.device:
        raise ValueError(f"a on {a_u8.device}, b on {b_u8.device}")
    out = torch.empty_like(a_u8)
    _build.launch(
        "qnn_q8vadd", a_u8.device.index or 0, a_u8.data_ptr(),
        b_u8.data_ptr(), out.data_ptr(), a_u8.numel(),
        params.zero_point_product, params.a_multiplier, params.b_multiplier,
        params.shift, params.y_zero_point, params.y_min, params.y_max,
        _build.stream_of(a_u8))
    q8vadd_cuda.launches += 1
    return out


q8vadd_cuda.launches = 0


def u8clamp_plain(x_u8, params: ClampParams):
    """Plain version of the kernel: quant.requantize.clamp_u8."""
    return clamp_u8(x_u8, params)


def u8clamp_cuda(x_u8, params: ClampParams):
    """uint8 clamp to [output_min, output_max], any shape."""
    if x_u8.device.type == "cpu":
        return u8clamp_plain(x_u8, params)
    _build.check_cuda("x", x_u8, torch.uint8, x_u8.dim())
    out = torch.empty_like(x_u8)
    _build.launch("qnn_u8clamp", x_u8.device.index or 0, x_u8.data_ptr(),
                  out.data_ptr(), x_u8.numel(), params.output_min,
                  params.output_max, _build.stream_of(x_u8))
    u8clamp_cuda.launches += 1
    return out


u8clamp_cuda.launches = 0


def _check_rows(x_u8):
    if x_u8.dim() != 2 or x_u8.shape[1] == 0:
        raise ValueError(f"expected rows [R, N] with N > 0, got "
                         f"{tuple(x_u8.shape)}")


# Bytes a lane loads at a time, widest first (csrc/u8rows.cuh).
ROW_VECS = (16, 8, 1)


def row_instance(n: int, *bases: int):
    """The instance of a row kernel's launch (u8rmax, u8lut32norm) over rows
    of `n` bytes at the base addresses `bases`: (vec, lanes).  vec, the
    bytes a lane loads at a time, is 16 where N % 16 == 0 and every base is
    on a 16-byte boundary, else 8 on the same terms, else 1 (any N, any
    base); lanes, the lanes a row, is the least power of two that covers
    the row's N / vec vectors, at most 32 (longer rows loop in the warp)."""
    vec = next(v for v in ROW_VECS
               if n % v == 0 and all(b % v == 0 for b in bases))
    return vec, min(32, 1 << (n // vec - 1).bit_length())


def u8rmax_plain(x_u8):
    """Plain version of the kernel: the max of each row."""
    return x_u8.amax(dim=-1)


def u8rmax_cuda(x_u8):
    """Row max of uint8 [R, N] -> uint8 [R]."""
    _check_rows(x_u8)
    if x_u8.device.type == "cpu":
        return u8rmax_plain(x_u8)
    _build.check_cuda("x", x_u8, torch.uint8, 2)
    rows, n = x_u8.shape
    out = torch.empty((rows,), dtype=torch.uint8, device=x_u8.device)
    vec, lanes = row_instance(n, x_u8.data_ptr())
    _build.launch("qnn_u8rmax", x_u8.device.index or 0, x_u8.data_ptr(),
                  out.data_ptr(), rows, n, vec, lanes, _build.stream_of(x_u8))
    u8rmax_cuda.launches += 1
    u8rmax_cuda.instance = (vec, lanes)
    return out


u8rmax_cuda.launches = 0
u8rmax_cuda.instance = None  # (vec, lanes) of the last launch


def u8lut32norm_plain(x_u8, rmax_u8, lut):
    """Plain version of the kernel, in int64 masked to uint32 (torch has
    little uint32 arithmetic): e = t[x + 255 - rmax], s = sum e,
    y = min((256 e + s / 2) / s, 255), every sum and product wrapping at
    2^32.  `lut` is int32 [256] holding the table's uint32 bits.

    A row whose sum wraps to exactly 0 (N t[255] = 2^32, e.g. N = 4096 at
    input scale 0.01) divides by zero: QNNPACK's C leaves that undefined
    and the JAX package's Barrett reciprocal gives 2; here, as in the
    kernel, the quotient is the GPU's uint32 x / 0 = 2^32 - 1, so y = 255."""
    t = lut.to(torch.int64) & 0xFFFFFFFF
    idx = x_u8.to(torch.int64) + (255 - rmax_u8.to(torch.int64))[:, None]
    e = t[idx]
    s = e.sum(dim=-1, keepdim=True) & 0xFFFFFFFF
    num = (e * 256 + (s >> 1)) & 0xFFFFFFFF
    q = torch.where(s == 0, 0xFFFFFFFF, num // s.clamp(min=1))
    return q.clamp(max=255).to(torch.uint8)


def u8lut32norm_cuda(x_u8, rmax_u8, lut):
    """Softargmax's normalize pass: uint8 rows [R, N], their maxima [R] and
    a 256-entry table (int32 holding uint32 bits) -> uint8 [R, N]."""
    _check_rows(x_u8)
    rows, n = x_u8.shape
    if tuple(rmax_u8.shape) != (rows,) or tuple(lut.shape) != (256,):
        raise ValueError(f"rmax {tuple(rmax_u8.shape)} and lut "
                         f"{tuple(lut.shape)} for rows {tuple(x_u8.shape)}")
    devices = {x_u8.device.type, rmax_u8.device.type, lut.device.type}
    if devices == {"cpu"}:
        return u8lut32norm_plain(x_u8, rmax_u8, lut)
    _build.check_cuda("x", x_u8, torch.uint8, 2)
    _build.check_cuda("rmax", rmax_u8, torch.uint8, 1)
    _build.check_cuda("lut", lut, torch.int32, 1)
    if not x_u8.device == rmax_u8.device == lut.device:
        raise ValueError(f"x on {x_u8.device}, rmax on {rmax_u8.device}, "
                         f"lut on {lut.device}")
    out = torch.empty_like(x_u8)
    vec, lanes = row_instance(n, x_u8.data_ptr(), out.data_ptr())
    _build.launch("qnn_u8lut32norm", x_u8.device.index or 0, x_u8.data_ptr(),
                  rmax_u8.data_ptr(), lut.data_ptr(), out.data_ptr(), rows, n,
                  vec, lanes, _build.stream_of(x_u8))
    u8lut32norm_cuda.launches += 1
    u8lut32norm_cuda.instance = (vec, lanes)
    return out


u8lut32norm_cuda.launches = 0
u8lut32norm_cuda.instance = None  # (vec, lanes) of the last launch
