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

from ..nn.requant_dispatch import apply_requant
from ..quant.params import AddQuantParams, ClampParams, FP32Params
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


def u8softmax_masked_plain(x_u8, lut, window: int, sinks=None):
    """Plain version of u8softmax_masked: softargmax over each row's valid
    keys of scores [G, S, S] (row i of a [S, S] block reads keys j <= i,
    and with window W > 0 only j > i - W), a new tensor whose entries
    outside the mask are 0.  `sinks`, uint8 [H] or None, is one more
    virtual entry of each row of head g % H in the max and the sum, with
    no output; `lut` is int32 [256] holding the uint32 table.  The
    arithmetic is u8lut32norm_plain's, wrapping in uint32."""
    from .q8bmm import valid_keys
    g, s, _ = x_u8.shape
    keep = valid_keys(s, window, x_u8.device)
    t = lut.to(torch.int64) & 0xFFFFFFFF
    x = x_u8.to(torch.int64)
    m = torch.where(keep, x, 0).amax(dim=-1, keepdim=True)
    if sinks is not None:
        sink = sinks.to(torch.int64).repeat(g // sinks.numel())[:, None, None]
        m = torch.maximum(m, sink)
    e = torch.where(keep, t[torch.where(keep, x, m) + 255 - m], 0)
    s_ = e.sum(dim=-1, keepdim=True)
    if sinks is not None:
        s_ = s_ + t[sink + 255 - m]
    s_ = s_ & 0xFFFFFFFF
    num = (e * 256 + (s_ >> 1)) & 0xFFFFFFFF
    q = torch.where(s_ == 0, 0xFFFFFFFF, num // s_.clamp(min=1))
    return torch.where(keep, q.clamp(max=255), 0).to(torch.uint8)


def u8softmax_masked_cuda(x_u8, lut, window: int, sinks=None):
    """Masked softargmax of scores [G, S, S] in place: each row's valid
    entries become their probabilities (scale 1/256, zero point 0), the
    others are left unspecified (q8bmm_masked's CONTEXT mode reads only the
    valid ones); returns x_u8.  One kernel reads the row's valid bytes
    once, takes their max (and the sink's), sums the table's entries and
    normalizes, as u8rmax and u8lut32norm do in two."""
    if x_u8.dim() != 3 or x_u8.shape[1] != x_u8.shape[2]:
        raise ValueError(f"expected scores [G, S, S], got "
                         f"{tuple(x_u8.shape)}")
    if sinks is not None and x_u8.shape[0] % sinks.numel():
        raise ValueError(f"{sinks.numel()} sinks for {x_u8.shape[0]} "
                         "score blocks")
    devices = {x_u8.device.type, lut.device.type} | (
        set() if sinks is None else {sinks.device.type})
    if devices == {"cpu"}:
        return x_u8.copy_(u8softmax_masked_plain(x_u8, lut, window, sinks))
    _build.check_cuda("x", x_u8, torch.uint8, 3)
    _build.check_cuda("lut", lut, torch.int32, 1)
    if sinks is not None:
        _build.check_cuda("sinks", sinks, torch.uint8, 1)
    g, s, _ = x_u8.shape
    _build.launch("qnn_u8softmax_masked", x_u8.device.index or 0,
                  x_u8.data_ptr(), lut.data_ptr(),
                  None if sinks is None else sinks.data_ptr(), g * s, s, s,
                  1 if sinks is None else sinks.numel(), window,
                  _build.stream_of(x_u8))
    u8softmax_masked_cuda.launches += 1
    return x_u8


u8softmax_masked_cuda.launches = 0


def q8rope_plain(x_u8, cos, sin, heads: int, head_dim: int, seq: int,
                 rparams):
    """Plain version of q8rope on rows [T, >= heads * head_dim] (row t at
    position t % seq), a new [T, heads * head_dim] tensor: dims i and
    i + R/2 (i < R/2, R = 2 * cos.shape[1]) of each head rotate by the
    tables, the rest pass through:
        y_i      = requant((x_i - z) C - (x_{i+R/2} - z) S)
        y_{i+R/2} = requant((x_{i+R/2} - z) C + (x_i - z) S)
    with C, S int32 [seq, R/2] and z the params' zero point."""
    t = x_u8.shape[0]
    half = cos.shape[1]
    x = x_u8[:, :heads * head_dim].reshape(t, heads, head_dim)
    z = rparams.zero_point
    pos = torch.arange(t, device=x_u8.device) % seq
    c = cos.to(torch.int64)[pos][:, None, :]
    s = sin.to(torch.int64)[pos][:, None, :]
    a = x[..., :half].to(torch.int64) - z
    b = x[..., half:2 * half].to(torch.int64) - z
    y = x.clone()
    y[..., :half] = apply_requant(a * c - b * s, rparams)
    y[..., half:2 * half] = apply_requant(b * c + a * s, rparams)
    return y.reshape(t, heads * head_dim)


def q8rope_cuda(x_u8, cos, sin, heads: int, head_dim: int, seq: int,
                rparams):
    """Partial rotary embedding in place on the first heads * head_dim
    columns of rows [T, ld] (a view with rows at any stride, columns at
    stride 1; row t at position t % seq); fp32 requantization with the
    input's zero point.  Returns x_u8."""
    half = cos.shape[1]
    if x_u8.dim() != 2 or x_u8.shape[1] < heads * head_dim or \
            2 * half > head_dim or tuple(sin.shape) != tuple(cos.shape) or \
            cos.shape[0] < seq:
        raise ValueError(f"rows {tuple(x_u8.shape)}, tables "
                         f"{tuple(cos.shape)}, {heads} x {head_dim}")
    if x_u8.device.type == "cpu":
        x_u8[:, :heads * head_dim] = q8rope_plain(x_u8, cos, sin, heads,
                                                  head_dim, seq, rparams)
        return x_u8
    if not isinstance(rparams, FP32Params) or x_u8.stride(1) != 1:
        raise ValueError("q8rope takes fp32 requantization and columns at "
                         "stride 1")
    _build.check_cuda("cos", cos, torch.int32, 2)
    _build.check_cuda("sin", sin, torch.int32, 2)
    _build.launch("qnn_q8rope", x_u8.device.index or 0, x_u8.data_ptr(),
                  cos.data_ptr(), sin.data_ptr(), x_u8.shape[0],
                  x_u8.stride(0), heads, head_dim, half, seq,
                  rparams.zero_point, rparams.scale, _build.stream_of(x_u8))
    q8rope_cuda.launches += 1
    return x_u8


q8rope_cuda.launches = 0


def q8swiglu_plain(gu_u8, silu_lut, width: int, z_silu: int, z_up: int,
                   rparams, counts=None, cap: int = 0):
    """Plain version of q8swiglu: rows [R, 2 W] holding gate | up ->
    [R, W], requant((silu_lut[g] - z_silu) (u - z_up)).  With `counts`
    the rows are segments of `cap` of which the first counts[e] are live;
    the rest are 0 here and unspecified in the kernel's output."""
    g = gu_u8[:, :width]
    u = gu_u8[:, width:2 * width]
    silu = silu_lut.to(gu_u8.device)[g.to(torch.int64)].to(torch.int64)
    y = apply_requant((silu - z_silu) * (u.to(torch.int64) - z_up), rparams)
    if counts is None:
        return y
    from .moe import live_rows
    live = live_rows(counts.to(gu_u8.device), cap)
    return torch.where(live[:, None], y, torch.zeros_like(y))


def q8swiglu_cuda(gu_u8, silu_lut, width: int, z_silu: int, z_up: int,
                  rparams, counts=None, cap: int = 0):
    """The SwiGLU product of a fused gate | up projection [R, 2 W] ->
    uint8 [R, W]: the gate through the 256-entry SiLU table, times the
    up, requantized (fp32).  With `counts` (int32 [E], on the device) only
    the first counts[e] rows of each segment of `cap` are computed."""
    if gu_u8.dim() != 2 or gu_u8.shape[1] != 2 * width or \
            tuple(silu_lut.shape) != (256,):
        raise ValueError(f"gate|up {tuple(gu_u8.shape)} for width {width}")
    if counts is not None and gu_u8.shape[0] != counts.numel() * cap:
        raise ValueError(f"{gu_u8.shape[0]} rows for {counts.numel()} "
                         f"segments of {cap}")
    if gu_u8.device.type == "cpu":
        return q8swiglu_plain(gu_u8, silu_lut, width, z_silu, z_up, rparams,
                              counts, cap)
    if not isinstance(rparams, FP32Params):
        raise ValueError("q8swiglu takes fp32 requantization")
    _build.check_cuda("gu", gu_u8, torch.uint8, 2)
    _build.check_cuda("silu_lut", silu_lut, torch.uint8, 1)
    if counts is not None:
        _build.check_cuda("counts", counts, torch.int32, 1)
    out = torch.empty((gu_u8.shape[0], width), dtype=torch.uint8,
                      device=gu_u8.device)
    _build.launch("qnn_q8swiglu", gu_u8.device.index or 0, gu_u8.data_ptr(),
                  silu_lut.data_ptr(), out.data_ptr(), gu_u8.shape[0], width,
                  None if counts is None else counts.data_ptr(),
                  0 if counts is None else counts.numel(), cap, z_silu,
                  z_up, rparams.zero_point, rparams.scale,
                  _build.stream_of(gu_u8))
    q8swiglu_cuda.launches += 1
    return out


q8swiglu_cuda.launches = 0
