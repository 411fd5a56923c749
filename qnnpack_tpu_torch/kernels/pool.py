"""Pooling kernels and their plain versions: u8maxpool, q8avgpool and
q8gavgpool.

Ports of qnnpack_tpu/kernels/pool.py:u8maxpool_pallas, q8avgpool_pallas and
q8gavgpool_pallas; the CUDA sources, with their design and what bounds
them, are csrc/u8maxpool.cu, csrc/q8avgpool.cu and csrc/q8gavgpool.cu.  The
first two share the instances and thread mapping of csrc/pool_tile.cuh,
whose instance `pool_instance` picks; `gavgpool_instance` picks
q8gavgpool's.

Each `*_cuda` wrapper takes the plain version for CPU tensors only.  For
CUDA tensors it launches the kernel or raises; there is no fallback.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..quant.params import AvgPoolQuantParams
from ..quant.requantize import avgpool_quantize
from . import _build


# Bytes of channels a thread takes at a time, widest first
# (csrc/pool_tile.cuh).
POOL_VECS = (16, 8, 4, 1)
# The window codes of csrc/pool_tile.cuh.
WINDOWS = {"any": 0, "3x3s2": 1, "any32": 2}
# Taps (q8avgpool) or rows (q8gavgpool) whose bytes sum exactly in 16-bit
# halves: 257 * 255 < 2^16.
HALF_TAPS = 257
# The sums forms of csrc/q8gavgpool.cu: 16-bit halves up to HALF_TAPS rows,
# 32-bit sums for any number.
GAVG_SUMS = {"halves": 0, "wide": 1}


def _channel_vec(c: int, bases) -> int:
    """Bytes of channels a thread takes: the widest of POOL_VECS that
    divides C and every base address."""
    return next(v for v in POOL_VECS
                if c % v == 0 and all(b % v == 0 for b in bases))


def pool_instance(c: int, pool, strides, dilation, *bases: int,
                  sums: bool = False):
    """The instance of a pooling launch over `c` channels at the base
    addresses `bases`: (vec, window).  vec, the bytes of channels a thread
    takes, is 16 where C % 16 == 0 and every base is on a 16-byte boundary,
    else 8, 4 or 1 on the same terms; window is "3x3s2" for a 3 x 3 window
    at stride 2 and dilation 1 (any padding), else "any", or "any32" where
    `sums` (q8avgpool) and the window has more than HALF_TAPS taps."""
    vec = _channel_vec(c, bases)
    if (tuple(pool) == (3, 3) and tuple(strides) == (2, 2)
            and tuple(dilation) == (1, 1)):
        return vec, "3x3s2"
    if sums and pool[0] * pool[1] > HALF_TAPS:
        return vec, "any32"
    return vec, "any"


def u8maxpool_plain(x_u8, pool_size, strides=None, padding=((0, 0), (0, 0)),
                    dilation=(1, 1), output_min: int = 0,
                    output_max: int = 255):
    """Plain version of the kernel: uint8 NHWC -> uint8 NHWC.

    The window max with padding 0 (the uint8 minimum), then the clamp."""
    ph, pw = pool_size
    sh, sw = strides if strides is not None else pool_size
    dh, dw = dilation
    _, h, w, _ = x_u8.shape
    ho, wo = _build.out_dims(h, w, ph, pw, (sh, sw), padding, dilation)
    (pt, pb), (pl_, pr) = padding
    x = F.pad(x_u8, (0, 0, pl_, pr, pt, pb), value=0)
    out = None
    for ky in range(ph):
        for kx in range(pw):
            y0, x0 = ky * dh, kx * dw
            tap = x[:, y0:y0 + (ho - 1) * sh + 1:sh,
                    x0:x0 + (wo - 1) * sw + 1:sw, :]
            out = tap if out is None else torch.maximum(out, tap)
    return out.clamp(output_min, output_max)


def u8maxpool_cuda(x_u8, pool_size, strides=None, padding=((0, 0), (0, 0)),
                   dilation=(1, 1), output_min: int = 0,
                   output_max: int = 255):
    """uint8 max pooling NHWC with a fused clamp to [output_min,
    output_max]; strides default to the pool size."""
    if x_u8.dim() != 4:
        raise ValueError(f"expected NHWC, got {tuple(x_u8.shape)}")
    if x_u8.device.type == "cpu":
        return u8maxpool_plain(x_u8, pool_size, strides, padding, dilation,
                               output_min, output_max)
    _build.check_cuda("x", x_u8, torch.uint8, 4)
    ph, pw = pool_size
    sh, sw = strides if strides is not None else pool_size
    b, h, w, c = x_u8.shape
    ho, wo = _build.out_dims(h, w, ph, pw, (sh, sw), padding, dilation)
    out = torch.empty((b, ho, wo, c), dtype=torch.uint8, device=x_u8.device)
    vec, window = pool_instance(c, pool_size, (sh, sw), dilation,
                                x_u8.data_ptr(), out.data_ptr())
    _build.launch(
        "qnn_u8maxpool", x_u8.device.index or 0, x_u8.data_ptr(),
        out.data_ptr(), b, h, w, c, ho, wo, ph, pw, sh, sw, padding[0][0],
        padding[1][0], dilation[0], dilation[1], output_min, output_max,
        vec, WINDOWS[window], _build.stream_of(x_u8))
    u8maxpool_cuda.launches += 1
    u8maxpool_cuda.instance = (vec, window)
    return out


u8maxpool_cuda.launches = 0
u8maxpool_cuda.instance = None  # (vec, window) of the last launch


def _quantize_wrapped(acc, params: AvgPoolQuantParams):
    """avgpool_quantize of an int64 sum wrapped to int32, as the kernels'
    int32 accumulators wrap."""
    return avgpool_quantize(((acc + 2**31) & 0xFFFFFFFF) - 2**31, params)


def q8avgpool_plain(x_u8, params: AvgPoolQuantParams, pool_size,
                    strides=None, padding=((0, 0), (0, 0))):
    """Plain version of the kernel: uint8 NHWC -> uint8 NHWC.

    The window sum over the input padded with params.input_zero_point (not
    0: a padded tap cancels against params.bias = -izp*ph*pw), plus
    params.bias, then avgpool_quantize."""
    ph, pw = pool_size
    sh, sw = strides if strides is not None else pool_size
    _, h, w, _ = x_u8.shape
    ho, wo = _build.out_dims(h, w, ph, pw, (sh, sw), padding)
    (pt, pb), (pl_, pr) = padding
    x = F.pad(x_u8, (0, 0, pl_, pr, pt, pb),
              value=params.input_zero_point).to(torch.int64)
    acc = params.bias
    for ky in range(ph):
        for kx in range(pw):
            acc = acc + x[:, ky:ky + (ho - 1) * sh + 1:sh,
                          kx:kx + (wo - 1) * sw + 1:sw, :]
    return _quantize_wrapped(acc, params)


def q8avgpool_cuda(x_u8, params: AvgPoolQuantParams, pool_size,
                   strides=None, padding=((0, 0), (0, 0))):
    """Quantized average pooling uint8 NHWC -> uint8 NHWC; strides default
    to the pool size, padded taps read params.input_zero_point."""
    if x_u8.dim() != 4:
        raise ValueError(f"expected NHWC, got {tuple(x_u8.shape)}")
    if x_u8.device.type == "cpu":
        return q8avgpool_plain(x_u8, params, pool_size, strides, padding)
    _build.check_cuda("x", x_u8, torch.uint8, 4)
    ph, pw = pool_size
    sh, sw = strides if strides is not None else pool_size
    b, h, w, c = x_u8.shape
    ho, wo = _build.out_dims(h, w, ph, pw, (sh, sw), padding)
    out = torch.empty((b, ho, wo, c), dtype=torch.uint8, device=x_u8.device)
    vec, window = pool_instance(c, pool_size, (sh, sw), (1, 1),
                                x_u8.data_ptr(), out.data_ptr(), sums=True)
    _build.launch(
        "qnn_q8avgpool", x_u8.device.index or 0, x_u8.data_ptr(),
        out.data_ptr(), b, h, w, c, ho, wo, ph, pw, sh, sw, padding[0][0],
        padding[1][0], params.input_zero_point, params.bias,
        params.multiplier, params.shift, params.output_zero_point,
        params.output_min_less_zero_point,
        params.output_max_less_zero_point, vec, WINDOWS[window],
        _build.stream_of(x_u8))
    q8avgpool_cuda.launches += 1
    q8avgpool_cuda.instance = (vec, window)
    return out


q8avgpool_cuda.launches = 0
q8avgpool_cuda.instance = None  # (vec, window) of the last launch


def gavgpool_instance(c: int, rows: int, *bases: int):
    """The instance of a q8gavgpool launch over `rows` rows of `c` channels
    at the base addresses `bases`: (vec, sums).  vec as pool_instance picks
    it; sums "halves" for at most HALF_TAPS rows, else "wide"."""
    return _channel_vec(c, bases), ("halves" if rows <= HALF_TAPS else "wide")


def q8gavgpool_plain(x_u8, params: AvgPoolQuantParams):
    """Plain version of the kernel: [B, S, C] -> [B, C]."""
    return _quantize_wrapped(x_u8.to(torch.int64).sum(dim=1) + params.bias,
                             params)


def q8gavgpool_cuda(x_u8, params: AvgPoolQuantParams):
    """Quantized global average pooling uint8 [B, S, C] -> uint8 [B, C]."""
    if x_u8.dim() != 3:
        raise ValueError(f"expected [B, S, C], got {tuple(x_u8.shape)}")
    if x_u8.device.type == "cpu":
        return q8gavgpool_plain(x_u8, params)
    _build.check_cuda("x", x_u8, torch.uint8, 3)
    b, s, c = x_u8.shape
    out = torch.empty((b, c), dtype=torch.uint8, device=x_u8.device)
    vec, sums = gavgpool_instance(c, s, x_u8.data_ptr(), out.data_ptr())
    _build.launch(
        "qnn_q8gavgpool", x_u8.device.index or 0, x_u8.data_ptr(),
        out.data_ptr(), b, s, c, params.bias, params.multiplier,
        params.shift, params.output_zero_point,
        params.output_min_less_zero_point,
        params.output_max_less_zero_point, vec, GAVG_SUMS[sums],
        _build.stream_of(x_u8))
    q8gavgpool_cuda.launches += 1
    q8gavgpool_cuda.instance = (vec, sums)
    return out


q8gavgpool_cuda.launches = 0
q8gavgpool_cuda.instance = None  # (vec, sums) of the last launch
