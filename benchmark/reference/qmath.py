"""Plain integer arithmetic of QNNPACK's quantized operators, in PyTorch.

The benchmark's references compute with this and nothing of the program
under test.  Each function follows QNNPACK's scalar C code
(src/qnnpack/requantization.h and the scalar micro-kernels):

  - conv / GEMM accumulators: sum_k (a - a_zp)(w - w_zp) + bias, wrapped
    to int32, computed as float64 matmuls, which are exact here (every
    partial sum is an integer far below 2^53) on the CPU and the GPU;
  - fp32 requantization (fp32-scalar.c): the int32 accumulator converted
    to float32, one float32 multiply, round half to even, clamp, add the
    zero point;
  - elementwise add (requantization.h:416-462, 500-522);
  - average pooling (requantization.h:268-303, 482-498);
  - softargmax (softargmax.c:86-91 for the table, u8lut32norm/scalar.c for
    the normalization, in wrapping uint32).
"""

from __future__ import annotations

import numpy as np
import torch


def f32(x: float) -> float:
    """`x` rounded to float32, as QNNPACK stores every scale."""
    return float(np.float32(x))


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of an int64 tensor, as a signed value (int64)."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def requant_fp32(acc: torch.Tensor, scale: float, zero_point: int,
                 qmin: int = 0, qmax: int = 255) -> torch.Tensor:
    """uint8 of an int64 accumulator (taken mod 2^32) under fp32
    requantization with a float32 `scale`."""
    s = torch.tensor(f32(scale), dtype=torch.float32, device=acc.device)
    y = torch.round(wrap_i32(acc).to(torch.float32) * s)
    y = y.clamp(float(qmin - zero_point), float(qmax - zero_point))
    return (y.to(torch.int64) + zero_point).to(torch.uint8)


def gemm_acc(a_u8: torch.Tensor, w_u8: torch.Tensor, a_zp: int, w_zp: int,
             bias: torch.Tensor) -> torch.Tensor:
    """int64 accumulator [M, N] of uint8 a [M, K] and a uint8 kernel
    w [N, K]: sum_k (a - a_zp)(w - w_zp) + bias, wrapped to int32."""
    a = a_u8.to(torch.float64) - a_zp
    w = w_u8.to(torch.float64) - w_zp
    acc = torch.matmul(a, w.t()).to(torch.int64)
    return wrap_i32(acc + bias.to(torch.int64))


def bmm_acc(a_u8: torch.Tensor, b_u8: torch.Tensor, a_zp: int,
            b_zp: int) -> torch.Tensor:
    """int64 accumulator [..., M, N] of uint8 a [..., M, K] and
    b [..., K, N]: sum_k (a - a_zp)(b - b_zp), wrapped to int32."""
    a = a_u8.to(torch.float64) - a_zp
    b = b_u8.to(torch.float64) - b_zp
    return wrap_i32(torch.matmul(a, b).to(torch.int64))


def add_params(a_zp: int, b_zp: int, y_zp: int, a_scale: float,
               b_scale: float, y_min: int = 0, y_max: int = 255) -> dict:
    """QNNPACK's scalar add parameters for the output-relative scales
    a_scale = s_a / s_y and b_scale = s_b / s_y."""
    a_scale, b_scale = f32(a_scale), f32(b_scale)

    def bits(x: float) -> int:
        return int(np.float32(x).view(np.uint32))

    def from_bits(b: int) -> float:
        return float(np.uint32(b).view(np.float32))

    exponent = (bits(max(a_scale, b_scale)) >> 23) - 127
    shift = 21 - exponent
    a_mult = int(np.rint(np.float32(from_bits(bits(a_scale) + (shift << 23)))))
    b_mult = int(np.rint(np.float32(from_bits(bits(b_scale) + (shift << 23)))))
    mask = (1 << shift) - 1
    return dict(zp_product=-(a_mult * a_zp + b_mult * b_zp), a_mult=a_mult,
                b_mult=b_mult, shift=shift, mask=mask, threshold=mask >> 1,
                y_zp=y_zp, y_min=y_min, y_max=y_max)


def add_quantize(a_u8: torch.Tensor, b_u8: torch.Tensor, p: dict):
    """Quantized add of two uint8 tensors of one shape."""
    acc = wrap_i32(p["zp_product"] + a_u8.to(torch.int64) * p["a_mult"]
                   + b_u8.to(torch.int64) * p["b_mult"])
    rem = (acc & p["mask"]) - (acc < 0).to(torch.int64)
    acc = (acc >> p["shift"]) + (rem > p["threshold"]).to(torch.int64)
    y = (acc + p["y_zp"]).clamp(max=p["y_max"]).clamp(min=p["y_min"])
    return y.to(torch.uint8)


def avgpool_params(bias: int, scale: float, y_zp: int, y_min: int = 0,
                   y_max: int = 255) -> dict:
    """QNNPACK's scalar average-pooling parameters."""
    b = int(np.float32(f32(scale)).view(np.uint32))
    return dict(bias=bias, mult=(b & 0x007FFFFF) | 0x00800000,
                shift=127 + 23 - (b >> 23), y_zp=y_zp, lo=y_min - y_zp,
                hi=y_max - y_zp)


def avgpool_quantize(acc: torch.Tensor, p: dict) -> torch.Tensor:
    """uint8 of an int64 window sum under `avgpool_params` (the bias is
    added here, the sum wrapped to int32 as the kernels' accumulators)."""
    x = wrap_i32(acc + p["bias"])
    prod = x * p["mult"] - (x < 0).to(torch.int64) + (1 << (p["shift"] - 1))
    y = wrap_i32(prod >> p["shift"]).clamp(p["lo"], p["hi"]) + p["y_zp"]
    return y.to(torch.uint8)


def softargmax_table(input_scale: float, channels: int) -> torch.Tensor:
    """The 256-entry uint32 exp table of softargmax.c, as int64 values."""
    qscale = min(float(np.iinfo(np.uint32).max) / float(channels), 8388607.0)
    i = np.arange(256, dtype=np.float64)
    t = np.rint(qscale * np.exp((i - 255.0) * float(input_scale)))
    return torch.from_numpy(t.astype(np.uint64).astype(np.int64))


def softargmax(x_u8: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Quantized softmax over the last axis, output scale 1/256 and zero
    point 0: e = t[x + 255 - max], s = sum e, y = min((256 e + s / 2) / s,
    255), every sum and product wrapping at 2^32."""
    t = table.to(x_u8.device)
    x = x_u8.to(torch.int64)
    e = t[x + (255 - x.amax(dim=-1, keepdim=True))]
    s = e.sum(dim=-1, keepdim=True) & 0xFFFFFFFF
    num = (e * 256 + (s >> 1)) & 0xFFFFFFFF
    q = torch.where(s == 0, torch.full_like(num, 0xFFFFFFFF),
                    num // s.clamp(min=1))
    return q.clamp(max=255).to(torch.uint8)


def pad_value(x_u8: torch.Tensor, pads, value: int) -> torch.Tensor:
    """NHWC x padded on H and W by pads ((top, bottom), (left, right))."""
    (t, b), (l, r) = pads
    if not (t or b or l or r):
        return x_u8
    n, h, w, c = x_u8.shape
    out = torch.full((n, h + t + b, w + l + r, c), value, dtype=x_u8.dtype,
                     device=x_u8.device)
    out[:, t:t + h, l:l + w] = x_u8
    return out


def conv_out(size: int, k: int, pads, stride: int) -> int:
    return (size + pads[0] + pads[1] - k) // stride + 1


def conv2d_acc(x_u8: torch.Tensor, w_u8: torch.Tensor, bias: torch.Tensor,
               stride: int, pads, x_zp: int, w_zp: int) -> torch.Tensor:
    """int64 accumulator NHWC of a dense convolution (groups 1) with a
    kernel [O, kh, kw, C], the input padded with its zero point."""
    o, kh, kw, c = w_u8.shape
    xp = pad_value(x_u8, pads, x_zp)
    n, hp, wp, _ = xp.shape
    ho, wo = (hp - kh) // stride + 1, (wp - kw) // stride + 1
    cols = [xp[:, ky:ky + (ho - 1) * stride + 1:stride,
               kx:kx + (wo - 1) * stride + 1:stride, :]
            for ky in range(kh) for kx in range(kw)]
    patches = torch.cat(cols, dim=-1).reshape(n * ho * wo, kh * kw * c)
    acc = gemm_acc(patches, w_u8.reshape(o, kh * kw * c), x_zp, w_zp, bias)
    return acc.reshape(n, ho, wo, o)


def dwconv2d_acc(x_u8: torch.Tensor, w_u8: torch.Tensor, bias: torch.Tensor,
                 stride: int, pads, x_zp: int, w_zp: int) -> torch.Tensor:
    """int64 accumulator NHWC of a depthwise convolution with a kernel
    [C, kh, kw, 1], the input padded with its zero point."""
    c, kh, kw, _ = w_u8.shape
    xp = pad_value(x_u8, pads, x_zp)
    _, hp, wp, _ = xp.shape
    ho, wo = (hp - kh) // stride + 1, (wp - kw) // stride + 1
    w = w_u8.to(torch.int32) - w_zp
    acc = None
    for ky in range(kh):
        for kx in range(kw):
            tap = xp[:, ky:ky + (ho - 1) * stride + 1:stride,
                     kx:kx + (wo - 1) * stride + 1:stride, :]
            term = (tap.to(torch.int32) - x_zp) * w[:, ky, kx, 0]
            acc = term if acc is None else acc + term
    return wrap_i32(acc.to(torch.int64) + bias.to(torch.int64))


def round_weights(w_u8: torch.Tensor, w_zp: int, bits: int) -> torch.Tensor:
    """A uint8 kernel with w - w_zp rounded to `bits` signed bits (steps of
    2^(8 - bits), half to even), the lower precision of the
    benchmark's control; `bits` = 8 returns it as it is."""
    if bits >= 8:
        return w_u8
    step = 1 << (8 - bits)
    q = torch.round((w_u8.to(torch.float32) - w_zp) / step)
    lim = 1 << (bits - 1)
    q = q.clamp(-lim, lim - 1) * step + w_zp
    return q.clamp(0, 255).to(torch.uint8)


def relu6_max(act_scale: float, zero_point: int) -> int:
    return min(255, zero_point + int(round(6.0 / act_scale)))
