"""Float compute paths: fp32 GEMM, conv and depthwise conv, and the 16-bit
GEMM - a port of qnnpack_tpu/nn/float_ops.py.

QNNPACK's float microkernel families (SURVEY.md 2.1C):

  sgemm   (src/sgemm/{5x8,6x8}-neon.c, 6x8-psimd.c; params.h:326-346)
  sconv   (src/sconv/6x8-psimd.c)
  sdwconv (src/sdwconv/up4x9-psimd.c)
  hgemm   (src/hgemm/8x8-neonfp16arith.c + .S)

All four keep the reference's clamping contract: output_min/max applied
before the store (qnnp_fp32_clamping_params / qnnp_fp16_clamping_params,
params.h:455-470).  They are plain float products outside any quantized
kernel, so they run on PyTorch's own GEMM and convolution, as the JAX
package runs them in XLA: a hand-written kernel adds nothing for dense fp32
(qnnpack_tpu/nn/float_ops.py:15-16).

Two numerics rules hold on the GPU as on the CPU:
  - TF32 stays off: sgemm and hgemm run at float32 matmul precision
    "highest", sconv2d and sdwconv2d under cudnn.flags(allow_tf32=False),
    each only for the duration of the call (the caller's settings are
    restored).
  - The 16-bit family is bfloat16, as in the JAX package (its TPU-native
    16-bit float), so the two packages agree: bf16 operands, products and
    sums in fp32, the bias added and the clamp applied in fp32, and only
    then the round to bf16.  A bf16 matmul would round before the bias.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from .packing import as_tensor


@contextlib.contextmanager
def _fp32_matmul():
    """float32 matmuls at full precision (no TF32) within the block."""
    prev = torch.get_float32_matmul_precision()
    if prev == "highest":
        yield
        return
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _bias_clamp(acc, bias, output_min, output_max, dims: int):
    if bias is not None:
        acc = acc + as_tensor(bias, torch.float32, acc.device).reshape(
            (1,) * (dims - 1) + (-1,))
    return torch.clamp(acc, float(output_min), float(output_max))


def sgemm(a, w, bias=None, output_min=float("-inf"),
          output_max=float("inf")):
    """fp32 GEMM with fused bias + clamp: [M, K] x [K, N] -> [M, N] (the
    sgemm ukernel contract, params.h:326-331)."""
    a = as_tensor(a, torch.float32)
    w = as_tensor(w, torch.float32, a.device)
    with _fp32_matmul():
        acc = torch.matmul(a, w)
    return _bias_clamp(acc, bias, output_min, output_max, 2)


def hgemm(a, w, bias=None, output_min=float("-inf"),
          output_max=float("inf")):
    """16-bit GEMM (hgemm analogue): bf16 operands, fp32 accumulation,
    bf16 result with fused bias + clamp (the bias and clamp in fp32, before
    the round)."""
    a = as_tensor(a, torch.bfloat16)
    w = as_tensor(w, torch.bfloat16, a.device)
    with _fp32_matmul():
        acc = torch.matmul(a.float(), w.float())
    return _bias_clamp(acc, bias, output_min, output_max, 2).to(
        torch.bfloat16)


def sconv2d(a, w_hwio, bias=None, strides=(1, 1), padding=((0, 0), (0, 0)),
            dilation=(1, 1), groups: int = 1, output_min=float("-inf"),
            output_max=float("inf")):
    """fp32 conv NHWC x HWIO -> NHWC with fused bias + clamp (the sconv
    ukernel contract); padded taps read 0."""
    a = as_tensor(a, torch.float32)
    w = as_tensor(w_hwio, torch.float32, a.device)
    (pt, pb), (pl_, pr) = padding
    x = F.pad(a.permute(0, 3, 1, 2), (pl_, pr, pt, pb))
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        acc = F.conv2d(x, w.permute(3, 2, 0, 1), stride=tuple(strides),
                       dilation=tuple(dilation), groups=groups)
    acc = acc.permute(0, 2, 3, 1).contiguous()
    return _bias_clamp(acc, bias, output_min, output_max, 4)


def sdwconv2d(a, w_hwc, bias=None, strides=(1, 1), padding=((0, 0), (0, 0)),
              dilation=(1, 1), output_min=float("-inf"),
              output_max=float("inf")):
    """fp32 depthwise conv: NHWC x [Kh, Kw, C] -> NHWC (the sdwconv up4x9
    contract)."""
    w = as_tensor(w_hwc, torch.float32)
    kh, kw, c = w.shape
    return sconv2d(a, w.reshape(kh, kw, 1, c), bias, strides, padding,
                   dilation, groups=c, output_min=output_min,
                   output_max=output_max)
