"""Quantized MobileNetV2 1.0_224: stem conv, 17 inverted-residual blocks
(1x1 expand -> depthwise 3x3 -> 1x1 linear project, residual add), head
conv, global average pool and FC classifier.

A port of qnnpack_tpu/models/mobilenet_v2.py.  The builder makes the same
numpy RNG calls in the same order, so one seed gives the same raw weights,
layer specs and requant params as the JAX builder.  ReLU6 folds into the
requantization clamp: output_max = zp + round(6 / scale).

On GPU tensors every layer runs on a CUDA kernel: the 1x1 layers and the
FC on q8gemm, the stem on q8stem, the depthwise layers on q8dwconv, the
residual adds on q8vadd and the pool on q8gavgpool.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..kernels.vpu_ops import q8vadd_cuda
from ..nn.conv import pack_conv_weights, q8conv2d
from ..nn.gemm import q8gemm
from ..nn.packing import pack_gemm_weights
from ..nn.pool import q8gavgpool
from ..nn.requant_dispatch import make_requant_params
from ..quant.params import compute_add_quant_params, compute_avgpool_quant_params
from .graph import packed_from_jax

# Standard MobileNetV2 inverted-residual config: (expansion, channels,
# repeats, first-stride) - QNNPACK's bench/convolution.cc:453-537 shapes.
INVERTED_RESIDUAL_CFG = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]

ACT_SCALE = 0.1  # uniform synthetic activation scale
ACT_ZP = 128
KERNEL_SCALE = 0.02
KERNEL_ZP = 128


def _relu6_max(scale: float, zero_point: int) -> int:
    return min(255, zero_point + int(round(6.0 / scale)))


@dataclasses.dataclass
class _ConvLayer:
    kind: str  # "conv" | "dwconv" | "gemm"
    strides: tuple
    padding: tuple
    groups: int
    rparams: Any


@dataclasses.dataclass
class _ModelSpec:
    layers: list  # list of (tag, name, layer-kind-specific static spec)
    num_classes: int
    raw_weights: list = dataclasses.field(default_factory=list)


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def build_mobilenet_v2(rng: np.random.Generator, *, width_mult: float = 1.0,
                       num_classes: int = 1000, requant: str = "fp32",
                       input_size: int = 224, cfg=None, stem_channels=32,
                       head_channels=1280, device="cuda"):
    """Construct (params, spec) for a synthetic-weights quantized MobileNetV2.

    params is a list of packed-weight records (None for weightless layers)
    on `device`; spec carries the static per-layer configuration including
    requantization constants, and the raw uint8 weights."""
    dev = resolve_device(device)
    cfg = cfg if cfg is not None else INVERTED_RESIDUAL_CFG
    layers = []
    params = []
    raw_weights = []  # [(kernel_u8, bias_i32) | None]

    def rand_kernel(o, kh, kw, i):
        return rng.integers(0, 256, (o, kh, kw, i), dtype=np.int64).astype(np.uint8)

    def rand_bias(o):
        return rng.integers(-8000, 8000, (o,), dtype=np.int64).astype(np.int32)

    def conv_scale():
        return ACT_SCALE * KERNEL_SCALE / ACT_SCALE  # < 1 by construction

    def add_conv(name, cin, cout, kh, kw, strides, padding, groups=1,
                 relu6=True):
        omin = ACT_ZP if relu6 else 0
        omax = _relu6_max(ACT_SCALE, ACT_ZP) if relu6 else 255
        rp = make_requant_params(requant, conv_scale(), ACT_ZP, omin, omax)
        k = rand_kernel(cout, kh, kw, cin // groups)
        b = rand_bias(cout)
        raw_weights.append((k, b))
        if (kh, kw) == (1, 1) and strides == (1, 1) and groups == 1:
            packed = pack_gemm_weights(k.reshape(cout, cin), b, ACT_ZP,
                                       KERNEL_ZP, device=dev)
            layers.append(("conv", name, _ConvLayer("gemm", strides, padding, 1, rp)))
        else:
            packed = pack_conv_weights(k, b, ACT_ZP, KERNEL_ZP, groups,
                                       device=dev)
            kind = "dwconv" if groups == cin and groups == cout else "conv"
            layers.append(("conv", name, _ConvLayer(kind, strides, padding, groups, rp)))
        params.append(packed)

    stem = _make_divisible(stem_channels * width_mult)
    add_conv("stem", 3, stem, 3, 3, (2, 2), ((0, 1), (0, 1)))
    cin = stem
    spatial = input_size // 2  # stem stride 2 with (0,1) padding

    for block_idx, (t, c, n, s) in enumerate(cfg):
        cout = _make_divisible(c * width_mult)
        for i in range(n):
            stride = s if i == 0 else 1
            if stride == 2:
                spatial //= 2
            hidden = cin * t
            prefix = f"block{block_idx}_{i}"
            has_residual = stride == 1 and cin == cout
            if has_residual:
                layers.append(("save", f"{prefix}_save", None))
                params.append(None)
                raw_weights.append(None)
            if t != 1:
                add_conv(f"{prefix}_expand", cin, hidden, 1, 1, (1, 1),
                         ((0, 0), (0, 0)))
            pad = ((0, 1), (0, 1)) if stride == 2 else ((1, 1), (1, 1))
            add_conv(f"{prefix}_dw", hidden, hidden, 3, 3, (stride, stride),
                     pad, groups=hidden)
            add_conv(f"{prefix}_project", hidden, cout, 1, 1, (1, 1),
                     ((0, 0), (0, 0)), relu6=False)
            if has_residual:
                layers.append(("add", f"{prefix}_add", compute_add_quant_params(
                    ACT_ZP, ACT_ZP, ACT_ZP, 1.0, 1.0)))
                params.append(None)
                raw_weights.append(None)
            cin = cout

    head = _make_divisible(head_channels * max(1.0, width_mult))
    add_conv("head", cin, head, 1, 1, (1, 1), ((0, 0), (0, 0)))

    layers.append(("gap", "gap", compute_avgpool_quant_params(
        -ACT_ZP * spatial * spatial, 1.0 / (spatial * spatial), ACT_ZP,
        input_zero_point=ACT_ZP)))
    params.append(None)
    raw_weights.append(None)

    fc_rp = make_requant_params(requant, conv_scale(), ACT_ZP)
    layers.append(("conv", "fc", _ConvLayer("gemm", (1, 1), ((0, 0), (0, 0)), 1, fc_rp)))
    fc_kernel = rng.integers(0, 256, (num_classes, head),
                             dtype=np.int64).astype(np.uint8)
    fc_bias = rand_bias(num_classes)
    raw_weights.append((fc_kernel, fc_bias))
    params.append(pack_gemm_weights(fc_kernel, fc_bias, ACT_ZP, KERNEL_ZP,
                                    device=dev))

    spec = _ModelSpec(layers=layers, num_classes=num_classes,
                      raw_weights=raw_weights)
    return params, spec


def apply_layer(tag: str, layer, p, x, residual):
    """One layer of the forward: returns (x, residual)."""
    if tag == "save":
        return x, x
    if tag == "add":
        return q8vadd_cuda(x, residual, layer), None
    if tag == "gap":
        b, h, w, c = x.shape
        return q8gavgpool(x.reshape(b, h * w, c), layer, axis=1), residual
    if tag == "conv" and layer.kind == "gemm":
        return q8gemm(x, p, layer.rparams), residual
    if tag == "conv":
        return q8conv2d(x, p, layer.rparams, layer.strides,
                        layer.padding), residual
    raise ValueError(f"unknown layer tag {tag!r}")


def mobilenet_v2_forward(params, spec: _ModelSpec, x_u8):
    """Forward pass: uint8 NHWC [B, S, S, 3] -> uint8 logits [B, classes]."""
    x = x_u8
    residual = None
    for (tag, _, layer), p in zip(spec.layers, params):
        x, residual = apply_layer(tag, layer, p, x, residual)
    return x


class MobileNetV2(nn.Module):
    """The quantized forward as a module around packed params and a spec.

    The packed records are dataclasses of tensors, not nn.Parameters: build
    them on the device the model runs on."""

    def __init__(self, params, spec: _ModelSpec):
        super().__init__()
        self.params = params
        self.spec = spec

    @classmethod
    def build(cls, seed: int = 0, *, device="cuda", **kwargs):
        """Model with synthetic weights from `seed` (see build_mobilenet_v2)."""
        params, spec = build_mobilenet_v2(np.random.default_rng(seed),
                                          device=device, **kwargs)
        return cls(params, spec)

    def forward(self, x_u8: torch.Tensor) -> torch.Tensor:
        return mobilenet_v2_forward(self.params, self.spec, x_u8)


def params_from_jax(arrays, spec: _ModelSpec, *, device="cuda"):
    """The port's packed records from the JAX package's packed params.

    `arrays` is the JAX params list with numpy leaves (records with `w` and
    `bias_folded`, as attributes or keys, or None); `spec` is the port's
    spec of the same model, whose raw weights give the expected shapes."""
    dev = resolve_device(device)
    if len(arrays) != len(spec.layers):
        raise ValueError(f"{len(arrays)} records for {len(spec.layers)} layers")
    out = []
    for (tag, name, layer), rec, raw in zip(spec.layers, arrays,
                                            spec.raw_weights):
        if raw is None:
            if rec is not None:
                raise ValueError(f"{name}: weightless layer got a record")
            out.append(None)
            continue
        out.append(packed_from_jax(
            name, rec, raw[0], gemm=tag == "conv" and layer.kind == "gemm",
            groups=layer.groups, device=dev))
    return out
