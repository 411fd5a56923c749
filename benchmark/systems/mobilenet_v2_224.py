"""MobileNetV2 on the program under test: the port's builder gives the
spec of the model (its layers and requantization), and the benchmark's raw
weights are packed through the port's public packing API."""

from __future__ import annotations

import numpy as np

from qnnpack_tpu_torch.models import mobilenet_v2
from qnnpack_tpu_torch.models.mobilenet_v2 import (build_mobilenet_v2,
                                                   mobilenet_v2_forward)
from qnnpack_tpu_torch.nn.conv import pack_conv_weights
from qnnpack_tpu_torch.nn.packing import pack_gemm_weights

from . import require_port_quantization


def build(cfg: dict, weights: list, device):
    """(forward, params): forward(params, x) is the forward that
    `entry(model="mobilenet_v2")` returns, params the benchmark's weights
    packed on `device`.  The spec comes from the port's builder on the
    host, whose own weights are dropped."""
    require_port_quantization(cfg, mobilenet_v2)
    q = cfg["quantization"]
    _, spec = build_mobilenet_v2(
        np.random.default_rng(0), width_mult=cfg["depth_multiplier"],
        num_classes=cfg["num_classes"], requant=q["requant"],
        input_size=cfg["input_size"],
        cfg=[tuple(r) for r in cfg["inverted_residual_setting"]],
        stem_channels=cfg["first_layer_channels"],
        head_channels=cfg["last_layer_channels"], device="cpu")
    if len(spec.layers) != len(weights):
        raise ValueError(f"the port's spec has {len(spec.layers)} layers, "
                         f"the benchmark's plan {len(weights)}")
    izp, kzp = q["act_zero_point"], q["kernel_zero_point"]
    params = []
    for (tag, name, layer), raw, wb in zip(spec.layers, spec.raw_weights,
                                           weights):
        if raw is None or wb is None:
            if (raw is None) != (wb is None):
                raise ValueError(f"{name}: weights on one side only")
            params.append(None)
            continue
        kernel, bias = wb
        if kernel.numel() != raw[0].size or kernel.shape[0] != raw[0].shape[0]:
            raise ValueError(f"{name}: kernel {tuple(kernel.shape)}, the "
                             f"port's {raw[0].shape}")
        if tag == "conv" and layer.kind == "gemm":
            params.append(pack_gemm_weights(
                kernel.reshape(kernel.shape[0], -1), bias, izp, kzp,
                device=device))
        else:
            params.append(pack_conv_weights(kernel, bias, izp, kzp,
                                            layer.groups, device=device))

    def forward(params, x):
        return mobilenet_v2_forward(params, spec, x)

    return forward, params
