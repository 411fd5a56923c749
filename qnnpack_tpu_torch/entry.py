"""Entry point: the quantized MobileNetV2 1.0_224 forward on the GPU.

The counterpart of the repository's __graft_entry__.entry(): the same seed
(0), the same config (224, fp32 requant) and the same example input, so the
port's forward is comparable byte for byte with the JAX package's."""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models.mobilenet_v2 import build_mobilenet_v2, mobilenet_v2_forward


def entry(device="cuda"):
    """(fn, example_args): fn(params, x) -> uint8 logits [1, 1000]."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    params, spec = build_mobilenet_v2(rng, input_size=224, requant="fp32",
                                      device=dev)
    x = torch.from_numpy(rng.integers(0, 256, (1, 224, 224, 3),
                                      dtype=np.int64).astype(np.uint8)).to(dev)

    def fn(params, x):
        return mobilenet_v2_forward(params, spec, x)

    return fn, (params, x)
