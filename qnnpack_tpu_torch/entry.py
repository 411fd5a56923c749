"""Entry point: a quantized 224 forward on the GPU.

The counterpart of the repository's __graft_entry__.entry(): the same seed
(0), the same config (224, fp32 requant) and the same example input, drawn
from the builder's RNG after the weights, so the port's forward is
comparable byte for byte with the JAX package's.  model="mobilenet_v2"
(the default) is MobileNetV2 1.0_224; model="resnet18" is the zoo's
ResNet-18 and model="shufflenet_v1_g3" its ShuffleNet v1 with 3 groups,
both through the graph runtime, as bench_models.py builds them."""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models import zoo
from .models.graph import graph_forward
from .models.mobilenet_v2 import build_mobilenet_v2, mobilenet_v2_forward

MODELS = ("mobilenet_v2", "resnet18", "shufflenet_v1_g3")


def entry(device="cuda", model="mobilenet_v2"):
    """(fn, example_args): fn(params, x) -> uint8 logits [1, 1000];
    fn.spec is the model's static spec."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    if model == "mobilenet_v2":
        params, spec = build_mobilenet_v2(rng, input_size=224, requant="fp32",
                                          device=dev)
        forward = mobilenet_v2_forward
    elif model == "resnet18":
        params, spec = zoo.resnet18(rng, requant="fp32", device=dev)
        forward = graph_forward
    elif model == "shufflenet_v1_g3":
        params, spec = zoo.shufflenet_v1(rng, groups=3, requant="fp32",
                                         device=dev)
        forward = graph_forward
    else:
        raise ValueError(f"unknown model {model!r}; expected one of {MODELS}")
    x = torch.from_numpy(rng.integers(0, 256, (1, 224, 224, 3),
                                      dtype=np.int64).astype(np.uint8)).to(dev)

    def fn(params, x):
        return forward(params, spec, x)

    fn.spec = spec
    return fn, (params, x)
