"""Entry point: a quantized forward on the GPU.

The counterpart of the repository's __graft_entry__.entry(): the same seed
(0), the same config (fp32 requant) and the same example input, drawn from
the builder's RNG after the weights, so the port's forward is comparable
byte for byte with the JAX package's.  model="mobilenet_v2" (the default)
is MobileNetV2 1.0_224; model="resnet18" is the zoo's ResNet-18 and
model="shufflenet_v1_g3" its ShuffleNet v1 with 3 groups, both through the
graph runtime at 224; model="enet_seg" is the ENet-style segmentation
net (models/enet.py: 12 classes, its three 2x2 stride-2 deconvs on the
upsample path) at 256; model="bert_base_s128" is the int8 BERT-base
encoder (12 layers, hidden 768, 12 heads, FFN 3072, sequence 128);
model="mimo_v2_flash" is MiMo-V2-Flash's hybrid block at its published
widths (models/mimo_v2_flash.py: layers 0-6, one GPU's 8 of 256 routed
experts, sequence 8,192).  Each other model is built as bench_models.py
builds it.

The returned fn runs eagerly, as the JAX entry returns a function for the
caller to jit: `ops.base.jit_forward(fn)` captures it, one CUDA graph per
input shape (and per set of params), and replays it."""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models import zoo
from .models.bert import BertConfig, bert_encoder_forward, build_bert_encoder
from .models.enet import enet_seg
from .models.graph import graph_forward
from .models.mimo_v2_flash import MimoConfig, build_mimo, mimo_forward
from .models.mobilenet_v2 import build_mobilenet_v2, mobilenet_v2_forward

MODELS = ("mobilenet_v2", "resnet18", "shufflenet_v1_g3", "enet_seg",
          "bert_base_s128", "mimo_v2_flash")


def input_shape(model: str) -> tuple:
    """Shape of one sample of `model`'s input (without the batch axis)."""
    if model == "bert_base_s128":
        return (128, 768)
    if model == "mimo_v2_flash":
        cfg = MimoConfig()
        return (cfg.seq_len, cfg.hidden)
    return (256, 256, 3) if model == "enet_seg" else (224, 224, 3)


def entry(device="cuda", model="mobilenet_v2"):
    """(fn, example_args): fn(params, x) -> the model's uint8 output for
    the example input x: logits [1, 1000] for the classifiers (x uint8
    [1, 224, 224, 3]), per-pixel logits [1, 256, 256, 12] for ENet (x
    uint8 [1, 256, 256, 3]), hidden states [1, 128, 768] for BERT (x uint8
    [1, 128, 768]) and [1, 8192, 4096] for MiMo-V2-Flash.  fn.spec is the
    model's static spec."""
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
    elif model == "enet_seg":
        params, spec = enet_seg(rng, input_size=256, device=dev)
        forward = graph_forward
    elif model == "bert_base_s128":
        params, spec = build_bert_encoder(
            rng, BertConfig(layers=12, hidden=768, heads=12, ffn=3072,
                            seq_len=128, requant="fp32"), device=dev)
        forward = bert_encoder_forward
    elif model == "mimo_v2_flash":
        params, spec = build_mimo(rng, MimoConfig(), device=dev)
        forward = mimo_forward
    else:
        raise ValueError(f"unknown model {model!r}; expected one of {MODELS}")
    x = torch.from_numpy(rng.integers(0, 256, (1,) + input_shape(model),
                                      dtype=np.int64).astype(np.uint8)).to(dev)

    def fn(params, x):
        return forward(params, spec, x)

    fn.spec = spec
    return fn, (params, x)
