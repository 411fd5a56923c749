"""ENet-style quantized segmentation net: a port of
qnnpack_tpu/models/enet.py (BASELINE.json's deconv configuration,
"Quantized deconvolution segmentation net").

Encoder-decoder with QNNPACK's deconvolution operator on the upsample path
(src/deconvolution.c; here nn/conv.py:q8deconv2d, whose k == s lowering
runs each 2x2 stride-2 deconv as one q8gemm launch and a depth-to-space
copy).  Reduced ENet shape: initial downsample, two encoder stages of
bottlenecks, two deconv upsample stages, and a final full-resolution
deconv classifier.  The builder makes the JAX builder's RNG calls in the
same order, so one seed gives the same raw weights.
"""

from __future__ import annotations

import numpy as np

from .graph import GraphBuilder


def enet_seg(rng: np.random.Generator, *, num_classes: int = 12,
             input_size: int = 256, requant: str = "fp32", device="cuda"):
    g = GraphBuilder(rng, requant, device=device)
    # initial block: 3x3 s2 conv (13ch) concat maxpool(3ch) -> 16ch analogue;
    # simplified to a 16-channel strided conv.
    c = g.conv("initial", 3, 16, strides=(2, 2), padding=((0, 1), (0, 1)),
               act="relu")

    def bottleneck(name, cin, cout, stride=1):
        has_res = stride == 1 and cin == cout
        if has_res:
            g.save(f"{name}_in")
        mid = max(cout // 4, 8)
        g.conv(f"{name}_a", cin, mid, kernel=(1, 1) if stride == 1 else (2, 2),
               strides=(stride, stride),
               padding=((0, 0), (0, 0)), act="relu")
        g.conv(f"{name}_b", mid, mid, padding=((1, 1), (1, 1)), act="relu")
        g.conv(f"{name}_c", mid, cout, kernel=(1, 1), padding=((0, 0), (0, 0)),
               act="linear")
        if has_res:
            g.add(f"{name}_add", f"{name}_in")
        return cout

    c = bottleneck("enc1_0", c, 64, stride=2)
    for i in range(1, 4):
        c = bottleneck(f"enc1_{i}", c, 64)
    c = bottleneck("enc2_0", c, 128, stride=2)
    for i in range(1, 3):
        c = bottleneck(f"enc2_{i}", c, 128)

    # decoder: deconv upsample x2, bottleneck, deconv x2, final deconv to
    # full resolution logits.
    c = g.deconv("dec1_up", c, 64, kernel=(2, 2), strides=(2, 2), act="relu")
    c = bottleneck("dec1_b", c, 64)
    c = g.deconv("dec2_up", c, 16, kernel=(2, 2), strides=(2, 2), act="relu")
    c = bottleneck("dec2_b", c, 16)
    g.deconv("classifier", c, num_classes, kernel=(2, 2), strides=(2, 2),
             act="linear")
    return g.finish(name="enet_seg", input_size=input_size,
                    num_classes=num_classes)
