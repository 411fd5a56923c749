"""Model zoo on GraphBuilder: the builders whose every layer runs on a
ported kernel.

A port of qnnpack_tpu/models/zoo.py (QNNPACK's bench/convolution.cc model
table): ResNet-18 (:642) / ResNet-50 (:668), SqueezeNet 1.0 (:539) / 1.1
(:591), MobileNet v1 (:428), ShuffleNet v1 g1-g8 (:108-216), ShuffleNet v2
x0.5-x2.0 (:241-397) and VGG-16 (:720).  Each builder makes the same numpy
RNG calls in the same order as its JAX builder.  All return (params, spec)
with params on `device`; run with graph.graph_forward(params, spec, x) or
graph.GraphModel.  ENet, the zoo's deconv model, is models/enet.py.
"""

from __future__ import annotations

import numpy as np

from .graph import GraphBuilder


def mobilenet_v1(rng: np.random.Generator, *, width_mult: float = 1.0,
                 num_classes: int = 1000, requant: str = "fp32",
                 device="cuda"):
    """MobileNetV1: 13 depthwise-separable stages (bench/convolution.cc:428)."""
    g = GraphBuilder(rng, requant, device=device)

    def d(c):
        return max(8, int(c * width_mult))

    c = g.conv("stem", 3, d(32), strides=(2, 2), padding=((0, 1), (0, 1)))
    plan = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
            (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
            (1024, 1)]
    for i, (cout, s) in enumerate(plan):
        pad = ((0, 1), (0, 1)) if s == 2 else ((1, 1), (1, 1))
        g.conv(f"dw{i}", c, c, strides=(s, s), padding=pad, groups=c)
        c = g.conv(f"pw{i}", c, d(cout), kernel=(1, 1),
                   padding=((0, 0), (0, 0)))
    g.gap("gap", 7)
    g.fc("fc", c, num_classes)
    return g.finish(name=f"mobilenet_v1_{width_mult}", input_size=224)


def _fire(g, idx, cin, squeeze, e1, e3):
    """SqueezeNet fire module: squeeze 1x1 -> expand 1x1 || expand 3x3,
    channel-concatenated."""
    g.conv(f"fire{idx}_squeeze", cin, squeeze, kernel=(1, 1),
           padding=((0, 0), (0, 0)), act="relu")
    g.save(f"f{idx}_sq")
    g.conv(f"fire{idx}_e1", squeeze, e1, kernel=(1, 1),
           padding=((0, 0), (0, 0)), act="relu")
    g.save(f"f{idx}_e1")
    g.load(f"f{idx}_sq")
    g.conv(f"fire{idx}_e3", squeeze, e3, act="relu")
    g.save(f"f{idx}_e3")
    g.concat(f"fire{idx}_cat", [f"f{idx}_e1", f"f{idx}_e3"])
    return e1 + e3


def squeezenet_v11(rng: np.random.Generator, *, num_classes: int = 1000,
                   requant: str = "fp32", device="cuda"):
    """SqueezeNet 1.1 (bench/convolution.cc:591)."""
    g = GraphBuilder(rng, requant, device=device)
    c = g.conv("conv1", 3, 64, strides=(2, 2), padding=((0, 1), (0, 1)),
               act="relu")
    g.maxpool("pool1", (3, 3), (2, 2), ((0, 0), (0, 0)))
    c = _fire(g, 2, c, 16, 64, 64)
    c = _fire(g, 3, c, 16, 64, 64)
    g.maxpool("pool3", (3, 3), (2, 2), ((0, 0), (0, 0)))
    c = _fire(g, 4, c, 32, 128, 128)
    c = _fire(g, 5, c, 32, 128, 128)
    g.maxpool("pool5", (3, 3), (2, 2), ((0, 0), (0, 0)))
    c = _fire(g, 6, c, 48, 192, 192)
    c = _fire(g, 7, c, 48, 192, 192)
    c = _fire(g, 8, c, 64, 256, 256)
    c = _fire(g, 9, c, 64, 256, 256)
    c = g.conv("conv10", c, num_classes, kernel=(1, 1),
               padding=((0, 0), (0, 0)), act="relu")
    g.gap("gap", 13)
    return g.finish(name="squeezenet_v11", input_size=224)


def squeezenet_v10(rng: np.random.Generator, *, num_classes: int = 1000,
                   requant: str = "fp32", device="cuda"):
    """SqueezeNet 1.0 (bench/convolution.cc:539): 7x7/96 stem and the
    original fire/pool placement."""
    g = GraphBuilder(rng, requant, device=device)
    c = g.conv("conv1", 3, 96, kernel=(7, 7), strides=(2, 2),
               padding=((2, 3), (2, 3)), act="relu")
    g.maxpool("pool1", (3, 3), (2, 2), ((0, 0), (0, 0)))
    c = _fire(g, 2, c, 16, 64, 64)
    c = _fire(g, 3, c, 16, 64, 64)
    c = _fire(g, 4, c, 32, 128, 128)
    g.maxpool("pool4", (3, 3), (2, 2), ((0, 0), (0, 0)))
    c = _fire(g, 5, c, 32, 128, 128)
    c = _fire(g, 6, c, 48, 192, 192)
    c = _fire(g, 7, c, 48, 192, 192)
    c = _fire(g, 8, c, 64, 256, 256)
    g.maxpool("pool8", (3, 3), (2, 2), ((0, 0), (0, 0)))
    c = _fire(g, 9, c, 64, 256, 256)
    c = g.conv("conv10", c, num_classes, kernel=(1, 1),
               padding=((0, 0), (0, 0)), act="relu")
    g.gap("gap", 13)
    return g.finish(name="squeezenet_v10", input_size=224)


def _shortcut(g, name, cin, cout, stride):
    """Save the block's shortcut: a 1x1 projection (a conv when strided)
    where the shape changes, else the input itself."""
    if stride != 1 or cin != cout:
        g.save(f"{name}_in")
        g.conv(f"{name}_proj", cin, cout, kernel=(1, 1),
               strides=(stride, stride), padding=((0, 0), (0, 0)),
               act="linear")
        g.save(f"{name}_short")
        g.load(f"{name}_in")
    else:
        g.save(f"{name}_short")


def _basic_block(g, name, cin, cout, stride):
    """ResNet basic block: two 3x3 convs + shortcut."""
    _shortcut(g, name, cin, cout, stride)
    pad = ((0, 1), (0, 1)) if stride == 2 else ((1, 1), (1, 1))
    g.conv(f"{name}_a", cin, cout, strides=(stride, stride), padding=pad,
           act="relu")
    g.conv(f"{name}_b", cout, cout, act="linear")
    g.add(f"{name}_add", f"{name}_short")
    return cout


def _bottleneck(g, name, cin, mid, cout, stride):
    """ResNet bottleneck: 1x1 -> 3x3 -> 1x1 + shortcut."""
    _shortcut(g, name, cin, cout, stride)
    g.conv(f"{name}_a", cin, mid, kernel=(1, 1), padding=((0, 0), (0, 0)),
           act="relu")
    pad = ((0, 1), (0, 1)) if stride == 2 else ((1, 1), (1, 1))
    g.conv(f"{name}_b", mid, mid, strides=(stride, stride), padding=pad,
           act="relu")
    g.conv(f"{name}_c", mid, cout, kernel=(1, 1), padding=((0, 0), (0, 0)),
           act="linear")
    g.add(f"{name}_add", f"{name}_short")
    return cout


def resnet18(rng: np.random.Generator, *, num_classes: int = 1000,
             requant: str = "fp32", device="cuda"):
    """ResNet-18 (bench/convolution.cc:642)."""
    g = GraphBuilder(rng, requant, device=device)
    c = g.conv("stem", 3, 64, kernel=(7, 7), strides=(2, 2),
               padding=((2, 3), (2, 3)), act="relu")
    g.maxpool("pool1", (3, 3), (2, 2), ((0, 1), (0, 1)))
    for stage, (cout, blocks, stride) in enumerate(
            [(64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2)]):
        for i in range(blocks):
            c = _basic_block(g, f"s{stage}b{i}", c, cout,
                             stride if i == 0 else 1)
    g.gap("gap", 7)
    g.fc("fc", c, num_classes)
    return g.finish(name="resnet18", input_size=224)


def resnet50(rng: np.random.Generator, *, num_classes: int = 1000,
             requant: str = "fp32", device="cuda"):
    """ResNet-50 (bench/convolution.cc:668)."""
    g = GraphBuilder(rng, requant, device=device)
    c = g.conv("stem", 3, 64, kernel=(7, 7), strides=(2, 2),
               padding=((2, 3), (2, 3)), act="relu")
    g.maxpool("pool1", (3, 3), (2, 2), ((0, 1), (0, 1)))
    for stage, (mid, blocks, stride) in enumerate(
            [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]):
        for i in range(blocks):
            c = _bottleneck(g, f"s{stage}b{i}", c, mid, mid * 4,
                            stride if i == 0 else 1)
    g.gap("gap", 7)
    g.fc("fc", c, num_classes)
    return g.finish(name="resnet50", input_size=224)


SHUFFLENET_V2_CHANNELS = {
    0.5: (24, 48, 96, 192, 1024),
    1.0: (24, 116, 232, 464, 1024),
    1.5: (24, 176, 352, 704, 1024),
    2.0: (24, 244, 488, 976, 2048),
}


def shufflenet_v2(rng: np.random.Generator, *, width: float = 1.0,
                  num_classes: int = 1000, requant: str = "fp32",
                  device="cuda"):
    """ShuffleNet v2 (bench/convolution.cc:241-397): channel split,
    dw-separable right branch, concat, shuffle."""
    g = GraphBuilder(rng, requant, device=device)
    stem, c2, c3, c4, head = SHUFFLENET_V2_CHANNELS[width]
    c = g.conv("stem", 3, stem, strides=(2, 2), padding=((0, 1), (0, 1)),
               act="relu")
    g.maxpool("pool1", (3, 3), (2, 2), ((0, 1), (0, 1)))

    def unit_s1(name, c):
        half = c // 2
        g.split(f"{name}_split", f"{name}_left", half)
        g.conv(f"{name}_pw1", half, half, kernel=(1, 1),
               padding=((0, 0), (0, 0)), act="relu")
        g.conv(f"{name}_dw", half, half, groups=half, act="linear")
        g.conv(f"{name}_pw2", half, half, kernel=(1, 1),
               padding=((0, 0), (0, 0)), act="relu")
        g.save(f"{name}_right")
        g.concat(f"{name}_cat", [f"{name}_left", f"{name}_right"])
        g.shuffle(f"{name}_shuf", 2)
        return c

    def unit_s2(name, cin, cout):
        half = cout // 2
        g.save(f"{name}_in")
        # left branch: dw s2 + pw
        g.conv(f"{name}_ldw", cin, cin, strides=(2, 2),
               padding=((0, 1), (0, 1)), groups=cin, act="linear")
        g.conv(f"{name}_lpw", cin, half, kernel=(1, 1),
               padding=((0, 0), (0, 0)), act="relu")
        g.save(f"{name}_left")
        g.load(f"{name}_in")
        # right branch: pw + dw s2 + pw
        g.conv(f"{name}_rpw1", cin, half, kernel=(1, 1),
               padding=((0, 0), (0, 0)), act="relu")
        g.conv(f"{name}_rdw", half, half, strides=(2, 2),
               padding=((0, 1), (0, 1)), groups=half, act="linear")
        g.conv(f"{name}_rpw2", half, half, kernel=(1, 1),
               padding=((0, 0), (0, 0)), act="relu")
        g.save(f"{name}_right")
        g.concat(f"{name}_cat", [f"{name}_left", f"{name}_right"])
        g.shuffle(f"{name}_shuf", 2)
        return cout

    for stage, (cout, repeats) in enumerate([(c2, 4), (c3, 8), (c4, 4)]):
        c = unit_s2(f"st{stage}u0", c, cout)
        for i in range(1, repeats):
            c = unit_s1(f"st{stage}u{i}", c)
    c = g.conv("head", c, head, kernel=(1, 1), padding=((0, 0), (0, 0)),
               act="relu")
    g.gap("gap", 7)
    g.fc("fc", c, num_classes)
    return g.finish(name=f"shufflenet_v2_x{width}", input_size=224)


def shufflenet_v1(rng: np.random.Generator, *, groups: int = 3,
                  num_classes: int = 1000, requant: str = "fp32",
                  device="cuda"):
    """ShuffleNet v1 with configurable groups (bench/convolution.cc:108-216):
    grouped 1x1 convs + channel shuffle + residual/concat units."""
    stage_channels = {1: 144, 2: 200, 3: 240, 4: 272, 8: 384}[groups]
    g = GraphBuilder(rng, requant, device=device)
    c = g.conv("stem", 3, 24, strides=(2, 2), padding=((0, 1), (0, 1)),
               act="relu")
    g.maxpool("pool1", (3, 3), (2, 2), ((0, 1), (0, 1)))

    def unit(name, cin, cout, stride, first_unit=False):
        mid = cout // 4
        grp = 1 if first_unit else groups
        g.save(f"{name}_in")
        if stride == 2:
            # shortcut: 3x3 avgpool s2 on input
            g.conv(f"{name}_g1", cin, mid, kernel=(1, 1),
                   padding=((0, 0), (0, 0)), groups=grp, act="relu")
            if not first_unit:
                g.shuffle(f"{name}_shuf", groups)
            g.conv(f"{name}_dw", mid, mid, strides=(2, 2),
                   padding=((0, 1), (0, 1)), groups=mid, act="linear")
            g.conv(f"{name}_g2", mid, cout - cin, kernel=(1, 1),
                   padding=((0, 0), (0, 0)), groups=groups, act="linear")
            g.save(f"{name}_main")
            g.load(f"{name}_in")
            g.avgpool(f"{name}_short", (3, 3), (2, 2), ((0, 1), (0, 1)))
            g.save(f"{name}_sc")
            g.concat(f"{name}_cat", [f"{name}_sc", f"{name}_main"])
            return cout
        g.conv(f"{name}_g1", cin, mid, kernel=(1, 1), padding=((0, 0), (0, 0)),
               groups=grp, act="relu")
        g.shuffle(f"{name}_shuf", groups)
        g.conv(f"{name}_dw", mid, mid, padding=((1, 1), (1, 1)), groups=mid,
               act="linear")
        g.conv(f"{name}_g2", mid, cout, kernel=(1, 1), padding=((0, 0), (0, 0)),
               groups=groups, act="linear")
        g.add(f"{name}_add", f"{name}_in")
        return cout

    for stage, repeats in enumerate([4, 8, 4]):
        cout = stage_channels * (2 ** stage)
        c = unit(f"st{stage}u0", c, cout, 2, first_unit=(stage == 0))
        for i in range(1, repeats):
            c = unit(f"st{stage}u{i}", c, cout, 1)
    g.gap("gap", 7)
    g.fc("fc", c, num_classes)
    return g.finish(name=f"shufflenet_v1_g{groups}", input_size=224)


def vgg16(rng: np.random.Generator, *, num_classes: int = 1000,
          requant: str = "fp32", device="cuda"):
    """VGG-16 (bench/convolution.cc:720 layer sweep)."""
    g = GraphBuilder(rng, requant, device=device)
    c = 3
    for stage, (cout, convs) in enumerate(
            [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]):
        for i in range(convs):
            c = g.conv(f"s{stage}c{i}", c, cout, act="relu")
        g.maxpool(f"pool{stage}", (2, 2), (2, 2), ((0, 0), (0, 0)))
    # FC head over the flattened 7x7x512.
    g._emit("flatten", "flatten", None)
    c = g.fc("fc6", 7 * 7 * 512, 4096, act="relu")
    c = g.fc("fc7", c, 4096, act="relu")
    g.fc("fc8", c, num_classes)
    return g.finish(name="vgg16", input_size=224)
