"""Plain reference of quantized MobileNetV2 as the benchmark runs it.

The layers follow the configuration file (Sandler et al., arXiv:1801.04381,
Table 2): a 3x3 stride-2 stem, the inverted-residual blocks (1x1 expand,
3x3 depthwise, 1x1 linear project, a residual add where stride 1 keeps the
channels), a 1x1 head conv, a global average pool and a fully-connected
classifier.  Padding is TF-slim's "SAME": a stride-2 3x3 layer pads one
row and column after the input, a stride-1 one pads one on each side.
ReLU6 is the requantization clamp [zp, zp + round(6 / scale)].

Each layer is QNNPACK's quantized operator in plain integer arithmetic
(qmath); nothing of the program under test is imported.  Inputs and
outputs are uint8 NHWC images and uint8 logits.
"""

from __future__ import annotations

import torch

from . import qmath


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    return new_v + divisor if new_v < 0.9 * v else new_v


def sample_shape(cfg: dict) -> tuple:
    """Shape of one request: an NHWC uint8 image without the batch axis."""
    return (cfg["input_size"], cfg["input_size"], 3)


def layer_plan(cfg: dict) -> list:
    """The forward as a list of layers, each a dict with `kind` ("conv",
    "dwconv", "gemm", "save", "add", "gap"), `name`, and for a layer with
    weights its kernel shape `kshape` [O, kh, kw, C / groups], `stride`,
    `pads`, the spatial size `h_in` of its input and `h_out` of its
    output, and `relu6`."""
    mult = cfg["depth_multiplier"]
    size = cfg["input_size"]
    plan = []

    def conv(kind, name, cin, cout, k, stride, h, relu6):
        if stride == 2:
            pads = ((0, 1), (0, 1))
        else:
            pads = ((k // 2, k // 2), (k // 2, k // 2))
        groups = cin if kind == "dwconv" else 1
        h_out = qmath.conv_out(h, k, pads[0], stride)
        plan.append(dict(kind=kind, name=name, kshape=(cout, k, k,
                                                       cin // groups),
                         stride=stride, pads=pads, h_in=h, h_out=h_out,
                         relu6=relu6))
        return h_out

    cin = _make_divisible(cfg["first_layer_channels"] * mult)
    h = conv("conv", "stem", 3, cin, 3, 2, size, True)
    for bi, (t, c, n, s) in enumerate(cfg["inverted_residual_setting"]):
        cout = _make_divisible(c * mult)
        for i in range(n):
            stride = s if i == 0 else 1
            prefix = f"block{bi}_{i}"
            residual = stride == 1 and cin == cout
            if residual:
                plan.append(dict(kind="save", name=prefix + "_save"))
            hidden = cin * t
            if t != 1:
                conv("gemm", prefix + "_expand", cin, hidden, 1, 1, h, True)
            h = conv("dwconv", prefix + "_dw", hidden, hidden, 3, stride, h,
                     True)
            conv("gemm", prefix + "_project", hidden, cout, 1, 1, h, False)
            if residual:
                plan.append(dict(kind="add", name=prefix + "_add", h_in=h,
                                 channels=cout))
            cin = cout
    head = _make_divisible(cfg["last_layer_channels"] * max(1.0, mult))
    conv("gemm", "head", cin, head, 1, 1, h, True)
    plan.append(dict(kind="gap", name="gap", h_in=h, channels=head))
    plan.append(dict(kind="gemm", name="fc", kshape=(cfg["num_classes"], 1, 1,
                                                      head),
                     stride=1, pads=((0, 0), (0, 0)), h_in=1, h_out=1,
                     relu6=False))
    return plan


def draw_weights(cfg: dict, generator: torch.Generator, device) -> list:
    """Seeded raw weights: for each layer of `layer_plan` with a kernel,
    (uint8 kernel [O, kh, kw, C / groups], int32 bias [O]), else None.
    Two draws in all (every kernel, then every bias), in the layers' order,
    uniform over [0, 256) and the configuration's bias range."""
    plan = layer_plan(cfg)
    sizes = [torch.Size(l["kshape"]).numel() for l in plan if "kshape" in l]
    outs = [l["kshape"][0] for l in plan if "kshape" in l]
    lo, hi = cfg["quantization"]["bias_range"]
    kernels = torch.randint(0, 256, (sum(sizes),), generator=generator,
                            dtype=torch.uint8, device=device)
    biases = torch.randint(lo, hi, (sum(outs),), generator=generator,
                           dtype=torch.int32, device=device)
    weights, k_at, b_at = [], 0, 0
    for layer in plan:
        if "kshape" not in layer:
            weights.append(None)
            continue
        n, o = torch.Size(layer["kshape"]).numel(), layer["kshape"][0]
        weights.append((kernels[k_at:k_at + n].view(layer["kshape"]),
                        biases[b_at:b_at + o]))
        k_at += n
        b_at += o
    return weights


def forward(cfg: dict, weights: list, x_u8: torch.Tensor,
            weight_bits: int = 8) -> torch.Tensor:
    """uint8 images [B, S, S, 3] -> uint8 logits [B, classes].  With
    `weight_bits` < 8 every kernel is first rounded to that many bits (the
    benchmark's lower-precision control)."""
    q = cfg["quantization"]
    zp, kzp, act = q["act_zero_point"], q["kernel_zero_point"], q["act_scale"]
    scale = q["act_scale"] * q["kernel_scale"] / q["act_scale"]
    top = qmath.relu6_max(act, zp)
    add = qmath.add_params(zp, zp, zp, 1.0, 1.0)
    x, residual = x_u8, None
    for layer, wb in zip(layer_plan(cfg), weights):
        kind = layer["kind"]
        if kind == "save":
            residual = x
            continue
        if kind == "add":
            x = qmath.add_quantize(x, residual, add)
            continue
        if kind == "gap":
            area = layer["h_in"] ** 2
            p = qmath.avgpool_params(-zp * area, 1.0 / area, zp)
            x = qmath.avgpool_quantize(
                x.to(torch.int64).sum(dim=(1, 2)), p)
            continue
        w, bias = wb
        w = qmath.round_weights(w, kzp, weight_bits)
        if kind == "gemm":
            lead = x.shape[:-1]
            acc = qmath.gemm_acc(x.reshape(-1, x.shape[-1]),
                                 w.reshape(w.shape[0], -1), zp, kzp, bias)
            acc = acc.reshape(*lead, w.shape[0])
        elif kind == "dwconv":
            acc = qmath.dwconv2d_acc(x, w, bias, layer["stride"],
                                     layer["pads"], zp, kzp)
        else:
            acc = qmath.conv2d_acc(x, w, bias, layer["stride"],
                                   layer["pads"], zp, kzp)
        lo, hi = (zp, top) if layer["relu6"] else (0, 255)
        x = qmath.requant_fp32(acc, scale, zp, lo, hi)
    return x


def costs(cfg: dict, batch: int) -> list:
    """Per layer of one forward at `batch`: (name, kind, int8 operations,
    bytes), operations = 2 x multiply-accumulates, bytes = the input read
    once, the weights and biases once, the output written once (a residual
    add reads two inputs)."""
    out = []
    for layer in layer_plan(cfg):
        kind, name = layer["kind"], layer["name"]
        if kind == "save":
            continue
        if kind == "add":
            n = batch * layer["h_in"] ** 2 * layer["channels"]
            out.append((name, kind, 0, 3 * n))
            continue
        if kind == "gap":
            c = layer["channels"]
            out.append((name, kind, 0,
                        batch * (layer["h_in"] ** 2 * c + c)))
            continue
        o, kh, kw, cpg = layer["kshape"]
        cin = o if kind == "dwconv" else cpg
        rows = batch * layer["h_out"] ** 2
        macs = rows * o * kh * kw * cpg
        nbytes = (batch * layer["h_in"] ** 2 * cin + o * kh * kw * cpg
                  + 4 * o + rows * o)
        out.append((name, kind, 2 * macs, nbytes))
    return out
