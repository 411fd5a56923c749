"""Graph builder/executor for quantized model assembly.

A port of qnnpack_tpu/models/graph.py: a layer-list IR (inference only)
that the model zoo builds against.  The builder makes the same numpy RNG
calls in the same order as the JAX builder, so one seed gives the same raw
weights, layer specs and requant params.  Tags run here:

    conv     dense, grouped or depthwise conv (nn.conv.q8conv2d: q8stem,
             q8conv or q8dwconv kernel); a conv whose record is GEMM
             weights (an imported 1x1, stride-1, unpadded dense conv,
             `is_gemm_conv`) runs nn.gemm.q8gemm: q8gemm kernel
    deconv   transposed conv (nn.conv.q8deconv2d: q8gemm or q8conv
             launches on the record's DeconvPlan, and a depth-to-space or
             interleaving copy)
    gemm     1x1-conv / fully-connected (nn.gemm.q8gemm: q8gemm kernel)
    maxpool  (nn.pool.u8maxpool2d: u8maxpool kernel)
    avgpool  (nn.pool.q8avgpool2d: q8avgpool kernel)
    gap      (nn.pool.q8gavgpool: q8gavgpool kernel)
    add      residual add against a saved slot (q8vadd kernel)
    shuffle  channel shuffle (nn.elementwise.x8zip, a PyTorch copy)
    lut      byte-wise table lookup (nn.elementwise.x8lut, a PyTorch index)
    softargmax  (nn.elementwise.u8softargmax: u8rmax and u8lut32norm
             kernels)
    save / load / concat / split / flatten / pad   data movement

`graph_forward` keeps the JAX executor's one peephole: a concat of g
equal-width slots followed by shuffle(g) is one interleaving copy.  A
deconv layer's plan (nn/conv.py:deconv_plan) is built with its record, by
the builder and by params_from_jax, so a forward only launches.

GraphBuilder's activations share one synthetic quantization (scale 0.1,
zp 128), so its adds and concats need no rescale; a graph imported by
io/tflite_import.py carries each layer's own zero points, add rescales and
per-channel scales.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..kernels.vpu_ops import q8vadd_cuda
from ..nn.conv import (PackedConvWeights, deconv_plan, pack_conv_weights,
                       q8conv2d, q8deconv2d)
from ..nn.elementwise import (build_softargmax_lut, lut32_tensor,
                              u8softargmax, x8lut, x8zip)
from ..nn.gemm import q8gemm
from ..nn.packing import PackedGemmWeights, as_tensor, pack_gemm_weights
from ..nn.pool import q8avgpool2d, q8gavgpool, u8maxpool2d
from ..nn.requant_dispatch import make_requant_params
from ..quant.params import compute_add_quant_params, compute_avgpool_quant_params

ACT_SCALE = 0.1
ACT_ZP = 128
KERNEL_SCALE = 0.02
KERNEL_ZP = 128


@dataclasses.dataclass
class ConvSpec:
    kind: str  # "conv" | "gemm" | "deconv"
    strides: tuple
    padding: tuple
    groups: int
    rparams: Any


def is_gemm_conv(spec: ConvSpec, kernel_height: int,
                 kernel_width: int) -> bool:
    """Whether a `conv` layer is QNNPACK's gemm ukernel type
    (src/convolution.c:180-189): 1x1, stride 1, unpadded, ungrouped."""
    return (spec.kind == "conv" and spec.groups == 1
            and (kernel_height, kernel_width) == (1, 1)
            and tuple(spec.strides) == (1, 1)
            and all(tuple(p) == (0, 0) for p in spec.padding))


@dataclasses.dataclass
class GraphSpec:
    layers: list
    raw_weights: list
    meta: dict


class GraphBuilder:
    """Accumulates (layers, params) for graph_forward; packs on `device`."""

    def __init__(self, rng: np.random.Generator, requant: str = "fp32", *,
                 device="cuda"):
        self.rng = rng
        self.requant = requant
        self.device = resolve_device(device)
        self.layers = []
        self.params = []
        self.raw = []

    # -- weight synthesis -------------------------------------------------
    def _kernel(self, o, kh, kw, i):
        return self.rng.integers(0, 256, (o, kh, kw, i),
                                 dtype=np.int64).astype(np.uint8)

    def _bias(self, o):
        return self.rng.integers(-8000, 8000, (o,),
                                 dtype=np.int64).astype(np.int32)

    def _emit(self, tag, name, payload, packed=None, raw=None):
        self.layers.append((tag, name, payload))
        self.params.append(packed)
        self.raw.append(raw)

    def _rparams(self, act: str):
        """act: "relu6" | "relu" | "linear" -> requant clamp window."""
        omin, omax = 0, 255
        if act == "relu6":
            omax = min(255, ACT_ZP + int(round(6.0 / ACT_SCALE)))
            omin = ACT_ZP
        elif act == "relu":
            omin = ACT_ZP
        scale = ACT_SCALE * KERNEL_SCALE / ACT_SCALE
        return make_requant_params(self.requant, scale, ACT_ZP, omin, omax)

    # -- layers -----------------------------------------------------------
    def conv(self, name, cin, cout, kernel=(3, 3), strides=(1, 1),
             padding=((1, 1), (1, 1)), groups=1, act="relu6"):
        kh, kw = kernel
        rp = self._rparams(act)
        k = self._kernel(cout, kh, kw, cin // groups)
        b = self._bias(cout)
        if (kh, kw) == (1, 1) and strides == (1, 1) and groups == 1:
            packed = pack_gemm_weights(k.reshape(cout, cin), b, ACT_ZP,
                                       KERNEL_ZP, device=self.device)
            self._emit("gemm", name, ConvSpec("gemm", strides, padding, 1, rp),
                       packed, (k, b))
        else:
            packed = pack_conv_weights(k, b, ACT_ZP, KERNEL_ZP, groups,
                                       device=self.device)
            self._emit("conv", name,
                       ConvSpec("conv", strides, padding, groups, rp),
                       packed, (k, b))
        return cout

    def deconv(self, name, cin, cout, kernel=(2, 2), strides=(2, 2),
               padding=((0, 0), (0, 0)), adjustment=(0, 0), groups=1,
               act="relu"):
        kh, kw = kernel
        k = self._kernel(cout, kh, kw, cin // groups)
        b = self._bias(cout)
        packed = pack_conv_weights(k, b, ACT_ZP, KERNEL_ZP, groups,
                                   transposed=True, device=self.device)
        cs = ConvSpec("deconv", strides, padding, groups, self._rparams(act))
        deconv_plan(packed, cs.rparams, strides, padding, adjustment)
        self._emit("deconv", name, (cs, adjustment), packed, (k, b))
        return cout

    def fc(self, name, cin, cout, act="linear"):
        k = self.rng.integers(0, 256, (cout, cin),
                              dtype=np.int64).astype(np.uint8)
        b = self._bias(cout)
        packed = pack_gemm_weights(k, b, ACT_ZP, KERNEL_ZP, device=self.device)
        self._emit("gemm", name,
                   ConvSpec("gemm", (1, 1), ((0, 0), (0, 0)), 1,
                            self._rparams(act)), packed, (k, b))
        return cout

    def maxpool(self, name, pool=(3, 3), strides=(2, 2),
                padding=((1, 1), (1, 1))):
        self._emit("maxpool", name, (pool, strides, padding))

    def avgpool(self, name, pool, strides=None, padding=((0, 0), (0, 0))):
        ph, pw = pool
        qp = compute_avgpool_quant_params(
            -ACT_ZP * ph * pw, 1.0 / (ph * pw), ACT_ZP,
            input_zero_point=ACT_ZP)
        self._emit("avgpool", name,
                   (qp, pool, strides if strides else pool, padding))

    def gap(self, name, spatial):
        qp = compute_avgpool_quant_params(
            -ACT_ZP * spatial * spatial, 1.0 / (spatial * spatial), ACT_ZP,
            input_zero_point=ACT_ZP)
        self._emit("gap", name, qp)

    def save(self, slot):
        self._emit("save", f"save_{slot}", slot)

    def load(self, slot):
        """Resume the flow from a saved slot."""
        self._emit("load", f"load_{slot}", slot)

    def add(self, name, slot):
        self._emit("add", name,
                   (slot, compute_add_quant_params(ACT_ZP, ACT_ZP, ACT_ZP,
                                                   1.0, 1.0)))

    def concat(self, name, slots):
        """Concatenate saved slots (in order) along channels."""
        self._emit("concat", name, tuple(slots))

    def split(self, name, slot, channels):
        """First `channels` channels -> slot; rest keeps flowing."""
        self._emit("split", name, (slot, channels))

    def shuffle(self, name, groups):
        self._emit("shuffle", name, groups)

    def softargmax(self, name, channels, input_scale=ACT_SCALE):
        self._emit("softargmax", name, lut32_tensor(
            build_softargmax_lut(input_scale, channels), self.device))

    def finish(self, **meta):
        spec = GraphSpec(layers=self.layers, raw_weights=self.raw, meta=meta)
        return self.params, spec


def graph_forward(params, spec: GraphSpec, x_u8):
    """Execute a GraphSpec: uint8 NHWC in, the last layer's uint8 out.

    A `concat` of g equal-width slots followed by `shuffle(g)` is a channel
    interleave of the slots, run as one stack + reshape: the same bytes as
    the pair (the JAX executor's peephole; ShuffleNet v2's unit tail)."""
    x = x_u8
    env = {}
    layers = spec.layers
    i = 0
    while i < len(layers):
        tag, _, payload = layers[i]
        if (tag == "concat" and i + 1 < len(layers)
                and layers[i + 1][0] == "shuffle"
                and layers[i + 1][2] == len(payload)
                and len({env[s].shape[-1] for s in payload}) == 1):
            parts = [env[s] for s in payload]
            x = torch.stack(parts, dim=-1).reshape(
                *parts[0].shape[:-1], len(parts) * parts[0].shape[-1])
            i += 2
            continue
        x = _graph_layer(tag, payload, params[i], x, env)
        i += 1
    return x


def _graph_layer(tag, payload, p, x, env):
    if tag == "save":
        env[payload] = x
    elif tag == "load":
        x = env[payload]
    elif tag == "add":
        slot, qp = payload
        x = q8vadd_cuda(x, env[slot], qp)
    elif tag == "concat":
        x = torch.cat([env[s] for s in payload], dim=-1)
    elif tag == "split":
        # Both halves contiguous: the kernels take contiguous tensors.
        slot, c = payload
        env[slot] = x[..., :c].contiguous()
        x = x[..., c:].contiguous()
    elif tag == "shuffle":
        x = x8zip(x, payload)
    elif tag == "maxpool":
        pool, strides, padding = payload
        x = u8maxpool2d(x, pool, strides, padding)
    elif tag == "avgpool":
        qp, pool, strides, padding = payload
        x = q8avgpool2d(x, qp, pool, strides, padding)
    elif tag == "gap":
        b, h, w, c = x.shape
        x = q8gavgpool(x.reshape(b, h * w, c), payload, axis=1)
    elif tag == "gemm":
        x = q8gemm(x, p, payload.rparams)
    elif tag == "conv":
        if isinstance(p, PackedGemmWeights):
            x = q8gemm(x, p, payload.rparams)
        else:
            x = q8conv2d(x, p, payload.rparams, payload.strides,
                         payload.padding)
    elif tag == "deconv":
        cs, adjustment = payload
        x = q8deconv2d(x, p, cs.rparams, cs.strides, cs.padding, adjustment)
    elif tag == "flatten":
        x = x.reshape(x.shape[0], -1)
    elif tag == "pad":
        # Spatial constant pad with the tensor's zero point.
        (pt, pb), (pl_, pr), zp = payload
        x = F.pad(x, (0, 0, pl_, pr, pt, pb), value=zp)
    elif tag == "lut":
        # Per-element byte map (x8lut): QUANTIZE rescales, sigmoid, ...
        x = x8lut(x, payload)
    elif tag == "softargmax":
        x = u8softargmax(x, payload)
    else:
        raise ValueError(f"unknown tag {tag!r}")
    return x


class GraphModel(nn.Module):
    """graph_forward as a module around packed params and a GraphSpec.

    The packed records are dataclasses of tensors, not nn.Parameters: build
    them on the device the model runs on."""

    def __init__(self, params, spec: GraphSpec):
        super().__init__()
        self.params = params
        self.spec = spec

    def forward(self, x_u8: torch.Tensor) -> torch.Tensor:
        return graph_forward(self.params, self.spec, x_u8)


def _field(record, name):
    return record[name] if isinstance(record, Mapping) else getattr(record, name)


def _jax_fields(record):
    """(kernel dims without O, O, input zero point, kernel zero point) from
    a JAX packed record's own fields: `k`, `n` of a GEMM record, the conv
    shape of a conv record."""
    izp = int(_field(record, "input_zero_point"))
    kzp = int(_field(record, "kernel_zero_point"))
    try:
        return (int(_field(record, "k")),), int(_field(record, "n")), izp, kzp
    except (AttributeError, KeyError):
        dims = tuple(int(_field(record, f)) for f in (
            "kernel_height", "kernel_width", "group_input_channels"))
        o = int(_field(record, "group_output_channels")) * int(
            _field(record, "groups"))
        return dims, o, izp, kzp


def packed_from_jax(name, record, kernel=None, *, gemm: bool, groups: int,
                    device):
    """One of the port's packed records from a JAX packed record.

    `record` holds numpy `w` and `bias_folded` (as attributes or keys).
    `kernel` is the layer's raw uint8 kernel [O, ...], which gives the
    expected shapes (w [K, O] for a GEMM, [Kh, Kw, Icpg, O] for a conv)
    under GraphBuilder's zero points ACT_ZP and KERNEL_ZP.  Without it (an
    imported graph keeps no raw weights) the shapes and zero points come
    from the record's own fields; a 1x1 conv record taken as GEMM weights
    (`gemm`, `is_gemm_conv`) gives w [Icpg, O]."""
    w = np.asarray(_field(record, "w"))
    bias = np.asarray(_field(record, "bias_folded"))
    if kernel is not None:
        dims, o = tuple(kernel.shape[1:]), kernel.shape[0]
        izp, kzp = ACT_ZP, KERNEL_ZP
    else:
        dims, o, izp, kzp = _jax_fields(record)
        if gemm and w.ndim == 4 and w.shape[:2] == (1, 1):
            w = w.reshape(-1, w.shape[-1])
    want = (int(np.prod(dims)), o) if gemm else dims + (o,)
    if w.shape != want or w.dtype != np.int8:
        raise ValueError(f"{name}: w {w.shape} {w.dtype}, want {want} int8")
    if bias.shape != (o,) or bias.dtype != np.int32:
        raise ValueError(f"{name}: bias_folded {bias.shape} {bias.dtype}, "
                         f"want ({o},) int32")
    w_t = as_tensor(w, torch.int8, device).contiguous()
    b_t = as_tensor(bias, torch.int32, device)
    if gemm:
        return PackedGemmWeights(
            w=w_t, bias_folded=b_t, k=want[0], n=o, input_zero_point=izp,
            kernel_zero_point=kzp)
    kh, kw, icpg = dims
    return PackedConvWeights(
        w=w_t, bias_folded=b_t, kernel_height=kh, kernel_width=kw,
        group_input_channels=icpg, group_output_channels=o // groups,
        groups=groups, input_zero_point=izp, kernel_zero_point=kzp)


def params_from_jax(arrays, spec: GraphSpec, *, device="cuda"):
    """The port's packed records from the JAX package's packed graph params.

    `arrays` is the JAX params list with numpy leaves (or None for
    weightless layers); `spec` is the port's spec of the same graph.  A
    layer without raw weights in `spec` (an imported graph) takes its
    shapes and zero points from its record, and an imported 1x1 conv
    becomes GEMM weights, as io/tflite_import.py packs it.  A deconv
    record is flipped already (packed transposed) and is taken as it is;
    its plan is built from the spec's geometry."""
    dev = resolve_device(device)
    if len(arrays) != len(spec.layers):
        raise ValueError(f"{len(arrays)} records for {len(spec.layers)} layers")
    out = []
    for (tag, name, payload), rec, raw in zip(spec.layers, arrays,
                                              spec.raw_weights):
        if rec is None or tag not in ("conv", "gemm", "deconv"):
            if rec is not None:
                raise ValueError(f"{name}: weightless layer got a record")
            if raw is not None:
                raise ValueError(f"{name}: layer with weights got no record")
            out.append(None)
            continue
        if raw is not None:
            kernel, gemm = raw[0], tag == "gemm"
        else:
            kernel = None
            gemm = tag == "gemm" or (tag == "conv" and is_gemm_conv(
                payload, int(_field(rec, "kernel_height")),
                int(_field(rec, "kernel_width"))))
        cs = payload[0] if tag == "deconv" else payload
        packed = packed_from_jax(name, rec, kernel, gemm=gemm,
                                 groups=cs.groups, device=dev)
        if tag == "deconv":
            deconv_plan(packed, cs.rparams, cs.strides, cs.padding,
                        payload[1])
        out.append(packed)
    return out
