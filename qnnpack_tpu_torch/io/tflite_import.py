"""TFLite flatbuffer importer: quantized checkpoints -> the port's packed
graphs.  A port of qnnpack_tpu/io/tflite_import.py.

The file is read by a flatbuffer table reader of this module's own
(`struct` and `np.frombuffer` over the few table operations the schema
subset needs), so the port needs no `flatbuffers` package.  `parse_tflite`
returns the same records as the JAX package's; `import_tflite` maps each
operator onto the port's packed records and models/graph.py tags, and
builds the records and tables on `device`.

Quantization-domain mapping (TFLite full-integer PTQ is int8-centric;
the framework is uint8-centric like QNNPACK):
  - int8 tensor t with zero point z  ->  uint8 tensor t + 128, zero point
    z + 128 (a bijection on the represented reals; accumulators identical
    because both kernels subtract the zero point).
  - per-channel symmetric int8 weights (zero point 0)  ->  uint8 weights
    + 128 with kernel_zero_point 128, requantized per channel via
    PerChannelFP32Params, whose scales go to `device` at import
    (`device_scales`), so no launch copies them.

Supported ops: CONV_2D, DEPTHWISE_CONV_2D (any depth_multiplier),
FULLY_CONNECTED, ADD, CONCATENATION (channel axis, with per-input LUT
requantization when input scales differ), MEAN (global avg pool),
AVERAGE_POOL_2D, MAX_POOL_2D, PAD, RESHAPE, SOFTMAX, QUANTIZE.  Arbitrary
DAG topologies are handled via a tensor-indexed value environment (every
op output is bound to a slot).

Routing: the tags and ConvSpecs equal the JAX import's.  A CONV_2D that is
1x1, stride 1, unpadded and ungrouped keeps its `conv` tag but is packed
as GEMM weights (QNNPACK's gemm ukernel type, src/convolution.c:180-189),
which the graph's conv branch runs on q8gemm.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch

from ..device import resolve_device
from ..models.graph import ConvSpec, GraphSpec, is_gemm_conv
from ..nn.conv import pack_conv_weights
from ..nn.elementwise import build_softargmax_lut, lut32_tensor
from ..nn.packing import pack_gemm_weights
from ..quant.params import (PerChannelFP32Params, compute_add_quant_params,
                            compute_avgpool_quant_params,
                            compute_per_channel_fp32_params)

# --- minimal flatbuffer table reader (TFLite schema.fbs v3 field slots) ----

_I8, _U8 = struct.Struct("<b"), struct.Struct("<B")
_U16 = struct.Struct("<H")
_I32, _U32 = struct.Struct("<i"), struct.Struct("<I")
_F32 = struct.Struct("<f")

U8, I32, I64, F32 = (np.dtype("<u1"), np.dtype("<i4"), np.dtype("<i8"),
                     np.dtype("<f4"))


class _T:
    """Field accessors over the flatbuffer table at `pos` of `buf`.

    A table starts with an int32 back-offset to its vtable; the vtable
    holds its own size in bytes, the table's, then one uint16 offset a
    field slot (0: absent).  Offsets to strings, vectors and sub-tables
    are uint32, relative to where they are stored."""

    def __init__(self, buf: bytes, pos: int):
        self.buf = buf
        self.pos = pos
        self._vtable = pos - _I32.unpack_from(buf, pos)[0]
        self._vsize = _U16.unpack_from(buf, self._vtable)[0]

    def _o(self, slot):
        at = 4 + 2 * slot
        if at >= self._vsize:
            return 0
        return _U16.unpack_from(self.buf, self._vtable + at)[0]

    def _indirect(self, at):
        return at + _U32.unpack_from(self.buf, at)[0]

    def _scalar(self, fmt, slot, default):
        o = self._o(slot)
        return fmt.unpack_from(self.buf, self.pos + o)[0] if o else default

    def i32(self, slot, default=0):
        return self._scalar(_I32, slot, default)

    def i8(self, slot, default=0):
        return self._scalar(_I8, slot, default)

    def u8(self, slot, default=0):
        return self._scalar(_U8, slot, default)

    def f32(self, slot, default=0.0):
        return self._scalar(_F32, slot, default)

    def u32(self, slot, default=0):
        return self._scalar(_U32, slot, default)

    def string(self, slot):
        o = self._o(slot)
        if not o:
            return ""
        at = self._indirect(self.pos + o)
        n = _U32.unpack_from(self.buf, at)[0]
        return bytes(self.buf[at + 4:at + 4 + n]).decode()

    def table(self, slot):
        o = self._o(slot)
        return _T(self.buf, self._indirect(self.pos + o)) if o else None

    def _vector(self, o):
        """(first element's position, length) of the vector at slot
        offset `o`."""
        at = self._indirect(self.pos + o)
        return at + 4, _U32.unpack_from(self.buf, at)[0]

    def vec_len(self, slot):
        o = self._o(slot)
        return self._vector(o)[1] if o else 0

    def vec_table(self, slot, j):
        start, _ = self._vector(self._o(slot))
        return _T(self.buf, self._indirect(start + 4 * j))

    def vec_np(self, slot, dtype):
        """The vector as a read-only numpy view of the file's bytes."""
        o = self._o(slot)
        if not o:
            return np.asarray([], dtype=dtype)
        start, n = self._vector(o)
        return np.frombuffer(self.buf, dtype=dtype, count=n, offset=start)


def _root(buf) -> _T:
    return _T(buf, _U32.unpack_from(buf, 0)[0])


# TensorType enum (schema.fbs)
_DTYPES = {0: np.float32, 2: np.int32, 3: np.uint8, 4: np.int64,
           7: np.int16, 9: np.int8}

# BuiltinOperator codes used here (schema.fbs)
BUILTIN = {0: "ADD", 1: "AVERAGE_POOL_2D", 2: "CONCATENATION", 3: "CONV_2D",
           4: "DEPTHWISE_CONV_2D", 9: "FULLY_CONNECTED", 17: "MAX_POOL_2D",
           22: "RESHAPE", 25: "SOFTMAX", 34: "PAD", 40: "MEAN",
           114: "QUANTIZE", 6: "DEQUANTIZE", 99: "SQUARED_DIFFERENCE",
           80: "FAKE_QUANT", 53: "CAST"}


@dataclasses.dataclass
class TfliteTensor:
    name: str
    shape: tuple
    dtype: type
    scales: np.ndarray      # [1] per-tensor or [C] per-channel
    zero_points: np.ndarray
    quantized_dimension: int
    data: np.ndarray | None  # constant buffer contents, reshaped; else None

    @property
    def scale(self) -> float:
        return float(self.scales[0])

    @property
    def zero_point(self) -> int:
        return int(self.zero_points[0])

    def zero_point_u8(self) -> int:
        """Zero point in the uint8 domain (int8 zp + 128)."""
        return self.zero_point + 128 if self.dtype == np.int8 else self.zero_point


@dataclasses.dataclass
class TfliteOp:
    opname: str
    inputs: list
    outputs: list
    options: _T | None


@dataclasses.dataclass
class TfliteModel:
    tensors: list
    ops: list
    inputs: list
    outputs: list


def _read(path_or_bytes) -> bytes:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return bytes(path_or_bytes)
    with open(path_or_bytes, "rb") as f:
        return f.read()


def parse_tflite(path_or_bytes) -> TfliteModel:
    """Read the (first subgraph of a) .tflite flatbuffer.  Constant data
    are read-only numpy views of the file's bytes."""
    buf = _read(path_or_bytes)
    model = _root(buf)
    # Model: operator_codes(1), subgraphs(2), buffers(4)
    opcodes = []
    for j in range(model.vec_len(1)):
        oc = model.vec_table(1, j)
        # OperatorCode: deprecated_builtin_code(0) int8, builtin_code(3) int32
        opcodes.append(max(oc.i32(3, 0), oc.i8(0, 0)))
    buffers = [model.vec_table(4, j).vec_np(0, U8)  # Buffer.data(0)
               for j in range(model.vec_len(4))]

    sg = model.vec_table(2, 0)  # first subgraph
    tensors = []
    for j in range(sg.vec_len(0)):  # SubGraph.tensors(0)
        t = sg.vec_table(0, j)
        shape = tuple(int(v) for v in t.vec_np(0, I32))
        dtype = _DTYPES.get(t.i8(1, 0), None)
        buf_idx = t.u32(2, 0)
        q = t.table(4)  # QuantizationParameters
        if q is not None:
            scales = q.vec_np(2, F32).astype(np.float64)
            zps = q.vec_np(3, I64).astype(np.int64)
            qdim = q.i32(6, 0)
        else:
            scales, zps, qdim = np.asarray([]), np.asarray([]), 0
        if len(scales) == 0:
            scales = np.asarray([1.0])
        if len(zps) == 0:
            zps = np.asarray([0])
        raw = buffers[buf_idx] if buf_idx < len(buffers) else np.asarray([])
        data = None
        if raw.size and dtype is not None:
            data = raw.view(dtype).reshape(shape)
        tensors.append(TfliteTensor(name=t.string(3), shape=shape,
                                    dtype=dtype, scales=scales,
                                    zero_points=zps, quantized_dimension=qdim,
                                    data=data))

    ops = []
    for j in range(sg.vec_len(3)):  # SubGraph.operators(3)
        op = sg.vec_table(3, j)
        code = opcodes[op.u32(0, 0)]  # opcode_index
        ops.append(TfliteOp(opname=BUILTIN.get(code, f"BUILTIN_{code}"),
                            inputs=[int(v) for v in op.vec_np(1, I32)],
                            outputs=[int(v) for v in op.vec_np(2, I32)],
                            options=op.table(4)))
    return TfliteModel(tensors=tensors, ops=ops,
                       inputs=[int(v) for v in sg.vec_np(1, I32)],
                       outputs=[int(v) for v in sg.vec_np(2, I32)])


# --- graph construction -----------------------------------------------------


def _to_u8(arr: np.ndarray) -> np.ndarray:
    """int8 weights/activations -> the framework's uint8 encoding (+128)."""
    if arr.dtype == np.int8:
        return (arr.astype(np.int16) + 128).astype(np.uint8)
    return arr.astype(np.uint8)


def _kzp_u8(t: TfliteTensor) -> int:
    zps = set(int(z) for z in t.zero_points)
    if len(zps) != 1:
        raise NotImplementedError(
            f"per-channel zero points differ for {t.name}: {sorted(zps)[:4]}")
    return zps.pop() + (128 if t.dtype == np.int8 else 0)


def _act_window(options: _T | None, slot: int, out: TfliteTensor):
    """Fused-activation clamp window in the uint8 domain.

    ActivationFunctionType: NONE=0, RELU=1, RELU_N1_TO_1=2, RELU6=3."""
    act = options.i8(slot, 0) if options is not None else 0
    zp = out.zero_point_u8()
    if act == 0:
        return 0, 255
    if act == 1:
        return min(max(zp, 0), 255), 255
    if act == 3:
        hi = zp + int(round(6.0 / out.scale))
        return min(max(zp, 0), 255), min(hi, 255)
    raise NotImplementedError(f"fused activation {act}")


def _per_channel_rparams(in_t, w_t, out_t, omin, omax, n_out: int):
    """in_scale * w_scales / out_scale in float64, rounded to float32 once
    by compute_per_channel_fp32_params."""
    scales = np.asarray(in_t.scale, np.float64) * w_t.scales / out_t.scale
    if scales.size == 1:  # per-tensor export: broadcast to all channels
        scales = np.full((n_out,), float(scales[0]))
    return compute_per_channel_fp32_params(
        scales, out_t.zero_point_u8(), omin, omax)


def _on_device(rp: PerChannelFP32Params, device) -> PerChannelFP32Params:
    """`rp` with its scales as a float32 tensor on `device`."""
    return dataclasses.replace(rp, device_scales=torch.tensor(
        rp.scales, dtype=torch.float32, device=device))


def _pad_amounts(options: _T | None, in_hw, k_hw, strides, dilation=(1, 1)):
    """TFLite Padding enum: SAME=0, VALID=1 -> explicit ((pt,pb),(pl,pr))."""
    pad_mode = options.i8(0, 0) if options is not None else 0
    if pad_mode == 1:
        return ((0, 0), (0, 0))
    pads = []
    for (size, k, s, d) in zip(in_hw, k_hw, strides, dilation):
        eff_k = (k - 1) * d + 1
        out = -(-size // s)
        total = max((out - 1) * s + eff_k - size, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def _requant_lut(in_t: TfliteTensor, out_t: TfliteTensor) -> np.ndarray:
    """256-entry byte map from in_t's quantization into out_t's, in float64
    (x8lut semantics; round half up as floor(v + 0.5))."""
    i = np.arange(256, dtype=np.float64)
    real = (i - in_t.zero_point_u8()) * in_t.scale
    q = np.floor(real / out_t.scale + 0.5) + out_t.zero_point_u8()
    return np.clip(q, 0, 255).astype(np.uint8)


def import_tflite(path_or_bytes, *, device="cuda"):
    """Build (params, spec, meta) runnable with models.graph.graph_forward,
    the packed records, tables and per-channel scales on `device`.

    Input/output are uint8 (int8 models are shifted by +128; callers feed
    `x_int8 + 128`); meta records the model's input/output quantization.
    """
    dev = resolve_device(device)
    m = parse_tflite(path_or_bytes)
    T = m.tensors
    layers, params = [], []

    def emit(tag, name, payload, packed=None):
        layers.append((tag, name, payload))
        params.append(packed)

    def lut_tensor(lut):
        return torch.from_numpy(lut).to(dev)

    # Every op output is saved to a slot named after its tensor index, and
    # each op loads its inputs from slots as needed: the emitted chain is a
    # topological walk of the TFLite DAG (SqueezeNet's fire concats too).
    current = m.inputs[0]
    slot_of = {m.inputs[0]: f"t{m.inputs[0]}"}
    emit("save", f"save_t{current}", slot_of[current])

    def ensure_current(ti, opname):
        nonlocal current
        if ti == current:
            return
        if ti in slot_of:
            emit("load", f"load_{slot_of[ti]}", slot_of[ti])
            current = ti
            return
        raise NotImplementedError(
            f"{opname}: input tensor {ti} ({T[ti].name}) was not produced "
            f"by any earlier op (activations must be topologically ordered)")

    def save_output(ti):
        slot = f"t{ti}"
        slot_of[ti] = slot
        emit("save", f"save_{slot}", slot)

    def rescale_slot(ti, out_t, name):
        """Requantize a saved tensor into out_t's quantization domain via a
        256-entry LUT, saving to a fresh slot."""
        emit("load", f"load_{slot_of[ti]}", slot_of[ti])
        emit("lut", name, lut_tensor(_requant_lut(T[ti], out_t)))
        slot = f"{slot_of[ti]}_rescaled"
        emit("save", f"save_{slot}", slot)
        return slot

    for oi, op in enumerate(m.ops):
        name = f"{oi}_{op.opname.lower()}"
        if op.opname in ("CONV_2D", "DEPTHWISE_CONV_2D"):
            in_t, w_t = T[op.inputs[0]], T[op.inputs[1]]
            bias = None
            if len(op.inputs) > 2 and op.inputs[2] >= 0:
                bias = T[op.inputs[2]].data.astype(np.int32)
            out_t = T[op.outputs[0]]
            ensure_current(op.inputs[0], op.opname)
            o = op.options
            if op.opname == "CONV_2D":
                # Conv2DOptions: padding(0), stride_w(1), stride_h(2),
                # fused_activation(3), dilation_w(4), dilation_h(5)
                strides = (o.i32(2, 1), o.i32(1, 1))
                dilation = (o.i32(5, 1), o.i32(4, 1))
                act_slot = 3
                k = _to_u8(w_t.data)           # [O, Kh, Kw, I]
                groups = 1
                if w_t.quantized_dimension != 0 and len(w_t.scales) > 1:
                    raise NotImplementedError("conv per-channel dim != 0")
            else:
                # DepthwiseConv2DOptions: padding(0), stride_w(1),
                # stride_h(2), depth_multiplier(3), fused_activation(4),
                # dilation_w(5), dilation_h(6)
                strides = (o.i32(2, 1), o.i32(1, 1))
                dilation = (o.i32(6, 1), o.i32(5, 1))
                act_slot = 4
                # depth_multiplier M: TFLite filter [1, Kh, Kw, C*M] indexes
                # the output channel as c*M + m, which is exactly the
                # grouped-conv layout with groups=C, ocpg=M (group g covers
                # output channels [g*M, (g+1)*M) reading input channel g):
                # q8dwconv for M = 1, grouped q8conv for M > 1.
                # [1, Kh, Kw, C*M] -> [C*M, Kh, Kw, 1]
                k = np.transpose(_to_u8(w_t.data), (3, 1, 2, 0))
                groups = in_t.shape[-1]
                if k.shape[0] % max(groups, 1) != 0:
                    raise NotImplementedError(
                        f"depthwise filter channels {k.shape[0]} not a "
                        f"multiple of input channels {groups}")
                if len(w_t.scales) > 1 and w_t.quantized_dimension != 3:
                    raise NotImplementedError(
                        "depthwise per-channel dim != 3")
            n_out, kh, kw, icpg = k.shape
            padding = _pad_amounts(o, in_t.shape[1:3], (kh, kw), strides,
                                   dilation)
            omin, omax = _act_window(o, act_slot, out_t)
            rp = _on_device(_per_channel_rparams(in_t, w_t, out_t, omin,
                                                 omax, n_out), dev)
            spec = ConvSpec("conv", strides, padding, groups, rp)
            if is_gemm_conv(spec, kh, kw):
                packed = pack_gemm_weights(
                    k.reshape(n_out, icpg), bias, in_t.zero_point_u8(),
                    _kzp_u8(w_t), device=dev)
            else:
                packed = pack_conv_weights(k, bias, in_t.zero_point_u8(),
                                           _kzp_u8(w_t), groups, device=dev)
            emit("conv", name, spec, packed)
        elif op.opname == "FULLY_CONNECTED":
            in_t, w_t = T[op.inputs[0]], T[op.inputs[1]]
            bias = None
            if len(op.inputs) > 2 and op.inputs[2] >= 0 \
                    and T[op.inputs[2]].data is not None:
                bias = T[op.inputs[2]].data.astype(np.int32)
            out_t = T[op.outputs[0]]
            ensure_current(op.inputs[0], op.opname)
            omin, omax = _act_window(op.options, 0, out_t)
            rp = _on_device(_per_channel_rparams(
                in_t, w_t, out_t, omin, omax, n_out=w_t.data.shape[0]), dev)
            packed = pack_gemm_weights(_to_u8(w_t.data), bias,
                                       in_t.zero_point_u8(), _kzp_u8(w_t),
                                       device=dev)
            emit("gemm", name,
                 ConvSpec("gemm", (1, 1), ((0, 0), (0, 0)), 1, rp), packed)
        elif op.opname == "ADD":
            a_t, b_t = T[op.inputs[0]], T[op.inputs[1]]
            out_t = T[op.outputs[0]]
            # One side runs, the other is read from its slot.
            if op.inputs[0] == current or op.inputs[1] in slot_of:
                run_t, res_t, res_i = a_t, b_t, op.inputs[1]
                ensure_current(op.inputs[0], "ADD")
            else:
                run_t, res_t, res_i = b_t, a_t, op.inputs[0]
                ensure_current(op.inputs[1], "ADD")
            if res_i not in slot_of:
                raise NotImplementedError("ADD with a constant operand")
            omin, omax = _act_window(op.options, 0, out_t)
            qp = compute_add_quant_params(
                run_t.zero_point_u8(), res_t.zero_point_u8(),
                out_t.zero_point_u8(),
                run_t.scale / out_t.scale, res_t.scale / out_t.scale,
                omin, omax)
            emit("add", name, (slot_of[res_i], qp))
        elif op.opname == "CONCATENATION":
            out_t = T[op.outputs[0]]
            # ConcatenationOptions: axis(0), fused_activation_function(1)
            axis = op.options.i32(0, 0) if op.options is not None else 0
            rank = len(out_t.shape)
            if axis not in (-1, rank - 1):
                raise NotImplementedError(f"CONCAT over axis {axis}")
            act = op.options.i8(1, 0) if op.options is not None else 0
            if act != 0:
                raise NotImplementedError("CONCAT with fused activation")
            slots = []
            for ti in op.inputs:
                if ti not in slot_of:
                    raise NotImplementedError("CONCAT of a constant input")
                in_t = T[ti]
                if (abs(in_t.scale - out_t.scale) < 1e-12 * out_t.scale
                        and in_t.zero_point_u8() == out_t.zero_point_u8()):
                    slots.append(slot_of[ti])
                else:
                    # Mismatched input quantization: requantize via LUT
                    # into a fresh slot first (TFLite's concat kernel does
                    # the same per-element rescale).
                    slots.append(rescale_slot(ti, out_t,
                                              f"{name}_rescale_t{ti}"))
            emit("concat", name, tuple(slots))
        elif op.opname == "MEAN":
            in_t, out_t = T[op.inputs[0]], T[op.outputs[0]]
            axes = tuple(int(v) for v in T[op.inputs[1]].data.ravel())
            if set(axes) != {1, 2}:
                raise NotImplementedError(f"MEAN over axes {axes}")
            ensure_current(op.inputs[0], "MEAN")
            count = in_t.shape[1] * in_t.shape[2]
            qp = compute_avgpool_quant_params(
                -in_t.zero_point_u8() * count,
                in_t.scale / (out_t.scale * count),
                out_t.zero_point_u8(),
                input_zero_point=in_t.zero_point_u8())
            emit("gap", name, qp)
        elif op.opname == "AVERAGE_POOL_2D":
            in_t, out_t = T[op.inputs[0]], T[op.outputs[0]]
            ensure_current(op.inputs[0], op.opname)
            o = op.options
            # Pool2DOptions: padding(0), stride_w(1), stride_h(2),
            # filter_w(3), filter_h(4), fused_activation(5)
            strides = (o.i32(2, 1), o.i32(1, 1))
            pool = (o.i32(4, 1), o.i32(3, 1))
            padding = _pad_amounts(o, in_t.shape[1:3], pool, strides)
            if padding != ((0, 0), (0, 0)):
                raise NotImplementedError("padded AVERAGE_POOL_2D "
                                          "(count_include_pad mismatch)")
            count = pool[0] * pool[1]
            qp = compute_avgpool_quant_params(
                -in_t.zero_point_u8() * count,
                in_t.scale / (out_t.scale * count),
                out_t.zero_point_u8(),
                input_zero_point=in_t.zero_point_u8())
            emit("avgpool", name, (qp, pool, strides, padding))
        elif op.opname == "MAX_POOL_2D":
            in_t = T[op.inputs[0]]
            ensure_current(op.inputs[0], op.opname)
            o = op.options
            strides = (o.i32(2, 1), o.i32(1, 1))
            pool = (o.i32(4, 1), o.i32(3, 1))
            padding = _pad_amounts(o, in_t.shape[1:3], pool, strides)
            emit("maxpool", name, (pool, strides, padding))
        elif op.opname == "PAD":
            in_t = T[op.inputs[0]]
            ensure_current(op.inputs[0], "PAD")
            pads = T[op.inputs[1]].data.reshape(-1, 2)
            if pads.shape[0] != 4 or pads[0].any() or pads[3].any():
                raise NotImplementedError(f"PAD spec {pads.tolist()}")
            emit("pad", name, (tuple(int(v) for v in pads[1]),
                               tuple(int(v) for v in pads[2]),
                               in_t.zero_point_u8()))
        elif op.opname == "RESHAPE":
            out_t = T[op.outputs[0]]
            ensure_current(op.inputs[0], "RESHAPE")
            if len(out_t.shape) == 2:
                emit("flatten", name, None)
            # else: shape-preserving metadata op; running value unchanged
        elif op.opname == "SOFTMAX":
            in_t, out_t = T[op.inputs[0]], T[op.outputs[0]]
            ensure_current(op.inputs[0], "SOFTMAX")
            if abs(out_t.scale - 1.0 / 256.0) > 1e-9:
                raise NotImplementedError("softmax output scale != 1/256")
            emit("softargmax", name, lut32_tensor(
                build_softargmax_lut(in_t.scale, in_t.shape[-1]), dev))
        elif op.opname == "QUANTIZE":
            # Per-tensor rescale: exact via a 256-entry LUT (TFLite's
            # requantize is round-half-away in double).
            in_t, out_t = T[op.inputs[0]], T[op.outputs[0]]
            ensure_current(op.inputs[0], "QUANTIZE")
            emit("lut", name, lut_tensor(_requant_lut(in_t, out_t)))
        else:
            raise NotImplementedError(f"TFLite op {op.opname} unsupported")
        current = op.outputs[0]
        save_output(current)

    if current != m.outputs[0]:
        ensure_current(m.outputs[0], "subgraph output")

    in_t, out_t = T[m.inputs[0]], T[m.outputs[0]]
    meta = {
        "input_scale": in_t.scale, "input_zero_point": in_t.zero_point_u8(),
        "input_dtype": "int8" if in_t.dtype == np.int8 else "uint8",
        "output_scale": out_t.scale,
        "output_zero_point": out_t.zero_point_u8(),
        "input_shape": in_t.shape,
    }
    spec = GraphSpec(layers=layers, raw_weights=[None] * len(layers),
                     meta=meta)
    return params, spec, meta
