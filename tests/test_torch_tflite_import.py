"""The port's TFLite importer (qnnpack_tpu_torch/io/tflite_import.py)
against the JAX package's (qnnpack_tpu/io/tflite_import.py).

- parse_tflite of both bundled assets (assets/mobilenet_v2_int8.tflite,
  assets/squeezenet_v11_int8.tflite), field for field: the port reads the
  flatbuffer with its own table reader, the JAX package with `flatbuffers`;
- import_tflite: the same tags, names, ConvSpecs, requant params and
  packed weights (an imported 1x1 conv's GEMM record against the JAX conv
  record reshaped), per-channel scales placed on the import's device;
- which kernel each layer reaches (the launch counts chip_smoke.py holds
  the card to), counted at the wrappers' call sites on the CPU;
- graph_forward of both imports at 224 and batch 1 equal to the JAX
  graph_forward byte for byte, through the port's import and through
  params_from_jax of the JAX import;
- a small flatbuffer written here with `flatbuffers.Builder`, which
  holds the ops neither asset has: SOFTMAX, QUANTIZE, PAD, RESHAPE,
  AVERAGE_POOL_2D, MAX_POOL_2D with SAME padding, a concat that rescales
  its inputs, a depthwise conv with depth multiplier 2 (grouped q8conv) and
  a dense 3x3 conv; and the importer's rejections.
"""

import dataclasses
import functools
import sys
import warnings
from pathlib import Path

import flatbuffers
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qnnpack_tpu.io import tflite_import as jt
from qnnpack_tpu.models.graph import graph_forward as jax_graph_forward
from qnnpack_tpu_torch.io import tflite_import as tt
from qnnpack_tpu_torch.models import graph as tgraph
from qnnpack_tpu_torch.nn import conv as tconv
from qnnpack_tpu_torch.nn import elementwise as telem
from qnnpack_tpu_torch.nn import gemm as tgemm
from qnnpack_tpu_torch.nn import pool as tpool
from qnnpack_tpu_torch.nn.packing import PackedGemmWeights
from qnnpack_tpu_torch.quant.params import PerChannelFP32Params

ROOT = Path(__file__).resolve().parents[1]
ASSETS = {"mobilenet_v2": ROOT / "assets" / "mobilenet_v2_int8.tflite",
          "squeezenet_v11": ROOT / "assets" / "squeezenet_v11_int8.tflite"}


@functools.lru_cache(maxsize=None)
def jax_import(name):
    return jt.import_tflite(str(ASSETS[name]))


@functools.lru_cache(maxsize=None)
def jax_logits(name):
    """The JAX graph_forward of the JAX import on seeded input (224, b1)."""
    params, spec, _ = jax_import(name)
    x = seeded_input(name)
    fwd = jax.jit(lambda p, v: jax_graph_forward(p, spec, v))
    return np.asarray(fwd(params, jnp.asarray(x)))


def seeded_input(name):
    seed = {"mobilenet_v2": 3, "squeezenet_v11": 9}[name]
    return np.random.default_rng(seed).integers(
        0, 256, (1, 224, 224, 3), dtype=np.int64).astype(np.uint8)


def assert_same_parse(a, b):
    assert len(a.tensors) == len(b.tensors)
    for x, y in zip(a.tensors, b.tensors):
        assert (x.name, x.shape, x.dtype, x.quantized_dimension) == \
            (y.name, y.shape, y.dtype, y.quantized_dimension)
        for f in ("scales", "zero_points"):
            u, v = getattr(x, f), getattr(y, f)
            assert u.dtype == v.dtype, (x.name, f)
            np.testing.assert_array_equal(u, v, err_msg=f"{x.name} {f}")
        assert (x.data is None) == (y.data is None), x.name
        if x.data is not None:
            assert x.data.dtype == y.data.dtype and \
                x.data.shape == y.data.shape, x.name
            np.testing.assert_array_equal(x.data, y.data, err_msg=x.name)
    assert [(o.opname, o.inputs, o.outputs) for o in a.ops] == \
        [(o.opname, o.inputs, o.outputs) for o in b.ops]
    assert (a.inputs, a.outputs) == (b.inputs, b.outputs)


@pytest.mark.parametrize("name", ASSETS)
def test_parse_equals_jax_parse(name):
    assert_same_parse(jt.parse_tflite(str(ASSETS[name])),
                      tt.parse_tflite(ASSETS[name]))


@pytest.mark.parametrize("name", ASSETS)
def test_parse_of_bytes_equals_parse_of_path(name):
    assert_same_parse(tt.parse_tflite(ASSETS[name].read_bytes()),
                      tt.parse_tflite(ASSETS[name]))


@pytest.mark.parametrize("name", ASSETS)
def test_parse_options_equal_jax(name):
    """Every op's options table reads the same scalars in both readers."""
    a, b = jt.parse_tflite(str(ASSETS[name])), tt.parse_tflite(ASSETS[name])
    for x, y in zip(a.ops, b.ops):
        assert (x.options is None) == (y.options is None)
        if x.options is None:
            continue
        for slot in range(7):
            for kind in ("i32", "i8", "u8", "u32", "f32"):
                u = getattr(x.options, kind)(slot, -7)
                v = getattr(y.options, kind)(slot, -7)
                assert u == v or (u != u and v != v), (x.opname, slot, kind)


@pytest.mark.parametrize("name", ASSETS)
def test_constant_data_is_read_only_and_import_copies_it(name):
    """parse_tflite's constant data are views of the file's bytes (as the
    JAX reader's); the import copies them once when it packs, so torch
    never sees a non-writable array."""
    m = tt.parse_tflite(ASSETS[name])
    consts = [t.data for t in m.tensors if t.data is not None]
    assert consts and not any(d.flags.writeable for d in consts)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tt.import_tflite(ASSETS[name], device="cpu")


def assert_same_params(jp, tp):
    """Requant/add/avgpool parameter records, field for field (per-channel
    scales as their float32 tuple)."""
    assert type(jp).__name__ == type(tp).__name__
    for f in dataclasses.fields(tp):
        if f.name == "device_scales":
            continue
        assert getattr(jp, f.name) == getattr(tp, f.name), f.name


def assert_same_layers(js, ts, jparams, tparams):
    assert [(t, n) for t, n, _ in js.layers] == \
        [(t, n) for t, n, _ in ts.layers]
    assert ts.raw_weights == [None] * len(ts.layers)
    assert js.meta == ts.meta
    for (tag, name, jpay), (_, _, tpay), jrec, trec in zip(
            js.layers, ts.layers, jparams, tparams):
        if tag in ("conv", "gemm"):
            assert (jpay.kind, tuple(jpay.strides), jpay.padding,
                    jpay.groups) == (tpay.kind, tuple(tpay.strides),
                                     tpay.padding, tpay.groups), name
            assert_same_params(jpay.rparams, tpay.rparams)
            assert_same_record(name, jrec, trec)
        elif tag == "add":
            assert jpay[0] == tpay[0], name
            assert_same_params(jpay[1], tpay[1])
        elif tag == "gap":
            assert_same_params(jpay, tpay)
        elif tag == "avgpool":
            assert_same_params(jpay[0], tpay[0])
            assert jpay[1:] == tpay[1:], name
        elif tag in ("lut", "softargmax"):
            np.testing.assert_array_equal(
                np.asarray(jpay).astype(np.int64),
                tpay.cpu().numpy().astype(np.int64)
                & (0xFF if tag == "lut" else 0xFFFFFFFF), err_msg=name)
        else:
            assert jpay == tpay, name
        if tag not in ("conv", "gemm"):
            assert jrec is None and trec is None, name


def assert_same_record(name, jrec, trec):
    w = np.asarray(jrec.w)
    if isinstance(trec, PackedGemmWeights):
        # A 1x1 conv record of the JAX import, [1, 1, Icpg, O] -> [K, N].
        w = w.reshape(-1, w.shape[-1])
        assert (trec.k, trec.n) == w.shape, name
    else:
        for f in ("kernel_height", "kernel_width", "group_input_channels",
                  "group_output_channels", "groups"):
            assert getattr(trec, f) == getattr(jrec, f), (name, f)
    np.testing.assert_array_equal(trec.w.numpy(), w, err_msg=name)
    np.testing.assert_array_equal(trec.bias_folded.numpy(),
                                  np.asarray(jrec.bias_folded), err_msg=name)
    assert (trec.input_zero_point, trec.kernel_zero_point) == \
        (jrec.input_zero_point, jrec.kernel_zero_point), name


@pytest.mark.parametrize("name", ASSETS)
def test_import_equals_jax_import(name):
    jparams, js, _ = jax_import(name)
    tparams, ts, _ = tt.import_tflite(ASSETS[name], device="cpu")
    assert_same_layers(js, ts, jparams, tparams)


@pytest.mark.parametrize("name,gemm_convs", [("mobilenet_v2", 34),
                                             ("squeezenet_v11", 17)])
def test_one_by_one_convs_are_packed_as_gemm_weights(name, gemm_convs):
    """Tags stay `conv` as in the JAX import; the 1x1 stride-1 unpadded
    dense ones carry GEMM records (and only they)."""
    tparams, ts, _ = tt.import_tflite(ASSETS[name], device="cpu")
    gemm = [(n, p) for (t, n, pay), p in zip(ts.layers, tparams)
            if t == "conv" and isinstance(p, PackedGemmWeights)]
    assert len(gemm) == gemm_convs
    for (t, n, pay), p in zip(ts.layers, tparams):
        if t == "conv":
            kh, kw = ((1, 1) if isinstance(p, PackedGemmWeights)
                      else (p.kernel_height, p.kernel_width))
            assert isinstance(p, PackedGemmWeights) == \
                tgraph.is_gemm_conv(pay, kh, kw), n


@pytest.mark.parametrize("name", ASSETS)
def test_per_channel_scales_lie_on_the_import_device(name):
    tparams, ts, _ = tt.import_tflite(ASSETS[name], device="cpu")
    convs = [pay for t, _, pay in ts.layers if t in ("conv", "gemm")]
    assert convs
    for pay in convs:
        rp = pay.rparams
        assert isinstance(rp, PerChannelFP32Params)
        assert rp.device_scales.device == torch.device("cpu")
        assert rp.device_scales.dtype == torch.float32
        assert rp.device_scales.tolist() == list(rp.scales)


# Where each kernel wrapper is called from: (module, name, kernel).
CALL_SITES = [(tgraph, "q8vadd_cuda", "q8vadd"),
              (tgemm, "q8gemm_cuda", "q8gemm"),
              (tconv, "q8conv_cuda", "q8conv"),
              (tconv, "q8dwconv_cuda", "q8dwconv"),
              (tconv, "q8stem_cuda", "q8stem"),
              (tpool, "u8maxpool_cuda", "u8maxpool"),
              (tpool, "q8avgpool_cuda", "q8avgpool"),
              (tpool, "q8gavgpool_cuda", "q8gavgpool"),
              (telem, "u8rmax_cuda", "u8rmax"),
              (telem, "u8lut32norm_cuda", "u8lut32norm")]


def count_wrapper_calls(monkeypatch):
    """Count every kernel-wrapper call the graph makes (on the CPU each
    runs its plain version); returns the live counts dict."""
    counts = {}
    for mod, attr, kernel in CALL_SITES:
        fn = getattr(mod, attr)

        def counted(*args, _fn=fn, _k=kernel, **kwargs):
            counts[_k] = counts.get(_k, 0) + 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(mod, attr, counted)
    return counts


def chip_smoke_expected():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke.IMPORTED_LAUNCHES


@pytest.mark.parametrize("name", ASSETS)
def test_forward_reaches_the_kernels_chip_smoke_counts(name, monkeypatch):
    tparams, ts, _ = tt.import_tflite(ASSETS[name], device="cpu")
    counts = count_wrapper_calls(monkeypatch)
    tgraph.graph_forward(tparams, ts, torch.from_numpy(seeded_input(name)))
    want = {k: v for k, v in chip_smoke_expected()[f"{name}_tflite"].items()
            if v}
    assert counts == want


@pytest.mark.parametrize("weights", ["port_import", "params_from_jax"])
@pytest.mark.parametrize("name", ASSETS)
def test_forward_equals_jax_forward(name, weights):
    """224, batch 1, byte for byte."""
    if weights == "port_import":
        tparams, ts, _ = tt.import_tflite(ASSETS[name], device="cpu")
    else:
        jparams, _, _ = jax_import(name)
        _, ts, _ = tt.import_tflite(ASSETS[name], device="cpu")
        tparams = tgraph.params_from_jax(jax.tree.map(np.asarray, jparams),
                                         ts, device="cpu")
    got = tgraph.graph_forward(tparams, ts,
                               torch.from_numpy(seeded_input(name))).numpy()
    want = jax_logits(name)
    assert got.shape == (1, 1000) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 16


def test_params_from_jax_takes_zero_points_from_the_records():
    """An imported graph keeps no raw weights: params_from_jax takes each
    record's zero points and shape from the record, not GraphBuilder's
    synthetic ACT_ZP / KERNEL_ZP."""
    jparams, _, _ = jax_import("mobilenet_v2")
    _, ts, _ = tt.import_tflite(ASSETS["mobilenet_v2"], device="cpu")
    ported = tgraph.params_from_jax(jax.tree.map(np.asarray, jparams), ts,
                                    device="cpu")
    izps = {p.input_zero_point for p in ported if p is not None}
    assert izps != {tgraph.ACT_ZP}
    for jrec, trec, (_, name, _) in zip(jparams, ported, ts.layers):
        if trec is not None:
            assert_same_record(name, jrec, trec)


# --- a small model written here with flatbuffers.Builder -------------------

_TYPES = {np.dtype(np.float32): 0, np.dtype(np.int32): 2,
          np.dtype(np.uint8): 3, np.dtype(np.int64): 4, np.dtype(np.int8): 9}
_CODES = {name: code for code, name in jt.BUILTIN.items()}


class TinyTflite:
    """A TFLite flatbuffer (schema v3 field slots, as the readers use them)
    built from tensors and ops added one by one."""

    def __init__(self):
        self.tensors, self.buffers, self.ops = [], [b""], []

    def tensor(self, shape, dtype, scales=(1.0,), zero_points=(0,),
               qdim=0, data=None):
        buf = 0
        if data is not None:
            self.buffers.append(np.ascontiguousarray(data, dtype).tobytes())
            buf = len(self.buffers) - 1
        self.tensors.append(dict(shape=shape, type=_TYPES[np.dtype(dtype)],
                                 buffer=buf, name=f"t{len(self.tensors)}",
                                 scales=scales, zero_points=zero_points,
                                 qdim=qdim))
        return len(self.tensors) - 1

    def op(self, opname, inputs, outputs, options=None):
        """options: {slot: (kind, value)} with kind "i8", "i32" or "f32"."""
        self.ops.append((opname, inputs, outputs, options or {}))

    def build(self, inputs, outputs) -> bytes:
        b = flatbuffers.Builder(1024)
        b.ForceDefaults(True)

        def vec(values, prepend, size):
            b.StartVector(size, len(values), size)
            for v in reversed(list(values)):
                prepend(v)
            return b.EndVector()

        def offsets(offs):
            return vec(offs, b.PrependUOffsetTRelative, 4)

        def table(fields):
            b.StartObject(8)
            for slot, (kind, value) in fields.items():
                {"i8": b.PrependInt8Slot, "u8": b.PrependUint8Slot,
                 "i32": b.PrependInt32Slot, "u32": b.PrependUint32Slot,
                 "f32": b.PrependFloat32Slot,
                 "off": b.PrependUOffsetTRelativeSlot}[kind](slot, value, 0)
            return b.EndObject()

        bufs = []
        for data in self.buffers:
            fields = {}
            if data:
                fields[0] = ("off", b.CreateNumpyVector(
                    np.frombuffer(data, np.uint8)))
            bufs.append(table(fields))
        tensors = []
        for t in self.tensors:
            name = b.CreateString(t["name"])
            shape = vec(t["shape"], b.PrependInt32, 4)
            scales = vec(t["scales"], b.PrependFloat32, 4)
            zps = vec(t["zero_points"], b.PrependInt64, 8)
            quant = table({2: ("off", scales), 3: ("off", zps),
                           6: ("i32", t["qdim"])})
            tensors.append(table({0: ("off", shape), 1: ("i8", t["type"]),
                                  2: ("u32", t["buffer"]), 3: ("off", name),
                                  4: ("off", quant)}))
        names = sorted({op[0] for op in self.ops})
        ops = []
        for opname, ins, outs, options in self.ops:
            ins_v = vec(ins, b.PrependInt32, 4)
            outs_v = vec(outs, b.PrependInt32, 4)
            fields = {0: ("u32", names.index(opname)), 1: ("off", ins_v),
                      2: ("off", outs_v)}
            if options:
                fields[4] = ("off", table(options))
            ops.append(table(fields))
        codes = [table({0: ("i8", min(_CODES[n], 127)),
                        3: ("i32", _CODES[n])}) for n in names]
        sg = table({0: ("off", offsets(tensors)),
                    1: ("off", vec(inputs, b.PrependInt32, 4)),
                    2: ("off", vec(outputs, b.PrependInt32, 4)),
                    3: ("off", offsets(ops))})
        model = table({0: ("u32", 3), 1: ("off", offsets(codes)),
                       2: ("off", offsets([sg])), 4: ("off", offsets(bufs))})
        b.Finish(model)
        return bytes(b.Output())


def tiny_model(rng):
    """int8 [1, 8, 8, 4] (zero point -3) -> dense 3x3 conv (RELU6,
    per-channel) -> depthwise 3x3 stride 2, multiplier 2 (RELU) ->
    QUANTIZE -> PAD -> AVERAGE_POOL_2D 2x2 -> MAX_POOL_2D 2x2 SAME -> ADD
    of the two pools (RELU, both rescaled) -> CONCATENATION of the sum and
    the average pool into a third quantization (both rescaled by LUT) ->
    MEAN -> RESHAPE -> FULLY_CONNECTED -> SOFTMAX."""
    m = TinyTflite()

    def i8(*shape):
        return rng.integers(-127, 128, shape, dtype=np.int64).astype(np.int8)

    def i32(n):
        return rng.integers(-3000, 3000, n, dtype=np.int64).astype(np.int32)

    x = m.tensor((1, 8, 8, 4), np.int8, (0.05,), (-3,))
    w1 = m.tensor((6, 3, 3, 4), np.int8, tuple(rng.uniform(0.002, 0.01, 6)),
                  (0,) * 6, 0, i8(6, 3, 3, 4))
    b1 = m.tensor((6,), np.int32, data=i32(6))
    c1 = m.tensor((1, 8, 8, 6), np.int8, (0.04,), (-128,))
    m.op("CONV_2D", [x, w1, b1], [c1], {0: ("i8", 0), 1: ("i32", 1),
                                         2: ("i32", 1), 3: ("i8", 3)})
    w2 = m.tensor((1, 3, 3, 12), np.int8,
                  tuple(rng.uniform(0.002, 0.01, 12)), (0,) * 12, 3,
                  i8(1, 3, 3, 12))
    b2 = m.tensor((12,), np.int32, data=i32(12))
    c2 = m.tensor((1, 4, 4, 12), np.int8, (0.03,), (-128,))
    m.op("DEPTHWISE_CONV_2D", [c1, w2, b2], [c2],
         {0: ("i8", 0), 1: ("i32", 2), 2: ("i32", 2), 3: ("i32", 2),
            4: ("i8", 1)})
    q = m.tensor((1, 4, 4, 12), np.int8, (0.045,), (-100,))
    m.op("QUANTIZE", [c2], [q])
    pads = m.tensor((4, 2), np.int32,
                    data=np.array([[0, 0], [1, 1], [1, 1], [0, 0]]))
    p = m.tensor((1, 6, 6, 12), np.int8, (0.045,), (-100,))
    m.op("PAD", [q, pads], [p])
    avg = m.tensor((1, 3, 3, 12), np.int8, (0.02,), (-90,))
    m.op("AVERAGE_POOL_2D", [p], [avg], {0: ("i8", 1), 1: ("i32", 2),
                                          2: ("i32", 2), 3: ("i32", 2),
                                          4: ("i32", 2)})
    mx = m.tensor((1, 3, 3, 12), np.int8, (0.02,), (-90,))
    m.op("MAX_POOL_2D", [avg], [mx], {0: ("i8", 0), 1: ("i32", 1),
                                       2: ("i32", 1), 3: ("i32", 2),
                                       4: ("i32", 2)})
    add = m.tensor((1, 3, 3, 12), np.int8, (0.03,), (-10,))
    m.op("ADD", [mx, avg], [add], {0: ("i8", 1)})
    cat = m.tensor((1, 3, 3, 24), np.int8, (0.025,), (-20,))
    m.op("CONCATENATION", [add, avg], [cat], {0: ("i32", 3)})
    axes = m.tensor((2,), np.int32, data=np.array([1, 2]))
    mean = m.tensor((1, 1, 1, 24), np.int8, (0.015,), (-40,))
    m.op("MEAN", [cat, axes], [mean])
    shape = m.tensor((2,), np.int32, data=np.array([1, 24]))
    flat = m.tensor((1, 24), np.int8, (0.015,), (-40,))
    m.op("RESHAPE", [mean, shape], [flat])
    w3 = m.tensor((10, 24), np.int8, tuple(rng.uniform(0.01, 0.03, 10)),
                  (0,) * 10, 0, i8(10, 24))
    b3 = m.tensor((10,), np.int32, data=i32(10))
    fc = m.tensor((1, 10), np.int8, (0.1,), (5,))
    m.op("FULLY_CONNECTED", [flat, w3, b3], [fc], {0: ("i8", 0)})
    sm = m.tensor((1, 10), np.int8, (1.0 / 256.0,), (-128,))
    m.op("SOFTMAX", [fc], [sm], {0: ("f32", 1.0)})
    return m.build([x], [sm])


@pytest.fixture(scope="module")
def tiny():
    return tiny_model(np.random.default_rng(2024))


def test_tiny_parse_equals_jax_parse(tiny):
    assert_same_parse(jt.parse_tflite(tiny), tt.parse_tflite(tiny))


def test_tiny_import_equals_jax_import(tiny):
    jparams, js, _ = jt.import_tflite(tiny)
    tparams, ts, _ = tt.import_tflite(tiny, device="cpu")
    assert_same_layers(js, ts, jparams, tparams)
    tags = [t for t, _, _ in ts.layers]
    for tag in ("lut", "pad", "avgpool", "maxpool", "add", "concat", "gap",
                "flatten", "gemm", "softargmax"):
        assert tag in tags, tag
    assert tags.count("lut") == 3  # QUANTIZE and both concat inputs


def test_tiny_forward_equals_jax_forward(tiny, monkeypatch):
    jparams, js, _ = jt.import_tflite(tiny)
    tparams, ts, _ = tt.import_tflite(tiny, device="cpu")
    x = np.random.default_rng(5).integers(0, 256, (3, 8, 8, 4),
                                          dtype=np.int64).astype(np.uint8)
    want = np.asarray(jax_graph_forward(jparams, js, jnp.asarray(x)))
    counts = count_wrapper_calls(monkeypatch)
    got = tgraph.graph_forward(tparams, ts, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, 10) and len(np.unique(got)) > 3
    # The dense 3x3 conv and the multiplier-2 depthwise conv (grouped,
    # two output channels a group) both run q8conv.
    assert counts == {"q8conv": 2, "q8avgpool": 1, "u8maxpool": 1,
                      "q8vadd": 1, "q8gavgpool": 1, "q8gemm": 1, "u8rmax": 1,
                      "u8lut32norm": 1}
    tp2 = tgraph.params_from_jax(jax.tree.map(np.asarray, jparams), ts,
                                 device="cpu")
    np.testing.assert_array_equal(
        tgraph.graph_forward(tp2, ts, torch.from_numpy(x)).numpy(), want)


def one_op_model(opname, options):
    m = TinyTflite()
    x = m.tensor((1, 4, 4, 4), np.int8, (0.05,), (0,))
    y = m.tensor((1, 4, 4, 4), np.int8, (0.05,), (0,))
    m.op(opname, [x], [y], options)
    return m.build([x], [y])


@pytest.mark.parametrize("opname,options,match", [
    ("CAST", {}, "CAST unsupported"),
    ("AVERAGE_POOL_2D", {0: ("i8", 0), 1: ("i32", 1), 2: ("i32", 1),
                         3: ("i32", 3), 4: ("i32", 3)}, "padded"),
    ("SOFTMAX", {0: ("f32", 1.0)}, "softmax output scale")])
def test_rejections_match_jax(opname, options, match):
    model = one_op_model(opname, options)
    for importer in (jt.import_tflite,
                     functools.partial(tt.import_tflite, device="cpu")):
        with pytest.raises(NotImplementedError, match=match):
            importer(model)
