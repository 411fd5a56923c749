"""The port's graph runtime and model zoo against the JAX package.

- A small graph over every ported tag (conv on all three conv kernels,
  gemm, maxpool, gap, add, save, load, concat, split, pad, flatten) gives
  the JAX graph_forward's bytes, under q31 and fp32 requant.
- A small graph with the lut and softargmax tags (and the builder's
  softargmax) gives the JAX graph_forward's bytes.
- ENet (models/enet.py, the deconv model) at 32x32 gives the JAX
  graph_forward's bytes through the port's builder, through
  params_from_jax, and after a save_params / load_params round trip (with
  the spec, and without it, where the first forward builds each deconv
  plan); so does a graph of deconvs at every lowering, with kzp != 128.
- ResNet-18 at full width (32x32, batch 2) and SqueezeNet 1.1 (64x64) give
  the JAX forward's logits, through the port's builder and through
  params_from_jax; the ResNet-18 entry point at 224 does too, and the
  port's InferenceServer answers ResNet-18 requests with the batch rows.
- Each ported zoo builder makes the JAX builder's RNG calls: the raw
  weights and layer specs are equal (vgg16 is left out: its fc6 alone is
  103 M weights).  The ShuffleNets' forwards are in
  test_torch_shufflenet.py.
Comparisons are exact."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qnnpack_tpu.models import graph as jgraph
from qnnpack_tpu.models import zoo as jzoo
from qnnpack_tpu_torch import kernels as tkernels
from qnnpack_tpu_torch.entry import entry
from qnnpack_tpu_torch.models import graph as tgraph
from qnnpack_tpu_torch.models import zoo as tzoo
from qnnpack_tpu_torch.nn.packing import PackedGemmWeights
from qnnpack_tpu_torch.serving import InferenceServer


def jax_forward(params, spec, x):
    return np.asarray(jax.jit(
        lambda p, v: jgraph.graph_forward(p, spec, v))(params,
                                                       jnp.asarray(x)))


def images(seed, shape):
    return np.random.default_rng(seed).integers(
        0, 256, shape, dtype=np.int64).astype(np.uint8)


def assert_same_spec(jspec, tspec):
    assert len(jspec.layers) == len(tspec.layers)
    for (jt, jn, jl), (tt, tn, tl) in zip(jspec.layers, tspec.layers):
        assert (jt, jn) == (tt, tn)
        if jt == "deconv":
            assert jl[1] == tl[1]
            jl, tl = jl[0], tl[0]
        if jt in ("conv", "gemm", "deconv"):
            assert (jl.kind, jl.strides, jl.padding, jl.groups) == \
                (tl.kind, tl.strides, tl.padding, tl.groups)
            assert dataclasses.asdict(jl.rparams) == \
                dataclasses.asdict(tl.rparams)
        elif jt == "gap":
            assert dataclasses.asdict(jl) == dataclasses.asdict(tl)
        elif jt == "avgpool":
            assert dataclasses.asdict(jl[0]) == dataclasses.asdict(tl[0])
            assert jl[1:] == tl[1:]
        elif jt == "add":
            assert jl[0] == tl[0]
            assert dataclasses.asdict(jl[1]) == dataclasses.asdict(tl[1])
        elif jt == "softargmax":
            np.testing.assert_array_equal(tl.numpy().view(np.uint32),
                                          np.asarray(jl))
        elif jt == "lut":
            np.testing.assert_array_equal(np.asarray(tl), np.asarray(jl))
        else:
            assert jl == tl
    assert jspec.meta == tspec.meta
    for jr, tr in zip(jspec.raw_weights, tspec.raw_weights):
        if jr is None:
            assert tr is None
        else:
            np.testing.assert_array_equal(jr[0], tr[0])
            np.testing.assert_array_equal(jr[1], tr[1])


def every_tag_graph(builder_cls, rng, requant, **kw):
    """A graph touching every ported tag: 2x19x19x3 in, [2, 10] out."""
    g = builder_cls(rng, requant, **kw)
    g.conv("stem", 3, 8, kernel=(5, 5), strides=(2, 2),
           padding=((1, 2), (1, 2)), act="relu")                # q8stem
    g.maxpool("pool", (3, 3), (2, 2), ((0, 1), (0, 1)))        # 4x4
    g.save("a")
    g.conv("dw", 8, 8, groups=8)                                # q8dwconv
    g.conv("pw", 8, 16, kernel=(1, 1), padding=((0, 0), (0, 0)))  # gemm
    g.split("split", "left", 6)
    g.save("right")
    g.concat("cat", ["left", "right"])
    g.conv("body", 16, 8, strides=(2, 2), padding=((0, 1), (0, 1)),
           act="linear")                                        # q8conv
    g.save("b")
    g.load("a")
    g.conv("proj", 8, 8, kernel=(1, 1), strides=(2, 2),
           padding=((0, 0), (0, 0)), act="linear")              # q8conv 1x1
    g.add("add", "b")                                           # 2x2
    g._emit("pad", "pad", ((1, 1), (0, 1), 128))                # 4x3
    g.save("p")
    g.gap("gap", 3)
    g.fc("fc1", 8, 10)
    g.save("f1")
    g.load("p")
    g._emit("flatten", "flatten", None)
    g.fc("fc2", 4 * 3 * 8, 10)
    g.add("sum", "f1")
    return g.finish(name="every_tag")


@pytest.mark.parametrize("requant", ["q31", "fp32"])
def test_every_ported_tag_matches_jax(requant):
    jp, js = every_tag_graph(jgraph.GraphBuilder,
                             np.random.default_rng(21), requant)
    tp, ts = every_tag_graph(tgraph.GraphBuilder,
                             np.random.default_rng(21), requant,
                             device="cpu")
    assert_same_spec(js, ts)
    tags = {t for t, _, _ in ts.layers}
    assert tags == {"conv", "gemm", "maxpool", "save", "load", "split",
                    "concat", "add", "pad", "gap", "flatten"}
    x = images(22, (2, 19, 19, 3))
    want = jax_forward(jp, js, x)
    tkernels.reset_launch_counts()
    got = tgraph.graph_forward(tp, ts, torch.from_numpy(x))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (2, 10)
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(tkernels.launch_counts().values()) == {0}
    tp2 = tgraph.params_from_jax(jax.tree.map(np.asarray, jp), ts,
                                 device="cpu")
    np.testing.assert_array_equal(
        tgraph.graph_forward(tp2, ts, torch.from_numpy(x)).numpy(), want)


def lut_softargmax_graph(builder_cls, rng, requant, table, **kw):
    """lut and softargmax over the channels of NHWC activations and over
    logits: 2x9x9x3 in, [2, 10] out."""
    g = builder_cls(rng, requant, **kw)
    g.conv("stem", 3, 8, strides=(2, 2), act="relu")         # 5x5x8
    g._emit("lut", "sigmoid", table)
    g.softargmax("sm_channels", 8)
    g.gap("gap", 5)
    g.fc("fc", 8, 10)
    g.softargmax("sm_logits", 10, input_scale=0.25)
    return g.finish(name="lut_softargmax")


@pytest.mark.parametrize("requant", ["q31", "fp32"])
def test_lut_and_softargmax_tags_match_jax(requant):
    from qnnpack_tpu.nn.elementwise import build_sigmoid_lut
    table = build_sigmoid_lut(140, 0.1)
    jp, js = lut_softargmax_graph(jgraph.GraphBuilder,
                                  np.random.default_rng(23), requant, table)
    tp, ts = lut_softargmax_graph(tgraph.GraphBuilder,
                                  np.random.default_rng(23), requant, table,
                                  device="cpu")
    assert_same_spec(js, ts)
    assert {t for t, _, _ in ts.layers} == {"conv", "lut", "softargmax",
                                            "gap", "gemm"}
    x = images(24, (2, 9, 9, 3))
    want = jax_forward(jp, js, x)
    tkernels.reset_launch_counts()
    got = tgraph.graph_forward(tp, ts, torch.from_numpy(x))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (2, 10)
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(tkernels.launch_counts().values()) == {0}


def deconv_graph(builder_cls, rng, requant, **kw):
    """Deconvs at each lowering (k == s grouped, phases with padding and
    adjustment, k < s, stride 1): 2x5x5x8 in."""
    g = builder_cls(rng, requant, **kw)
    g.deconv("up_g", 8, 12, groups=2)                          # k == s
    g.deconv("up_pad", 12, 8, kernel=(3, 3), strides=(2, 2),
             padding=((1, 1), (1, 1)), adjustment=(1, 1))      # phase
    g.deconv("up_klt", 8, 4, kernel=(2, 2), strides=(3, 3))    # k < s
    g.deconv("same", 4, 4, kernel=(3, 3), strides=(1, 1),
             padding=((1, 1), (1, 1)), act="linear")           # dilated
    return g.finish(name="deconvs")


@pytest.mark.parametrize("requant", ["q31", "fp32"])
def test_deconv_tag_matches_jax(requant):
    jp, js = deconv_graph(jgraph.GraphBuilder, np.random.default_rng(41),
                          requant)
    tp, ts = deconv_graph(tgraph.GraphBuilder, np.random.default_rng(41),
                          requant, device="cpu")
    assert_same_spec(js, ts)
    # Each builder record holds the plan of its layer's geometry.
    assert [len(p.deconv_plans) for p in tp] == [1, 1, 1, 1]
    x = images(42, (2, 5, 5, 8))
    want = jax_forward(jp, js, x)
    got = tgraph.graph_forward(tp, ts, torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (2, 59, 59, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    tp2 = tgraph.params_from_jax(jax.tree.map(np.asarray, jp), ts,
                                 device="cpu")
    assert [len(p.deconv_plans) for p in tp2] == [1, 1, 1, 1]
    np.testing.assert_array_equal(
        tgraph.graph_forward(tp2, ts, torch.from_numpy(x)).numpy(), want)


@functools.lru_cache(maxsize=None)
def jax_enet(seed):
    from qnnpack_tpu.models.enet import enet_seg
    return enet_seg(np.random.default_rng(seed), input_size=32)


@functools.lru_cache(maxsize=None)
def jax_enet_output(seed, x_seed):
    jp, js = jax_enet(seed)
    return jax_forward(jp, js, images(x_seed, (2, 32, 32, 3)))


@pytest.mark.parametrize("weights", ["own_builder", "params_from_jax",
                                     "checkpoint_with_spec",
                                     "checkpoint_without_spec",
                                     "jax_checkpoint"])
def test_enet_matches_jax(weights, tmp_path):
    from qnnpack_tpu.utils import checkpoint as jckpt
    from qnnpack_tpu_torch.models.enet import enet_seg
    from qnnpack_tpu_torch.utils import checkpoint as tckpt
    jp, js = jax_enet(13)
    tp, ts = enet_seg(np.random.default_rng(13), input_size=32,
                      device="cpu")
    assert_same_spec(js, ts)
    path = str(tmp_path / "enet.npz")
    if weights == "params_from_jax":
        tp = tgraph.params_from_jax(jax.tree.map(np.asarray, jp), ts,
                                    device="cpu")
    elif weights == "checkpoint_with_spec":
        tckpt.save_params(path, tp, ts)
        tp = tckpt.load_params(path, device="cpu", spec=ts)
    elif weights == "checkpoint_without_spec":
        tckpt.save_params(path, tp, ts)
        tp = tckpt.load_params(path, device="cpu")
    elif weights == "jax_checkpoint":
        jckpt.save_params(path, jp)
        tp = tckpt.load_params(path, device="cpu", spec=ts)
    deconvs = [p for (tag, _, _), p in zip(ts.layers, tp) if tag == "deconv"]
    assert len(deconvs) == 3
    # A checkpoint keeps no geometry: with the spec, loading builds each
    # deconv plan; without it, the first forward does.
    assert {len(p.deconv_plans) for p in deconvs} == (
        {0} if weights == "checkpoint_without_spec" else {1})
    got = tgraph.graph_forward(tp, ts, torch.from_numpy(images(14, (
        2, 32, 32, 3))))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (2, 32, 32, 12)
    np.testing.assert_array_equal(got.numpy(), jax_enet_output(13, 14))
    assert {len(p.deconv_plans) for p in deconvs} == {1}
    for p in deconvs:
        plan = next(iter(p.deconv_plans.values()))
        assert plan.lowering == "k_eq_s"
        assert isinstance(plan.record, PackedGemmWeights)


def test_enet_layers_and_kernels():
    """One forward: the stem on q8stem, 11 convs on q8conv, 16 1x1 convs
    and the 3 k == s deconvs on q8gemm, 7 adds on q8vadd."""
    from qnnpack_tpu_torch.models.enet import enet_seg
    from qnnpack_tpu_torch.nn.conv import dense_conv_route
    tp, ts = enet_seg(np.random.default_rng(13), input_size=32, device="cpu")
    routes = []
    for (tag, _, payload), p in zip(ts.layers, tp):
        if tag == "conv":
            routes.append(dense_conv_route(p, payload.strides))
        elif tag in ("gemm", "deconv", "add"):
            routes.append({"gemm": "q8gemm", "deconv": "q8gemm",
                           "add": "q8vadd"}[tag])
    assert {r: routes.count(r) for r in set(routes)} == {
        "q8stem": 1, "q8conv": 11, "q8gemm": 19, "q8vadd": 7}


def test_enet_entry_input_and_output_shape():
    from qnnpack_tpu_torch.entry import MODELS, input_shape
    assert "enet_seg" in MODELS
    assert input_shape("enet_seg") == (256, 256, 3)


@functools.lru_cache(maxsize=None)
def jax_model(name, seed):
    return getattr(jzoo, name)(np.random.default_rng(seed))


@pytest.mark.parametrize("weights", ["own_builder", "params_from_jax"])
@pytest.mark.parametrize("name,size", [("resnet18", 32),
                                       ("squeezenet_v11", 64)])
def test_zoo_model_matches_jax(name, size, weights):
    jp, js = jax_model(name, 5)
    tp, ts = getattr(tzoo, name)(np.random.default_rng(5), device="cpu")
    assert_same_spec(js, ts)
    if weights == "params_from_jax":
        tp = tgraph.params_from_jax(jax.tree.map(np.asarray, jp), ts,
                                    device="cpu")
    x = images(6, (2, size, size, 3))
    got = tgraph.GraphModel(tp, ts)(torch.from_numpy(x))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (2, 1000)
    np.testing.assert_array_equal(got.numpy(), jax_forward(jp, js, x))


@pytest.mark.parametrize("name", ["resnet18", "squeezenet_v11"])
def test_params_from_jax_gives_the_kernel_fields_of_raw_packing(name):
    """params_from_jax derives the same K-major weights and raw-uint8 bias
    as the port's builder packing the raw weights, conv and GEMM alike."""
    jp, _ = jax_model(name, 5)
    tp, ts = getattr(tzoo, name)(np.random.default_rng(5), device="cpu")
    ported = tgraph.params_from_jax(jax.tree.map(np.asarray, jp), ts,
                                    device="cpu")
    checked = 0
    for own, got in zip(tp, ported):
        if own is None:
            assert got is None
            continue
        assert type(own) is type(got)
        assert torch.equal(got.w_kmajor, own.w_kmajor)
        assert torch.equal(got.bias_c, own.bias_c)
        checked += 1
    assert checked > 10


def test_resnet18_entry_224_matches_jax():
    # The entry point's model: seed 0, 224, fp32, the same example input.
    rng = np.random.default_rng(0)
    jp, js = jzoo.resnet18(rng)
    x = rng.integers(0, 256, (1, 224, 224, 3), dtype=np.int64).astype(np.uint8)
    fn, (tp, tx) = entry(device="cpu", model="resnet18")
    np.testing.assert_array_equal(tx.numpy(), x)
    assert_same_spec(js, fn.spec)
    tkernels.reset_launch_counts()
    got = fn(tp, tx)
    assert tuple(got.shape) == (1, 1000) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), jax_forward(jp, js, x))
    assert set(tkernels.launch_counts().values()) == {0}
    # 16 3x3 bodies + 3 strided 1x1 projections on q8conv, the 7x7 stem
    # on q8stem, the pool on u8maxpool, 8 adds, gap, fc.
    kinds = [t for t, _, _ in js.layers]
    assert (kinds.count("conv"), kinds.count("gemm"), kinds.count("add"),
            kinds.count("maxpool"), kinds.count("gap")) == (20, 1, 8, 1, 1)


def test_server_answers_resnet18_requests():
    model = tgraph.GraphModel(*tzoo.resnet18(np.random.default_rng(8),
                                             num_classes=10, device="cpu"))
    imgs = images(9, (5, 32, 32, 3))
    direct = model(torch.from_numpy(imgs)).numpy()
    with InferenceServer(model, (32, 32, 3), device="cpu",
                         max_batch=4) as server:
        futures = [server.submit(img, block=True) for img in imgs]
        answers = [f.result(timeout=60) for f in futures]
    for i, ans in enumerate(answers):
        np.testing.assert_array_equal(ans, direct[i])
    assert server.stats.requests == 5 and server.stats.batches >= 2


def test_entry_rejects_unknown_model():
    with pytest.raises(ValueError, match="resnet18"):
        entry(device="cpu", model="vgg16")


BUILDERS = {
    # case -> (builder, keyword arguments)
    "resnet18": ("resnet18", {}),
    "resnet50": ("resnet50", {}),
    "squeezenet_v10": ("squeezenet_v10", {}),
    "squeezenet_v11": ("squeezenet_v11", {}),
    "mobilenet_v1": ("mobilenet_v1", {}),
    "shufflenet_v1_g1": ("shufflenet_v1", {"groups": 1}),
    "shufflenet_v1_g3": ("shufflenet_v1", {"groups": 3}),
    "shufflenet_v1_g8": ("shufflenet_v1", {"groups": 8}),
    "shufflenet_v2_x0.5": ("shufflenet_v2", {"width": 0.5}),
    "shufflenet_v2_x1.0": ("shufflenet_v2", {"width": 1.0}),
}


@pytest.mark.parametrize("name", list(BUILDERS))
def test_builder_rng_matches_jax(name, monkeypatch):
    """Same seed, same raw weights and specs.  The JAX weight packing is
    stubbed out here: the raw weights do not depend on it."""
    builder, kwargs = BUILDERS[name]
    monkeypatch.setattr(jgraph, "pack_conv_weights", lambda *a, **k: None)
    monkeypatch.setattr(jgraph, "pack_gemm_weights", lambda *a, **k: None)
    _, js = getattr(jzoo, builder)(np.random.default_rng(9), **kwargs)
    _, ts = getattr(tzoo, builder)(np.random.default_rng(9), device="cpu",
                                   **kwargs)
    assert_same_spec(js, ts)


def test_params_from_jax_checks_shapes_and_records():
    jp, js = jax_model("squeezenet_v11", 5)
    _, ts = tzoo.squeezenet_v11(np.random.default_rng(5), device="cpu")
    arrays = [None if r is None else {"w": np.asarray(r.w),
                                      "bias_folded": np.asarray(r.bias_folded)}
              for r in jp]
    first = next(i for i, d in enumerate(arrays) if d is not None)
    bad = list(arrays)
    bad[first] = {"w": arrays[first]["w"][:-1],
                  "bias_folded": arrays[first]["bias_folded"]}
    with pytest.raises(ValueError, match="conv1"):
        tgraph.params_from_jax(bad, ts, device="cpu")
    weightless = next(i for i, d in enumerate(arrays) if d is None)
    bad = list(arrays)
    bad[weightless] = arrays[first]
    with pytest.raises(ValueError, match="weightless"):
        tgraph.params_from_jax(bad, ts, device="cpu")
    with pytest.raises(ValueError):
        tgraph.params_from_jax(arrays[:-1], ts, device="cpu")
