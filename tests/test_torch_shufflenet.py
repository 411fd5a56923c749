"""ShuffleNet on the port's graph runtime against the JAX package.

- x8zip (the channel shuffle) gives the JAX x8zip's bytes.
- The concat + shuffle peephole of graph_forward gives the bytes of the
  unfused pair, and is taken only where the JAX executor takes it.
- ShuffleNet v1 g3 (64x64, batch 2; through the port's builder and through
  params_from_jax) and ShuffleNet v2 x0.5 (64x64) give the JAX forward's
  logits; so does the ShuffleNet v1 g3 entry point at 224, and the port's
  InferenceServer answers ShuffleNet requests with the batch rows.
Comparisons are exact."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qnnpack_tpu.models import graph as jgraph
from qnnpack_tpu.models import zoo as jzoo
from qnnpack_tpu.nn.elementwise import x8zip as jx8zip
from qnnpack_tpu_torch import kernels as tkernels
from qnnpack_tpu_torch.entry import entry
from qnnpack_tpu_torch.models import graph as tgraph
from qnnpack_tpu_torch.models import zoo as tzoo
from qnnpack_tpu_torch.nn.elementwise import x8zip
from qnnpack_tpu_torch.serving import InferenceServer
from test_torch_graph import assert_same_spec, images, jax_forward


@pytest.mark.parametrize("shape,groups", [
    ((2, 3, 4, 60), 3), ((1, 5, 5, 240), 3), ((7, 12), 2), ((2, 2, 2, 48), 8),
    ((3, 16), 4), ((1, 1, 1, 6), 1)])
def test_x8zip_matches_jax(shape, groups):
    x = images(1, shape)
    got = x8zip(torch.from_numpy(x), groups)
    assert got.is_contiguous() and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jx8zip(jnp.asarray(x), groups)))


def test_x8zip_rejects_uneven_groups():
    with pytest.raises(ValueError):
        x8zip(torch.zeros(1, 10, dtype=torch.uint8), 3)


def concat_shuffle_graph(builder_cls, rng, widths, groups, **kw):
    """Equal or unequal-width branches, concatenated and shuffled."""
    g = builder_cls(rng, "fp32", **kw)
    g.save("in")
    slots = []
    for i, width in enumerate(widths):
        g.load("in")
        g.conv(f"b{i}", 6, width, kernel=(1, 1), padding=((0, 0), (0, 0)))
        g.save(f"s{i}")
        slots.append(f"s{i}")
    g.concat("cat", slots)
    g.shuffle("shuf", groups)
    return g.finish(name="concat_shuffle")


@pytest.mark.parametrize("widths,groups,fused", [
    ((8, 8), 2, True), ((4, 4, 4), 3, True), ((6, 10), 2, False),
    ((8, 8), 4, False)])
def test_concat_shuffle_peephole(widths, groups, fused, monkeypatch):
    jp, js = concat_shuffle_graph(jgraph.GraphBuilder,
                                  np.random.default_rng(3), widths, groups)
    tp, ts = concat_shuffle_graph(tgraph.GraphBuilder,
                                  np.random.default_rng(3), widths, groups,
                                  device="cpu")
    x = images(4, (2, 5, 5, 6))
    # The unfused pair, layer by layer.
    env, y = {}, torch.from_numpy(x)
    for (tag, _, payload), p in zip(ts.layers, tp):
        y = tgraph._graph_layer(tag, payload, p, y, env)
    shuffles = []
    monkeypatch.setattr(tgraph, "x8zip",
                        lambda v, g: shuffles.append(g) or x8zip(v, g))
    got = tgraph.graph_forward(tp, ts, torch.from_numpy(x))
    assert torch.equal(got, y) and got.is_contiguous()
    assert shuffles == ([] if fused else [groups])
    np.testing.assert_array_equal(got.numpy(), jax_forward(jp, js, x))


@functools.lru_cache(maxsize=None)
def jax_model(name, seed, **kwargs):
    return getattr(jzoo, name)(np.random.default_rng(seed), **kwargs)


@pytest.mark.parametrize("weights", ["own_builder", "params_from_jax"])
def test_shufflenet_v1_g3_matches_jax(weights):
    jp, js = jax_model("shufflenet_v1", 5, groups=3)
    tp, ts = tzoo.shufflenet_v1(np.random.default_rng(5), groups=3,
                                device="cpu")
    assert_same_spec(js, ts)
    if weights == "params_from_jax":
        tp = tgraph.params_from_jax(jax.tree.map(np.asarray, jp), ts,
                                    device="cpu")
    x = images(6, (2, 64, 64, 3))
    got = tgraph.GraphModel(tp, ts)(torch.from_numpy(x))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (2, 1000)
    np.testing.assert_array_equal(got.numpy(), jax_forward(jp, js, x))


def test_shufflenet_v2_x05_matches_jax():
    jp, js = jax_model("shufflenet_v2", 5, width=0.5)
    tp, ts = tzoo.shufflenet_v2(np.random.default_rng(5), width=0.5,
                                device="cpu")
    assert_same_spec(js, ts)
    x = images(7, (2, 64, 64, 3))
    got = tgraph.graph_forward(tp, ts, torch.from_numpy(x))
    assert tuple(got.shape) == (2, 1000)
    np.testing.assert_array_equal(got.numpy(), jax_forward(jp, js, x))


def test_shufflenet_v1_g3_entry_224_matches_jax():
    # The entry point's model: seed 0, 224, fp32, the same example input.
    rng = np.random.default_rng(0)
    jp, js = jzoo.shufflenet_v1(rng, groups=3)
    x = rng.integers(0, 256, (1, 224, 224, 3), dtype=np.int64).astype(np.uint8)
    fn, (tp, tx) = entry(device="cpu", model="shufflenet_v1_g3")
    np.testing.assert_array_equal(tx.numpy(), x)
    assert_same_spec(js, fn.spec)
    tkernels.reset_launch_counts()
    got = fn(tp, tx)
    assert tuple(got.shape) == (1, 1000) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), jax_forward(jp, js, x))
    assert set(tkernels.launch_counts().values()) == {0}
    # stem, 15 grouped _g1, 16 _dw and 16 grouped _g2 convs; st0u0_g1 and
    # fc on q8gemm; 13 adds, 3 avgpool shortcuts, 15 shuffles, 3 concats.
    kinds = [t for t, _, _ in js.layers]
    assert {k: kinds.count(k) for k in ("conv", "gemm", "add", "avgpool",
                                        "shuffle", "concat", "maxpool",
                                        "gap")} == {
        "conv": 48, "gemm": 2, "add": 13, "avgpool": 3, "shuffle": 15,
        "concat": 3, "maxpool": 1, "gap": 1}
    grouped = [p for p in tp if getattr(p, "groups", 1) > 1
               and p.group_input_channels > 1]
    assert len(grouped) == 31


def test_server_answers_shufflenet_requests():
    model = tgraph.GraphModel(*tzoo.shufflenet_v1(
        np.random.default_rng(8), groups=3, num_classes=10, device="cpu"))
    imgs = images(9, (5, 64, 64, 3))
    direct = model(torch.from_numpy(imgs)).numpy()
    with InferenceServer(model, (64, 64, 3), device="cpu",
                         max_batch=4) as server:
        futures = [server.submit(img, block=True) for img in imgs]
        answers = [f.result(timeout=60) for f in futures]
    for i, ans in enumerate(answers):
        np.testing.assert_array_equal(ans, direct[i])
    assert server.stats.requests == 5 and server.stats.batches >= 2
