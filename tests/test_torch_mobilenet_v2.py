"""MobileNetV2 end to end: the port against the JAX package.

The same seed builds both models; the raw weights, the layer specs and the
requant params must agree, and the forward must give the same uint8 logits
- through the port's own builder and through params_from_jax, for the tiny
config of tests/test_mobilenet_v2.py (q31 and fp32) and for the full 224
fp32 config at batch 1 (the entry point's forward).  Also the port's
InferenceServer on the CPU."""

import dataclasses
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qnnpack_tpu.models import mobilenet_v2 as jm
from qnnpack_tpu_torch import kernels as tkernels
from qnnpack_tpu_torch.entry import entry
from qnnpack_tpu_torch.models import mobilenet_v2 as tm
from qnnpack_tpu_torch.serving import InferenceServer, ServerOverloadedError

TINY = dict(input_size=32, num_classes=10,
            cfg=[(1, 8, 1, 1), (6, 16, 2, 2), (6, 24, 1, 1)],
            stem_channels=8, head_channels=32)


def build_both(seed, **kw):
    jparams, jspec = jm.build_mobilenet_v2(np.random.default_rng(seed), **kw)
    tparams, tspec = tm.build_mobilenet_v2(np.random.default_rng(seed),
                                           device="cpu", **kw)
    return (jparams, jspec), (tparams, tspec)


def jax_forward(params, spec, x):
    return np.asarray(jax.jit(
        lambda p, v: jm.mobilenet_v2_forward(p, spec, v))(params,
                                                          jnp.asarray(x)))


def assert_same_spec(jspec, tspec):
    assert len(jspec.layers) == len(tspec.layers)
    for (jt, jn, jl), (tt, tn, tl) in zip(jspec.layers, tspec.layers):
        assert (jt, jn) == (tt, tn)
        if jl is None:
            assert tl is None
        elif jt == "conv":
            assert (jl.kind, jl.strides, jl.padding, jl.groups) == \
                (tl.kind, tl.strides, tl.padding, tl.groups)
            assert dataclasses.asdict(jl.rparams) == \
                dataclasses.asdict(tl.rparams)
        else:
            assert dataclasses.asdict(jl) == dataclasses.asdict(tl)
    for jr, tr in zip(jspec.raw_weights, tspec.raw_weights):
        if jr is None:
            assert tr is None
        else:
            np.testing.assert_array_equal(jr[0], tr[0])
            np.testing.assert_array_equal(jr[1], tr[1])


@pytest.mark.parametrize("requant", ["q31", "fp32"])
@pytest.mark.parametrize("weights", ["own_builder", "params_from_jax"])
def test_tiny_config_matches_jax(requant, weights):
    (jp, js), (tp, ts) = build_both(11, requant=requant, **TINY)
    assert_same_spec(js, ts)
    if weights == "params_from_jax":
        tp = tm.params_from_jax(jax.tree.map(np.asarray, jp), ts,
                                device="cpu")
    x = np.random.default_rng(12).integers(0, 256, (2, 32, 32, 3),
                                           dtype=np.int64).astype(np.uint8)
    want = jax_forward(jp, js, x)
    got = tm.mobilenet_v2_forward(tp, ts, torch.from_numpy(x))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (2, 10)
    np.testing.assert_array_equal(got.numpy(), want)


def test_params_from_jax_accepts_dicts_and_checks_shapes():
    (jp, _), (tp, ts) = build_both(3, requant="fp32", **TINY)
    dicts = [None if r is None else {"w": np.asarray(r.w),
                                     "bias_folded": np.asarray(r.bias_folded)}
             for r in jp]
    got = tm.params_from_jax(dicts, ts, device="cpu")
    for g, t in zip(got, tp):
        if t is None:
            assert g is None
        else:
            assert torch.equal(g.w, t.w)
            assert torch.equal(g.bias_folded, t.bias_folded)
    first = next(i for i, d in enumerate(dicts) if d is not None)
    dicts[first] = {"w": dicts[first]["w"][:-1],
                    "bias_folded": dicts[first]["bias_folded"]}
    with pytest.raises(ValueError):
        tm.params_from_jax(dicts, ts, device="cpu")


def test_module_forward_equals_function():
    model = tm.MobileNetV2.build(5, device="cpu", requant="q31", **TINY)
    x = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (3, 32, 32, 3), dtype=np.int64).astype(np.uint8))
    assert torch.equal(model(x), tm.mobilenet_v2_forward(model.params,
                                                         model.spec, x))


def test_full_224_fp32_batch1_matches_jax():
    # The entry point's model: seed 0, 224, fp32, the same example input.
    rng = np.random.default_rng(0)
    jp, js = jm.build_mobilenet_v2(rng, input_size=224, requant="fp32")
    x = rng.integers(0, 256, (1, 224, 224, 3), dtype=np.int64).astype(np.uint8)
    want = jax_forward(jp, js, x)

    fn, (tp, tx) = entry(device="cpu")
    np.testing.assert_array_equal(tx.numpy(), x)
    tkernels.reset_launch_counts()
    got = fn(tp, tx)
    assert tuple(got.shape) == (1, 1000) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    # The plain path on the CPU launches no kernel.
    assert set(tkernels.launch_counts().values()) == {0}

    conv_layers = [layer for layer in js.layers if layer[0] == "conv"]
    assert len(conv_layers) == 53
    by_kind = {}
    for tag, _, layer in js.layers:
        key = layer.kind if tag == "conv" else tag
        by_kind[key] = by_kind.get(key, 0) + 1
    # 35 GEMM layers on q8gemm, the stem (q8stem), 17 depthwise, 10 adds,
    # 1 pool.
    assert (by_kind["gemm"], by_kind["conv"], by_kind["dwconv"],
            by_kind["add"], by_kind["gap"]) == (35, 1, 17, 10, 1)


def tiny_model():
    params, spec = tm.build_mobilenet_v2(np.random.default_rng(2),
                                         device="cpu", requant="fp32", **TINY)
    return lambda xb: tm.mobilenet_v2_forward(params, spec, xb)


def test_server_answers_match_batch_forward():
    fwd = tiny_model()
    images = np.random.default_rng(4).integers(
        0, 256, (11, 32, 32, 3), dtype=np.int64).astype(np.uint8)
    direct = fwd(torch.from_numpy(images)).numpy()
    with InferenceServer(fwd, (32, 32, 3), device="cpu",
                         max_batch=4) as server:
        futures = [server.submit(img, block=True) for img in images]
        answers = [f.result(timeout=60) for f in futures]
    for i, ans in enumerate(answers):
        np.testing.assert_array_equal(ans, direct[i])
    assert server.stats.requests == 11
    assert server.stats.batches >= 3
    assert 0 < server.stats.occupancy <= 1


def test_server_fans_failures_out_to_every_future():
    def broken(_):
        raise RuntimeError("device lost")

    with InferenceServer(broken, (4,), device="cpu", max_batch=4,
                         batch_timeout_s=0.05) as server:
        futures = [server.submit(np.zeros(4, np.uint8)) for _ in range(3)]
        for f in futures:
            with pytest.raises(RuntimeError, match="device lost"):
                f.result(timeout=30)


def test_server_rejects_when_queue_full():
    release = threading.Event()

    def slow(xb):
        release.wait(30)
        return xb

    with InferenceServer(slow, (2,), device="cpu", max_batch=1,
                         max_queue=2) as server:
        futures, rejected = [], 0
        for _ in range(8):
            try:
                futures.append(server.submit(np.zeros(2, np.uint8)))
            except ServerOverloadedError:
                rejected += 1
        release.set()
        for f in futures:
            f.result(timeout=30)
    assert rejected > 0 and server.stats.rejected == rejected


def test_server_checks_sample_shape():
    with InferenceServer(lambda xb: xb, (2, 2), device="cpu") as server:
        with pytest.raises(ValueError):
            server.submit(np.zeros((3, 2), np.uint8))
