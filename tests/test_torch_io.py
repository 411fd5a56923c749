"""The port's host IO (qnnpack_tpu_torch/io/) against the JAX package's
(qnnpack_tpu/io/), mirroring tests/test_native_io.py:

- accuracy: every metric, synth_images and quantize_input equal the JAX
  functions on seeded inputs;
- native: the library the port builds from native/ (into its own build
  directory) - the C requantization oracles against the JAX package's C
  oracles, its numpy oracles and the port's own requantize functions;
  resize_quantize_batch, quantize and dequantize against the JAX functions
  (the same C) and against the port's plain numpy versions; and an error,
  not a fallback, where the library cannot be built;
- pipeline: BatchPrefetcher / image_pipeline end to end on device="cpu",
  in order, equal to the JAX pipeline's batches, and a failing source's
  exception raised on the consumer's side.
"""

import numpy as np
import pytest
import torch

from qnnpack_tpu.io import accuracy as jacc
from qnnpack_tpu.io import native as jnative
from qnnpack_tpu.quant import oracles, params as jparams
from qnnpack_tpu_torch.io import BatchPrefetcher, image_pipeline
from qnnpack_tpu_torch.io import accuracy as tacc
from qnnpack_tpu_torch.io import native as tnative
from qnnpack_tpu_torch.quant import params as tparams
from qnnpack_tpu_torch.quant import requantize as treq

RNG_SEED = 0xC0DE


def rng(salt=0):
    return np.random.default_rng(RNG_SEED + salt)


# --- accuracy ---------------------------------------------------------------


def logits_pair(salt, shape=(64, 1000)):
    r = rng(salt)
    a = r.integers(0, 256, shape, dtype=np.int64).astype(np.uint8)
    b = np.clip(a.astype(np.int32) + r.integers(-2, 3, shape), 0,
                255).astype(np.uint8)
    return a, b


@pytest.mark.parametrize("tolerance", [0, 1, 3])
def test_element_agreement_equals_jax(tolerance):
    a, b = logits_pair(1)
    assert tacc.element_agreement(a, b, tolerance) == \
        jacc.element_agreement(a, b, tolerance)
    with pytest.raises(ValueError, match="shape mismatch"):
        tacc.element_agreement(a, b[:-1])


def test_top1_metrics_equal_jax():
    a, b = logits_pair(2)
    labels = rng(3).integers(0, 1000, 64)
    assert tacc.top1_agreement(a, b) == jacc.top1_agreement(a, b)
    assert tacc.top1_accuracy(a, labels) == jacc.top1_accuracy(a, labels)
    assert 0.0 < tacc.top1_agreement(a, b) < 1.0


@pytest.mark.parametrize("shape", [(64, 1000), (7, 2), (3, 5, 10)])
def test_margin_and_diff_stats_equal_jax(shape):
    a, b = logits_pair(4, shape)
    assert tacc.margin_stats(a) == jacc.margin_stats(a)
    assert tacc.diff_stats(a, b) == jacc.diff_stats(a, b)


def test_margin_stats_rejects_single_channel():
    with pytest.raises(ValueError, match="2 channels"):
        tacc.margin_stats(np.zeros((4, 1), np.uint8))


@pytest.mark.parametrize("n,size,seed", [(2, 224, 17), (3, 57, 4),
                                         (1, 28, 0)])
def test_synth_images_equal_jax(n, size, seed):
    got = tacc.synth_images(n, size=size, seed=seed)
    want = jacc.synth_images(n, size=size, seed=seed)
    assert got.dtype == np.float32 and got.shape == (n, size, size, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scale,zp", [(0.0078431, 0), (1 / 128, -1),
                                      (0.02, 17), (0.5, -128)])
def test_quantize_input_equals_jax(scale, zp):
    x = tacc.synth_images(2, size=32, seed=5)
    got = tacc.quantize_input(x, scale, zp)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, jacc.quantize_input(x, scale, zp))


# --- native -----------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_native():
    if not jnative.native_available():
        pytest.skip("the JAX package's native library did not build")
    return jnative


def int32_samples(salt):
    return rng(salt).integers(-(2**31), 2**31, 4096,
                              dtype=np.int64).astype(np.int32)


ORACLES = {
    "q31": (oracles.oracle_q31, jparams.compute_q31_params,
            treq.requantize_q31, tparams.compute_q31_params),
    "precise": (oracles.oracle_precise, jparams.compute_precise_params,
                treq.requantize_precise, tparams.compute_precise_params),
    "fp32": (oracles.oracle_fp32, jparams.compute_fp32_params,
             treq.requantize_fp32, tparams.compute_fp32_params),
    "gemmlowp": (oracles.oracle_gemmlowp, jparams.compute_gemmlowp_params,
                 treq.requantize_gemmlowp, tparams.compute_gemmlowp_params),
}


@pytest.mark.parametrize("scheme", list(ORACLES))
@pytest.mark.parametrize("scale", [0.5, 0.125, 0.0003, 2**-20, 0.999])
@pytest.mark.parametrize("zp", [0, 128, 255])
def test_c_requantize_matches_numpy_and_port_requantize(scheme, scale, zp):
    x = int32_samples(zp)
    oracle, jcompute, requant, tcompute = ORACLES[scheme]
    got = tnative.c_requantize(scheme, x, scale, zp)
    np.testing.assert_array_equal(got, oracle(x, jcompute(scale, zp)))
    port = requant(torch.from_numpy(x), tcompute(scale, zp)).numpy()
    np.testing.assert_array_equal(got, port)


@pytest.mark.parametrize("scheme", list(ORACLES))
def test_c_requantize_equals_jax_c_oracle(jax_native, scheme):
    x = int32_samples(7)
    for scale, zp, lo, hi in ((0.3, 128, 0, 255), (2**-17, 3, 10, 240)):
        np.testing.assert_array_equal(
            tnative.c_requantize(scheme, x, scale, zp, lo, hi),
            jax_native.c_requantize(scheme, x, scale, zp, lo, hi))


def test_c_requantize_rejects_unknown_scheme():
    with pytest.raises(ValueError, match="unknown scheme"):
        tnative.c_requantize("q15", np.zeros(4, np.int32), 0.5, 0)


def images(salt, shape):
    return (rng(salt).standard_normal(shape) * 10).astype(np.float32)


@pytest.mark.parametrize("shape,out_hw", [((4, 37, 53, 3), (224, 224)),
                                          ((2, 224, 224, 3), (112, 96)),
                                          ((1, 5, 7, 1), (1, 1))])
def test_resize_quantize_equals_jax_and_plain(jax_native, shape, out_hw):
    imgs = images(8, shape)
    got = tnative.resize_quantize_batch(imgs, out_hw, 0.1, 128)
    assert got.shape == (shape[0],) + out_hw + (shape[3],)
    np.testing.assert_array_equal(
        got, jax_native.resize_quantize_batch(imgs, out_hw, 0.1, 128))
    plain = tnative.resize_quantize_plain(imgs, out_hw, 0.1, 128)
    np.testing.assert_array_equal(
        plain, jax_native._numpy_resize_quantize(imgs, out_hw, 0.1, 128))
    # lrintf(v * (1 / scale)) against rint(v / scale): one quantum apart
    # at most, rarely.
    diff = got.astype(np.int32) - plain.astype(np.int32)
    assert np.abs(diff).max() <= 1
    assert (diff != 0).mean() < 0.01


def test_identity_resize_is_quantize():
    imgs = images(9, (2, 16, 16, 3)) / 10
    np.testing.assert_array_equal(
        tnative.resize_quantize_batch(imgs, (16, 16), 0.05, 128),
        tnative.quantize(imgs, 0.05, 128))


@pytest.mark.parametrize("scale,zp", [(0.05, 128), (0.0078431, 0),
                                      (0.3, 250)])
def test_quantize_dequantize_equal_jax(jax_native, monkeypatch, scale, zp):
    x = images(10, (1000,)) / 10
    q = tnative.quantize(x, scale, zp)
    np.testing.assert_array_equal(q, jax_native.quantize(x, scale, zp))
    d = tnative.dequantize(q, scale, zp)
    np.testing.assert_array_equal(d, jax_native.dequantize(q, scale, zp))
    assert np.abs(tnative.quantize_plain(x, scale, zp).astype(np.int32)
                  - q).max() <= 1
    # The plain versions against the JAX package's numpy fallbacks.
    monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    np.testing.assert_array_equal(tnative.quantize_plain(x, scale, zp),
                                  jax_native.quantize(x, scale, zp))
    np.testing.assert_array_equal(tnative.dequantize_plain(q, scale, zp),
                                  jax_native.dequantize(q, scale, zp))
    np.testing.assert_array_equal(
        tnative.resize_quantize_plain(images(11, (2, 9, 9, 3)), (5, 5),
                                      scale, zp),
        jax_native.resize_quantize_batch(images(11, (2, 9, 9, 3)), (5, 5),
                                         scale, zp))


def test_quantize_dequantize_roundtrip():
    x = images(12, (1000,)) / 10
    d = tnative.dequantize(tnative.quantize(x, 0.05, 128), 0.05, 128)
    assert np.abs(d - np.clip(x, -128 * 0.05, 127 * 0.05)).max() <= 0.026


def test_library_is_built_into_the_port_build_directory():
    assert tnative.native_available()
    path = tnative.library_path()
    assert path.parent == tnative.BUILD_DIR and path.exists()
    assert path.parent != tnative.NATIVE_DIR
    assert sorted(tnative.SOURCES) == sorted(
        p.name for p in tnative.NATIVE_DIR.iterdir()
        if p.suffix in (".c", ".cpp"))


def test_no_fallback_when_the_library_cannot_be_built(monkeypatch,
                                                      tmp_path):
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CC", str(tmp_path / "no-cc"))
    monkeypatch.setenv("CXX", str(tmp_path / "no-cxx"))
    assert not tnative.native_available()
    with pytest.raises(RuntimeError, match="native library"):
        tnative.quantize(np.zeros(4, np.float32), 0.1, 0)
    with pytest.raises(RuntimeError, match="native library"):
        tnative.resize_quantize_batch(np.zeros((1, 2, 2, 1), np.float32),
                                      (2, 2), 0.1, 0)


# --- pipeline ---------------------------------------------------------------


def float_batches(n=5):
    return [images(20 + i, (2, 32, 32, 3)) / 10 for i in range(n)]


def test_image_pipeline_end_to_end_equals_jax():
    from qnnpack_tpu.io import image_pipeline as jax_image_pipeline
    batches = float_batches()
    out = list(image_pipeline(batches, (16, 16), 0.1, 128, prefetch=2,
                              device="cpu"))
    want = [np.asarray(y) for y in jax_image_pipeline(batches, (16, 16),
                                                      0.1, 128, prefetch=2)]
    assert len(out) == len(want) == 5
    for src, o, w in zip(batches, out, want):
        assert isinstance(o, torch.Tensor) and o.device.type == "cpu"
        assert tuple(o.shape) == (2, 16, 16, 3) and o.dtype == torch.uint8
        np.testing.assert_array_equal(o.numpy(), w)
        np.testing.assert_array_equal(
            o.numpy(), tnative.resize_quantize_batch(src, (16, 16), 0.1, 128))


@pytest.mark.parametrize("prefetch", [1, 3])
def test_prefetcher_keeps_order_and_preprocess(prefetch):
    batches = [np.full((1, 2, 2, 3), i, np.uint8) for i in range(7)]
    out = list(BatchPrefetcher(batches, preprocess=lambda b: b + 1,
                               prefetch=prefetch, device="cpu"))
    assert [int(o[0, 0, 0, 0]) for o in out] == list(range(1, 8))
    assert list(BatchPrefetcher([], device="cpu")) == []


def test_prefetcher_propagates_errors():
    def bad_source():
        yield np.zeros((1, 4, 4, 3), np.float32)
        raise RuntimeError("source failed")

    it = BatchPrefetcher(bad_source(), device="cpu")
    first = next(it)
    assert tuple(first.shape) == (1, 4, 4, 3)
    with pytest.raises(RuntimeError, match="source failed"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)


def test_prefetcher_propagates_preprocess_errors():
    def preprocess(b):
        raise ValueError("bad batch")

    it = BatchPrefetcher([np.zeros((1, 2), np.uint8)], preprocess=preprocess,
                         device="cpu")
    with pytest.raises(ValueError, match="bad batch"):
        next(it)
