"""The port's runtime against the JAX package's, on the CPU.

- config: tune_params / initialize (the probe, the H100 row, no fallback
  from a GPU to the CPU), no JAX Config record;
- utils/logging.py: set_log_level and the log_* functions;
- utils/timing.py: measure_loop's contract (positive finite time, a
  power-of-two n, a dispersion) for chain=True and chain=False, the four
  perturbed copies, dispatch_overhead;
- utils/profiling.py: graph_cost and total_cost equal to the JAX ones,
  field for field, on the zoo's MobileNetV1, ResNet-18 and ShuffleNet v1
  g3 specs built from the same seed; trace() writes a Chrome trace;
- utils/checkpoint.py: bundles load across the two packages with equal
  forwards (MobileNetV1 0.25, 10 classes) and equal records, the derived
  kernel fields equal to a freshly packed record's, a non-null w_aug
  refused, and an imported graph's 1x1 conv records (GEMM weights in the
  port, conv records in the JAX package) equal in both directions;
- ops/base.py: jit_forward on CPU inputs equals fn and captures nothing,
  its cache key, Operator.lower/delete; the launch path's capture rules
  (per-graph split-K counters; per-channel scales only from device_scales
  during a capture, never from the cache) with torch.cuda's capture probe
  stubbed.
"""

import dataclasses
import functools
import json
import logging
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qnnpack_tpu import config as jconfig
from qnnpack_tpu import utils as jutils
from qnnpack_tpu.io import tflite_import as jt
from qnnpack_tpu.models import zoo as jzoo
from qnnpack_tpu.models.graph import graph_forward as jax_graph_forward
from qnnpack_tpu_torch import config as tconfig
from qnnpack_tpu_torch import kernels as tkernels
from qnnpack_tpu_torch import ops as tops
from qnnpack_tpu_torch import utils as tutils
from qnnpack_tpu_torch.io import tflite_import as tt
from qnnpack_tpu_torch.kernels import _build
from qnnpack_tpu_torch.kernels import q8gemm as tq8gemm
from qnnpack_tpu_torch.models import zoo as tzoo
from qnnpack_tpu_torch.models.graph import graph_forward, params_from_jax
from qnnpack_tpu_torch.nn.conv import PackedConvWeights, pack_conv_weights
from qnnpack_tpu_torch.nn.packing import PackedGemmWeights
from qnnpack_tpu_torch.ops.base import JitForward, jit_forward
from qnnpack_tpu_torch.quant import params as tqparams
from qnnpack_tpu_torch.utils import timing as ttiming

ROOT = Path(__file__).resolve().parents[1]
SQUEEZENET = ROOT / "assets" / "squeezenet_v11_int8.tflite"


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def image(seed, batch=1, size=224):
    return np.random.default_rng(seed).integers(
        0, 256, (batch, size, size, 3), dtype=np.int64).astype(np.uint8)


# ------------------------------------------------------------------ config
def test_tune_params_cpu_and_initialize_idempotent():
    tp = tconfig.tune_params("cpu")
    assert tp.generation == "cpu" == jconfig.tune_params().generation
    assert tconfig.initialize("cpu") is tp
    assert tconfig.initialize("cpu") is tp
    assert tconfig.tune_params("cpu") is tp


def test_tune_params_never_falls_back_to_the_cpu(no_gpu):
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tconfig.tune_params()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tconfig.initialize()


@pytest.mark.parametrize("name,generation,tops,gbps", [
    ("NVIDIA H100 80GB HBM3", "h100", 1979.0, 3350.0),
    ("NVIDIA A100-SXM4-80GB", "generic", 0.0, 0.0)])
def test_device_probe_table(monkeypatch, name, generation, tops, gbps):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev: name)
    tp = tconfig._probe.__wrapped__(torch.device("cuda", 0))
    assert (tp.generation, tp.int8_peak_tops, tp.hbm_gbps) == \
        (generation, tops, gbps)


def test_tune_params_drops_the_pallas_routing_fields():
    fields = {f.name for f in tconfig.TuneParams.__dataclass_fields__
              .values()}
    assert fields == {"generation", "int8_peak_tops", "hbm_gbps"}
    # The JAX Config's fields (pallas_mode, compilation_cache_dir and the
    # default_requant that no code reads) have nothing to set in the port.
    assert hasattr(jconfig, "Config")
    assert not hasattr(tconfig, "Config") and not hasattr(tconfig, "config")


def test_chip_smoke_reads_the_peaks_from_the_table(monkeypatch):
    import chip_smoke
    monkeypatch.setattr(tconfig, "tune_params",
                        lambda device="cuda": tconfig._TUNE_TABLE[
                            "nvidia h100"])
    assert chip_smoke.card_peaks() == (3350.0e9, 1979.0e12)


def test_chip_smoke_names_every_kernel(monkeypatch):
    """chip_smoke.py counts launches over kernels.KERNELS, maps each kernel
    to its source and JAX counterpart in SOURCES, and refuses to start
    where SOURCES names another set."""
    import chip_smoke
    assert set(chip_smoke.EXPECTED_LAUNCHES["resnet18"]) == \
        set(tkernels.KERNELS)
    assert set(chip_smoke.SOURCES) == set(tkernels.KERNELS)
    for source, _ in chip_smoke.SOURCES.values():
        assert (ROOT / source).is_file(), source
    monkeypatch.delitem(chip_smoke.SOURCES, "q8attn_masked")
    assert chip_smoke.main() == 2


# ----------------------------------------------------------------- logging
@pytest.mark.parametrize("level", ["debug", "info", "warning", "error",
                                   "fatal", "none"])
def test_set_log_level(level):
    before = (tutils.logger.level, jutils.logger.level)
    want = {"debug": logging.DEBUG, "info": logging.INFO,
            "warning": logging.WARNING, "error": logging.ERROR,
            "fatal": logging.CRITICAL, "none": logging.CRITICAL + 10}[level]
    try:
        tutils.set_log_level(level.upper())
        jutils.set_log_level(level)
        assert tutils.logger.level == jutils.logger.level == want
    finally:
        tutils.logger.setLevel(before[0])
        jutils.logger.setLevel(before[1])


def test_log_functions_are_the_loggers():
    for name in ("debug", "info", "warning", "error"):
        assert getattr(tutils, f"log_{name}") == getattr(tutils.logger, name)


# ------------------------------------------------------------------ timing
@pytest.fixture
def one_thread():
    """One intra-op thread for the test, the previous count restored after.
    Next to the other test workers, torch's default of a thread a core
    oversubscribes the host, and measure_loop chases the jitter that makes
    by doubling its iterations up to max_iters."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("chain", [True, False])
def test_measure_loop_on_cpu_tensors(chain):
    w = torch.ones((64, 64), dtype=torch.float32)
    m = ttiming.measure_loop(lambda v: torch.matmul(v, w),
                             torch.ones((64, 64)), chain=chain,
                             min_seconds=0.05, repeats=3, est_seconds=1e-5)
    assert m.seconds > 0 and math.isfinite(m.seconds)
    assert m.dispersion >= 0
    assert m.n_iters & (m.n_iters - 1) == 0 and m.n_iters >= 4
    assert len(m.samples) == 3
    assert m.rate(2.0) == 2.0 / m.seconds


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("chain", [True, False])
def test_measure_loop_uint8_body(chain):
    m = ttiming.measure_loop(lambda v: v + 1,
                             torch.zeros((256, 256), dtype=torch.uint8),
                             chain=chain, min_seconds=0.05, repeats=3,
                             est_seconds=1e-5)
    assert m.seconds > 0 and m.n_iters & (m.n_iters - 1) == 0


@pytest.mark.usefixtures("one_thread")
def test_measure_loop_calibrates_without_an_estimate():
    m = ttiming.measure_loop(lambda v: v * 2, torch.ones(1024),
                             min_seconds=0.05, repeats=3)
    assert m.seconds > 0 and m.dispersion >= 0


@pytest.mark.usefixtures("one_thread")
def test_measure_loop_cpu_tensors_never_capture(monkeypatch):
    from qnnpack_tpu_torch.ops import base

    def refuse(*args, **kwargs):
        raise AssertionError("captured a CPU loop")
    monkeypatch.setattr(base, "capture", refuse)
    ttiming.measure_loop(lambda t: t[0] + t[1],
                         (torch.ones(64), torch.ones(64)), min_seconds=0.02,
                         repeats=3, est_seconds=1e-6)


def test_perturbed_copies():
    x = torch.tensor([0, 1, 2, 255], dtype=torch.uint8)
    copies = ttiming._perturbed(x)
    assert [c.tolist() for c in copies] == [
        [0, 1, 2, 255], [1, 0, 3, 254], [2, 3, 0, 253], [3, 2, 1, 252]]
    pairs = ttiming._perturbed((torch.zeros(2), x))
    assert len(pairs) == 4 and all(isinstance(p, tuple) for p in pairs)
    assert torch.allclose(pairs[3][0], torch.full((2,), 3e-6))


def test_dispatch_overhead_on_cpu():
    med, spread = ttiming.dispatch_overhead("cpu")
    assert med > 0 and spread >= 0
    assert ttiming.dispatch_overhead("cpu") == (med, spread)


# --------------------------------------------------------------- profiling
@functools.lru_cache(maxsize=None)
def zoo_specs(name):
    build = {"mobilenet_v1": (jzoo.mobilenet_v1, tzoo.mobilenet_v1, {}),
             "resnet18": (jzoo.resnet18, tzoo.resnet18, {}),
             "shufflenet_v1_g3": (jzoo.shufflenet_v1, tzoo.shufflenet_v1,
                                  dict(groups=3))}[name]
    jax_build, torch_build, kw = build
    _, jspec = jax_build(np.random.default_rng(4), **kw)
    _, tspec = torch_build(np.random.default_rng(4), device="cpu", **kw)
    return jspec, tspec


@pytest.mark.parametrize("name", ["mobilenet_v1", "resnet18",
                                  "shufflenet_v1_g3"])
@pytest.mark.parametrize("shape", [(1, 224, 224, 3), (3, 224, 224, 3)])
def test_graph_cost_equals_jax(name, shape):
    jspec, tspec = zoo_specs(name)
    want = jutils.graph_cost(jspec, shape)
    got = tutils.graph_cost(tspec, shape)
    assert [(c.name, c.macs, c.bytes_accessed, c.flops) for c in got] == \
        [(c.name, c.macs, c.bytes_accessed, c.flops) for c in want]
    jt_, tt_ = jutils.total_cost(jspec, shape), tutils.total_cost(tspec,
                                                                  shape)
    assert (tt_.name, tt_.macs, tt_.bytes_accessed) == \
        (jt_.name, jt_.macs, jt_.bytes_accessed)
    if name == "mobilenet_v1":   # tests/test_utils.py:35's checks
        assert 450e6 * shape[0] < tt_.macs < 700e6 * shape[0]
        assert got[0].name == "stem"
        assert got[0].macs == shape[0] * 112 * 112 * 32 * 3 * 3 * 3


def test_graph_cost_zero_traffic_for_concat_and_shuffle():
    _, tspec = zoo_specs("shufflenet_v1_g3")
    names = {c.name for c in tutils.graph_cost(tspec, (1, 224, 224, 3))}
    for tag, name, _ in tspec.layers:
        if tag in ("concat", "shuffle", "save", "load", "split"):
            assert name not in names


def test_trace_writes_a_chrome_trace(tmp_path):
    with tutils.trace(tmp_path / "t", device="cpu") as prof:
        (torch.ones(64) + 1).sum()
    data = json.loads((tmp_path / "t" / "trace.json").read_text())
    assert data["traceEvents"]
    assert len(prof.key_averages()) > 0


# -------------------------------------------------------------- checkpoint
@functools.lru_cache(maxsize=None)
def mobilenet_v1_025():
    """(JAX params, JAX spec, port params, port spec, input, JAX logits):
    MobileNetV1 0.25 with 10 classes, as tests/test_utils.py:14 builds it."""
    jparams, jspec = jzoo.mobilenet_v1(np.random.default_rng(3),
                                       width_mult=0.25, num_classes=10)
    tparams, tspec = tzoo.mobilenet_v1(np.random.default_rng(3),
                                       width_mult=0.25, num_classes=10,
                                       device="cpu")
    x = image(5)
    logits = np.asarray(jax.jit(lambda p, v: jax_graph_forward(p, jspec, v))(
        jparams, jnp.asarray(x)))
    return jparams, jspec, tparams, tspec, x, logits


def assert_records_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        assert type(a) is type(b)
        for f in ("w", "bias_folded", "w_kmajor", "bias_c"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        if isinstance(b, PackedConvWeights):
            for f in ("w_dw", "w_stem"):
                x, y = getattr(a, f), getattr(b, f)
                assert (x is None) == (y is None), f
                assert x is None or torch.equal(x, y), f
        for f in b.__dataclass_fields__:
            if not isinstance(getattr(b, f), (torch.Tensor, type(None))):
                assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("with_spec", [False, True])
def test_jax_bundle_loads_in_the_port(tmp_path, with_spec):
    jparams, _, tparams, tspec, x, logits = mobilenet_v1_025()
    path = str(tmp_path / "jax.npz")
    jutils.save_params(path, jparams)
    loaded = tutils.load_params(path, device="cpu",
                                spec=tspec if with_spec else None)
    # The derived kernel fields equal a freshly packed record's.
    assert_records_equal(loaded, tparams)
    y = graph_forward(loaded, tspec, torch.from_numpy(x))
    np.testing.assert_array_equal(y.numpy(), logits)


def test_port_bundle_loads_in_jax(tmp_path):
    jparams, jspec, tparams, _, x, logits = mobilenet_v1_025()
    path = str(tmp_path / "port.npz")
    tutils.save_params(path, tparams)
    restored = jutils.load_params(path)
    for a, b in zip(restored, jparams):
        assert (a is None) == (b is None)
        if a is not None:
            assert type(a) is type(b)
            np.testing.assert_array_equal(np.asarray(a.w), np.asarray(b.w))
            np.testing.assert_array_equal(np.asarray(a.bias_folded),
                                          np.asarray(b.bias_folded))
    y = jax.jit(lambda p, v: jax_graph_forward(p, jspec, v))(
        restored, jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(y), logits)


def test_bundles_hold_the_same_meta(tmp_path):
    jparams, _, tparams, _, _, _ = mobilenet_v1_025()
    jutils.save_params(str(tmp_path / "j.npz"), jparams)
    tutils.save_params(str(tmp_path / "t.npz"), tparams)
    with np.load(tmp_path / "j.npz") as jz, np.load(tmp_path / "t.npz") as tz:
        assert sorted(jz.files) == sorted(tz.files)
        metas = [json.loads(bytes(z["__meta__"].tobytes()).decode())
                 for z in (jz, tz)]
        assert metas[0] == metas[1]
        for name in jz.files:
            if name != "__meta__":   # JSON of the same dicts, keys reordered
                np.testing.assert_array_equal(jz[name], tz[name])
    gemm = [m for m in metas[1] if m and m["kind"] == "gemm"]
    assert gemm and all(m["w_aug"] is None for m in gemm)
    assert not any("w_kmajor" in m or "bias_c" in m for m in metas[1] if m)


@pytest.mark.parametrize("w_aug", [[1, 2], 0, "x"])
def test_non_null_w_aug_is_refused(tmp_path, w_aug):
    _, _, tparams, _, _, _ = mobilenet_v1_025()
    path = tmp_path / "b.npz"
    tutils.save_params(str(path), tparams)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    metas = json.loads(bytes(arrays["__meta__"].tobytes()).decode())
    i = next(i for i, m in enumerate(metas) if m and m["kind"] == "gemm")
    metas[i]["w_aug"] = w_aug
    arrays["__meta__"] = np.frombuffer(json.dumps(metas).encode(), np.uint8)
    np.savez(path, **arrays)
    with pytest.raises(ValueError, match="w_aug"):
        tutils.load_params(str(path), device="cpu")


def test_unknown_record_kind_is_refused(tmp_path):
    arrays = {"w_0": np.zeros((2, 2), np.int8),
              "b_0": np.zeros(2, np.int32),
              "__meta__": np.frombuffer(json.dumps(
                  [{"kind": "deconv", "k": 2}]).encode(), np.uint8)}
    np.savez(tmp_path / "b.npz", **arrays)
    with pytest.raises(ValueError, match="kind"):
        tutils.load_params(str(tmp_path / "b.npz"), device="cpu")


def test_load_params_defaults_to_the_gpu(no_gpu, tmp_path):
    tutils.save_params(str(tmp_path / "b.npz"), [None])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tutils.load_params(str(tmp_path / "b.npz"))


@functools.lru_cache(maxsize=None)
def squeezenet_imports():
    jparams, jspec, _ = jt.import_tflite(str(SQUEEZENET))
    tparams, tspec, _ = tt.import_tflite(SQUEEZENET, device="cpu")
    return jparams, jspec, tparams, tspec


def test_imported_graph_round_trip_jax_to_port(tmp_path):
    """A JAX import's bundle (1x1 convs as conv records) loads, with the
    port's spec, into the port import's records (those convs as GEMM
    weights)."""
    jparams, _, tparams, tspec = squeezenet_imports()
    assert any(isinstance(p, PackedGemmWeights) and tag == "conv"
               for p, (tag, _, _) in zip(tparams, tspec.layers))
    path = str(tmp_path / "jax.npz")
    jutils.save_params(path, jparams)
    loaded = tutils.load_params(path, device="cpu", spec=tspec)
    assert_records_equal(loaded, tparams)


def test_imported_graph_round_trip_port_to_jax(tmp_path):
    """The port import's bundle, saved with its spec, loads in the JAX
    package as the JAX import's records (conv records for the 1x1 convs);
    without the spec the GEMM records stay GEMM records."""
    jparams, _, tparams, tspec = squeezenet_imports()
    path = str(tmp_path / "port.npz")
    tutils.save_params(path, tparams, spec=tspec)
    restored = jutils.load_params(path)
    for a, b in zip(restored, jparams):
        assert (a is None) == (b is None)
        if a is None:
            continue
        assert type(a) is type(b)
        assert a.__dataclass_fields__.keys() == b.__dataclass_fields__.keys()
        for f in a.__dataclass_fields__:
            x, y = getattr(a, f), getattr(b, f)
            if f in ("w", "bias_folded"):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
            else:
                assert x == y, f
    assert_records_equal(tutils.load_params(path, device="cpu", spec=tspec),
                         tparams)
    plain = str(tmp_path / "plain.npz")
    tutils.save_params(plain, tparams)
    assert_records_equal(tutils.load_params(plain, device="cpu"), tparams)


def test_params_from_jax_agrees_with_load_params(tmp_path):
    jparams, _, _, tspec = squeezenet_imports()
    path = str(tmp_path / "jax.npz")
    jutils.save_params(path, jparams)
    arrays = [None if p is None else jax.tree.map(np.asarray, p)
              for p in jparams]
    assert_records_equal(tutils.load_params(path, device="cpu", spec=tspec),
                         params_from_jax(arrays, tspec, device="cpu"))


# ------------------------------------------------------------- jit_forward
def small_graph():
    _, _, tparams, tspec, x, logits = mobilenet_v1_025()
    return tparams, tspec, torch.from_numpy(x), logits


def test_jit_forward_on_cpu_equals_fn():
    params, spec, x, logits = small_graph()
    calls = []

    def fn(p, v):
        calls.append(1)
        return graph_forward(p, spec, v)

    jf = jit_forward(fn)
    assert isinstance(jf, JitForward) and jit_forward(jf) is jf
    assert jf.__name__ == "fn" and jf.__wrapped__ is fn
    tkernels.reset_launch_counts()
    y = jf(params, x)
    np.testing.assert_array_equal(y.numpy(), logits)
    assert calls == [1] and jf.graphs == {}
    assert set(tkernels.launch_counts().values()) == {0}
    with pytest.raises(ValueError, match="CUDA"):
        jf.lower(params, x)


def test_jit_forward_key():
    params, spec, x, _ = small_graph()
    jf = jit_forward(lambda p, v: graph_forward(p, spec, v))
    key = jf.key(params, x)
    # Stable for equal shapes, and for the same parameters.
    assert jf.key(params, torch.zeros_like(x)) == key
    assert jf.key(list(params), x.clone()) == key
    # Input shape, dtype and scalar arguments are part of it.
    assert jf.key(params, x[:, :112]) != key
    assert jf.key(params, x.to(torch.int32)) != key
    assert jf.key(params, x, 1) != jf.key(params, x, 2)
    # New parameter tensors miss: a replaced record, a rebuilt model.
    i = next(i for i, p in enumerate(params) if p is not None)
    swapped = list(params)
    swapped[i] = pack_conv_weights(
        np.zeros((8, 3, 3, 3), np.uint8), None, 128, 128) \
        if isinstance(params[i], PackedConvWeights) else None
    assert jf.key(swapped, x) != key
    rebuilt, _ = tzoo.mobilenet_v1(np.random.default_rng(3), width_mult=0.25,
                                   num_classes=10, device="cpu")
    assert jf.key(rebuilt, x) != key
    # A frozen record counts by identity (it cannot be given new tensors
    # or scalars), kept alive by the memo so that its id is not reused.
    assert key[0] == (list, tuple(None if p is None else id(p)
                                  for p in params))
    assert all(jf._memo[id(p)] is p for p in params if p is not None)


@dataclasses.dataclass
class _Box:
    scale: float
    table: object = None


def test_jit_forward_key_sees_scalars_in_the_parameters():
    jf = jit_forward(lambda p, v: v)
    x = torch.zeros(4)
    assert jf.key({"s": 1.0}, x) == jf.key({"s": 1.0}, x)
    assert jf.key({"s": 1.0}, x) != jf.key({"s": 2.0}, x)
    assert jf.key([1], x) != jf.key([True], x)
    assert jf.key([1], x) != jf.key([1.0], x)
    assert jf.key({"a": 1}, x) != jf.key({"b": 1}, x)
    # Frozen requant records count by identity: another record misses,
    # even an equal one.
    rp1 = tqparams.compute_fp32_params(0.5, 128)
    rp2 = tqparams.compute_fp32_params(0.25, 128)
    k1 = jf.key([rp1], x)
    assert jf.key([rp1], x) == k1 and jf.key([rp2], x) != k1
    assert jf.key([dataclasses.replace(rp1)], x) != k1
    # A mutable dataclass is walked on every call.
    box = _Box(1.0)
    k1 = jf.key(box, x)
    box.scale = 2.0
    assert jf.key(box, x) != k1
    # Anything else counts by identity.
    table = np.zeros(3)
    assert jf.key(_Box(1.0, table), x) == jf.key(_Box(1.0, table), x)
    assert jf.key(_Box(1.0, np.zeros(3)), x) != jf.key(_Box(1.0, table), x)


def test_jit_forward_key_follows_a_dict_of_tensors():
    jf = jit_forward(lambda p, v: v + p["b"])
    p = {"b": torch.ones(4)}
    k1 = jf.key(p, torch.zeros(4))
    p["b"] = torch.ones(4)
    assert jf.key(p, torch.zeros(4)) != k1
    assert torch.equal(jf(p, torch.zeros(4)), torch.ones(4))


def test_jit_forward_refuses_inputs_on_two_devices():
    jf = jit_forward(lambda a, b: a + b)
    meta = torch.empty(2, device="meta")
    with pytest.raises(ValueError, match="several devices"):
        jf(torch.zeros(2), meta)


def test_operator_runs_through_jit_forward_on_cpu():
    op = tops.Clamp(output_min=20, output_max=200, device="cpu")
    x = torch.arange(256, dtype=torch.uint8).reshape(16, 16)
    assert isinstance(op._jitted, JitForward)
    y = op(x)
    assert torch.equal(y, x.clamp(20, 200))
    assert op._jitted.graphs == {} and op._jitted.cached(x) is None
    with pytest.raises(ValueError, match="CUDA"):
        op.lower(x)
    op.delete()
    with pytest.raises(Exception, match="deleted"):
        op(x)


# ------------------------------------------------ the launch path's rules
def test_split_counters_of_a_graph():
    dev = torch.device("cpu")
    own = tq8gemm.new_counters(dev)
    assert own.dtype == torch.int32 and own.numel() == tq8gemm.COUNTERS
    assert not own.any()
    with tq8gemm.graph_counters(own):
        assert tq8gemm._split_counters(dev, 0x1000, 66) is own
        assert tq8gemm._split_counters(dev, 0x2000, 1) is own
        with pytest.raises(RuntimeError, match="graph counters"):
            tq8gemm._split_counters(dev, 0x1000, tq8gemm.COUNTERS + 1)
        inner = tq8gemm.new_counters(dev)
        with tq8gemm.graph_counters(inner):
            assert tq8gemm._split_counters(dev, 0x1000, 1) is inner
        assert tq8gemm._split_counters(dev, 0x1000, 1) is own
    assert tq8gemm._split_counters(dev, 0x1000, 1) is not own


def test_split_launch_captured_without_graph_counters_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="captured without counters"):
        tq8gemm._split_counters("cuda", 0x1000, 4)


def per_channel(scales, device_scales=None):
    return dataclasses.replace(
        tqparams.compute_per_channel_fp32_params(scales, 128),
        device_scales=device_scales)


def test_channel_scale_miss_during_capture_raises(monkeypatch):
    read = []
    monkeypatch.setattr(_build, "_channel_scales",
                        lambda scales, device: read.append(scales))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    cuda = torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="during a CUDA graph capture"):
        _build.requant_args(per_channel((0.25, 0.5)), 2, cuda)
    # Scales that lie on another device are no better.
    with pytest.raises(RuntimeError, match="device_scales"):
        _build.requant_args(per_channel((0.25, 0.5), torch.tensor(
            [0.25, 0.5])), 2, cuda)
    assert read == []


def test_channel_scale_cache_hit_during_capture_raises(monkeypatch):
    """A hit would hand the graph a cached tensor it does not own, which the
    cache may free and reuse while the graph replays: refused before the
    cache is read, so no graph holds such an address."""
    rp = per_channel((0.125, 0.5))
    _build.requant_args(rp, 2, torch.device("cpu"))
    hits = _build._channel_scales.cache_info().hits
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="during a CUDA graph capture"):
        _build.requant_args(rp, 2, torch.device("cuda", 0))
    assert _build._channel_scales.cache_info().hits == hits
    # The CPU never captures, and device_scales on the launch's device are
    # taken as they are.
    scales, _ = _build.requant_args(rp, 2, torch.device("cpu"))
    assert scales.tolist() == [0.125, 0.5]
    own = torch.tensor([0.125, 0.5])
    assert _build.requant_args(per_channel((0.125, 0.5), own), 2,
                               torch.device("cpu"))[0] is own
