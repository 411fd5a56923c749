"""The port's parallelism axes against the JAX package's on the 8-device
virtual CPU mesh (the cases of tests/test_parallel_axes.py), each in a
spawned gloo world of 2, 4 or 8 ranks (tests/torch_parallel_worlds.py):

  SP  spatial_conv2d (halo exchange) at 2, 4 and 8 shards, three
      geometries, and its rejections
  PP  pipeline_apply (2, 4), (4, 4) and (8, 3)
  TP  gemm_kdim_tp at 2, 4 and 8 shards x kzp 103 / 128 x all five
      requantization schemes (the JAX tests take q31 and fp32); conv_ic_tp
      at 2 and 4 shards x kzp; their rejections
  EP  grouped_conv2d_ep (8, 2), (8, 8) and (4, 4)

Each rank's output must equal the JAX sharded function's (its shard of a
sharded output, the whole of a replicated one), run under jax.jit (an
eager shard_map call takes 5-9 s here, a jitted one well under 1 s).  In
this process, the
partial instances' plain versions, summed over K slices with the record's
bias_c, must equal JAX's q8gemm_acc / q8conv2d_acc mod 2^32, and
q8requant's plain version JAX's apply_requant of acc + bias."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import torch_parallel_worlds as W
from qnnpack_tpu.nn.conv import pack_conv_weights as jpack_conv
from qnnpack_tpu.nn.conv import q8conv2d_acc as jq8conv2d_acc
from qnnpack_tpu.nn.gemm import q8gemm_acc as jq8gemm_acc
from qnnpack_tpu.nn.packing import pack_gemm_weights as jpack_gemm
from qnnpack_tpu.nn.requant_dispatch import apply_requant as japply
from qnnpack_tpu.nn.requant_dispatch import make_requant_params as jmake
from qnnpack_tpu.parallel.expert import grouped_conv2d_ep
from qnnpack_tpu.parallel.halo import spatial_conv2d
from qnnpack_tpu.parallel.mesh import conv_ic_tp, gemm_kdim_tp
from qnnpack_tpu.parallel.pipeline import pipeline_apply, stack_stage_params
from qnnpack_tpu.quant.params import compute_per_channel_fp32_params as jpc
from qnnpack_tpu_torch.kernels.q8requant import q8requant_plain
from qnnpack_tpu_torch.nn import conv as tconv
from qnnpack_tpu_torch.nn import gemm as tgemm
from qnnpack_tpu_torch.nn.packing import pack_gemm_weights as tpack_gemm
from qnnpack_tpu_torch.nn.requant_dispatch import make_requant_params as tmake
from qnnpack_tpu_torch.parallel.mesh import conv_c_slice, gemm_k_slice
from qnnpack_tpu_torch.quant.params import \
    compute_per_channel_fp32_params as tpc

requires_8_devices = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """size -> every rank's results of cases_axes in a world of `size`."""
    cache = {}

    def get(size):
        if size not in cache:
            cache[size] = W.run_world(size, "cases_axes",
                                      tmp_path_factory.mktemp(f"w{size}"))
        return cache[size]
    return get


def _mesh_1d(n, axis):
    return Mesh(np.asarray(jax.devices()[:n]), (axis,))


def _mesh_grid(n):
    return Mesh(np.asarray(jax.devices()[:n]).reshape(1, n),
                ("data", "model"))


def _bands(world, key, axis):
    return np.concatenate([r[key] for r in world], axis=axis)


def _replicated(world, key, want):
    for rank, got in enumerate(world):
        np.testing.assert_array_equal(got[key], want,
                                      err_msg=f"{key}, rank {rank}")


@requires_8_devices
@pytest.mark.parametrize("kh,s,pt,pb", W.SPATIAL)
@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_spatial_halo_conv_matches_jax(worlds, kh, s, pt, pb, n_shards):
    d = W.spatial_inputs(kh, s, pt, pb, n_shards)
    packed = jpack_conv(d["k"], d["bias"], 121, 103)
    want = _jit(spatial_conv2d, d["x"], packed, jmake("fp32", 0.004, 117),
                _mesh_1d(n_shards, "sp"), axis="sp", strides=d["strides"],
                padding=d["pad"])
    got = _bands(worlds(n_shards), f"spatial {kh} {s} {pt} {pb}", 1)
    np.testing.assert_array_equal(got, np.asarray(want))


@requires_8_devices
@pytest.mark.parametrize("key,match", [
    ("reject spatial split", "must divide"),
    ("reject spatial pad", "even output split"),
    ("reject kdim", "does not divide"),
    ("reject ic grouped", "grouped conv shards over groups"),
    ("reject ic channels", "do not divide"),
    ("reject ep", "must divide over"),
])
def test_rejections_match_jax(worlds, key, match):
    for r in worlds(4):
        kind, name, msg = r[key]
        assert (kind, name) == ("raised", "ValueError"), key
        assert match in msg, msg
    rp = jmake("fp32", 0.004, 117)
    rng = np.random.default_rng(0)
    if key == "reject spatial split":
        packed = jpack_conv(W.u8(rng, 8, 3, 3, 8), None, 121, 103)
        with pytest.raises(ValueError, match=match):
            spatial_conv2d(jnp.zeros((1, 30, 8, 8), jnp.uint8), packed, rp,
                           _mesh_1d(4, "sp"), axis="sp", strides=(2, 2),
                           padding=((1, 0), (1, 1)))
    if key == "reject kdim":
        packed = jpack_gemm(W.u8(rng, 8, 30), None, 121, 103)
        with pytest.raises(ValueError, match=match):
            gemm_kdim_tp(jnp.zeros((2, 30), jnp.uint8), packed, rp,
                         _mesh_grid(4))


@requires_8_devices
@pytest.mark.parametrize("n_stages,n_micro", W.PIPELINES)
def test_pipeline_matches_jax(worlds, n_stages, n_micro):
    d = W.pipeline_inputs(n_stages, n_micro)
    rp = jmake("q31", 0.01, 128)
    stacked = stack_stage_params(
        [jpack_gemm(w, b, 121, 103) for w, b in d["stages"]])
    want = _jit(lambda x, *args, **kw: pipeline_apply(
        lambda p, v: japply(jq8gemm_acc(v, p), rp), stacked, x, *args, **kw),
        d["x"], _mesh_1d(n_stages, "pp"), axis="pp")
    _replicated(worlds(n_stages), f"pipeline {n_stages} {n_micro}",
                np.asarray(want))


def _jit(fn, x, *args, **kw):
    """fn(x, *args, **kw) as one jitted call on the numpy input x."""
    return np.asarray(jax.jit(lambda v: fn(v, *args, **kw))(jnp.asarray(x)))


def _jax_rparams(scheme, scales):
    return W.requant(jmake, jpc, scheme, scales)


@requires_8_devices
@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("scheme", W.SCHEMES)
@pytest.mark.parametrize("kzp", W.KZPS)
def test_tp_kdim_matches_jax(worlds, n_shards, scheme, kzp):
    d = W.kdim_inputs(n_shards, scheme, kzp)
    packed = jpack_gemm(d["w"], d["bias"], 121, kzp)
    want = _jit(gemm_kdim_tp, d["a"], packed,
                _jax_rparams(scheme, d["scales"]), _mesh_grid(n_shards))
    _replicated(worlds(n_shards), f"kdim {scheme} {kzp}", np.asarray(want))


@requires_8_devices
@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("kzp", W.KZPS)
def test_tp_conv_ic_matches_jax(worlds, n_shards, kzp):
    d = W.ic_inputs(n_shards, kzp)
    packed = jpack_conv(d["k"], d["bias"], 121, kzp)
    want = _jit(conv_ic_tp, d["x"], packed, jmake("q31", 0.004, 117),
                _mesh_grid(n_shards), strides=(2, 2),
                padding=((1, 1), (1, 1)))
    _replicated(worlds(n_shards), f"ic {kzp}", np.asarray(want))


@requires_8_devices
@pytest.mark.parametrize("groups,n_shards", W.EXPERTS)
def test_grouped_conv_ep_matches_jax(worlds, groups, n_shards):
    d = W.ep_inputs(groups, n_shards)
    packed = jpack_conv(d["k"], d["bias"], 121, 103, groups=groups)
    want = _jit(grouped_conv2d_ep, d["x"], packed, jmake("q31", 0.004, 117),
                _mesh_1d(n_shards, "ep"), axis="ep",
                padding=((1, 1), (1, 1)))
    got = _bands(worlds(n_shards), f"ep {groups}", 3)
    np.testing.assert_array_equal(got, np.asarray(want))


def _wrap(x):
    return ((np.asarray(x, np.int64) + 2**31) % 2**32) - 2**31


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
@pytest.mark.parametrize("kzp", W.KZPS)
def test_gemm_partials_sum_to_the_jax_accumulator(shards, kzp):
    """The K slices' partials (q8gemm's partial instance, plain version)
    plus the record's bias_c are JAX's q8gemm_acc mod 2^32; the slices
    are built once and held by the record."""
    d = W.kdim_inputs(shards, "q31", kzp)
    packed = tpack_gemm(d["w"], d["bias"], 121, kzp)
    ks = 64 // shards
    total = packed.bias_c.to(torch.int64)
    for i in range(shards):
        rec = gemm_k_slice(packed, shards, i)
        assert gemm_k_slice(packed, shards, i) is rec
        part = tgemm.q8gemm_partial(torch.from_numpy(
            d["a"][:, i * ks:(i + 1) * ks]), rec)
        assert part.dtype == torch.int32
        total = total + part.to(torch.int64)
    want = jq8gemm_acc(jnp.asarray(d["a"]),
                       jpack_gemm(d["w"], d["bias"], 121, kzp))
    np.testing.assert_array_equal(_wrap(total.numpy()), np.asarray(want))


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("kzp", W.KZPS)
def test_conv_partials_sum_to_the_jax_accumulator(shards, kzp):
    """The same for q8conv's partial instance over input-channel slices,
    zero-point taps included (stride 2, padding 1)."""
    d = W.ic_inputs(shards, kzp)
    packed = tconv.pack_conv_weights(d["k"], d["bias"], 121, kzp)
    cs = 16 // shards
    total = packed.bias_c.to(torch.int64)
    for i in range(shards):
        part = tconv.q8conv2d_partial(
            torch.from_numpy(d["x"][..., i * cs:(i + 1) * cs]),
            conv_c_slice(packed, shards, i), (2, 2), ((1, 1), (1, 1)))
        total = total + part.to(torch.int64)
    want = jq8conv2d_acc(jnp.asarray(d["x"]),
                         jpack_conv(d["k"], d["bias"], 121, kzp),
                         strides=(2, 2), padding=((1, 1), (1, 1)))
    np.testing.assert_array_equal(_wrap(total.numpy()), np.asarray(want))


@pytest.mark.parametrize("scheme", W.SCHEMES)
def test_q8requant_plain_matches_jax_apply_requant(scheme):
    """apply_requant(acc + bias) with int32 wrapping, odd N and biases
    that wrap the sum."""
    rng = W.case_rng("q8requant", scheme)
    n = 37
    acc = rng.integers(-2**31, 2**31, (9, n), dtype=np.int64).astype(np.int32)
    bias = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    acc[0] = 2**31 - 5
    bias[:4] = [2**31 - 1, -2**31, 7, -9]
    scales = rng.uniform(1e-9, 1e-8, n)
    got = tgemm.q8requant(torch.from_numpy(acc), torch.from_numpy(bias),
                          W.requant(tmake, tpc, scheme, scales, 3e-9))
    want = japply(jnp.asarray(acc) + jnp.asarray(bias)[None, :],
                  W.requant(jmake, jpc, scheme, scales, 3e-9))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        q8requant_plain(torch.from_numpy(acc), torch.from_numpy(bias),
                        W.requant(tmake, tpc, scheme, scales, 3e-9)).numpy(),
        got.numpy())
