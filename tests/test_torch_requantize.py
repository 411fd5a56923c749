"""Parity of the port's requantization numerics with the JAX package.

The same int32 inputs (edge values plus a random sweep, as in
tests/test_requantize.py) go through qnnpack_tpu.quant.requantize and
qnnpack_tpu_torch.quant.requantize; the uint8 outputs must be identical,
and so must the parameter records both packages compute."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qnnpack_tpu.quant import oracles
from qnnpack_tpu.quant import params as jparams
from qnnpack_tpu.quant import requantize as jrq
from qnnpack_tpu_torch.nn import requant_dispatch as tdispatch
from qnnpack_tpu_torch.quant import params as tparams
from qnnpack_tpu_torch.quant import requantize as trq

RNG = np.random.default_rng(0x70C4)

EDGE_INT32 = np.array([
    0, 1, -1, 2, -2, 3, -3, 127, -127, 128, -128, 255, -255, 256, -256,
    2**15 - 1, -(2**15), 2**16, -(2**16), 2**30 - 1, 2**30, -(2**30),
    2**31 - 1, -(2**31), -(2**31) + 1, 0x40000000, -0x40000000,
    0x7FFFFFFF, -0x7FFFFFFF,
], dtype=np.int64).astype(np.int32)


def sample_inputs(n=4096):
    rand = RNG.integers(-(2**31), 2**31, size=n, dtype=np.int64)
    return np.concatenate([EDGE_INT32, rand.astype(np.int32)])


def _scales_po2():
    return [float(np.ldexp(np.float32(1.0), -k)) for k in range(1, 32)]


def _scales_random(n=8):
    rng = np.random.default_rng(42)
    out = []
    for _ in range(n):
        exp = rng.integers(-20, 0)
        s = float(np.float32(np.ldexp(rng.uniform(1.0, 2.0), int(exp) - 1)))
        if 2**-32 <= s < 1.0:
            out.append(s)
    return out


SCALES = _scales_po2()[:6] + [_scales_po2()[-1]] + _scales_random(8)


def both(jfn, tfn, x, jp, tp):
    want = np.asarray(jfn(jnp.asarray(x), jp))
    got = tfn(torch.from_numpy(x), tp).numpy()
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("zero_point", [0, 128, 255])
@pytest.mark.parametrize("scheme", ["q31", "precise", "gemmlowp", "fp32"])
def test_per_tensor_schemes_match_jax(scheme, scale, zero_point):
    jp = {"q31": jparams.compute_q31_params,
          "precise": jparams.compute_precise_params,
          "gemmlowp": jparams.compute_gemmlowp_params,
          "fp32": jparams.compute_fp32_params}[scheme](scale, zero_point)
    tp = tdispatch.make_requant_params(scheme, scale, zero_point)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    from qnnpack_tpu.nn.requant_dispatch import apply_requant
    both(apply_requant, tdispatch.apply_requant, sample_inputs(), jp, tp)


@pytest.mark.parametrize("scheme,oracle", [
    ("q31", oracles.oracle_q31), ("precise", oracles.oracle_precise),
    ("gemmlowp", oracles.oracle_gemmlowp), ("fp32", oracles.oracle_fp32)])
def test_saturating_bounds_match_oracle(scheme, oracle):
    tp = tdispatch.make_requant_params(scheme, 0.25, 128, qmin=10, qmax=200)
    x = sample_inputs()
    got = tdispatch.apply_requant(torch.from_numpy(x), tp).numpy()
    assert got.min() >= 10 and got.max() <= 200
    np.testing.assert_array_equal(got, oracle(x, tp))


def test_q31_exact_divide_by_po2():
    for k in range(1, 20):
        p = tparams.compute_q31_params(float(np.ldexp(1.0, -k)), 128)
        x = (RNG.integers(-(2**(31 - k)), 2**(31 - k), size=512,
                          dtype=np.int64) << k).astype(np.int32)
        got = trq.requantize_q31(torch.from_numpy(x), p).numpy()
        np.testing.assert_array_equal(
            got, np.clip((x >> k) + 128, 0, 255).astype(np.uint8))


def test_fp32_ties_to_even():
    p = tparams.compute_fp32_params(0.5, 128)
    got = trq.requantize_fp32(
        torch.tensor([1, -1, 3, -3], dtype=torch.int32), p).numpy()
    np.testing.assert_array_equal(got, [128, 128, 130, 126])


def test_precise_rounds_away_from_zero():
    p = tparams.compute_precise_params(0.5, 128)
    got = trq.requantize_precise(
        torch.tensor([1, -1, 3, -3, 5, -5], dtype=torch.int32), p).numpy()
    np.testing.assert_array_equal(got, [129, 127, 130, 126, 131, 125])


@pytest.mark.parametrize("zero_point,qmin,qmax", [(117, 0, 255),
                                                  (128, 128, 188)])
def test_per_channel_matches_jax(zero_point, qmin, qmax):
    c = 37
    scales = RNG.uniform(2**-20, 3.0, c).astype(np.float32)
    scales[:3] = [2**-32, 255.9, 1.0]
    jp = jparams.compute_per_channel_fp32_params(scales, zero_point, qmin, qmax)
    tp = tparams.compute_per_channel_fp32_params(scales, zero_point, qmin, qmax)
    assert tp == tparams.PerChannelFP32Params(**dataclasses.asdict(jp))
    x = sample_inputs(37 * 64)
    x = x[:x.size // c * c].reshape(-1, c)
    both(jrq.requantize_fp32_per_channel, trq.requantize_fp32_per_channel,
         x, jp, tp)


def test_per_channel_rejects_wrong_width():
    tp = tparams.compute_per_channel_fp32_params([0.1, 0.2], 0)
    with pytest.raises(ValueError):
        trq.requantize_fp32_per_channel(torch.zeros(4, 3, dtype=torch.int32),
                                        tp)


@pytest.mark.parametrize("scale", [2**-10, 1.0 / 9.0, 1.0 / 49.0, 0.9, 3.7,
                                   255.0])
@pytest.mark.parametrize("zero_point", [0, 128, 255])
def test_avgpool_quantize_matches_jax(scale, zero_point):
    jp = jparams.compute_avgpool_quant_params(-7, scale, zero_point, 3, 250)
    tp = tparams.compute_avgpool_quant_params(-7, scale, zero_point, 3, 250)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    both(jrq.avgpool_quantize, trq.avgpool_quantize, sample_inputs(), jp, tp)


@pytest.mark.parametrize("a_scale,b_scale", [
    (0.5, 0.5), (0.125, 1.75), (100.0, 0.01), (2**-14, 255.0), (1.0, 1.0)])
def test_add_quantize_matches_jax(a_scale, b_scale):
    jp = jparams.compute_add_quant_params(10, 200, 128, a_scale, b_scale)
    tp = tparams.compute_add_quant_params(10, 200, 128, a_scale, b_scale)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    a, b = np.meshgrid(np.arange(256, dtype=np.uint8),
                       np.arange(256, dtype=np.uint8))
    a, b = a.ravel(), b.ravel()
    want = np.asarray(jrq.add_quantize(jnp.asarray(a), jnp.asarray(b), jp))
    got = trq.add_quantize(torch.from_numpy(a), torch.from_numpy(b), tp)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), oracles.oracle_add(a, b, tp))


def test_add_quantize_empty_clamp_window():
    # y_min > y_max: the reference clamps max first, then min.
    tp = tparams.compute_add_quant_params(0, 0, 0, 0.5, 0.5, 0, 255)
    tp = dataclasses.replace(tp, y_min=200, y_max=100)
    jp = jparams.AddQuantParams(**dataclasses.asdict(tp))
    a = np.arange(256, dtype=np.uint8)
    want = np.asarray(jrq.add_quantize(jnp.asarray(a), jnp.asarray(a), jp))
    got = trq.add_quantize(torch.from_numpy(a), torch.from_numpy(a), tp)
    np.testing.assert_array_equal(got.numpy(), want)


def test_clamp_u8_matches_jax():
    x = np.arange(256, dtype=np.uint8)
    jp = jparams.compute_u8_clamping_params(17, 201)
    tp = tparams.compute_u8_clamping_params(17, 201)
    both(jrq.clamp_u8, trq.clamp_u8, x, jp, tp)


@pytest.mark.parametrize("bad", [
    lambda: tparams.compute_q31_params(1.0, 0),
    lambda: tparams.compute_precise_params(2**-33, 0),
    lambda: tparams.compute_gemmlowp_params(1.5, 0),
    lambda: tparams.compute_avgpool_quant_params(0, 256.0, 0),
    lambda: tparams.compute_add_quant_params(0, 0, 0, 2**-15, 1.0),
    lambda: tparams.compute_u8_clamping_params(5, 4),
    lambda: tdispatch.make_requant_params("q15", 0.5, 0),
])
def test_invalid_parameters_raise(bad):
    with pytest.raises(ValueError):
        bad()
