"""The port's float ops (nn/float_ops.py) against the JAX package's
qnnpack_tpu/nn/float_ops.py and the numpy references of
tests/test_float_ops.py, at its shapes and tolerances: sgemm with and
without bias and clamp, hgemm in bfloat16 (products and the bias in fp32,
one round to bf16 after the clamp) and its clamp, sconv2d with groups 1
and 4, sdwconv2d.  Each op also leaves the caller's float32 matmul
precision and cuDNN flags as they were.  Runs on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qnnpack_tpu.nn import float_ops as jfloat
from qnnpack_tpu_torch.nn import float_ops as tfloat
from test_float_ops import _np_conv2d

RNG = np.random.default_rng(0xF00E)


def normal(*shape):
    return RNG.standard_normal(shape, dtype=np.float32)


@pytest.mark.parametrize("m,n,k", [(1, 8, 8), (5, 17, 23), (32, 128, 64)])
def test_sgemm(m, n, k):
    a, w, bias = normal(m, k), normal(k, n), normal(n)
    want = np.clip(a @ w + bias, -1.0, 1.0)
    got = tfloat.sgemm(torch.from_numpy(a), torch.from_numpy(w),
                       torch.from_numpy(bias), output_min=-1.0,
                       output_max=1.0)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jfloat.sgemm(a, w, bias, -1.0, 1.0)),
        rtol=1e-5, atol=1e-5)


def test_sgemm_no_bias_no_clamp():
    a, w = normal(4, 16), normal(16, 8)
    got = tfloat.sgemm(a, w).numpy()
    np.testing.assert_allclose(got, a @ w, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jfloat.sgemm(a, w)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("m,n,k", [(8, 8, 8), (16, 64, 32)])
def test_hgemm_bf16(m, n, k):
    a, w, bias = normal(m, k), normal(k, n), normal(n)
    a16 = jnp.asarray(a, jnp.bfloat16)
    w16 = jnp.asarray(w, jnp.bfloat16)
    want = np.asarray(a16, np.float32) @ np.asarray(w16, np.float32) + bias
    got = tfloat.hgemm(torch.from_numpy(a), torch.from_numpy(w),
                       torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=1 / 128, atol=1 / 64)
    np.testing.assert_allclose(
        got, np.asarray(jfloat.hgemm(a16, w16, bias), np.float32),
        rtol=1 / 128, atol=1 / 64)


def test_hgemm_adds_the_bias_before_the_round():
    """(1 + 2^-7)(1 - 2^-8) = 1 + 2^-8 - 2^-15, exact in fp32, plus a bias
    of -1 gives 2^-8 - 2^-15, which bf16 holds; a bf16 product rounded
    before the bias would give 1 - 1 = 0."""
    a = np.array([[1.0 + 2**-7]], np.float32)
    w = np.array([[1.0 - 2**-8]], np.float32)
    bias = np.array([-1.0], np.float32)
    want = np.asarray(jfloat.hgemm(a, w, bias), np.float32)
    got = tfloat.hgemm(a, w, bias).float().numpy()
    np.testing.assert_array_equal(want, [[2**-8 - 2**-15]])
    np.testing.assert_array_equal(got, want)


def test_hgemm_clamp():
    a = torch.ones((4, 8), dtype=torch.bfloat16) * 10
    w = torch.ones((8, 4), dtype=torch.bfloat16)
    got = tfloat.hgemm(a, w, output_min=-5.0, output_max=5.0)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.full((4, 4), 5.0, np.float32))


@pytest.mark.parametrize("groups", [1, 4])
def test_sconv2d(groups):
    a = normal(2, 9, 9, 8)
    w = normal(3, 3, 8 // groups, 12)
    bias = normal(12)
    want = _np_conv2d(a, w, (2, 2), ((1, 1), (1, 1)), (1, 1), groups) + bias
    got = tfloat.sconv2d(torch.from_numpy(a), torch.from_numpy(w),
                         torch.from_numpy(bias), strides=(2, 2),
                         padding=((1, 1), (1, 1)), groups=groups)
    assert tuple(got.shape) == want.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jfloat.sconv2d(
            a, w, bias, strides=(2, 2), padding=((1, 1), (1, 1)),
            groups=groups)), rtol=1e-4, atol=1e-4)


def test_sconv2d_asymmetric_padding_dilation_and_clamp():
    a = normal(1, 8, 7, 3)
    w = normal(3, 2, 3, 5)
    pad, dil = ((2, 0), (1, 2)), (2, 1)
    want = np.clip(_np_conv2d(a, w, (1, 2), pad, dil, 1), -0.5, 0.75)
    got = tfloat.sconv2d(a, w, strides=(1, 2), padding=pad, dilation=dil,
                         output_min=-0.5, output_max=0.75)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jfloat.sconv2d(
            a, w, strides=(1, 2), padding=pad, dilation=dil,
            output_min=-0.5, output_max=0.75)), rtol=1e-4, atol=1e-4)


def test_sdwconv2d():
    c = 16
    a = normal(2, 8, 8, c)
    w = normal(3, 3, c)
    want = _np_conv2d(a, w.reshape(3, 3, 1, c), (1, 1), ((1, 1), (1, 1)),
                      (1, 1), c)
    got = tfloat.sdwconv2d(torch.from_numpy(a), torch.from_numpy(w),
                           padding=((1, 1), (1, 1)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jfloat.sdwconv2d(a, w,
                                                 padding=((1, 1), (1, 1)))),
        rtol=1e-4, atol=1e-4)


def test_float_ops_leave_the_callers_settings():
    cudnn = torch.backends.cudnn
    prev = (torch.get_float32_matmul_precision(), cudnn.allow_tf32,
            cudnn.benchmark, cudnn.deterministic, cudnn.enabled)
    torch.set_float32_matmul_precision("high")
    try:
        tfloat.sgemm(normal(2, 3), normal(3, 4))
        tfloat.hgemm(normal(2, 3), normal(3, 4))
        assert torch.get_float32_matmul_precision() == "high"
        tfloat.sconv2d(normal(1, 4, 4, 2), normal(3, 3, 2, 2))
        tfloat.sdwconv2d(normal(1, 4, 4, 2), normal(3, 3, 2))
        assert (cudnn.allow_tf32, cudnn.benchmark, cudnn.deterministic,
                cudnn.enabled) == prev[1:]
    finally:
        torch.set_float32_matmul_precision(prev[0])
