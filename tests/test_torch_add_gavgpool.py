"""Parity of the port's residual add (q8vadd) and global average pool
(q8gavgpool) with the JAX package: quant.requantize.add_quantize and
q8vadd_pallas, nn.pool.q8gavgpool and q8gavgpool_pallas (interpret mode).
A numpy mirror of csrc/q8vadd.cu's per-byte arithmetic (uint32 sum, the
compare-free rounding shift) is held against add_quantize on all 65,536
(a, b) pairs.  Inputs come from a numpy seed; comparisons are exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qnnpack_tpu.kernels import q8gavgpool_pallas, q8vadd_pallas
from qnnpack_tpu.nn import pool as jpool
from qnnpack_tpu.quant import params as jparams
from qnnpack_tpu.quant.requantize import add_quantize as jadd
from qnnpack_tpu_torch import kernels as tkernels
from qnnpack_tpu_torch.kernels.pool import q8gavgpool_cuda, q8gavgpool_plain
from qnnpack_tpu_torch.kernels.vpu_ops import q8vadd_cuda, q8vadd_plain
from qnnpack_tpu_torch.nn import pool as tpool
from qnnpack_tpu_torch.quant import params as tparams

RNG = np.random.default_rng(0xADD5)


def u8(*shape):
    return RNG.integers(0, 256, shape, dtype=np.int64).astype(np.uint8)


ADD_PARAMS = [
    (128, 128, 128, 1.0, 1.0, 0, 255),       # the MobileNetV2 residual add
    (10, 200, 128, 0.125, 1.75, 0, 255),
    (127, 63, 128, 0.25, 0.75, 20, 240),
    (0, 255, 3, 2**-14, 255.0, 0, 255),
    (77, 1, 250, 100.0, 0.01, 5, 250),
]


@pytest.mark.parametrize("p", ADD_PARAMS, ids=[str(p[:5]) for p in ADD_PARAMS])
@pytest.mark.parametrize("shape", [(1, 56, 56, 24), (2, 7, 7, 5), (1000,)])
def test_q8vadd_matches_jax(shape, p):
    jp = jparams.compute_add_quant_params(*p)
    tp = tparams.compute_add_quant_params(*p)
    a, b = u8(*shape), u8(*shape)
    want = np.asarray(jadd(jnp.asarray(a), jnp.asarray(b), jp))
    got = q8vadd_cuda(torch.from_numpy(a), torch.from_numpy(b), tp)
    assert got.dtype == torch.uint8 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("p", ADD_PARAMS[:3], ids=[str(p[:5])
                                                   for p in ADD_PARAMS[:3]])
def test_q8vadd_plain_matches_pallas(p):
    jp = jparams.compute_add_quant_params(*p)
    tp = tparams.compute_add_quant_params(*p)
    a, b = u8(3, 9, 11, 7), u8(3, 9, 11, 7)
    want = np.asarray(q8vadd_pallas(jnp.asarray(a), jnp.asarray(b), jp,
                                    tile_m=8, tile_n=128, interpret=True))
    np.testing.assert_array_equal(
        q8vadd_plain(torch.from_numpy(a), torch.from_numpy(b), tp).numpy(),
        want)


# Parameter sets for all 65,536 (a, b) pairs: BERT's residual add, the
# phase-2 set, the smallest shift compute_add_quant_params gives (14, both
# scales near 256, so |acc| comes within 2^24 of 2^31 and the uint32 sum
# wraps) and the largest (31).
ALL_PAIRS_PARAMS = [
    (128, 128, 128, 1.0, 1.0, 0, 255),
    (10, 200, 128, 0.125, 1.75, 20, 240),
    (255, 255, 3, 255.0, 255.5, 0, 255),
    (0, 0, 250, 255.9, 254.0, 5, 250),
    (77, 1, 250, 2**-10, 1e-4, 0, 255),
    (200, 31, 0, 0.0019, 0.0013, 0, 255),
]


def all_pairs():
    a, b = np.meshgrid(np.arange(256, dtype=np.uint8),
                       np.arange(256, dtype=np.uint8), indexing="ij")
    return a, b


def q8vadd_mirror(a, b, p):
    """csrc/q8vadd.cu's add_quant in numpy: the sum in uint32, then
    d = (acc & mask) + (acc >> 31) - 2^(shift - 1) and
    y = clamp((acc >> shift) + (d >> 31) + zp + 1, y_min, y_max)."""
    acc = (np.uint32(p.zero_point_product & 0xFFFFFFFF)
           + a.astype(np.uint32) * np.uint32(p.a_multiplier)
           + b.astype(np.uint32) * np.uint32(p.b_multiplier)).view(np.int32)
    mask = np.uint32((1 << p.shift) - 1)
    d = ((acc.view(np.uint32) & mask).view(np.int32) + (acc >> 31)
         - np.int32(1 << (p.shift - 1)))
    y = (acc >> p.shift) + (d >> 31) + np.int32(p.y_zero_point + 1)
    y = np.maximum(np.minimum(y, np.int32(p.y_max)), np.int32(p.y_min))
    return y.astype(np.uint8), acc


def test_all_pairs_params_reach_both_shift_ends_and_2_31():
    params = [tparams.compute_add_quant_params(*p) for p in ALL_PAIRS_PARAMS]
    assert {p.shift for p in params} >= {14, 31}
    a, b = all_pairs()
    worst = max(int(np.abs(q8vadd_mirror(a, b, p)[1].astype(np.int64)).max())
                for p in params)
    assert worst > 2**31 - 2**24


@pytest.mark.parametrize("p", ALL_PAIRS_PARAMS,
                         ids=[str(p[:5]) for p in ALL_PAIRS_PARAMS])
def test_q8vadd_kernel_arithmetic_matches_jax_on_all_pairs(p):
    jp = jparams.compute_add_quant_params(*p)
    tp = tparams.compute_add_quant_params(*p)
    a, b = all_pairs()
    want = np.asarray(jadd(jnp.asarray(a), jnp.asarray(b), jp))
    got, _ = q8vadd_mirror(a, b, tp)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        q8vadd_cuda(torch.from_numpy(a), torch.from_numpy(b), tp).numpy(),
        want)


def test_q8vadd_rejects_shape_mismatch():
    tp = tparams.compute_add_quant_params(*ADD_PARAMS[0])
    with pytest.raises(ValueError):
        q8vadd_cuda(torch.zeros(3, 4, dtype=torch.uint8),
                    torch.zeros(4, 3, dtype=torch.uint8), tp)


GAP_CASES = [
    # b, s, c, izp, scale, ozp, omin, omax
    (1, 49, 1280, 128, 1.0 / 49, 128, 0, 255),   # MobileNetV2 7x7x1280
    (3, 49, 40, 128, 1.0 / 49, 128, 0, 255),
    (2, 9, 33, 7, 3.7 / 9, 100, 20, 230),
    (4, 1, 17, 0, 0.9, 0, 0, 255),
    (2, 200, 8, 255, 2**-10, 255, 0, 255),
]


@pytest.mark.parametrize("case", GAP_CASES, ids=[str(c[:4]) for c in GAP_CASES])
def test_q8gavgpool_matches_jax(case):
    b, s, c, izp, scale, ozp, omin, omax = case
    args = (-izp * s, scale, ozp, omin, omax)
    jp = jparams.compute_avgpool_quant_params(*args, input_zero_point=izp)
    tp = tparams.compute_avgpool_quant_params(*args, input_zero_point=izp)
    x = u8(b, s, c)
    want = np.asarray(jpool.q8gavgpool(jnp.asarray(x), jp, axis=1))
    got = tpool.q8gavgpool(torch.from_numpy(x), tp, axis=1)
    np.testing.assert_array_equal(got.numpy(), want)
    pallas = np.asarray(q8gavgpool_pallas(jnp.asarray(x), jp,
                                          interpret=True))
    np.testing.assert_array_equal(
        q8gavgpool_plain(torch.from_numpy(x), tp).numpy(), pallas)


def test_q8gavgpool_over_nhwc_axes():
    # The pool over H of an NHWC tensor: other axes keep their shape.
    jp = jparams.compute_avgpool_quant_params(-128 * 5, 0.2, 128,
                                              input_zero_point=128)
    tp = tparams.compute_avgpool_quant_params(-128 * 5, 0.2, 128,
                                              input_zero_point=128)
    x = u8(2, 5, 3, 4)
    want = np.asarray(jpool.q8gavgpool(jnp.asarray(x), jp, axis=1))
    got = tpool.q8gavgpool(torch.from_numpy(x), tp, axis=1)
    assert tuple(got.shape) == want.shape == (2, 3, 4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_wrappers_count_nothing():
    tkernels.reset_launch_counts()
    tp = tparams.compute_avgpool_quant_params(-128 * 4, 0.25, 128,
                                              input_zero_point=128)
    q8gavgpool_cuda(torch.from_numpy(u8(1, 4, 8)), tp)
    ap = tparams.compute_add_quant_params(*ADD_PARAMS[0])
    q8vadd_cuda(torch.from_numpy(u8(5)), torch.from_numpy(u8(5)), ap)
    assert tkernels.launch_counts() == {
        "q8gemm": 0, "q8dwconv": 0, "q8vadd": 0, "q8gavgpool": 0,
        "q8conv": 0, "q8stem": 0, "u8maxpool": 0, "q8avgpool": 0,
        "q8bmm": 0, "u8rmax": 0, "u8lut32norm": 0, "u8clamp": 0}
