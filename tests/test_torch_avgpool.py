"""Parity of the port's average pooling with the JAX package: the q8avgpool
kernel's plain version against nn.pool.q8avgpool2d and against
q8avgpool_pallas in interpret mode, and the port's q8avgpool2d.  The cases
are those of the JAX package's Pallas test, ShuffleNet's three strided
shortcuts at small H/W, and edge cases (izp != 128, odd sizes, C % 4 != 0,
an output clamp).  Inputs come from a numpy seed; comparisons are exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qnnpack_tpu.kernels.pool import q8avgpool_pallas
from qnnpack_tpu.nn import pool as jpool
from qnnpack_tpu.quant.params import \
    compute_avgpool_quant_params as jparams
from qnnpack_tpu_torch import kernels as tkernels
from qnnpack_tpu_torch.kernels.pool import q8avgpool_cuda, q8avgpool_plain
from qnnpack_tpu_torch.nn import pool as tpool
from qnnpack_tpu_torch.quant.params import \
    compute_avgpool_quant_params as tparams

RNG = np.random.default_rng(0xA7E)

S2 = ((0, 1), (0, 1))
P0 = ((0, 0), (0, 0))
P1 = ((1, 1), (1, 1))

CASES = {
    # h, w, c, pool, strides, padding, izp, scale, output zp, clamp
    # tests/test_kernels_pallas.py POOL_CASES, izp 121, scale 0.25, zp 117
    "pallas_13x13x17_3x3_s2_p1": (13, 13, 17, (3, 3), (2, 2), P1, 121,
                                  0.25, 117, (0, 255)),
    "pallas_9x9x140_2x2_s2": (9, 9, 140, (2, 2), (2, 2), P0, 121, 0.25, 117,
                              (0, 255)),
    "pallas_12x12x8_4x4_s3_p1": (12, 12, 8, (4, 4), (3, 3), P1, 121, 0.25,
                                 117, (0, 255)),
    # ShuffleNet v1's strided shortcuts (graph bias -128 * 9, scale 1/9)
    "shufflenet_st0_24ch": (14, 14, 24, (3, 3), (2, 2), S2, 128, 1 / 9, 128,
                            (0, 255)),
    "shufflenet_st1_240ch": (8, 8, 240, (3, 3), (2, 2), S2, 128, 1 / 9, 128,
                             (0, 255)),
    "shufflenet_st2_480ch": (7, 7, 480, (3, 3), (2, 2), S2, 128, 1 / 9, 128,
                             (0, 255)),
    # edges
    "izp_7_2x2_s2_unpadded": (10, 8, 12, (2, 2), (2, 2), P0, 7, 0.25, 100,
                              (0, 255)),
    "3x3_s1_pad1_odd": (9, 7, 16, (3, 3), (1, 1), P1, 250, 1 / 9, 3,
                        (0, 255)),
    "c5_odd_s2_pad01": (11, 13, 5, (3, 3), (2, 2), S2, 121, 0.37, 117,
                        (0, 255)),
    "clamp_20_250": (9, 9, 20, (3, 3), (2, 2), S2, 128, 1 / 9, 128,
                     (20, 250)),
    "asym_3x2_s2x1_pad": (8, 9, 6, (3, 2), (2, 1), ((2, 0), (0, 1)), 99,
                          0.5, 60, (10, 240)),
}


def u8(*shape):
    return RNG.integers(0, 256, shape, dtype=np.int64).astype(np.uint8)


def case_inputs(case, batch):
    h, w, c, pool, strides, pad, izp, scale, zp, (lo, hi) = CASES[case]
    count = pool[0] * pool[1]
    args = (-izp * count, scale, zp, lo, hi)
    return (u8(batch, h, w, c), jparams(*args, input_zero_point=izp),
            tparams(*args, input_zero_point=izp), pool, strides, pad)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_q8avgpool2d(case):
    x, jp, tp, pool, strides, pad = case_inputs(case, 3)
    want = np.asarray(jpool.q8avgpool2d(jnp.asarray(x), jp, pool, strides,
                                        pad))
    got = q8avgpool_plain(torch.from_numpy(x), tp, pool, strides, pad)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_pallas(case):
    x, jp, tp, pool, strides, pad = case_inputs(case, 2)
    want = np.asarray(q8avgpool_pallas(jnp.asarray(x), jp, pool, strides,
                                       pad, tile_h=3, interpret=True))
    got = q8avgpool_plain(torch.from_numpy(x), tp, pool, strides, pad)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["shufflenet_st0_24ch", "c5_odd_s2_pad01",
                                  "clamp_20_250"])
def test_q8avgpool2d_matches_jax(case):
    x, jp, tp, pool, strides, pad = case_inputs(case, 2)
    want = np.asarray(jpool.q8avgpool2d(jnp.asarray(x), jp, pool, strides,
                                        pad))
    got = tpool.q8avgpool2d(torch.from_numpy(x), tp, pool, strides, pad)
    np.testing.assert_array_equal(got.numpy(), want)


def test_padded_taps_read_the_input_zero_point():
    """A constant image at the zero point averages to the output zero point
    everywhere, the padded right and bottom edges included: each padded
    tap adds izp and the bias takes izp back once per tap."""
    izp = 77
    params = tparams(-izp * 9, 1 / 9, 128, input_zero_point=izp)
    x = torch.full((1, 8, 8, 4), izp, dtype=torch.uint8)
    got = q8avgpool_plain(x, params, (3, 3), (2, 2), S2)
    assert got.shape == (1, 4, 4, 4)
    assert set(got.flatten().tolist()) == {128}


def test_default_strides_are_the_pool_size():
    x = torch.from_numpy(u8(1, 8, 6, 4))
    params = tparams(-128 * 6, 1 / 6, 128, input_zero_point=128)
    assert torch.equal(q8avgpool_plain(x, params, (2, 3)),
                       q8avgpool_plain(x, params, (2, 3), (2, 3)))


def test_wrapper_on_cpu_counts_nothing():
    x = torch.from_numpy(u8(1, 9, 9, 4))
    params = tparams(-128 * 9, 1 / 9, 128, input_zero_point=128)
    tkernels.reset_launch_counts()
    assert torch.equal(q8avgpool_cuda(x, params, (3, 3), (2, 2), S2),
                       q8avgpool_plain(x, params, (3, 3), (2, 2), S2))
    assert q8avgpool_cuda.launches == 0
    with pytest.raises(ValueError):
        q8avgpool_cuda(x[0], params, (3, 3))
