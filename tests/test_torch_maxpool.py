"""Parity of the port's max pooling with the JAX package: the u8maxpool
kernel's plain version against u8maxpool_pallas in interpret mode (with its
fused clamp) and against nn.pool.u8maxpool2d, and the port's u8maxpool2d.
Inputs come from a numpy seed; comparisons are exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qnnpack_tpu.kernels.pool import u8maxpool_pallas
from qnnpack_tpu.nn import pool as jpool
from qnnpack_tpu_torch import kernels as tkernels
from qnnpack_tpu_torch.kernels.pool import u8maxpool_cuda, u8maxpool_plain
from qnnpack_tpu_torch.nn import pool as tpool

RNG = np.random.default_rng(0x9001)

CASES = {
    # h, w, c, pool, strides, padding, dilation
    "resnet_pool1": (12, 12, 8, (3, 3), (2, 2), ((0, 1), (0, 1)), (1, 1)),
    "squeezenet_no_pad": (13, 13, 17, (3, 3), (2, 2), ((0, 0), (0, 0)),
                          (1, 1)),
    "vgg_2x2": (10, 8, 6, (2, 2), (2, 2), ((0, 0), (0, 0)), (1, 1)),
    "odd_pad1_c3": (11, 9, 3, (3, 3), (2, 2), ((1, 1), (1, 1)), (1, 1)),
    "asym_4x3_s3": (12, 12, 5, (4, 3), (3, 2), ((1, 2), (0, 1)), (1, 1)),
}


def u8(*shape):
    return RNG.integers(0, 256, shape, dtype=np.int64).astype(np.uint8)


@pytest.mark.parametrize("clamp", [(0, 255), (20, 250)])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_pallas(case, clamp):
    h, w, c, pool, strides, pad, dil = CASES[case]
    x = u8(2, h, w, c)
    lo, hi = clamp
    want = np.asarray(u8maxpool_pallas(
        jnp.asarray(x), pool, strides, pad, dil, output_min=lo,
        output_max=hi, tile_h=3, interpret=True))
    got = u8maxpool_plain(torch.from_numpy(x), pool, strides, pad, dil, lo,
                          hi)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", list(CASES))
def test_u8maxpool2d_matches_jax(case):
    h, w, c, pool, strides, pad, dil = CASES[case]
    x = u8(3, h, w, c)
    want = np.asarray(jpool.u8maxpool2d(jnp.asarray(x), pool, strides, pad,
                                        dil))
    got = tpool.u8maxpool2d(torch.from_numpy(x), pool, strides, pad, dil)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_clamp_applies_after_the_max_and_padding_is_zero():
    x = np.full((1, 4, 4, 2), 10, np.uint8)
    got = u8maxpool_plain(torch.from_numpy(x), (3, 3), (2, 2),
                          ((2, 0), (2, 0)), (1, 1), 20, 250)
    # Every window holds a real 10; padding 0 never wins; the clamp lifts.
    assert got.shape == (1, 2, 2, 2) and set(got.flatten().tolist()) == {20}
    corner = u8maxpool_plain(torch.from_numpy(x), (1, 1), (1, 1),
                             ((1, 0), (1, 0)))
    assert int(corner[0, 0, 0, 0]) == 0  # an all-padding window reads 0


def test_default_strides_are_the_pool_size():
    x = torch.from_numpy(u8(1, 8, 6, 4))
    assert torch.equal(u8maxpool_plain(x, (2, 3)),
                       u8maxpool_plain(x, (2, 3), (2, 3)))


def test_wrapper_on_cpu_counts_nothing():
    x = torch.from_numpy(u8(1, 9, 9, 4))
    tkernels.reset_launch_counts()
    assert torch.equal(u8maxpool_cuda(x, (3, 3), (2, 2)),
                       u8maxpool_plain(x, (3, 3), (2, 2)))
    assert u8maxpool_cuda.launches == 0
    with pytest.raises(ValueError):
        u8maxpool_cuda(x[0], (3, 3))
