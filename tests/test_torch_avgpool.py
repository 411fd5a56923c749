"""Parity of the port's average pooling with the JAX package: the q8avgpool
kernel's plain version against nn.pool.q8avgpool2d and against
q8avgpool_pallas in interpret mode, and the port's q8avgpool2d.  The cases
are those of the JAX package's Pallas test, ShuffleNet's three strided
shortcuts at small H/W (and C = 24, 64, 240, 480 on 15x17 images), and
edge cases (izp != 128, odd sizes, C % 4 != 0, an output clamp).  Also a
numpy mirror of csrc/q8avgpool.cu's sums (16-bit halves of each word, or
32-bit sums past kernels.pool.HALF_TAPS taps; padded taps counted and added
as outside * izp with the bias, wrapping in uint32; the requantization)
held against the JAX package's avgpool_quantize and q8avgpool_plain on
extreme data.  Inputs come from a numpy seed; comparisons are exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qnnpack_tpu.kernels.pool import q8avgpool_pallas
from qnnpack_tpu.nn import pool as jpool
from qnnpack_tpu.quant.params import \
    compute_avgpool_quant_params as jparams
from qnnpack_tpu.quant.requantize import avgpool_quantize as javgpool_quantize
from qnnpack_tpu_torch import kernels as tkernels
from qnnpack_tpu_torch.kernels.pool import (HALF_TAPS, pool_instance,
                                            q8avgpool_cuda, q8avgpool_plain)
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
    # The main path's window at ShuffleNet's widths (and ResNet's 64) on
    # odd small images
    "st0_c24_15x17": (15, 17, 24, (3, 3), (2, 2), S2, 128, 1 / 9, 128,
                      (0, 255)),
    "c64_15x17": (15, 17, 64, (3, 3), (2, 2), S2, 128, 1 / 9, 128,
                  (0, 255)),
    "st1_c240_15x17": (15, 17, 240, (3, 3), (2, 2), S2, 128, 1 / 9, 128,
                       (0, 255)),
    "st2_c480_15x17": (15, 17, 480, (3, 3), (2, 2), S2, 128, 1 / 9, 128,
                       (0, 255)),
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
                                  "clamp_20_250", "st0_c24_15x17",
                                  "c64_15x17", "st1_c240_15x17",
                                  "st2_c480_15x17"])
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


# -------------------------------------------------- the kernel's sums, mirrored
U32 = 0xFFFFFFFF
EVEN = np.uint32(0x00FF00FF)


def window_taps(x, pool, strides, padding, fill):
    """The taps of every output of uint8 NHWC `x`: [B, Ho, Wo, ph * pw, C],
    `fill` outside the image, and each output's count of taps inside."""
    b, h, w, c = x.shape
    (pt, pb), (pl_, pr) = padding
    ph, pw = pool
    sh, sw = strides
    ho, wo = (h + pt + pb - ph) // sh + 1, (w + pl_ + pr - pw) // sw + 1
    xp = np.pad(x, ((0, 0), (pt, pb), (pl_, pr), (0, 0)),
                constant_values=fill)
    inside = np.pad(np.ones((h, w), np.int64), ((pt, pb), (pl_, pr)))
    taps, count = [], 0
    for ky in range(ph):
        for kx in range(pw):
            rows = slice(ky, ky + (ho - 1) * sh + 1, sh)
            cols = slice(kx, kx + (wo - 1) * sw + 1, sw)
            taps.append(xp[:, rows, cols, :])
            count = count + inside[rows, cols]
    return np.stack(taps, axis=3), count


def kernel_sums(x, pool, strides, padding):
    """q8avgpool.cu's byte sums of each output, [B, Ho, Wo, C] as uint32,
    and its count of padded taps: in 16-bit halves of each 32-bit word up
    to HALF_TAPS taps (bytes 0 and 2 of w & 0x00FF00FF, bytes 1 and 3 of
    (w >> 8) & 0x00FF00FF, padded taps loaded as 0), in 32 bits a byte
    past them."""
    b, h, w, c = x.shape
    taps, inside = window_taps(x, pool, strides, padding, 0)
    outside = pool[0] * pool[1] - inside
    if pool[0] * pool[1] > HALF_TAPS:
        return taps.astype(np.uint32).sum(axis=3, dtype=np.uint32), outside
    words = np.ascontiguousarray(np.pad(
        taps, ((0, 0),) * 4 + ((0, -c % 4),))).view("<u4")
    even = (words & EVEN).sum(axis=3, dtype=np.uint32)
    odd = ((words >> np.uint32(8)) & EVEN).sum(axis=3, dtype=np.uint32)
    assert (even >> np.uint32(16)).max(initial=0) < 2**16  # no carry
    lanes = [even & np.uint32(0xFFFF), odd & np.uint32(0xFFFF),
             even >> np.uint32(16), odd >> np.uint32(16)]
    sums = np.stack(lanes, axis=-1).reshape(*even.shape[:3], -1)
    return sums[..., :c], outside


def kernel_acc(x, params, pool, strides, padding):
    """The int32 accumulator the kernel requantizes: the byte sum plus
    bias + outside * izp, every add and product wrapping in uint32."""
    sums, outside = kernel_sums(x, pool, strides, padding)
    base = (np.int64(params.bias) + outside.astype(np.int64)
            * params.input_zero_point) & U32
    acc = (sums.astype(np.int64) + base[None, :, :, None]) & U32
    return (acc ^ 2**31) - 2**31


def avgpool_requant_mirror(acc, params):
    """requant.cuh:avgpool_requant on int32 values (int64 array): the 64-bit
    product, -1 for negatives, + 2^(shift-1), the arithmetic shift, the low
    32 bits, the clamp less the zero point and the zero point."""
    prod = acc * params.multiplier - (acc < 0) + (1 << (params.shift - 1))
    scaled = (((prod >> params.shift) & U32) ^ 2**31) - 2**31
    scaled = np.clip(scaled, params.output_min_less_zero_point,
                     params.output_max_less_zero_point)
    return (scaled + params.output_zero_point).astype(np.uint8)


# (h, w, c, pool, strides, padding, izp, scale, output zp, fill or None,
# bias or None for -izp * taps)
MIRROR_CASES = {
    "main path 3x3 s2 c24": (15, 17, 24, (3, 3), (2, 2), S2, 128, 1 / 9,
                             128, None, None),
    "all 255, 256 taps, izp 0": (20, 24, 8, (16, 16), (4, 4), P0, 0,
                                 1 / 256, 0, 255, None),
    "all 255, 257 taps, izp 0": (3, 257, 4, (1, 257), (1, 1), P0, 0,
                                 1 / 257, 0, 255, None),
    "all 0, izp 255, 3x3 s2 padded": (9, 11, 12, (3, 3), (2, 2), P1, 255,
                                      1 / 9, 128, 0, None),
    "all 255, izp 255, 16x16 pad 1": (17, 18, 5, (16, 16), (1, 1), P1,
                                      255, 1 / 256, 128, 255, None),
    "random, izp 0, 16x16 s2": (19, 21, 6, (16, 16), (2, 2), S2, 0,
                                1 / 256, 100, None, None),
    "all 255, 289 taps (32-bit sums)": (18, 19, 7, (17, 17), (1, 1), P0,
                                        0, 1 / 289, 0, 255, None),
    "random, izp 250, 17x17 pad 1": (20, 21, 4, (17, 17), (2, 2), P1, 250,
                                     1 / 289, 128, None, None),
    "bias wraps int32, all 255 3x3 s2": (9, 11, 8, (3, 3), (2, 2), S2, 0,
                                         2**-20, 128, 255, 2**31 - 1000),
    "bias wraps int32, 17x17": (18, 19, 4, (17, 17), (1, 1), P0, 0, 2**-20,
                                128, None, 2**31 - 1000),
    "bias at -2^31, izp 255 all 0": (9, 11, 8, (3, 3), (2, 2), P1, 255,
                                     2**-20, 128, 0, -2**31),
}


def mirror_inputs(case):
    h, w, c, pool, strides, pad, izp, scale, zp, fill, bias = \
        MIRROR_CASES[case]
    x = (u8(2, h, w, c) if fill is None
         else np.full((2, h, w, c), fill, np.uint8))
    if bias is None:
        bias = -izp * pool[0] * pool[1]
    return (x, tparams(bias, scale, zp, input_zero_point=izp),
            jparams(bias, scale, zp, input_zero_point=izp), pool, strides,
            pad)


@pytest.mark.parametrize("case", list(MIRROR_CASES))
def test_kernel_sums_mirror_matches_plain(case):
    x, tp, _, pool, strides, pad = mirror_inputs(case)
    got = avgpool_requant_mirror(kernel_acc(x, tp, pool, strides, pad), tp)
    want = q8avgpool_plain(torch.from_numpy(x), tp, pool, strides, pad)
    np.testing.assert_array_equal(got, want.numpy())
    sums = pool_instance(x.shape[-1], pool, strides, (1, 1), sums=True)[1]
    assert (sums == "any32") == (pool[0] * pool[1] > HALF_TAPS)


@pytest.mark.parametrize("case", list(MIRROR_CASES))
def test_kernel_requant_mirror_matches_jax(case):
    x, tp, jp, pool, strides, pad = mirror_inputs(case)
    acc = kernel_acc(x, tp, pool, strides, pad)
    want = np.asarray(javgpool_quantize(jnp.asarray(acc.astype(np.int32)),
                                        jp))
    np.testing.assert_array_equal(avgpool_requant_mirror(acc, tp), want)


def test_wrapping_bias_changes_the_output():
    """The wrap cases are real: without the uint32 wrap the accumulator
    would sit past 2^31 and requantize to 255, with it to 0."""
    x, tp, _, pool, strides, pad = mirror_inputs(
        "bias wraps int32, all 255 3x3 s2")
    acc = kernel_acc(x, tp, pool, strides, pad)
    assert (acc < 0).all()
    assert (avgpool_requant_mirror(acc, tp) == 0).all()
