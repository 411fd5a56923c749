"""Parity of the port's max pooling with the JAX package: the u8maxpool
kernel's plain version against u8maxpool_pallas in interpret mode (with its
fused clamp) and against nn.pool.u8maxpool2d, and the port's u8maxpool2d,
at small sizes of the main paths' shapes among others.  Also
kernels.pool.pool_instance, the pooling kernels' instance picker, and a
numpy mirror of csrc/u8maxpool.cu's thread mapping (pool_tile.cuh's plan and
walk: every output made once) and of its 3x3 stride-2 instance (shared
columns, padded taps read as 0, column maxima then output maxima, the clamp)
against the plain version.  Inputs come from a numpy seed; comparisons are
exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qnnpack_tpu.kernels.pool import u8maxpool_pallas
from qnnpack_tpu.nn import pool as jpool
from qnnpack_tpu_torch import kernels as tkernels
from qnnpack_tpu_torch.kernels.pool import (HALF_TAPS, POOL_VECS, WINDOWS,
                                            pool_instance, u8maxpool_cuda,
                                            u8maxpool_plain)
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
    # The main paths' window (ResNet-18's and ShuffleNet's pool1) at their
    # channel counts and ShuffleNet's shortcut widths, on odd small images.
    "shufflenet_c24_s2_pad01": (15, 17, 24, (3, 3), (2, 2),
                                ((0, 1), (0, 1)), (1, 1)),
    "resnet_c64_s2_pad01": (15, 17, 64, (3, 3), (2, 2), ((0, 1), (0, 1)),
                            (1, 1)),
    "c240_s2_pad01": (15, 17, 240, (3, 3), (2, 2), ((0, 1), (0, 1)),
                      (1, 1)),
    "c480_s2_pad01": (15, 17, 480, (3, 3), (2, 2), ((0, 1), (0, 1)),
                      (1, 1)),
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


# ------------------------------------------------------ pool_instance
@pytest.mark.parametrize("c,pool,strides,dil,bases,sums,want", [
    # Main-path widths at aligned bases: 16 bytes, or 8 for C = 24.
    (64, (3, 3), (2, 2), (1, 1), (0, 4096), False, (16, "3x3s2")),
    (240, (3, 3), (2, 2), (1, 1), (0, 4096), True, (16, "3x3s2")),
    (480, (3, 3), (2, 2), (1, 1), (0, 4096), True, (16, "3x3s2")),
    (24, (3, 3), (2, 2), (1, 1), (0, 4096), False, (8, "3x3s2")),
    (24, (3, 3), (2, 2), (1, 1), (0, 4096), True, (8, "3x3s2")),
    # Each width and form: C % 4 == 0 only, any C, the generic window.
    (12, (3, 3), (2, 2), (1, 1), (0, 0), False, (4, "3x3s2")),
    (17, (3, 3), (2, 2), (1, 1), (0, 0), False, (1, "3x3s2")),
    (512, (2, 2), (2, 2), (1, 1), (0, 0), False, (16, "any")),
    (24, (3, 3), (1, 1), (1, 1), (0, 0), False, (8, "any")),
    (12, (2, 2), (2, 2), (1, 1), (0, 0), True, (4, "any")),
    (3, (3, 2), (1, 2), (2, 1), (0, 0), False, (1, "any")),
    # Not the 3x3 stride-2 form: dilation 2, stride (2, 1), a 3x2 window.
    (64, (3, 3), (2, 2), (2, 2), (0, 0), False, (16, "any")),
    (64, (3, 3), (2, 1), (1, 1), (0, 0), False, (16, "any")),
    (64, (3, 2), (2, 2), (1, 1), (0, 0), False, (16, "any")),
    # A base off the 16-byte boundary narrows the vector, input or output.
    (64, (3, 3), (2, 2), (1, 1), (8, 0), False, (8, "3x3s2")),
    (64, (3, 3), (2, 2), (1, 1), (0, 4), False, (4, "3x3s2")),
    (64, (3, 3), (2, 2), (1, 1), (1, 0), False, (1, "3x3s2")),
    (240, (3, 3), (2, 2), (1, 1), (4104, 0), True, (8, "3x3s2")),
    (480, (3, 3), (2, 2), (1, 1), (0, 4100), True, (4, "3x3s2")),
    (24, (3, 3), (2, 2), (1, 1), (4097, 0), True, (1, "3x3s2")),
    # q8avgpool's sums: halves up to 257 taps, 32 bits past them; max
    # pooling has no sums and keeps the generic form.
    (64, (16, 16), (4, 4), (1, 1), (0, 0), True, (16, "any")),
    (64, (1, 257), (1, 1), (1, 1), (0, 0), True, (16, "any")),
    (64, (1, 258), (1, 1), (1, 1), (0, 0), True, (16, "any32")),
    (24, (17, 17), (1, 1), (1, 1), (0, 0), True, (8, "any32")),
    (5, (17, 17), (3, 3), (1, 1), (0, 0), True, (1, "any32")),
    (24, (17, 17), (1, 1), (1, 1), (0, 0), False, (8, "any")),
])
def test_pool_instance(c, pool, strides, dil, bases, sums, want):
    assert pool_instance(c, pool, strides, dil, *bases, sums=sums) == want
    assert want[1] in WINDOWS and want[0] in POOL_VECS


def test_half_taps_is_the_most_a_16_bit_half_holds():
    assert HALF_TAPS * 255 < 2**16 <= (HALF_TAPS + 1) * 255


# ------------------------------------------- the kernel's mapping, mirrored
THREADS, OUTPUTS = 128, 2  # pool_tile.cuh's kThreads and kOutputs


def plan_mirror(b, ho, wo, c, vec, window, cap=65535):
    """pool_tile.cuh:plan: (vecs, tiles, n, grid, block); `cap` stands for
    the grid's 65,535 limit in y and z."""
    n = OUTPUTS if window == "3x3s2" else 1
    vecs, tiles = c // vec, -(-wo // n)
    bx = min(vecs, THREADS)
    by = min(tiles, THREADS // bx)
    bz = min(THREADS // (bx * by), ho, 64)
    grid = (-(-tiles // by), min(-(-ho // bz), cap), min(b, cap))
    return vecs, tiles, n, grid, (bx, by, bz)


def walk_mirror(b, ho, wo, c, vec, window, cap=65535):
    """pool_tile.cuh:walk over every block and thread: yields (image,
    output row, first output column, outputs, channel vector)."""
    vecs, tiles, n, grid, block = plan_mirror(b, ho, wo, c, vec, window, cap)
    assert block[0] * block[1] * block[2] <= THREADS and block[2] <= 64
    for gx in range(grid[0]):
        for gy in range(grid[1]):
            for gz in range(grid[2]):
                for tz in range(block[2]):
                    for ty in range(block[1]):
                        tile = gx * block[1] + ty
                        if tile >= tiles:
                            continue
                        ox0 = tile * n
                        for img in range(gz, b, grid[2]):
                            for oy in range(gy * block[2] + tz, ho,
                                            grid[1] * block[2]):
                                for tx in range(block[0]):
                                    for v in range(tx, vecs, block[0]):
                                        yield (img, oy, ox0,
                                               min(n, wo - ox0), v)


@pytest.mark.parametrize("b,ho,wo,c,vec,window,cap", [
    (2, 56, 56, 64, 16, "3x3s2", 65535),   # ResNet-18 pool1
    (2, 56, 56, 24, 8, "3x3s2", 65535),    # ShuffleNet pool1
    (2, 28, 28, 24, 8, "3x3s2", 65535),    # ShuffleNet st0u0
    (3, 7, 7, 480, 16, "3x3s2", 65535),    # ShuffleNet st2u0
    (2, 5, 9, 4097, 1, "any", 65535),      # more vectors than threads
    (1, 130, 1, 1, 1, "any", 65535),       # one vector, one column
    (5, 9, 3, 8, 4, "3x3s2", 2),           # grid y and z loop
])
def test_walk_makes_every_output_once(b, ho, wo, c, vec, window, cap):
    made = np.zeros((b, ho, wo, c // vec), np.int64)
    for img, oy, ox0, outs, v in walk_mirror(b, ho, wo, c, vec, window,
                                             cap):
        made[img, oy, ox0:ox0 + outs, v] += 1
    assert (made == 1).all()


def maxpool_3x3s2_mirror(x, pad, lo, hi, vec):
    """csrc/u8maxpool.cu's 3x3 stride-2 instance on uint8 NHWC `x`: each
    thread of walk_mirror loads 3 rows x (2 n + 1) columns of its vector (0
    outside the image), takes each column's max over its rows, then each
    output's over its 3 columns, and clamps."""
    b, h, w, c = x.shape
    (pt, pb), (pl_, pr) = pad
    ho, wo = (h + pt + pb - 3) // 2 + 1, (w + pl_ + pr - 3) // 2 + 1
    y = np.full((b, ho, wo, c), 77, np.uint8)
    for img, oy, ox0, outs, v in walk_mirror(b, ho, wo, c, vec, "3x3s2"):
        iy0, ix0 = 2 * oy - pt, 2 * ox0 - pl_
        tap = np.zeros((3, 2 * OUTPUTS + 1, vec), np.uint8)
        for ky in range(3):
            for j in range(2 * OUTPUTS + 1):
                if 0 <= iy0 + ky < h and 0 <= ix0 + j < w:
                    tap[ky, j] = x[img, iy0 + ky, ix0 + j,
                                   v * vec:(v + 1) * vec]
        col = tap.max(axis=0)
        for o in range(outs):
            y[img, oy, ox0 + o, v * vec:(v + 1) * vec] = np.clip(
                col[2 * o:2 * o + 3].max(axis=0), lo, hi)
    return y


@pytest.mark.parametrize("h,w,c,vec,pad,clamp", [
    (13, 15, 64, 16, ((0, 1), (0, 1)), (0, 255)),
    (14, 11, 24, 8, ((0, 1), (0, 1)), (0, 255)),
    (9, 12, 12, 4, ((1, 1), (1, 1)), (20, 250)),
    (10, 10, 5, 1, ((2, 0), (0, 2)), (20, 250)),
])
def test_maxpool_mirror_matches_plain(h, w, c, vec, pad, clamp):
    x = u8(2, h, w, c)
    x[0, :4] = 0
    x[1, -3:] = 255
    want = u8maxpool_plain(torch.from_numpy(x), (3, 3), (2, 2), pad,
                           (1, 1), *clamp)
    np.testing.assert_array_equal(
        maxpool_3x3s2_mirror(x, pad, *clamp, vec), want.numpy())
