"""The port's row max, clamp, LUT ops and softargmax against the JAX package.

- u8rmax's plain version against u8rmax_pallas (interpret mode) at N = 1,
  3, 128 and 301;
- u8clamp's plain version against u8clamp_pallas (interpret mode);
- u8lut32norm's plain version against tests/reference_ops.softargmax, and
  its uint32 wrap on a table whose sums pass 2^32;
- u8softargmax against the JAX function (with the factored table where
  build_softargmax_lut_factored holds, its bilinear form where it declines)
  and against reference_ops.softargmax;
- the LUT builders bit for bit, and x8lut, against the JAX ones;
- a numpy mirror of csrc/u8lut32norm.cu's divide (one uint32 divide a
  row for the magic, a multiply-high and one correction an element, the
  s == 0 -> 255 rule and the clamp) against exact integer division and
  the JAX package's u32_barrett_magic / u32_div_floor, and whole rows of
  it against u8lut32norm_plain;
- kernels.vpu_ops.row_instance, the row kernels' instance picker.
Comparisons are exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import reference_ops as ref
from qnnpack_tpu.kernels.vpu_ops import u8clamp_pallas, u8rmax_pallas
from qnnpack_tpu.nn import elementwise as jelem
from qnnpack_tpu.quant.int_arith import u32_barrett_magic, u32_div_floor
from qnnpack_tpu.quant.params import ClampParams as JClampParams
from qnnpack_tpu_torch import kernels as tkernels
from qnnpack_tpu_torch.kernels.vpu_ops import (u8clamp_cuda, u8clamp_plain,
                                               u8lut32norm_cuda,
                                               u8lut32norm_plain, u8rmax_cuda,
                                               u8rmax_plain, row_instance)
from qnnpack_tpu_torch.nn import elementwise as telem
from qnnpack_tpu_torch.quant.params import compute_u8_clamping_params

RNG = np.random.default_rng(0x50F7)


def u8(*shape):
    return RNG.integers(0, 256, shape, dtype=np.int64).astype(np.uint8)


@pytest.mark.parametrize("rows,n", [(5, 1), (9, 3), (16, 128), (9, 301),
                                    (1, 7)])
def test_u8rmax_matches_pallas(rows, n):
    x = u8(rows, n)
    want = np.asarray(u8rmax_pallas(jnp.asarray(x), interpret=True))
    got = u8rmax_plain(torch.from_numpy(x))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(u8rmax_cuda(torch.from_numpy(x)).numpy(),
                                  want)


def test_u8rmax_rejects_empty_rows_and_other_ranks():
    with pytest.raises(ValueError):
        u8rmax_cuda(torch.zeros(3, 0, dtype=torch.uint8))
    with pytest.raises(ValueError):
        u8rmax_cuda(torch.zeros(3, 4, 5, dtype=torch.uint8))


@pytest.mark.parametrize("shape", [(3, 100), (2, 7, 11, 5), (1000,), (33,)])
@pytest.mark.parametrize("lo,hi", [(20, 200), (0, 255), (128, 128)])
def test_u8clamp_matches_pallas(shape, lo, hi):
    x = u8(*shape)
    want = np.asarray(u8clamp_pallas(jnp.asarray(x), JClampParams(lo, hi),
                                     tile_m=8, tile_n=128, interpret=True))
    params = compute_u8_clamping_params(lo, hi)
    np.testing.assert_array_equal(u8clamp_plain(torch.from_numpy(x),
                                                params).numpy(), want)
    tkernels.reset_launch_counts()
    np.testing.assert_array_equal(u8clamp_cuda(torch.from_numpy(x),
                                               params).numpy(), want)
    assert tkernels.launch_counts()["u8clamp"] == 0


@pytest.mark.parametrize("n,scale", [(1, 0.1), (3, 0.5), (128, 0.05),
                                     (301, 1.0)])
def test_u8lut32norm_matches_reference(n, scale):
    x = u8(6, n)
    lut = telem.build_softargmax_lut(scale, n)
    rows = torch.from_numpy(x)
    got = u8lut32norm_cuda(rows, u8rmax_plain(rows), telem.lut32_tensor(lut))
    np.testing.assert_array_equal(got.numpy(), ref.softargmax(x, lut))


def test_u8lut32norm_wraps_at_2_to_32():
    """A table whose entries sum past 2^32: the sum and 256 e wrap in
    uint32, as the reference's do."""
    lut = RNG.integers(2**31, 2**32, 256, dtype=np.uint64).astype(np.uint32)
    x = u8(4, 9)
    rows = torch.from_numpy(x)
    got = u8lut32norm_plain(rows, u8rmax_plain(rows), telem.lut32_tensor(lut))
    np.testing.assert_array_equal(got.numpy(), ref.softargmax(x, lut))


def test_u8lut32norm_sum_wrapping_to_zero_gives_255():
    """N t[255] = 2^32 (N = 4096, scale 0.01): a row of maxima sums to 0
    mod 2^32.  The reference is undefined there; the port takes the GPU's
    uint32 x / 0 = 2^32 - 1, so every output is 255."""
    lut = telem.build_softargmax_lut(0.01, 4096)
    assert int(lut[255]) * 4096 == 2**32
    x = np.full((2, 4096), 255, np.uint8)
    x[1, :7] = 3
    rows = torch.from_numpy(x)
    got = u8lut32norm_plain(rows, u8rmax_plain(rows), telem.lut32_tensor(lut))
    assert got[0].tolist() == [255] * 4096
    np.testing.assert_array_equal(got[1:].numpy(), ref.softargmax(x[1:], lut))


def test_lut32_tensor_keeps_the_bits():
    lut = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1] + [7] * 251,
                   np.uint32)
    t = telem.lut32_tensor(lut)
    assert t.dtype == torch.int32 and tuple(t.shape) == (256,)
    np.testing.assert_array_equal(t.numpy().view(np.uint32), lut)
    assert telem.lut32_tensor(t) is t


# (channels, scale): build_softargmax_lut_factored holds for the first
# three and declines for the rest (see test_factored_form_status).
SOFTARGMAX_CASES = [(128, 0.05), (100, 0.1), (1000, 0.01), (128, 0.5),
                    (3, 1.0), (301, 0.01)]


def test_factored_form_status():
    held = [jelem.build_softargmax_lut_factored(s, c)[1] is not None
            for c, s in SOFTARGMAX_CASES]
    assert held == [True, True, True, False, False, False]


@pytest.mark.parametrize("channels,scale", SOFTARGMAX_CASES)
def test_u8softargmax_matches_jax(channels, scale):
    x = u8(2, 5, channels)
    lut, f16, g16, corr = jelem.build_softargmax_lut_factored(scale, channels)
    fac = None if f16 is None else (jnp.asarray(f16), jnp.asarray(g16), corr)
    want = np.asarray(jelem.u8softargmax(jnp.asarray(x), jnp.asarray(lut),
                                         factored=fac))
    tlut = telem.build_softargmax_lut(scale, channels)
    np.testing.assert_array_equal(tlut, lut)
    tkernels.reset_launch_counts()
    got = telem.u8softargmax(torch.from_numpy(x), tlut)
    assert got.dtype == torch.uint8 and tuple(got.shape) == x.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy().reshape(-1, channels),
        ref.softargmax(x.reshape(-1, channels), lut))
    assert set(tkernels.launch_counts().values()) == {0}


@pytest.mark.parametrize("izp,scale,lo,hi", [(121, 0.25, 0, 255),
                                             (0, 0.05, 10, 240),
                                             (255, 1.5, 0, 255)])
def test_sigmoid_lut_matches_jax(izp, scale, lo, hi):
    np.testing.assert_array_equal(
        telem.build_sigmoid_lut(izp, scale, lo, hi),
        jelem.build_sigmoid_lut(izp, scale, lo, hi))


@pytest.mark.parametrize("izp,ratio,slope,ozp,lo,hi", [
    (121, 0.5, 0.01, 100, 0, 255), (0, 2.0, 0.5, 7, 20, 250),
    (200, 0.01, 1.0, 128, 0, 255)])
def test_leaky_relu_lut_matches_jax(izp, ratio, slope, ozp, lo, hi):
    np.testing.assert_array_equal(
        telem.build_leaky_relu_lut(izp, ratio, slope, ozp, lo, hi),
        jelem.build_leaky_relu_lut(izp, ratio, slope, ozp, lo, hi))


@pytest.mark.parametrize("scale,channels", [(0.05, 128), (0.1, 1),
                                            (1.0, 301), (0.001, 70000)])
def test_softargmax_lut_matches_jax(scale, channels):
    got = telem.build_softargmax_lut(scale, channels)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(
        got, jelem.build_softargmax_lut(scale, channels))


@pytest.mark.parametrize("shape", [(2, 333), (3, 4, 5, 7)])
def test_x8lut_matches_jax(shape):
    x = u8(*shape)
    lut = u8(256)
    want = np.asarray(jelem.x8lut(jnp.asarray(x), lut))
    for table in (lut, torch.from_numpy(lut)):
        got = telem.x8lut(torch.from_numpy(x), table)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------- the kernel's divide, mirrored
U32 = 0xFFFFFFFF


def lut32norm_magic(s):
    """csrc/u8lut32norm.cu:row_div's magic for uint32 sums `s` (uint64
    array): one uint32 divide, m = floor((2^32 - 1) / s) + [s divides
    2^32] = floor(2^32 / s) for s >= 2, and 2^32 - 1 for s <= 1."""
    q = np.uint64(U32) // np.maximum(s, np.uint64(1))
    exact = (np.uint64(U32) - q * s) == s - np.uint64(1)
    return np.where(s > 1, q + exact.astype(np.uint64), np.uint64(U32))


def lut32norm_divide(num, s, m):
    """csrc/u8lut32norm.cu:norm's quotient of uint32 `num` by the row's
    `s` (uint64 arrays holding uint32 values): q0 = mulhi(num, m), then one
    correction, q0 + (num - q0 s >= s), every product and difference in
    uint32."""
    q0 = (num * m) >> np.uint64(32)
    d = (num - q0 * s) & np.uint64(U32)
    return q0 + (d >= s).astype(np.uint64)


def lut32norm_mirror(x, rmax, lut):
    """Whole rows through the kernel's steps: e = t[x + 255 - rmax], the
    wrapping uint32 sum, the magic, num = 256 e + s / 2 (wrapping), the
    quotient, the clamp to 255, and 255 where s == 0 (the fill)."""
    t = lut.astype(np.uint64)
    e = t[x.astype(np.int64) + (255 - rmax.astype(np.int64))[:, None]]
    s = e.sum(axis=-1, keepdims=True) & np.uint64(U32)
    num = (e * np.uint64(256) + (s >> np.uint64(1))) & np.uint64(U32)
    q = lut32norm_divide(num, s, lut32norm_magic(s))
    y = np.minimum(q, np.uint64(255))
    return np.where(s == 0, np.uint64(255), y).astype(np.uint8)


DIVISORS = [1, 2, 3, 255, 256, 2**16 - 1, 2**16 + 1, 2**31 - 1, 2**31,
            2**31 + 1, 2**32 - 1]


def numerators(s, rng):
    """For each divisor: 0, s - 1, s, 2^32 - 1, 256 e + s / 2 for a random
    uint32 e (wrapping past 2^32), and k s - 1, k s at a random k with
    k s < 2^32 (the edges of the correction)."""
    e = rng.integers(0, 2**32, s.shape, dtype=np.uint64)
    k = (rng.random(s.shape) * (np.uint64(U32) // s).astype(np.float64)
         ).astype(np.uint64) + np.uint64(1)
    k = np.minimum(k, np.uint64(U32) // s)
    cols = [np.zeros_like(s), s - np.uint64(1), s,
            np.full_like(s, U32),
            (e * np.uint64(256) + (s >> np.uint64(1))) & np.uint64(U32),
            k * s - np.uint64(1), k * s]
    return np.stack(cols, axis=-1)


@pytest.mark.parametrize("which", ["listed", "random"])
def test_lut32norm_divide_is_exact(which):
    rng = np.random.default_rng(0xD1F)
    if which == "listed":
        s = np.array(DIVISORS, np.uint64)
    else:
        s = rng.integers(1, 2**32, 100_000, dtype=np.uint64)
    n = numerators(s, rng)
    s2 = np.broadcast_to(s[:, None], n.shape)
    m = lut32norm_magic(s2)
    assert int(m.max()) <= U32
    q = lut32norm_divide(n, s2, m)
    np.testing.assert_array_equal(q, n // s2)
    # The JAX package's magic agrees where it fits in uint32 (s >= 2), and
    # its divide (two corrections, s == 1 apart) gives the same quotient.
    n32, s32 = n.astype(np.uint32).ravel(), s2.astype(np.uint32).ravel()
    jm = np.asarray(u32_barrett_magic(jnp.asarray(s32)))
    big = s32 >= 2
    np.testing.assert_array_equal(m.ravel()[big].astype(np.uint32), jm[big])
    jq = np.asarray(u32_div_floor(jnp.asarray(n32), jnp.asarray(s32),
                                  jnp.asarray(jm)))
    np.testing.assert_array_equal(q.ravel().astype(np.uint32), jq)


def test_lut32norm_divide_listed_divisors_cover_the_edges():
    s = np.array(DIVISORS, np.uint64)
    m = lut32norm_magic(s)
    # s = 1 takes 2^32 - 1; powers of two take the + [s divides 2^32] term.
    assert int(m[0]) == U32 and int(m[DIVISORS.index(256)]) == 2**24
    assert int(m[DIVISORS.index(2**31)]) == 2
    n = numerators(s, np.random.default_rng(3))
    assert int(n[:, 4].max()) < 2**32 and (n[:, 4] < n[:, 3]).all()


@pytest.mark.parametrize("case", ["table past 2^31", "bert rows",
                                  "sum wraps to 0"])
def test_lut32norm_mirror_matches_plain(case):
    if case == "table past 2^31":
        lut = RNG.integers(2**31, 2**32, 256, dtype=np.uint64).astype(
            np.uint32)
        x = u8(16, 130)
    elif case == "bert rows":
        lut = telem.build_softargmax_lut(0.05, 128)
        x = u8(16, 128)
    else:
        lut = telem.build_softargmax_lut(0.01, 4096)
        x = np.full((3, 4096), 255, np.uint8)
        x[1, :5] = 7
        x[2] = u8(4096)
    rows = torch.from_numpy(x)
    rmax = u8rmax_plain(rows)
    want = u8lut32norm_plain(rows, rmax, telem.lut32_tensor(lut)).numpy()
    got = lut32norm_mirror(x, rmax.numpy(), lut)
    np.testing.assert_array_equal(got, want)
    if case == "sum wraps to 0":
        assert (got[0] == 255).all()
    else:
        np.testing.assert_array_equal(got, ref.softargmax(x, lut))


# ------------------------------------------------ the row kernels' instance
@pytest.mark.parametrize("n,bases,want", [
    (128, (0,), (16, 8)),                # BERT's score rows, aligned
    (128, (0, 512), (16, 8)),            # u8lut32norm: x and y
    (16, (0,), (16, 1)), (32, (0,), (16, 2)), (64, (0,), (16, 4)),
    (256, (0,), (16, 16)), (512, (0,), (16, 32)), (4096, (0,), (16, 32)),
    (1000, (0,), (8, 32)),               # the lifecycle's SoftArgMax
    (520, (0,), (8, 32)), (24, (0,), (8, 4)), (128, (8,), (8, 16)),
    (8, (0,), (8, 1)), (16, (8,), (8, 2)), (40, (0,), (8, 8)),
    (56, (0,), (8, 8)), (64, (8,), (8, 8)),
    (2, (0,), (1, 2)), (6, (0,), (1, 8)), (10, (0,), (1, 16)),
    (1, (0,), (1, 1)), (3, (0,), (1, 4)), (301, (0,), (1, 32)),
    (128, (1,), (1, 32)), (128, (2,), (1, 32)), (128, (4,), (1, 32)),
    (128, (0, 1), (1, 32)), (1000, (16, 2), (1, 32)),
])
def test_row_instance(n, bases, want):
    assert row_instance(n, *bases) == want
