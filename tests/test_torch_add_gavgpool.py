"""Parity of the port's residual add (q8vadd) and global average pool
(q8gavgpool) with the JAX package: quant.requantize.add_quantize and
q8vadd_pallas, nn.pool.q8gavgpool and q8gavgpool_pallas (interpret mode).
A numpy mirror of csrc/q8vadd.cu's per-byte arithmetic (uint32 sum, the
compare-free rounding shift) is held against add_quantize on all 65,536
(a, b) pairs.  For q8gavgpool: kernels.pool.gavgpool_instance, and a numpy
mirror of csrc/q8gavgpool.cu's mapping (every output made once, every row
read once) and of its sums (row groups, 16-bit halves, the wide form's
flushes, the uint32 wrap with the bias) held against the JAX package's
avgpool_quantize and q8gavgpool_pallas on all-255, all-0 and wrapping
data.  Inputs come from a numpy seed; comparisons are exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qnnpack_tpu.kernels import q8gavgpool_pallas, q8vadd_pallas
from qnnpack_tpu.nn import pool as jpool
from qnnpack_tpu.quant import params as jparams
from qnnpack_tpu.quant.requantize import add_quantize as jadd
from qnnpack_tpu.quant.requantize import avgpool_quantize as javgpool_quantize
from qnnpack_tpu_torch import kernels as tkernels
from qnnpack_tpu_torch.kernels.pool import (HALF_TAPS, gavgpool_instance,
                                            q8gavgpool_cuda, q8gavgpool_plain)
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
        "q8bmm": 0, "u8rmax": 0, "u8lut32norm": 0, "u8clamp": 0,
        "q8gemm_partial": 0, "q8conv_partial": 0, "q8requant": 0,
        "q8gemm_grouped": 0, "q8bmm_masked": 0, "u8softmax_masked": 0,
        "q8rope": 0, "q8swiglu": 0, "moe_route": 0, "moe_combine": 0,
        "q8attn_masked": 0}


# ---------------------------------------- q8gavgpool's instance and mapping
@pytest.mark.parametrize("c,rows,bases,want", [
    (1280, 49, (0, 0), (16, "halves")),      # MobileNetV2
    (512, 49, (0, 0), (16, "halves")),       # ResNet-18
    (960, 49, (0, 0), (16, "halves")),       # ShuffleNet v1 g3
    (1280, 49, (8, 0), (8, "halves")),
    (1280, 49, (0, 4), (4, "halves")),
    (1280, 49, (1, 0), (1, "halves")),
    (24, 257, (0, 0), (8, "halves")),
    (24, 258, (0, 0), (8, "wide")),
    (36, 1000, (0, 0), (4, "wide")),
    (33, 1, (0, 0), (1, "halves")),
    (3, 4096, (0, 16), (1, "wide")),
])
def test_gavgpool_instance(c, rows, bases, want):
    assert gavgpool_instance(c, rows, *bases) == want


# csrc/q8gavgpool.cu's kThreads, kLanes, kBatch and kFlushRows
THREADS, LANES, BATCH, FLUSH_ROWS = 256, 32, 8, 256
EVEN = np.uint32(0x00FF00FF)


def gavg_plan(b, s, c, vec, cap=65535):
    """q8gavgpool.cu's Launch::run: (vecs, bx, by, grid)."""
    vecs = c // vec
    bx = min(vecs, LANES)
    by = max(1, min(THREADS // bx, s))
    return vecs, bx, by, (-(-vecs // bx), min(b, cap))


def gavg_words(x, vec):
    """The words a thread adds: [B, S, C / 4] little-endian uint32 (the
    byte itself where vec = 1)."""
    if vec == 1:
        return x.astype(np.uint32)
    return np.ascontiguousarray(x).view("<u4")


def halves(words):
    """Sums of `words` over axis 1 in 16-bit halves, (even, odd), after
    checking that no half carries into the next."""
    lanes = [(words & EVEN) & np.uint32(0xFFFF), (words & EVEN) >> 16,
             ((words >> 8) & EVEN) & np.uint32(0xFFFF),
             ((words >> 8) & EVEN) >> 16]
    assert max(int(lane.astype(np.int64).sum(axis=1).max(initial=0))
               for lane in lanes) < 2**16
    return ((words & EVEN).sum(axis=1, dtype=np.uint32),
            ((words >> 8) & EVEN).sum(axis=1, dtype=np.uint32))


def unpack(even, odd, vec):
    """The byte sums of (even, odd) words, [..., C]."""
    if vec == 1:
        return even & np.uint32(0xFFFF)
    lanes = [even & np.uint32(0xFFFF), odd & np.uint32(0xFFFF),
             even >> 16, odd >> 16]
    return np.stack(lanes, axis=-1).reshape(*even.shape[:-1], -1)


def gavg_kernel_acc(x, bias, vec, sums):
    """q8gavgpool.cu's int32 accumulator of each output, [B, C] as int64:
    row group g of `by` sums rows g, g + by, ... of its vector in 16-bit
    halves (wide: moved into 32-bit sums every FLUSH_ROWS of its rows); the
    groups' words meet in a uint32 sum (halves: each half apart, with no
    carry); then the bias, wrapping."""
    b, s, c = x.shape
    _, _, by, _ = gavg_plan(b, s, c, vec)
    words = gavg_words(x, vec)
    total = np.zeros((b, c), np.uint32)
    for g in range(by):
        mine = words[:, g::by]
        if sums == "halves":
            assert mine.shape[1] <= HALF_TAPS
            even, odd = halves(mine)
            total += unpack(even, odd, vec)
        else:
            for r0 in range(0, mine.shape[1], FLUSH_ROWS):
                total += unpack(*halves(mine[:, r0:r0 + FLUSH_ROWS]), vec)
    acc = (total.astype(np.int64) + bias) & 0xFFFFFFFF
    return (acc ^ 2**31) - 2**31


def gavg_walk(b, s, c, vec, cap=65535):
    """How often q8gavgpool.cu's reduce writes each output [B, C]: block
    (bx_i, by_i) takes images by_i, by_i + grid_y, ...; thread (tx, ty) the
    output words ty, ty + by, ... of vector bx_i * bx + tx, where it lies
    below vecs."""
    vecs, bx, by, (gx, gy) = gavg_plan(b, s, c, vec, cap)
    assert bx * by <= THREADS and gy <= cap
    words = max(vec // 4, 1)
    made = np.zeros((b, c), np.int64)
    for x_block in range(gx):
        for y_block in range(gy):
            for img in range(y_block, b, gy):
                for tx in range(bx):
                    v = x_block * bx + tx
                    if v >= vecs:
                        continue
                    for ty in range(by):
                        for i in range(ty, words, by):
                            lo = v * vec + 4 * i
                            made[img, lo:lo + min(vec, 4)] += 1
    return made


@pytest.mark.parametrize("b,s,c,vec,cap", [
    (3, 49, 1280, 16, 65535), (2, 49, 960, 16, 65535), (5, 49, 512, 16, 2),
    (3, 9, 33, 1, 65535), (2, 300, 24, 8, 65535), (4, 1, 20, 4, 3),
    (7, 258, 3, 1, 2), (2, 1000, 48, 16, 1)])
def test_gavgpool_walk_makes_every_output_once(b, s, c, vec, cap):
    assert (gavg_walk(b, s, c, vec, cap) == 1).all()


def test_gavgpool_row_groups_read_every_row_once():
    for s, c, vec in ((49, 1280, 16), (1, 16, 16), (257, 3, 1),
                      (4096, 512, 16), (300, 40, 8)):
        _, _, by, _ = gavg_plan(1, s, c, vec)
        rows = np.concatenate([np.arange(g, s, by) for g in range(by)])
        assert sorted(rows.tolist()) == list(range(s))


# (b, s, c, base offset, fill or None, bias or None for -izp * s, izp)
GAVG_MIRROR = {
    "mobilenet 49x1280": (2, 49, 1280, 0, None, None, 128),
    "shufflenet 49x960": (2, 49, 960, 0, None, None, 128),
    "all 255, S = 257 (halves full)": (2, 257, 64, 0, 255, None, 0),
    "all 255, S = 258 (wide)": (2, 258, 64, 0, 255, None, 0),
    "all 255, S = 4096, a flush": (2, 4096, 512, 0, 255, None, 0),
    "all 0, izp 255, S = 49": (2, 49, 24, 0, 0, None, 255),
    "random S = 1000, C = 17": (2, 1000, 17, 0, None, None, 121),
    # (q8gavgpool_pallas adds bias + 128 S as an int32 constant)
    "bias wraps int32, all 255": (2, 33, 40, 0, 255, 2**31 - 5000, 0),
    "bias at -2^31, all 0, base + 4": (2, 49, 36, 4, 0, -2**31, 255),
    "S = 1, C = 3, base + 1": (3, 1, 3, 1, None, None, 7),
}


@pytest.mark.parametrize("case", list(GAVG_MIRROR))
def test_gavgpool_kernel_mirror_matches_jax(case):
    b, s, c, offset, fill, bias, izp = GAVG_MIRROR[case]
    x = (u8(b, s, c) if fill is None else np.full((b, s, c), fill, np.uint8))
    if bias is None:
        bias = -izp * s
    args = (bias, 2**-20 if fill == 255 else 1.0 / s, 128)
    jp = jparams.compute_avgpool_quant_params(*args, input_zero_point=izp)
    tp = tparams.compute_avgpool_quant_params(*args, input_zero_point=izp)
    vec, sums = gavgpool_instance(c, s, offset, 0)
    assert (sums == "wide") == (s > HALF_TAPS)
    acc = gavg_kernel_acc(x, bias, vec, sums)
    got = np.asarray(javgpool_quantize(jnp.asarray(acc.astype(np.int32)), jp))
    want = np.asarray(q8gavgpool_pallas(jnp.asarray(x), jp, interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        q8gavgpool_plain(torch.from_numpy(x), tp).numpy(), want)


def test_gavgpool_wrapping_bias_changes_the_output():
    """The wrap case is real: unwrapped, the accumulator would pass 2^31 and
    requantize to 255; wrapped, it is negative and requantizes to 0."""
    x = np.full((2, 33, 40), 255, np.uint8)
    acc = gavg_kernel_acc(x, 2**31 - 5000, 8, "halves")
    assert (acc < 0).all()
    tp = tparams.compute_avgpool_quant_params(2**31 - 5000, 2**-20, 128)
    assert (q8gavgpool_plain(torch.from_numpy(x), tp) == 0).all()
