"""Parity of the port's weight packing and quantized GEMM with the JAX
package: nn.packing.pack_gemm_weights, nn.gemm.q8gemm_acc / q8gemm, and
the q8gemm kernel's plain version against the XLA path and both Pallas
GEMM kernels (run in interpret mode, as tests/test_kernels_pallas.py
does); the packed fields the tensor-core kernel reads (K-major weights and
the raw-uint8 bias) and the sum it forms from them, whole and split over
K; the wrapper's block-shape and split-K plan; the row-sum pair
(q8gemm_row_sums_out -> q8gemm_presummed) chained as tests/test_q8gemm.py
chains it, and the consumer kernel's sum from the given row sums.  Inputs
come from a numpy seed; comparisons are exact."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qnnpack_tpu.kernels.q8gemm import q8gemm_pallas
from qnnpack_tpu.kernels.q8gemm_small import q8gemm_small_pallas
from qnnpack_tpu.nn import gemm as jgemm
from qnnpack_tpu.nn import packing as jpacking
from qnnpack_tpu.nn.requant_dispatch import make_requant_params as jmake
from qnnpack_tpu.quant.params import \
    compute_per_channel_fp32_params as jper_channel
from qnnpack_tpu_torch import config as tconfig
from qnnpack_tpu_torch import kernels as tkernels
from qnnpack_tpu_torch.kernels import q8gemm as tq8gemm
from qnnpack_tpu_torch.kernels.q8gemm import q8gemm_cuda, q8gemm_plain
from qnnpack_tpu_torch.nn import gemm as tgemm
from qnnpack_tpu_torch.nn import packing as tpacking
from qnnpack_tpu_torch.nn.requant_dispatch import apply_requant
from qnnpack_tpu_torch.nn.requant_dispatch import make_requant_params as tmake
from qnnpack_tpu_torch.quant.params import \
    compute_per_channel_fp32_params as tper_channel

RNG = np.random.default_rng(0x6E88)


def u8(*shape):
    return RNG.integers(0, 256, shape, dtype=np.int64).astype(np.uint8)


def make_weights(n, k, izp, kzp):
    kernel = u8(n, k)
    bias = RNG.integers(-30000, 30000, n, dtype=np.int64).astype(np.int32)
    return (jpacking.pack_gemm_weights(kernel, bias, izp, kzp),
            tpacking.pack_gemm_weights(kernel, bias, izp, kzp))


def requant_pair(scheme, n):
    if scheme == "per_channel":
        scales = RNG.uniform(1e-4, 3e-3, n)
        return jper_channel(scales, 119), tper_channel(scales, 119)
    return (jmake(scheme, 0.0021, 119, 3, 250),
            tmake(scheme, 0.0021, 119, 3, 250))


@pytest.mark.parametrize("izp,kzp", [(128, 128), (121, 103), (0, 255),
                                     (255, 0)])
@pytest.mark.parametrize("n,k", [(16, 27), (33, 64), (7, 1)])
def test_pack_gemm_weights_matches_jax(n, k, izp, kzp):
    jp, tp = make_weights(n, k, izp, kzp)
    np.testing.assert_array_equal(tp.w.numpy(), np.asarray(jp.w))
    np.testing.assert_array_equal(tp.bias_folded.numpy(),
                                  np.asarray(jp.bias_folded))
    assert (tp.k, tp.n, tp.kzp_biased) == (jp.k, jp.n, jp.kzp_biased)
    assert tp.w.dtype == torch.int8 and tp.w.is_contiguous()
    assert tp.bias_folded.dtype == torch.int32


def test_pack_gemm_weights_without_bias():
    kernel = u8(9, 13)
    jp = jpacking.pack_gemm_weights(kernel, None, 7, 200)
    tp = tpacking.pack_gemm_weights(kernel, None, 7, 200)
    np.testing.assert_array_equal(tp.bias_folded.numpy(),
                                  np.asarray(jp.bias_folded))


@pytest.mark.parametrize("scheme", ["q31", "fp32", "precise", "gemmlowp",
                                    "per_channel"])
@pytest.mark.parametrize("izp,kzp", [(128, 128), (121, 103)])
@pytest.mark.parametrize("shape", [(37, 45, 19), (2, 5, 3, 40, 24),
                                   (1, 1280, 100)],
                         ids=["rank2", "rank4", "fc_m1"])
def test_q8gemm_matches_jax(shape, izp, kzp, scheme):
    *lead, k, n = shape
    jp, tp = make_weights(n, k, izp, kzp)
    jr, tr = requant_pair(scheme, n)
    a = u8(*lead, k)
    want_acc = np.asarray(jgemm.q8gemm_acc(jnp.asarray(a), jp))
    got_acc = tgemm.q8gemm_acc(torch.from_numpy(a), tp)
    np.testing.assert_array_equal(got_acc.numpy(), want_acc)
    want = np.asarray(jgemm.q8gemm(jnp.asarray(a), jp, jr))
    got = tgemm.q8gemm(torch.from_numpy(a), tp, tr)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("scheme", ["q31", "fp32", "per_channel"])
@pytest.mark.parametrize("m,k,n,kzp", [(70, 40, 48, 128), (33, 27, 16, 103),
                                       (5, 130, 129, 90)])
def test_plain_kernel_matches_pallas_small(m, k, n, kzp, scheme):
    jp, tp = make_weights(n, k, 121, kzp)
    jr, tr = requant_pair(scheme, n)
    a = u8(m, k)
    want = np.asarray(q8gemm_small_pallas(jnp.asarray(a), jp, jr, tile_m=32,
                                          interpret=True))
    np.testing.assert_array_equal(
        q8gemm_plain(torch.from_numpy(a), tp, tr).numpy(), want)


@pytest.mark.parametrize("scheme", ["q31", "fp32", "gemmlowp"])
@pytest.mark.parametrize("m,k,n,kzp", [(40, 200, 130, 128),
                                       (33, 257, 64, 103)])
def test_plain_kernel_matches_pallas_k_tiled(m, k, n, kzp, scheme):
    # tile_k = 128 makes the Pallas kernel carry its accumulator and row
    # sum across K steps: the contract the CUDA kernel's in-block K loop
    # takes over.
    jp, tp = make_weights(n, k, 7, kzp)
    jr, tr = requant_pair(scheme, n)
    a = u8(m, k)
    want = np.asarray(q8gemm_pallas(jnp.asarray(a), jp, jr, tile_m=32,
                                    tile_n=128, tile_k=128, interpret=True))
    np.testing.assert_array_equal(
        q8gemm_plain(torch.from_numpy(a), tp, tr).numpy(), want)


def test_wrapper_on_cpu_runs_plain_and_counts_nothing():
    jp, tp = make_weights(24, 31, 128, 128)
    _, tr = requant_pair("fp32", 24)
    a = torch.from_numpy(u8(9, 31))
    tkernels.reset_launch_counts()
    np.testing.assert_array_equal(q8gemm_cuda(a, tp, tr).numpy(),
                                  q8gemm_plain(a, tp, tr).numpy())
    assert q8gemm_cuda.launches == 0


def test_wrapper_rejects_wrong_depth():
    _, tp = make_weights(8, 16, 128, 128)
    _, tr = requant_pair("q31", 8)
    with pytest.raises(ValueError):
        q8gemm_cuda(torch.zeros(4, 15, dtype=torch.uint8), tp, tr)


def test_large_accumulators_wrap_like_int32():
    # A large bias pushes the accumulator past int32; both packages wrap.
    k, n = 64, 8
    kernel = np.zeros((n, k), np.uint8)
    bias = np.full(n, 2**31 - 5, np.int64).astype(np.int32)
    jp = jpacking.pack_gemm_weights(kernel, bias, 0, 128)
    tp = tpacking.pack_gemm_weights(kernel, bias, 0, 128)
    a = np.full((3, k), 255, np.uint8)
    want = np.asarray(jax.jit(jgemm.q8gemm_acc)(jnp.asarray(a), jp))
    got = tgemm.q8gemm_acc(torch.from_numpy(a), tp)
    np.testing.assert_array_equal(got.numpy(), want)


# The tensor-core kernels' form of the same sum (csrc/imma_tile.cuh): raw
# uint8 A, K-major weights zero-padded to the 64-byte K step, and
# c = bias' - 128 colsum(W') + 128 K kzp', all mod 2^32.

def kmajor_acc(a, tp, split_steps=None):
    """sum_k A W'_kmajor + c - kzp' sum_k A in int64 mod 2^32, as an int64
    array holding the wrapped int32 value; with `split_steps`, the K steps
    of 64 are summed in parts of that many steps and the parts added mod
    2^32, as split-K does."""
    wk = tp.w_kmajor.numpy().astype(np.int64)
    kp = wk.shape[1]
    a64 = np.zeros(a.shape[:-1] + (kp,), np.int64)
    a64[..., :a.shape[-1]] = a
    step = tpacking.K_STEP * (split_steps or kp)
    prod = np.zeros(a.shape[:-1] + (wk.shape[0],), np.int64)
    for k0 in range(0, kp, step):
        part = a64[..., k0:k0 + step] @ wk[:, k0:k0 + step].T
        prod = (prod + part) & 0xFFFFFFFF
    acc = (prod + tp.bias_c.numpy().astype(np.int64)
           - tp.kzp_biased * a64.sum(axis=-1, keepdims=True))
    return ((acc + 2**31) & 0xFFFFFFFF) - 2**31


@pytest.mark.parametrize("izp,kzp", [(128, 128), (121, 103), (0, 255),
                                     (255, 0)])
@pytest.mark.parametrize("n,k", [(16, 27), (33, 64), (7, 1), (5, 130)])
def test_kmajor_weights_are_w_transposed_and_padded(n, k, izp, kzp):
    _, tp = make_weights(n, k, izp, kzp)
    kp = -(-k // 64) * 64
    assert tuple(tp.w_kmajor.shape) == (n, kp)
    assert tp.w_kmajor.dtype == torch.int8 and tp.w_kmajor.is_contiguous()
    np.testing.assert_array_equal(tp.w_kmajor[:, :k].numpy(), tp.w.numpy().T)
    assert not tp.w_kmajor[:, k:].any()
    w = tp.w.numpy().astype(np.int64)
    want = (tp.bias_folded.numpy().astype(np.int64) - 128 * w.sum(axis=0)
            + 128 * k * (kzp - 128))
    np.testing.assert_array_equal(tp.bias_c.numpy(),
                                  (((want + 2**31) & 0xFFFFFFFF) - 2**31))
    assert tp.bias_c.dtype == torch.int32


@pytest.mark.parametrize("scheme", ["q31", "fp32", "per_channel"])
@pytest.mark.parametrize("kzp", [128, 103, 0, 255])
@pytest.mark.parametrize("m,k,n", [(37, 45, 19), (5, 77, 3), (9, 130, 129),
                                   (3, 1, 7), (11, 200, 24)])
def test_kmajor_sum_matches_reference(m, k, n, kzp, scheme):
    jp, tp = make_weights(n, k, 121, kzp)
    jr, tr = requant_pair(scheme, n)
    a = u8(m, k)
    acc = kmajor_acc(a, tp)
    np.testing.assert_array_equal(
        acc, tgemm.q8gemm_acc(torch.from_numpy(a), tp).numpy())
    want = np.asarray(jgemm.q8gemm(jnp.asarray(a), jp, jr))
    got = apply_requant(torch.from_numpy(acc), tr)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("split_steps", [1, 2, 3])
def test_kmajor_sum_split_over_k_is_exact(split_steps):
    """Split-K's parts, added mod 2^32 in any grouping, give the whole."""
    _, tp = make_weights(21, 400, 7, 90)
    a = u8(13, 400)
    np.testing.assert_array_equal(kmajor_acc(a, tp, split_steps),
                                  kmajor_acc(a, tp))


@pytest.mark.parametrize("kzp", [128, 0])
def test_kmajor_sum_wraps_like_int32(kzp):
    # test_large_accumulators_wrap_like_int32's operands, in the kernels'
    # form: the accumulator passes 2^31 and wraps the same way.
    k, n = 64, 8
    kernel = np.zeros((n, k), np.uint8)
    bias = np.full(n, 2**31 - 5, np.int64).astype(np.int32)
    jp = jpacking.pack_gemm_weights(kernel, bias, 0, kzp)
    tp = tpacking.pack_gemm_weights(kernel, bias, 0, kzp)
    a = np.full((3, k), 255, np.uint8)
    want = np.asarray(jax.jit(jgemm.q8gemm_acc)(jnp.asarray(a), jp))
    np.testing.assert_array_equal(kmajor_acc(a, tp), want)


# The H100's ridge, 1,979 TOP/s over 3.35 TB/s (config.tune_params).
H100_RIDGE = tq8gemm.ridge_of(tconfig._TUNE_TABLE["nvidia h100"])
# (M, N, K) of this table's launches that take the wgmma instance on the
# H100: BERT's four b128 projections (qkv 1,113 int8 operations a byte,
# out 750, ffn1 and ffn2 1,185), its b8 qkv and ffn2 (737 and 768, 72 and
# 24 tiles of 128 x 256 on 132 SMs), b16 out (647) and b64 out (734).
# BERT's b8 out (559) stays below the ridge.
WGMMA_SHAPES = {(16384, 2304, 768), (16384, 768, 768), (16384, 3072, 768),
                (16384, 768, 3072), (1024, 2304, 768), (1024, 768, 3072),
                (2048, 768, 768), (8192, 768, 768)}


@pytest.mark.parametrize("m,n,k,groups,want_tile,want_split", [
    (16384, 2304, 768, 1, 3, False),   # BERT b128 qkv: 128-byte stages
    (6272, 1280, 320, 1, 0, False),    # MobileNetV2 b128 head: K < 512
    (1605632, 96, 16, 1, 0, False),    # MobileNetV2 b128 expand
    (401408, 24, 144, 1, 1, False),    # N <= 64: 128 x 64
    (128, 768, 3072, 1, 2, True),      # BERT b1 ffn2: 64 x 64, split-K
    (49, 512, 4608, 1, 2, True),       # ResNet-18 b1 7x7x512 3x3
    (784, 20, 80, 3, 2, False),        # ShuffleNet b1 grouped 1x1
    (1, 1000, 512, 1, 2, True),        # FC at batch 1
    (1088, 256, 70000, 1, 2, True),    # K past 65,536: split for exactness
    (1, 1, 1, 1, 2, False),
    (16384, 768, 768, 1, 3, False),    # BERT b128 out
    (16384, 3072, 768, 1, 3, False),   # BERT b128 ffn1
    (16384, 768, 3072, 1, 3, False),   # BERT b128 ffn2
    (128, 2304, 768, 1, 2, False),     # BERT b1 qkv
    (6272, 160, 960, 1, 1, False),     # MobileNetV2 b128 project 960->160
    (128, 1000, 512, 1, 2, True),      # ResNet-18 b128 FC
    (1024, 2304, 768, 1, 3, False),    # BERT b8 qkv
    (1024, 768, 3072, 1, 2, False),    # BERT b8 ffn2
    (2048, 768, 768, 1, 1, False),     # BERT b16 out
    (8192, 768, 768, 1, 3, False),     # BERT b64 out
    (1024, 768, 768, 1, 2, False),     # BERT b8 out
])
def test_tile_plan(m, n, k, groups, want_tile, want_split):
    steps = tpacking.round_up(k) // tpacking.K_STEP
    tile, splits, per = tq8gemm.tile_plan(m, n, steps, groups, 132)
    assert (tile, splits > 1) == (want_tile, want_split)
    shallow = tq8gemm.tile_plan(m, n, steps, groups, 132, deep=False)
    assert shallow == ((0 if tile == 3 else tile), splits, per)
    assert per <= tq8gemm.MAX_CHAIN_STEPS
    assert (splits - 1) * per < steps <= splits * per
    bm, bn = tq8gemm.TILES[tile]
    blocks = -(-m // bm) * -(-n // bn) * groups
    assert splits == 1 or blocks * splits <= 132 or k > 65536
    # The route on the H100: only launches at or above the ridge, however
    # few SMs their tiles fill (a grouped launch is q8conv's, which never
    # takes the wgmma instance).
    route = groups == 1 and tq8gemm.wgmma_route(m, n, k, steps, H100_RIDGE)
    assert route == ((m, n, k) in WGMMA_SHAPES)


@pytest.mark.parametrize("case,kwargs,want", [
    ("aligned plain", {}, True),
    ("A base 8 bytes off 16", dict(a_ptr=0x1000 + 8), False),
    ("A base 16-byte aligned", dict(a_ptr=0x1000 + 16), True),
    ("K % 16 != 0", dict(k=776), False),
    ("row-sum producer or consumer", dict(plain=False), False),
    ("partial", dict(plain=False), False),
    ("K past one int32 chain", dict(k=65600), False),
    ("generic card", dict(ridge=0.0), False),
    ("M past the kernel's int coordinates", dict(m=2**31), False),
    ("BERT b8 ffn1: 96 tiles on 132 SMs", dict(m=1024), True),
    ("BERT b8 out: 559 operations a byte", dict(m=1024, n=768), False),
])
def test_wgmma_route_gates(case, kwargs, want):
    """BERT b128 ffn1, 1,185 int8 operations a byte, under each gate of
    the route: A's alignment and K % 16 (TMA), the plain instance only
    (the row-sum pair and the partial keep mma.sync), one chain, a card
    with known peaks, the ridge (b8 out falls below it; b8 ffn1 routes
    although its 96 tiles leave SMs idle)."""
    args = dict(m=16384, n=3072, k=768, ridge=H100_RIDGE)
    args.update(kwargs)
    args["steps"] = tpacking.round_up(args["k"]) // tpacking.K_STEP
    assert tq8gemm.wgmma_route(**args) is want


@pytest.mark.parametrize("peaks,want", [
    ((1979.0, 3350.0), {"qkv", "out", "ffn1", "ffn2"}),   # the H100, ~591
    ((1979.0, 2500.0), {"qkv", "ffn1", "ffn2"}),          # ridge ~792
    ((1979.0, 1000.0), set()),                             # ridge 1,979
    ((0.0, 0.0), set()),                                   # "generic"
])
def test_wgmma_route_follows_the_cards_ridge(peaks, want):
    """The ridge is tune_params' int8 peak over its memory rate; the same
    BERT b128 launches route by it, and a card with no peaks routes none."""
    tops, gbps = peaks
    ridge = tq8gemm.ridge_of(tconfig.TuneParams("card", int8_peak_tops=tops,
                                                hbm_gbps=gbps))
    assert ridge == (tops / gbps * 1e3 if gbps else 0.0)
    shapes = {"qkv": (16384, 2304, 768), "out": (16384, 768, 768),
              "ffn1": (16384, 3072, 768), "ffn2": (16384, 768, 3072)}
    got = {name for name, (m, n, k) in shapes.items()
           if tq8gemm.wgmma_route(m, n, k, -(-k // 64), ridge)}
    assert got == want


def test_generic_card_routes_nothing():
    assert tq8gemm.ridge_of(tconfig.TuneParams("generic")) == 0.0
    assert tq8gemm.ridge_of(tconfig._TUNE_TABLE["cpu"]) == 0.0
    assert H100_RIDGE == pytest.approx(1979.0 / 3.35)


@pytest.mark.parametrize("blocks", [1, 4096, 5000])
def test_split_counters_are_per_stream(blocks, monkeypatch):
    """Two streams of one device get counter storage of their own, so
    split-K launches in flight on both never count on the same tiles; one
    stream keeps its counters (zeroed) across launches."""
    monkeypatch.setattr(tq8gemm, "_counters", {})
    dev = torch.device("cpu")
    first = tq8gemm._split_counters(dev, 0x1000, blocks)
    second = tq8gemm._split_counters(dev, 0x2000, blocks)
    assert first.data_ptr() != second.data_ptr()
    assert first.numel() >= blocks and second.numel() >= blocks
    assert first.dtype == torch.int32 and not first.any()
    assert tq8gemm._split_counters(dev, 0x1000, blocks) is first
    assert tq8gemm._split_counters("cpu", 0x2000, 1) is second
    assert len(tq8gemm._counters) == 2


ROW_SUM_ZPS = [((121, 103), (117, 99)), ((128, 128), (128, 128)),
               ((128, 103), (128, 255))]


@pytest.mark.parametrize("scheme", ["fp32", "q31"])
@pytest.mark.parametrize("zps", ROW_SUM_ZPS, ids=["kzp_ne_128", "kzp_128",
                                                  "mixed"])
@pytest.mark.parametrize("m,k,n", [(17, 33, 29), (1, 1, 1), (40, 130, 257),
                                   (64, 64, 16)])
def test_row_sum_chain_matches_jax(m, k, n, zps, scheme):
    """The producer's y and row sums, then the consumer on them, each
    equal to the JAX pair and to plain chained q8gemm."""
    (izp1, kzp1), (izp2, kzp2) = zps
    x = u8(m, k)
    w1, w2 = u8(k, k), u8(n, k)
    rp1 = (jmake(scheme, 0.004, izp2), tmake(scheme, 0.004, izp2))
    rp2 = (jmake(scheme, 0.003, 121), tmake(scheme, 0.003, 121))
    jp1 = jpacking.pack_gemm_weights(w1, None, izp1, kzp1)
    jp2 = jpacking.pack_gemm_weights(w2, None, izp2, kzp2)
    tp1 = tpacking.pack_gemm_weights(w1, None, izp1, kzp1)
    tp2 = tpacking.pack_gemm_weights(w2, None, izp2, kzp2)
    ja, jrs = jgemm.q8gemm_row_sums_out(jnp.asarray(x), jp1, rp1[0])
    tkernels.reset_launch_counts()
    ta, trs = tgemm.q8gemm_row_sums_out(torch.from_numpy(x), tp1, rp1[1])
    assert ta.dtype == torch.uint8 and trs.dtype == torch.int32
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(trs.numpy(), np.asarray(jrs))
    np.testing.assert_array_equal(
        trs.numpy(), ta.numpy().astype(np.int64).sum(-1) - 128 * k)
    got = tgemm.q8gemm_presummed(ta, trs, tp2, rp2[1])
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jgemm.q8gemm_presummed(ja, jrs, jp2,
                                                       rp2[0])))
    np.testing.assert_array_equal(got.numpy(),
                                  tgemm.q8gemm(ta, tp2, rp2[1]).numpy())
    assert set(tkernels.launch_counts().values()) == {0}


def test_row_sum_pair_keeps_leading_axes():
    x = u8(2, 3, 40)
    tp1 = tpacking.pack_gemm_weights(u8(24, 40), None, 121, 103)
    tp2 = tpacking.pack_gemm_weights(u8(8, 24), None, 117, 99)
    rp = tmake("fp32", 0.004, 117)
    y, rs = tgemm.q8gemm_row_sums_out(torch.from_numpy(x), tp1, rp)
    assert tuple(y.shape) == (2, 3, 24) and tuple(rs.shape) == (2, 3)
    got = tgemm.q8gemm_presummed(y, rs, tp2, rp)
    np.testing.assert_array_equal(got.numpy(),
                                  tgemm.q8gemm(y, tp2, rp).numpy())


@pytest.mark.parametrize("kzp", [103, 128, 255])
def test_consumer_takes_any_row_sums_as_jax(kzp):
    """The consumer applies the given sums, whatever they are (JAX's
    q8gemm_presummed does not check them)."""
    a = u8(9, 70)
    rs = RNG.integers(-2**31, 2**31, 9, dtype=np.int64).astype(np.int32)
    jp, tp = make_weights(11, 70, 121, kzp)
    jr, tr = requant_pair("q31", 11)
    want = np.asarray(jgemm.q8gemm_presummed(jnp.asarray(a), jnp.asarray(rs),
                                             jp, jr))
    got = tgemm.q8gemm_presummed(torch.from_numpy(a), torch.from_numpy(rs),
                                 tp, tr)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kzp", [103, 128, 0])
@pytest.mark.parametrize("m,k,n", [(17, 33, 29), (5, 130, 3)])
def test_consumer_kernel_sum_from_given_row_sums(m, k, n, kzp):
    """What the consumer instance computes: the product of raw A by the
    K-major weights, + c, - kzp' * (rs + 128 K) with the true K, mod 2^32,
    equals the reference accumulator (the raw sum A is rs + 128 K; the
    zeros past K add nothing)."""
    _, tp = make_weights(n, k, 121, kzp)
    a = u8(m, k)
    rs = a.astype(np.int64).sum(-1) - 128 * k
    wk = tp.w_kmajor.numpy().astype(np.int64)
    a64 = np.zeros((m, wk.shape[1]), np.int64)
    a64[:, :k] = a
    acc = (a64 @ wk.T + tp.bias_c.numpy().astype(np.int64)
           - tp.kzp_biased * (rs + 128 * k)[:, None])
    acc = ((acc + 2**31) & 0xFFFFFFFF) - 2**31
    np.testing.assert_array_equal(acc, kmajor_acc(a, tp))
    np.testing.assert_array_equal(
        acc, tgemm.q8gemm_acc(torch.from_numpy(a), tp).numpy())


def test_row_sum_wrappers_check_their_operands():
    tp = tpacking.pack_gemm_weights(u8(8, 16), None, 121, 103)
    rp = tmake("fp32", 0.01, 128)
    a = torch.from_numpy(u8(4, 16))
    with pytest.raises(ValueError, match="K = 16"):
        tq8gemm.q8gemm_row_sums_cuda(a[:, :8], tp, rp)
    with pytest.raises(ValueError, match="row sums"):
        tq8gemm.q8gemm_presummed_cuda(a, torch.zeros(3, dtype=torch.int32),
                                      tp, rp)
