"""Parity of the port's dense and grouped conv kernels with the JAX
package: the q8conv and q8stem kernels' plain versions against
nn.conv.q8conv2d and against q8conv_pallas / q8stem_pallas in interpret
mode, grouped q8conv against q8conv2d's grouped branches, the dense-conv
route (which kernel q8conv2d picks), and the stem kernel's contract; the
packed fields the tensor-core q8conv kernel reads (K-major weights padded
per tap, the raw-uint8 bias) and the sum it forms from a gather with raw
izp at the borders.  Inputs come from a numpy seed; comparisons are
exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qnnpack_tpu.kernels.q8conv import q8conv_pallas
from qnnpack_tpu.kernels.q8stem import q8stem_pallas
from qnnpack_tpu.nn import conv as jconv
from qnnpack_tpu.nn.requant_dispatch import make_requant_params as jmake
from qnnpack_tpu.quant.params import \
    compute_per_channel_fp32_params as jper_channel
from qnnpack_tpu_torch import kernels as tkernels
from qnnpack_tpu_torch.kernels.q8conv import q8conv_cuda, q8conv_plain
from qnnpack_tpu_torch.kernels.q8gemm import gemm_acc_plain
from qnnpack_tpu_torch.kernels.q8stem import (q8stem_cuda, q8stem_plain,
                                              stem_tile)
from qnnpack_tpu_torch.nn import conv as tconv
from qnnpack_tpu_torch.nn.requant_dispatch import apply_requant
from qnnpack_tpu_torch.nn.requant_dispatch import make_requant_params as tmake
from qnnpack_tpu_torch.quant.params import \
    compute_per_channel_fp32_params as tper_channel

RNG = np.random.default_rng(0xC0A7)


def u8(*shape):
    return RNG.integers(0, 256, shape, dtype=np.int64).astype(np.uint8)


def make_weights(o, kh, kw, icpg, izp, kzp):
    kernel = u8(o, kh, kw, icpg)
    bias = RNG.integers(-20000, 20000, o, dtype=np.int64).astype(np.int32)
    return (jconv.pack_conv_weights(kernel, bias, izp, kzp),
            tconv.pack_conv_weights(kernel, bias, izp, kzp))


def requant_pair(scheme, n):
    if scheme == "per_channel":
        scales = RNG.uniform(1e-4, 2e-3, n)
        return jper_channel(scales, 117), tper_channel(scales, 117)
    return jmake(scheme, 0.0037, 117), tmake(scheme, 0.0037, 117)


S2 = ((0, 1), (0, 1))
P1 = ((1, 1), (1, 1))
P0 = ((0, 0), (0, 0))

CONV_CASES = {
    # h, w, cin, cout, k, stride, padding, dilation
    "3x3_s1_pad1": (9, 8, 16, 24, 3, 1, P1, 1),
    "3x3_s2_pad01": (10, 9, 8, 16, 3, 2, S2, 1),
    "1x1_s2": (9, 10, 16, 32, 1, 2, P0, 1),
    "dilation2": (11, 9, 8, 12, 3, 1, ((2, 2), (2, 2)), 2),
    "c3": (12, 11, 3, 8, 3, 2, S2, 1),
    "c5_5x5": (9, 9, 5, 7, 5, 1, ((2, 2), (2, 2)), 1),
}


@pytest.mark.parametrize("scheme", ["q31", "fp32", "precise", "gemmlowp",
                                    "per_channel"])
@pytest.mark.parametrize("case", list(CONV_CASES))
@pytest.mark.parametrize("izp,kzp", [(128, 128), (121, 103)])
def test_q8conv_plain_matches_q8conv2d(case, scheme, izp, kzp):
    h, w, cin, cout, k, s, pad, d = CONV_CASES[case]
    jp, tp = make_weights(cout, k, k, cin, izp, kzp)
    jr, tr = requant_pair(scheme, cout)
    a = u8(2, h, w, cin)
    kw = dict(strides=(s, s), padding=pad, dilation=(d, d))
    want = np.asarray(jconv.q8conv2d(jnp.asarray(a), jp, jr, **kw))
    got = q8conv_plain(torch.from_numpy(a), tp, tr, **kw)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["3x3_s1_pad1", "3x3_s2_pad01", "1x1_s2",
                                  "dilation2", "c3"])
@pytest.mark.parametrize("izp,kzp,scheme", [(128, 128, "fp32"),
                                            (121, 103, "q31")])
def test_q8conv_plain_matches_pallas(case, izp, kzp, scheme):
    h, w, cin, cout, k, s, pad, d = CONV_CASES[case]
    jp, tp = make_weights(cout, k, k, cin, izp, kzp)
    jr, tr = requant_pair(scheme, cout)
    a = u8(1, h, w, cin)
    kw = dict(strides=(s, s), padding=pad, dilation=(d, d))
    want = np.asarray(q8conv_pallas(jnp.asarray(a), jp, jr, tile_h=3,
                                    interpret=True, **kw))
    np.testing.assert_array_equal(
        q8conv_plain(torch.from_numpy(a), tp, tr, **kw).numpy(), want)


def test_q8conv_zero_point_padding_is_not_zero():
    """izp != 128 with padding: a padded tap reads the input zero point,
    which multiplies W' and enters the kzp row sum."""
    jp, tp = make_weights(6, 3, 3, 4, 7, 250)
    jr, tr = requant_pair("q31", 6)
    a = u8(1, 5, 5, 4)
    kw = dict(strides=(1, 1), padding=((2, 2), (2, 2)))
    want = np.asarray(jconv.q8conv2d(jnp.asarray(a), jp, jr, **kw))
    np.testing.assert_array_equal(
        q8conv_plain(torch.from_numpy(a), tp, tr, **kw).numpy(), want)


GROUPED_CASES = {
    # h, w, groups, icpg, ocpg, k, stride, padding
    "g2_1x1": (6, 5, 2, 16, 24, 1, 1, P0),
    "g3_1x1_icpg20": (5, 6, 3, 20, 72, 1, 1, P0),
    "g4_1x1_ocpg17": (5, 7, 4, 8, 17, 1, 1, P0),
    "g8_1x1": (4, 4, 8, 12, 6, 1, 1, P0),
    "g3_3x3_pad1": (7, 6, 3, 5, 4, 3, 1, P1),
    "g2_3x3_s2_pad01": (9, 8, 2, 8, 8, 3, 2, S2),
}


@pytest.mark.parametrize("scheme", ["q31", "fp32", "per_channel"])
@pytest.mark.parametrize("izp,kzp", [(128, 128), (121, 103)])
@pytest.mark.parametrize("batch", [1, 40])
@pytest.mark.parametrize("case", list(GROUPED_CASES))
def test_grouped_q8conv_plain_matches_q8conv2d(case, batch, izp, kzp,
                                                scheme):
    """Batch 1 takes the JAX package's einsum branch for grouped 1x1, batch
    40 its feature_group_count branch (config.TuneParams.
    grouped_1x1_einsum_max_batch = 32)."""
    h, w, groups, icpg, ocpg, k, s, pad = GROUPED_CASES[case]
    o = groups * ocpg
    kernel = u8(o, k, k, icpg)
    bias = RNG.integers(-20000, 20000, o, dtype=np.int64).astype(np.int32)
    jp = jconv.pack_conv_weights(kernel, bias, izp, kzp, groups)
    tp = tconv.pack_conv_weights(kernel, bias, izp, kzp, groups)
    jr, tr = requant_pair(scheme, o)
    a = u8(batch, h, w, groups * icpg)
    kw = dict(strides=(s, s), padding=pad)
    want = np.asarray(jconv.q8conv2d(jnp.asarray(a), jp, jr, **kw))
    got = q8conv_plain(torch.from_numpy(a), tp, tr, **kw)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tconv.q8conv2d(torch.from_numpy(a), tp, tr, **kw).numpy(), want)


@pytest.mark.parametrize("izp,kzp", [(128, 128), (121, 103)])
def test_grouped_q8conv_plain_matches_split_branch(izp, kzp):
    """28x28 at batch 40 with g = 2 takes the JAX package's split-GEMM
    branch (grouped_1x1_split_min_pixels = 784)."""
    groups, icpg, ocpg = 2, 8, 12
    kernel = u8(groups * ocpg, 1, 1, icpg)
    jp = jconv.pack_conv_weights(kernel, None, izp, kzp, groups)
    tp = tconv.pack_conv_weights(kernel, None, izp, kzp, groups)
    jr, tr = requant_pair("fp32", groups * ocpg)
    a = u8(40, 28, 28, groups * icpg)
    want = np.asarray(jconv.q8conv2d(jnp.asarray(a), jp, jr))
    np.testing.assert_array_equal(
        q8conv_plain(torch.from_numpy(a), tp, tr).numpy(), want)


def test_grouped_plain_is_the_dense_conv_of_each_group():
    """Each group's output channels are the dense conv of its own input
    channels with its own weights, bias and channel scales."""
    groups, icpg, ocpg = 3, 4, 5
    kernel = u8(groups * ocpg, 3, 3, icpg)
    bias = RNG.integers(-9000, 9000, groups * ocpg).astype(np.int32)
    scales = RNG.uniform(1e-4, 2e-3, groups * ocpg)
    a = torch.from_numpy(u8(2, 7, 7, groups * icpg))
    grouped = q8conv_plain(
        a, tconv.pack_conv_weights(kernel, bias, 121, 103, groups),
        tper_channel(scales, 117), padding=P1)
    for g in range(groups):
        cout = slice(g * ocpg, (g + 1) * ocpg)
        dense = q8conv_plain(
            a[..., g * icpg:(g + 1) * icpg].contiguous(),
            tconv.pack_conv_weights(kernel[cout], bias[cout], 121, 103),
            tper_channel(scales[cout], 117), padding=P1)
        assert torch.equal(grouped[..., cout], dense)


STEM_CASES = {
    # h, w, c, o, k, padding
    "7x7_pad23": (23, 22, 3, 8, 7, ((2, 3), (2, 3))),
    "3x3_pad01": (17, 18, 3, 24, 3, S2),
    "odd_c4": (15, 13, 4, 16, 3, P1),
    "c1": (15, 15, 1, 8, 3, P1),
}


@pytest.mark.parametrize("scheme", ["q31", "fp32", "per_channel"])
@pytest.mark.parametrize("case", list(STEM_CASES))
def test_q8stem_plain_matches_pallas_and_q8conv2d(case, scheme):
    h, w, c, o, k, pad = STEM_CASES[case]
    jp, tp = make_weights(o, k, k, c, 121, 128)
    jr, tr = requant_pair(scheme, o)
    a = u8(2, h, w, c)
    got = q8stem_plain(torch.from_numpy(a), tp, tr, pad).numpy()
    want = np.asarray(q8stem_pallas(jnp.asarray(a), jp, jr, padding=pad,
                                    interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jconv.q8conv2d(
        jnp.asarray(a), jp, jr, (2, 2), pad)))


@pytest.mark.parametrize("groups,c,kzp,what", [
    (1, 8, 128, "more than 4 input channels"),
    (1, 3, 103, "kernel zero point"),
    (2, 2, 128, "groups"),
])
def test_q8stem_contract_raises(groups, c, kzp, what):
    kernel = u8(4, 3, 3, c)
    packed = tconv.pack_conv_weights(kernel, None, 128, kzp, groups)
    a = torch.from_numpy(u8(1, 9, 9, c * groups))
    rp = tmake("fp32", 0.004, 128)
    for fn in (q8stem_plain, q8stem_cuda):
        with pytest.raises(ValueError):
            fn(a, packed, rp, S2)


ROUTES = {
    # o, k, cin, kzp, strides, dilation -> kernel
    "resnet_stem_7x7": ((64, 7, 3, 128, (2, 2), (1, 1)), "q8stem"),
    "mobilenet_stem_3x3": ((32, 3, 3, 128, (2, 2), (1, 1)), "q8stem"),
    "c4_stem": ((16, 3, 4, 128, (2, 2), (1, 1)), "q8stem"),
    "resnet_body_3x3_s1": ((64, 3, 64, 128, (1, 1), (1, 1)), "q8conv"),
    "resnet_body_3x3_s2": ((128, 3, 64, 128, (2, 2), (1, 1)), "q8conv"),
    "projection_1x1_s2": ((128, 1, 64, 128, (2, 2), (1, 1)), "q8conv"),
    "stem_kzp_not_128": ((32, 3, 3, 103, (2, 2), (1, 1)), "q8conv"),
    "stem_c5": ((32, 3, 5, 128, (2, 2), (1, 1)), "q8conv"),
    "stem_stride1": ((32, 3, 3, 128, (1, 1), (1, 1)), "q8conv"),
    "stem_dilated": ((32, 3, 3, 128, (2, 2), (2, 2)), "q8conv"),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_dense_conv_route(case):
    (o, k, cin, kzp, strides, dilation), kernel = ROUTES[case]
    packed = tconv.pack_conv_weights(u8(o, k, k, cin), None, 128, kzp)
    assert tconv.dense_conv_route(packed, strides, dilation) == kernel


@pytest.mark.parametrize("case", ["resnet_stem_7x7", "mobilenet_stem_3x3",
                                  "resnet_body_3x3_s1", "projection_1x1_s2",
                                  "stem_kzp_not_128"])
def test_q8conv2d_dispatches_by_route(case, monkeypatch):
    """q8conv2d sends a dense conv to the kernel its route names."""
    (o, k, cin, kzp, strides, dilation), kernel = ROUTES[case]
    packed = tconv.pack_conv_weights(u8(o, k, k, cin), None, 128, kzp)
    called = []
    for name in ("q8stem_cuda", "q8conv_cuda"):
        real = getattr(tconv, name)
        monkeypatch.setattr(
            tconv, name,
            lambda *a, real=real, name=name, **kw: called.append(name)
            or real(*a, **kw))
    pad = ((k // 2, k // 2), (k // 2, k // 2))
    tconv.q8conv2d(torch.from_numpy(u8(1, 9, 9, cin)), packed,
                   tmake("fp32", 0.004, 128), strides, pad, dilation)
    assert called == [kernel + "_cuda"]


def test_q8conv2d_sends_grouped_convs_to_q8conv(monkeypatch):
    """Grouped convs (more than one channel per group) run q8conv, also a
    strided 3x3 one from 3 channels a group that a dense conv would send to
    q8stem; depthwise ones run q8dwconv."""
    called = []
    for name in ("q8stem_cuda", "q8conv_cuda", "q8dwconv_cuda"):
        real = getattr(tconv, name)
        monkeypatch.setattr(
            tconv, name,
            lambda *a, real=real, name=name, **kw: called.append(name)
            or real(*a, **kw))
    rp = tmake("fp32", 0.004, 128)
    a = torch.from_numpy(u8(1, 9, 9, 6))
    for icpg, ocpg, strides in [(3, 4, (2, 2)), (2, 2, (1, 1)),
                                (1, 1, (1, 1))]:
        groups = 6 // icpg
        packed = tconv.pack_conv_weights(u8(groups * ocpg, 3, 3, icpg), None,
                                         128, 128, groups)
        tconv.q8conv2d(a, packed, rp, strides, P1)
    assert called == ["q8conv_cuda", "q8conv_cuda", "q8dwconv_cuda"]


def test_wrappers_on_cpu_run_plain_and_count_nothing():
    _, tp = make_weights(8, 3, 3, 3, 128, 128)
    _, tr = requant_pair("fp32", 8)
    a = torch.from_numpy(u8(1, 11, 11, 3))
    tkernels.reset_launch_counts()
    assert torch.equal(q8conv_cuda(a, tp, tr, (2, 2), S2),
                       q8conv_plain(a, tp, tr, (2, 2), S2))
    assert torch.equal(q8stem_cuda(a, tp, tr, S2), q8stem_plain(a, tp, tr, S2))
    assert q8conv_cuda.launches == 0 and q8stem_cuda.launches == 0


def test_q8conv_rejects_channel_mismatch_and_groups():
    _, tp = make_weights(8, 3, 3, 4, 128, 128)
    _, tr = requant_pair("fp32", 8)
    with pytest.raises(ValueError):
        q8conv_cuda(torch.from_numpy(u8(1, 6, 6, 5)), tp, tr)
    dw = tconv.pack_conv_weights(u8(4, 3, 3, 1), None, 128, 128, 4)
    with pytest.raises(ValueError):
        q8conv_cuda(torch.from_numpy(u8(1, 6, 6, 4)), dw, tr)


# The tensor-core conv kernel's form of the sum (csrc/q8conv.cu): the
# zero-point-padded gather (raw izp outside the image), channels past Icpg
# raw 0, times the K-major weights [O, Kh*Kw, Icpg_p], + c - kzp' sum A.

def conv_kmajor_acc(a, tp, strides, padding, dilation=(1, 1)):
    """int64 array of the wrapped int32 accumulators [B*Ho*Wo, O]."""
    icpg, ocpg = tp.group_input_channels, tp.group_output_channels
    wk = tp.w_kmajor.numpy().astype(np.int64)
    _, taps, icpg_p = wk.shape
    accs = []
    for g in range(tp.groups):
        cols, _ = tconv.im2col(a[..., g * icpg:(g + 1) * icpg], tp, strides,
                               padding, dilation)
        cols = cols.numpy().astype(np.int64).reshape(-1, taps, icpg)
        gathered = np.zeros((cols.shape[0], taps, icpg_p), np.int64)
        gathered[..., :icpg] = cols
        gathered = gathered.reshape(cols.shape[0], -1)
        rows = slice(g * ocpg, (g + 1) * ocpg)
        accs.append(gathered @ wk[rows].reshape(ocpg, -1).T
                    + tp.bias_c.numpy()[rows]
                    - tp.kzp_biased * gathered.sum(axis=-1, keepdims=True))
    acc = np.concatenate(accs, axis=-1)
    return ((acc + 2**31) & 0xFFFFFFFF) - 2**31


def plain_conv_acc(a, tp, strides, padding, dilation=(1, 1)):
    """The plain version's accumulators (q8conv_plain before requant)."""
    icpg, ocpg = tp.group_input_channels, tp.group_output_channels
    k = tp.kernel_height * tp.kernel_width * icpg
    accs = []
    for g in range(tp.groups):
        cols, _ = tconv.im2col(a[..., g * icpg:(g + 1) * icpg], tp, strides,
                               padding, dilation)
        cout = slice(g * ocpg, (g + 1) * ocpg)
        accs.append(gemm_acc_plain(cols, tp.w[..., cout].reshape(k, ocpg),
                                   tp.bias_folded[cout], tp.kzp_biased))
    return torch.cat(accs, dim=-1).numpy()


KMAJOR_CASES = {
    **{name: (h, w, 1, cin, cout, k, s, pad, d)
       for name, (h, w, cin, cout, k, s, pad, d) in CONV_CASES.items()},
    **{name: (h, w, g, icpg, ocpg, k, s, pad, 1)
       for name, (h, w, g, icpg, ocpg, k, s, pad) in GROUPED_CASES.items()},
}


def kmajor_pair(case, izp, kzp):
    h, w, g, icpg, ocpg, k, s, pad, d = KMAJOR_CASES[case]
    kernel = u8(g * ocpg, k, k, icpg)
    bias = RNG.integers(-20000, 20000, g * ocpg, dtype=np.int64).astype(
        np.int32)
    return (jconv.pack_conv_weights(kernel, bias, izp, kzp, g),
            tconv.pack_conv_weights(kernel, bias, izp, kzp, g))


@pytest.mark.parametrize("case", list(KMAJOR_CASES))
def test_conv_kmajor_weights_are_w_regrouped_and_padded(case):
    _, tp = kmajor_pair(case, 121, 103)
    kh, kw, icpg, o = tp.w.shape
    icpg_p = -(-icpg // 64) * 64
    assert tuple(tp.w_kmajor.shape) == (o, kh * kw, icpg_p)
    assert tp.w_kmajor.dtype == torch.int8 and tp.w_kmajor.is_contiguous()
    w = tp.w.numpy()
    for ky in range(kh):
        for kx in range(kw):
            np.testing.assert_array_equal(
                tp.w_kmajor[:, ky * kw + kx, :icpg].numpy(), w[ky, kx].T)
    assert not tp.w_kmajor[..., icpg:].any()
    want = (tp.bias_folded.numpy().astype(np.int64)
            - 128 * w.astype(np.int64).sum(axis=(0, 1, 2))
            + 128 * kh * kw * icpg * tp.kzp_biased)
    np.testing.assert_array_equal(tp.bias_c.numpy(),
                                  ((want + 2**31) & 0xFFFFFFFF) - 2**31)


@pytest.mark.parametrize("kzp", [128, 103, 0, 255])
@pytest.mark.parametrize("case", list(KMAJOR_CASES))
def test_conv_kmajor_sum_matches_q8conv2d(case, kzp):
    """izp 121: every padded tap gathers the raw zero point, which the
    folded c counts; channels past Icpg gather 0."""
    h, w, g, icpg, ocpg, k, s, pad, d = KMAJOR_CASES[case]
    jp, tp = kmajor_pair(case, 121, kzp)
    jr, tr = requant_pair("q31", g * ocpg)
    a = u8(2, h, w, g * icpg)
    kw = dict(strides=(s, s), padding=pad, dilation=(d, d))
    acc = conv_kmajor_acc(torch.from_numpy(a), tp, (s, s), pad, (d, d))
    np.testing.assert_array_equal(
        acc, plain_conv_acc(torch.from_numpy(a), tp, (s, s), pad, (d, d)))
    want = np.asarray(jconv.q8conv2d(jnp.asarray(a), jp, jr, **kw))
    got = apply_requant(torch.from_numpy(acc), tr).numpy()
    np.testing.assert_array_equal(got.reshape(want.shape), want)


# The stem kernel's K order (csrc/q8stem.cu): kernel row ky's Kw*C window
# bytes at ky*Rs, zero up to Rs = Kw*C rounded up to 32, times the record's
# w_stem [O, Kh*Rs], + c.  kzp' = 0, so there is no row sum.

def stem_field_acc(a, tp, padding):
    """int64 array of the stem kernel's wrapped accumulators [B*Ho*Wo, O]:
    the im2col rows scattered into the field's padded K order."""
    kh, kw, c = tp.kernel_height, tp.kernel_width, tp.group_input_channels
    o, k = tp.w_stem.shape
    rs = k // kh
    cols, _ = tconv.im2col(a, tp, (2, 2), padding)
    rows = np.zeros((cols.shape[0], kh, rs), np.int64)
    rows[..., :kw * c] = cols.numpy().astype(np.int64).reshape(-1, kh, kw * c)
    acc = (rows.reshape(-1, k) @ tp.w_stem.numpy().astype(np.int64).T
           + tp.bias_c.numpy())
    return ((acc + 2**31) & 0xFFFFFFFF) - 2**31


STEM_FIELD_CASES = {
    # h, w, c, o, k, padding
    **STEM_CASES,
    "resnet_7x7_c3": (19, 21, 3, 64, 7, ((2, 3), (2, 3))),
    "c2_5x5": (13, 12, 2, 40, 5, ((2, 2), (2, 2))),
    "c4_9x9_rows_of_36": (21, 19, 4, 16, 9, ((4, 4), (4, 4))),
}


@pytest.mark.parametrize("case", list(STEM_FIELD_CASES))
def test_stem_field_is_w_by_kernel_row_padded(case):
    _, _, c, o, k, _ = STEM_FIELD_CASES[case]
    _, tp = make_weights(o, k, k, c, 121, 128)
    rs = -(-k * c // 32) * 32
    assert tp.w_stem.dtype == torch.int8 and tp.w_stem.is_contiguous()
    assert tuple(tp.w_stem.shape) == (o, k * rs)
    field = tp.w_stem.numpy().reshape(o, k, rs)
    np.testing.assert_array_equal(
        field[..., :k * c],
        tp.w.numpy().transpose(3, 0, 1, 2).reshape(o, k, k * c))
    assert not field[..., k * c:].any()
    assert tp.w_dw is None


@pytest.mark.parametrize("groups,c", [(2, 3), (1, 5), (1, 64)])
def test_stem_field_only_on_records_that_can_be_stems(groups, c):
    tp = tconv.pack_conv_weights(u8(4 * groups, 3, 3, c), None, 128, 128,
                                 groups)
    assert tp.w_stem is None


@pytest.mark.parametrize("izp", [128, 121, 0, 255])
@pytest.mark.parametrize("case", list(STEM_FIELD_CASES))
def test_stem_field_sum_matches_q8stem_plain(case, izp):
    """im2col(A) in the field's K order times the field, + bias_c, is the
    plain version's accumulator; requantized, it is q8stem_pallas's output
    (interpret mode)."""
    h, w, c, o, k, pad = STEM_FIELD_CASES[case]
    jp, tp = make_weights(o, k, k, c, izp, 128)
    jr, tr = requant_pair("q31" if izp % 2 else "per_channel", o)
    a = u8(2, h, w, c)
    acc = stem_field_acc(torch.from_numpy(a), tp, pad)
    np.testing.assert_array_equal(
        acc, plain_conv_acc(torch.from_numpy(a), tp, (2, 2), pad))
    want = np.asarray(q8stem_pallas(jnp.asarray(a), jp, jr, padding=pad,
                                    interpret=True))
    got = apply_requant(torch.from_numpy(acc), tr).numpy()
    np.testing.assert_array_equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("case", ["7x7_pad23", "3x3_pad01", "odd_c4"])
def test_stem_field_on_records_from_params_from_jax(case):
    """A record made from the JAX package's packed record (the path of
    params_from_jax) derives the same stem field and bias_c."""
    from qnnpack_tpu_torch.models import graph as tgraph
    _, _, c, o, k, _ = STEM_CASES[case]
    kernel = u8(o, k, k, c)
    bias = RNG.integers(-20000, 20000, o, dtype=np.int64).astype(np.int32)
    jp = jconv.pack_conv_weights(kernel, bias, tgraph.ACT_ZP,
                                 tgraph.KERNEL_ZP)
    own = tconv.pack_conv_weights(kernel, bias, tgraph.ACT_ZP,
                                  tgraph.KERNEL_ZP)
    got = tgraph.packed_from_jax(
        "stem", {"w": np.asarray(jp.w), "bias_folded":
                 np.asarray(jp.bias_folded)}, kernel, gemm=False, groups=1,
        device="cpu")
    assert got.w_stem is not None
    assert torch.equal(got.w_stem, own.w_stem)
    assert torch.equal(got.bias_c, own.bias_c)


@pytest.mark.parametrize("o,want", [(8, 32), (24, 32), (32, 32), (33, 64),
                                    (64, 64), (100, 64)])
def test_stem_tile_by_output_channels(o, want):
    assert stem_tile(o) == want
