"""Parity of the port's convolution with the JAX package: conv weight
packing, the depthwise branch (the q8dwconv kernel's plain version) against
nn.conv.q8conv2d and q8dwconv_pallas in interpret mode, and the dense
branch (the q8stem and q8conv kernels' plain versions, a zero-point-padded
im2col times the packed weights) against nn.conv.q8conv2d.
Inputs come from a numpy seed; comparisons are exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qnnpack_tpu.kernels.q8dwconv import q8dwconv_pallas
from qnnpack_tpu.nn import conv as jconv
from qnnpack_tpu.nn.requant_dispatch import make_requant_params as jmake
from qnnpack_tpu.quant.params import \
    compute_per_channel_fp32_params as jper_channel
from qnnpack_tpu_torch import kernels as tkernels
from qnnpack_tpu_torch.kernels.q8dwconv import (dw_instance,
                                                q8dwconv_acc_plain,
                                                q8dwconv_cuda, q8dwconv_plain)
from qnnpack_tpu_torch.nn import conv as tconv
from qnnpack_tpu_torch.nn.requant_dispatch import apply_requant
from qnnpack_tpu_torch.nn.requant_dispatch import make_requant_params as tmake
from qnnpack_tpu_torch.quant.params import \
    compute_per_channel_fp32_params as tper_channel

RNG = np.random.default_rng(0xD3C0)


def u8(*shape):
    return RNG.integers(0, 256, shape, dtype=np.int64).astype(np.uint8)


def make_weights(o, kh, kw, icpg, izp, kzp, groups):
    kernel = u8(o, kh, kw, icpg)
    bias = RNG.integers(-20000, 20000, o, dtype=np.int64).astype(np.int32)
    return (jconv.pack_conv_weights(kernel, bias, izp, kzp, groups),
            tconv.pack_conv_weights(kernel, bias, izp, kzp, groups))


def requant_pair(scheme, n):
    if scheme == "per_channel":
        scales = RNG.uniform(1e-3, 2e-2, n)
        return jper_channel(scales, 117), tper_channel(scales, 117)
    return jmake(scheme, 0.0037, 117), tmake(scheme, 0.0037, 117)


@pytest.mark.parametrize("groups,icpg,o", [(1, 3, 8), (6, 1, 6), (1, 5, 1)])
@pytest.mark.parametrize("izp,kzp", [(128, 128), (121, 103)])
def test_pack_conv_weights_matches_jax(groups, icpg, o, izp, kzp):
    jp, tp = make_weights(o, 3, 2, icpg, izp, kzp, groups)
    np.testing.assert_array_equal(tp.w.numpy(), np.asarray(jp.w))
    np.testing.assert_array_equal(tp.bias_folded.numpy(),
                                  np.asarray(jp.bias_folded))
    for f in ("kernel_height", "kernel_width", "group_input_channels",
              "group_output_channels", "groups", "izp_biased", "kzp_biased"):
        assert getattr(tp, f) == getattr(jp, f), f


DW_CASES = [
    # h, w, c, stride, dilation, padding
    (13, 11, 24, 1, 1, ((1, 1), (1, 1))),
    (14, 14, 32, 2, 1, ((0, 1), (0, 1))),   # MobileNetV2 stride-2 padding
    (15, 9, 8, 2, 1, ((1, 1), (1, 1))),
    (12, 10, 16, 2, 2, ((2, 2), (2, 2))),
    (7, 7, 160, 1, 1, ((1, 1), (1, 1))),
    (6, 5, 3, 1, 1, ((0, 0), (0, 0))),
]


@pytest.mark.parametrize("scheme", ["q31", "fp32", "precise", "gemmlowp",
                                    "per_channel"])
@pytest.mark.parametrize("case", DW_CASES, ids=[str(c[:5]) for c in DW_CASES])
@pytest.mark.parametrize("izp,kzp", [(128, 128), (121, 103)])
def test_depthwise_matches_jax(case, scheme, izp, kzp):
    h, w, c, s, d, pad = case
    jp, tp = make_weights(c, 3, 3, 1, izp, kzp, c)
    jr, tr = requant_pair(scheme, c)
    a = u8(2, h, w, c)
    kw = dict(strides=(s, s), padding=pad, dilation=(d, d))
    want = np.asarray(jconv.q8conv2d(jnp.asarray(a), jp, jr, **kw))
    got = tconv.q8conv2d(torch.from_numpy(a), tp, tr, **kw)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("scheme", ["q31", "fp32", "per_channel"])
@pytest.mark.parametrize("case", DW_CASES[:4], ids=[str(c[:5])
                                                    for c in DW_CASES[:4]])
def test_plain_kernel_matches_pallas_dwconv(case, scheme):
    h, w, c, s, d, pad = case
    jp, tp = make_weights(c, 3, 3, 1, 121, 103, c)
    jr, tr = requant_pair(scheme, c)
    a = u8(1, h, w, c)
    kw = dict(strides=(s, s), padding=pad, dilation=(d, d))
    want = np.asarray(q8dwconv_pallas(jnp.asarray(a), jp, jr, tile_h=4,
                                      interpret=True, **kw))
    np.testing.assert_array_equal(
        q8dwconv_plain(torch.from_numpy(a), tp, tr, **kw).numpy(), want)


def test_depthwise_5x5_matches_jax():
    jp, tp = make_weights(8, 5, 5, 1, 121, 103, 8)
    jr, tr = requant_pair("q31", 8)
    a = u8(1, 9, 9, 8)
    kw = dict(strides=(1, 1), padding=((2, 2), (2, 2)))
    np.testing.assert_array_equal(
        tconv.q8conv2d(torch.from_numpy(a), tp, tr, **kw).numpy(),
        np.asarray(jconv.q8conv2d(jnp.asarray(a), jp, jr, **kw)))


DENSE_CASES = [
    # h, w, cin, cout, k, stride, padding
    (17, 17, 3, 8, 3, 2, ((0, 1), (0, 1))),  # the MobileNetV2 stem
    (16, 16, 3, 32, 3, 2, ((0, 1), (0, 1))),
    (9, 7, 5, 6, 3, 1, ((1, 1), (1, 1))),
    (11, 11, 4, 9, 5, 2, ((2, 2), (2, 2))),
    (6, 6, 7, 5, 1, 1, ((0, 0), (0, 0))),
]


@pytest.mark.parametrize("scheme", ["q31", "fp32", "gemmlowp", "per_channel"])
@pytest.mark.parametrize("case", DENSE_CASES,
                         ids=[str(c[:5]) for c in DENSE_CASES])
@pytest.mark.parametrize("izp,kzp", [(128, 128), (121, 103)])
def test_dense_conv_matches_jax(case, scheme, izp, kzp):
    h, w, cin, cout, k, s, pad = case
    jp, tp = make_weights(cout, k, k, cin, izp, kzp, 1)
    jr, tr = requant_pair(scheme, cout)
    a = u8(2, h, w, cin)
    kw = dict(strides=(s, s), padding=pad)
    want = np.asarray(jconv.q8conv2d(jnp.asarray(a), jp, jr, **kw))
    got = tconv.q8conv2d(torch.from_numpy(a), tp, tr, **kw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dense_conv_dilation_matches_jax():
    jp, tp = make_weights(4, 3, 3, 3, 121, 103, 1)
    jr, tr = requant_pair("q31", 4)
    a = u8(1, 10, 9, 3)
    kw = dict(strides=(1, 2), padding=((2, 2), (1, 2)), dilation=(2, 1))
    np.testing.assert_array_equal(
        tconv.q8conv2d(torch.from_numpy(a), tp, tr, **kw).numpy(),
        np.asarray(jconv.q8conv2d(jnp.asarray(a), jp, jr, **kw)))


def test_im2col_orders_k_as_the_pack():
    _, tp = make_weights(4, 3, 3, 2, 100, 128, 1)
    a = torch.from_numpy(u8(1, 4, 4, 2))
    cols, (b, ho, wo) = tconv.im2col(a, tp, (1, 1), ((1, 1), (1, 1)))
    assert (b, ho, wo) == (1, 4, 4) and tuple(cols.shape) == (16, 18)
    # Output pixel (0, 0): tap (ky, kx) reads input (ky - 1, kx - 1).
    want = []
    for ky in range(3):
        for kx in range(3):
            y, x = ky - 1, kx - 1
            pix = a[0, y, x] if 0 <= y < 4 and 0 <= x < 4 else \
                torch.full((2,), 100, dtype=torch.uint8)
            want.append(pix)
    assert torch.equal(cols[0], torch.cat(want))


def test_wrapper_on_cpu_counts_nothing():
    _, tp = make_weights(8, 3, 3, 1, 128, 128, 8)
    _, tr = requant_pair("fp32", 8)
    a = torch.from_numpy(u8(1, 6, 6, 8))
    tkernels.reset_launch_counts()
    kw = dict(strides=(2, 2), padding=((0, 1), (0, 1)))
    assert torch.equal(q8dwconv_cuda(a, tp, tr, **kw),
                       q8dwconv_plain(a, tp, tr, **kw))
    assert q8dwconv_cuda.launches == 0


def test_depthwise_rejects_channel_mismatch():
    _, tp = make_weights(8, 3, 3, 1, 128, 128, 8)
    _, tr = requant_pair("fp32", 8)
    with pytest.raises(ValueError):
        q8dwconv_cuda(torch.from_numpy(u8(1, 6, 6, 7)), tp, tr)


# The q8dwconv kernel's form of the sum (csrc/q8dwconv.cu): the raw uint8
# input, padded with the raw input zero point, times wd = W' - kzp' (the
# record's float table w_dw), accumulated in float32 for a 3 x 3 window and
# in int32 for any other, plus bias_c.

def dw_kernel_acc(a, tp, strides, padding, dilation):
    """int64 array of the kernel's wrapped int32 accumulators [B, Ho, Wo, C],
    in the kernel's arithmetic."""
    (pt, pb), (pl_, pr) = padding
    a = np.pad(a, ((0, 0), (pt, pb), (pl_, pr), (0, 0)),
               constant_values=tp.input_zero_point)
    kh, kw = tp.kernel_height, tp.kernel_width
    (sh, sw), (dh, dw) = strides, dilation
    ho = (a.shape[1] - ((kh - 1) * dh + 1)) // sh + 1
    wo = (a.shape[2] - ((kw - 1) * dw + 1)) // sw + 1
    wd = tp.w_dw.numpy()
    fast = (kh, kw) == (3, 3) and (dh, dw) == (1, 1)
    acc = np.zeros((a.shape[0], ho, wo, a.shape[3]),
                   np.float32 if fast else np.int64)
    for ky in range(kh):
        for kx in range(kw):
            tap = a[:, ky * dh:ky * dh + (ho - 1) * sh + 1:sh,
                    kx * dw:kx * dw + (wo - 1) * sw + 1:sw, :]
            w = wd[ky * kw + kx]
            acc = (acc + tap.astype(np.float32) * w if fast
                   else acc + tap.astype(np.int64) * w.astype(np.int64))
    acc = acc.astype(np.int64) + tp.bias_c.numpy().astype(np.int64)
    return ((acc + 2**31) & 0xFFFFFFFF) - 2**31


@pytest.mark.parametrize("izp,kzp", [(128, 128), (121, 103), (7, 0),
                                     (250, 255)])
def test_depthwise_weight_table_is_w_less_kzp(izp, kzp):
    _, tp = make_weights(12, 3, 5, 1, izp, kzp, 12)
    assert tp.w_dw.dtype == torch.float32 and tp.w_dw.is_contiguous()
    assert tuple(tp.w_dw.shape) == (15, 12)
    np.testing.assert_array_equal(
        tp.w_dw.numpy(),
        tp.w.numpy().reshape(15, 12).astype(np.float32) - tp.kzp_biased)
    want = (tp.bias_folded.numpy().astype(np.int64)
            - 128 * tp.w_dw.numpy().astype(np.int64).sum(axis=0))
    np.testing.assert_array_equal(tp.bias_c.numpy(),
                                  ((want + 2**31) & 0xFFFFFFFF) - 2**31)
    assert tp.w_stem is None


@pytest.mark.parametrize("groups,icpg,ocpg,held", [
    (1, 3, 8, False), (3, 2, 4, False), (4, 1, 2, False),
    (1, 1, 1, True),   # one channel, groups 1: still a depthwise record
    (5, 1, 1, True)])
def test_only_depthwise_records_hold_the_weight_table(groups, icpg, ocpg,
                                                      held):
    """The table is there exactly where q8dwconv's contract holds."""
    kernel = u8(groups * ocpg, 3, 3, icpg)
    tp = tconv.pack_conv_weights(kernel, None, 128, 128, groups)
    assert (tp.w_dw is not None) == held
    a = torch.from_numpy(u8(1, 5, 5, groups * icpg))
    if held:
        assert tuple(tp.w_dw.shape) == (9, groups)
        q8dwconv_acc_plain(a, tp)
    else:
        with pytest.raises(ValueError):
            q8dwconv_acc_plain(a, tp)


DW_KERNEL_CASES = DW_CASES + [
    # h, w, c, stride, dilation, padding; then the kernel size
    (7, 6, 1, 1, 1, ((1, 1), (1, 1))),      # one channel, groups 1
    (11, 13, 33, 1, 1, ((1, 1), (1, 1))),   # Wo = 13, one channel a thread
    (9, 14, 60, 2, 1, ((0, 1), (0, 1))),    # ShuffleNet's width
]


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("case", DW_KERNEL_CASES,
                         ids=[str(c[:5]) for c in DW_KERNEL_CASES])
@pytest.mark.parametrize("izp,kzp", [(128, 128), (121, 103), (3, 200)])
def test_depthwise_raw_input_identity(case, k, izp, kzp):
    """sum A (W' - kzp') + bias_c over the raw input, padded with the raw
    zero point, is the plain version's accumulator."""
    h, w, c, s, d, pad = case
    if k == 5:
        pad = ((2, 2), (2, 2))
    _, tp = make_weights(c, k, k, 1, izp, kzp, c)
    a = u8(2, h, w, c)
    kw = dict(strides=(s, s), padding=pad, dilation=(d, d))
    np.testing.assert_array_equal(
        dw_kernel_acc(a, tp, (s, s), pad, (d, d)),
        q8dwconv_acc_plain(torch.from_numpy(a), tp, **kw).numpy())


@pytest.mark.parametrize("scheme", ["q31", "fp32", "precise", "gemmlowp",
                                    "per_channel"])
@pytest.mark.parametrize("case", DW_KERNEL_CASES[:2] + DW_KERNEL_CASES[-2:],
                         ids=[str(c[:5]) for c in DW_KERNEL_CASES[:2]
                              + DW_KERNEL_CASES[-2:]])
def test_depthwise_kernel_sum_matches_pallas(case, scheme):
    """The kernel's arithmetic, requantized, against q8dwconv_pallas in
    interpret mode, kzp != 128 and izp != 128."""
    h, w, c, s, d, pad = case
    jp, tp = make_weights(c, 3, 3, 1, 121, 90, c)
    jr, tr = requant_pair(scheme, c)
    a = u8(1, h, w, c)
    kw = dict(strides=(s, s), padding=pad, dilation=(d, d))
    want = np.asarray(q8dwconv_pallas(jnp.asarray(a), jp, jr, tile_h=4,
                                      interpret=True, **kw))
    acc = dw_kernel_acc(a, tp, (s, s), pad, (d, d))
    np.testing.assert_array_equal(
        apply_requant(torch.from_numpy(acc), tr).numpy(), want)


@pytest.mark.parametrize("c,kh,kw,strides,dilation,want", [
    (96, 3, 3, (2, 2), (1, 1), (4, "3x3s2")),
    (960, 3, 3, (1, 1), (1, 1), (4, "3x3s1")),
    (60, 3, 3, (1, 1), (1, 1), (4, "3x3s1")),
    (33, 3, 3, (2, 2), (1, 1), (1, "3x3s2")),
    (33, 3, 3, (1, 1), (1, 1), (1, "3x3s1")),
    (16, 3, 3, (2, 2), (2, 2), (4, "any")),
    (8, 5, 5, (1, 1), (1, 1), (4, "any")),
    (12, 3, 3, (1, 2), (1, 1), (4, "any")),
    (12, 3, 3, (3, 3), (1, 1), (4, "any")),
])
def test_dw_instance_choice(c, kh, kw, strides, dilation, want):
    """The instance the wrapper names to csrc/q8dwconv.cu's entry."""
    assert dw_instance(c, kh, kw, strides, dilation) == want
    assert dw_instance(c, kh, kw, strides, dilation,
                       aligned=False) == (1, want[1])
