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
from qnnpack_tpu_torch.kernels.q8dwconv import q8dwconv_cuda, q8dwconv_plain
from qnnpack_tpu_torch.nn import conv as tconv
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
