"""The port's lifecycle API (ops) against the JAX package's qnnpack_tpu.ops.

- each operator gives the JAX operator's bytes on the same inputs (the
  plain versions of the kernels on the CPU, x8lut and x8zip) and launches
  no kernel: the elementwise operators; Convolution2D at each kernel type
  (1x1 gemm, depthwise, dense 3x3 with dilation 2, grouped, the stem at
  kzp = 128 and the same shape at kzp != 128), every requant scheme and
  per-channel; FullyConnected at odd K and N under every `use_pallas`;
  MaxPooling2D with and without a range; AveragePooling2D at 3x3 stride 2
  padded and at 17x17 (32-bit sums); GlobalAveragePooling at widths 1, 49,
  257, 258 and 1,000; and Convolution2D.output_shape;
- each rejection of tests/test_ops.py (and of the shared checks of scale,
  zero point and range) raises the same exception type with the same
  message and status code;
- Deconvolution2D at each lowering (k == s with and without groups, the
  phases with padding and adjustment, k < s, a depthwise deconv, stride 1,
  dilation 2, stride 2 with dilation 2), zero points (121, 103) and
  (128, 128), every requant scheme: the JAX operator's bytes and output
  shape; its create rejections, and the padding its dilated lowering
  refuses at the first run;
- create takes a device, the GPU by default (tests/test_torch_port_rules
  .py checks that it raises without one); a deleted operator refuses to
  run.
Comparisons are exact."""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qnnpack_tpu import ops as jops
from qnnpack_tpu_torch import kernels as tkernels
from qnnpack_tpu_torch import ops as tops
from qnnpack_tpu_torch import status as tstatus
from qnnpack_tpu_torch.nn.conv import dense_conv_route

RNG = np.random.default_rng(0x0B5)
# The weights of the conv and FC cases, made once at import.
WEIGHTS = np.random.default_rng(0x0B6)


def u8(*shape):
    return RNG.integers(0, 256, shape, dtype=np.int64).astype(np.uint8)


def conv(o, kh, kw, icpg, *, izp=121, kzp=103, ozp=117, requant=None,
         per_channel=False, **kw_):
    """Convolution2D create kwargs with random weights and bias and an
    output scale that spreads the accumulator over the uint8 range."""
    k = kh * kw * icpg
    conv_scale = 0.0116 / math.sqrt(k)
    out = dict(kernel=WEIGHTS.integers(0, 256, (o, kh, kw, icpg),
                                       dtype=np.int64).astype(np.uint8),
               bias=WEIGHTS.integers(-5000, 5000, (o,),
                                     dtype=np.int64).astype(np.int32),
               input_zero_point=izp, input_scale=0.9, kernel_zero_point=kzp,
               kernel_scale=1.1, output_zero_point=ozp,
               output_scale=0.9 * 1.1 / conv_scale, **kw_)
    if requant is not None:
        out["requant"] = requant
    if per_channel:
        out["per_channel_requant"] = [
            float(s) for s in WEIGHTS.uniform(0.5, 2.0, o) * 1.1]
    return out


def fc(n, k, *, requant=None, **kw_):
    out = dict(kernel=WEIGHTS.integers(0, 256, (n, k),
                                       dtype=np.int64).astype(np.uint8),
               bias=WEIGHTS.integers(-5000, 5000, (n,),
                                     dtype=np.int64).astype(np.int32),
               input_zero_point=121, input_scale=0.9, kernel_zero_point=103,
               kernel_scale=1.1, output_zero_point=100,
               output_scale=0.9 * 1.1 * math.sqrt(k) / 0.0116, **kw_)
    if requant is not None:
        out["requant"] = requant
    return out


# The quantization of the pools' cases.
AVG = dict(input_zero_point=121, input_scale=0.7, output_zero_point=77,
           output_scale=0.5)
P1 = ((1, 1), (1, 1))
SCHEMES = ("q31", "fp32", "precise", "gemmlowp")


ADD = dict(a_zero_point=10, a_scale=0.25, b_zero_point=200, b_scale=0.75,
           sum_zero_point=128, sum_scale=0.5)

# (operator, create kwargs, input shapes)
CASES = [
    ("Add", ADD, [(3, 100), (3, 100)]),
    ("Add", dict(ADD, output_min=20, output_max=240), [(2, 7, 5), (2, 7, 5)]),
    ("Clamp", dict(output_min=20, output_max=200), [(1, 256)]),
    ("Clamp", dict(output_min=0, output_max=255), [(4, 3, 33)]),
    ("Sigmoid", dict(input_zero_point=121, input_scale=0.25), [(2, 333)]),
    ("Sigmoid", dict(input_zero_point=0, input_scale=0.05, output_min=10,
                     output_max=240), [(3, 17)]),
    ("LeakyReLU", dict(negative_slope=0.01, input_zero_point=121,
                       input_scale=0.25, output_zero_point=100,
                       output_scale=0.5), [(2, 64)]),
    ("SoftArgMax", dict(channels=100, input_scale=0.1), [(4, 100)]),
    ("SoftArgMax", dict(channels=128, input_scale=0.5), [(2, 3, 128)]),
    ("SoftArgMax", dict(channels=7, input_scale=1.0), [(5, 7)]),
    ("ChannelShuffle", dict(groups=4, group_channels=8), [(2, 32)]),
    ("ChannelShuffle", dict(groups=3, group_channels=5), [(2, 3, 15)]),
    # Convolution2D: each kernel type under every scheme and per-channel
    *[("Convolution2D", conv(24, 1, 1, 16, requant=r), [(2, 7, 7, 16)])
      for r in SCHEMES],
    ("Convolution2D", conv(24, 1, 1, 16, per_channel=True), [(2, 7, 7, 16)]),
    *[("Convolution2D", conv(16, 3, 3, 1, groups=16, strides=(2, 2),
                             padding=P1, requant=r), [(2, 9, 9, 16)])
      for r in SCHEMES],
    ("Convolution2D", conv(16, 3, 3, 1, groups=16, padding=P1,
                           per_channel=True, output_min=20,
                           output_max=240), [(2, 9, 8, 16)]),
    *[("Convolution2D", conv(12, 3, 3, 8, dilation=(2, 2),
                             padding=((2, 2), (2, 2)), requant=r),
       [(2, 11, 10, 8)]) for r in SCHEMES],
    ("Convolution2D", conv(12, 3, 3, 8, dilation=(2, 2), per_channel=True),
     [(2, 11, 10, 8)]),
    *[("Convolution2D", conv(24, 3, 3, 4, groups=3, padding=P1, requant=r),
       [(2, 6, 6, 12)]) for r in SCHEMES],
    ("Convolution2D", conv(24, 3, 3, 4, groups=3, per_channel=True),
     [(2, 6, 6, 12)]),
    # the stem class: at kzp 128 q8stem, at kzp 103 q8conv
    *[("Convolution2D", conv(8, 3, 3, 3, kzp=kzp, strides=(2, 2),
                             padding=((0, 1), (0, 1)), requant=r),
       [(2, 15, 15, 3)]) for kzp in (128, 103) for r in ("q31", "fp32")],
    ("Convolution2D", conv(8, 7, 7, 3, kzp=128, strides=(2, 2),
                           padding=((3, 3), (3, 3)), per_channel=True),
     [(1, 16, 16, 3)]),
    ("Convolution2D", conv(5, 3, 2, 7, izp=0, kzp=255, ozp=0, strides=(1, 2),
                           padding=((1, 0), (0, 1)), requant="precise"),
     [(3, 5, 9, 7)]),
    # FullyConnected at odd K and N (tile edges), every use_pallas
    *[("FullyConnected", fc(37, 101, use_pallas=u), [(3, 101)])
      for u in (None, True, False)],
    *[("FullyConnected", fc(65, 77, requant=r), [(5, 77)])
      for r in SCHEMES],
    ("FullyConnected", fc(1, 1, output_min=30, output_max=200), [(4, 1)]),
    ("FullyConnected", fc(129, 33, requant="fp32"), [(2, 3, 33)]),
    # MaxPooling2D with and without a range
    ("MaxPooling2D", dict(pool_size=(3, 3), strides=(2, 2), padding=P1),
     [(2, 9, 9, 8)]),
    ("MaxPooling2D", dict(pool_size=(3, 3), strides=(2, 2), padding=P1,
                          output_min=20, output_max=250), [(2, 9, 9, 8)]),
    ("MaxPooling2D", dict(pool_size=(2, 2)), [(2, 8, 10, 5)]),
    ("MaxPooling2D", dict(pool_size=(3, 2), strides=(1, 2),
                          padding=((2, 1), (0, 2)), dilation=(2, 1),
                          output_min=0, output_max=100), [(3, 12, 9, 3)]),
    # AveragePooling2D at 3x3 stride 2 padded, at 17x17 (289 taps: 32-bit
    # sums), default strides, a range
    ("AveragePooling2D", dict(AVG, pool_size=(3, 3), strides=(2, 2),
                              padding=P1), [(2, 9, 9, 8)]),
    ("AveragePooling2D", dict(AVG, pool_size=(17, 17), strides=(1, 1)),
     [(2, 18, 19, 4)]),
    ("AveragePooling2D", dict(AVG, pool_size=(17, 17), strides=(2, 2),
                              padding=P1, output_min=10, output_max=240),
     [(1, 20, 21, 5)]),
    ("AveragePooling2D", dict(AVG, pool_size=(2, 2)), [(2, 8, 6, 12)]),
    # GlobalAveragePooling at widths 1, 49, 257 (16-bit halves exactly
    # full), 258 and 1,000 (32-bit sums)
    *[("GlobalAveragePooling", dict(AVG, channels=c), [(2, width, c)])
      for width, c in ((1, 16), (49, 40), (257, 24), (258, 5), (1000, 17))],
    ("GlobalAveragePooling", dict(AVG, channels=8, output_min=50,
                                  output_max=200), [(3, 49, 8)]),
]


@pytest.mark.parametrize("name,kwargs,shapes", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_operator_matches_jax(name, kwargs, shapes):
    inputs = [u8(*s) for s in shapes]
    jop = getattr(jops, name)(**kwargs)
    want = np.asarray(jop(*[jnp.asarray(x) for x in inputs]))
    top = getattr(tops, name)(**kwargs, device="cpu")
    assert top.device == torch.device("cpu")
    tkernels.reset_launch_counts()
    got = top(*[torch.from_numpy(x) for x in inputs])
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(tkernels.launch_counts().values()) == {0}


def test_lut_operators_keep_the_jax_tables():
    sig = dict(input_zero_point=121, input_scale=0.25)
    np.testing.assert_array_equal(
        tops.Sigmoid(**sig, device="cpu").lut.numpy(),
        np.asarray(jops.Sigmoid(**sig).lut))
    sm = dict(channels=100, input_scale=0.1)
    np.testing.assert_array_equal(
        tops.SoftArgMax(**sm, device="cpu").lut.numpy().view(np.uint32),
        np.asarray(jops.SoftArgMax(**sm).lut))


# (operator, create kwargs) that both packages reject.
REJECTED = [
    ("Add", dict(ADD, a_scale=1e-6, b_scale=1.0, sum_scale=1.0)),
    ("Add", dict(ADD, a_scale=1000.0, sum_scale=1.0)),
    ("Add", dict(ADD, a_scale=-1.0)),
    ("Add", dict(ADD, b_scale=float("inf"))),
    ("Add", dict(ADD, sum_zero_point=256)),
    ("Add", dict(ADD, output_min=200, output_max=100)),
    ("Clamp", dict(output_min=-1, output_max=200)),
    ("Clamp", dict(output_min=100, output_max=99)),
    ("Sigmoid", dict(input_zero_point=0, input_scale=0.5, output_scale=0.5)),
    ("Sigmoid", dict(input_zero_point=0, input_scale=0.5,
                     output_zero_point=3)),
    ("Sigmoid", dict(input_zero_point=300, input_scale=0.5)),
    ("Sigmoid", dict(input_zero_point=0, input_scale=0.0)),
    ("LeakyReLU", dict(negative_slope=1.5, input_zero_point=0,
                       input_scale=0.5, output_zero_point=0,
                       output_scale=0.5)),
    ("LeakyReLU", dict(negative_slope=-0.1, input_zero_point=0,
                       input_scale=0.5, output_zero_point=0,
                       output_scale=0.5)),
    ("LeakyReLU", dict(negative_slope=0.1, input_zero_point=0,
                       input_scale=100.0, output_zero_point=0,
                       output_scale=0.1)),
    ("LeakyReLU", dict(negative_slope=0.1, input_zero_point=0,
                       input_scale=0.5, output_zero_point=-2,
                       output_scale=0.5)),
    ("SoftArgMax", dict(channels=0, input_scale=0.1)),
    ("SoftArgMax", dict(channels=10, input_scale=float("nan"))),
    ("SoftArgMax", dict(channels=10, input_scale=0.1, output_scale=0.5)),
    ("SoftArgMax", dict(channels=10, input_scale=0.1, output_zero_point=1)),
    ("ChannelShuffle", dict(groups=1, group_channels=8)),
    ("ChannelShuffle", dict(groups=2, group_channels=0)),
    ("Convolution2D", conv(8, 3, 3, 4, groups=3)),
    ("Convolution2D", dict(conv(8, 3, 3, 4), kernel=np.zeros((8, 0, 3, 4),
                                                             np.uint8))),
    ("Convolution2D", conv(8, 3, 3, 4, strides=(1, 0))),
    ("Convolution2D", conv(8, 3, 3, 4, dilation=(0, 1))),
    ("Convolution2D", dict(conv(8, 3, 3, 4), input_scale=2.0,
                           kernel_scale=2.0, output_scale=1.0)),
    ("Convolution2D", dict(conv(8, 3, 3, 4), kernel_scale=float("nan"))),
    ("Convolution2D", conv(8, 3, 3, 4, izp=300)),
    ("Convolution2D", conv(8, 3, 3, 4, kzp=-1)),
    ("Convolution2D", conv(8, 3, 3, 4, output_min=9, output_max=3)),
    ("Convolution2D", dict(conv(8, 3, 3, 4),
                           per_channel_requant=[1.0] * 7)),
    ("Convolution2D", dict(conv(8, 3, 3, 4), output_scale=1.0,
                           per_channel_requant=[0.5] * 7 + [2.0])),
    ("FullyConnected", dict(fc(8, 4), kernel=np.zeros((2, 4, 4), np.uint8))),
    ("FullyConnected", dict(fc(8, 4), input_scale=2.0, kernel_scale=2.0,
                            output_scale=1.0)),
    ("FullyConnected", dict(fc(8, 4), output_scale=-1.0)),
    ("FullyConnected", dict(fc(8, 4), kernel_zero_point=256)),
    ("FullyConnected", fc(8, 4, output_min=100, output_max=99)),
    ("MaxPooling2D", dict(pool_size=(0, 3))),
    ("MaxPooling2D", dict(pool_size=(1, 1))),
    ("MaxPooling2D", dict(pool_size=(3, 3), strides=(0, 2))),
    ("MaxPooling2D", dict(pool_size=(3, 3), dilation=(1, 0))),
    ("MaxPooling2D", dict(pool_size=(3, 3), output_min=200, output_max=100)),
    ("AveragePooling2D", dict(AVG, pool_size=(0, 2))),
    ("AveragePooling2D", dict(AVG, pool_size=(1, 1))),
    ("AveragePooling2D", dict(AVG, pool_size=(2, 2), strides=(2, 0))),
    ("AveragePooling2D", dict(AVG, pool_size=(2, 2), input_scale=0.0)),
    ("AveragePooling2D", dict(AVG, pool_size=(2, 2), output_zero_point=256)),
    ("AveragePooling2D", dict(AVG, pool_size=(2, 2), input_scale=1000.0,
                              output_scale=0.001)),
    ("AveragePooling2D", dict(AVG, pool_size=(4096, 4096))),
    ("AveragePooling2D", dict(AVG, pool_size=(2, 2), output_min=-1)),
    ("GlobalAveragePooling", dict(AVG, channels=0)),
    ("GlobalAveragePooling", dict(AVG, channels=8, input_scale=1000.0,
                                  output_scale=0.001)),
    ("GlobalAveragePooling", dict(AVG, channels=8, input_zero_point=-1)),
    ("GlobalAveragePooling", dict(AVG, channels=8,
                                  output_scale=float("inf"))),
    ("GlobalAveragePooling", dict(AVG, channels=8, output_max=256)),
]


@pytest.mark.parametrize("name,kwargs", REJECTED,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(REJECTED)])
def test_rejection_matches_jax(name, kwargs):
    with pytest.raises(Exception) as jerr:
        getattr(jops, name)(**kwargs)
    with pytest.raises(tstatus.QnnpackError) as terr:
        getattr(tops, name)(**kwargs, device="cpu")
    assert type(terr.value).__name__ == type(jerr.value).__name__
    assert str(terr.value) == str(jerr.value)
    assert int(terr.value.status) == int(jerr.value.status)


def test_rejection_comes_before_the_device():
    """An invalid create raises its parameter error even where the device
    it asks for does not exist."""
    with pytest.raises(tstatus.InvalidParameterError):
        tops.Clamp(output_min=9, output_max=3, device="cuda:7")


def test_status_codes_match_jax():
    from qnnpack_tpu import status as jstatus
    assert {s.name: int(s) for s in tstatus.Status} == \
        {s.name: int(s) for s in jstatus.Status}
    for cls in ("InvalidParameterError", "UnsupportedParameterError",
                "UninitializedError"):
        assert getattr(tstatus, cls).status == getattr(jstatus, cls).status


def test_deleted_operator_refuses_to_run():
    op = tops.Sigmoid(input_zero_point=121, input_scale=0.25, device="cpu")
    x = torch.from_numpy(u8(2, 5))
    op(x)
    op.delete()
    assert op.lut is None
    with pytest.raises(tstatus.UninitializedError, match="deleted"):
        op(x)


def test_operator_checks_its_inputs():
    op = tops.Clamp(output_min=3, output_max=9, device="cpu")
    with pytest.raises(TypeError):
        op(u8(2, 3))
    with pytest.raises(TypeError):
        op(torch.zeros(2, 3, dtype=torch.int32))


def test_unknown_requant_scheme_matches_jax():
    for name, kwargs in (("Convolution2D", conv(8, 3, 3, 4, requant="q15")),
                         ("FullyConnected", fc(8, 4, requant="q15"))):
        with pytest.raises(ValueError) as jerr:
            getattr(jops, name)(**kwargs)
        with pytest.raises(ValueError) as terr:
            getattr(tops, name)(**kwargs, device="cpu")
        assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("width,c,why", [
    (49, 9, "channels"), (0, 8, "width")])
def test_global_average_pooling_call_rejections_match_jax(width, c, why):
    x = u8(2, width, c)
    jop = jops.GlobalAveragePooling(**AVG, channels=8)
    top = tops.GlobalAveragePooling(**AVG, channels=8, device="cpu")
    with pytest.raises(Exception) as jerr:
        jop(jnp.asarray(x))
    with pytest.raises(tstatus.InvalidParameterError) as terr:
        top(torch.from_numpy(x))
    assert type(terr.value).__name__ == type(jerr.value).__name__
    assert str(terr.value) == str(jerr.value) and why in str(terr.value)


def test_global_average_pooling_binds_each_width():
    """One operator over several widths: the params of each width are
    cached apart, and each call equals the JAX operator's."""
    jop = jops.GlobalAveragePooling(**AVG, channels=16)
    top = tops.GlobalAveragePooling(**AVG, channels=16, device="cpu")
    for width in (7, 49, 300, 7):
        x = u8(2, width, 16)
        np.testing.assert_array_equal(top(torch.from_numpy(x)).numpy(),
                                      np.asarray(jop(jnp.asarray(x))))
        assert (dataclasses.astuple(top._params_for_width(width))
                == dataclasses.astuple(jop._params_for_width(width)))
    assert sorted(top._width_cache) == [7, 49, 300]


# Deconvolution2D takes Convolution2D's create kwargs (conv()) plus its
# adjustment.
deconv = conv
S2 = dict(strides=(2, 2))
# (create kwargs, input shape) of Deconvolution2D
DECONV = [
    # k == s: one GEMM (groups 1) or grouped 1x1 conv, depth-to-space
    *[(deconv(16, 2, 2, 8, requant=r, **S2), (2, 5, 6, 8))
      for r in ("q31", "fp32")],
    *[(deconv(16, 2, 2, 8, izp=128, kzp=128, requant=r, **S2),
       (2, 5, 6, 8)) for r in ("q31", "fp32")],
    (deconv(12, 2, 2, 4, groups=2, requant="fp32", **S2), (1, 4, 5, 8)),
    (deconv(9, 3, 3, 4, requant="gemmlowp", strides=(3, 3)), (1, 3, 4, 4)),
    # phases: padding and adjustment, k < s, asymmetric, depthwise
    *[(deconv(8, 3, 3, 8, padding=P1, adjustment=(1, 1), requant=r, **S2),
       (1, 5, 5, 8)) for r in SCHEMES],
    (deconv(8, 3, 3, 8, izp=128, kzp=128, padding=P1, adjustment=(1, 1),
            **S2), (1, 5, 5, 8)),
    (deconv(8, 2, 2, 4, requant="fp32", strides=(3, 3)), (1, 4, 5, 4)),
    (deconv(6, 3, 3, 4, strides=(3, 2), padding=((1, 1), (0, 1)),
            adjustment=(1, 0), requant="precise"), (2, 5, 4, 4)),
    (deconv(8, 3, 3, 1, groups=8, padding=P1, output_min=30,
            output_max=220, **S2), (1, 5, 5, 8)),
    (deconv(12, 3, 3, 4, groups=2, padding=P1, adjustment=(1, 1), **S2),
     (1, 4, 4, 8)),
    # dilated: stride 1, dilation 2, stride 2 with dilation 2
    *[(deconv(4, 3, 3, 4, padding=P1, requant=r), (1, 6, 6, 4))
      for r in ("q31", "fp32")],
    (deconv(4, 3, 3, 4, dilation=(2, 2), padding=((2, 2), (2, 2))),
     (1, 5, 5, 4)),
    (deconv(4, 3, 3, 4, dilation=(2, 2), requant="fp32", **S2),
     (1, 4, 4, 4)),
    # tests/test_ops.py's lifecycle case
    (deconv(8, 3, 3, 8, izp=120, kzp=110, ozp=128, padding=P1,
            adjustment=(1, 1), **S2), (1, 5, 5, 8)),
]


@pytest.mark.parametrize("kwargs,shape", DECONV,
                         ids=[str(i) for i in range(len(DECONV))])
def test_deconvolution_matches_jax(kwargs, shape):
    x = u8(*shape)
    jop = jops.Deconvolution2D(**kwargs)
    want = np.asarray(jop(jnp.asarray(x)))
    top = tops.Deconvolution2D(**kwargs, device="cpu")
    assert top.output_shape(shape) == jop.output_shape(shape) == want.shape
    # The plan is built at create, so a run only launches.
    assert len(top.packed.deconv_plans) == 1
    tkernels.reset_launch_counts()
    got = top(torch.from_numpy(x))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(tkernels.launch_counts().values()) == {0}
    assert len(top.packed.deconv_plans) == 1


def test_deconvolution_lowerings():
    kinds = [tops.Deconvolution2D(**kw, device="cpu").lowering
             for kw, _ in DECONV]
    assert {k: kinds.count(k) for k in set(kinds)} == {
        "k_eq_s": 6, "phase": 10, "dilated": 4}


DECONV_REJECTED = [
    deconv(8, 3, 3, 4, groups=3),
    dict(deconv(8, 3, 3, 4), kernel=np.zeros((8, 0, 3, 4), np.uint8)),
    deconv(8, 3, 3, 4, strides=(0, 2)),
    deconv(8, 3, 3, 4, dilation=(1, 0)),
    dict(deconv(8, 3, 3, 4), input_scale=2.0, kernel_scale=2.0,
         output_scale=1.0),
    dict(deconv(8, 3, 3, 4), output_scale=float("nan")),
    deconv(8, 3, 3, 4, ozp=256),
    deconv(8, 3, 3, 4, output_min=9, output_max=3),
]


@pytest.mark.parametrize("kwargs", DECONV_REJECTED,
                         ids=[str(i) for i in range(len(DECONV_REJECTED))])
def test_deconvolution_rejection_matches_jax(kwargs):
    with pytest.raises(Exception) as jerr:
        jops.Deconvolution2D(**kwargs)
    with pytest.raises(tstatus.QnnpackError) as terr:
        tops.Deconvolution2D(**kwargs, device="cpu")
    assert type(terr.value).__name__ == type(jerr.value).__name__
    assert str(terr.value) == str(jerr.value)
    assert int(terr.value.status) == int(jerr.value.status)


def test_deconvolution_padding_past_the_kernel_raises_at_run_as_jax():
    kwargs = deconv(4, 3, 3, 4, padding=((3, 0), (0, 0)))
    x = u8(1, 5, 5, 4)
    jop = jops.Deconvolution2D(**kwargs)
    with pytest.raises(ValueError) as jerr:
        jop(jnp.asarray(x))
    top = tops.Deconvolution2D(**kwargs, device="cpu")
    assert top.lowering == "unsupported"
    with pytest.raises(ValueError) as terr:
        top(torch.from_numpy(x))
    assert str(terr.value) == str(jerr.value)


def test_deleted_deconvolution_refuses_to_run():
    op = tops.Deconvolution2D(**deconv(8, 2, 2, 4, **S2), device="cpu")
    x = torch.from_numpy(u8(1, 3, 3, 4))
    op(x)
    op.delete()
    assert op.packed is None
    with pytest.raises(tstatus.UninitializedError, match="deleted"):
        op(x)


CONV_SHAPES = [  # (case index in CASES, input shape) of each kernel type
    (i, c[2][0]) for i, c in enumerate(CASES) if c[0] == "Convolution2D"]


@pytest.mark.parametrize("index,shape", CONV_SHAPES,
                         ids=[str(i) for i, _ in CONV_SHAPES])
def test_conv_output_shape_and_kernel_type_match_jax(index, shape):
    _, kwargs, _ = CASES[index]
    jop = jops.Convolution2D(**kwargs)
    top = tops.Convolution2D(**kwargs, device="cpu")
    assert top.kernel_type == jop.kernel_type
    assert top.output_shape(shape) == jop.output_shape(shape)
    for odd in ((1, 5, 6, shape[-1]), (4, 17, 3, shape[-1])):
        if all(d >= k for d, k in zip(odd[1:3], top.kernel_size)):
            assert top.output_shape(odd) == jop.output_shape(odd)


def test_conv_kernel_types_reach_their_kernels():
    """The routes the card takes: 1x1 -> q8gemm's packing, depthwise ->
    q8dwconv's, the stem class at kzp 128 -> q8stem and at kzp != 128 ->
    q8conv."""
    types, routes = {}, set()
    for name, kwargs, _ in CASES:
        if name == "Convolution2D":
            op = tops.Convolution2D(**kwargs, device="cpu")
            types.setdefault(op.kernel_type, op)
            if op.kernel_type == "conv" and op.groups == 1:
                route = dense_conv_route(op.packed, op.strides, op.dilation)
                routes.add(route)
                assert (route == "q8stem") == (
                    kwargs["kernel_zero_point"] == 128
                    and op.strides == (2, 2))
    assert set(types) == {"gemm", "dwconv", "conv"}
    assert routes == {"q8stem", "q8conv"}
    assert types["gemm"].packed.w_kmajor.shape[0] == 24
    assert types["dwconv"].packed.w_dw is not None


def test_fully_connected_use_pallas_selects_nothing():
    kwargs = fc(37, 101)
    x = torch.from_numpy(u8(3, 101))
    outs = [tops.FullyConnected(**kwargs, use_pallas=u, device="cpu")(x)
            for u in (None, True, False)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.parametrize("name,kwargs,shape", [
    ("Convolution2D", conv(8, 3, 3, 4, padding=P1), (1, 5, 5, 4)),
    ("FullyConnected", fc(8, 4), (2, 4)),
    ("MaxPooling2D", dict(pool_size=(2, 2)), (1, 4, 4, 3)),
    ("AveragePooling2D", dict(AVG, pool_size=(2, 2)), (1, 4, 4, 3)),
    ("GlobalAveragePooling", dict(AVG, channels=3), (1, 4, 3))])
def test_deleted_new_operators_refuse_to_run(name, kwargs, shape):
    op = getattr(tops, name)(**kwargs, device="cpu")
    x = torch.from_numpy(u8(*shape))
    op(x)
    op.delete()
    for attr in op._tensors:
        assert getattr(op, attr) is None
    with pytest.raises(tstatus.UninitializedError, match="deleted"):
        op(x)


def test_per_channel_scales_live_on_the_operator_device():
    """Per-channel Convolution2D puts its scales on its device at create;
    the kernels' requant arguments take that tensor as it is (no copy at
    a run), and delete() frees it."""
    import gc
    import weakref

    from qnnpack_tpu_torch.kernels import _build

    kwargs = conv(24, 3, 3, 4, padding=P1, per_channel=True)
    op = tops.Convolution2D(**kwargs, device="cpu")
    scales = op.rparams.device_scales
    assert scales.dtype == torch.float32 and scales.device == op.device
    np.testing.assert_array_equal(
        scales.numpy(), np.float32(op.rparams.scales))
    misses = _build._channel_scales.cache_info().misses
    assert _build.requant_args(op.rparams, 24, op.device)[0] is scales
    op(torch.from_numpy(u8(1, 5, 5, 4)))
    assert _build._channel_scales.cache_info().misses == misses
    ref = weakref.ref(scales)
    del scales
    op.delete()
    gc.collect()
    assert ref() is None
