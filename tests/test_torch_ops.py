"""The port's lifecycle API (ops: the elementwise operators) against the JAX
package's qnnpack_tpu.ops.

- each operator gives the JAX operator's bytes on the same inputs (the
  plain versions of the q8vadd, u8clamp, u8rmax and u8lut32norm kernels on
  the CPU, x8lut and x8zip) and launches no kernel;
- each rejection of tests/test_ops.py (and of the shared checks of scale,
  zero point and range) raises the same exception type with the same
  message and status code;
- create takes a device, the GPU by default (tests/test_torch_port_rules
  .py checks that it raises without one); a deleted operator refuses to
  run.
Comparisons are exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qnnpack_tpu import ops as jops
from qnnpack_tpu_torch import kernels as tkernels
from qnnpack_tpu_torch import ops as tops
from qnnpack_tpu_torch import status as tstatus

RNG = np.random.default_rng(0x0B5)


def u8(*shape):
    return RNG.integers(0, 256, shape, dtype=np.int64).astype(np.uint8)


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
