"""The port's deconvolution (nn/conv.py:q8deconv2d) against the JAX
package's, byte for byte.

- every case of tests/test_conv.py::test_deconv2d_bit_exact (k == s with
  and without groups, strided phases with padding and adjustment, k < s
  phases that no tap reaches, stride 1, dilation 2) at zero points
  (121, 103) and (128, 128), under q31 and fp32 requant, both records
  packed from the same raw numpy kernel; each case also through a record
  made by models/graph.py:packed_from_jax from the JAX record;
- the three lowerings are picked as JAX picks them, each plan is built once
  per record, geometry and requantization and is the record's own;
- transposed packing flips the kernel and keeps the folded bias; the
  dilated lowering's padding limit raises JAX's ValueError.
Runs on the CPU (device="cpu"): the wrappers take their plain versions
there."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import reference_ops as ref
from qnnpack_tpu.nn import conv as jconv
from qnnpack_tpu.nn.requant_dispatch import make_requant_params as jrequant
from qnnpack_tpu_torch import kernels as tkernels
from qnnpack_tpu_torch.models.graph import packed_from_jax
from qnnpack_tpu_torch.nn import conv as tconv
from qnnpack_tpu_torch.nn.packing import PackedGemmWeights
from qnnpack_tpu_torch.nn.requant_dispatch import make_requant_params
from test_conv import DECONV_CASES, make_conv_case, scale_for

LOWERING = {
    "2x2_stride2": "k_eq_s", "3x3_stride2_pad1": "phase",
    "3x3_stride2_adj1": "phase", "3x3_stride1": "dilated",
    "grouped": "phase", "dilated": "dilated", "k_lt_stride": "phase",
    "s3_pad_adj": "phase", "k_eq_s_grouped": "k_eq_s",
    "k_eq_s_3x3": "k_eq_s",
}


def deconv_case(case, zps, requant, seed):
    """(input, JAX output, port record, requant params, geometry)."""
    name, b, h, w, c, o, kh, kw, groups, strides, padding, adj, dil = case
    a, wt, bias = make_conv_case(b, h, w, c, o, kh, kw, groups, seed=seed)
    acc = ref.deconv2d_acc(a, wt, bias, zps[0], zps[1], strides, padding,
                           adj, dil, groups)
    scale, zp = scale_for(acc)
    jp = jconv.pack_conv_weights(wt, bias, zps[0], zps[1], groups,
                                 transposed=True)
    want = np.asarray(jconv.q8deconv2d(
        jnp.asarray(a), jp, jrequant(requant, scale, zp), strides, padding,
        adj, dil))
    tp = tconv.pack_conv_weights(wt, bias, zps[0], zps[1], groups,
                                 transposed=True, device="cpu")
    return (a, want, tp, jp, make_requant_params(requant, scale, zp),
            (strides, padding, adj, dil))


@pytest.mark.parametrize("requant", ["q31", "fp32"])
@pytest.mark.parametrize("zps", [(121, 103), (128, 128)])
@pytest.mark.parametrize("case", DECONV_CASES,
                         ids=[c[0] for c in DECONV_CASES])
def test_q8deconv2d_matches_jax(case, zps, requant):
    a, want, tp, jp, rp, geom = deconv_case(case, zps, requant, seed=31)
    assert tconv.deconv_lowering(tp, *geom) == LOWERING[case[0]]
    tkernels.reset_launch_counts()
    got = tconv.q8deconv2d(torch.from_numpy(a), tp, rp, *geom)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(tkernels.launch_counts().values()) == {0}
    # The same layer from the JAX package's record (flipped already): its
    # shapes and zero points come from the record's own fields.
    rec = packed_from_jax("deconv", jp, None, gemm=False, groups=case[8],
                          device="cpu")
    assert torch.equal(rec.w, tp.w)
    got = tconv.q8deconv2d(torch.from_numpy(a), rec, rp, *geom)
    np.testing.assert_array_equal(got.numpy(), want)


def test_transposed_packing_flips_the_kernel_and_keeps_the_bias():
    _, wt, bias = make_conv_case(1, 1, 1, 6, 4, 3, 2, 2, seed=3)
    plain = tconv.pack_conv_weights(wt, bias, 121, 103, 2, device="cpu")
    flipped = tconv.pack_conv_weights(wt, bias, 121, 103, 2, True,
                                      device="cpu")
    assert torch.equal(flipped.w, plain.w.flip(0, 1))
    assert torch.equal(flipped.bias_folded, plain.bias_folded)
    jp = jconv.pack_conv_weights(wt, bias, 121, 103, 2, transposed=True)
    np.testing.assert_array_equal(flipped.w.numpy(), np.asarray(jp.w))
    np.testing.assert_array_equal(flipped.bias_folded.numpy(),
                                  np.asarray(jp.bias_folded))


def test_k_eq_s_runs_one_gemm_record():
    """groups 1: phase-major GEMM weights [Icpg, sy*sx*Og]; groups > 1: a
    grouped 1x1 conv record with sy*sx*Og channels a group."""
    _, wt, bias = make_conv_case(1, 1, 1, 8, 6, 2, 2, 1, seed=4)
    p = tconv.pack_conv_weights(wt, bias, 121, 103, transposed=True,
                                device="cpu")
    rp = make_requant_params("fp32", 0.01, 128)
    plan = tconv.deconv_plan(p, rp, (2, 2))
    assert isinstance(plan.record, PackedGemmWeights)
    assert (plan.record.k, plan.record.n) == (8, 24)
    _, wt, bias = make_conv_case(1, 1, 1, 8, 6, 2, 2, 2, seed=4)
    p = tconv.pack_conv_weights(wt, bias, 121, 103, 2, transposed=True,
                                device="cpu")
    rec = tconv.deconv_plan(p, rp, (2, 2)).record
    assert isinstance(rec, tconv.PackedConvWeights)
    assert (rec.groups, rec.group_input_channels,
            rec.group_output_channels) == (2, 4, 12)
    assert rec.w_dw is None


def test_phase_plan_holds_constant_rows_for_untapped_phases():
    a, want, tp, _, rp, geom = deconv_case(DECONV_CASES[6], (121, 103),
                                           "fp32", seed=8)
    plan = tconv.deconv_plan(tp, rp, *geom)
    consts = [ph for ph in plan.phases if ph.record is None]
    assert len(plan.phases) == 9 and len(consts) == 5
    for ph in consts:
        assert ph.const.dtype == torch.uint8 and ph.const.shape == (8,)
        np.testing.assert_array_equal(
            want[:, ph.r::3, ph.q::3].reshape(-1, 8),
            np.broadcast_to(ph.const.numpy(), (want[:, ph.r::3,
                                                     ph.q::3].size // 8, 8)))


def test_depthwise_deconv_phases_route_to_dwconv():
    _, wt, bias = make_conv_case(1, 1, 1, 8, 8, 3, 3, 8, seed=5)
    p = tconv.pack_conv_weights(wt, bias, 121, 103, 8, transposed=True,
                                device="cpu")
    plan = tconv.deconv_plan(p, make_requant_params("q31", 0.01, 128),
                             (2, 2), ((1, 1), (1, 1)))
    for ph in plan.phases:
        assert ph.record is not None and ph.record.w_dw is not None
        assert ph.record.groups == 8


def test_plan_is_built_once_per_record_and_geometry():
    _, wt, bias = make_conv_case(1, 1, 1, 4, 8, 3, 3, 1, seed=6)
    p = tconv.pack_conv_weights(wt, bias, 121, 103, transposed=True,
                                device="cpu")
    q = tconv.pack_conv_weights(wt, bias, 121, 103, transposed=True,
                                device="cpu")
    rp = make_requant_params("q31", 0.01, 128)
    geom = ((2, 2), ((1, 1), (1, 1)), (1, 1))
    plan = tconv.deconv_plan(p, rp, *geom)
    assert tconv.deconv_plan(p, rp, *geom) is plan
    assert tconv.deconv_plan(q, rp, *geom) is not plan
    assert tconv.deconv_plan(p, rp, (2, 2), ((1, 1), (1, 1))) is not plan
    other = make_requant_params("q31", 0.02, 128)
    assert tconv.deconv_plan(p, other, *geom) is not plan
    assert len(p.deconv_plans) == 3 and len(q.deconv_plans) == 1


def test_padding_larger_than_the_effective_kernel_raises_as_jax():
    a, wt, bias = make_conv_case(1, 4, 4, 4, 4, 3, 3, seed=7)
    geom = ((1, 1), ((3, 0), (0, 0)), (0, 0), (1, 1))
    jp = jconv.pack_conv_weights(wt, bias, 121, 103, transposed=True)
    with pytest.raises(ValueError) as jerr:
        jconv.q8deconv2d(jnp.asarray(a), jp,
                         jrequant("q31", 0.01, 128), *geom)
    tp = tconv.pack_conv_weights(wt, bias, 121, 103, transposed=True,
                                 device="cpu")
    assert tconv.deconv_lowering(tp, *geom) == "unsupported"
    with pytest.raises(ValueError) as terr:
        tconv.q8deconv2d(torch.from_numpy(a), tp,
                         make_requant_params("q31", 0.01, 128), *geom)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("n,pad,adj,k,dil,s", [
    (4, 0, 0, 2, 1, 2), (5, 2, 1, 3, 1, 2), (7, 3, 2, 5, 2, 3),
    (1, 0, 0, 1, 1, 1)])
def test_deconv_output_dims_match_jax(n, pad, adj, k, dil, s):
    assert tconv.deconv_output_dims(n, pad, adj, k, dil, s) == \
        jconv.deconv_output_dims(n, pad, adj, k, dil, s)
