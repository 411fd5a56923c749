"""The port's int8 BERT encoder and q8bmm against the JAX package.

- q8bmm (the kernel's plain version behind nn.gemm.q8bmm) against the JAX
  q8bmm for (za, zb) in {(128, 128), (0, 128), (37, 201)} under fp32, q31
  and per-channel requant, on contiguous operands and on BERT's q, k and v
  views of one qkv array with the context written through `out=`;
- the wrapper's layout rule (kernels/q8bmm.py:bmm_layout): K- and N-major
  B, and the layouts it refuses;
- BERT at the tiny config of tests/test_models_zoo.py (q31 and fp32), one
  layer at full width (hidden 768, 12 heads, FFN 3072, sequence 128, batch
  1, fp32), the port's builder against the JAX builder (same seed, same
  packed weights) and params_from_jax;
- the entry point's BERT example input and spec, and InferenceServer
  answering BERT requests with the batch rows.
Comparisons are exact."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qnnpack_tpu.models import bert as jbert
from qnnpack_tpu.nn import gemm as jgemm
from qnnpack_tpu.nn.requant_dispatch import make_requant_params as jmake
from qnnpack_tpu.quant.params import \
    compute_per_channel_fp32_params as jper_channel
from qnnpack_tpu_torch import kernels as tkernels
from qnnpack_tpu_torch.entry import entry, input_shape
from qnnpack_tpu_torch.kernels.q8bmm import bmm_layout, q8bmm_cuda
from qnnpack_tpu_torch.models import bert as tbert
from qnnpack_tpu_torch.nn import gemm as tgemm
from qnnpack_tpu_torch.nn.requant_dispatch import make_requant_params as tmake
from qnnpack_tpu_torch.quant.params import \
    compute_per_channel_fp32_params as tper_channel
from qnnpack_tpu_torch.serving import InferenceServer

RNG = np.random.default_rng(0xBE27)
TINY = dict(hidden=32, heads=2, ffn=64, seq_len=16, layers=2)


def u8(*shape):
    return RNG.integers(0, 256, shape, dtype=np.int64).astype(np.uint8)


def requant_pair(scheme, n):
    if scheme == "per_channel":
        scales = RNG.uniform(1e-4, 3e-3, n)
        return jper_channel(scales, 119), tper_channel(scales, 119)
    return (jmake(scheme, 0.0021, 119, 3, 250),
            tmake(scheme, 0.0021, 119, 3, 250))


@pytest.mark.parametrize("scheme", ["fp32", "q31", "per_channel"])
@pytest.mark.parametrize("za,zb", [(128, 128), (0, 128), (37, 201)])
@pytest.mark.parametrize("lead,m,k,n", [((2, 3), 16, 8, 16),
                                        ((5,), 33, 70, 9), ((), 1, 1, 1)])
def test_q8bmm_matches_jax(lead, m, k, n, za, zb, scheme):
    a, b = u8(*lead, m, k), u8(*lead, k, n)
    jrp, trp = requant_pair(scheme, n)
    want = np.asarray(jgemm.q8bmm(jnp.asarray(a), jnp.asarray(b), za, zb,
                                  jrp))
    acc = np.asarray(jgemm.q8bmm_acc(jnp.asarray(a), jnp.asarray(b), za, zb))
    np.testing.assert_array_equal(
        tgemm.q8bmm_acc(torch.from_numpy(a), torch.from_numpy(b), za,
                        zb).numpy(), acc)
    tkernels.reset_launch_counts()
    got = tgemm.q8bmm(torch.from_numpy(a), torch.from_numpy(b), za, zb, trp)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert tkernels.launch_counts()["q8bmm"] == 0


@pytest.mark.parametrize("scheme", ["fp32", "q31", "per_channel"])
@pytest.mark.parametrize("za,zb", [(128, 128), (0, 128), (37, 201)])
@pytest.mark.parametrize("b,s,nh,dh", [(2, 16, 2, 16), (1, 9, 3, 5)])
def test_q8bmm_on_head_views_matches_jax(b, s, nh, dh, za, zb, scheme):
    """Scores from q and k, context from probabilities and v, all views of
    one [B * S, 3 H] qkv array (no copy), the context written into a
    [B, S, H] buffer through out=; the JAX q8bmm takes the transposed
    arrays, as the JAX forward builds them."""
    h = nh * dh
    qkv = u8(b * s, 3 * h)
    q, k, v = tbert.head_views(torch.from_numpy(qkv), b, s, nh, dh)
    assert q.data_ptr() == k.data_ptr() - h == v.data_ptr() - 2 * h
    j5 = qkv.reshape(b, s, 3, nh, dh)
    jq = np.ascontiguousarray(j5[:, :, 0].transpose(0, 2, 1, 3))
    jk = np.ascontiguousarray(j5[:, :, 1].transpose(0, 2, 3, 1))
    jv = np.ascontiguousarray(j5[:, :, 2].transpose(0, 2, 1, 3))
    jrp, trp = requant_pair(scheme, s)
    want = np.asarray(jgemm.q8bmm(jnp.asarray(jq), jnp.asarray(jk), za, zb,
                                  jrp))
    got = tgemm.q8bmm(q, k, za, zb, trp)
    np.testing.assert_array_equal(got.numpy(), want)

    probs = u8(b, nh, s, s)
    jrp, trp = requant_pair(scheme, dh)
    want = np.asarray(jgemm.q8bmm(jnp.asarray(probs), jnp.asarray(jv), za,
                                  zb, jrp))
    ctx = torch.zeros((b, s, h), dtype=torch.uint8)
    view = ctx.view(b, s, nh, dh).permute(0, 2, 1, 3)
    got = tgemm.q8bmm(torch.from_numpy(probs), v, za, zb, trp, out=view)
    assert got.data_ptr() == ctx.data_ptr()
    np.testing.assert_array_equal(view.numpy(), want)
    np.testing.assert_array_equal(
        ctx.numpy(), want.transpose(0, 2, 1, 3).reshape(b, s, h))


def test_bmm_layout_reads_k_and_n_major_b():
    qkv = torch.zeros((2 * 16, 3 * 32), dtype=torch.uint8)
    q, k, v = tbert.head_views(qkv, 2, 16, 2, 16)
    g, g1, sa, sb, b_kmajor, so = bmm_layout(q, k)
    assert (g, g1, b_kmajor) == (4, 2, True)
    assert sa == (16 * 96, 16, 96) and sb == (16 * 96, 16, 96)
    assert so == (2 * 16 * 16, 16 * 16, 16)
    probs = torch.zeros((2, 2, 16, 16), dtype=torch.uint8)
    ctx = torch.zeros((2, 16, 32), dtype=torch.uint8)
    g, g1, sa, sb, b_kmajor, so = bmm_layout(
        probs, v, ctx.view(2, 16, 2, 16).permute(0, 2, 1, 3))
    assert (g, g1, b_kmajor) == (4, 2, False)
    assert sb == (16 * 96, 16, 96) and so == (16 * 32, 16, 32)
    # A contiguous B is N-major; a 3-D batch has no outer stride.
    g, g1, sa, sb, b_kmajor, so = bmm_layout(
        torch.zeros((5, 3, 4), dtype=torch.uint8),
        torch.zeros((5, 4, 6), dtype=torch.uint8))
    assert (g, g1, sa, sb, b_kmajor, so) == (5, 5, (0, 12, 4), (0, 24, 6),
                                             False, (0, 18, 6))


def test_bmm_layout_refuses_other_layouts():
    a = torch.zeros((2, 3, 4), dtype=torch.uint8)
    b = torch.zeros((2, 8, 12), dtype=torch.uint8)[:, ::2, ::2]
    with pytest.raises(ValueError, match="K or N at stride 1"):
        bmm_layout(a, b)
    with pytest.raises(ValueError, match="K at stride 1"):
        bmm_layout(torch.zeros((2, 4, 3), dtype=torch.uint8).transpose(1, 2),
                   torch.zeros((2, 4, 6), dtype=torch.uint8))
    b = torch.zeros((2, 4, 6), dtype=torch.uint8)
    for out in (torch.zeros((2, 3, 5), dtype=torch.uint8),
                torch.zeros((2, 3, 6), dtype=torch.int32),
                torch.zeros((2, 6, 3), dtype=torch.uint8).transpose(1, 2),
                torch.zeros((2, 3, 12), dtype=torch.uint8)[:, :, ::2]):
        with pytest.raises(ValueError, match="out"):
            bmm_layout(a, b, out)
    with pytest.raises(ValueError, match="do not chain"):
        bmm_layout(a, torch.zeros((3, 4, 6), dtype=torch.uint8))
    with pytest.raises(ValueError):
        bmm_layout(a[0], b[0])


def test_q8bmm_accumulator_wraps_like_int32():
    """K = 70000 at za = zb = 0 passes 2^31: both packages wrap."""
    a = np.full((1, 1, 70000), 255, np.uint8)
    b = np.full((1, 70000, 1), 255, np.uint8)
    want = np.asarray(jgemm.q8bmm_acc(jnp.asarray(a), jnp.asarray(b), 0, 0))
    got = tgemm.q8bmm_acc(torch.from_numpy(a), torch.from_numpy(b), 0, 0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(want[0, 0, 0]) == ((255 * 255 * 70000 + 2**31) % 2**32) - 2**31


def test_q8bmm_rejects_operands_that_do_not_chain():
    rp = tmake("fp32", 0.01, 128)
    with pytest.raises(ValueError):
        q8bmm_cuda(torch.zeros(2, 3, 4, dtype=torch.uint8),
                   torch.zeros(2, 5, 6, dtype=torch.uint8), 0, 0, rp)
    with pytest.raises(ValueError):
        tgemm.q8bmm(torch.zeros(2, 3, 4, dtype=torch.uint8),
                    torch.zeros(3, 4, 6, dtype=torch.uint8), 0, 0, rp)


def jax_forward(params, spec, x):
    return np.asarray(jax.jit(
        lambda p, v: jbert.bert_encoder_forward(p, spec, v))(
            params, jnp.asarray(x)))


def build_pair(seed, **cfg):
    jp, js = jbert.build_bert_encoder(np.random.default_rng(seed),
                                      jbert.BertConfig(**cfg))
    tp, ts = tbert.build_bert_encoder(np.random.default_rng(seed),
                                      tbert.BertConfig(**cfg), device="cpu")
    return jp, js, tp, ts


def assert_same_weights(jp, tp):
    assert len(jp) == len(tp)
    for jl, tl in zip(jp, tp):
        assert set(tl) == set(tbert.LAYER_WEIGHTS)
        for name in tbert.LAYER_WEIGHTS:
            np.testing.assert_array_equal(tl[name].w.numpy(),
                                          np.asarray(jl[name].w))
            np.testing.assert_array_equal(tl[name].bias_folded.numpy(),
                                          np.asarray(jl[name].bias_folded))
            assert (tl[name].k, tl[name].n) == (jl[name].k, jl[name].n)


@pytest.mark.parametrize("requant", ["q31", "fp32"])
def test_bert_tiny_matches_jax(requant):
    jp, js, tp, ts = build_pair(5, requant=requant, **TINY)
    assert_same_weights(jp, tp)
    np.testing.assert_array_equal(
        ts["softargmax_lut"].numpy().view(np.uint32),
        np.asarray(js["softargmax_lut"]))
    for key in ("rp_proj", "rp_relu", "rp_scores", "rp_ctx", "add"):
        assert dataclasses.asdict(ts[key]) == dataclasses.asdict(js[key]), \
            key
    x = u8(2, 16, 32)
    want = jax_forward(jp, js, x)
    tkernels.reset_launch_counts()
    got = tbert.bert_encoder_forward(tp, ts, torch.from_numpy(x))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(tkernels.launch_counts().values()) == {0}
    assert len(np.unique(want)) > 8


def test_bert_one_full_width_layer_matches_jax():
    jp, js, tp, ts = build_pair(11, layers=1)
    cfg = ts["cfg"]
    assert (cfg.hidden, cfg.heads, cfg.ffn, cfg.seq_len, cfg.requant) == \
        (768, 12, 3072, 128, "fp32")
    x = u8(1, 128, 768)
    want = jax_forward(jp, js, x)
    got = tbert.bert_encoder_forward(tp, ts, torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


def test_bert_params_from_jax():
    jp, js, tp, ts = build_pair(3, requant="q31", **TINY)
    arrays = jax.tree_util.tree_map(np.asarray, jp)
    cfg = tbert.BertConfig(requant="q31", **TINY)
    ported = tbert.params_from_jax(arrays, cfg, device="cpu")
    assert_same_weights(jp, ported)
    keyed = [{name: {"w": np.asarray(rec.w),
                     "bias_folded": np.asarray(rec.bias_folded)}
              for name, rec in layer.items()} for layer in jp]
    assert_same_weights(jp, tbert.params_from_jax(keyed, cfg, device="cpu"))
    x = u8(2, 16, 32)
    np.testing.assert_array_equal(
        tbert.bert_encoder_forward(ported, ts, torch.from_numpy(x)).numpy(),
        jax_forward(jp, js, x))
    with pytest.raises(ValueError):
        tbert.params_from_jax(arrays[:1], cfg, device="cpu")
    bad = [dict(layer) for layer in keyed]
    bad[1]["ffn2"] = {"w": bad[1]["ffn2"]["w"][:-1],
                      "bias_folded": bad[1]["ffn2"]["bias_folded"]}
    with pytest.raises(ValueError, match="ffn2"):
        tbert.params_from_jax(bad, cfg, device="cpu")


def test_bert_params_from_jax_gives_the_kernel_fields_of_raw_packing():
    """params_from_jax derives the same K-major weights and raw-uint8 bias
    as the port's own packing of the raw weights."""
    jp, _, tp, _ = build_pair(4, requant="fp32", **TINY)
    cfg = tbert.BertConfig(requant="fp32", **TINY)
    ported = tbert.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                   cfg, device="cpu")
    for own, got in zip(tp, ported):
        for name in tbert.LAYER_WEIGHTS:
            assert torch.equal(got[name].w_kmajor, own[name].w_kmajor)
            assert torch.equal(got[name].bias_c, own[name].bias_c)


def test_bert_entry_example_and_spec():
    """entry(model="bert_base_s128") builds BERT-base from seed 0 and draws
    the example input from the same RNG after the weights, as bench_models
    .py's _bert_base does."""
    fn, (params, x) = entry(device="cpu", model="bert_base_s128")
    cfg = fn.spec["cfg"]
    assert (cfg.layers, cfg.hidden, cfg.heads, cfg.ffn, cfg.seq_len,
            cfg.requant) == (12, 768, 12, 3072, 128, "fp32")
    assert input_shape("bert_base_s128") == (128, 768)
    rng = np.random.default_rng(0)
    jp, _ = jbert.build_bert_encoder(rng, jbert.BertConfig())
    want_x = rng.integers(0, 256, (1, 128, 768), dtype=np.int64).astype(
        np.uint8)
    np.testing.assert_array_equal(x.numpy(), want_x)
    assert_same_weights(jp[:1], params[:1])
    assert_same_weights(jp[-1:], params[-1:])


def test_inference_server_answers_bert_requests():
    _, _, tp, ts = build_pair(9, requant="fp32", **TINY)
    fwd = functools.partial(tbert.bert_encoder_forward, tp, ts)
    samples = u8(5, 16, 32)
    direct = fwd(torch.from_numpy(samples)).numpy()
    server = InferenceServer(fwd, (16, 32), device="cpu", max_batch=4)
    with server:
        futures = [server.submit(s, block=True) for s in samples]
        answers = [f.result(timeout=60) for f in futures]
    for i, ans in enumerate(answers):
        np.testing.assert_array_equal(ans, direct[i])
    assert server.stats.requests == 5
