"""MiMo-V2-Flash's hybrid block in the port (models/mimo_v2_flash.py) held
to the plain reference (tests/reference_mimo.py) at a small size on the
CPU: the forward byte for byte; each new op against its plain form (RoPE,
the fused masked attention, the top-8 choice with ties, SwiGLU, the
combine), and the fused attention's three-step oracle (masked scores with
grouped-query attention, masked softargmax with and without a sink,
masked context; plain PyTorch, below) against the reference; the share test of expert parallelism (the held experts' int32
combine accumulators of every share add up to the uncut layer's); a
planted fault failing the comparison; the spans and counters.

Tests marked `card` hold each new CUDA kernel to its plain version at the
block's shapes, and skip without a GPU."""

from __future__ import annotations

import copy

import pytest
import torch

import reference_mimo as ref
from qnnpack_tpu_torch import kernels as tk
from qnnpack_tpu_torch.kernels import moe as tmoe
from qnnpack_tpu_torch.kernels.q8bmm import (attn_norm, attn_row_div,
                                             kv_heads_of,
                                             q8attn_masked_cuda,
                                             q8attn_masked_plain, q8bmm_plain,
                                             valid_keys)
from qnnpack_tpu_torch.kernels.q8gemm import (q8gemm_grouped_cuda,
                                              q8gemm_grouped_plain)
from qnnpack_tpu_torch.kernels.vpu_ops import (q8rope_cuda, q8rope_plain,
                                               q8swiglu_cuda, q8swiglu_plain)
from qnnpack_tpu_torch.models import mimo_v2_flash as mimo
from qnnpack_tpu_torch.nn.elementwise import (build_softargmax_lut,
                                              lut32_tensor)
from qnnpack_tpu_torch.nn.packing import pack_grouped_weights
from qnnpack_tpu_torch.nn.requant_dispatch import make_requant_params
from qnnpack_tpu_torch.utils import profiling

ZP = 128


def small_config(held: int = 4, rank: int = 0, seq: int = 64,
                 heads: tuple = (48, 32, 8)) -> dict:
    """The block at test sizes, in the configuration's keys: hidden 256, 8
    query heads over 2 (full) or 4 (window) key/value heads, qk 48 and v
    32 (or `heads`: qk, v, window), window 8, 16 router experts of which
    `held` are held at `rank`, layers full+dense, window, full; the scales
    the port derives from these widths (mimo.quantization_scales)."""
    cfg = copy.deepcopy(ref.published())
    h, nh, f, ew = 256, 8, 384, 128
    dq, dv, w = heads
    cfg.update(hidden_size=h, num_attention_heads=nh,
               swa_num_attention_heads=nh, num_key_value_heads=2,
               swa_num_key_value_heads=4, head_dim=dq, swa_head_dim=dq,
               v_head_dim=dv, swa_v_head_dim=dv,
               partial_rotary_factor=0.34 if dq == 48 else
               cfg["partial_rotary_factor"],
               sliding_window=w, intermediate_size=f,
               moe_intermediate_size=ew, router_experts=16,
               n_routed_experts=held, num_experts_per_tok=8, seq_len=seq,
               num_hidden_layers=3, hybrid_layer_pattern=[0, 1, 0],
               moe_layer_freq=[0, 1, 1])
    cfg["expert_parallel"] = dict(cfg["expert_parallel"], rank=rank)
    cfg["quantization"].update(mimo.quantization_scales(
        mimo.config_from_dict(cfg)))
    return cfg


def _setup(cfg, seed=7, batch=2):
    gen = torch.Generator().manual_seed(seed)
    raw = ref.draw_weights(cfg, gen, "cpu")
    x = torch.randint(0, 256, (batch,) + ref.sample_shape(cfg), generator=gen,
                      dtype=torch.uint8)
    mc = mimo.config_from_dict(cfg)
    return raw, x, mc


def _port(cfg, raw, mc, x):
    spec = mimo.build_spec(mc, "cpu")
    params = mimo.pack_layers(raw, mc, "cpu")
    return mimo.mimo_forward(params, spec, x), params, spec


# ------------------------------------------------------------ (a) forward
@pytest.mark.parametrize("seed", [7, 2**31 + 11])
def test_forward_equals_reference_byte_for_byte(seed):
    cfg = small_config()
    raw, x, mc = _setup(cfg, seed)
    y, _, _ = _port(cfg, raw, mc, x)
    want = ref.forward(cfg, raw, x)
    assert y.dtype == torch.uint8 and y.shape == x.shape
    assert torch.equal(y, want)
    # Not a trivial output: the layers moved most bytes off the input.
    assert (y != x).float().mean() > 0.5


def test_config_from_the_benchmark_file():
    """The benchmark's configuration is the port's default block: widths,
    the cut (layers 0-6, 8 of 256 experts at rank 0), and every scale."""
    mc = mimo.config_from_dict(ref.published())
    assert mc == mimo.MimoConfig()
    mimo.check_quantization(ref.published())
    assert mc.qkv_width(0) == 13568 and mc.qkv_width(1) == 14848
    assert mc.rot_dim == 64 and mc.pattern == (0, 1, 1, 1, 1, 0, 1)


def test_quantization_the_port_does_not_build_with_is_refused():
    cfg = ref.published()
    cfg["quantization"]["rope_fraction_bits"] = 12
    with pytest.raises(ValueError, match="quantization.rope_fraction_bits"):
        mimo.check_quantization(cfg)


def test_scales_follow_from_the_widths():
    """The configuration's per-product scales are the port's rule applied
    to its widths (the port builds with them, whatever the file says), and
    a file whose scale is off the rule is refused."""
    q = ref.published()["quantization"]
    for key, value in mimo.quantization_scales(mimo.MimoConfig()).items():
        assert q[key] == value, key
    small = small_config()
    assert mimo.quantization_scales(mimo.config_from_dict(small))[
        "o_scale"] != q["o_scale"]
    mimo.check_quantization(small)
    cfg = ref.published()
    cfg["quantization"]["o_scale"] *= 2
    with pytest.raises(ValueError, match="quantization.o_scale"):
        mimo.check_quantization(cfg)


# ------------------------------------------------------------- (b) ops
def test_rope_equals_its_plain_form():
    gen = torch.Generator().manual_seed(1)
    s, heads, dim, rot = 64, 10, 48, 16
    x = torch.randint(0, 256, (2 * s, heads * dim + 40), generator=gen,
                      dtype=torch.uint8)
    c, sn = mimo.rope_tables(1e4, s, rot)
    rp = make_requant_params("fp32", 2.0 ** -14, ZP)
    y = q8rope_cuda(x.clone(), torch.from_numpy(c), torch.from_numpy(sn),
                    heads, dim, s, rp)
    rc, rs = ref.rope_tables(1e4, s, rot, "cpu")
    per = x[:, :heads * dim].reshape(2, s, heads, dim).permute(0, 2, 1, 3)
    want = torch.stack([ref.rope(p, rc, rs, ZP) for p in per])
    assert torch.equal(y[:, :heads * dim].reshape(2, s, heads, dim)
                       .permute(0, 2, 1, 3), want)
    assert torch.equal(y[:, heads * dim:], x[:, heads * dim:])


@pytest.mark.parametrize("window,sink", [(0, False), (8, False), (8, True),
                                         (1, True)])
def test_masked_softargmax_equals_its_plain_form(window, sink):
    gen = torch.Generator().manual_seed(window + 2 * sink)
    heads, s = 4, 40
    x = torch.randint(60, 200, (2 * heads, s, s), generator=gen,
                      dtype=torch.uint8)
    sinks = torch.randint(96, 192, (heads,), generator=gen,
                          dtype=torch.uint8) if sink else None
    channels = window + 1 if window else s
    lut = build_softargmax_lut(0.06, channels)
    y = u8softmax_masked_plain(x, lut32_tensor(lut), window, sinks)
    keep = ref.mask(s, window, "cpu")
    table = ref.qmath.softargmax_table(0.06, channels)
    want = ref.masked_softargmax(
        x, keep, table,
        None if sinks is None else sinks.repeat(2))
    assert torch.equal(torch.where(keep, y, 0), want)
    assert torch.equal(y, torch.where(keep, y, 0))
    # Rows sum to about 256; with a sink, which takes its share, to less.
    mean = want.to(torch.float64).sum(-1).mean()
    assert mean < 240 if sink else mean > 250


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("heads,kv", [(8, 2), (8, 4), (4, 4)])
def test_masked_bmm_with_gqa_equals_its_plain_form(window, heads, kv):
    gen = torch.Generator().manual_seed(heads * kv + window)
    b, s, dq, dv = 2, 32, 48, 32
    width = (heads + kv) * dq + kv * dv
    qkv = torch.randint(0, 256, (b, s, width), generator=gen,
                        dtype=torch.uint8)
    q = qkv[..., :heads * dq].view(b, s, heads, dq).permute(0, 2, 1, 3)
    k = qkv[..., heads * dq:(heads + kv) * dq].view(b, s, kv, dq).permute(
        0, 2, 3, 1)
    v = qkv[..., (heads + kv) * dq:].view(b, s, kv, dv).permute(0, 2, 1, 3)
    rp = make_requant_params("fp32", 0.003, ZP)
    scores = q8bmm_masked_plain(q, k, ZP, ZP, rp, SCORES, window)
    keep = ref.mask(s, window, "cpu")
    group = heads // kv
    want = torch.stack([torch.stack([ref.qmath.requant_fp32(
        ref.qmath.bmm_acc(q[i, h], k[i, h // group], ZP, ZP), 0.003, ZP)
        for h in range(heads)]) for i in range(b)])
    assert torch.equal(torch.where(keep, scores, 0),
                       torch.where(keep, want, 0))
    probs = torch.randint(0, 256, (b, heads, s, s), generator=gen,
                          dtype=torch.uint8)
    ctx = q8bmm_masked_plain(probs, v, 0, ZP, rp, CONTEXT, window)
    masked = torch.where(keep, probs, 0)
    want = torch.stack([torch.stack([ref.qmath.requant_fp32(
        ref.qmath.bmm_acc(masked[i, h], v[i, h // group], 0, ZP), 0.003, ZP)
        for h in range(heads)]) for i in range(b)])
    assert torch.equal(ctx, want)
    # The entries outside the mask never reach the context.
    noisy = torch.where(keep, probs, 255 - probs)
    assert torch.equal(q8bmm_masked_plain(noisy, v, 0, ZP, rp, CONTEXT,
                                          window), want)


def _attention_inputs(gen, b, s, heads, kv, dq=192, dv=128, case=None):
    """q, k, v views of one qkv buffer [B, S, width] as the block makes
    them (k K-major), the sinks and the buffer; `case` shapes the rows:
    "equal" makes every score of a row equal, "sink_max" puts the sink
    above every score."""
    width = (heads + kv) * dq + kv * dv
    # About the spread of the block's products (24 steps), so that the
    # scores spread over the table rather than saturate.
    qkv = torch.randint(100, 157, (b, s, width), generator=gen,
                        dtype=torch.uint8)
    if case == "equal":
        qkv[..., heads * dq:(heads + kv) * dq] = 140
    q = qkv[..., :heads * dq].view(b, s, heads, dq).permute(0, 2, 1, 3)
    k = qkv[..., heads * dq:(heads + kv) * dq].view(b, s, kv, dq).permute(
        0, 2, 3, 1)
    v = qkv[..., (heads + kv) * dq:].view(b, s, kv, dv).permute(0, 2, 1, 3)
    sinks = torch.randint(96, 192, (heads,), generator=gen,
                          dtype=torch.uint8)
    if case == "sink_max":
        sinks[:] = 255
    return q, k, v, sinks, qkv


# The fused attention's independent oracle: attention in three plain steps
# (masked scores, masked softargmax, masked context), each held to the
# reference above.
SCORES, CONTEXT = 1, 2


def q8bmm_masked_plain(a_u8, b_u8, a_zero_point: int, b_zero_point: int,
                       rparams, mode: int, window: int):
    """Attention's masked products, [B, H, ...] operands, B with
    [B, Hkv, ...] leading axes (query head h reads b[:, h * Hkv // H]).

    mode SCORES: A [B, H, S, K] x B [B, Hkv, K, S] -> [B, H, S, S], the
    entries outside the mask 0.  mode CONTEXT: A [B, H, S, S] (the
    probabilities, read only inside the mask) x B [B, Hkv, S, N] ->
    [B, H, S, N], each row summing over its valid keys."""
    h, hkv = a_u8.shape[1], b_u8.shape[1]
    b_full = b_u8[:, kv_heads_of(h, hkv, b_u8.device)]
    s = a_u8.shape[-2]
    keep = valid_keys(s, window, a_u8.device)
    if mode == CONTEXT:
        a_u8 = torch.where(keep, a_u8, torch.full_like(a_u8, a_zero_point))
        return q8bmm_plain(a_u8, b_full, a_zero_point, b_zero_point, rparams)
    y = q8bmm_plain(a_u8, b_full, a_zero_point, b_zero_point, rparams)
    return torch.where(keep, y, torch.zeros_like(y))


def u8softmax_masked_plain(x_u8, lut, window: int, sinks=None):
    """Softargmax over each row's valid keys of scores [G, S, S] (row i of
    a [S, S] block reads keys j <= i, and with window W > 0 only
    j > i - W), a new tensor whose entries outside the mask are 0.
    `sinks`, uint8 [H] or None, is one more virtual entry of each row of
    head g % H in the max and the sum, with no output; `lut` is int32 [256]
    holding the uint32 table.  The arithmetic is u8lut32norm_plain's,
    wrapping in uint32."""
    g, s, _ = x_u8.shape
    keep = valid_keys(s, window, x_u8.device)
    t = lut.to(torch.int64) & 0xFFFFFFFF
    x = x_u8.to(torch.int64)
    m = torch.where(keep, x, 0).amax(dim=-1, keepdim=True)
    if sinks is not None:
        sink = sinks.to(torch.int64).repeat(g // sinks.numel())[:, None, None]
        m = torch.maximum(m, sink)
    e = torch.where(keep, t[torch.where(keep, x, m) + 255 - m], 0)
    s_ = e.sum(dim=-1, keepdim=True)
    if sinks is not None:
        s_ = s_ + t[sink + 255 - m]
    s_ = s_ & 0xFFFFFFFF
    num = (e * 256 + (s_ >> 1)) & 0xFFFFFFFF
    q = torch.where(s_ == 0, 0xFFFFFFFF, num // s_.clamp(min=1))
    return torch.where(keep, q.clamp(max=255), 0).to(torch.uint8)


def _three_steps(q, k, v, rps, lut, window, sinks, rpc):
    """Attention in three plain steps: scores, softargmax, context."""
    b, h, s, _ = q.shape
    scores = q8bmm_masked_plain(q, k, ZP, ZP, rps, SCORES, window)
    probs = u8softmax_masked_plain(scores.reshape(b * h, s, s), lut, window,
                                   sinks).view(b, h, s, s)
    return q8bmm_masked_plain(probs, v, 0, ZP, rpc, CONTEXT, window)


def _reference_attention(q, k, v, scores_scale, table, window, sinks,
                         ctx_scale):
    """tests/reference_mimo.py's arithmetic, head by head."""
    b, h, s, _ = q.shape
    group = h // k.shape[1]
    keep = ref.mask(s, window, "cpu")
    out = []
    for i in range(b):
        rows = []
        for hh in range(h):
            sc = ref.qmath.requant_fp32(ref.qmath.bmm_acc(
                q[i, hh], k[i, hh // group], ZP, ZP), scores_scale, ZP)
            pr = ref.masked_softargmax(
                sc, keep, table, None if sinks is None else sinks[hh])
            rows.append(ref.qmath.requant_fp32(ref.qmath.bmm_acc(
                pr, v[i, hh // group], 0, ZP), ctx_scale, ZP))
        out.append(torch.stack(rows))
    return torch.stack(out).to(torch.uint8)


@pytest.mark.parametrize("s", [1, 63, 200, 257])
@pytest.mark.parametrize("heads,kv", [(16, 1), (16, 2)])
@pytest.mark.parametrize("window", [0, 128])
def test_fused_attention_equals_three_steps_and_reference(window, heads, kv,
                                                          s):
    """The fused op's plain version (the kernel's sweeps: the rows' max
    from the accumulators, the table's sum, the reciprocal divide) against
    the three plain steps and the reference, byte for byte: causal, and
    the 128-key band with the heads' sinks; GQA 16:1 and 8:1; qk 192, v
    128; sequences that are no multiple of a tile."""
    gen = torch.Generator().manual_seed(s + 3 * heads * kv + window)
    q, k, v, sinks, qkv = _attention_inputs(gen, 2, s, heads, kv)
    sinks = sinks if window else None
    channels = window + 1 if window else s
    lut = lut32_tensor(build_softargmax_lut(0.06, channels))
    rps = make_requant_params("fp32", 0.003007, ZP)
    rpc = make_requant_params("fp32", 0.0221 if window else 0.0884, ZP)
    got = q8attn_masked_cuda(q, k, v, ZP, rps, lut, window, sinks, rpc)
    assert got.shape == (2, heads, s, 128) and got.is_contiguous()
    assert torch.equal(got, _three_steps(q, k, v, rps, lut, window, sinks,
                                         rpc))
    table = ref.qmath.softargmax_table(0.06, channels)
    assert torch.equal(got, _reference_attention(
        q, k, v, 0.003007, table, window, sinks, 0.0221 if window else
        0.0884))
    # Through out=, as the block writes its [B, S, H dv] buffer.
    ctx = torch.zeros((2, s, heads * 128), dtype=torch.uint8)
    q8attn_masked_cuda(q, k, v, ZP, rps, lut, window, sinks, rpc,
                       out=ctx.view(2, s, heads, 128).permute(0, 2, 1, 3))
    assert torch.equal(ctx.view(2, s, heads, 128).permute(0, 2, 1, 3), got)


@pytest.mark.parametrize("case", ["sink_max", "equal", "saturate"])
@pytest.mark.parametrize("window", [0, 8])
def test_fused_attention_edge_rows(case, window):
    """Rows whose max is the sink, rows of all-equal scores, and scales
    that saturate the scores and the context: the fused op's plain version
    against the three plain steps."""
    gen = torch.Generator().manual_seed(len(case) + window)
    q, k, v, sinks, qkv = _attention_inputs(gen, 1, 70, 8, 2, case=case)
    if case != "sink_max" and not window:
        sinks = None
    channels = window + 1 if window else 70
    lut = lut32_tensor(build_softargmax_lut(0.06, channels))
    scale = 0.5 if case == "saturate" else 0.003007
    rps = make_requant_params("fp32", scale, ZP)
    rpc = make_requant_params("fp32", 2.0 if case == "saturate" else 0.0884,
                              ZP)
    got = q8attn_masked_cuda(q, k, v, ZP, rps, lut, window, sinks, rpc)
    assert torch.equal(got, _three_steps(q, k, v, rps, lut, window, sinks,
                                         rpc))
    scores = q8bmm_masked_plain(q, k, ZP, ZP, rps, SCORES, window)
    keep = ref.mask(70, window, "cpu")
    valid = scores[:, :, keep]
    if case == "saturate":
        assert (valid == 0).float().mean() > 0.2
        assert (valid == 255).float().mean() > 0.2
        assert ((got == 0) | (got == 255)).float().mean() > 0.5
    elif case == "equal":
        rows = torch.where(keep, scores.to(torch.int64), -1)
        assert torch.equal(rows.amax(-1), torch.where(
            keep, scores.to(torch.int64), 999).amin(-1))
    else:
        assert int(valid.max()) < 255


@pytest.mark.parametrize("s", [0, 1, 2, 3, 255, 256, 257, 2**16, 2**24 + 3,
                               2**31 - 1, 2**31, 2**31 + 1, 2**32 - 2,
                               2**32 - 1])
def test_fused_divide_equals_the_integer_divide(s):
    """The kernel's divide of a row (a reciprocal m = floor(2^32 / s), one
    correction; half = 255 for a zero sum) equals min((256 e + s / 2)
    mod 2^32 // s, 255), and 255 for s = 0, at the edges of e and s."""
    gen = torch.Generator().manual_seed(s % 1000)
    e = torch.cat([torch.tensor([0, 1, 255, 256, 2**24 - 1, 2**24, 2**24 + 1,
                                 2**31 - 1, 2**31, 2**32 - 1, s, s // 2,
                                 s // 256]),
                   torch.randint(0, 2**32, (2000,), generator=gen,
                                 dtype=torch.int64)]) & 0xFFFFFFFF
    total = torch.full_like(e, s)
    got = attn_norm(e, attn_row_div(total))
    num = (e * 256 + (total >> 1)) & 0xFFFFFFFF
    want = torch.full_like(e, 255) if s == 0 else (num // s).clamp(max=255)
    assert torch.equal(got, want)


def test_fused_attention_refuses_what_it_does_not_take():
    gen = torch.Generator().manual_seed(9)
    q, k, v, sinks, qkv = _attention_inputs(gen, 1, 16, 4, 2, dq=32, dv=32)
    lut = lut32_tensor(build_softargmax_lut(0.06, 16))
    rp = make_requant_params("fp32", 0.003, ZP)
    with pytest.raises(ValueError, match="window"):
        q8attn_masked_cuda(q, k.transpose(2, 3), v, ZP, rp, lut, 0, None, rp)
    with pytest.raises(ValueError, match="sinks"):
        q8attn_masked_cuda(q, k, v, ZP, rp, lut, 8, sinks[:3], rp)
    with pytest.raises(ValueError, match="out"):
        q8attn_masked_cuda(q, k, v, ZP, rp, lut, 0, None, rp,
                           out=torch.empty((1, 4, 16, 16),
                                           dtype=torch.uint8))
    # Any zero point and head sizes on the CPU: the three steps' bytes.
    got = q8attn_masked_plain(q, k, v, 100, rp, lut, 0, None, rp)
    scores = q8bmm_masked_plain(q, k, 100, 100, rp, SCORES, 0)
    probs = u8softmax_masked_plain(scores.reshape(4, 16, 16), lut, 0)
    assert torch.equal(got, q8bmm_masked_plain(probs.view(1, 4, 16, 16), v,
                                               0, 100, rp, CONTEXT, 0))


def test_route_equals_its_plain_form_with_ties():
    """Ties in sigma + c fall to the larger r, then to the lower expert:
    eight experts share every score, and four share r too."""
    cfg = small_config()
    r_n, t = 16, 12
    gen = torch.Generator().manual_seed(3)
    logits = torch.randint(-2000, 2000, (t, r_n), generator=gen,
                           dtype=torch.int32)
    logits[:, 4:8] = logits[:, :1]           # equal r
    corr = torch.zeros(r_n, dtype=torch.int32)
    lut = torch.full((256,), 77, dtype=torch.uint8)   # every sigma ties
    bias_c = torch.zeros(r_n, dtype=torch.int32)
    rp = make_requant_params("fp32", 1e-3, ZP)
    sel, wts = tmoe.route_plain(logits, bias_c, corr, lut, rp, 8)
    want = [sorted(range(r_n), key=lambda e: (-int(row[e]), e))[:8]
            for row in logits]
    assert sel.tolist() == want
    assert (wts == 32).all()   # 8 equal scores of 77: (256*77+308)//616
    # Against the reference's route on real logits.
    raw, x, mc = _setup(cfg)
    x2 = x[0]
    layer = raw[1]
    spec = mimo.build_spec(mc, "cpu")
    packed = mimo.pack_layers(raw, mc, "cpu")[1]
    part = tk.q8gemm_partial_cuda(x2, packed["router"])
    sel, wts = tmoe.route_plain(part, packed["router"].bias_c,
                                packed["corr"], spec["sigmoid_lut"],
                                spec["rp"]["router"], 8)
    rsel, rwts = ref.route(cfg, layer, x2, 8)
    assert torch.equal(sel.to(torch.int64), rsel)
    assert torch.equal(wts.to(torch.int64), rwts)
    assert 230 <= int(rwts.sum(1).min()) and int(rwts.sum(1).max()) <= 270


def test_swiglu_equals_its_plain_form():
    gen = torch.Generator().manual_seed(4)
    w = 40
    gu = torch.randint(0, 256, (3 * 16, 2 * w), generator=gen,
                       dtype=torch.uint8)
    lut = torch.from_numpy(mimo.silu_lut(0.05))
    rp = make_requant_params("fp32", 0.05, ZP)
    q = dict(act_zero_point=ZP, swiglu_scale=0.05)
    want = ref.swiglu(gu, w, ref.silu_table(0.05, ZP, "cpu"), q)
    assert torch.equal(q8swiglu_cuda(gu, lut, w, ZP, ZP, rp), want)
    counts = torch.tensor([16, 3, 0], dtype=torch.int32)
    y = q8swiglu_plain(gu, lut, w, ZP, ZP, rp, counts, 16)
    live = tmoe.live_rows(counts, 16)
    assert torch.equal(y[live], want[live]) and not y[~live].any()
    assert torch.equal(torch.from_numpy(mimo.silu_lut(0.05)).to(torch.int64),
                       ref.silu_table(0.05, ZP, "cpu"))
    assert torch.equal(torch.from_numpy(mimo.sigmoid_lut(0.05)).to(
        torch.int64), ref.sigmoid_table(0.05, ZP, "cpu"))


def test_grouped_gemm_and_combine_equal_their_plain_forms():
    """The experts' grouped GEMM on its segments, and the combine of the
    held experts' rows, against the reference's layer accumulator."""
    cfg = small_config()
    raw, x, mc = _setup(cfg)
    spec = mimo.build_spec(mc, "cpu")
    p = mimo.pack_layers(raw, mc, "cpu")[1]
    x2 = x[0]
    acc = mimo.moe_ffn(p, spec, 1, x2, combine=lambda d, slot, wts, rp:
                       tmoe.combine_acc_plain(d, slot, wts, rp.zero_point))
    assert torch.equal(acc, ref.moe_acc(cfg, raw[1], x2, 0))
    counts = spec["routed_rows"][1]
    assert 0 < int(counts.sum()) <= x2.shape[0] * 4
    t = x2.shape[0]
    gate_up = pack_grouped_weights(raw[1]["gate_up"], ZP, ZP)
    rows = torch.randint(0, 256, (4 * t, cfg["hidden_size"]),
                         dtype=torch.uint8)
    y = q8gemm_grouped_cuda(rows, gate_up, counts, t,
                            spec["rp"]["expert_gate_up"])
    for e in range(4):
        n = int(counts[e])
        want = ref.qmath.requant_fp32(ref.qmath.gemm_acc(
            rows[e * t:e * t + n], raw[1]["gate_up"][e], ZP, ZP,
            torch.zeros(1, dtype=torch.int64)),
            cfg["quantization"]["expert_gate_up_scale"], ZP)
        assert torch.equal(y[e * t:e * t + n], want)
    assert torch.equal(y, q8gemm_grouped_plain(rows, gate_up, counts, t,
                                               spec["rp"]["expert_gate_up"]))


# ------------------------------------------------------ (c) the share test
def test_expert_shares_add_up_to_the_uncut_layer():
    """The shares of expert parallelism: four devices, each holding 4 of
    16 experts, each computing its held experts' part of the combine's
    int32 accumulator; summed, the parts equal the uncut reference
    layer's (all 16 experts held), exactly."""
    full = small_config(held=16)
    gen = torch.Generator().manual_seed(5)
    raw = ref.draw_weights(full, gen, "cpu")
    x2 = torch.randint(0, 256, (64, full["hidden_size"]), generator=gen,
                       dtype=torch.uint8)
    want = ref.moe_acc(full, raw[1], x2, 0)
    total = torch.zeros_like(want)
    for rank in range(4):
        cfg = small_config(held=4, rank=rank)
        mc = mimo.config_from_dict(cfg)
        share = [dict(layer) for layer in raw]
        for key in ("gate_up", "down"):
            share[1][key] = raw[1][key][4 * rank:4 * rank + 4]
        spec = mimo.build_spec(mc, "cpu")
        p = mimo.pack_layers(share, mc, "cpu")[1]
        part = mimo.moe_ffn(p, spec, 1, x2, combine=lambda d, slot, wts, rp:
                            tmoe.combine_acc_plain(d, slot, wts,
                                                   rp.zero_point))
        assert torch.equal(part, ref.moe_acc(cfg, share[1], x2, 4 * rank))
        total += part
    assert torch.equal(ref.qmath.wrap_i32(total), want)
    assert want.abs().sum() > 0


# ------------------------------------------------------ (d) a planted fault
@pytest.mark.parametrize("fault", ["sink", "corr", "rope_table"])
def test_a_planted_fault_fails_the_comparison(fault):
    cfg = small_config()
    raw, x, mc = _setup(cfg)
    spec = mimo.build_spec(mc, "cpu")
    params = mimo.pack_layers(raw, mc, "cpu")
    if fault == "sink":
        params[1]["sink"] = params[1]["sink"] + 40
    elif fault == "corr":
        params[1]["corr"] = -params[1]["corr"]
    else:
        cos, sin = spec["rope"][mimo.WINDOW]
        spec["rope"][mimo.WINDOW] = (sin, cos)
    y = mimo.mimo_forward(params, spec, x)
    assert (y != ref.forward(cfg, raw, x)).sum() > 0


# ------------------------------------------------- spans and the counters
def test_spans_and_device_counter():
    cfg = small_config()
    raw, x, mc = _setup(cfg)
    profiling.reset()
    _, _, spec = _port(cfg, raw, mc, x)
    names = {p.split("/")[-1] for p in profiling.totals()}
    assert {"attn.rope", "attn.masked", "moe.route", "moe.experts",
            "moe.combine"} <= names
    got = profiling.counters()
    routed = spec["routed_rows"]
    assert got["moe.routed_rows"] == int(routed.sum()) > 0
    assert got["moe.routed_rows.l1"] == int(routed[1].sum())
    assert "moe.routed_rows.l0" not in got
    # Every layer's masked attention; on the CPU none took the kernel.
    assert got["attn.masked"] == len(mc.pattern)
    assert "attn.fused" not in got
    # Counted only while a graph is captured: none on the CPU.
    assert "moe.grid_rows" not in got and "moe.grouped_launches" not in got
    profiling.reset()
    assert "moe.routed_rows" not in profiling.counters()


def test_cpu_forward_launches_no_new_kernel():
    cfg = small_config()
    raw, x, mc = _setup(cfg, batch=1)
    tk.reset_launch_counts()
    _port(cfg, raw, mc, x)
    assert set(tk.launch_counts().values()) == {0}


def test_costs_count_the_mask_and_the_routed_rows():
    cfg = ref.published()
    assert ref.pairs(8192, 0) == 8192 * 8193 // 2
    assert ref.pairs(8192, 128) == 128 * 129 // 2 + (8192 - 128) * 128
    costs = ref.costs(cfg, 4)
    ops = {}
    for _, kind, o, _ in costs:
        ops[kind] = ops.get(kind, 0) + o
    # ~1.08 G multiply-accumulates a token, 70.5 T int8 operations a step.
    assert 70e12 < sum(ops.values()) < 71e12
    gemm = [c for c in costs if c[1] == "expert_gemm"]
    assert len(gemm) == 12 and gemm[0][2] == 2 * 8192 * 4096 * 4096


def test_entry_raises_without_a_gpu(monkeypatch):
    from qnnpack_tpu_torch.entry import entry, input_shape
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        entry(model="mimo_v2_flash")
    assert input_shape("mimo_v2_flash") == (8192, 4096)


# ------------------------------------------------------------- on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False): the kernels are CUDA")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_card_attention_kernels_equal_their_plain_forms():
    """q8rope on a full and a window layer's qkv rows at the block's head
    sizes (GQA 16 and 8 to 1) and S = 1,024, against its plain version."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(11)
    b, s, nh, dq, dv = 1, 1024, 64, 192, 128
    for kv in (4, 8):
        width = (nh + kv) * dq + kv * dv
        qkv = torch.randint(0, 256, (b * s, width), generator=gen,
                            dtype=torch.uint8, device=dev)
        c, sn = (torch.from_numpy(t).to(dev)
                 for t in mimo.rope_tables(1e4, s, 64))
        rp = make_requant_params("fp32", 2.0 ** -14, ZP)
        want = q8rope_plain(qkv.cpu(), c.cpu(), sn.cpu(), nh + kv, dq, s, rp)
        q8rope_cuda(qkv, c, sn, nh + kv, dq, s, rp)
        assert torch.equal(qkv[:, :(nh + kv) * dq].cpu(), want)


@pytest.mark.card
@pytest.mark.parametrize("s,heads,kv,window", [
    (1024, 64, 4, 0), (1024, 64, 8, 128), (272, 32, 2, 0), (272, 16, 2, 128),
    (200, 32, 2, 0), (200, 16, 2, 128), (272, 8, 2, 0), (200, 12, 3, 128),
    (257, 4, 1, 0), (257, 4, 1, 128)])
def test_card_fused_attention_equals_its_plain_form(s, heads, kv, window):
    """The fused kernel against its plain version on the card: GQA 16:1
    and 8:1 at the block's head sizes, causal and banded with sinks, at
    sequences that are no multiple of a tile, and 4:1; once on uniform
    bytes (rows that saturate), once on the products' spread.  Two query
    heads a key/value head are refused (a block takes four)."""
    dev = _card()
    gen = torch.Generator().manual_seed(s + heads + window)
    for spread in (False, True):
        q, k, v, sinks, qkv = _attention_inputs(gen, 2, s, heads, kv)
        if not spread:
            for t in (q, k):
                t.copy_(torch.randint(0, 256, t.shape, generator=gen,
                                      dtype=torch.uint8))
        sinks = sinks if window else None
        lut = lut32_tensor(build_softargmax_lut(0.06, window + 1 if window
                                                else s))
        rps = make_requant_params("fp32", 0.003007, ZP)
        rpc = make_requant_params("fp32", 0.0221 if window else 0.0884, ZP)
        want = q8attn_masked_plain(q, k, v, ZP, rps, lut, window, sinks, rpc)
        qc = qkv.to(dev)
        width = qc.shape[-1]
        qd = qc[..., :heads * 192].view(2, s, heads, 192).permute(0, 2, 1, 3)
        kd = qc[..., heads * 192:(heads + kv) * 192].view(
            2, s, kv, 192).permute(0, 2, 3, 1)
        vd = qc[..., (heads + kv) * 192:width].view(2, s, kv, 128).permute(
            0, 2, 1, 3)
        lutd, sinksd = lut.to(dev), None if sinks is None else sinks.to(dev)
        ctx = torch.zeros((2, s, heads * 128), dtype=torch.uint8, device=dev)
        out = ctx.view(2, s, heads, 128).permute(0, 2, 1, 3)
        tk.reset_launch_counts()
        q8attn_masked_cuda(qd, kd, vd, ZP, rps, lutd, window, sinksd, rpc,
                           out=out)
        assert tk.launch_counts()["q8attn_masked"] == 1
        assert torch.equal(out.cpu(), want)
    with pytest.raises(ValueError, match="multiple of 4"):
        q8attn_masked_cuda(qd[:, :2], kd[:, :1], vd[:, :1], ZP, rps, lutd,
                           window, None if sinksd is None else sinksd[:2],
                           rpc)


@pytest.mark.card
def test_card_forward_equals_the_cpu_forward():
    """A b1 forward of the block at the published head sizes (qk 192, v
    128, window 128; 8 query heads over 2 key/value heads, since the
    kernel takes 4 or more a key/value head) on the card, every attention
    on the fused kernel, against the port's CPU forward and the
    reference."""
    dev = _card()
    cfg = small_config(seq=320, heads=(192, 128, 128))
    cfg["swa_num_key_value_heads"] = 2
    raw, x, mc = _setup(cfg, batch=1)
    want = ref.forward(cfg, raw, x)
    y_cpu, _, _ = _port(cfg, raw, mc, x)
    assert torch.equal(y_cpu, want)
    spec = mimo.build_spec(mc, dev)
    params = mimo.pack_layers(raw, mc, dev)
    tk.reset_launch_counts()
    profiling.reset()
    y = mimo.mimo_forward(params, spec, x.to(dev))
    counts = tk.launch_counts()
    assert counts["q8attn_masked"] == len(mc.pattern)
    got = profiling.counters()
    assert got["attn.masked"] == got["attn.fused"] == len(mc.pattern)
    assert torch.equal(y.cpu(), want)


@pytest.mark.card
def test_card_expert_kernels_equal_their_plain_forms():
    """moe_route, q8gemm's grouped instance, q8swiglu and moe_combine at
    the block's widths over 2,048 tokens, each against its plain
    version."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(12)
    t, h, r_n, e, w = 2048, 4096, 256, 8, 2048
    x = torch.randint(0, 256, (t, h), generator=gen, dtype=torch.uint8,
                      device=dev)
    logits = torch.randint(-2**20, 2**20, (t, r_n), generator=gen,
                           dtype=torch.int32, device=dev)
    bias_c = torch.randint(-2**20, 2**20, (r_n,), generator=gen,
                           dtype=torch.int32, device=dev)
    corr = torch.randint(-4, 5, (r_n,), generator=gen, dtype=torch.int32,
                         device=dev)
    lut = torch.from_numpy(mimo.sigmoid_lut(0.05)).to(dev)
    rp = make_requant_params("fp32", 9.13e-5, ZP)
    got = tmoe.moe_route_cuda(logits, bias_c, corr, lut, rp, x, 8, 0, e)
    want = tmoe.moe_route_plain(logits.cpu(), bias_c.cpu(), corr.cpu(),
                                lut.cpu(), rp, x.cpu(), 8, 0, e)
    for name in ("sel", "wts", "slot", "counts"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), \
            name
    live = tmoe.live_rows(want.counts, t)
    assert torch.equal(got.rows.cpu()[live], want.rows[live])
    kernels = torch.randint(0, 256, (e, 2 * w, h), generator=gen,
                            dtype=torch.uint8, device=dev)
    packed = pack_grouped_weights(kernels, ZP, ZP, device=dev)
    rpg = make_requant_params("fp32", 9.13e-5, ZP)
    gu = q8gemm_grouped_cuda(got.rows, packed, got.counts, t, rpg)
    want_gu = q8gemm_grouped_plain(got.rows, packed, got.counts, t, rpg)
    assert torch.equal(gu[live.to(dev)], want_gu[live.to(dev)])
    silu = torch.from_numpy(mimo.silu_lut(0.05)).to(dev)
    rpw = make_requant_params("fp32", 0.05, ZP)
    hh = q8swiglu_cuda(gu, silu, w, ZP, ZP, rpw, got.counts, t)
    want_h = q8swiglu_plain(gu, silu, w, ZP, ZP, rpw, got.counts, t)
    assert torch.equal(hh[live.to(dev)], want_h[live.to(dev)])
    d = torch.randint(0, 256, (e * t, h), generator=gen, dtype=torch.uint8,
                      device=dev)
    rpc = make_requant_params("fp32", 1.0 / 256.0, ZP)
    assert torch.equal(tmoe.moe_combine_cuda(d, got.slot, got.wts, rpc),
                       tmoe.moe_combine_plain(d, got.slot, got.wts, rpc))


def test_live_rows():
    assert tmoe.live_rows(torch.tensor([2, 0, 1]), 3).tolist() == [
        True, True, False, False, False, False, True, False, False]
