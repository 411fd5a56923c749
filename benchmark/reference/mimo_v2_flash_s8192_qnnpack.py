"""Plain reference of MiMo-V2-Flash's hybrid block in the QNNPACK contract,
as the benchmark runs it.

The widths are the published config.json's (XiaomiMiMo/MiMo-V2-Flash:
hidden 4,096; 64 query heads of qk 192 and v 128 over 4 key/value heads in
full layers and 8 in window layers of 128 keys; partial RoPE on 64 dims; a
dense SwiGLU layer 0 of width 16,384; 256 routed SwiGLU experts of width
2,048, 8 a token by sigmoid scores).  The configuration runs layers 0 to
num_hidden_layers - 1 of its hybrid_layer_pattern and moe_layer_freq, and
holds experts rank * n_routed_experts .. + n_routed_experts - 1 of
router_experts (expert parallelism); the layer equations are those its
file's changed_mechanisms lists.  Per layer, on x [S, H] of one sequence:

    qkv   = fc(x)                        q [nh, S, 192], k [nkv, S, 192],
                                         v [nkv, S, 128]
    q, k  = rope(q, k)                   dims 0-63, pairs (i, i + 32)
    s     = requant(q_h k_{h // (nh / nkv)}^T)
    p     = softargmax over j <= i (full) or i - 127 <= j <= i (window,
            with the head's sink in the max and the sum)
    ctx   = requant(p v)                 attention_value_scale folded in
    x     = add(fc_o(ctx), x)
    x     = add(down(swiglu(gate_up(x))), x)              dense layer
    x     = add(combine over the held experts of the top-8, x)  MoE layer

Integer arithmetic is QNNPACK's (qmath): every product a float64 matmul,
exact here; nothing of the program under test is imported.  TF32 is off.
"""

from __future__ import annotations

import numpy as np
import torch

from . import qmath

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROPE_ONE = 2.0 ** 14


def sample_shape(cfg: dict) -> tuple:
    """Shape of one request: uint8 hidden states [S, H]."""
    return (cfg["seq_len"], cfg["hidden_size"])


def _layers(cfg: dict) -> list:
    """(window?, moe?) of each layer run."""
    n = cfg["num_hidden_layers"]
    return [(bool(w), bool(m)) for w, m in
            zip(cfg["hybrid_layer_pattern"][:n], cfg["moe_layer_freq"][:n])]


def _heads(cfg: dict, window: bool) -> tuple:
    """(query heads, key/value heads, qk size, v size) of a layer kind.
    The published swa_num_attention_heads, swa_head_dim and swa_v_head_dim
    equal the full layers' sizes; only the key/value heads differ."""
    return (cfg["num_attention_heads"],
            cfg["swa_num_key_value_heads" if window else
                "num_key_value_heads"],
            cfg["head_dim"], cfg["v_head_dim"])


def _shapes(cfg: dict, window: bool, moe: bool) -> dict:
    """Each kernel's shape ([N, K], or [E, N, K] for the held experts)."""
    h = cfg["hidden_size"]
    nh, nkv, dq, dv = _heads(cfg, window)
    out = {"qkv": ((nh + nkv) * dq + nkv * dv, h), "o": (h, nh * dv)}
    if moe:
        e, w = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
        out.update(router=(cfg["router_experts"], h),
                   gate_up=(e, 2 * w, h), down=(e, h, w))
    else:
        f = cfg["intermediate_size"]
        out.update(gate_up=(2 * f, h), down=(h, f))
    return out


def draw_weights(cfg: dict, generator: torch.Generator, device) -> list:
    """Seeded raw weights, per layer a dict: uint8 kernels [N, K] (the held
    experts' [E, N, K]) by name, uniform over [0, 256); for a window layer
    `sink`, uint8 [heads] in sink_range; for a MoE layer `corr`, the int32
    correction bias [router_experts] in correction_bias_range.  Biases are
    zero."""
    q = cfg["quantization"]
    out = []
    for window, moe in _layers(cfg):
        layer = {name: torch.randint(0, 256, shape, generator=generator,
                                     dtype=torch.uint8, device=device)
                 for name, shape in _shapes(cfg, window, moe).items()}
        if window:
            lo, hi = q["sink_range"]
            layer["sink"] = torch.randint(
                lo, hi, (_heads(cfg, True)[0],), generator=generator,
                dtype=torch.int32, device=device).to(torch.uint8)
        if moe:
            lo, hi = q["correction_bias_range"]
            layer["corr"] = torch.randint(
                lo, hi + 1, (cfg["router_experts"],), generator=generator,
                dtype=torch.int32, device=device)
        out.append(layer)
    return out


# ----------------------------------------------------------------- tables
def rope_tables(theta: float, seq: int, rot: int, device):
    """int64 C, S [seq, rot / 2]: rint(2^14 cos(p theta^(-2i/rot))) and the
    same with sin, float64."""
    i = np.arange(rot // 2, dtype=np.float64)
    inv = float(theta) ** (-(2.0 * i) / rot)
    ang = np.outer(np.arange(seq, dtype=np.float64), inv)
    return (torch.from_numpy(np.rint(ROPE_ONE * np.cos(ang))).to(
        device, torch.int64),
        torch.from_numpy(np.rint(ROPE_ONE * np.sin(ang))).to(
            device, torch.int64))


def silu_table(scale: float, zp: int, device) -> torch.Tensor:
    """int64 [256]: clamp(rint(silu(scale (i - zp)) / scale) + zp)."""
    x = scale * (np.arange(256, dtype=np.float64) - zp)
    y = np.clip(np.rint(x / (1.0 + np.exp(-x)) / scale) + zp, 0, 255)
    return torch.from_numpy(y.astype(np.int64)).to(device)


def sigmoid_table(scale: float, zp: int, device) -> torch.Tensor:
    """int64 [256]: min(255, rint(256 / (1 + exp(-scale (i - zp)))))."""
    x = scale * (np.arange(256, dtype=np.float64) - zp)
    y = np.minimum(255, np.rint(256.0 / (1.0 + np.exp(-x))))
    return torch.from_numpy(y.astype(np.int64)).to(device)


# ------------------------------------------------------------------ layers
def rope(x_u8: torch.Tensor, c: torch.Tensor, s: torch.Tensor,
         zp: int) -> torch.Tensor:
    """x [heads, S, D] with dims (i, i + R/2), i < R/2, rotated by the
    tables C, S [S, R/2] in fixed point (2^14), the rest as they are."""
    half = c.shape[1]
    a = x_u8[..., :half].to(torch.int64) - zp
    b = x_u8[..., half:2 * half].to(torch.int64) - zp
    y = x_u8.clone()
    y[..., :half] = qmath.requant_fp32(a * c - b * s, 1.0 / ROPE_ONE, zp)
    y[..., half:2 * half] = qmath.requant_fp32(b * c + a * s, 1.0 / ROPE_ONE,
                                               zp)
    return y


def mask(seq: int, window: int, device) -> torch.Tensor:
    """bool [S, S]: query i reads key j (j <= i; and j > i - window)."""
    i = torch.arange(seq, device=device)[:, None]
    j = torch.arange(seq, device=device)[None, :]
    keep = j <= i
    return keep & (j > i - window) if window else keep


def masked_softargmax(x_u8: torch.Tensor, keep: torch.Tensor,
                      table: torch.Tensor, sink=None) -> torch.Tensor:
    """QNNPACK's softargmax over the entries `keep` of each row of
    x [..., S, S] (output scale 1/256, zero point 0; 0 outside), with
    `sink` [...] (or None) one more entry of each row's max and sum that
    gives no output.  Sums and products wrap at 2^32."""
    t = table.to(x_u8.device)
    x = x_u8.to(torch.int64)
    m = torch.where(keep, x, 0).amax(dim=-1, keepdim=True)
    if sink is not None:
        sink = sink.to(torch.int64)[..., None, None]
        m = torch.maximum(m, sink)
    e = torch.where(keep, t[torch.where(keep, x, m) + 255 - m], 0)
    total = e.sum(dim=-1, keepdim=True)
    if sink is not None:
        total = total + t[sink + 255 - m]
    total = total & 0xFFFFFFFF
    num = (e * 256 + (total >> 1)) & 0xFFFFFFFF
    q = torch.where(total == 0, torch.full_like(num, 0xFFFFFFFF),
                    num // total.clamp(min=1))
    return torch.where(keep, q.clamp(max=255), 0).to(torch.uint8)


def _fc(x2, kernel, q, scale, bits):
    w = qmath.round_weights(kernel, q["kernel_zero_point"], bits)
    zeros = torch.zeros(w.shape[0], dtype=torch.int64, device=x2.device)
    return qmath.requant_fp32(
        qmath.gemm_acc(x2, w, q["act_zero_point"], q["kernel_zero_point"],
                       zeros), scale, q["act_zero_point"])


def swiglu(gu_u8: torch.Tensor, width: int, silu: torch.Tensor, q: dict):
    """requant((silu[g] - z) (u - z)) of rows [R, 2 W] = gate | up."""
    zp = q["act_zero_point"]
    g = silu[gu_u8[:, :width].to(torch.int64)] - zp
    u = gu_u8[:, width:].to(torch.int64) - zp
    return qmath.requant_fp32(g * u, q["swiglu_scale"], zp)


def attention(cfg: dict, layer: dict, window: bool, x2: torch.Tensor,
              bits: int, heads_at_once: int = 4) -> torch.Tensor:
    """o [S, H] of one sequence's x [S, H]."""
    q = cfg["quantization"]
    zp = q["act_zero_point"]
    seq = x2.shape[0]
    nh, nkv, dq, dv = _heads(cfg, window)
    rot = int(dq * cfg["partial_rotary_factor"])
    theta = cfg["swa_rope_theta"] if window else cfg["rope_theta"]
    c, s = rope_tables(theta, seq, rot, x2.device)
    qkv = _fc(x2, layer["qkv"], q, q["qkv_scale"], bits)
    qh = rope(qkv[:, :nh * dq].reshape(seq, nh, dq).transpose(0, 1), c, s, zp)
    kh = rope(qkv[:, nh * dq:(nh + nkv) * dq].reshape(seq, nkv, dq)
              .transpose(0, 1), c, s, zp)
    vh = qkv[:, (nh + nkv) * dq:].reshape(seq, nkv, dv).transpose(0, 1)
    w = cfg["sliding_window"] if window else 0
    keep = mask(seq, w, x2.device)
    table = qmath.softargmax_table(q["softmax_input_scale"],
                                   w + 1 if window else seq)
    ctx_scale = q["context_window_scale" if window else "context_full_scale"]
    ctx = torch.empty((nh, seq, dv), dtype=torch.uint8, device=x2.device)
    for h0 in range(0, nh, heads_at_once):
        hs = torch.arange(h0, min(nh, h0 + heads_at_once), device=x2.device)
        kv = hs * nkv // nh
        scores = qmath.requant_fp32(
            qmath.bmm_acc(qh[hs], kh[kv].transpose(1, 2), zp, zp),
            q["scores_scale"], zp)
        probs = masked_softargmax(scores, keep, table,
                                  layer["sink"][hs] if window else None)
        ctx[hs] = qmath.requant_fp32(
            qmath.bmm_acc(probs, vh[kv], q["probs_zero_point"], zp),
            ctx_scale, zp)
    return _fc(ctx.transpose(0, 1).reshape(seq, nh * dv), layer["o"], q,
               q["o_scale"], bits)


def route(cfg: dict, layer: dict, x2: torch.Tensor, bits: int):
    """(sel [T, 8], wts [T, 8]): each token's experts, ordered by
    (sigma + corr, r, lower index), and their weights."""
    q = cfg["quantization"]
    zp, kzp = q["act_zero_point"], q["kernel_zero_point"]
    w = qmath.round_weights(layer["router"], kzp, bits)
    zeros = torch.zeros(w.shape[0], dtype=torch.int64, device=x2.device)
    r = qmath.gemm_acc(x2, w, zp, kzp, zeros)
    sig = sigmoid_table(q["sigmoid_input_scale"], zp, x2.device)[
        qmath.requant_fp32(r, q["router_scale"], zp).to(torch.int64)]
    e = torch.arange(r.shape[1], device=x2.device)
    key = (((sig + layer["corr"].to(torch.int64) + 4) << 41)
           | ((r + 2**31) << 9) | (511 - e))
    sel = key.topk(cfg["num_experts_per_tok"], dim=1).indices
    chosen = sig.gather(1, sel)
    total = chosen.sum(dim=1, keepdim=True)
    wts = torch.where(total > 0, torch.clamp(
        (256 * chosen + total // 2) // total.clamp(min=1), max=255), 32)
    return sel, wts


def moe_acc(cfg: dict, layer: dict, x2: torch.Tensor, first: int,
            bits: int = 8) -> torch.Tensor:
    """int64 [T, H]: sum over each token's chosen experts held here (first
    .. first + len(layer["gate_up"]) - 1) of w_k (d_tk - z), wrapped to
    int32: the held experts' part of the layer's result."""
    q = cfg["quantization"]
    zp = q["act_zero_point"]
    sel, wts = route(cfg, layer, x2, bits)
    silu = silu_table(q["silu_input_scale"], zp, x2.device)
    width = cfg["moe_intermediate_size"]
    acc = torch.zeros(x2.shape, dtype=torch.int64, device=x2.device)
    for e in range(layer["gate_up"].shape[0]):
        tok, k = torch.nonzero(sel == first + e, as_tuple=True)
        if len(tok) == 0:
            continue
        h = swiglu(_fc(x2[tok], layer["gate_up"][e], q,
                       q["expert_gate_up_scale"], bits), width, silu, q)
        d = _fc(h, layer["down"][e], q, q["expert_down_scale"], bits)
        acc.index_add_(0, tok, wts[tok, k][:, None] *
                       (d.to(torch.int64) - zp))
    return qmath.wrap_i32(acc)


def dense_ffn(cfg: dict, layer: dict, x2: torch.Tensor, bits: int):
    q = cfg["quantization"]
    silu = silu_table(q["silu_input_scale"], q["act_zero_point"], x2.device)
    h = swiglu(_fc(x2, layer["gate_up"], q, q["gate_up_scale"], bits),
               cfg["intermediate_size"], silu, q)
    return _fc(h, layer["down"], q, q["down_scale"], bits)


def forward(cfg: dict, weights: list, x_u8: torch.Tensor,
            weight_bits: int = 8) -> torch.Tensor:
    """uint8 [B, S, H] -> uint8 [B, S, H], one sequence at a time.  With
    `weight_bits` < 8 every kernel is first rounded to that many bits
    (the benchmark's lower-precision control)."""
    q = cfg["quantization"]
    zp = q["act_zero_point"]
    add = qmath.add_params(zp, zp, zp, 1.0, 1.0)
    first = cfg["expert_parallel"]["rank"] * cfg["n_routed_experts"]
    out = []
    for x in x_u8:
        for (window, moe), layer in zip(_layers(cfg), weights):
            x = qmath.add_quantize(attention(cfg, layer, window, x,
                                             weight_bits), x, add)
            if moe:
                y = qmath.requant_fp32(
                    moe_acc(cfg, layer, x, first, weight_bits),
                    q["combine_scale"], zp)
            else:
                y = dense_ffn(cfg, layer, x, weight_bits)
            x = qmath.add_quantize(y, x, add)
        out.append(x)
    return torch.stack(out)


# ------------------------------------------------------------------- costs
def pairs(seq: int, window: int) -> int:
    """(query, key) pairs of one head's mask: causal, or banded."""
    if not window:
        return seq * (seq + 1) // 2
    w = min(window, seq)
    return w * (w + 1) // 2 + (seq - w) * w


def expected_rows(cfg: dict, batch: int) -> float:
    """Held experts' rows an expert layer expects at `batch`: tokens x
    top-k x held / router_experts (routing spread evenly)."""
    return (batch * cfg["seq_len"] * cfg["num_experts_per_tok"]
            * cfg["n_routed_experts"] / cfg["router_experts"])


def costs(cfg: dict, batch: int) -> list:
    """Per layer of one forward at `batch`: (name, kind, int8 operations,
    bytes), operations = 2 x multiply-accumulates, bytes = each input read
    once (K and V once a key/value head), the weights once, the output
    written once.  Attention counts only the mask's pairs; the experts
    count expected_rows.  Kinds: gemm (the dense projections and the
    router, on q8gemm), scores, softmax_masked, context, rope, route,
    expert_gemm, swiglu, combine, add."""
    seq, h = cfg["seq_len"], cfg["hidden_size"]
    t = batch * seq
    out = []

    def gemm(name, kind, rows, n, k, out_bytes=1):
        out.append((name, kind, 2 * rows * n * k,
                    int(rows * k + n * k + 4 * n + out_bytes * rows * n)))

    for i, (window, moe) in enumerate(_layers(cfg)):
        nh, nkv, dq, dv = _heads(cfg, window)
        rot = int(dq * cfg["partial_rotary_factor"])
        pr = batch * nh * pairs(seq, cfg["sliding_window"] if window else 0)
        shapes = _shapes(cfg, window, moe)
        gemm(f"l{i}.qkv", "gemm", t, *shapes["qkv"])
        out.append((f"l{i}.rope", "rope", 0,
                    2 * t * (nh + nkv) * rot + 8 * seq * (rot // 2)))
        out.append((f"l{i}.scores", "scores", 2 * pr * dq,
                    t * (nh + nkv) * dq + pr))
        out.append((f"l{i}.softmax", "softmax_masked", 0, 2 * pr))
        out.append((f"l{i}.context", "context", 2 * pr * dv,
                    pr + t * nkv * dv + t * nh * dv))
        gemm(f"l{i}.o", "gemm", t, *shapes["o"])
        out.append((f"l{i}.attn_add", "add", 0, 3 * t * h))
        if moe:
            rows = expected_rows(cfg, batch)
            e, n2, _ = shapes["gate_up"]
            w = n2 // 2
            k = cfg["num_experts_per_tok"]
            r = cfg["router_experts"]
            gemm(f"l{i}.router", "gemm", t, r, h, out_bytes=4)
            out.append((f"l{i}.route", "route", 0,
                        int(4 * t * r + 4 * r + 12 * t * k + 2 * rows * h)))
            out.append((f"l{i}.expert_gate_up", "expert_gemm",
                        int(2 * rows * n2 * h),
                        int(rows * h + e * n2 * h + 4 * e * n2 + rows * n2)))
            out.append((f"l{i}.expert_swiglu", "swiglu", 0,
                        int(rows * n2 + rows * w)))
            out.append((f"l{i}.expert_down", "expert_gemm",
                        int(2 * rows * h * w),
                        int(rows * w + e * h * w + 4 * e * h + rows * h)))
            out.append((f"l{i}.combine", "combine", 0,
                        int(rows * h + t * h + 8 * t * k)))
        else:
            f = cfg["intermediate_size"]
            gemm(f"l{i}.gate_up", "gemm", t, 2 * f, h)
            out.append((f"l{i}.swiglu", "swiglu", 0, 3 * t * f))
            gemm(f"l{i}.down", "gemm", t, h, f)
        out.append((f"l{i}.ffn_add", "add", 0, 3 * t * h))
    return out

