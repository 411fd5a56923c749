"""Plain reference of the int8 QNNPACK-contract encoder at BERT-Base's
widths, as the benchmark runs it.

The widths and depth are BERT-Base's (Devlin et al., arXiv:1810.04805;
google-research/bert BERT-Base: L 12, H 768, A 12, FFN 3072) at the
configuration's sequence length; the layer is not BERT's but the one its
file's `changed_mechanisms` lists: the input is uint8 hidden states (no
embeddings, no pooler), no LayerNorm, ReLU for GELU, and softmax as
QNNPACK's softargmax.  Per layer:

    qkv   = fc(x)                       [S, 3H], then q, k, v per head
    p     = softargmax(q k^T, requantized with 1/sqrt(d_head))
    ctx   = p v                         (p at scale 1/256, zero point 0)
    x     = add(fc_out(ctx), x)
    x     = add(fc_2(relu(fc_1(x))), x)

Each product is QNNPACK's quantized operator in plain integer arithmetic
(qmath); nothing of the program under test is imported.
"""

from __future__ import annotations

import math

import torch

from . import qmath

WEIGHTS = ("qkv", "out", "ffn1", "ffn2")


def sample_shape(cfg: dict) -> tuple:
    """Shape of one request: uint8 hidden states [S, H]."""
    return (cfg["seq_len"], cfg["hidden_size"])


def _shapes(cfg: dict) -> dict:
    """(output, input) features of each weight of a layer."""
    h, f = cfg["hidden_size"], cfg["intermediate_size"]
    return {"qkv": (3 * h, h), "out": (h, h), "ffn1": (f, h), "ffn2": (h, f)}


def draw_weights(cfg: dict, generator: torch.Generator, device) -> list:
    """Seeded raw weights: per layer a dict of (uint8 kernel [N, K], int32
    bias [N]) by name.  Two draws in all (every kernel, then every bias),
    uniform over [0, 256) and the configuration's bias range."""
    shapes = _shapes(cfg)
    layers = cfg["num_hidden_layers"]
    per_k = sum(n * k for n, k in shapes.values())
    per_b = sum(n for n, _ in shapes.values())
    lo, hi = cfg["quantization"]["bias_range"]
    kernels = torch.randint(0, 256, (layers * per_k,), generator=generator,
                            dtype=torch.uint8, device=device)
    biases = torch.randint(lo, hi, (layers * per_b,), generator=generator,
                           dtype=torch.int32, device=device)
    out, k_at, b_at = [], 0, 0
    for _ in range(layers):
        layer = {}
        for name in WEIGHTS:
            n, k = shapes[name]
            layer[name] = (kernels[k_at:k_at + n * k].view(n, k),
                           biases[b_at:b_at + n])
            k_at += n * k
            b_at += n
        out.append(layer)
    return out


def forward(cfg: dict, weights: list, x_u8: torch.Tensor,
            weight_bits: int = 8) -> torch.Tensor:
    """uint8 [B, S, H] -> uint8 [B, S, H].  With `weight_bits` < 8 every
    kernel is first rounded to that many bits (the benchmark's
    lower-precision control)."""
    q = cfg["quantization"]
    zp, kzp = q["act_zero_point"], q["kernel_zero_point"]
    act, ker = q["act_scale"], q["kernel_scale"]
    p_scale, p_zp = q["probs_scale"], q["probs_zero_point"]
    b, s, h = x_u8.shape
    nh = cfg["num_attention_heads"]
    dh = h // nh
    proj = act * ker / act
    scores_scale = act * act / math.sqrt(dh) / act
    ctx_scale = p_scale * act / act
    add = qmath.add_params(zp, zp, zp, 1.0, 1.0)
    table = qmath.softargmax_table(act, s)

    def fc(x2, wb, lo=0):
        w = qmath.round_weights(wb[0], kzp, weight_bits)
        return qmath.requant_fp32(qmath.gemm_acc(x2, w, zp, kzp, wb[1]),
                                  proj, zp, lo, 255)

    x = x_u8
    for layer in weights:
        qkv = fc(x.reshape(b * s, h), layer["qkv"]).reshape(b, s, 3, nh, dh)
        qh = qkv[:, :, 0].permute(0, 2, 1, 3)
        kh = qkv[:, :, 1].permute(0, 2, 3, 1)
        vh = qkv[:, :, 2].permute(0, 2, 1, 3)
        scores = qmath.requant_fp32(qmath.bmm_acc(qh, kh, zp, zp),
                                    scores_scale, zp)
        probs = qmath.softargmax(scores, table)
        ctx = qmath.requant_fp32(qmath.bmm_acc(probs, vh, p_zp, zp),
                                 ctx_scale, zp)
        ctx = ctx.permute(0, 2, 1, 3).reshape(b * s, h)
        attn = fc(ctx, layer["out"]).reshape(b, s, h)
        x = qmath.add_quantize(attn, x, add)
        y = fc(x.reshape(b * s, h), layer["ffn1"], lo=zp)
        y = fc(y, layer["ffn2"]).reshape(b, s, h)
        x = qmath.add_quantize(y, x, add)
    return x


def costs(cfg: dict, batch: int) -> list:
    """Per layer of one forward at `batch`: (name, kind, int8 operations,
    bytes), operations = 2 x multiply-accumulates, bytes = each input read
    once, the weights and biases once, the output written once."""
    s, h = cfg["seq_len"], cfg["hidden_size"]
    nh = cfg["num_attention_heads"]
    dh = h // nh
    rows = batch * s
    out = []
    for i in range(cfg["num_hidden_layers"]):
        for name, (n, k) in _shapes(cfg).items():
            out.append((f"l{i}.{name}", "gemm", 2 * rows * n * k,
                        rows * k + n * k + 4 * n + rows * n))
            if name == "qkv":
                heads = batch * nh
                out.append((f"l{i}.scores", "bmm", 2 * heads * s * s * dh,
                            2 * rows * h + heads * s * s))
                out.append((f"l{i}.softargmax", "softmax", 0,
                            2 * heads * s * s))
                out.append((f"l{i}.context", "bmm", 2 * heads * s * s * dh,
                            heads * s * s + 2 * rows * h))
            if name in ("out", "ffn2"):
                out.append((f"l{i}.{name}_add", "add", 0, 3 * rows * h))
    return out
