"""MiMo-V2-Flash's hybrid block, int8 (QNNPACK contract), prefilled.

XiaomiMiMo/MiMo-V2-Flash (config.json on huggingface.co): hidden 4,096;
48 layers in a pattern of full-attention and sliding-window layers, about
1 : 5; 64 query heads of qk size 192 and v size 128, over 4 key/value
heads in full layers and 8 in window layers (window 128, with a learnable
attention sink); partial RoPE on 64 of the 192 dims; a dense SwiGLU layer
0 of width 16,384, then 256 routed SwiGLU experts of width 2,048, 8 a
token, chosen by sigmoid scores with a correction bias (noaux_tc).

Per layer on x [B, S, H], every tensor uint8 with one scale:
  qkv  = fc(x)                          q, k, v as views, no copy
  q, k = rope(q, k)                     dims 0-63 of each head, in place
  ctx  = masked_softargmax(q k^T) v     one fused kernel: causal, or the
                                        128-key band with the head's sink
                                        in max and sum; only the valid
                                        keys of each row
  x    = add(fc_o(ctx), x)
  x    = add(down(swiglu(gate_up(x))), x)            layer 0
  x    = add(combine(experts(dispatch(route(x)))), x)  layers 1-6
The layer is held to tests/reference_mimo.py and the benchmark's
reference/mimo_v2_flash_s8192_qnnpack.py byte for byte.

Every op runs on a kernel of this package on the GPU: q8gemm (the
projections, the dense FFN, the router's int32 logits through its partial
instance), q8rope, the fused masked attention (csrc/q8attn_masked.cu,
kernels/q8bmm.py q8attn_masked_cuda: the scores, the softargmax and the
context in one launch, each score kept in registers, grouped-query
attention read in place: 16 or 8 query heads share a key/value head with
no copy; no [B, H, S, S] tensor is made), q8gemm's grouped instance
(the held experts' gate|up and down in one launch each), q8swiglu,
moe_route and moe_combine (kernels/moe.py), q8vadd.  The routing is read
on the device only, so the whole forward is one CUDA graph
(ops.base.jit_forward).

This device holds experts `first_expert` .. + `experts_held` - 1 of
`router_experts` (expert parallelism): the router scores all of them and
the layer adds the part of each token's result its experts give.  The
spans attn.rope, attn.masked, moe.route, moe.experts and moe.combine
enclose those calls (utils/profiling.py); the counters attn.masked and
attn.fused count the masked-attention calls and those that took the fused
kernel (at an eager call and a capture, never at a replay); the device
counter moe.routed_rows holds the held experts' rows of the last
forward.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.moe import moe_combine_cuda, moe_route_cuda
from ..kernels.q8bmm import q8attn_masked_cuda
from ..kernels.q8gemm import q8gemm_grouped_cuda, q8gemm_partial_cuda
from ..kernels.vpu_ops import q8rope_cuda, q8swiglu_cuda, q8vadd_cuda
from ..nn.elementwise import build_softargmax_lut, lut32_tensor
from ..nn.gemm import q8gemm
from ..nn.packing import pack_gemm_weights, pack_grouped_weights
from ..nn.requant_dispatch import make_requant_params
from ..quant.params import compute_add_quant_params
from ..utils import profiling

ACT_ZP = 128
KERNEL_ZP = 128
PROBS_SCALE = 1.0 / 256.0
PROBS_ZP = 0
ROPE_BITS = 14
COMBINE_SCALE = 1.0 / 256.0
ACT_SCALE = 0.05            # the residual stream, and the SiLU and sigmoid
SOFTMAX_INPUT_SCALE = 0.06  # tables' inputs
# The spread, in steps, of a product's input: the residual stream's
# (uniform uint8) and a product's output's.
STREAM_SIGMA, PRODUCT_SIGMA = 74.0, 24.0
FULL, WINDOW = 0, 1   # hybrid_layer_pattern's codes
# The context's spread over probs x v, by layer kind.
CONTEXT_SPREAD = {FULL: 8.0, WINDOW: 2.0}


@dataclasses.dataclass(frozen=True)
class MimoConfig:
    """The block's sizes; the defaults are the published widths, cut to
    layers 0-6 and one GPU's 8 of 256 experts at sequence 8,192."""
    hidden: int = 4096
    heads: int = 64
    kv_full: int = 4
    kv_window: int = 8
    qk_dim: int = 192
    v_dim: int = 128
    rot_dim: int = 64
    window: int = 128
    theta_full: float = 5e6
    theta_window: float = 1e4
    ffn: int = 16384
    expert_ffn: int = 2048
    router_experts: int = 256
    experts_held: int = 8
    first_expert: int = 0
    top_k: int = 8
    seq_len: int = 8192
    pattern: tuple = (0, 1, 1, 1, 1, 0, 1)
    moe: tuple = (0, 1, 1, 1, 1, 1, 1)
    value_scale: float = 0.707

    def kv_heads(self, layer: int) -> int:
        return self.kv_full if self.pattern[layer] == FULL else self.kv_window

    def qkv_width(self, layer: int) -> int:
        kv = self.kv_heads(layer)
        return (self.heads + kv) * self.qk_dim + kv * self.v_dim


def config_from_dict(cfg: dict) -> MimoConfig:
    """MimoConfig of a configuration in the published config.json's keys
    (the benchmark's configs/mimo_v2_flash_s8192_qnnpack.json)."""
    layers = cfg["num_hidden_layers"]
    return MimoConfig(
        hidden=cfg["hidden_size"], heads=cfg["num_attention_heads"],
        kv_full=cfg["num_key_value_heads"],
        kv_window=cfg["swa_num_key_value_heads"], qk_dim=cfg["head_dim"],
        v_dim=cfg["v_head_dim"],
        rot_dim=int(cfg["head_dim"] * cfg["partial_rotary_factor"]),
        window=cfg["sliding_window"], theta_full=float(cfg["rope_theta"]),
        theta_window=float(cfg["swa_rope_theta"]),
        ffn=cfg["intermediate_size"],
        expert_ffn=cfg["moe_intermediate_size"],
        router_experts=cfg["router_experts"],
        experts_held=cfg["n_routed_experts"],
        first_expert=cfg["expert_parallel"]["rank"] * cfg["n_routed_experts"],
        top_k=cfg["num_experts_per_tok"], seq_len=cfg["seq_len"],
        pattern=tuple(cfg["hybrid_layer_pattern"][:layers]),
        moe=tuple(cfg["moe_layer_freq"][:layers]),
        value_scale=float(cfg["attention_value_scale"]))


def quantization_scales(cfg: MimoConfig) -> dict:
    """Each product's requantization scale and the tables' input scales,
    by their keys in the configuration's `quantization`, from the block's
    widths.  A product of fan-in K whose inputs spread by sigma_in steps
    takes 32 / (74 sigma_in sqrt K), so that no output saturates and the
    router's logits spread over the sigmoid table; the scores take act^2 /
    sqrt(qk_dim) / softmax_input, the context attention_value_scale x
    probs_scale x its spread; all rounded to float32."""
    def fan_in(sigma_in: float, k: int) -> float:
        return float(np.float32(32.0 / (74.0 * sigma_in * math.sqrt(k))))

    h = cfg.hidden
    out = {key: fan_in(STREAM_SIGMA, h) for key in
           ("qkv_scale", "gate_up_scale", "expert_gate_up_scale",
            "router_scale")}
    out.update(
        o_scale=fan_in(PRODUCT_SIGMA, cfg.heads * cfg.v_dim),
        down_scale=fan_in(PRODUCT_SIGMA, cfg.ffn),
        expert_down_scale=fan_in(PRODUCT_SIGMA, cfg.expert_ffn),
        scores_scale=float(np.float32(ACT_SCALE * ACT_SCALE / math.sqrt(
            cfg.qk_dim) / SOFTMAX_INPUT_SCALE)),
        context_full_scale=float(np.float32(
            cfg.value_scale * PROBS_SCALE * CONTEXT_SPREAD[FULL])),
        context_window_scale=float(np.float32(
            cfg.value_scale * PROBS_SCALE * CONTEXT_SPREAD[WINDOW])),
        softmax_input_scale=SOFTMAX_INPUT_SCALE, silu_input_scale=ACT_SCALE,
        swiglu_scale=ACT_SCALE, sigmoid_input_scale=ACT_SCALE)
    return out


def check_quantization(cfg: dict) -> None:
    """Raise unless the configuration's zero points and scales are the
    ones this module builds with: the fixed ones, and each product's from
    the configuration's widths (quantization_scales)."""
    q = cfg["quantization"]
    fixed = {"act_scale": ACT_SCALE, "act_zero_point": ACT_ZP,
             "kernel_zero_point": KERNEL_ZP,
             "probs_scale": PROBS_SCALE, "probs_zero_point": PROBS_ZP,
             "rope_fraction_bits": ROPE_BITS, "rope_scale": 2.0 ** -ROPE_BITS,
             "combine_scale": COMBINE_SCALE, "requant": "fp32"}
    fixed.update(quantization_scales(config_from_dict(cfg)))
    for key, port in fixed.items():
        if q[key] != port:
            raise ValueError(f"{cfg.get('name', 'mimo')}: quantization.{key} "
                             f"is {q[key]}, models/mimo_v2_flash.py builds "
                             f"with {port}")


# ----------------------------------------------------------------- tables
def rope_tables(theta: float, seq: int, rot: int):
    """(C, S) int32 [seq, rot / 2]: rint(2^14 cos(p inv_freq_i)) and
    rint(2^14 sin(p inv_freq_i)), inv_freq_i = theta^(-2 i / rot), in
    float64."""
    i = np.arange(rot // 2, dtype=np.float64)
    ang = np.arange(seq, dtype=np.float64)[:, None] * \
        (float(theta) ** (-2.0 * i / rot))[None, :]
    one = float(1 << ROPE_BITS)
    return (np.rint(one * np.cos(ang)).astype(np.int32),
            np.rint(one * np.sin(ang)).astype(np.int32))


def silu_lut(input_scale: float, zero_point: int = ACT_ZP) -> np.ndarray:
    """uint8 [256]: clamp(rint(silu(s (i - z)) / s) + z, 0, 255), input and
    output at one scale s, float64."""
    x = float(input_scale) * (np.arange(256, dtype=np.float64) - zero_point)
    y = x / (1.0 + np.exp(-x)) / float(input_scale)
    return np.clip(np.rint(y) + zero_point, 0, 255).astype(np.uint8)


def sigmoid_lut(input_scale: float, zero_point: int = ACT_ZP) -> np.ndarray:
    """uint8 [256]: min(255, rint(256 / (1 + exp(-s (i - z))))), the
    router's scores at scale 1/256, zero point 0, float64."""
    x = float(input_scale) * (np.arange(256, dtype=np.float64) - zero_point)
    return np.minimum(255, np.rint(256.0 / (1.0 + np.exp(-x)))).astype(
        np.uint8)


# ----------------------------------------------------------------- weights
def draw_raw_weights(rng: np.random.Generator, cfg: MimoConfig) -> list:
    """Seeded raw weights of every layer (uniform uint8 kernels, the int
    correction bias in [-4, 4], the window sinks in [96, 192)); the layout
    pack_layers takes.  Expert kernels are those of the held experts."""
    def u8(*shape):
        return rng.integers(0, 256, shape, dtype=np.uint8)

    h = cfg.hidden
    layers = []
    for i, kind in enumerate(cfg.pattern):
        layer = {"qkv": u8(cfg.qkv_width(i), h),
                 "o": u8(h, cfg.heads * cfg.v_dim)}
        if kind == WINDOW:
            layer["sink"] = rng.integers(96, 192, cfg.heads).astype(np.uint8)
        if cfg.moe[i]:
            e, w = cfg.experts_held, cfg.expert_ffn
            layer.update(router=u8(cfg.router_experts, h),
                         corr=rng.integers(-4, 5, cfg.router_experts
                                           ).astype(np.int32),
                         gate_up=u8(e, 2 * w, h), down=u8(e, h, w))
        else:
            layer.update(gate_up=u8(2 * cfg.ffn, h), down=u8(h, cfg.ffn))
        layers.append(layer)
    return layers


def pack_layers(raw: list, cfg: MimoConfig, device) -> list:
    """The raw weights (uint8 [N, K] kernels, zero biases; expert kernels
    [E, N, K]) packed on `device`."""
    def fc(kernel):
        return pack_gemm_weights(kernel, None, ACT_ZP, KERNEL_ZP,
                                 device=device)

    def grouped(kernels):
        return pack_grouped_weights(kernels, ACT_ZP, KERNEL_ZP,
                                    device=device)

    out = []
    for i, layer in enumerate(raw):
        p = {"qkv": fc(layer["qkv"]), "o": fc(layer["o"])}
        if cfg.pattern[i] == WINDOW:
            p["sink"] = torch.as_tensor(layer["sink"]).to(device, torch.uint8)
        if cfg.moe[i]:
            p.update(router=fc(layer["router"]),
                     corr=torch.as_tensor(layer["corr"]).to(device,
                                                            torch.int32),
                     gate_up=grouped(layer["gate_up"]),
                     down=grouped(layer["down"]))
        else:
            p.update(gate_up=fc(layer["gate_up"]), down=fc(layer["down"]))
        out.append(p)
    return out


def build_spec(cfg: MimoConfig, device) -> dict:
    """The forward's static spec on `device`: requantization params, the
    RoPE, softargmax, SiLU and sigmoid tables, the add params, and the
    per-layer buffer of the held experts' row counts, which the recorder
    reads as the device counter moe.routed_rows (and .l<layer>)."""
    dev = resolve_device(device)
    s = quantization_scales(cfg)

    def rp(scale, zp=ACT_ZP):
        return make_requant_params("fp32", float(np.float32(scale)), zp)

    def tables(theta):
        c, sn = rope_tables(theta, cfg.seq_len, cfg.rot_dim)
        return (torch.from_numpy(c).to(dev), torch.from_numpy(sn).to(dev))

    routed = torch.zeros((len(cfg.pattern), cfg.experts_held),
                         dtype=torch.int32, device=dev)
    profiling.watch("moe.routed_rows", routed)
    for i, m in enumerate(cfg.moe):
        if m:
            profiling.watch(f"moe.routed_rows.l{i}", routed[i])
    return {
        "cfg": cfg,
        "rp": {name: rp(s[name + "_scale"]) for name in
               ("qkv", "o", "gate_up", "down", "expert_gate_up",
                "expert_down", "router", "scores", "context_full",
                "context_window", "swiglu")},
        "rp_rope": rp(2.0 ** -ROPE_BITS),
        "rp_combine": rp(COMBINE_SCALE),
        "rope": {FULL: tables(cfg.theta_full),
                 WINDOW: tables(cfg.theta_window)},
        "softmax_lut": {
            kind: lut32_tensor(build_softargmax_lut(
                s["softmax_input_scale"], channels), dev)
            for kind, channels in ((FULL, cfg.seq_len),
                                   (WINDOW, cfg.window + 1))},
        "silu_lut": torch.from_numpy(silu_lut(s["silu_input_scale"])).to(
            dev),
        "sigmoid_lut": torch.from_numpy(sigmoid_lut(
            s["sigmoid_input_scale"])).to(dev),
        "add": compute_add_quant_params(ACT_ZP, ACT_ZP, ACT_ZP, 1.0, 1.0),
        "routed_rows": routed,
    }


def build_mimo(rng: np.random.Generator, cfg: MimoConfig | None = None, *,
               device="cuda"):
    """(params, spec): the block with seeded weights, packed on `device`."""
    cfg = cfg or MimoConfig()
    dev = resolve_device(device)
    return pack_layers(draw_raw_weights(rng, cfg), cfg, dev), \
        build_spec(cfg, dev)


# ---------------------------------------------------------------- forward
def attention(p: dict, spec: dict, layer: int, x2, b: int):
    """The attention sub-layer's output o [B S, H] of rows x2 [B S, H]."""
    cfg: MimoConfig = spec["cfg"]
    kind = cfg.pattern[layer]
    s, nh, dq, dv = cfg.seq_len, cfg.heads, cfg.qk_dim, cfg.v_dim
    nkv = cfg.kv_heads(layer)
    window = cfg.window if kind == WINDOW else 0
    qkv = q8gemm(x2, p["qkv"], spec["rp"]["qkv"])          # [B S, Nqkv]
    width = qkv.shape[1]
    with profiling.span("attn.rope"):
        cos, sin = spec["rope"][kind]
        q8rope_cuda(qkv, cos, sin, nh + nkv, dq, s, spec["rp_rope"])
    rows = qkv.view(b, s, width)
    q = rows[..., :nh * dq].view(b, s, nh, dq).permute(0, 2, 1, 3)
    k = rows[..., nh * dq:(nh + nkv) * dq].view(b, s, nkv, dq).permute(
        0, 2, 3, 1)
    v = rows[..., (nh + nkv) * dq:].view(b, s, nkv, dv).permute(0, 2, 1, 3)
    with profiling.span("attn.masked"):
        ctx = torch.empty((b, s, nh * dv), dtype=torch.uint8,
                          device=x2.device)
        q8attn_masked_cuda(
            q, k, v, ACT_ZP, spec["rp"]["scores"], spec["softmax_lut"][kind],
            window, p.get("sink"),
            spec["rp"]["context_window" if kind == WINDOW else
                       "context_full"],
            out=ctx.view(b, s, nh, dv).permute(0, 2, 1, 3))
    # Counted at the eager warm-up and the capture, never at a replay.
    profiling.count("attn.masked")
    if ctx.is_cuda:
        profiling.count("attn.fused")
    return q8gemm(ctx.view(b * s, nh * dv), p["o"], spec["rp"]["o"])


def dense_ffn(p: dict, spec: dict, x2):
    cfg: MimoConfig = spec["cfg"]
    gu = q8gemm(x2, p["gate_up"], spec["rp"]["gate_up"])
    h = q8swiglu_cuda(gu, spec["silu_lut"], cfg.ffn, ACT_ZP, ACT_ZP,
                      spec["rp"]["swiglu"])
    return q8gemm(h, p["down"], spec["rp"]["down"])


def moe_ffn(p: dict, spec: dict, layer: int, x2, combine=moe_combine_cuda):
    """The held experts' part of the expert layer's output [B S, H]."""
    cfg: MimoConfig = spec["cfg"]
    t = x2.shape[0]
    with profiling.span("moe.route"):
        logits = q8gemm_partial_cuda(x2, p["router"])      # int32 [T, R]
        route = moe_route_cuda(logits, p["router"].bias_c, p["corr"],
                               spec["sigmoid_lut"], spec["rp"]["router"], x2,
                               cfg.top_k, cfg.first_expert, cfg.experts_held,
                               counts=spec["routed_rows"][layer])
    with profiling.span("moe.experts"):
        gu = q8gemm_grouped_cuda(route.rows, p["gate_up"], route.counts, t,
                                 spec["rp"]["expert_gate_up"])
        h = q8swiglu_cuda(gu, spec["silu_lut"], cfg.expert_ffn, ACT_ZP,
                          ACT_ZP, spec["rp"]["swiglu"], route.counts, t)
        d = q8gemm_grouped_cuda(h, p["down"], route.counts, t,
                                spec["rp"]["expert_down"])
    with profiling.span("moe.combine"):
        return combine(d, route.slot, route.wts, spec["rp_combine"])


def mimo_forward(params, spec, x_u8):
    """uint8 hidden states [B, S, H] -> uint8 [B, S, H]."""
    cfg: MimoConfig = spec["cfg"]
    b, s, h = x_u8.shape
    if s != cfg.seq_len:
        raise ValueError(f"sequence {s}, the spec's tables are for "
                         f"{cfg.seq_len}")
    x = x_u8.reshape(b * s, h)
    for i, p in enumerate(params):
        x = q8vadd_cuda(attention(p, spec, i, x, b), x, spec["add"])
        y = moe_ffn(p, spec, i, x) if cfg.moe[i] else dense_ffn(p, spec, x)
        x = q8vadd_cuda(y, x, spec["add"])
    return x.view(b, s, h)
