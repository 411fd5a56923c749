"""Int8 BERT-style encoder: a port of qnnpack_tpu/models/bert.py.

Every op runs on a kernel of this package on the GPU:
  - Q/K/V and output projections and the FFN: q8gemm over prepacked
    weights (the reference's fully-connected path);
  - attention scores and context: q8bmm (activation x activation, the
    zero-point algebra on both sides);
  - attention softmax: u8softargmax, the u8rmax and u8lut32norm kernels;
  - residuals: q8vadd.
There is no head split or merge copy (the JAX code's transposes are XLA
copies): q8bmm reads q, k and v as strided views of the qkv projection's
output (`head_views`) and writes the context straight into its [B, S, H]
buffer through a [B, nh, S, dh] view.

The builder makes the JAX builder's numpy RNG calls in the same order, so
one seed gives the same raw weights.  The 1/sqrt(dh) score scaling folds
into the score requantization scale.  LayerNorm is outside QNNPACK's
operator set and is left out, as in the reference model.  The spec carries
the softargmax table only: the JAX spec's factored form is a TPU lowering.
"""

from __future__ import annotations

import dataclasses
import math
import numpy as np
import torch

from ..device import resolve_device
from ..kernels.vpu_ops import q8vadd_cuda
from ..nn.elementwise import build_softargmax_lut, lut32_tensor, u8softargmax
from ..nn.gemm import q8bmm, q8gemm
from ..nn.packing import PackedGemmWeights, as_tensor, pack_gemm_weights
from ..nn.requant_dispatch import make_requant_params
from ..quant.params import compute_add_quant_params
from .graph import _field

ACT_SCALE = 0.05
ACT_ZP = 128
KERNEL_SCALE = 0.02
KERNEL_ZP = 128
LAYER_WEIGHTS = ("qkv", "out", "ffn1", "ffn2")


@dataclasses.dataclass
class BertConfig:
    hidden: int = 768
    heads: int = 12
    ffn: int = 3072
    seq_len: int = 128
    layers: int = 12
    requant: str = "fp32"

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


def _layer_shapes(cfg: BertConfig) -> dict:
    """(cin, cout) of each weight of a layer."""
    h, f = cfg.hidden, cfg.ffn
    return {"qkv": (h, 3 * h), "out": (h, h), "ffn1": (h, f), "ffn2": (f, h)}


def build_bert_encoder(rng: np.random.Generator, cfg: BertConfig | None = None,
                       *, device="cuda"):
    """(params, spec): synthetic-weights int8 encoder stack, packed on
    `device`; params is a list of {qkv, out, ffn1, ffn2} per layer.  The
    spec's softargmax table is the int32 bits of the uint32 table."""
    cfg = cfg or BertConfig()
    dev = resolve_device(device)

    def fc_weights(cin, cout):
        k = rng.integers(0, 256, (cout, cin), dtype=np.int64).astype(np.uint8)
        b = rng.integers(-8000, 8000, (cout,), dtype=np.int64).astype(np.int32)
        return pack_gemm_weights(k, b, ACT_ZP, KERNEL_ZP, device=dev)

    shapes = _layer_shapes(cfg)
    params = [{name: fc_weights(*shapes[name]) for name in LAYER_WEIGHTS}
              for _ in range(cfg.layers)]

    proj_scale = ACT_SCALE * KERNEL_SCALE / ACT_SCALE
    spec = {
        "cfg": cfg,
        "rp_proj": make_requant_params(cfg.requant, proj_scale, ACT_ZP),
        "rp_relu": make_requant_params(
            cfg.requant, proj_scale, ACT_ZP, ACT_ZP, 255),
        # scores: (a-za)(b-zb) spans +-K*127^2; fold 1/sqrt(dh) and the
        # activation scale into one requant scale targeting the LUT window.
        "rp_scores": make_requant_params(
            cfg.requant,
            float(np.float32(ACT_SCALE * ACT_SCALE
                             / math.sqrt(cfg.head_dim) / ACT_SCALE)),
            ACT_ZP),
        "rp_ctx": make_requant_params(
            cfg.requant, float(np.float32((1.0 / 256.0) * ACT_SCALE
                                          / ACT_SCALE)), ACT_ZP),
        "add": compute_add_quant_params(ACT_ZP, ACT_ZP, ACT_ZP, 1.0, 1.0),
        "softargmax_lut": lut32_tensor(
            build_softargmax_lut(ACT_SCALE, cfg.seq_len), dev),
    }
    return params, spec


def head_views(qkv, b: int, s: int, nh: int, dh: int):
    """q [B, nh, S, dh], k [B, nh, dh, S] and v [B, nh, S, dh] as views of
    the qkv projection's [B * S, 3 H] output (no copy): q and v have dh at
    stride 1 (q8bmm's A, and its N-major B), k has dh, its K axis, at
    stride 1 (q8bmm's K-major B)."""
    qkv = qkv.reshape(b, s, 3, nh, dh)
    return (qkv[:, :, 0].permute(0, 2, 1, 3), qkv[:, :, 1].permute(0, 2, 3, 1),
            qkv[:, :, 2].permute(0, 2, 1, 3))


def bert_encoder_forward(params, spec, x_u8):
    """uint8 [B, S, H] -> uint8 [B, S, H]."""
    cfg: BertConfig = spec["cfg"]
    b, s, h = x_u8.shape
    nh, dh = cfg.heads, cfg.head_dim
    x = x_u8
    for layer in params:
        resid = x
        qkv = q8gemm(x.reshape(b * s, h), layer["qkv"], spec["rp_proj"])
        q, k, v = head_views(qkv, b, s, nh, dh)

        scores = q8bmm(q, k, ACT_ZP, ACT_ZP, spec["rp_scores"])  # [B,nh,S,S]
        probs = u8softargmax(scores, spec["softargmax_lut"])     # scale 1/256
        ctx = torch.empty((b, s, h), dtype=torch.uint8, device=x.device)
        q8bmm(probs, v, 0, ACT_ZP, spec["rp_ctx"],
              out=ctx.view(b, s, nh, dh).permute(0, 2, 1, 3))

        attn = q8gemm(ctx.reshape(b * s, h), layer["out"],
                      spec["rp_proj"]).reshape(b, s, h)
        x = q8vadd_cuda(attn, resid, spec["add"])

        resid2 = x
        y = q8gemm(x.reshape(b * s, h), layer["ffn1"], spec["rp_relu"])
        y = q8gemm(y, layer["ffn2"], spec["rp_proj"]).reshape(b, s, h)
        x = q8vadd_cuda(y, resid2, spec["add"])
    return x


def params_from_jax(arrays, cfg: BertConfig, *, device="cuda"):
    """The port's packed layers from the JAX package's packed BERT params.

    `arrays` is the JAX params list (one mapping per layer of records with
    numpy `w` [K, N] int8 and `bias_folded` [N] int32, as attributes or
    keys)."""
    dev = resolve_device(device)
    if len(arrays) != cfg.layers:
        raise ValueError(f"{len(arrays)} layers for a {cfg.layers}-layer "
                         "config")
    shapes = _layer_shapes(cfg)
    out = []
    for i, layer in enumerate(arrays):
        packed = {}
        for name in LAYER_WEIGHTS:
            cin, cout = shapes[name]
            w = np.asarray(_field(layer[name], "w"))
            bias = np.asarray(_field(layer[name], "bias_folded"))
            if w.shape != (cin, cout) or w.dtype != np.int8:
                raise ValueError(f"layer {i} {name}: w {w.shape} {w.dtype}, "
                                 f"want {(cin, cout)} int8")
            if bias.shape != (cout,) or bias.dtype != np.int32:
                raise ValueError(f"layer {i} {name}: bias_folded "
                                 f"{bias.shape} {bias.dtype}, want "
                                 f"({cout},) int32")
            packed[name] = PackedGemmWeights(
                w=as_tensor(w, torch.int8, dev).contiguous(),
                bias_folded=as_tensor(bias, torch.int32, dev),
                k=cin, n=cout, input_zero_point=ACT_ZP,
                kernel_zero_point=KERNEL_ZP)
        out.append(packed)
    return out
