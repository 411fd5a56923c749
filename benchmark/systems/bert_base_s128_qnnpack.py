"""The int8 encoder at BERT-Base's widths on the program under test: the
port's builder gives the spec (requantization and the softargmax table),
and the benchmark's raw weights are packed through the port's public
packing API."""

from __future__ import annotations

import numpy as np

from qnnpack_tpu_torch.models import bert
from qnnpack_tpu_torch.models.bert import (BertConfig, bert_encoder_forward,
                                           build_bert_encoder)
from qnnpack_tpu_torch.nn.packing import pack_gemm_weights

from . import require_port_quantization


def build(cfg: dict, weights: list, device):
    """(forward, params): forward(params, x) is the encoder forward that
    `entry(model="bert_base_s128")` returns, params the benchmark's weights
    packed on `device`.  The spec is built at depth 0, so the port's
    builder draws no weights; the forward runs every layer params holds."""
    # The softargmax's output: scale 1/256, zero point 0 (the port's
    # context requantization and q8bmm call).
    require_port_quantization(cfg, bert, {"probs_scale": 1.0 / 256.0,
                                          "probs_zero_point": 0})
    q = cfg["quantization"]
    _, spec = build_bert_encoder(
        np.random.default_rng(0),
        BertConfig(hidden=cfg["hidden_size"],
                   heads=cfg["num_attention_heads"],
                   ffn=cfg["intermediate_size"], seq_len=cfg["seq_len"],
                   layers=0, requant=q["requant"]), device=device)
    izp, kzp = q["act_zero_point"], q["kernel_zero_point"]
    params = [{name: pack_gemm_weights(kernel, bias, izp, kzp, device=device)
               for name, (kernel, bias) in layer.items()}
              for layer in weights]

    def forward(params, x):
        return bert_encoder_forward(params, spec, x)

    return forward, params
