"""MiMo-V2-Flash's hybrid block on the program under test: the port's
model (qnnpack_tpu_torch/models/mimo_v2_flash.py) built at the
configuration's sizes and scales, the benchmark's raw weights packed
through its public packing API."""

from __future__ import annotations

from qnnpack_tpu_torch.models import mimo_v2_flash as mimo


def build(cfg: dict, weights: list, device):
    """(forward, params): forward(params, x) is the block's forward that
    `entry(model="mimo_v2_flash")` returns, params the benchmark's weights
    packed on `device`.  The configuration's zero points and fixed scales
    must be the ones the port hard-codes; its per-product scales reach
    the port and the reference alike."""
    mimo.check_quantization(cfg)
    mc = mimo.config_from_dict(cfg)
    spec = mimo.build_spec(mc, device)
    params = mimo.pack_layers(weights, mc, device)

    def forward(params, x):
        return mimo.mimo_forward(params, spec, x)

    return forward, params
