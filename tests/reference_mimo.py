"""The plain reference of MiMo-V2-Flash's hybrid block for the port's CPU
tests: the benchmark's plain reference
(benchmark/reference/mimo_v2_flash_s8192_qnnpack.py, plain PyTorch with
float64 matmuls and TF32 off, which imports nothing of the port or of the
JAX package), and the benchmark's configuration of the block, which the
tests cut to their sizes (test_torch_mimo.py small_config)."""

from __future__ import annotations

import json
from pathlib import Path

from benchmark.reference import qmath  # noqa: F401  (the arithmetic)
from benchmark.reference.mimo_v2_flash_s8192_qnnpack import (  # noqa: F401
    attention, costs, dense_ffn, draw_weights, expected_rows, forward, mask,
    masked_softargmax, moe_acc, pairs, rope, rope_tables, route,
    sample_shape, sigmoid_table, silu_table, swiglu)

CONFIG = Path(__file__).resolve().parents[1] / "benchmark" / "configs" / \
    "mimo_v2_flash_s8192_qnnpack.json"


def published() -> dict:
    """The benchmark's configuration of the block, as run."""
    with open(CONFIG) as f:
        return json.load(f)
