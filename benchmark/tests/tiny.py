"""Cells of BENCHMARK.json cut to sizes a CPU test run holds: the same
configurations and loops at tiny widths, batches and rates."""

from __future__ import annotations

import copy

from benchmark import harness

MNV2 = dict(input_size=32, first_layer_channels=8, last_layer_channels=32,
            num_classes=10,
            inverted_residual_setting=[[1, 8, 1, 1], [6, 8, 2, 2],
                                       [6, 16, 2, 1]])
BERT = dict(hidden_size=64, num_attention_heads=2, intermediate_size=128,
            num_hidden_layers=2, seq_len=16)


# The open-arrivals loop has no cell in BENCHMARK.json yet (PERF.md, Open
# questions); its tests run it on MobileNetV2 through a tiny server.
SERVE = "mnv2.open_arrivals"
SERVE_MIX = dict(loop="open_arrivals", rate_per_s=1000,
                 server=dict(max_batch=8, buckets=[1, 2, 4, 8],
                             batch_timeout_s=0.002, max_queue=1024),
                 ring_requests=32, check_requests=32, drain_s=20)


def cell(name: str) -> harness.Cell:
    if name == SERVE:
        c = cell("mnv2.offline_b128")
        c.name, c.traffic = SERVE, "open_arrivals"
        c.mix = copy.deepcopy(SERVE_MIX)
        return c
    c = harness.load_cell(harness.load_benchmark(), name)
    c.cfg = copy.deepcopy(c.cfg)
    c.cfg.update(MNV2 if c.config.startswith("mobilenet") else BERT)
    c.mix = copy.deepcopy(c.mix)
    c.mix.update(batch=4, ring_batches=3)
    return c
