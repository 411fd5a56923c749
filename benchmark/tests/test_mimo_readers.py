"""The four per-layer metrics of the MiMo-V2-Flash cell on known traces and
recorder contents: attn_roofline.offline, glue_roofline.offline and
moe_gemm_roofline.offline (kernel time against the costs of their kinds),
moe_grid_fill (the program's counters); each gives no reading where the
trace holds none of its kernels or the program has none of its counters,
as a program without the expert layer has not.  Also the configuration's
counts.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import harness, loops, trace
from benchmark.reference import mimo_v2_flash_s8192_qnnpack as ref
from qnnpack_tpu_torch.utils import profiling

BENCH = harness.load_benchmark()
CELL = "mimo.offline_b4"
PEAKS = json.loads((harness.HERE / "peaks.json").read_text())[
    "NVIDIA H100 80GB HBM3"]


@pytest.fixture
def recorder():
    profiling.reset()
    yield
    profiling.reset()


def _view(kernel_s, steps=10):
    cell = harness.load_cell(BENCH, CELL)
    window = loops.Window(seconds=1.0, samples=4 * steps, steps=steps,
                          attempted=4 * steps, failed=0)
    s = None if kernel_s is None else trace.TraceSummary(
        window_s=1.0, busy_s=0.99, device_s=dict(kernel_s),
        kernel_s=dict(kernel_s), idle_gaps={})
    return harness.RunView(cell=cell, setup_s=20.0, window=window, trace=s,
                           costs=ref.costs(cell.cfg, 4), batch=4,
                           peaks=PEAKS)


def _bound(costs, kinds, scale=1.0):
    return sum(max(o * scale / PEAKS["int8_ops_per_s"],
                   b / PEAKS["bytes_per_s"])
               for _, k, o, b in costs if k in kinds)


def test_attention_and_glue_rooflines_on_known_times():
    v = _view({"q8bmm_masked_kernel": 0.3, "u8softmax_masked_kernel": 0.1,
               "q8rope_kernel": 0.01, "moe_route_kernel": 0.002,
               "moe_dispatch_kernel": 0.003, "q8swiglu_kernel": 0.01,
               "moe_combine_kernel": 0.005, "q8gemm_kernel": 0.5})
    attn = _bound(v.costs, ("scores", "softmax_masked", "context"))
    glue = _bound(v.costs, ("rope", "route", "swiglu", "combine"))
    read = harness.load_reader
    assert read("attn_roofline.offline")(v) == pytest.approx(
        100 * attn / 0.04)
    assert read("glue_roofline.offline")(v) == pytest.approx(
        100 * glue / 0.003)
    # The masked products count only the mask's pairs: a full layer's
    # scores are about half of a square product's operations.
    full = [c for c in v.costs if c[0] == "l0.scores"][0]
    assert full[2] == 2 * 4 * 64 * (8192 * 8193 // 2) * 192


def test_moe_gemm_roofline_follows_the_routed_rows(recorder):
    v = _view({"q8gemm_grouped_kernel": 0.2})
    read = harness.load_reader("moe_gemm_roofline.offline")
    assert read(v) is None                    # no counter: no reading
    routed = torch.full((7, 8), 1024, dtype=torch.int32)
    routed[0] = 0                             # the dense layer
    profiling.watch("moe.routed_rows", routed)
    at_expected = _bound(v.costs, ("expert_gemm",))
    assert read(v) == pytest.approx(100 * at_expected / 0.02)
    routed[1:] = 1536                         # 1.5x the expected rows
    assert read(v) == pytest.approx(
        100 * _bound(v.costs, ("expert_gemm",), 1.5) / 0.02)
    assert read(_view({"q8gemm_kernel": 0.2})) is None


def test_grid_fill_from_the_counters(recorder):
    read = harness.load_reader("moe_grid_fill")
    v = _view(None)
    assert read(v) is None
    profiling.watch("moe.routed_rows", torch.tensor([8192 * 6]))
    profiling.count("moe.grid_rows", 6 * 8 * 32768)
    assert read(v) is None                    # no capture counted
    profiling.count("graph.captures")
    assert read(v) == pytest.approx(100 * 8192 * 6 / (6 * 8 * 32768))
    profiling.count("graph.captures")         # a second capture
    profiling.count("moe.grid_rows", 6 * 8 * 32768)
    assert read(v) == pytest.approx(100 * 8192 * 6 / (6 * 8 * 32768))


def test_readers_find_nothing_without_their_kernels(recorder):
    v = _view({"q8gemm_kernel": 0.5, "q8bmm_kernel": 0.1})
    for m in ("attn_roofline.offline", "glue_roofline.offline",
              "moe_gemm_roofline.offline", "moe_grid_fill"):
        assert harness.load_reader(m)(v) is None
    for m in ("attn_roofline.offline", "glue_roofline.offline"):
        assert harness.load_reader(m)(_view(None)) is None


def test_mimo_counts():
    """About 1.08 G multiply-accumulates a token at b4: the linears, the
    router, masked attention and the held experts at their expected
    rows."""
    cfg = harness.load_cell(BENCH, CELL).cfg
    costs = ref.costs(cfg, 4)
    macs = sum(c[2] for c in costs) // 2
    assert 1.07e9 < macs / (4 * 8192) < 1.08e9
    assert ref.expected_rows(cfg, 4) == 8192
    kinds = {c[1] for c in costs}
    assert kinds == {"gemm", "rope", "scores", "softmax_masked", "context",
                     "add", "swiglu", "route", "expert_gemm", "combine"}


def test_new_metrics_list_only_the_new_cell():
    new = ("attn_roofline.offline", "moe_gemm_roofline.offline",
           "moe_grid_fill", "glue_roofline.offline")
    for m in BENCH["per_layer"]:
        if m["name"] in new:
            assert m["workloads"] == [CELL]
            assert (m["layer"], m["moves"], m["unit"]) == (
                "CUDA kernels", "samples_per_s", "%")
