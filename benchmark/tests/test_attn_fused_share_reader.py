"""The per-layer metric attn_fused_share on known contents of the program's
recorder (qnnpack_tpu_torch.utils.profiling): the share of the counted
masked-attention calls that took the fused kernel, and no reading where
nothing was counted or the program has no such counters.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import pytest

from benchmark import harness, loops
from qnnpack_tpu_torch.utils import profiling

BENCH = harness.load_benchmark()
NAME = "attn_fused_share"


@pytest.fixture
def recorder():
    profiling.reset()
    yield
    profiling.reset()


def _read():
    cell = harness.load_cell(BENCH, "mimo.offline_b4")
    window = loops.Window(seconds=1.0, samples=4, steps=1, attempted=4,
                          failed=0)
    view = harness.RunView(cell=cell, setup_s=1.0, window=window, trace=None,
                           costs=[], batch=4, peaks=None)
    return harness.load_reader(NAME)(view)


@pytest.mark.parametrize("calls,fused,want", [
    (14, 14, 100.0),   # MiMo b4: 7 layers at the warm-up, 7 captured
    (14, 0, 0.0),      # the unfused path
    (8, 2, 25.0),
])
def test_share_of_counted_calls(recorder, calls, fused, want):
    profiling.count("attn.masked", calls)
    if fused:
        profiling.count("attn.fused", fused)
    assert _read() == pytest.approx(want)


def test_no_reading_without_masked_attention(recorder):
    assert _read() is None
    profiling.count("q8gemm.launches", 96)
    assert _read() is None


def test_no_reading_in_a_program_without_the_recorder(recorder,
                                                      monkeypatch):
    profiling.count("attn.masked", 3)
    monkeypatch.delattr(profiling, "span_total")
    assert _read() is None


def test_listed_for_the_mimo_cell():
    entry = next(m for m in BENCH["per_layer"] if m["name"] == NAME)
    assert entry["workloads"] == ["mimo.offline_b4"]
    assert (entry["layer"], entry["moves"], entry["unit"],
            entry["source"]) == ("CUDA kernels", "samples_per_s", "%",
                                 "program_counter")
