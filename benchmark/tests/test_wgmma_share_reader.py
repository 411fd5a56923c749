"""The per-layer metric q8gemm_wgmma_share on known contents of the
program's recorder (qnnpack_tpu_torch.utils.profiling): the share of
q8gemm's counted launches that took the wgmma instance, and no reading
where nothing was counted or the program has no such counters.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import pytest

from benchmark import harness, loops
from qnnpack_tpu_torch.utils import profiling

BENCH = harness.load_benchmark()
NAME = "q8gemm_wgmma_share"


@pytest.fixture
def recorder():
    profiling.reset()
    yield
    profiling.reset()


def _read():
    cell = harness.load_cell(BENCH, BENCH["workloads"][0]["name"])
    window = loops.Window(seconds=1.0, samples=128, steps=1, attempted=128,
                          failed=0)
    view = harness.RunView(cell=cell, setup_s=1.0, window=window, trace=None,
                           costs=[], batch=128, peaks=None)
    return harness.load_reader(NAME)(view)


@pytest.mark.parametrize("launches,wgmma,want", [
    (96, 96, 100.0),   # BERT b128: 48 launches at the warm-up, 48 captured
    (70, 0, 0.0),      # MobileNetV2 b128: none reaches the ridge
    (10, 4, 40.0),
])
def test_share_of_counted_launches(recorder, launches, wgmma, want):
    profiling.count("q8gemm.launches", launches)
    if wgmma:
        profiling.count("q8gemm.wgmma", wgmma)
    assert _read() == pytest.approx(want)


def test_no_reading_without_launches(recorder):
    assert _read() is None
    profiling.count("graph.captures")
    assert _read() is None


def test_no_reading_in_a_program_without_the_recorder(recorder,
                                                      monkeypatch):
    profiling.count("q8gemm.launches", 3)
    monkeypatch.delattr(profiling, "span_total")
    assert _read() is None


def test_listed_for_both_cells():
    entry = next(m for m in BENCH["per_layer"] if m["name"] == NAME)
    assert entry["workloads"] == [w["name"] for w in BENCH["workloads"]]
    assert (entry["layer"], entry["moves"], entry["unit"]) == (
        "CUDA kernels", "samples_per_s", "%")
