"""The per-layer metrics that read the program's own recorder of spans and
counters (qnnpack_tpu_torch.utils.profiling, through benchmark/spans.py):
each on known recorder contents, None where nothing was recorded, and the
set-up split adding up to setup_s.

    python -m pytest benchmark/tests -q

The test marked `card` runs both cells traced on an NVIDIA GPU and skips
without one."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from benchmark import harness, loops, spans
from qnnpack_tpu_torch.utils import profiling

BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
SETUP = ("setup_library_s", "setup_pack_s", "setup_capture_s",
         "setup_outside_s")
READERS = SETUP + ("runtime_host_us.offline", "graph_captures")


class Clock:
    def __init__(self):
        self.ns = 0

    def perf_counter_ns(self):
        return self.ns

    def advance(self, ms):
        self.ns += int(round(ms * 1e6))


@pytest.fixture
def recorder(monkeypatch):
    """The process's recorder, empty, on a clock the test moves."""
    clock = Clock()
    monkeypatch.setattr(profiling, "time", clock)
    profiling.reset()
    yield clock
    profiling.reset()


def _view(setup_s=12.5):
    cell = harness.load_cell(BENCH, CELLS[0])
    window = loops.Window(seconds=1.0, samples=128, steps=1, attempted=128,
                          failed=0)
    return harness.RunView(cell=cell, setup_s=setup_s, window=window,
                           trace=None, costs=[], batch=128, peaks=None)


def _read(view):
    return {m: harness.load_reader(m)(view) for m in READERS}


def _record_a_run(clock, replays=3, wait_ms=1.5):
    """What an offline run records: packs; a first call before the
    profiler starts, which captures (the library loaded and built inside
    the capture) and records no runtime span; then `replays` calls under
    the profiler, each with its key walk before it and its children, the
    input copy waiting `wait_ms` on a full launch queue."""
    span = profiling.span
    for ms in (100, 200, 300):
        with span("setup.pack"):
            clock.advance(ms)
    with span("graph.capture"):
        clock.advance(20)
        with span("library.load"):
            clock.advance(500)
            with span("library.build"):
                clock.advance(1500)
        clock.advance(480)
    profiling.count("graph.captures")
    for _ in range(replays):
        with span("runtime.key"):
            clock.advance(0.02)
        with span("runtime.call"):
            clock.advance(0.004)
            with span("runtime.copy_in"):
                clock.advance(wait_ms)
            with span("runtime.replay"):
                clock.advance(0.04)
            with span("runtime.clone_out"):
                clock.advance(0.01)
            clock.advance(0.006)


def test_readers_on_known_recorder_contents(recorder):
    _record_a_run(recorder)
    got = _read(_view(12.5))
    assert got["setup_library_s"] == pytest.approx(2.0)
    assert got["setup_pack_s"] == pytest.approx(0.6)
    assert got["setup_capture_s"] == pytest.approx(0.5)   # 2.5 less 2.0
    assert got["setup_outside_s"] == pytest.approx(12.5 - 3.1)
    # A call: 0.02 ms key walk, 0.01 ms of its own and 0.01 ms clone.
    assert got["runtime_host_us.offline"] == pytest.approx(40.0)
    assert got["graph_captures"] == 1


@pytest.mark.parametrize("wait_ms", [0.01, 2.4, 8.3])
def test_runtime_host_us_leaves_out_the_launches_that_wait(recorder,
                                                            wait_ms):
    """However long the input copy waits for room in the launch queue
    (a device step at b128), the host's own work a call reads the same."""
    _record_a_run(recorder, wait_ms=wait_ms)
    assert _read(_view())["runtime_host_us.offline"] == pytest.approx(40.0)


def test_runtime_host_us_needs_the_traced_children(recorder):
    """runtime.call with no key walk or clone recorded: no reading."""
    for _ in range(3):
        with profiling.span("runtime.call"):
            recorder.advance(2.4)
    assert _read(_view())["runtime_host_us.offline"] is None


def test_setup_split_adds_up_to_setup_s(recorder):
    _record_a_run(recorder)
    for setup_s in (2.9, 9.04, 47.367):
        got = _read(_view(setup_s))
        assert sum(got[m] for m in SETUP) == pytest.approx(setup_s)
        assert got["setup_outside_s"] == pytest.approx(
            setup_s - got["setup_library_s"] - got["setup_pack_s"]
            - got["setup_capture_s"])


def test_a_library_loaded_inside_a_pack_is_counted_once(recorder):
    with profiling.span("setup.pack"):
        recorder.advance(10)
        with profiling.span("library.load"):
            recorder.advance(30)
    with profiling.span("graph.capture"):
        recorder.advance(5)
    got = _read(_view(1.0))
    assert got["setup_library_s"] == pytest.approx(0.03)
    assert got["setup_pack_s"] == pytest.approx(0.01)
    assert got["setup_capture_s"] == pytest.approx(0.005)
    assert got["setup_outside_s"] == pytest.approx(1.0 - 0.045)


def test_readers_find_nothing_when_nothing_was_recorded(recorder):
    assert _read(_view()) == {m: None for m in READERS}
    # Packs alone (a CPU run: no library, no capture, no replay).
    with profiling.span("setup.pack"):
        recorder.advance(1)
    got = _read(_view())
    assert got["setup_pack_s"] == pytest.approx(1e-3)
    assert {m for m, v in got.items() if v is None} == set(READERS) - {
        "setup_pack_s"}


def test_readers_find_nothing_in_a_program_without_the_recorder(
        monkeypatch):
    """The parent of the recorder: profiling without span_total."""
    monkeypatch.delattr(profiling, "span_total")
    assert spans.span("runtime.call") is None
    assert spans.counter("graph.captures") is None
    assert _read(_view()) == {m: None for m in READERS}


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_traced_on_card_reads_the_spans(name):
    """A short traced run of each cell on the card prints all six metrics;
    the run captured once and its set-up split adds up to its setup_s."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         str(2**31 + 41), "--seconds", "3", "--trace", "1"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(READERS) <= set(metrics), sorted(metrics)
    assert metrics["graph_captures"] == 1
    assert metrics["runtime_host_us.offline"] > 0
    assert sum(metrics[m] for m in SETUP) == pytest.approx(
        result["window"]["setup_s"], rel=1e-9)
