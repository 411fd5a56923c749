"""The port's recorder of spans and counters (qnnpack_tpu_torch/utils/
profiling.py): nesting, self time and aggregation by path, counters,
reset, threads, the qnnpack:: ranges it opens under torch.profiler (and
only there), and the spans of the set-up code that a CPU run reaches
(weight packing, the kernel library's load)."""

import json
import sys
import threading
import types

import numpy as np
import pytest
import torch

from qnnpack_tpu_torch.kernels import _build
from qnnpack_tpu_torch.nn.conv import pack_conv_weights
from qnnpack_tpu_torch.nn.packing import pack_gemm_weights
from qnnpack_tpu_torch.ops.base import jit_forward
from qnnpack_tpu_torch.utils import profiling


class Clock:
    """A perf_counter_ns that moves only when the test moves it."""

    def __init__(self):
        self.ns = 0

    def perf_counter_ns(self):
        return self.ns

    def advance(self, ms):
        self.ns += int(ms * 1e6)


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(profiling, "time", c)
    return c


def _totals(rec):
    return {p: (t.calls, round(t.total_s * 1e3, 6), round(t.self_s * 1e3, 6))
            for p, t in rec.totals().items()}


def test_spans_nest_with_self_time_by_path(clock):
    rec = profiling.Recorder()
    for _ in range(2):
        with rec.span("outer"):
            clock.advance(1)
            with rec.span("inner"):
                clock.advance(3)
                with rec.span("leaf"):
                    clock.advance(2)
            clock.advance(1)
            with rec.span("inner"):
                clock.advance(4)
    with rec.span("leaf"):
        clock.advance(5)
    # ms: (calls, total, self); outer's self is its 2 ms outside children.
    assert _totals(rec) == {
        "outer": (2, 22.0, 4.0),
        "outer/inner": (4, 18.0, 14.0),
        "outer/inner/leaf": (2, 4.0, 4.0),
        "leaf": (1, 5.0, 5.0),
    }


def test_span_total_takes_outermost_spans_less_nested_ones(clock):
    rec = profiling.Recorder()
    assert rec.span_total("graph.capture") is None
    with rec.span("runtime.call"):
        with rec.span("graph.capture"):
            clock.advance(2)
            with rec.span("library.load"):
                clock.advance(7)
                with rec.span("library.build"):
                    clock.advance(5)
        clock.advance(1)
    with rec.span("graph.capture"):
        clock.advance(3)
        with rec.span("graph.capture"):   # nested in one of its own name
            clock.advance(1)
    calls, s = rec.span_total("graph.capture", ("library.load",))
    assert calls == 2 and s == pytest.approx((14 + 4 - 12) * 1e-3)
    calls, s = rec.span_total("library.load")
    assert calls == 1 and s == pytest.approx(12e-3)
    calls, s = rec.span_total("runtime.call", ("graph.capture",))
    assert calls == 1 and s == pytest.approx(1e-3)
    calls, s = rec.span_total("runtime.call", ("graph.capture",
                                               "library.load"))
    assert calls == 1 and s == pytest.approx(1e-3)   # subtracted once


def test_a_span_that_raises_is_recorded(clock):
    rec = profiling.Recorder()
    with pytest.raises(ValueError):
        with rec.span("a"):
            clock.advance(1)
            with rec.span("b"):
                clock.advance(2)
                raise ValueError
    assert _totals(rec) == {"a": (1, 3.0, 1.0), "a/b": (1, 2.0, 2.0)}
    with rec.span("c"):
        pass
    assert "c" in rec.totals()   # the stack was left empty


def test_counters():
    rec = profiling.Recorder()
    assert rec.counters() == {}
    rec.count("graph.captures")
    rec.count("graph.captures")
    rec.count("n", 5)
    assert rec.counters() == {"graph.captures": 2, "n": 5}
    got = rec.counters()
    got["graph.captures"] = 99   # a copy
    assert rec.counters()["graph.captures"] == 2


def test_reset_clears_spans_and_counters(clock):
    rec = profiling.Recorder()
    with rec.span("outer"):
        clock.advance(1)
        rec.count("n")
        rec.reset()
        with rec.span("inner"):
            clock.advance(1)
    # The span open across the reset is recorded when it ends.
    assert _totals(rec) == {"outer/inner": (1, 1.0, 1.0),
                            "outer": (1, 2.0, 1.0)}
    assert rec.counters() == {}
    rec.reset()
    assert rec.totals() == {} and rec.counters() == {}
    assert rec.span_total("outer") is None


def test_threads_record_at_once_and_lose_nothing():
    rec = profiling.Recorder()
    threads, rounds = 8, 2000
    start = threading.Barrier(threads)

    def work():
        start.wait(timeout=30)
        for _ in range(rounds):
            with rec.span("outer"):
                with rec.span("inner"):
                    rec.count("n")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in pool)
    totals = rec.totals()
    # Each thread nests only its own spans: no path crosses threads.
    assert set(totals) == {"outer", "outer/inner"}
    assert totals["outer"].calls == totals["outer/inner"].calls \
        == threads * rounds
    assert rec.counters() == {"n": threads * rounds}
    assert totals["outer"].total_s >= totals["outer/inner"].total_s


def _ranges(trace_json):
    events = json.loads(trace_json.read_text())["traceEvents"]
    return {e["name"]: e for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"}


def test_spans_are_ranges_inside_the_enclosing_range_under_trace(tmp_path):
    rec = profiling.Recorder()
    with profiling.trace(tmp_path, device="cpu"):
        with torch.profiler.record_function("enclosing"):
            with rec.span("runtime.call"):
                with rec.span("runtime.replay"):
                    torch.ones(64).sum()
    ranges = _ranges(tmp_path / "trace.json")
    outer, call = ranges["enclosing"], ranges["qnnpack::runtime.call"]
    replay = ranges["qnnpack::runtime.replay"]

    def inside(a, b):
        return (b["ts"] <= a["ts"]
                and a["ts"] + a["dur"] <= b["ts"] + b["dur"]
                and a["tid"] == b["tid"])

    assert inside(call, outer) and inside(replay, call)
    # One clock: the recorder's span fits its range in the trace.
    assert rec.totals()["runtime.call"].total_s * 1e6 <= call["dur"] + 1


def test_no_range_is_opened_without_a_profiler(monkeypatch, clock):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    rec = profiling.Recorder()
    with rec.span("a"):
        with rec.span("b"):
            clock.advance(1)
    assert _totals(rec) == {"a": (1, 1.0, 0.0), "a/b": (1, 1.0, 1.0)}


def test_traced_only_spans_record_only_under_a_profiler(tmp_path,
                                                        monkeypatch):
    """A traced_only span (a hot path's detail) records and opens nothing
    with no profiler on; under one it is a span like any other."""
    rec = profiling.Recorder()
    real = torch.profiler.record_function

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with rec.span("runtime.call"):
        with rec.span("runtime.replay", traced_only=True):
            pass
    assert set(rec.totals()) == {"runtime.call"}
    monkeypatch.setattr(torch.profiler, "record_function", real)
    with profiling.trace(tmp_path, device="cpu"):
        with rec.span("runtime.call"):
            with rec.span("runtime.replay", traced_only=True):
                torch.ones(8).sum()
    assert rec.totals()["runtime.call/runtime.replay"].calls == 1
    assert "qnnpack::runtime.replay" in _ranges(tmp_path / "trace.json")


def test_a_childs_range_is_in_no_self_time(monkeypatch, clock):
    """Under a profiler, the time a span spends opening and closing its
    range is left out of its parent's self time (and out of its own)."""

    class Range:
        def __init__(self, name):
            pass

        def __enter__(self):
            clock.advance(10)

        def __exit__(self, *exc):
            clock.advance(20)

    monkeypatch.setattr(profiling, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(torch.profiler, "record_function", Range)
    rec = profiling.Recorder()
    with rec.span("runtime.call"):
        clock.advance(1)
        with rec.span("runtime.clone_out"):
            clock.advance(2)
        clock.advance(1)
    assert _totals(rec) == {"runtime.call": (1, 34.0, 2.0),
                            "runtime.call/runtime.clone_out": (1, 2.0, 2.0)}


def _packs(fn):
    before = profiling.span_total("setup.pack") or (0, 0.0)
    fn()
    return profiling.span_total("setup.pack")[0] - before[0]


def test_pack_gemm_weights_records_one_pack():
    rng = np.random.default_rng(0)
    kernel = rng.integers(0, 256, (16, 24), dtype=np.uint8)
    bias = rng.integers(-100, 100, 16, dtype=np.int32)
    assert _packs(lambda: pack_gemm_weights(
        kernel, bias, 120, 130, device="cpu")) == 1


@pytest.mark.parametrize("groups,transposed", [(1, False), (4, False),
                                               (1, True)])
def test_pack_conv_weights_records_one_pack(groups, transposed):
    rng = np.random.default_rng(1)
    kernel = rng.integers(0, 256, (8, 3, 3, 4), dtype=np.uint8)
    assert _packs(lambda: pack_conv_weights(
        kernel, None, 120, 130, groups, transposed, device="cpu")) == 1


def test_library_load_records_its_build_once(monkeypatch, tmp_path):
    """The first load records library.load with library.build inside it
    when nvcc runs; a loaded library records nothing more."""

    class FakeLib:
        def __init__(self, path):
            self.path = path

        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            self.__dict__[name] = fn
            return fn

    built = []
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build_log", _build.build_log)
    monkeypatch.setattr(_build, "library_path", lambda: tmp_path / "k.so")
    monkeypatch.setattr(_build, "build",
                        lambda path: built.append(path) or "log")
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)

    def seen():
        t = profiling.totals()
        return (t.get("library.load", profiling.SpanTotal(0, 0, 0)).calls,
                t.get("library.load/library.build",
                      profiling.SpanTotal(0, 0, 0)).calls)

    before = seen()
    lib = _build.load_library()
    assert isinstance(lib, FakeLib) and built == [tmp_path / "k.so"]
    assert _build.build_log == "log"
    assert [a - b for a, b in zip(seen(), before)] == [1, 1]
    assert _build.load_library() is lib
    assert [a - b for a, b in zip(seen(), before)] == [1, 1]


def test_cpu_calls_of_a_jit_forward_record_no_replay():
    """On CPU inputs jit_forward runs eagerly: no runtime.call, no key
    walk, no capture."""
    names = ("runtime.call", "runtime.key", "graph.capture")
    before = [profiling.span_total(n) for n in names]
    f = jit_forward(lambda p, x: x + p)
    assert torch.equal(f(1, torch.zeros(3)), torch.ones(3))
    assert [profiling.span_total(n) for n in names] == before
