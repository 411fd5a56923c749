"""CPU tests of the benchmark harness: BENCHMARK.json against its contract,
the counts the rooflines divide by, the arrival schedule, the trace
reduction and the metric readers, the plain references against the
program's CPU path, and the check catching a broken program.

    python -m pytest benchmark/tests -q

Tests marked `card` run a cell on an NVIDIA GPU and skip without one."""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import harness, loops, schedule, trace
from benchmark.reference import bert_base_s128_qnnpack, mobilenet_v2_224
from benchmark.tests import tiny

BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


# ---------------------------------------------------------------- contract
def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    assert len(CELLS) == len(set(CELLS))
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    """Each cell finds its configuration, mix, reference, system and the
    reader of every metric it reports; each reports setup_s, another
    end-to-end metric and a per-layer metric."""
    cell = harness.load_cell(BENCH, name)
    assert (harness.HERE / "reference" / f"{cell.config}.py").is_file()
    assert (harness.HERE / "systems" / f"{cell.config}.py").is_file()
    assert cell.mix["loop"] in loops.LOOPS
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.load_reader(m["name"]))
    for m in cell.per_layer:
        assert m["moves"] in e2e


def test_every_configuration_is_used_and_states_its_cuts():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        with open(harness.ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert c["file"].startswith(BENCH["paths"][0] + "/")


# ------------------------------------------------------------------ counts
def _cfg(name):
    with open(harness.HERE / "configs" / f"{name}.json") as f:
        return json.load(f)


def test_mobilenet_v2_counts():
    """About 300 M multiply-accumulates an image (the paper's 300 M):
    52 conv layers and the classifier, 35 of them on q8gemm."""
    costs = mobilenet_v2_224.costs(_cfg("mobilenet_v2_224"), 1)
    assert sum(c[2] for c in costs) // 2 == 300_774_272
    assert sum(c[1] == "gemm" for c in costs) == 35
    assert sum(c[1] in ("conv", "dwconv", "gemm") for c in costs) == 53
    # The stem by hand: 112 x 112 outputs x 32 channels x 27 taps.
    stem = costs[0]
    assert stem[2] == 2 * 112 * 112 * 32 * 27
    assert stem[3] == 224 * 224 * 3 + 32 * 27 + 4 * 32 + 112 * 112 * 32


def test_bert_counts():
    """11.17 G multiply-accumulates a sequence: per layer 128 x 768 x
    (2304 + 768 + 2 x 3072) in the linears and 2 x 12 x 128 x 128 x 64 in
    attention."""
    costs = bert_base_s128_qnnpack.costs(_cfg("bert_base_s128_qnnpack"), 1)
    assert sum(c[2] for c in costs) // 2 == 11_173_625_856
    per_layer = 128 * 768 * (2304 + 768 + 2 * 3072) + 2 * 12 * 128 * 128 * 64
    assert per_layer * 12 == 11_173_625_856
    qkv = costs[0]
    assert qkv[3] == 128 * 768 + 768 * 2304 + 4 * 2304 + 128 * 2304
    # Weights are read once a forward, so the bytes grow less than 128x.
    big = bert_base_s128_qnnpack.costs(_cfg("bert_base_s128_qnnpack"), 128)
    assert sum(c[3] for c in big) < 128 * sum(c[3] for c in costs)


# ---------------------------------------------------------------- schedule
def test_arrivals_reproducible_and_at_the_rate():
    mix = {"rate_per_s": 5000}
    a = schedule.arrivals(mix, 10.0, 2**31 + 11)
    b = schedule.arrivals(mix, 10.0, 2**31 + 11)
    c = schedule.arrivals(mix, 10.0, 2**31 + 12)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert len(a) == len(c) == 50_000
    assert np.all(np.diff(a) >= 0) and 0 < a[0] and a[-1] <= 10.0 + 1e-9
    # Every seed gets the same gaps in another order.
    np.testing.assert_allclose(np.sort(np.diff(a, prepend=0.0)),
                               np.sort(np.diff(c, prepend=0.0)),
                               rtol=1e-6, atol=1e-12)
    gaps = np.diff(a)
    assert abs(gaps.mean() - 1 / 5000) < 1e-6
    assert abs(gaps.std() / gaps.mean() - 1.0) < 0.02   # exponential


def test_sub_seeds_take_large_and_negative_seeds():
    seeds = {schedule.sub_seed(s, "weights")
             for s in (0, 1, 2**31 + 5, 2**33, -7)}
    assert len(seeds) == 5 and all(0 <= s < 2**63 for s in seeds)


# ------------------------------------------------------------------- trace
def _events():
    """A synthetic Chrome trace: a 100 us window; a graph launch at 5 us
    running kernels 10-40 and 40-60 (a q8gemm and a q8dwconv), a copy
    from 55 to 70 overlapping the second, and a kernel 90-120 that ends
    past the window."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window",
         "ts": 1000.0, "dur": 100.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "bench.window",
         "ts": 1000.0, "dur": 100.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
         "ts": 1005.0, "dur": 2.0, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
         "ts": 1050.0, "dur": 2.0, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel",
         "name": "(anonymous namespace)::q8gemm_kernel<qnn::imma::Tile<128,"
                 " 64, 4, 1, 3, 64, 4>, 16, 0, (anonymous namespace)::"
                 "GemmArgs>((anonymous namespace)::GemmArgs)",
         "ts": 1010.0, "dur": 30.0, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel",
         "name": "void (anonymous namespace)::dw3x3_kernel<4, 1>(Args)",
         "ts": 1040.0, "dur": 20.0, "args": {"correlation": 1}},
        {"ph": "X", "cat": "gpu_memcpy",
         "name": "Memcpy DtoD (Device -> Device)", "ts": 1055.0,
         "dur": 15.0, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel",
         "name": "void q8gemm_kernel<Tile<128, 64>, true>(Params)",
         "ts": 1090.0, "dur": 30.0, "args": {"correlation": 3}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 1049.0,
         "dur": 5.0},
    ]
    return ev


def test_trace_summary_of_known_events():
    s = trace.summarize(_events())
    assert s.window_s == pytest.approx(100e-6)
    # busy: [10, 70] and [90, 100] -> 70 us.
    assert s.busy_s == pytest.approx(70e-6)
    assert s.kernel_s == pytest.approx({"q8gemm_kernel": 40e-6,
                                        "dw3x3_kernel": 20e-6})
    assert s.device_s["Memcpy DtoD (Device -> Device)"] == pytest.approx(
        15e-6)
    assert s.idle_gaps == pytest.approx({
        "cudaGraphLaunch -> q8gemm_kernel": 10e-6,
        "host -> q8gemm_kernel": 20e-6})
    assert s.top(s.device_s, 1) == [["q8gemm_kernel", pytest.approx(40e-6)]]


def test_trace_needs_its_window():
    with pytest.raises(ValueError):
        trace.summarize([e for e in _events()
                         if e["cat"] != "user_annotation"])


def _view(name, trace_summary, steps=10, seconds=1.0, stats=None,
          latencies=None):
    cell = harness.load_cell(BENCH, name)
    ref = mobilenet_v2_224 if cell.config.startswith("mobilenet") \
        else bert_base_s128_qnnpack
    batch = cell.mix.get("batch", 1)
    window = loops.Window(seconds=seconds, samples=steps * batch,
                          steps=steps, attempted=steps * batch, failed=0,
                          latencies_ms=latencies, stats=stats)
    peaks = json.loads((harness.HERE / "peaks.json").read_text())
    return harness.RunView(cell=cell, setup_s=12.5, window=window,
                           trace=trace_summary,
                           costs=ref.costs(cell.cfg, batch), batch=batch,
                           peaks=peaks["NVIDIA H100 80GB HBM3"])


def test_metric_readers_on_known_numbers():
    s = trace.TraceSummary(window_s=1.0, busy_s=0.95,
                           device_s={"q8gemm_kernel": 0.6},
                           kernel_s={"q8gemm_kernel": 0.6,
                                     "dw3x3_kernel": 0.3},
                           idle_gaps={})
    v = _view("mnv2.offline_b128", s, steps=400)
    read = harness.load_reader
    assert read("idle_share.offline")(v) == pytest.approx(5.0)
    assert read("setup_s")(v) == 12.5
    assert read("samples_per_s")(v) == pytest.approx(51_200.0)
    ops = 2 * 300_774_272 * 128 * 400
    assert read("mfu.offline")(v) == pytest.approx(100 * ops / 1.979e15)
    # 0.9 s of kernels over 400 forwards: 2.25 ms a forward against the
    # 0.542 ms bound; q8gemm 1.5 ms against 0.263.
    assert read("roofline.offline")(v) == pytest.approx(
        100 * 0.5420756 / 2.25, rel=1e-6)
    assert read("q8gemm_roofline.offline")(v) == pytest.approx(
        100 * 0.2628105 / 1.5, rel=1e-6)


def test_readers_find_nothing_without_a_trace_or_kernel():
    read = harness.load_reader
    v = _view("mnv2.offline_b128", None)
    for m in ("idle_share.offline", "roofline.offline",
              "q8gemm_roofline.offline"):
        assert read(m)(v) is None
    s = trace.TraceSummary(window_s=1.0, busy_s=0.5, device_s={},
                           kernel_s={"dw3x3_kernel": 0.3}, idle_gaps={})
    assert read("q8gemm_roofline.offline")(_view("mnv2.offline_b128",
                                                 s)) is None


# ---------------------------------------------- references and the program
@pytest.mark.parametrize("config", ["mobilenet_v2_224",
                                    "bert_base_s128_qnnpack"])
def test_a_scale_the_port_does_not_build_with_fails_set_up(config):
    """The port's builders take widths only: a configuration whose scale
    differs from the port's is refused at set-up, naming the key."""
    import importlib
    system = importlib.import_module(f"benchmark.systems.{config}")
    cfg = _cfg(config)
    cfg["quantization"]["act_scale"] *= 2
    with pytest.raises(ValueError, match="quantization.act_scale"):
        system.build(cfg, [], "cpu")


@pytest.mark.parametrize("name", CELLS + [tiny.SERVE])
def test_reference_equals_program_on_cpu(name):
    """A whole run at a tiny size on the CPU, the program on its plain
    path: the window's outputs equal the reference, byte for byte."""
    cell = tiny.cell(name)
    result, lines = harness.run_cell(cell, 2**31 + 3, 0.4, False,
                                     torch.device("cpu"),
                                     time.perf_counter())
    assert result["correct"], result["checks"]
    assert result["checks"]["compared_samples"]["value"] >= 8
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert lines[0] == "check mismatched_bytes 0 limit 0"


@pytest.mark.parametrize("config", ["mobilenet_v2_224",
                                    "bert_base_s128_qnnpack"])
def test_control_fails_the_check(config):
    """The control, the reference with 4-bit kernels in the program's
    place, differs from the reference: the exact comparison fails it."""
    cell = tiny.cell("mnv2.offline_b128" if config.startswith("mobilenet")
                     else "bert.offline_b128")
    ref = mobilenet_v2_224 if config.startswith("mobilenet") \
        else bert_base_s128_qnnpack
    gen = torch.Generator().manual_seed(3)
    weights = ref.draw_weights(cell.cfg, gen, "cpu")
    x = torch.randint(0, 256, (8,) + ref.sample_shape(cell.cfg),
                      generator=gen, dtype=torch.uint8)
    control = ref.forward(cell.cfg, weights, x,
                          cell.cfg["control_weight_bits"])
    assert harness.compare(ref, cell.cfg, weights, x, control, "cpu") > 0
    assert harness.compare(ref, cell.cfg, weights, x,
                           ref.forward(cell.cfg, weights, x), "cpu") == 0


def _altered(forward):
    """An answer altered where it is produced: one byte of each output."""
    def run(params, x):
        y = forward(params, x).clone()
        y.view(-1)[0] ^= 1
        return y
    return run


def _half_batch(forward):
    """Half of the batch left out: the rest computed, the left-out rows
    filled with their mean."""
    def run(params, x):
        n = (x.shape[0] + 1) // 2
        y = forward(params, x[:n])
        fill = y.float().mean(dim=0).round().to(torch.uint8)
        return torch.cat([y, fill.expand(x.shape[0] - n, *y.shape[1:])])
    return run


def _stale(forward):
    """A step that returns its state unchanged: every call after the first
    at a shape returns that first call's output."""
    first = {}

    def run(params, x):
        if x.shape not in first:
            first[x.shape] = forward(params, x)
        return first[x.shape].clone()
    return run


@pytest.mark.parametrize("fault", [_altered, _half_batch, _stale])
@pytest.mark.parametrize("name", ["mnv2.offline_b128", "bert.offline_b128",
                                  tiny.SERVE])
def test_broken_program_is_not_correct(name, fault):
    """The rest of a run with the timed path broken underneath: `correct`
    comes out false for each fault a one-chip inference cell can have."""
    result, lines = harness.run_cell(tiny.cell(name), 2**31 + 17, 0.4,
                                     False, torch.device("cpu"),
                                     time.perf_counter(), wrap_forward=fault)
    assert result["correct"] is False
    assert result["checks"]["mismatched_bytes"]["value"] > 0


def test_run_refuses_without_a_card(tmp_path):
    """No CUDA device: a non-zero exit and no result line; the same in a
    directory holding only BENCHMARK.json and the benchmark's files."""
    cmd = [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
           "--seed", "1", "--seconds", "1", "--trace", "0"]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run(cmd, cwd=harness.ROOT, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    import shutil
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    p = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_card(name):
    """A short run of each cell at its own sizes on the card: correct, and
    every end-to-end metric read."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    cell = harness.load_cell(BENCH, name)
    result, _ = harness.run_cell(cell, 2**31 + 29, 2.0, False,
                                 torch.device("cuda", 0),
                                 time.perf_counter())
    assert result["correct"], result["checks"]
    assert {m["name"] for m in cell.end_to_end} == set(result["metrics"])
