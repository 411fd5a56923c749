"""One run of one cell: set-up, the measured window, the check, the result.

Everything a cell needs is found by the names in BENCHMARK.json:
  - configs/<config>.json (the `file` of the configuration's entry): the
    configuration as it is run;
  - reference/<config>.py: its plain reference (`sample_shape`,
    `draw_weights`, `forward`, `costs`);
  - systems/<config>.py: `build(cfg, weights, device)`, the program under
    test set up on the benchmark's raw weights;
  - traffic/<mix>.json: the traffic mix, whose `loop` names a loop of
    loops.py;
  - metrics/<metric>.py: `read(view)` for each metric, end-to-end or per
    layer, returning a number or None where it finds nothing to read.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from . import loops, schedule
from .trace import Tracer

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "qnnpack_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    config: str          # the configuration's name: its module stem
    traffic: str
    chips: int
    cfg: dict
    mix: dict
    end_to_end: list     # BENCHMARK.json entries this cell reports
    per_layer: list


@dataclasses.dataclass
class RunView:
    """What a metric's reader sees of one run."""
    cell: Cell
    setup_s: float
    window: loops.Window
    trace: object        # trace.TraceSummary, or None with --trace 0
    costs: list          # (name, kind, ops, bytes) of one device step
    batch: int           # samples of one device step the costs are for
    peaks: dict | None   # the card's published peaks, if known


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of BENCHMARK.json with its configuration, mix and
    metrics."""
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; have {sorted(work)}")
    w = work[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / entry["file"]) as f:
        cfg = json.load(f)
    with open(root / HERE.name / "traffic" / f"{w['traffic']}.json") as f:
        mix = json.load(f)
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (name in m["workloads"] if "workloads" in m
               else m["moves"] in reported)]
    return Cell(name=name, config=w["config"], traffic=w["traffic"],
                chips=w["chips"], cfg=cfg, mix=mix, end_to_end=e2e,
                per_layer=per)


def load_reader(metric: str):
    """metrics/<metric>.py's `read`."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list:
    """Modules loaded whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card_record(device) -> dict:
    """The card's name, count and power limit, for the record."""
    if device.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=1)
    rec = dict(platform="gpu", kind=torch.cuda.get_device_name(device),
               count=1)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30, check=True).stdout
        rec["power_limit_w"] = float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        pass
    return rec


def compare(ref, cfg: dict, weights, xs: torch.Tensor, ys: torch.Tensor,
            device, weight_bits: int = 8, block: int = 32) -> int:
    """Output bytes of `ys` that differ from the reference's forward over
    `xs`, computed on `device` in blocks of `block` samples."""
    bad = 0
    for i in range(0, len(xs), block):
        want = ref.forward(cfg, weights, xs[i:i + block].to(device),
                           weight_bits)
        bad += int((want.cpu() != ys[i:i + block].cpu()).sum())
    return bad


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float, wrap_forward=None) -> tuple:
    """One run: (result dict, check lines).  `wrap_forward`, in tests,
    replaces the program's forward by a broken one."""
    ref = importlib.import_module(f"{HERE.name}.reference.{cell.config}")
    system = importlib.import_module(f"{HERE.name}.systems.{cell.config}")
    gen = torch.Generator(device=device)
    gen.manual_seed(schedule.sub_seed(seed, "weights"))
    weights = ref.draw_weights(cell.cfg, gen, device)
    forward, params = system.build(cell.cfg, weights, device)
    if wrap_forward is not None:
        forward = wrap_forward(forward)
    loop = loops.LOOPS[cell.mix["loop"]](
        cell.mix, tuple(ref.sample_shape(cell.cfg)), forward, params, device,
        seed)
    del params
    loop.prepare()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    with Tracer(trace) as tracer:
        setup_s = time.perf_counter() - t_start
        window = loop.measure(seconds, tracer)
    card = card_record(device)
    if device.type == "cuda":
        card["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(
            device))
    xs, ys, missing = loop.check_data()
    loop.release()
    del loop
    if device.type == "cuda":
        torch.cuda.empty_cache()
    mismatched = compare(ref, cell.cfg, weights, xs, ys, device)

    batch = cell.mix.get("batch", 1)
    peaks_path = HERE / "peaks.json"
    peaks = json.loads(peaks_path.read_text()).get(card["kind"])
    view = RunView(cell=cell, setup_s=setup_s, window=window,
                   trace=tracer.summary, costs=ref.costs(cell.cfg, batch),
                   batch=batch, peaks=peaks)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_reader(m["name"])(view)
        if value is None and not trace:
            raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
        if value is not None:
            metrics[m["name"]] = dict(value=float(value), unit=m["unit"])
    if trace:
        s = tracer.summary
        card.update(busy_s=s.busy_s, window_s=s.window_s)
    checks = {"mismatched_bytes": dict(value=mismatched, limit=0),
              "missing_answers": dict(value=missing, limit=0),
              "compared_samples": dict(value=len(ys), limit_min=1)}
    correct = mismatched == 0 and missing == 0 and len(ys) >= 1
    result = dict(correct=correct, attempted=window.attempted,
                  failed=window.failed, metrics=metrics, device=card)
    if trace:
        result["breakdown"] = dict(
            device_ops=tracer.summary.top(tracer.summary.device_s),
            idle_gaps=tracer.summary.top(tracer.summary.idle_gaps))
    result["window"] = dict(seconds=window.seconds, steps=window.steps,
                            samples=window.samples, setup_s=setup_s)
    if window.load is not None:
        result["load"] = window.load
    if window.stats is not None:
        result["server"] = window.stats
    result["checks"] = checks
    lines = [f"check mismatched_bytes {mismatched} limit 0",
             f"check missing_answers {missing} limit 0",
             f"check compared_samples {len(ys)} limit >= 1"]
    return result, lines
