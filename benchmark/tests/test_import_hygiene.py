"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
references import nothing of the program under test.

Top-level module names are compared whole (the part before the first
dot), since the program's name, qnnpack_tpu_torch, begins with the JAX
package's, qnnpack_tpu."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from benchmark import harness

FORBIDDEN = ("jax", "jaxlib", "flax", "qnnpack_tpu")
REFERENCE = sorted((harness.HERE / "reference").glob("*.py"))
METRICS = sorted((harness.HERE / "metrics").glob("*.py"))


def test_run_references_metrics_and_systems_load_no_jax():
    """In a fresh interpreter: import run.py, harness, every reference,
    every system adapter (and so the program) and every metric reader;
    then no module of a forbidden top-level name is loaded."""
    code = f"""
import importlib, importlib.util, json, sys
sys.path.insert(0, {str(harness.ROOT)!r})
import benchmark.run, benchmark.harness, benchmark.sweep
from pathlib import Path
here = Path({str(harness.HERE)!r})
for sub in ("reference", "systems"):
    for p in sorted((here / sub).glob("*.py")):
        importlib.import_module(f"benchmark.{{sub}}.{{p.stem}}")
for p in sorted((here / "metrics").glob("*.py")):
    benchmark.harness.load_reader(p.stem)
print(json.dumps(sorted(m for m in sys.modules)))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=harness.ROOT)
    assert p.returncode == 0, p.stderr
    loaded = json.loads(p.stdout.strip().splitlines()[-1])
    tops = {m.split(".")[0] for m in loaded}
    assert "qnnpack_tpu_torch" in tops       # the systems load the program
    assert not tops & set(FORBIDDEN), sorted(tops & set(FORBIDDEN))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                yield node.module
            elif node.module:
                yield "." + node.module


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    """A reference file imports torch, numpy, the standard library and its
    sibling references only."""
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN + ("qnnpack_tpu_torch",), name
        assert name.startswith(".") or top in (
            "torch", "numpy", "math", "__future__"), name


@pytest.mark.parametrize("path", METRICS, ids=lambda p: p.name)
def test_metric_imports_nothing_of_jax(path):
    for name in _imports(path):
        assert name.split(".")[0] not in FORBIDDEN, name


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "qnnpack_tpu_torch_fake", object())
    assert "qnnpack_tpu_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "qnnpack_tpu.fake", object())
    assert harness.forbidden_modules() == ["qnnpack_tpu.fake"]


def test_paths_hold_the_command():
    with open(harness.ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    assert bench["paths"] == [harness.HERE.name]
    assert bench["command"][1] == f"{harness.HERE.name}/run.py"
