"""Nothing the benchmark runs imports the JAX stack or the JAX package
(top-level module names compared whole, so ``repro_torch`` is not
``repro``), the reference imports nothing of the program, and nothing
reads the JAX package's old benchmark or its result files."""
from __future__ import annotations

import ast
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from bench_tiny import ROOT  # noqa: E402

JAX_STACK = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in (ROOT / "bench").rglob("*.py")
                 if p.name != "test_bench_imports.py")


def _imports(path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_source_imports_the_jax_stack():
    for p in SOURCES:
        assert not _imports(p) & JAX_STACK, p


def test_reference_imports_only_torch():
    allowed = {"__future__", "dataclasses", "time", "torch"}
    for p in (ROOT / "bench" / "reference").glob("*.py"):
        assert _imports(p) <= allowed, p


def test_nothing_reads_the_old_benchmark():
    old = ("bench" + "marks/", "BENCH" + "_")
    for p in SOURCES:
        text = p.read_text()
        assert not any(o in text for o in old), p


_RUN = r"""
import sys, tempfile
from pathlib import Path
sys.path[:0] = [{root!r}, {root!r} + "/src", {tests!r}]
import torch
torch.set_num_threads(2)
import bench_tiny
from bench import harness

class Patch:
    def setitem(self, d, k, v):
        d[k] = v

import bench.reference.diloco
tops = {{m.split(".")[0] for m in sys.modules}}
print("REFERENCE", sorted(tops & {{"repro_torch", "repro", "jax"}}))
with tempfile.TemporaryDirectory() as tmp:
    root, name = bench_tiny.make_root(Path(tmp), Patch(), "moe")
    res = harness.run(harness.load_cell(name, root), 1, 0.1, True,
                      device="cpu", log=lambda m: None)
print("CORRECT", res["correct"])
print("AFTER", harness.forbidden_modules(),
      "repro_torch" in {{m.split(".")[0] for m in sys.modules}})
"""


def test_a_run_loads_nothing_of_the_jax_stack():
    script = _RUN.format(root=str(ROOT), tests=str(ROOT / "bench" / "tests"))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines()
                 if line.split(" ", 1)[0] in ("REFERENCE", "CORRECT",
                                              "AFTER"))
    assert lines["REFERENCE"] == "[]"
    assert lines["CORRECT"] == "True"
    assert lines["AFTER"] == "[] True"
