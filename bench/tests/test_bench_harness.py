"""The harness reads its cells, configurations, traffic, limits and
per-layer readers as data; a run at a CPU test's size prints the
contract's line; the command refuses to run without a card or without
the program."""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from bench_tiny import ROOT, make_root  # noqa: E402

sys.path[:0] = [str(ROOT), str(ROOT / "src")]
from bench import harness  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_benchmark_file_keeps_the_contract_shape():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "bench/run.py"]
    assert b["paths"] == ["bench"]
    names = [c["name"] for c in b["configs"]] + \
        [w["name"] for w in b["workloads"]] + \
        [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = [w["name"] for w in b["workloads"]]
    reports = {m["name"]: set(m.get("workloads", cells))
               for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m["workloads"]) <= reports[m["moves"]]
    for c in cells:
        assert {"setup_s"} < {n for n, w in reports.items() if c in w}
        assert any(c in m["workloads"] for m in b["per_layer"])
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}


def test_every_cell_finds_its_files_by_name():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in b["workloads"]:
        cell = harness.load_cell(w["name"], ROOT)
        assert cell.chips == w["chips"] == 1
        assert set(cell.readers) == {
            m["name"] for m in b["per_layer"]
            if w["name"] in m.get("workloads", [w["name"]])}
        assert set(cell.limits) >= {"loss_gap", "moment1_gap", "change_gap"}
        assert cell.config["num_hidden_layers"] \
            < cell.config["reduced"]["num_hidden_layers"]
        # the port's registry agrees with the file's widths
        cfg = harness.arch_config(cell.config)
        assert cfg.d_model == cell.config["hidden_size"]
        assert cfg.n_layers == cell.config["num_hidden_layers"]


def _check_line(res: dict, metric_names: set):
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= \
        set(res)
    assert set(res["metrics"]) == metric_names
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert json.loads(json.dumps(res)) == res
    for v in res["checks"].values():
        assert set(v) == {"value", "limit"}


@pytest.mark.parametrize("trace", [0, 1])
def test_cpu_run_prints_the_contract_line(tmp_path, monkeypatch, trace):
    root, name = make_root(tmp_path, monkeypatch, "dense")
    cell = harness.load_cell(name, root)
    res = harness.run(cell, 2 ** 31 + 7, 0.2, bool(trace), device="cpu",
                      log=lambda msg: None)
    want = ({"mfu", "step_mfu", "outer_sync_ms", "device_idle_share"}
            if trace else
            {"train_tokens_per_s", "peak_mem_gib", "setup_s"})
    # codec_roofline reads kernels of the card: on the CPU it finds
    # none and is left out
    _check_line(res, want)
    assert res["correct"] is True
    assert res["attempted"] >= 1 and res["failed"] == 0
    if trace:
        assert "breakdown" in res and "window_s" in res["device"]


def test_a_new_cell_and_metric_are_files_alone(tmp_path, monkeypatch):
    root, name = make_root(tmp_path, monkeypatch, "dense")
    (root / "bench" / "metrics" / "window_steps.py").write_text(
        "def read(w):\n    return float(len(w.steps))\n")
    (root / "bench" / "traffic" / "tiny-3.json").write_text(json.dumps(
        {**json.loads((root / "bench" / "traffic" / "tiny.json")
                      .read_text()), "inner_steps": 3}))
    shutil.copy(root / "bench" / "limits" / f"{name}.json",
                root / "bench" / "limits" / "dummy.json")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "dummy", "config": name,
                           "traffic": "tiny-3", "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "window_steps", "unit": "steps",
                           "better": "higher", "source": "program_counter",
                           "layer": "trainer and outer sync",
                           "moves": "train_tokens_per_s",
                           "workloads": ["dummy"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = harness.load_cell("dummy", root)
    assert cell.traffic["inner_steps"] == 3
    assert set(cell.readers) == {"window_steps"}
    res = harness.run(cell, 3, 0.1, True, device="cpu",
                      log=lambda msg: None)
    assert res["metrics"]["window_steps"]["value"] == res["attempted"]


def _run_cli(cwd, *extra):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "diloco-internlm2-1.8b-4k", "--seed", "5", "--seconds", "1",
         "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
        timeout=120, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_cli_refuses_without_a_card():
    out = _run_cli(ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_cli_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_cli(tmp_path)
    assert out.returncode != 0
    assert "{" not in out.stdout
