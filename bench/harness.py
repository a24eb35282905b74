"""One run of one cell of ``BENCHMARK.json``.

Everything about a cell is data, found by the names in
``BENCHMARK.json``: its configuration (``bench/configs/<config>.json``,
the file the entry names), its traffic (``bench/traffic/<traffic>.json``),
the limits of its correctness check (``bench/limits/<cell>.json``) and
a reader per per-layer metric (``bench/metrics/<metric>.py``;
``read(window)`` returns a number or None).

A run:

1. set-up: the weights of the seed are made on the device and handed to
   the port's ``ElasticTrainer`` (``repro_torch.train.loop``) with a
   batch provider of this benchmark's (``bench/traffic.py``), no
   membership events, no validation, the synchronous int8 ring; the
   trainer takes its first outer steps through its own ``run(1,
   inner_steps=h)`` (the first also builds the kernels), the readings
   of those steps are kept (``bench/check.py``), and one ``run(1)``
   warms the window's own call;
2. the window: ``run(1)`` (H inner steps on every worker, the outer
   sync) again and again until ``seconds`` have passed, under the
   profiler with ``trace``;
3. the trainer is freed, and the plain reference (``bench/reference``)
   follows the same first steps from the same weights and rows; the
   two sides' readings decide ``correct``.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import record_function

from bench import check, traffic as traffic_mod, weights
from bench.reference import diloco as ref_diloco
from bench.reference import model as ref_model
from bench.reference import optim as ref_optim
from bench.devtrace import WINDOW, DeviceTrace

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GIB = 2 ** 30


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    readers: dict


@dataclasses.dataclass
class Window:
    """What a per-layer reader reads."""
    config: dict
    traffic: dict
    steps: list           # the trainer's history records of the window
    seconds: float        # wall time of the window's outer steps
    tokens: int           # tokens the live workers trained in them
    n_params: int         # elements of one worker's parameters
    trace: DeviceTrace | None


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reader(root: Path, name: str):
    """``read`` of ``bench/metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"),
        root / "bench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _covers(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` and its files."""
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    per_layer = [m for m in bench["per_layer"] if _covers(m, name)]
    return Cell(
        name=name, chips=w["chips"],
        config=_load_json(root / conf["file"]),
        traffic=_load_json(root / "bench" / "traffic"
                           / f"{w['traffic']}.json"),
        limits=_load_json(root / "bench" / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _covers(m, name)],
        per_layer=per_layer,
        readers={m["name"]: _reader(root, m["name"]) for m in per_layer})


def forbidden_modules() -> list[str]:
    """Loaded modules of the JAX stack or the JAX package, by their
    whole top-level name."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


# -- the program under test ---------------------------------------------------


def arch_config(c: dict):
    """The port's ``ArchConfig`` of a configuration file: the registry's
    entry, checked against the file's widths, at the file's depth,
    norm epsilon, rotary base and routing settings."""
    from repro_torch.configs import get_config
    a = c["assumed"]
    base = get_config(c["registry"])
    want = {"d_model": c["hidden_size"], "n_heads": c["num_attention_heads"],
            "n_kv_heads": c["num_key_value_heads"],
            "d_ff": c["intermediate_size"], "vocab": c["vocab_size"],
            "padded_vocab": a["padded_vocab_size"],
            "tie_embeddings": c["tie_word_embeddings"]}
    have = {k: getattr(base, k) for k in want}
    if (base.head_dim or base.d_model // base.n_heads) != a["head_dim"]:
        have["head_dim"], want["head_dim"] = base.head_dim, a["head_dim"]
    if c["family"] == "moe":
        m = base.moe
        want.update(n_experts=c["n_routed_experts"],
                    top_k=c["num_experts_per_tok"],
                    d_expert=c["moe_intermediate_size"],
                    n_shared=c["n_shared_experts"],
                    first_dense=c["first_k_dense_replace"])
        have.update(n_experts=m.n_experts, top_k=m.top_k,
                    d_expert=m.d_expert, n_shared=m.n_shared,
                    first_dense=m.first_dense)
    if have != want:
        raise ValueError(f"the port's {c['registry']} is not the "
                         f"configuration file's: {have} != {want}")
    kw = dict(n_layers=c["num_hidden_layers"], rope_theta=c["rope_theta"],
              norm_eps=c["rms_norm_eps"], dtype=c["torch_dtype"],
              max_z_weight=a["max_z_weight"])
    if c["family"] == "moe":
        if not a["renormalise_top_k"]:
            raise ValueError("the port renormalises the top-k gates and "
                             "has no switch for unnormalised ones")
        kw["moe"] = dataclasses.replace(
            base.moe, capacity_factor=a["capacity_factor"],
            lb_weight=a["lb_weight"])
    return dataclasses.replace(base, **kw)


def build_trainer(cell: Cell, params, tokens: traffic_mod.Tokens, device):
    """The port's trainer as the cell states it, holding ``params``."""
    from repro_torch.core.diloco import DiLoCoConfig
    from repro_torch.core.fault_tolerance import ClusterSimulator
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.registry import get_model
    from repro_torch.train.loop import ElasticTrainer, TrainerConfig

    t = cell.traffic
    cfg = arch_config(cell.config)
    tcfg = TrainerConfig(
        diloco=DiLoCoConfig(inner_steps=t["inner_steps"], quant=t["quant"],
                            outer_lr=t["outer_lr"],
                            outer_momentum=t["outer_momentum"],
                            overlap="none"),
        inner_lr=t["adamw"]["lr"], max_workers=t["workers"],
        validation=None)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=t["seq_len"],
                      batch_per_worker=t["rows_per_worker_step"])
    sim = ClusterSimulator(list(range(t["workers"])), events=[])
    tr = ElasticTrainer(get_model(cfg, device), tcfg, dcfg, params, sim,
                        batch_provider=tokens.provider())
    opt = tr.optimizer
    have = dict(lr=opt.lr, b1=opt.b1, b2=opt.b2, eps=opt.eps,
                weight_decay=opt.weight_decay)
    if have != t["adamw"]:
        raise ValueError(f"the trainer's AdamW {have} is not the "
                         f"traffic file's {t['adamw']}")
    return tr


def _norms(tree, slots) -> dict:
    return {n: [float(torch.linalg.vector_norm(x[s], dtype=torch.float64))
                for s in slots]
            for n, x in ref_diloco.leaves(tree)}


def first_steps(tr, cell: Cell, w0) -> dict:
    """Drive the trainer through its first outer steps (the traffic's
    ``check_outer_steps`` calls of ``run(1, inner_steps=h)``, h its
    ``check_inner_steps``) and read what ``bench.check`` compares: each
    outer step's loss, every worker's AdamW first moment after the
    first outer step, and each tensor's change from ``w0`` after the
    last."""
    t = cell.traffic
    slots = [tr.slots.slot_of[n] for n in range(t["workers"])]
    out = {"loss": []}
    for i in range(t["check_outer_steps"]):
        out["loss"].append(
            tr.run(1, inner_steps=t["check_inner_steps"])[-1]["loss"])
        if i == 0:
            out["moment1"] = _norms(tr.opt_state.m, slots)
    w0 = dict(ref_diloco.leaves(w0))
    out["change"] = {
        n: [float(torch.linalg.vector_norm(
            x[s].double() - w0[n].double())) for s in slots]
        for n, x in ref_diloco.leaves(tr.params)}
    return out


# -- the reference ------------------------------------------------------------


def reference_readings(cell: Cell, seed: int, device, *,
                       prec=ref_model.Precision(), fault=None) -> dict:
    """The plain reference's readings of the cell's first outer steps,
    from the seed's weights and rows (made again: outer step i trains
    on global steps i h .. i h + h - 1), with TF32 off."""
    t = cell.traffic
    spec = ref_model.spec_from_config(cell.config)
    tokens = traffic_mod.Tokens(t, spec.vocab, seed, device)
    h = t["check_inner_steps"]
    rows = [tokens.outer_step(i * h, h)
            for i in range(t["check_outer_steps"])]
    w0 = weights.make(spec, seed, device)
    job = ref_diloco.Job(
        workers=t["workers"], adamw=ref_optim.AdamWConfig(**t["adamw"]),
        outer_lr=t["outer_lr"], outer_momentum=t["outer_momentum"])
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return ref_diloco.follow(spec, job, w0, rows, prec=prec,
                                 fault=fault)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32


# -- one run ------------------------------------------------------------------


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _alloc_stats(dev) -> dict:
    """The caching allocator's retries and device allocations so far."""
    st = torch.cuda.memory_stats(dev)
    return {k: st.get(k, 0) for k in ("num_alloc_retries",
                                      "num_device_alloc",
                                      "num_device_free")}


def _power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def _finite(x: float) -> float:
    return x if math.isfinite(x) else sys.float_info.max


def run(cell: Cell, seed: int, seconds: float, trace: bool, *,
        device="cuda", t_start: float | None = None, log=None) -> dict:
    """One run; returns the result line's object. ``t_start``: the
    process's start on ``time.perf_counter`` (set-up is timed from
    it)."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    spec = ref_model.spec_from_config(cell.config)
    tokens = traffic_mod.Tokens(cell.traffic, spec.vocab, seed, dev)
    w0 = weights.make(spec, seed, dev)
    tr = build_trainer(cell, w0, tokens, dev)
    n_params = sum(x[0].numel() for _, x in ref_diloco.leaves(tr.params))
    prog = first_steps(tr, cell, w0)
    del w0
    # one outer step of the window's own call, so that the caching
    # allocator holds every block the window asks for
    tr.run(1)
    _sync(dev)
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        prof = profile(activities=acts)
        prof.start()
    _sync(dev)
    alloc0 = _alloc_stats(dev) if cuda else {}
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    steps = []
    with record_function(WINDOW):
        while True:
            with record_function("bench.outer_step"):
                steps.append(dict(tr.run(1)[-1]))
            if time.perf_counter() - t0 >= seconds:
                break
    _sync(dev)
    window_s = time.perf_counter() - t0
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    alloc = {k: v - alloc0[k] for k, v in _alloc_stats(dev).items()} \
        if cuda else {}
    dtrace = None
    t1 = time.perf_counter()
    if prof is not None:
        prof.stop()
        dtrace = DeviceTrace.from_profile(prof)
        del prof
    trace_s = time.perf_counter() - t1

    t = cell.traffic
    tokens_done = sum(len(h["live"]) for h in steps) * t["inner_steps"] \
        * t["rows_per_worker_step"] * t["seq_len"]
    failed = sum(1 for h in steps if not math.isfinite(h["loss"]))
    window = Window(cell.config, t, steps, window_s, tokens_done, n_params,
                    dtrace)
    del tr
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t1 = time.perf_counter()
    ref = reference_readings(cell, seed, dev)
    _sync(dev)
    ref_s = time.perf_counter() - t1
    ref_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    found = check.gaps(prog, ref)
    correct, checks = check.judge(found, cell.limits)
    checks = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
              for k, v in checks.items()}

    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = cell.readers[m["name"]](window)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {"train_tokens_per_s": tokens_done / window_s,
               "peak_mem_gib": window_peak / GIB, "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device_info = {
        "platform": "gpu" if cuda else dev.type,
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": max(setup_peak, window_peak),
        "power_limit": _power_limit() if cuda else None}
    result = {"correct": correct, "attempted": len(steps), "failed": failed,
              "metrics": metrics, "device": device_info}
    if dtrace is not None:
        device_info["busy_s"] = dtrace.busy_s()
        device_info["window_s"] = dtrace.window_s
        result["breakdown"] = dtrace.breakdown()
    result["checks"] = checks
    log(f"window: {len(steps)} outer steps, {window_s:.3f} s, "
        f"{tokens_done} tokens, inner_s "
        f"{[round(h['inner_s'], 4) for h in steps]}, sync_s "
        f"{[round(h['sync_s'], 4) for h in steps]}; set-up {setup_s:.3f} s,"
        f" peak {setup_peak} B; window peak {window_peak} B; trace read "
        f"{trace_s:.3f} s; reference {ref_s:.3f} s, peak {ref_peak} B; "
        f"allocator in the window {alloc}")
    log(f"losses: program {prog['loss']} reference {ref['loss']}; "
        f"reference seconds {ref['seconds']}")
    log("gaps: " + json.dumps(found))
    for k, v in checks.items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    return result
