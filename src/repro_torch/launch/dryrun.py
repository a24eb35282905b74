"""Dry run at production scale: trace one rank's step of every (arch x
shape x mesh) cell on fake tensors (port of ``repro.launch.dryrun``).

For each cell:
  * build the production mesh (16x16 single-pod / 2x16x16 multi-pod)
    over an in-process fake world (``launch.mesh.make_production_mesh``:
    this process is one rank of 256 or 512, the traced rank);
  * derive the plan and every parameter's layout, and allocate the
    traced rank's block of the train state as fake tensors (no memory);
  * run the train step (forward, backward, AdamW) and the DiLoCo outer
    sync (the int8 ring, plain codec) once each, or for a prefill or
    decode cell the serve step (``build_serve_step``) on the traced
    rank's block of the parameters and of the cache (``local_cache``),
    under
    ``analysis.op_cost.OpCounter`` and a live-memory tracker, and write
    FLOPs, HBM bytes (unfused upper bound), wire bytes per collective,
    the roofline on the H100 and the memory per rank to JSON under
    ``experiments/dryrun_torch/``.

Fake tensors run on the CPU, so the step goes through the plain
versions of the kernels, as the reference's dry run lowers its ``jnp``
paths (``quant_impl="jnp"``) and never the Pallas kernels.

The traced rank is rank 0, except in a train cell whose plan sets
``act_seq_axis`` (sequence parallelism: every multi-pod train cell but
the SSM and hybrid ones). There each rank runs its block of positions,
and attention skips the key ranges its causal mask cannot reach, so
rank 0 (positions 0 to S / 16) does the least work: the traced rank is
the one of the last position block (the SP axis's last coordinate, 0
on every other axis), which paces the step. The cell's JSON records
it (``traced_rank``). Unsupported shapes are ``"skipped"``, as in the
reference.

Run a single cell:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-130m \\
        --shape train_4k --mesh single
Run everything (one subprocess per cell: a process holds one world):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys
import time

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" \
    / "dryrun_torch"
MESH_AXES = {"single": {"data": 16, "model": 16},
             "multi": {"pod": 2, "data": 16, "model": 16}}


def _write(result: dict, out_dir: pathlib.Path) -> dict:
    out = out_dir / result["mesh"] / result["arch"]
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{result['shape']}.json").write_text(
        json.dumps(result, indent=1, default=str))
    return result


def tree_tensors(tree) -> list:
    """Every tensor of a tree of dicts, tuples, named tuples and
    dataclasses (a cache's ``KVCache`` leaves)."""
    import dataclasses
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_tensors(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in tree_tensors(x)]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree)
                for t in tree_tensors(getattr(tree, f.name))]
    return [tree] if hasattr(tree, "element_size") else []


def tree_nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_tensors(tree))


def _measure(tag: str, label: str, result: dict, fn, args, tracked,
             model_flops, n_chips: int, extra_mem: dict) -> None:
    """Run ``fn(*args)`` once under the op counter and the memory
    tracker; record its roofline, collectives and memory as
    ``result[tag]``."""
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.analysis import op_cost, roofline
    mt = MemTracker()
    mt.track_external(*tree_tensors(tracked))
    counter = op_cost.OpCounter()
    with mt, counter:
        fn(*args)
    peak = max((d.get("Total", 0)
                for d in mt.get_tracker_snapshot("peak").values()),
               default=0)
    cost = counter.cost
    rl = roofline.analyze(cost, n_chips=n_chips, model_flops=model_flops)
    mem = dict(extra_mem, peak_live_bytes=int(peak))
    # the reference's keys; "op_cost" stands where its "xla_cost" (XLA's
    # own aggregates) does
    result[tag] = {"roofline": rl.as_dict(),
                   "collectives": cost.collective_bytes,
                   "memory": mem,
                   "op_cost": {"ops": cost.ops,
                               "collective_calls": cost.collective_calls,
                               "flops_by_op": dict(
                                   cost.flops_by_op.most_common(8))}}
    print(f"[{label}/{tag}] "
          f"flops/dev={rl.flops:.3e} hbm/dev={rl.hbm_bytes:.3e} "
          f"wire/dev={rl.wire_bytes:.3e} bottleneck={rl.bottleneck} "
          f"mfu_bound={rl.mfu:.3f} peakmem={peak / 2**30:.2f}GiB",
          flush=True)


def traced_rank(plan, mesh_axes: dict) -> tuple[int, dict]:
    """(rank, coordinates) of the rank a train cell traces: the last
    position block's under sequence parallelism (the SP axis's last
    coordinate, 0 on every other), else rank 0."""
    from repro_torch.core import rank_mesh
    coords = dict.fromkeys(mesh_axes, 0)
    if plan.act_seq_axis:
        coords[plan.act_seq_axis] = mesh_axes[plan.act_seq_axis] - 1
    return rank_mesh.axes_index(mesh_axes, list(mesh_axes), coords), coords


def _plan_record(plan) -> dict:
    return {"diloco_axis": plan.diloco_axis, "n_workers": plan.n_workers,
            "batch_axes": plan.batch_axes, "remat": plan.remat,
            "seq_axis": plan.seq_axis, "act_seq_axis": plan.act_seq_axis,
            "microbatches": plan.microbatches}


def trace(cfg, shape, plan, mesh, *, sync_too: bool = True,
          quant: str = "int8", label: str = "") -> dict:
    """This process's rank's train step (and outer sync) of ``cfg`` at
    ``shape`` under ``plan`` on ``mesh`` (a ``DeviceMesh`` over a fake
    world), traced once each on fake tensors: the plan, the rank count,
    the traced rank and, per step, the roofline, collectives and
    memory."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis import roofline
    from repro_torch.core.diloco import DiLoCoConfig
    from repro_torch.core.sync_engine import tree_map
    from repro_torch.models.registry import get_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train import step as step_lib

    n_chips = int(mesh.size())
    amap = step_lib.mesh_axes(mesh)
    model = get_model(cfg, device="cpu")
    dax, k = plan.diloco_axis, plan.n_workers
    result = {"plan": _plan_record(plan), "n_chips": n_chips,
              "traced_rank": {"rank": int(mesh.get_rank()),
                              "coords": step_lib._coords(mesh)}}
    opt = AdamW(lr=7.5e-5)
    # meshes and groups are made outside fake mode (they hold real
    # rank tensors); only the state and the steps' tensors are fake
    train_step, _ = step_lib.build_train_step(model, plan, mesh, opt)
    dcfg = DiLoCoConfig(quant=quant)
    sync = (step_lib.build_outer_sync(model, plan, mesh, dcfg)[0]
            if sync_too else None)
    with FakeTensorMode():
        state = step_lib.local_train_state(model, plan, mesh)

        def fake(m):
            shp = tuple(m.shape)
            if dax:
                shp = (k, shp[0] // k) + shp[1:]
            return torch.empty(shp, dtype=m.dtype)
        batch = {key: fake(v) for key, v in model.input_specs(shape).items()}
        _measure("train_step", label, result, train_step, (state, batch),
                 [state], roofline.model_flops_for(cfg, shape), n_chips,
                 {"param_opt_bytes": tree_nbytes(state),
                  "param_bytes": tree_nbytes(state.params)})
        if sync is not None:
            params = state.params
            own = (lambda t: t[0]) if dax else (lambda t: t)
            anchor = tree_map(lambda t: torch.empty(
                own(t).shape, dtype=torch.float32), params)
            outer = step_lib.local_outer_state(model, plan, mesh, anchor,
                                               dcfg)
            if outer.anchor_flat is None:
                # every DiLoCo plan threads its flat fp32 anchor: a
                # sharded plan its per-shard view, one sentinel longer
                tile = math.prod(v for a, v in amap.items() if a != dax)
                outer = outer._replace(anchor_flat=torch.empty(
                    step_lib.flat_anchor_len(model, plan, mesh) // tile))
            weights = torch.ones((1,) if dax else ())
            _measure("sync_step", label, result, sync,
                     (params, outer, weights), [params, outer],
                     float(cfg.param_count()), n_chips,
                     {"param_outer_bytes": tree_nbytes(params)
                      + tree_nbytes(outer)})
    return result


def trace_serve(cfg, shape, plan, mesh, *, label: str = "") -> dict:
    """This process's rank's serve step of ``cfg`` at ``shape`` (a
    prefill or decode cell) under ``plan`` on ``mesh`` (a ``DeviceMesh``
    over a fake world; rank 0 in ``run_cell``), traced once on fake
    tensors: the whole inputs, the rank's block of the parameters and
    of a fresh cache. Returns the plan, the
    rank count and the step's roofline, collectives and memory (the
    parameter and cache bytes of the rank beside its live peak)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis import roofline
    from repro_torch.models.registry import get_model
    from repro_torch.train import step as step_lib

    n_chips = int(mesh.size())
    model = get_model(cfg, device="cpu")
    kind = shape.kind
    result = {"plan": _plan_record(plan), "n_chips": n_chips}
    # the groups are made outside fake mode (they hold real tensors)
    fn, _ = step_lib.build_serve_step(model, plan, mesh, kind)
    with FakeTensorMode():
        params = step_lib.local_params(model, plan, mesh)
        cache = step_lib.local_cache(model, plan, mesh, shape.global_batch,
                                     shape)
        specs = model.input_specs(shape)
        inputs = {k: torch.zeros(m.shape, dtype=m.dtype)
                  for k, m in specs.items()}
        if kind == "decode":
            inputs = inputs["token"]
        _measure("serve_step", label, result, fn, (params, inputs, cache),
                 [params, cache], roofline.model_flops_for(cfg, shape),
                 n_chips, {"param_bytes": tree_nbytes(params),
                           "cache_bytes": tree_nbytes(cache)})
    return result


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             sync_too: bool = True, quant: str = "int8",
             out_dir: pathlib.Path = OUT_DIR) -> dict:
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.sharding.plans import make_plan

    t0 = time.time()
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_kind}
    if not cfg.supports(shape):
        return _write(dict(result, skipped="no sub-quadratic path for "
                           "500k dense attn"), out_dir)
    plan = make_plan(cfg, shape, MESH_AXES[mesh_kind])
    rank = (traced_rank(plan, MESH_AXES[mesh_kind])[0]
            if shape.kind == "train" else 0)
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                rank=rank)
    label = f"{arch}/{shape_name}/{mesh_kind}"
    if shape.kind != "train":
        result.update(trace_serve(cfg, shape, plan, mesh, label=label))
    else:
        result.update(trace(cfg, shape, plan, mesh, sync_too=sync_too,
                            quant=quant, label=label))
    result["elapsed_s"] = round(time.time() - t0, 1)
    return _write(result, out_dir)


def run_custom(arch: str, n_layers: int | None, seq_len: int,
               global_batch: int, mesh_shape: tuple, sync_too: bool = True,
               quant: str = "int8") -> dict:
    """A train cell of ``arch`` cut to ``n_layers`` at (``global_batch``,
    ``seq_len``) on a ("data", "model") fake mesh of ``mesh_shape``, or
    a ("pod", "data", "model") one when it has three dims: the trace of
    a configuration run on cards (``chip_smoke.py`` sets one beside its
    measured step), of the rank ``traced_rank`` names."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_fake_mesh
    from repro_torch.sharding.plans import make_plan
    t0 = time.time()
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    shape = ShapeConfig("custom", "train", seq_len, global_batch)
    names = ("pod", "data", "model")[-len(mesh_shape):]
    amap = dict(zip(names, mesh_shape))
    plan = make_plan(cfg, shape, amap)
    mesh = make_fake_mesh(mesh_shape, names,
                          rank=traced_rank(plan, amap)[0])
    result = {"arch": arch, "n_layers": cfg.n_layers, "seq_len": seq_len,
              "global_batch": global_batch, "mesh": list(mesh_shape)}
    result.update(trace(cfg, shape, plan, mesh, sync_too=sync_too,
                        quant=quant, label=f"{arch}/custom"))
    result["elapsed_s"] = round(time.time() - t0, 1)
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-sync", action="store_true")
    ap.add_argument("--quant", default="int8")
    ap.add_argument("--out-dir", type=pathlib.Path, default=OUT_DIR)
    ap.add_argument("--mesh-shape", default=None,
                    help="data,model or pod,data,model: trace a custom "
                         "train cell on a fake mesh of this shape (with "
                         "--n-layers, --seq-len, --global-batch) and print "
                         "its JSON")
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=4096)
    ap.add_argument("--global-batch", type=int, default=256)
    args = ap.parse_args()

    if args.mesh_shape:
        res = run_custom(args.arch, args.n_layers, args.seq_len,
                         args.global_batch,
                         tuple(int(x) for x in args.mesh_shape.split(",")),
                         sync_too=not args.no_sync, quant=args.quant)
        print(json.dumps(res, default=str))
        return
    if not args.all:
        res = run_cell(args.arch, args.shape, args.mesh,
                       sync_too=not args.no_sync, quant=args.quant,
                       out_dir=args.out_dir)
        print(json.dumps(
            {k: v for k, v in res.items() if k != "plan"} | {
                "plan": res.get("plan")}, default=str)[:2000])
        return

    from repro_torch.configs import ASSIGNED, SHAPES
    failures, kinds = [], {"done": 0, "skipped": 0}
    for mesh_kind in ("single", "multi"):
        for arch in ASSIGNED:
            for shape_name in SHAPES:
                tgt = args.out_dir / mesh_kind / arch / f"{shape_name}.json"
                if args.skip_existing and tgt.exists():
                    print(f"skip {tgt}")
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape_name,
                       "--mesh", mesh_kind, "--quant", args.quant,
                       "--out-dir", str(args.out_dir)]
                if args.no_sync:
                    cmd.append("--no-sync")
                print(">>", " ".join(cmd), flush=True)
                tgt.unlink(missing_ok=True)
                p = subprocess.run(cmd, timeout=3600)
                if p.returncode != 0 or not tgt.exists():
                    failures.append((mesh_kind, arch, shape_name))
                    continue
                cell = json.loads(tgt.read_text())
                kinds["skipped" if "skipped" in cell else "done"] += 1
    print("CELLS:", kinds)
    print("FAILURES:", failures)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
