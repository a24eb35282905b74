"""Hybrid DiLoCo-FSDP training on a mesh of rank processes (the rank
driver of ``train/step.py``'s ``build_train_step`` and
``build_outer_sync``; paper §2.3).

A ("data", "model") ``RankMesh`` (single-pod: each 'data' coordinate
one DiLoCo worker, its 'model' ranks one FSDP group) or a ("pod",
"data", "model") one (multi-pod: DiLoCo over 'pod', each worker's
('data', 'model') ranks one FSDP group). The FSDP group shards the
parameters as ``make_plan`` says and splits the worker's batch: by rows
over the plan's batch axes and, where the plan sets ``act_seq_axis``
(a worker's batch too small to cover its ranks, e.g. one sequence a
worker), by positions over 'model'. Every rank builds the model from
the seed and keeps its block of the state; each outer step is H inner
steps on every rank (its worker's batch from the synthetic pipeline,
keyed by (seed, worker, step)), then the outer sync: each rank rings
its own shard over its DiLoCo group (gloo; the codec kernels on the
card).

An FSDP group of one rank is gloo on the CPU and NCCL on the card. A
larger group is gloo: on one card (NCCL takes one card a rank) its
sequence-parallel step moves the weights and K/V through the card
mailboxes (``core.rank_mesh.CardMailboxes``, CUDA IPC). ``run`` returns
one record per outer step: the workers' losses, the inner phase's and
the sync's seconds, the codec's launches summed over the ranks.
"""
from __future__ import annotations

import dataclasses
import time

import torch


@dataclasses.dataclass(frozen=True)
class FSDPConfig:
    arch: str = "internlm2-1.8b"
    reduced: bool = False
    n_layers: int | None = None       # cut the depth (full width)
    seq_len: int = 128
    batch_per_worker: int = 4         # 1: one sequence a worker
    inner_steps: int = 4
    dtype: str | None = None          # None: the config's


INNER_LR = 7.5e-5       # the paper's inner AdamW lr
QUANT = "int8"          # the outer sync's ring codec
SEED = 0                # parameters and data


def model_config(fc: FSDPConfig):
    from repro_torch.configs import get_config
    cfg = get_config(fc.arch)
    if fc.reduced:
        cfg = cfg.reduced()
    if fc.n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=fc.n_layers)
    if fc.dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=fc.dtype)
    return cfg


def diloco_axis(shape: dict) -> str:
    """The DiLoCo axis of a mesh: 'pod' where there is one (multi-pod),
    else 'data'."""
    return "pod" if "pod" in shape else "data"


def train_shape(fc: FSDPConfig, n_workers: int):
    from repro_torch.configs.base import ShapeConfig
    return ShapeConfig("fsdp", "train", fc.seq_len,
                       fc.batch_per_worker * n_workers)


# -- rank side ----------------------------------------------------------------


def rank_build(ctx, fc: FSDPConfig, outer_steps: int) -> dict:
    """Build this rank's model, plan, train step, outer sync and state
    (kept in ``ctx.state["fsdp"]``). Returns the plan, the state's bytes
    on this rank, its worker and its shard: its index in its worker's
    group, which names the blocks it holds."""
    from repro_torch.core import diloco as dl
    from repro_torch.core import rank_mesh
    from repro_torch.core.sync_engine import leaves
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models.registry import get_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.sharding.plans import make_plan
    from repro_torch.train import step as ts
    dax = diloco_axis(ctx.shape)
    local = [a for a in ctx.shape if a != dax]
    one = all(ctx.shape[a] == 1 for a in local)
    mesh = ctx.device_mesh(dax, "nccl" if ctx.device.type == "cuda"
                           and one else "gloo")
    amap = ts.mesh_axes(mesh)
    cfg = model_config(fc)
    model = get_model(cfg, ctx.device)
    plan = make_plan(cfg, train_shape(fc, amap[dax]), amap)
    opt = AdamW(lr=INNER_LR)
    dcfg = dl.DiLoCoConfig(inner_steps=fc.inner_steps, quant=QUANT)
    step, _ = ts.build_train_step(model, plan, mesh, opt)
    sync, _ = ts.build_outer_sync(model, plan, mesh, dcfg)
    params = model.init(SEED)
    state = ts.local_train_state(model, plan, mesh, params)
    outer = ts.local_outer_state(
        model, plan, mesh,
        ts.shard_tree(params, ts.param_specs(model, plan, mesh), mesh), dcfg)
    del params
    worker = ctx.coords[dax]
    pipe = TokenPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=fc.seq_len,
        batch_per_worker=fc.batch_per_worker,
        total_steps=max(1, outer_steps * fc.inner_steps), seed=SEED),
        worker, amap[dax])
    shard = rank_mesh.axes_index(ctx.shape, local, ctx.coords)
    ctx.state["fsdp"] = {"step": step, "sync": sync, "state": state,
                         "outer": outer, "pipe": pipe, "t": 0,
                         "dax": dax, "shard": shard}
    nbytes = sum(t.numel() * t.element_size() for tree in
                 (state.params, state.opt.m, state.opt.v)
                 for t in leaves(tree)) + state.opt.step.numel() * 4
    return {"plan": dataclasses.asdict(plan), "param_opt_bytes": nbytes,
            "worker": worker, "shard": shard}


def _batch(ctx, f, t: int) -> dict:
    """This worker's batch at inner step ``t`` (a block of one worker:
    leading dim 1)."""
    return {k: v[None].to(ctx.device) for k, v in
            f["pipe"].batch_at(t).items()}


def _reset_peak(ctx) -> None:
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)


def _peak(ctx) -> int:
    """This rank's peak of allocated bytes since ``_reset_peak`` (0 on
    the CPU)."""
    if ctx.device.type != "cuda":
        return 0
    return torch.cuda.max_memory_allocated(ctx.device)


def rank_inner(ctx, n: int) -> dict:
    """``n`` inner steps; returns the losses, the seconds and the peak
    of allocated bytes during them."""
    f = ctx.state["fsdp"]
    losses = []
    ctx.sync()
    _reset_peak(ctx)
    t0 = time.perf_counter()
    for _ in range(n):
        f["state"], metrics = f["step"](f["state"], _batch(ctx, f, f["t"]))
        losses.append(float(metrics["loss"]))
        f["t"] += 1
    ctx.sync()
    return {"losses": losses, "inner_s": time.perf_counter() - t0,
            "peak_bytes": _peak(ctx)}


def rank_flat_params(ctx, out) -> dict:
    """Write this rank's parameters, flat, into row ``worker`` of
    ``out`` ((k, n) on this rank's device, shared by the caller: the
    whole model where the FSDP group is one rank), or into row
    ``(worker, shard)`` of a (k, n_shards, n) ``out`` (each rank its
    blocks, concatenated leaf by leaf: what its sync rings), for a
    caller's check against the simulator; leaf by leaf (no flat copy
    on the rank). Returns the peak of allocated bytes during the copy
    (what the rank holds, at most, until its next command)."""
    from repro_torch.core.sync_engine import SyncEngine, leaves, tree_map
    _reset_peak(ctx)
    f = ctx.state["fsdp"]
    own = tree_map(lambda t: t[0], f["state"].params)
    eng = SyncEngine.for_tree(own)
    row = out[ctx.coords[f["dax"]]]
    if out.dim() == 3:
        row = row[f["shard"]]
    for leaf, o, n in zip(leaves(own), eng.offsets, eng.sizes):
        row[o:o + n].copy_(leaf.reshape(-1))
    ctx.sync()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()        # the inner phase's cached blocks
    return {"peak_bytes": _peak(ctx)}


def rank_sync(ctx, expected=None) -> dict:
    """One outer sync. Returns its seconds, this rank's codec calls and
    launches during it and its peak of allocated bytes; with
    ``expected`` (a flat anchor on this rank's device, shared by the
    caller; (n_shards, n): one a shard, this rank's its ``shard``'s)
    also whether this rank's new flat anchor equals it bit for bit."""
    from repro_torch.core import ring_reduce as rr
    from repro_torch.kernels import int8_quant as iq
    f = ctx.state["fsdp"]
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()        # the inner phase's cached blocks
    before = {n: (iq.calls[n], getattr(iq, n).launches) for n in rr.CODEC}
    ctx.sync()
    _reset_peak(ctx)
    t0 = time.perf_counter()
    w = torch.ones(1, device=ctx.device)
    params, f["outer"] = f["sync"](f["state"].params, f["outer"], w)
    f["state"] = f["state"]._replace(params=params)
    ctx.sync()
    out = {"sync_s": time.perf_counter() - t0,
           "calls": {n: iq.calls[n] - before[n][0] for n in rr.CODEC},
           "launches": {n: getattr(iq, n).launches - before[n][1]
                        for n in rr.CODEC},
           "peak_bytes": _peak(ctx)}
    if expected is not None:
        if expected.dim() == 2:
            expected = expected[f["shard"]]
        flat = f["outer"].anchor_flat
        out["anchor_equal"] = bool(torch.equal(flat[:expected.numel()],
                                               expected))
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def rank_time_step(ctx, warm: int, timed: int) -> dict:
    """The train step on one fixed batch: ``warm`` untimed calls, then
    ``timed`` calls each timed with CUDA events (the card) or the host
    clock; the peak of allocated bytes over the timed calls."""
    f = ctx.state["fsdp"]
    batch = _batch(ctx, f, 0)
    for _ in range(warm):
        f["state"], _ = f["step"](f["state"], batch)
    ctx.sync()
    cuda = ctx.device.type == "cuda"
    _reset_peak(ctx)
    ms = []
    for _ in range(timed):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            f["state"], _ = f["step"](f["state"], batch)
            end.record()
            torch.cuda.synchronize(ctx.device)
            ms.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            f["state"], _ = f["step"](f["state"], batch)
            ms.append((time.perf_counter() - t0) * 1e3)
    return {"ms": ms, "peak_bytes": _peak(ctx)}


def rank_clock_step(ctx, n: int, host: bool = False) -> list:
    """``n`` train steps on one fixed batch, each with its seconds in
    the gathers and their backwards by kind (``rank_mesh.
    timed_collectives``: 'weights', 'kv', 'routing'; each call timed
    after the device work queued before it, so these steps run apart
    from ``rank_time_step``'s) beside its wall seconds. ``host``: the
    gloo groups move CUDA tensors through host copies instead of the
    card mailboxes (the transports compared)."""
    from repro_torch.core import rank_mesh
    f = ctx.state["fsdp"]
    batch = _batch(ctx, f, 0)
    out = []
    with rank_mesh.host_transport(host):
        for _ in range(n):
            ctx.sync()
            with rank_mesh.timed_collectives() as rec:
                t0 = time.perf_counter()
                f["state"], _ = f["step"](f["state"], batch)
                ctx.sync()
                rec["step_s"] = time.perf_counter() - t0
            out.append(rec)
    return out


def rank_steps(ctx, batch: dict, n: int) -> list:
    """``n`` train steps on ``batch`` (the whole stacked batch, or this
    worker's block: leading dim 1; on this rank's device, shared by the
    caller); each step's metrics."""
    f = ctx.state["fsdp"]
    out = []
    for _ in range(n):
        f["state"], metrics = f["step"](f["state"], batch)
        out.append({k: float(v) for k, v in metrics.items()})
    return out


def rank_drop(ctx) -> None:
    """Forget the run (frees its memory on the rank) and close the card
    mailboxes its steps opened. Collective: every rank calls it."""
    from repro_torch.core import rank_mesh
    ctx.state.pop("fsdp", None)
    rank_mesh.release_card_mailboxes()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


# -- controller ---------------------------------------------------------------


def run(mesh, fc: FSDPConfig, outer_steps: int,
        on_sync) -> tuple[dict, list]:
    """``outer_steps`` outer steps of hybrid training on ``mesh`` (a
    ("data", "model") or ("pod", "data", "model") ``RankMesh``, built
    already). Returns rank 0's
    ``rank_build`` record and one record a step (``peak_bytes``: each
    rank's peak of allocated bytes in the inner phase and in the sync,
    by rank). ``on_sync(t, mesh)`` runs sync ``t`` (``mesh.call(
    rank_sync, expected)``, with the caller's check around it) and
    returns the ranks' ``rank_sync`` results."""
    info = mesh.call(rank_build, fc, outer_steps)[0]
    dax = diloco_axis(mesh.shape)
    hist = []
    for t in range(outer_steps):
        inner = mesh.call(rank_inner, fc.inner_steps)
        syncs = on_sync(t, mesh)
        workers = sorted({mesh.coords(r)[dax] for r in range(mesh.size)})
        by_worker = {w: next(inner[r]["losses"] for r in range(mesh.size)
                             if mesh.coords(r)[dax] == w)
                     for w in workers}
        hist.append({
            "outer_step": t,
            "loss": sum(v[-1] for v in by_worker.values()) / len(workers),
            "losses": by_worker,
            "inner_s": max(i["inner_s"] for i in inner),
            "sync_s": max(s["sync_s"] for s in syncs),
            "peak_bytes": {"inner": [i["peak_bytes"] for i in inner],
                           "sync": [s["peak_bytes"] for s in syncs]},
            "launches": {n: sum(s["launches"][n] for s in syncs)
                         for n in syncs[0]["launches"]}})
    return info, hist
