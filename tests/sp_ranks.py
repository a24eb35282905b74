"""Rank-side commands of the sequence-parallel train tests
(``test_torch_sp_train.py``, ``test_torch_sp_train_families.py`` and
their card twin): each runs in every process of a ``RankMesh`` as
``fn(ctx, *args)``. This module imports no JAX, so the rank processes
stay light."""
import torch

from fsdp_ranks import model_of
from repro_torch.configs import get_config
from repro_torch.core import rank_mesh
from repro_torch.core.sync_engine import tree_map
from repro_torch.models.registry import get_model
from repro_torch.optim.adamw import AdamW
from repro_torch.train import step as ts


class _FirstGrads(AdamW):
    """AdamW that also keeps the first gradient it is given (on the
    host, with the parameters' leading worker dim of 1)."""

    first = None

    def update_(self, grads, state, params) -> None:
        if self.first is None:
            self.first = tree_map(lambda g: g.float().cpu()[None], grads)
        super().update_(grads, state, params)


def train(ctx, arch, plan, params, batch, n_steps, lr, local_backend):
    """``n_steps`` of ``build_train_step`` from ``params`` (the whole
    tree): every step's metrics and this rank's block of the first
    step's gradient (what the step hands its optimizer). Closes the
    card mailboxes the step opened (collective)."""
    torch.set_float32_matmul_precision("highest")
    mesh = ctx.device_mesh(plan.diloco_axis, local_backend)
    model = model_of(ctx, arch)
    opt = _FirstGrads(lr=lr)
    step, _ = ts.build_train_step(model, plan, mesh, opt)
    state = ts.local_train_state(model, plan, mesh, tree_map(
        lambda t: t.to(ctx.device), params))
    batch = {k: v.to(ctx.device) for k, v in batch.items()}
    hist = []
    for _ in range(n_steps):
        state, metrics = step(state, batch)
        hist.append({k: float(v) for k, v in metrics.items()})
    del step
    rank_mesh.release_card_mailboxes()
    return {"metrics": hist, "grads": opt.first}


def build(ctx, arch, plan, seq_len: int, batch_per_worker: int,
          inner_steps: int) -> int:
    """What ``launch.fsdp.rank_build`` keeps in ``ctx.state["fsdp"]``
    (the reduced ``arch``'s train step, int8 outer sync, state and
    token pipeline) under ``plan`` in place of ``make_plan``'s, which
    replicates the reduced models, so that the launcher's rank commands
    (``rank_inner``, ``rank_flat_params``, ``rank_sync``, ``rank_drop``)
    run the sequence-parallel step. Returns this rank's shard: its index
    in its worker's group."""
    from repro_torch.core import diloco as dl
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import fsdp
    dax = plan.diloco_axis
    mesh = ctx.device_mesh(dax, "gloo")
    fc = fsdp.FSDPConfig(arch, reduced=True, seq_len=seq_len,
                         batch_per_worker=batch_per_worker,
                         inner_steps=inner_steps)
    model = get_model(fsdp.model_config(fc), ctx.device)
    dcfg = dl.DiLoCoConfig(inner_steps=inner_steps, quant=fsdp.QUANT)
    step, _ = ts.build_train_step(model, plan, mesh,
                                  AdamW(lr=fsdp.INNER_LR))
    sync, _ = ts.build_outer_sync(model, plan, mesh, dcfg)
    params = model.init(fsdp.SEED)
    specs = ts.param_specs(model, plan, mesh)
    shard = rank_mesh.axes_index(
        ctx.shape, [a for a in ctx.shape if a != dax], ctx.coords)
    pipe = TokenPipeline(DataConfig(
        vocab=model.cfg.vocab, seq_len=seq_len,
        batch_per_worker=batch_per_worker, total_steps=inner_steps,
        seed=fsdp.SEED), ctx.coords[dax], ctx.shape[dax])
    ctx.state["fsdp"] = {
        "step": step, "sync": sync,
        "state": ts.local_train_state(model, plan, mesh, params),
        "outer": ts.local_outer_state(
            model, plan, mesh, ts.shard_tree(params, specs, mesh), dcfg),
        "pipe": pipe, "t": 0, "dax": dax, "shard": shard}
    return shard


def refusal(ctx, arch, plan) -> str:
    """The error ``build_train_step`` raises for the reduced ``arch``
    under ``plan`` ('' when it builds)."""
    mesh = ctx.device_mesh(plan.diloco_axis, "gloo")
    try:
        ts.build_train_step(model_of(ctx, arch), plan, mesh, AdamW())
    except ValueError as e:
        return str(e)
    return ""


def split_gathers(ctx, plan, rows: int, s: int, x, y, cs, cg,
                  local_backend):
    """The step's sequence split (over ``plan.act_seq_axis``) and token
    grid (over the worker's ranks) laid over ``s`` positions, alone:
    this rank gathers its block of ``x`` (its worker's (R, s, D), R the
    rows of the worker's ranks together) by positions and of ``y``
    ((R * s, E), b-major) by (rows, positions), and takes as its loss
    the gathered wholes times its coefficients (``cs``, ``cg``: one
    (rows of its seq group, s, D) and one (R * s, E) a rank, by global
    rank). Returns the gathered wholes and the gradients of its blocks:
    summed over the ranks, each block's is the sum of the coefficients
    at its cells."""
    mesh = ctx.device_mesh(plan.diloco_axis, local_backend)
    amap = ts.mesh_axes(mesh)
    dax = plan.diloco_axis
    worker_axes = tuple(a for a in amap if a != dax)
    entry = plan.batch_axes[0] if len(plan.batch_axes) == 1 \
        else plan.batch_axes
    wgroup = ts._group(mesh, worker_axes)
    n_rows = amap[entry] if isinstance(entry, str) else 1
    r = x.shape[0] // n_rows
    hint = ts._sp_hints(mesh, plan, entry, worker_axes, wgroup,
                        ctx.device)(r)
    seq, grid = hint.seq.over(s), hint.batch.over(s)
    r0, r1 = grid.rows[grid.index]
    xb = x[r0:r1, seq.lo:seq.hi].clone().requires_grad_()
    yb = grid.mine(y).clone().requires_grad_()
    gx, gy = seq.gather_seq(xb), grid.gather(yb)
    loss = (gx * cs[ctx.rank]).sum() + (gy * cg[ctx.rank]).sum()
    loss.backward()
    return {"x": gx.detach(), "y": gy.detach(), "gx": xb.grad,
            "gy": yb.grad, "rows": (r0, r1), "cols": (seq.lo, seq.hi),
            "grid_cols": grid.cols[grid.index]}


def unsplit_step_bitwise(ctx, arch, plan, params, batch, local_backend):
    """Two steps of ``build_train_step`` under ``plan`` and under ``plan``
    without its SP axis, from the same state: whether the losses and
    the parameters are equal bit for bit (a plan whose SP axis has one
    rank runs the path without sequence parallelism)."""
    import dataclasses
    from repro_torch.core.sync_engine import leaves, tree_map
    from repro_torch.optim.adamw import AdamW
    mesh = ctx.device_mesh(plan.diloco_axis, local_backend)
    cfg = get_config(arch).reduced()
    model = get_model(cfg, device=ctx.device)
    out = []
    for p in (plan, dataclasses.replace(plan, act_seq_axis=None)):
        step, _ = ts.build_train_step(model, p, mesh, AdamW(lr=1e-3))
        state = ts.local_train_state(model, p, mesh, tree_map(
            lambda t: t.to(ctx.device), params))
        losses = []
        for _ in range(2):
            state, m = step(state, batch)
            losses.append(m["loss"])
        out.append((torch.stack(losses), leaves(state.params)))
    (la, pa), (lb, pb) = out
    return bool(torch.equal(la, lb)) and all(
        torch.equal(a, b) for a, b in zip(pa, pb))
