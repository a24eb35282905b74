"""Rank-side commands of ``test_torch_fsdp.py`` (and its card twin):
each runs in every process of a ``RankMesh`` as ``fn(ctx, *args)``.
This module imports no JAX, so the rank processes stay light."""
import torch

from repro_torch.configs import get_config
from repro_torch.core import diloco as dl
from repro_torch.core import ring_reduce as rr
from repro_torch.core.sync_engine import SyncEngine, leaves, tree_map
from repro_torch.kernels import int8_quant as iq
from repro_torch.models.registry import get_model
from repro_torch.optim.adamw import AdamW
from repro_torch.sharding import partition
from repro_torch.train import step as ts


def model_of(ctx, arch: str, n_layers=None):
    import dataclasses
    cfg = get_config(arch)
    cfg = cfg.reduced() if n_layers is None else dataclasses.replace(
        cfg, n_layers=n_layers)
    return get_model(cfg, device=ctx.device)


def train(ctx, arch, plan, params, batch, n_steps, lr, local_backend):
    """``n_steps`` of ``build_train_step`` from ``params`` (the whole
    tree); returns the losses, every step's metrics, this rank's local
    parameter shapes and its final local parameters (on the host)."""
    torch.set_float32_matmul_precision("highest")
    mesh = ctx.device_mesh(plan.diloco_axis, local_backend)
    model = model_of(ctx, arch)
    opt = AdamW(lr=lr)
    step, _ = ts.build_train_step(model, plan, mesh, opt)
    params = tree_map(lambda t: t.to(ctx.device), params)
    batch = {k: v.to(ctx.device) for k, v in batch.items()}
    state = ts.local_train_state(model, plan, mesh, params)
    losses, hist = [], []
    for _ in range(n_steps):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        hist.append({k: float(v) for k, v in metrics.items()})
    return {"losses": losses, "metrics": hist,
            "shapes": tree_map(lambda t: tuple(t.shape), state.params),
            "params": tree_map(lambda t: t.cpu(), state.params)}


class _Recorder:
    """An optimizer that keeps the gradients it is given (on the host)
    and leaves the parameters as they are."""

    def update_(self, grads, state, params) -> None:
        self.grads = tree_map(lambda g: g.float().cpu(), grads)


def first_grads(ctx, arch, plan, params, batch, local_backend):
    """The gradient one ``build_train_step`` step hands its optimizer:
    this rank's block of its worker's gradient (a leading dim of 1, as
    the parameters have under a DiLoCo axis)."""
    torch.set_float32_matmul_precision("highest")
    mesh = ctx.device_mesh(plan.diloco_axis, local_backend)
    model = model_of(ctx, arch)
    rec = _Recorder()
    step, _ = ts.build_train_step(model, plan, mesh, rec)
    params = tree_map(lambda t: t.to(ctx.device), params)
    batch = {k: v.to(ctx.device) for k, v in batch.items()}
    step(ts.local_train_state(model, plan, mesh, params), batch)
    return {"grads": tree_map(lambda g: g[None], rec.grads)}


def sync_chain(ctx, arch, plan, params, stacked, quant, weights,
               local_backend):
    """Two outer syncs chained off the threaded flat anchor, and the
    second again from the tree path (``anchor_flat=None``). Returns this
    rank's local results (on the host)."""
    mesh = ctx.device_mesh(plan.diloco_axis, local_backend)
    model = model_of(ctx, arch)
    specs = ts.param_specs(model, plan, mesh)
    lead = partition.with_leading(specs, plan.diloco_axis)
    dev = lambda tree: tree_map(lambda t: t.to(ctx.device), tree)
    p0 = ts.shard_tree(dev(stacked), lead, mesh)
    cfg = dl.DiLoCoConfig(quant=quant)
    st = ts.local_outer_state(model, plan, mesh,
                              ts.shard_tree(dev(params), specs, mesh), cfg)
    sync, ospecs = ts.build_outer_sync(model, plan, mesh, cfg)
    w = weights[ctx.coords[plan.diloco_axis]:][:1].to(ctx.device)
    p1, st1 = sync(p0, st, w)
    fresh = SyncEngine.for_tree(st1.anchor).flatten(st1.anchor)
    p2a, st2a = sync(p1, st1, w)
    p2b, st2b = sync(p1, st1._replace(anchor_flat=None), w)
    host = lambda tree: tree_map(lambda t: t.cpu(), tree)
    return {"p1": host(p1), "p2a": host(p2a), "p2b": host(p2b),
            "flat1": st1.anchor_flat.cpu(), "fresh1": fresh.cpu(),
            "flat2a": st2a.anchor_flat.cpu(),
            "flat2b": st2b.anchor_flat.cpu(),
            "anchor1": host(st1.anchor), "flat_spec": ospecs.anchor_flat}


def sharded_ring_vs_sim(ctx, arch, plan, params, stacked, weights,
                        local_backend, plain=False):
    """One int8 sharded sync against the port's simulator on this
    shard's rows: ``outer_sync_sim`` over the k workers' blocks of this
    shard (the same codec: its ring is ``simulate_ring_all_reduce``).
    Returns whether anchors and parameters are bitwise equal, and this
    rank's codec calls and launches during the sync. With ``plain`` (a
    rank on the card) the simulator also runs on the host copies (the
    plain codec): the largest anchor difference, the share of elements
    off by more than 1e-5 (a code flipped at a bucket edge) and the
    bound a flip can reach (one bucket width of the widest row, k times
    over the total weight, times the outer step's lr (1 + momentum))."""
    mesh = ctx.device_mesh(plan.diloco_axis, local_backend)
    model = model_of(ctx, arch)
    dax = plan.diloco_axis
    k = mesh.shape[mesh.mesh_dim_names.index(dax)]
    specs = ts.param_specs(model, plan, mesh)
    dev = lambda tree: tree_map(lambda t: t.to(ctx.device), tree)
    stacked, params = dev(stacked), dev(params)
    p0 = ts.shard_tree(stacked, partition.with_leading(specs, dax), mesh)
    anchor = ts.shard_tree(params, specs, mesh)
    cfg = dl.DiLoCoConfig(quant="int8")
    st = ts.local_outer_state(model, plan, mesh, anchor, cfg)
    sync, _ = ts.build_outer_sync(model, plan, mesh, cfg)
    w = weights.to(ctx.device)
    before = {n: (iq.calls[n], getattr(iq, n).launches) for n in rr.CODEC}
    p1, st1 = sync(p0, st, w[ctx.coords[dax]:][:1])
    ctx.sync()
    counts = {n: (iq.calls[n] - before[n][0],
                  getattr(iq, n).launches - before[n][1]) for n in rr.CODEC}
    # every worker's block of THIS shard position, stacked
    amap = ts.mesh_axes(mesh)
    rows = tree_map(lambda spec, t: torch.stack([
        partition.local_block(t[i], spec, amap, ctx.coords)
        for i in range(k)]), specs, stacked)
    sim_st = dl.init_outer_state_sim(anchor, cfg, k)
    sim_p, sim_st = dl.outer_sync_sim(rows, sim_st, cfg, weights=w)
    out = {"anchor": bool(torch.equal(st1.anchor_flat[:-1],
                                      sim_st.anchor_flat)),
           "params": all(torch.equal(a[0], b[0]) for a, b in
                         zip(leaves(p1), leaves(sim_p))),
           "counts": counts, "n": sim_st.anchor_flat.numel()}
    if plain:
        host = lambda tree: tree_map(lambda t: t.cpu(), tree)
        cpu_st = dl.init_outer_state_sim(host(anchor), cfg, k)
        _, cpu_st = dl.outer_sync_sim(host(rows), cpu_st, cfg,
                                      weights=weights)
        err = (st1.anchor_flat[:-1].cpu() - cpu_st.anchor_flat).abs()
        eng = SyncEngine.for_tree(host(anchor))
        pgs = eng.flatten(host(anchor))[None] - eng.flatten_rows(host(rows))
        width = 12.0 * float(sum((w * pg).std(correction=0)
                                 for w, pg in zip(weights, pgs))) / 256
        out.update(plain_err=float(err.max()),
                   plain_flipped=float((err > 1e-5).float().mean()),
                   plain_bound=cfg.outer_lr * (1 + cfg.outer_momentum)
                   * k * width / float(weights.sum()))
    return out


def ef_sharded_raises(ctx, arch, plan):
    mesh = ctx.device_mesh(plan.diloco_axis)
    try:
        ts.build_outer_sync(model_of(ctx, arch), plan, mesh,
                            dl.DiLoCoConfig(quant="int8",
                                            error_feedback=True))
    except NotImplementedError:
        return True
    return False

