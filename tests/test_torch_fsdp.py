"""The port's hybrid DiLoCo-FSDP train step and its sharded outer sync
(``repro_torch.train.step``: ``build_train_step``, ``build_outer_sync``)
on one (4, 2) ("data", "model") gloo mesh of rank processes on the CPU,
against ``repro`` and the port's unsharded paths (the cases of the
reference's ``tests/test_distributed.py``):

  * the train step on the reduced internlm2-1.8b (its plan: DiLoCo over
    'data', the batch over 'model', replicated parameters) makes the
    same 8 losses per worker as ``repro``'s unsharded per-worker step
    (value_and_grad and AdamW, vmapped over the workers) within 1e-4,
    and as the port's unsharded step within 1e-5;
  * under a random 0/1 mask (some rows all zero) the row-only step's
    losses equal ``repro``'s within 1e-4 at every step (internlm2-1.8b
    with 1 and 2 microbatches, mamba2-130m): a rank's loss is its share
    of the worker's one masked mean (``act_hints.LossSplit``);
  * the forced-TP plan shards the parameters: every rank's local shapes
    are ``local_shape`` of ``repro``'s spec, and its losses the
    unsharded step's within 1e-5; so are a 2-D FSDP plan's (no DiLoCo,
    'embed' over 'data' and the TP dims over 'model', dbrx's single-pod
    shape, with 2 microbatches and remat);
  * the replicated plan (reduced mamba2-130m) threads ``anchor_flat``:
    bitwise a fresh flatten, and two chained syncs within 1e-5 / 1e-6
    of ``repro``'s ``outer_sync_sim`` (fp32 ring) in every leaf;
  * the sharded plan's threaded path is bitwise its tree path and two
    chained syncs within 1e-4 / 1e-5 of the simulation in every leaf,
    assembled from the ranks' blocks by ``repro``'s specs (fp32 ring:
    per-shard sums add in another order);
  * the int8 sharded ring is bitwise the port's simulator on each
    shard's rows, with ``codec_calls(4)`` codec calls a rank;
  * error feedback with a sharded plan raises;
  * a token-choice MoE (reduced deepseek-moe-16b, fp32) with its
    worker's batch split over 'model' routes over the whole batch, as
    ``repro``'s one program does: losses, ``lb_loss`` and
    ``dropped_frac`` within 1e-4 of ``repro``'s unsharded per-worker
    step, with 1 and 2 microbatches (the reference's rows of the
    worker's batch); one row a rank (no microbatch of the reference's
    divides over the ranks) updates as the reference, each rank's row
    one of its microbatches, and reports the ranks' mean.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fsdp_ranks as fr
from repro.configs import CONFIGS as JCONFIGS
from repro.core import diloco as jdl
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro.models.registry import get_model as jget_model
from repro.optim.adamw import AdamW as JAdamW
from repro.sharding import partition as jpart
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import from_jax_params
from repro_torch.core import ring_reduce as rr
from repro_torch.core.sync_engine import (from_paths, leaves,
                                          leaves_with_paths, tree_map)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.registry import get_model
from repro_torch.optim.adamw import AdamW
from repro_torch.sharding import partition
from repro_torch.sharding.plans import ParallelismPlan, make_plan

torch.set_float32_matmul_precision("highest")

AMAP = {"data": 4, "model": 2}
K = 4
SHAPE = ShapeConfig("t", "train", 32, 8)
LR = 1e-3
TP = ParallelismPlan(
    diloco_axis="data",
    rules=(("vocab", "model"), ("heads", "model"), ("ff", "model"),
           ("experts", "model"), ("embed", None), ("layers", None)),
    batch_axes=(), seq_axis=None, remat=True, n_workers=K)
FSDP_2D = ParallelismPlan(
    diloco_axis=None,
    rules=(("vocab", "model"), ("heads", "model"), ("ff", "model"),
           ("experts", "model"), ("embed", "data"), ("layers", None)),
    batch_axes=("data", "model"), seq_axis=None, remat=True, n_workers=1,
    microbatches=2)


@pytest.fixture(scope="module")
def mesh():
    with make_mesh((4, 2), ("data", "model"), device="cpu",
                   timeout=300.0) as m:
        yield m


def _ref_params(arch):
    params, _ = jget_model(JCONFIGS[arch].reduced()).init(
        jax.random.PRNGKey(0))
    return params, from_jax_params(jax.tree.map(np.asarray, params), "cpu")


def _batch(cfg, lead, seed=1, seq=32, zero_rows=None):
    """Random tokens; the mask all ones or, with ``zero_rows`` (indices
    into ``lead``), random 0/1 with those rows all zero."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, lead + (seq + 1,)).astype(np.int32)
    mask = np.ones(lead + (seq,), np.float32)
    if zero_rows is not None:
        mask = (rng.random(lead + (seq,)) < 0.6).astype(np.float32)
        for row in zero_rows:
            mask[row] = 0.0
    return {"tokens": tok[..., :-1], "targets": tok[..., 1:], "mask": mask}


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _unsharded(arch, params, batch, n_steps):
    """The port's unsharded step: loss, grad and AdamW on one worker's
    whole batch. Returns the losses and the final parameters."""
    model = get_model(get_config(arch).reduced(), device="cpu")
    opt = AdamW(lr=LR)
    params = tree_map(torch.clone, params)
    st = opt.init(params)
    out = []
    for _ in range(n_steps):
        req = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, _ = model.loss(req, batch)
        gs = torch.autograd.grad(loss, leaves(req))
        opt.update_(from_paths([p for p, _ in leaves_with_paths(req)], gs),
                    st, params)
        out.append(float(loss.detach()))
    return out, params


@functools.lru_cache(maxsize=None)
def _ref_step(arch, nmb):
    """repro's unsharded per-worker step, vmapped over the workers and
    jitted once for the module (its compiles are the cases' largest
    cost): (optimizer, step). With ``nmb`` microbatches (rows [i B / n,
    (i + 1) B / n)) the gradients are their mean and the loss the last
    one's, as ``repro``'s ``build_train_step`` accumulates."""
    jm = jget_model(JCONFIGS[arch].reduced())
    opt = JAdamW(lr=LR)
    value_and_grad = jax.value_and_grad(jm.loss, has_aux=True)

    def grad(p, b):
        if nmb == 1:
            return value_and_grad(p, b)
        rows = next(iter(b.values())).shape[0] // nmb
        outs = [value_and_grad(p, {k: v[i * rows:(i + 1) * rows]
                                   for k, v in b.items()})
                for i in range(nmb)]
        g = jax.tree.map(lambda *gs: sum(gs) / nmb,
                         *[g for _, g in outs])
        return outs[-1][0], g

    @jax.jit
    def step(p, s, b):
        (_, m), g = jax.vmap(grad)(p, b)
        p, s = jax.vmap(opt.update)(g, s, p)
        return p, s, m["loss"]
    return opt, step


def _ref_losses(arch, params, batch, n_steps, nmb=1):
    """``_ref_step``'s losses over ``n_steps`` from ``params``."""
    opt, step = _ref_step(arch, nmb)
    stacked = jax.tree.map(lambda x: jnp.stack([x] * K), params)
    st = jax.vmap(opt.init)(stacked)
    out = []
    for _ in range(n_steps):
        stacked, st, loss = step(stacked, st, batch)
        out.append(np.asarray(loss))
    return np.stack(out, 1)               # (K, n_steps)


def test_train_step_equals_reference_and_unsharded(mesh):
    arch = "internlm2-1.8b"
    cfg = get_config(arch).reduced()
    plan = make_plan(cfg, SHAPE, AMAP)
    assert plan.diloco_axis == "data" and plan.batch_axes == ("model",)
    jparams, params = _ref_params(arch)
    b = _batch(cfg, (K, 2))
    res = mesh.call(fr.train, arch, plan, params, _torch_batch(b), 8, LR,
                    "gloo")
    ref = _ref_losses(arch, jparams, {k: jnp.asarray(v)
                                      for k, v in b.items()}, 8)
    for r, out in enumerate(res):
        w = mesh.coords(r)["data"]
        np.testing.assert_allclose(out["losses"], ref[w], rtol=1e-4,
                                   atol=1e-4)
        want, _ = _unsharded(arch, params, {
            k: torch.from_numpy(v[w]) for k, v in b.items()}, 8)
        np.testing.assert_allclose(out["losses"], want, rtol=1e-5,
                                   atol=1e-5)
    assert out["losses"][-1] < out["losses"][0]


@pytest.mark.parametrize("arch,nmb,rows", [("internlm2-1.8b", 1, 2),
                                           ("internlm2-1.8b", 2, 4),
                                           ("mamba2-130m", 1, 4)],
                         ids=["internlm2", "internlm2_two_microbatches",
                              "mamba2"])
def test_random_mask_losses_equal_reference(mesh, arch, nmb, rows):
    """The row-only step under a ragged mask: each rank's loss is its
    rows' masked sum over the worker's (micro)batch's mask sum, so the
    worker's loss is the reference's one masked mean, not a mean of the
    ranks' means (the SSM's loss too: its rows' scans are whole). Some
    rows, and so some ranks' whole (micro)batch rows, are all zero.
    internlm2-1.8b's single microbatch takes the first test's batch
    shape, so the reference's compile is shared."""
    cfg = get_config(arch).reduced()
    plan = dataclasses.replace(make_plan(cfg, SHAPE, AMAP),
                               microbatches=nmb)
    assert plan.diloco_axis == "data" and plan.batch_axes == ("model",)
    jparams, params = _ref_params(arch)
    b = _batch(cfg, (K, rows), seed=3,
               zero_rows=[(0, 1), (1, rows - 2), (3, 0)])
    res = mesh.call(fr.train, arch, plan, params, _torch_batch(b), 2, LR,
                    "gloo")
    ref = _ref_losses(arch, jparams, {k: jnp.asarray(v)
                                      for k, v in b.items()}, 2, nmb)
    for r, out in enumerate(res):
        np.testing.assert_allclose(out["losses"], ref[mesh.coords(r)[
            "data"]], rtol=1e-4, atol=1e-4, err_msg=f"rank {r}")


@pytest.mark.parametrize("plan", [TP, FSDP_2D], ids=["tp", "fsdp_2d"])
def test_sharded_plans_local_shapes_and_losses(mesh, plan):
    arch = "internlm2-1.8b"
    cfg = get_config(arch).reduced()
    jparams, params = _ref_params(arch)
    jm = jget_model(JCONFIGS[arch].reduced())
    shapes, axes = jcommon.eval_axes(jm.init, jax.random.PRNGKey(0))
    jspecs = jpart.param_pspecs(axes, shapes, plan, AMAP)
    jspecs = jpart.with_leading(jspecs, plan.diloco_axis)
    lead = (K,) if plan.diloco_axis else ()
    want_shapes = jax.tree.map(
        lambda s, spec: partition.local_shape(lead + tuple(s.shape),
                                              tuple(spec), AMAP),
        shapes, jspecs)
    assert any(len(tuple(s)) > len(lead) for s in jax.tree.leaves(
        jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    # the 2-D plan: 2 rows a rank, so its 2 microbatches are 1 row each
    b = _batch(cfg, (K, 2) if plan.diloco_axis else (16,))
    res = mesh.call(fr.train, arch, plan, params, _torch_batch(b), 3, LR,
                    "gloo")
    specs = _ref_specs(arch, plan)
    for r, out in enumerate(res):
        assert out["shapes"] == want_shapes
        c = mesh.coords(r)
        own = {k: torch.from_numpy(v[c["data"]] if plan.diloco_axis else v)
               for k, v in b.items()}
        losses, final = _unsharded(arch, params, own, 3)
        if plan.microbatches == 1:     # else: the last microbatch's loss
            np.testing.assert_allclose(out["losses"], losses, rtol=1e-5,
                                       atol=1e-5)
        for (path, got), want in zip(leaves_with_paths(out["params"]),
                                     leaves(final)):
            np.testing.assert_allclose(
                (got[0] if plan.diloco_axis else got).numpy(),
                partition.local_block(want, _at(specs, path), AMAP,
                                      c).numpy(),
                rtol=1e-5, atol=1e-5, err_msg=str(path))


def _stacked(params):
    return tree_map(lambda x: torch.stack([x + 0.01 * i for i in range(K)]),
                    params)


def _sim(jparams, stacked, quant="fp32"):
    """repro's simulated outer sync, chained twice from ``stacked``."""
    dcfg = jdl.DiLoCoConfig(quant=quant)
    js = jax.tree.map(lambda t: jnp.asarray(t.numpy()), stacked)
    st = jdl.init_outer_state_sim(jparams, dcfg, K)
    p1, st = jdl.outer_sync_sim(js, st, dcfg)
    p2, _ = jdl.outer_sync_sim(p1, st, dcfg)
    return p1, p2


def _ref_specs(arch, plan):
    """``repro``'s parameter specs for ``plan`` on ``AMAP``, as tuples."""
    jm = jget_model(JCONFIGS[arch].reduced())
    shapes, axes = jcommon.eval_axes(jm.init, jax.random.PRNGKey(0))
    return jax.tree.map(
        tuple, jpart.param_pspecs(axes, shapes, plan, AMAP),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _assert_every_leaf(res, mesh, key, want, specs, rtol, atol):
    """Every (K, ...) leaf of ``key``, assembled from the ranks' local
    blocks (each rank's block written where ``partition.local_block``
    cuts worker ``data``'s leaf by ``repro``'s spec), against ``want``
    (``repro``'s stacked parameters). A block no rank wrote stays NaN
    and fails."""
    for path, _ in leaves_with_paths(res[0][key]):
        ref = np.asarray(_at(want, path), np.float32)
        full = torch.full(ref.shape, float("nan"))
        for r in range(mesh.size):
            c = mesh.coords(r)
            partition.local_block(full[c["data"]], _at(specs, path), AMAP,
                                  c).copy_(_at(res[r][key], path)[0])
        np.testing.assert_allclose(full.numpy(), ref, rtol=rtol, atol=atol,
                                   err_msg=f"{key} {path}")


def test_replicated_plan_sync_threads_anchor_flat(mesh):
    arch = "mamba2-130m"
    cfg = get_config(arch).reduced()
    plan = make_plan(cfg, SHAPE, AMAP)
    assert plan.diloco_axis == "data"
    jparams, params = _ref_params(arch)
    stacked = _stacked(params)
    res = mesh.call(fr.sync_chain, arch, plan, params, stacked, "fp32",
                    torch.ones(K), "gloo")
    p1, p2 = _sim(jparams, stacked)
    for out in res:
        assert out["flat_spec"] == ()
        assert torch.equal(out["flat1"], out["fresh1"])
        assert torch.equal(out["flat2a"], out["flat2b"])
    specs = _ref_specs(arch, plan)
    for key, want in (("p1", p1), ("p2a", p2)):
        _assert_every_leaf(res, mesh, key, want, specs, 1e-5, 1e-6)


def test_sharded_plan_threads_per_shard_anchor_flat(mesh):
    arch = "internlm2-1.8b"
    jparams, params = _ref_params(arch)
    stacked = _stacked(params)
    res = mesh.call(fr.sync_chain, arch, TP, params, stacked, "fp32",
                    torch.ones(K), "gloo")
    numel = sum(t.numel() for t in leaves(params))
    p1, p2 = _sim(jparams, stacked)
    for out in res:
        assert out["flat_spec"] == ("model",)
        # the per-shard view plus its sentinel, never a global flatten
        assert out["flat1"].numel() == out["fresh1"].numel() + 1 != numel
        assert torch.equal(out["flat1"][:-1], out["fresh1"])
        assert torch.equal(out["flat2a"], out["flat2b"])
        for a, b in zip(leaves(out["p2a"]), leaves(out["p2b"])):
            assert torch.equal(a, b)
    specs = _ref_specs(arch, TP)
    assert any(jax.tree.leaves(specs,
                               is_leaf=lambda x: isinstance(x, tuple)))
    for key, want in (("p1", p1), ("p2a", p2)):
        _assert_every_leaf(res, mesh, key, want, specs, 1e-4, 1e-5)


def test_int8_sharded_ring_bitwise_per_shard_simulator(mesh):
    arch = "internlm2-1.8b"
    _, params = _ref_params(arch)
    weights = torch.tensor([1.0, 0.5, 0.0, 2.0])
    res = mesh.call(fr.sharded_ring_vs_sim, arch, TP, params,
                    _stacked(params), weights, "gloo")
    want = rr.codec_calls(K)
    for out in res:
        assert out["anchor"] and out["params"]
        assert {n: c for n, (c, _) in out["counts"].items()} == want


def test_error_feedback_with_sharded_plan_raises(mesh):
    assert mesh.call(fr.ef_sharded_raises, "internlm2-1.8b", TP) == \
        [True] * mesh.size


def test_launcher_trains_and_syncs_as_the_simulator(mesh):
    """``launch.fsdp.run``: two outer steps of inner training and int8
    syncs on the reduced internlm2-1.8b; every sync's anchor, on every
    rank, is bitwise the port's ``outer_sync_sim`` on the same stacked
    parameters (the inner steps between syncs write the parameters in
    place: they must not alias the anchor), each rank's codec calls
    ``codec_calls(4)`` a sync."""
    from repro_torch.core import diloco as tdl
    from repro_torch.core.sync_engine import SyncEngine
    from repro_torch.launch import fsdp
    fc = fsdp.FSDPConfig("internlm2-1.8b", reduced=True, seq_len=32,
                         batch_per_worker=4, inner_steps=2)
    model = get_model(fsdp.model_config(fc), device="cpu")
    eng = SyncEngine.for_tree(model.param_shapes())
    dcfg = tdl.DiLoCoConfig(inner_steps=2, quant="int8")
    sim = {"state": tdl.init_outer_state_sim(model.init(0), dcfg, K)}
    thetas = torch.empty((K, eng.numel))
    checks = []

    def on_sync(t, mesh):
        mesh.call(fsdp.rank_flat_params, thetas)
        stacked = from_paths(eng.paths, [
            thetas[:, o:o + n].view((K,) + shape) for o, n, shape in
            zip(eng.offsets, eng.sizes, eng.shapes)])
        _, sim["state"] = tdl.outer_sync_sim(stacked, sim["state"], dcfg)
        res = mesh.call(fsdp.rank_sync, sim["state"].anchor_flat)
        checks.append([(r["anchor_equal"], r["calls"]) for r in res])
        return res

    info, hist = fsdp.run(mesh, fc, 2, on_sync)
    mesh.call(fsdp.rank_drop)
    assert info["plan"]["diloco_axis"] == "data"
    assert checks == [[(True, rr.codec_calls(K))] * mesh.size] * 2
    for h in hist:
        assert h["launches"] == dict.fromkeys(rr.CODEC, 0)   # the CPU
        assert np.isfinite(h["loss"])


# -- MoE routing over a worker's split batch ----------------------------------

MOE = "deepseek-moe-16b"
GRAD_TOL = 1e-5


def _ref_moe_dropped(jcfg, params, tokens):
    """``dropped_frac`` of ``repro``'s forward on ``tokens``: the mean
    over the MoE layers (the port's metric), layer by layer."""
    x = jcommon.embedding_lookup(params["embed"], tokens)
    b, s = tokens.shape
    pos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
    for i in range(jcfg.moe.first_dense):
        x, _, _ = jtf._layer(jcfg, params[f"dense{i}"], x, positions=pos,
                             is_moe=False)
    drops = []
    for l in range(params["layers"]["wq"].shape[0]):
        p = jax.tree.map(lambda a: a[l], params["layers"])
        x, _, aux = jtf._layer(jcfg, p, x, positions=pos, is_moe=True)
        drops.append(aux["dropped_frac"])
    return jnp.mean(jnp.stack(drops))


def _ref_moe_steps(params, batch, n_steps, nmb):
    """``repro``'s per-worker step (``build_train_step``'s body without a
    mesh): microbatch i is rows [i B / n, (i + 1) B / n), gradients
    averaged in fp32, then AdamW. Returns per worker the (n_steps, 2, 3)
    loss, lb_loss and dropped_frac of the last microbatch (the
    reference's metrics) and their mean over the microbatches, and the
    first step's gradient (the microbatches' mean), stacked (K, ...)
    over the workers."""
    jcfg = JCONFIGS[MOE].reduced()
    jm = jget_model(jcfg)
    opt = JAdamW(lr=LR)

    @jax.jit
    def grad(p, b):
        rows = b["tokens"].shape[0] // nmb
        acc = jax.tree.map(jnp.zeros_like, p)
        ms = []
        for i in range(nmb):
            mb = {k: v[i * rows:(i + 1) * rows] for k, v in b.items()}
            (_, m), g = jax.value_and_grad(jm.loss, has_aux=True)(p, mb)
            acc = jax.tree.map(jnp.add, acc, g)
            ms.append(jnp.stack([m["loss"], m["lb_loss"],
                                 _ref_moe_dropped(jcfg, p, mb["tokens"])]))
        g = jax.tree.map(lambda g: g / nmb, acc)
        return g, jnp.stack([ms[-1], jnp.mean(jnp.stack(ms), 0)])

    @jax.jit
    def step(p, st, b):
        g, m = grad(p, b)
        p, st = opt.update(g, st, p)
        return p, st, m
    out, firsts = [], []
    for w in range(K):
        p, st, hist = params, opt.init(params), []
        wb = {k: jnp.asarray(v[w]) for k, v in batch.items()}
        firsts.append(grad(p, wb)[0])
        for _ in range(n_steps):
            p, st, m = step(p, st, wb)
            hist.append(np.asarray(m))
        out.append(np.stack(hist))
    return out, jax.tree.map(lambda *x: np.stack(x), *firsts)


@pytest.mark.parametrize("nmb,rows,seq", [(1, 4, 64), (2, 4, 64),
                                          (2, 2, 96)],
                         ids=["one_microbatch", "two_microbatches",
                              "one_row_a_rank"])
def test_moe_routes_over_the_workers_batch(mesh, nmb, rows, seq):
    """The MoE repair: a rank's block (128 or 64 tokens) and the
    worker's (micro)batch route differently (a block of more than 64
    tokens gives each expert 1.25 k T / E). ``one_row_a_rank``: the
    reference's 2 microbatches of 1 row (96 tokens) are the 2 ranks'
    rows, so each rank routes its own and the update is the
    reference's; the metrics are the mean over the ranks (the reference
    reports the last microbatch's). The first step's gradient, every
    rank's block assembled by ``repro``'s specs, is the reference's
    within GRAD_TOL: ``lb_loss`` reaches it once (``_GatherRows``'s
    backward sums it over the ranks, the step divides by their count;
    Adam's normalised update hides a wrong weight on it in the losses,
    and makes the parameters after a step differ in a few elements by
    up to the learning rate on a gradient near 0)."""
    cfg = get_config(MOE).reduced()
    plan = dataclasses.replace(
        make_plan(cfg, ShapeConfig("t", "train", seq, K * rows), AMAP),
        microbatches=nmb)
    assert plan.diloco_axis == "data" and plan.batch_axes == ("model",)
    jparams, params = _ref_params(MOE)
    b = _batch(cfg, (K, rows), seq=seq)
    res = mesh.call(fr.train, MOE, plan, params, _torch_batch(b), 3, LR,
                    "gloo")
    ref, grads = _ref_moe_steps(jparams, b, 3, nmb)
    aligned = rows // nmb >= AMAP["model"]
    for r, out in enumerate(res):
        want = ref[mesh.coords(r)["data"]][:, 0 if aligned else 1]
        got = np.array([[m["loss"], m["lb_loss"], m["dropped_frac"]]
                        for m in out["metrics"]])
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        assert want[:, 2].max() > 0           # the capacity drops tokens
    first = mesh.call(fr.first_grads, MOE, plan, params, _torch_batch(b),
                      "gloo")
    _assert_every_leaf(first, mesh, "grads", grads, _ref_specs(MOE, plan),
                       GRAD_TOL, GRAD_TOL)
