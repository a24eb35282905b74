"""Sequence parallelism in the port's hybrid DiLoCo-FSDP train step
(``repro_torch.train.step.build_train_step`` under ``plan.act_seq_axis``)
on one (2, 2, 2) ("pod", "data", "model") gloo mesh of rank processes on
the CPU: DiLoCo over 'pod', each worker's rows over 'data' and its
positions over 'model', the parameters laid over ('data', 'model')
combined (the multi-pod rules), against ``repro``'s unsharded
per-worker step (``tests/sp_reference.py``):

  * the reduced internlm2-1.8b at 64 positions, 4 steps, with a
    uniform mask, a random 0/1 mask (which a mean of the ranks' means
    would miss) and remat off, and the reduced h2o-danube-1.8b, whose
    window of 32 crosses the position blocks' boundary: losses and
    every metric within 1e-4, the first step's gradient, assembled from
    the ranks' blocks by ``repro``'s specs, within 1e-5;
  * the split's gathers alone (``act_hints.SeqSplit`` by positions and
    ``act_hints.GridSplit`` by rows and positions) over 7 positions,
    uneven blocks: the wholes gathered in order, and each block's
    gradient the summed gradient of the whole at its cells;
  * the launcher's rank commands (``launch.fsdp``) on the mesh: SP
    inner steps, then an int8 outer sync whose anchor is, on every
    rank, bitwise the port's ``outer_sync_sim`` on its shard's rows
    (the ranks' parameters), with ``codec_calls(2)`` codec calls a
    rank;
  * the SSM and hybrid families, whose losses do not split by
    positions, refuse a sequence split;
  * a plan whose SP axis has one rank runs bitwise as the same plan
    without it (a (2, 1) mesh);
  * ``partition.stacked_blocks``, the rows of a weight gradient's
    reduce-scatter, are the ranks' ``local_block``s.

The MoE, VLM and enc-dec families: ``test_torch_sp_train_families.py``."""
import numpy as np
import pytest
import torch

import sp_ranks as spr
import sp_reference as ref
from repro_torch.core import ring_reduce as rr
from repro_torch.launch.mesh import make_mesh
from repro_torch.sharding import partition
from repro_torch.sharding.plans import ParallelismPlan

torch.set_float32_matmul_precision("highest")
torch.set_num_threads(2)

ARCH = "internlm2-1.8b"
GRAD_TOL = 1e-5


@pytest.fixture(scope="module")
def mesh():
    with make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu",
                   timeout=300.0) as m:
        yield m


@pytest.mark.parametrize("arch,random_mask,remat", [
    (ARCH, False, True), (ARCH, True, True), (ARCH, True, False),
    ("h2o-danube-1.8b", True, True)],
    ids=["uniform_mask", "random_mask", "no_remat", "swa"])
def test_sp_step_matches_reference(mesh, arch, random_mask, remat):
    plan = ref.sp_plan(remat=remat)
    jparams, params = ref.ref_params(arch)
    b = ref.batch(arch, 2, 64, random_mask=random_mask)
    res = mesh.call(spr.train, arch, plan, params, ref.torch_batch(b), 4,
                    ref.LR, "gloo")
    want, grads = ref.ref_steps(arch, jparams, b, 4)
    ref.assert_metrics(res, mesh, want)
    assert set(res[0]["metrics"][0]) == set(want)
    ref.assert_every_leaf(res, mesh, "grads", grads,
                          ref.ref_specs(arch, plan), GRAD_TOL)


def test_split_gathers_with_uneven_bounds(mesh):
    plan = ref.sp_plan()
    rows, s, d, e = 4, 7, 3, 5                 # 2 rows a 'data' rank
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((rows, s, d), generator=gen)
    y = torch.randn((rows * s, e), generator=gen)
    cs = torch.randn((mesh.size, rows // 2, s, d), generator=gen)
    cg = torch.randn((mesh.size, rows * s, e), generator=gen)
    res = mesh.call(spr.split_gathers, plan, rows, s, x, y, cs, cg, "gloo")
    assert {out["cols"] for out in res} == {(0, 3), (3, 7)}
    for r, out in enumerate(res):
        c = mesh.coords(r)
        (r0, r1), (lo, hi) = out["rows"], out["cols"]
        assert out["grid_cols"] == (lo, hi)
        assert torch.equal(out["x"], x[r0:r1])
        assert torch.equal(out["y"], y)
        # the unsplit gradients: the seq group's coefficients summed (its
        # ranks share the rows), the worker's for the grid
        seq = [q for q in range(mesh.size) if all(
            mesh.coords(q)[a] == c[a] for a in ("pod", "data"))]
        wrk = [q for q in range(mesh.size)
               if mesh.coords(q)["pod"] == c["pod"]]
        gx = sum(cs[q] for q in seq)[:, lo:hi]
        gy = sum(cg[q] for q in wrk).reshape(rows, s, e)[r0:r1, lo:hi]
        torch.testing.assert_close(out["gx"], gx, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(out["gy"], gy.reshape(-1, e),
                                   rtol=1e-6, atol=1e-6)


def test_launcher_sp_steps_then_int8_sync_as_the_simulator(mesh):
    """Two SP inner steps a worker (2 sequences of 64 positions) through
    the launcher's rank commands, then the int8 outer sync: each rank's
    new anchor bitwise the port's ``outer_sync_sim`` on its shard's rows
    (every worker's block of it, as ``rank_flat_params`` writes them),
    each rank's codec calls ``codec_calls(2)``."""
    from repro_torch.core import diloco as tdl
    from repro_torch.core.sync_engine import SyncEngine, from_paths, tree_map
    from repro_torch.launch import fsdp
    from repro_torch.models.registry import get_model
    from repro_torch.train import step as ts
    plan = ref.sp_plan()
    fc = fsdp.FSDPConfig(ARCH, reduced=True)
    model = get_model(fsdp.model_config(fc), device="cpu")
    specs = ts.param_specs(model, plan, ref.AMAP)
    n_shards = ref.AMAP["data"] * ref.AMAP["model"]
    blocks = [{"data": i // 2, "model": i % 2} for i in range(n_shards)]
    params0 = model.init(fsdp.SEED)
    dcfg = tdl.DiLoCoConfig(inner_steps=2, quant="int8")
    local = [tree_map(lambda sp, t: partition.local_block(
        t, sp, ref.AMAP, c).clone(), specs, params0) for c in blocks]
    eng = SyncEngine.for_tree(local[0])
    sims = [tdl.init_outer_state_sim(t, dcfg, ref.K) for t in local]
    thetas = torch.empty((ref.K, n_shards, eng.numel))
    shards = mesh.call(spr.build, ARCH, plan, 64, 2, 2)
    assert shards == [blocks.index({a: mesh.coords(r)[a] for a in blocks[0]})
                      for r in range(mesh.size)]
    inner = mesh.call(fsdp.rank_inner, 2)
    mesh.call(fsdp.rank_flat_params, thetas)
    want = torch.empty((n_shards, eng.numel))
    for i in range(n_shards):
        rows = from_paths(eng.paths, [
            thetas[:, i, o:o + n].view((ref.K,) + shape) for o, n, shape
            in zip(eng.offsets, eng.sizes, eng.shapes)])
        _, sims[i] = tdl.outer_sync_sim(rows, sims[i], dcfg)
        want[i] = sims[i].anchor_flat
    res = mesh.call(fsdp.rank_sync, want)
    mesh.call(fsdp.rank_drop)
    assert [(r["anchor_equal"], r["calls"]) for r in res] == \
        [(True, rr.codec_calls(ref.K))] * mesh.size
    assert all(np.isfinite(x) for i in inner for x in i["losses"])


def test_ssm_and_hybrid_refuse_the_sequence_split(mesh):
    """Their losses score the whole sequence on every rank, so under a
    sequence split the summed gradient would count it once a rank:
    ``build_train_step`` refuses the plan."""
    for arch in ("mamba2-130m", "zamba2-2.7b"):
        assert all("does not split by positions" in e for e in mesh.call(
            spr.refusal, arch, ref.sp_plan()))


def test_sp_axis_of_one_rank_runs_unsplit_bitwise():
    plan = ParallelismPlan(
        diloco_axis="data",
        rules=(("vocab", "model"), ("heads", "model"), ("ff", "model"),
               ("experts", "model"), ("embed", None), ("layers", None)),
        batch_axes=(),
        seq_axis=None, remat=True, n_workers=2, act_seq_axis="model")
    _, params = ref.ref_params(ARCH)
    b = ref.torch_batch(ref.batch(ARCH, 2, 32))
    with make_mesh((2, 1), ("data", "model"), device="cpu",
                   timeout=300.0) as m:
        assert m.call(spr.unsplit_step_bitwise, ARCH, plan, params, b,
                      "gloo") == [True, True]


@pytest.mark.parametrize("spec,axes", [
    ((("data", "model"),), ("data", "model")),
    (("model", None, "data"), ("data", "model")),
    ((None, "model"), ("model",))], ids=["combined", "two_dims", "one"])
def test_stacked_blocks_are_the_ranks_local_blocks(spec, axes):
    """``partition.stacked_blocks`` (the rows a weight's gradient is
    reduce-scattered by): row r is rank r's ``local_block``, ranks
    row-major over ``axes``."""
    x = torch.randn((8, 6, 4))
    rows = partition.stacked_blocks(x, spec, ref.AMAP, axes)
    for r, idx in enumerate(np.ndindex(*(ref.AMAP[a] for a in axes))):
        coords = dict(zip(axes, idx))
        assert torch.equal(rows[r], partition.local_block(x, spec, ref.AMAP,
                                                          coords))
