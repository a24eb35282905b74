"""The port's analysis layer and dry run (``repro_torch.analysis``,
``repro_torch.launch.dryrun``) on the CPU:

  * ``op_cost.OpCounter``: a matmul is 2mnk FLOPs, a Python layer loop
    is counted once per iteration, an elementwise op's bytes are its
    inputs plus its output and a view's none; in a fake world of 4, an
    all-reduce's wire bytes are twice its operand, an all-gather's its
    result, a reduce-scatter's its operand, a send its operand;
  * ``roofline.analyze``: the three terms on the H100 constants and the
    bottleneck;
  * ``run_cell`` at production scale (one subprocess a cell, as
    ``--all`` runs them: a process holds one fake world): internlm2-1.8b
    train_4k on the single-pod mesh and mamba2-130m on the multi-pod
    mesh. Their keys are the reference's (``repro.launch.dryrun``; an
    ``op_cost`` entry stands where its ``xla_cost`` does), and the
    parameter plus optimizer bytes per rank equal the bytes the
    reference's ``param_pspecs`` give;
  * an unsupported shape comes back ``skipped``, on both meshes (the
    serve cells: ``test_torch_dryrun_serve.py``; a multi-pod train cell
    of sequence parallelism: ``test_torch_dryrun_sp.py``).
"""
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.analysis import roofline as jroof
from repro.configs import CONFIGS as JCONFIGS
from repro.configs import SHAPES as JSHAPES
from repro.models import common as jcommon
from repro.models.registry import get_model as jget_model
from repro.sharding import make_plan as jmake_plan
from repro.sharding import partition as jpart
from repro_torch.analysis import op_cost, roofline
from repro_torch.launch import dryrun
from repro_torch.sharding import partition

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
# repro.launch.dryrun's keys: a cell, its plan, a traced step
CELL_KEYS = {"arch", "shape", "mesh", "plan", "n_chips", "train_step",
             "sync_step", "elapsed_s"}
PLAN_KEYS = {"diloco_axis", "n_workers", "batch_axes", "remat", "seq_axis"}
STEP_KEYS = {"roofline", "collectives", "memory"}


def test_matmul_flops_and_layer_loop():
    m, k, n, layers = 8, 16, 4, 5
    a, w = torch.randn(m, k), torch.randn(k, k)
    with op_cost.OpCounter() as c:
        a @ torch.randn(k, n)
    assert c.cost.flops == 2 * m * n * k
    with op_cost.OpCounter() as c:
        x = a
        for _ in range(layers):
            x = x @ w
    assert c.cost.flops == layers * 2 * m * k * k
    assert c.cost.flops_by_op["aten.mm"] == c.cost.flops


def test_elementwise_bytes_and_views():
    x, y = torch.randn(1000), torch.randn(1000)
    with op_cost.OpCounter() as c:
        x + y
    assert c.cost.hbm_bytes == 3 * 4 * 1000 and c.cost.flops == 0
    with op_cost.OpCounter() as c:
        x.view(10, 100).t()
        x[:10]
    assert c.cost.hbm_bytes == 0
    with op_cost.OpCounter() as c:
        x.to(torch.bfloat16)
    assert c.cost.hbm_bytes == 4 * 1000 + 2 * 1000


def test_collective_wire_bytes_in_a_fake_world():
    code = textwrap.dedent("""
        import json, torch
        import torch.distributed as dist
        import torch.distributed._functional_collectives as funcol
        from torch._subclasses.fake_tensor import FakeTensorMode
        from repro_torch.analysis.op_cost import OpCounter
        from repro_torch.launch.mesh import make_fake_mesh
        mesh = make_fake_mesh((4,), ("data",))
        group = mesh.get_group("data")
        out = {}
        with FakeTensorMode():
            t = torch.empty(1000)
            for name, fn in (
                    ("allreduce", lambda: dist.all_reduce(t, group=group)),
                    ("f_allreduce", lambda: funcol.all_reduce(
                        t, "sum", group)),
                    ("f_allgather", lambda: funcol.all_gather_tensor(
                        t, 0, group)),
                    ("f_reducescatter", lambda: funcol.reduce_scatter_tensor(
                        t, "sum", 0, group)),
                    ("p2p", lambda: [w.wait() for w in dist.batch_isend_irecv(
                        [dist.P2POp(dist.isend, t, 1, group),
                         dist.P2POp(dist.irecv, torch.empty(1000), 3,
                                    group)])])):
                with OpCounter() as c:
                    fn()
                out[name] = (c.cost.wire_bytes, c.cost.collective_bytes,
                             c.cost.hbm_bytes)
        print(json.dumps(out))
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=300)
    got = json.loads(res.stdout.strip().splitlines()[-1])
    b = 4 * 1000
    assert got["allreduce"][0] == 2 * b
    assert got["allreduce"][1]["all-reduce"] == 2 * b
    assert got["f_allreduce"][0] == 2 * b
    assert got["f_allgather"][1]["all-gather"] == 4 * b
    assert got["f_reducescatter"][1]["reduce-scatter"] == b
    assert got["p2p"][1]["p2p"] == b
    for wire, _, hbm in got.values():
        assert hbm == 0                    # collectives move no HBM bytes


def test_analyze_terms_and_bottleneck():
    cost = op_cost.OpCost(flops=roofline.PEAK_FLOPS,
                          hbm_bytes=2 * roofline.HBM_BW,
                          wire_bytes=0.5 * roofline.LINK_BW)
    r = roofline.analyze(cost, n_chips=4, model_flops=2 * roofline.PEAK_FLOPS)
    assert (r.compute_s, r.memory_s, r.collective_s) == (1.0, 2.0, 0.5)
    assert r.bottleneck == "memory" and r.step_s == 2.0
    assert r.useful_ratio == 0.5
    assert r.mfu == pytest.approx(2 / 4 / 2)
    cost.wire_bytes = 10 * roofline.LINK_BW
    assert roofline.analyze(cost, n_chips=4,
                            model_flops=1.0).bottleneck == "collective"
    assert set(r.as_dict()) == {f.name for f in dataclasses.fields(
        jroof.Roofline)}


def _ref_param_opt_bytes(arch, shape, mesh_axes) -> int:
    """Parameter + AdamW bytes of one rank from repro's layouts: the
    parameters in their dtype, two fp32 moments, the int32 step."""
    cfg = JCONFIGS[arch]
    plan = jmake_plan(cfg, JSHAPES[shape], mesh_axes)
    shapes, axes = jcommon.eval_axes(jget_model(cfg).init,
                                     jax.random.PRNGKey(0))
    specs = jpart.with_leading(
        jpart.param_pspecs(axes, shapes, plan, mesh_axes), plan.diloco_axis)
    lead = (plan.n_workers,) if plan.diloco_axis else ()
    total = 0
    for s, spec in zip(jax.tree.leaves(shapes), jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, P))):
        n = math.prod(partition.local_shape(lead + tuple(s.shape),
                                            tuple(spec), mesh_axes))
        total += n * (s.dtype.itemsize + 8)
    return total + 4


@pytest.mark.parametrize("arch,mesh", [("internlm2-1.8b", "single"),
                                       ("mamba2-130m", "multi")])
def test_run_cell_at_production_scale(arch, mesh, tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC)
    subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--arch", arch, "--shape", "train_4k", "--mesh", mesh,
                    "--out-dir", str(tmp_path)], env=env, check=True,
                   capture_output=True, timeout=600)
    cell = json.loads((tmp_path / mesh / arch / "train_4k.json").read_text())
    assert CELL_KEYS <= set(cell) and PLAN_KEYS <= set(cell["plan"])
    assert cell["n_chips"] == (512 if mesh == "multi" else 256)
    roof_keys = {f.name for f in dataclasses.fields(jroof.Roofline)}
    for tag in ("train_step", "sync_step"):
        step = cell[tag]
        assert STEP_KEYS <= set(step) and set(step["roofline"]) == roof_keys
        r = step["roofline"]
        assert r["hbm_bytes"] > 0 and r["wire_bytes"] > 0
        assert step["memory"]["peak_live_bytes"] > 0
    train = cell["train_step"]
    assert train["roofline"]["flops"] > 0
    assert train["roofline"]["model_flops"] == jroof.model_flops_for(
        JCONFIGS[arch], JSHAPES["train_4k"])
    assert train["memory"]["param_opt_bytes"] == _ref_param_opt_bytes(
        arch, "train_4k", dryrun.MESH_AXES[mesh])
    plan = jmake_plan(JCONFIGS[arch], JSHAPES["train_4k"],
                      dryrun.MESH_AXES[mesh])
    assert cell["plan"]["diloco_axis"] == plan.diloco_axis
    assert tuple(cell["plan"]["batch_axes"]) == plan.batch_axes


@pytest.mark.parametrize("arch,shape,mesh", [
    ("internlm2-1.8b", "long_500k", "multi"),
    ("dbrx-132b", "long_500k", "multi"),
    ("seamless-m4t-medium", "long_500k", "multi"),
    ("internlm2-1.8b", "long_500k", "single")])
def test_cells_skipped(arch, shape, mesh, tmp_path):
    cell = dryrun.run_cell(arch, shape, mesh, out_dir=tmp_path)
    assert "skipped" in cell and "train_step" not in cell
    assert json.loads((tmp_path / mesh / arch / f"{shape}.json")
                      .read_text()) == cell
