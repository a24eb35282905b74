"""The dry run's serve cells (``repro_torch.launch.dryrun.trace_serve``:
``build_serve_step`` on rank 0's blocks, fake tensors in a fake world)
at production scale, one subprocess a cell as ``--all`` runs them:
granite-3-2b decode_32k (8 KV heads on a 'model' axis of 16: the cache
laid by sequence, decode through the block variant) and internlm2-1.8b
prefill_32k (the prefill's sequence split), both single-pod. The cell
has the reference's keys; ``model_flops`` equals ``repro``'s; the
parameter and cache bytes of rank 0 equal the sum of ``local_shape``
of ``repro``'s parameter and cache specs; the step moves bytes over
the wire and holds a live peak at least its parameters and cache."""
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys

import jax
import pytest
from jax.sharding import PartitionSpec as P

from repro.analysis import roofline as jroof
from repro.configs import CONFIGS as JCONFIGS
from repro.configs import SHAPES as JSHAPES
from repro.models import common as jcommon
from repro.models.registry import get_model as jget_model
from repro.sharding import make_plan as jmake_plan
from repro.sharding import partition as jpart
from repro_torch.launch import dryrun
from repro_torch.sharding import partition

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")


def _local_bytes(shapes, specs, amap) -> int:
    is_spec = lambda x: isinstance(x, P)
    return sum(math.prod(partition.local_shape(tuple(s.shape), tuple(spec),
                                               amap)) * s.dtype.itemsize
               for s, spec in zip(jax.tree.leaves(shapes),
                                  jax.tree.leaves(specs, is_leaf=is_spec)))


@pytest.mark.parametrize("arch,shape", [("granite-3-2b", "decode_32k"),
                                        ("internlm2-1.8b", "prefill_32k")])
def test_serve_cell_at_production_scale(arch, shape, tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC)
    subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--arch", arch, "--shape", shape, "--mesh", "single",
                    "--out-dir", str(tmp_path)], env=env, check=True,
                   capture_output=True, timeout=600)
    cell = json.loads((tmp_path / "single" / arch / f"{shape}.json")
                      .read_text())
    assert {"arch", "shape", "mesh", "plan", "n_chips", "serve_step",
            "elapsed_s"} <= set(cell)
    assert cell["n_chips"] == 256
    step = cell["serve_step"]
    roof_keys = {f.name for f in dataclasses.fields(jroof.Roofline)}
    assert set(step["roofline"]) == roof_keys
    cfg, jshape = JCONFIGS[arch], JSHAPES[shape]
    assert step["roofline"]["model_flops"] == jroof.model_flops_for(cfg,
                                                                    jshape)
    assert step["roofline"]["flops"] > 0
    assert step["roofline"]["wire_bytes"] > 0
    amap = dryrun.MESH_AXES["single"]
    plan = jmake_plan(cfg, jshape, amap)
    jm = jget_model(cfg)
    shapes, axes = jcommon.eval_axes(jm.init, jax.random.PRNGKey(0))
    mem = step["memory"]
    assert mem["param_bytes"] == _local_bytes(
        shapes, jpart.param_pspecs(axes, shapes, plan, amap), amap)
    cache = jax.eval_shape(lambda: jm.init_cache(jshape.global_batch,
                                                 jshape))
    specs = jm.cache_pspecs(cache, plan, amap)
    assert mem["cache_bytes"] == _local_bytes(cache, specs, amap)
    # the KV cache is laid by sequence: 8 heads do not divide 16
    assert any("model" in tuple(s)[2:3] for s in jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, P)))
    assert mem["peak_live_bytes"] >= mem["param_bytes"] + mem["cache_bytes"]
