"""The dry run of a multi-pod train cell under sequence parallelism
(``repro_torch.launch.dryrun``, ``build_train_step`` under
``plan.act_seq_axis``): internlm2-1.8b train_4k on the (2, 16, 16)
("pod", "data", "model") mesh, traced in a subprocess (a process holds
one fake world). The cell's plan sets ``act_seq_axis = "model"`` as
``repro``'s does; the traced rank is the one of the last position
block (model coordinate 15, 0 on the other axes), which does the most
attention work; its parameter plus optimizer bytes equal those of
``repro``'s specs; the step's collectives carry the backward of its
gathers (reduce-scatters by all-to-all)."""
import json
import os
import subprocess
import sys

from repro.configs import CONFIGS as JCONFIGS
from repro.configs import SHAPES as JSHAPES
from repro.sharding import make_plan as jmake_plan
from repro_torch.launch import dryrun
from test_torch_dryrun import SRC, _ref_param_opt_bytes


def test_sp_train_cell_traces_the_last_blocks_rank(tmp_path):
    arch = "internlm2-1.8b"
    env = dict(os.environ, PYTHONPATH=SRC)
    subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--arch", arch, "--shape", "train_4k", "--mesh", "multi",
                    "--no-sync", "--out-dir", str(tmp_path)], env=env,
                   check=True, capture_output=True, timeout=600)
    cell = json.loads((tmp_path / "multi" / arch / "train_4k.json")
                      .read_text())
    amap = dryrun.MESH_AXES["multi"]
    plan = jmake_plan(JCONFIGS[arch], JSHAPES["train_4k"], amap)
    assert plan.act_seq_axis == "model"
    assert cell["plan"]["act_seq_axis"] == plan.act_seq_axis
    assert tuple(cell["plan"]["batch_axes"]) == plan.batch_axes
    assert cell["traced_rank"] == {"rank": 15, "coords": {
        "pod": 0, "data": 0, "model": 15}}
    train = cell["train_step"]
    assert train["memory"]["param_opt_bytes"] == _ref_param_opt_bytes(
        arch, "train_4k", amap)
    assert train["collectives"]["all-to-all"] > 0
    assert train["roofline"]["flops"] > 0
