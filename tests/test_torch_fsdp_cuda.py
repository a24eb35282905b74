"""The sharded outer sync on the card: a (2, 1) ("data", "model") mesh
of rank processes on one CUDA device (the DiLoCo group gloo through
pinned host buffers, each FSDP group one rank on NCCL), the reduced
internlm2-1.8b with its parameters sharded over 'model' (a forced-TP
plan), one int8 sync. Needs a CUDA device and nvcc (skipped without a
device); imports no JAX:

  PYTHONPATH=src python -m pytest -q tests/test_torch_fsdp_cuda.py

Checked: the rank's anchor and parameters bitwise the port's simulator
on the card on this shard's rows (the same kernels), the simulator on
the host (the plain codec) within a flipped code's reach, every codec
call a launch, ``codec_calls(2)`` of each per rank.
"""
import pytest
import torch

import fsdp_ranks as fr
from repro_torch.configs import get_config
from repro_torch.core import ring_reduce as rr
from repro_torch.core.sync_engine import tree_map
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.registry import get_model
from repro_torch.sharding.plans import ParallelismPlan

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device")

K = 2
TP = ParallelismPlan(
    diloco_axis="data",
    rules=(("vocab", "model"), ("heads", "model"), ("ff", "model"),
           ("experts", "model"), ("embed", None), ("layers", None)),
    batch_axes=(), seq_axis=None, remat=False, n_workers=K)


@needs_cuda
def test_int8_sharded_sync_on_the_card():
    params = get_model(get_config("internlm2-1.8b").reduced(),
                       device="cpu").init(0)
    stacked = tree_map(lambda x: torch.stack([x + 0.01 * i
                                              for i in range(K)]), params)
    weights = torch.tensor([1.0, 0.5])
    with make_mesh((K, 1), ("data", "model"), local_backend="nccl",
                   timeout=300.0) as mesh:
        res = mesh.call(fr.sharded_ring_vs_sim, "internlm2-1.8b", TP,
                        params, stacked, weights, "nccl", True)
    want = rr.codec_calls(K)
    for out in res:
        assert out["anchor"] and out["params"]
        assert {n: c for n, (c, _) in out["counts"].items()} == want
        assert {n: l for n, (_, l) in out["counts"].items()} == want
        assert out["plain_err"] <= out["plain_bound"]
        assert out["plain_flipped"] < 0.01
