"""The distributed outer sync on the card: rank processes on one CUDA
device, the WAN ring over gloo through pinned host buffers, the codec
kernels in each rank. Needs a CUDA device and nvcc (skipped without a
device); imports no JAX, so it runs on the GPU machine:

  PYTHONPATH=src python -m pytest -q tests/test_torch_distributed_cuda.py

Checked bit for bit: a 4-rank ``DistRingSyncOp`` against ``RingSyncOp``
at a few million elements (launches summed over the ranks equal k x
``codec_calls``); the codec's one-row calls against its k-row calls
(the per-row statistics do not depend on how many rows a call holds);
an all-gather over an NCCL local group at world size 1 (one card cannot
hold a multi-rank NCCL group).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import ring_reduce as rr
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.train import step as ts

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device")

K, D = 4, 3_000_017     # not a multiple of k: the padding is exercised


def _rows(seed=0):
    rng = np.random.default_rng(seed)
    anchor = rng.normal(size=D).astype(np.float32)
    thetas = (anchor[None] + 0.05 * rng.normal(size=(K, D))
              * rng.uniform(0.5, 2.0, size=(K, 1))).astype(np.float32)
    return (torch.from_numpy(anchor).cuda(), torch.from_numpy(thetas).cuda())


@needs_cuda
def test_dist_ring_equals_ring_op_on_the_card():
    anchor, thetas = _rows()
    pgs = anchor[None] - thetas
    w = torch.tensor([1.0, 0.0, 1.0, 1.0], device="cuda")
    order = (2, 0, 3, 1)
    cfg = rr.RingConfig(buckets=2)
    with make_host_mesh(K) as mesh:
        pr = ts.DistSyncPrograms(mesh, "data", D, cfg, ring_order=order)
        for fused in (None, (anchor, thetas)):
            got = ts.DistRingSyncOp(pr, pgs, weights=w,
                                    fused_src=fused).finish()
            want = rr.RingSyncOp(pgs, order, cfg, w, fused).finish()
            assert torch.equal(got, want)
            rec = pr.log[-1]
            calls = rr.codec_calls(K, cfg, fused is not None)
            assert rec["launches"] == {n: K * c for n, c in calls.items()}
            assert rec["launches"] == rec["calls"]


@needs_cuda
def test_one_row_codec_equals_k_rows():
    anchor, thetas = _rows(1)
    pgs = anchor[None] - thetas
    scale = torch.tensor([1.0, 0.5, 2.0, 1.0], device="cuda")
    q = ops.quantize(pgs)
    qf = ops.quantize_pseudograd(anchor[None].expand(K, D).contiguous(),
                                 thetas, scale=scale)
    for r in range(K):
        one = ops.quantize(pgs[r:r + 1])
        assert torch.equal(one.codes, q.codes[r:r + 1])
        assert torch.equal(one.codebook, q.codebook[r:r + 1])
        onef = ops.quantize_pseudograd(anchor[None], thetas[r:r + 1],
                                       scale=scale[r:r + 1])
        assert torch.equal(onef.codes, qf.codes[r:r + 1])
        assert torch.equal(onef.codebook, qf.codebook[r:r + 1])
        acc = torch.zeros(1, D, device="cuda")
        assert torch.equal(ops.dequantize_add(one, acc),
                           ops.dequantize(q)[r:r + 1])


def _gather(ctx, key, x):
    return ts.local_all_gather(ctx, key, x.to(ctx.device)).cpu()


@needs_cuda
def test_nccl_local_group_all_gather_world_size_1():
    x = torch.arange(1000, dtype=torch.float32)
    with make_mesh((1,), ("model",), local_backend="nccl") as mesh:
        key = mesh.group(("model",), mesh.local_backend)
        (got,) = mesh.call(_gather, key, x)
    assert torch.equal(got, x)
