"""Sequence parallelism in the port's train step for the MoE, VLM and
enc-dec families, on one (2, 2, 2) ("pod", "data", "model") gloo mesh
of rank processes on the CPU, against ``repro``'s unsharded per-worker
step (``tests/sp_reference.py``; the dense and sliding-window families
and the split's parts: ``test_torch_sp_train.py``). Each runs 3 steps
from ``repro``'s reduced parameters with a random 0/1 mask, 2 rows a
worker a microbatch (one a 'data' rank) split by positions over
'model': losses and every metric within 1e-4, the first step's gradient
(every rank's blocks assembled by ``repro``'s specs) within 1e-5.

  * deepseek-moe-16b: 128 tokens a microbatch, so the capacity drops
    routes: ``lb_loss`` and ``dropped_frac`` as the reference's one
    routing over the worker's token grid, and the gradient upstream of
    the routers, which ``lb_loss`` reaches once;
  * dbrx-132b with 2 microbatches of 2 rows (the last one's metrics);
  * phi-3-vision-4.2b: 8 frontend positions and 56 tokens, the frontend
    in the first position block, whose rank scores fewer targets;
  * seamless-m4t-medium: a 47-frame source (uneven blocks) and 64
    target tokens: the encoder, the gathered memory's cross-attention
    and the decoder under the split."""
import pytest
import torch

import sp_ranks as spr
import sp_reference as ref
from repro_torch.launch.mesh import make_mesh

torch.set_float32_matmul_precision("highest")
torch.set_num_threads(2)

GRAD_TOL = 1e-5
# arch -> (rows a worker, microbatches, stream positions, source frames)
CASES = {"deepseek-moe-16b": (2, 1, 64, None),
         "dbrx-132b": (4, 2, 64, None),
         "phi-3-vision-4.2b": (2, 1, 64, None),
         "seamless-m4t-medium": (2, 1, 64, 47)}


@pytest.fixture(scope="module")
def mesh():
    with make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu",
                   timeout=300.0) as m:
        yield m


@pytest.mark.parametrize("arch", list(CASES))
def test_sp_step_matches_reference(mesh, arch):
    rows, nmb, seq, src = CASES[arch]
    plan = ref.sp_plan(microbatches=nmb)
    jparams, params = ref.ref_params(arch)
    b = ref.batch(arch, rows, seq, src_len=src)
    res = mesh.call(spr.train, arch, plan, params, ref.torch_batch(b), 3,
                    ref.LR, "gloo")
    want, grads = ref.ref_steps(arch, jparams, b, 3, nmb)
    ref.assert_metrics(res, mesh, want)
    assert set(res[0]["metrics"][0]) == set(want)
    if "dropped_frac" in want:
        assert want["dropped_frac"].max() > 0    # the capacity drops
    ref.assert_every_leaf(res, mesh, "grads", grads,
                          ref.ref_specs(arch, plan), GRAD_TOL)
