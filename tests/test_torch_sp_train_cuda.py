"""Sequence parallelism in the train step on the card: a (2, 1, 2)
("pod", "data", "model") mesh of rank processes on one CUDA device
(every group gloo; the weights, K/V and routing gathers and their
backwards through the card mailboxes, CUDA IPC), the multi-pod plan
with ``act_seq_axis = "model"`` (``tests/sp_reference.py``'s rules),
the reduced dense, sliding-window, MoE, VLM and enc-dec families in
fp32, 3 steps on one sequence a worker of 64 positions with a random
mask, against the port's unsharded step on the card (``model.loss``
and AdamW on the worker's batch): every step's loss and metrics within
1e-4. Needs a CUDA device (skipped without one); imports no JAX:

  PYTHONPATH=src python -m pytest -q tests/test_torch_sp_train_cuda.py
"""
import numpy as np
import pytest
import torch

import sp_ranks as spr
from repro_torch.configs import get_config
from repro_torch.core.sync_engine import (from_paths, leaves,
                                          leaves_with_paths, tree_map)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.registry import get_model
from repro_torch.optim.adamw import AdamW
from repro_torch.sharding.plans import ParallelismPlan

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device")

K, LR, STEPS, SEQ = 2, 1e-3, 3, 64
COMBO = ("data", "model")
PLAN = ParallelismPlan(
    diloco_axis="pod",
    rules=(("vocab", COMBO), ("heads", COMBO), ("ff", [COMBO, "data"]),
           ("experts", "model"), ("embed", None), ("layers", None)),
    batch_axes=("data",), seq_axis=None, remat=True, n_workers=K,
    act_seq_axis="model")
ARCHS = ("internlm2-1.8b", "h2o-danube-1.8b", "deepseek-moe-16b",
         "phi-3-vision-4.2b", "seamless-m4t-medium")


def _batch(cfg, seed=1) -> dict:
    """(K, 1, ...) inputs: ``SEQ`` stream positions a worker."""
    g = torch.Generator().manual_seed(seed)
    n_tok = SEQ - cfg.n_frontend
    tok = torch.randint(0, cfg.vocab, (K, 1, n_tok + 1), generator=g,
                        dtype=torch.int32)
    out = {"tokens": tok[..., :-1].contiguous(),
           "targets": tok[..., 1:].contiguous(),
           "mask": (torch.rand((K, 1, n_tok), generator=g) < 0.7).float()}
    if cfg.n_frontend:
        out["frontend"] = torch.randn((K, 1, cfg.n_frontend, cfg.d_model),
                                      generator=g)
    if cfg.family == "encdec":
        out["src_embeds"] = torch.randn((K, 1, SEQ - 17, cfg.d_model),
                                        generator=g)
    return out


def _unsharded(model, params, batch) -> list:
    opt = AdamW(lr=LR)
    params = tree_map(torch.clone, params)
    st = opt.init(params)
    out = []
    for _ in range(STEPS):
        req = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, m = model.loss(req, batch)
        gs = torch.autograd.grad(loss, leaves(req))
        opt.update_(from_paths([p for p, _ in leaves_with_paths(req)], gs),
                    st, params)
        out.append({k: float(v.detach()) for k, v in m.items()})
    return out


@pytest.fixture(scope="module")
def mesh():
    with make_mesh((K, 1, 2), ("pod", "data", "model"),
                   timeout=300.0) as m:
        yield m


@needs_cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_sp_step_on_the_card_equals_unsharded(mesh, arch):
    torch.set_float32_matmul_precision("highest")
    cfg = get_config(arch).reduced()
    model = get_model(cfg, device="cuda")
    params = tree_map(lambda t: t.cpu(), model.init(0))
    b = _batch(cfg)
    res = mesh.call(spr.train, arch, PLAN, params, b, STEPS, LR, "gloo")
    for w in range(K):
        want = _unsharded(model, tree_map(lambda t: t.cuda(), params),
                          {k: v[w].cuda() for k, v in b.items()})
        for r, out in enumerate(res):
            if mesh.coords(r)["pod"] != w:
                continue
            for got, ref in zip(out["metrics"], want):
                assert set(got) == set(ref)
                np.testing.assert_allclose(
                    [got[k] for k in sorted(ref)],
                    [ref[k] for k in sorted(ref)], rtol=1e-4, atol=1e-4,
                    err_msg=f"{arch} rank {r}")
