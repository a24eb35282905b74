"""The SSM and hybrid families on the card: the flash-decode kernels at
zamba2-2.7b's shared-attention head shape (dh = 80: 10 of the kernel's
16 lanes busy), the reduced mamba2-130m and zamba2-2.7b engines against
the same models on the CPU, and paged == the batch_admit=False foil.
Needs a CUDA device and nvcc (skipped without a device); imports no
JAX:

  PYTHONPATH=src python -m pytest -q tests/test_torch_ssm_cuda.py

Tolerances: the kernels as ``test_torch_flash_decode_cuda.py`` (fp32
2e-5, bf16 3e-2 against the plain version, repeats bitwise); the fp32
reduced models card vs CPU 1e-3 on the first-token logits (as
``chip_smoke.py``'s reduced INTELLECT-1; TF32 off), greedy tokens equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import flash_decode as fd
from repro_torch.models import attention as attn
from repro_torch.models import registry
from repro_torch.serving.engine import Request, make_engine

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device")

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# (Hk, G, dh): zamba2-2.7b's shared attention (32 heads of 80, MHA) and
# dh = 80 under grouped queries (8 kv heads of 4)
SHAPES = [(32, 1, 80), (8, 4, 80)]
LENGTHS = [512, 1, 300, 77]
ARCHS = ["mamba2-130m", "zamba2-2.7b"]


def _inputs(hk, g, dh, dtype, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, s = len(LENGTHS), 512

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return (randn(b, 1, hk * g, dh), randn(b, s, hk, dh), randn(b, s, hk, dh),
            torch.tensor(LENGTHS, dtype=torch.int32, device="cuda"))


@needs_cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_at_dh_80(shape, dtype):
    """Kernel 5 against its plain version, a repeat bitwise equal;
    kernel 6 on a permuted pool of 16-cell blocks against its plain
    version, a repeat bitwise equal, and bitwise against kernel 5 on
    the gathered view."""
    q, k, v, length = _inputs(*shape, dtype)
    out = fd.flash_decode(q, k, v, length)
    assert torch.equal(out, fd.flash_decode(q, k, v, length))
    torch.testing.assert_close(
        out.float(), fd.flash_decode_torch(q, k, v, length).float(),
        rtol=TOL[dtype], atol=TOL[dtype])
    blk, b, s = 16, q.shape[0], k.shape[1]
    nb = s // blk
    perm = (torch.randperm(b * nb, generator=torch.Generator().manual_seed(1))
            + 1).reshape(b, nb)
    kp = torch.zeros((b * nb + 1, blk) + k.shape[2:], dtype=dtype,
                     device="cuda")
    vp = torch.zeros_like(kp)
    for i in range(b):
        kp[perm[i]] = k[i].reshape(nb, blk, *k.shape[2:])
        vp[perm[i]] = v[i].reshape(nb, blk, *v.shape[2:])
    table = perm.to(device="cuda", dtype=torch.int32)
    paged = fd.flash_decode_paged(q, kp, vp, table, length)
    assert torch.equal(paged, fd.flash_decode_paged(q, kp, vp, table, length))
    torch.testing.assert_close(
        paged.float(),
        fd.flash_decode_paged_torch(q, kp, vp, table, length).float(),
        rtol=TOL[dtype], atol=TOL[dtype])
    view = attn.paged_view(attn.PagedKVCache(kp, vp, table, length))
    assert torch.equal(paged, fd.flash_decode(q, view.k, view.v, length))


def _prompts(vocab, n=6, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, size=int(rng.integers(3, 40)))
            .astype(np.int32) for _ in range(n)]


def _serve(model, params, prompts, kind, **kw):
    eng = make_engine(kind, model, params, batch_slots=3, max_len=64,
                      decode_chunk=4, **kw)
    reqs = [Request(i, p, max_new_tokens=8) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert all(r.done for r in reqs)
    return [r.out_tokens for r in reqs]


@needs_cuda
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["continuous", "paged"])
def test_reduced_engine_card_matches_cpu(arch, kind):
    """The fp32 reduced model's greedy tokens on the card equal the
    CPU's; the prefill's logits agree within 1e-3; a decode step
    launches kernel 5 once per shared-attention application (none for
    mamba2)."""
    cfg = get_config(arch).reduced()
    cpu, gpu = registry.get_model(cfg, "cpu"), registry.get_model(cfg)
    params = cpu.init(0)
    gparams = _to(params, "cuda")
    prompts = _prompts(cfg.vocab)
    assert _serve(gpu, gparams, prompts, kind) == \
        _serve(cpu, params, prompts, kind)
    toks = torch.from_numpy(np.stack([p[:3] for p in prompts]))
    shape = ShapeConfig("t", "decode", 64, len(prompts))
    lc, _ = cpu.prefill(params, {"tokens": toks}, cpu.init_cache(
        len(prompts), shape))
    lg, cg = gpu.prefill(gparams, {"tokens": toks.cuda()}, gpu.init_cache(
        len(prompts), shape))
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-3, atol=1e-3)
    fd.flash_decode.launches = 0
    gpu.decode(gparams, lg.argmax(-1, keepdim=True).to(torch.int32), cg)
    assert fd.flash_decode.launches == (
        cfg.n_layers // cfg.attn_every if cfg.attn_every else 0)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@needs_cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_equals_foil_on_card(arch):
    """bf16 reduced model on the card: the paged engine (zamba2's shared
    attention paged, its SSM state dense; mamba2 degenerate) gives the
    batch_admit=False foil's greedy tokens."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    model = registry.get_model(cfg)
    params = model.init(0)
    prompts = _prompts(cfg.vocab, 7, seed=3)
    assert _serve(model, params, prompts, "paged", block_size=8) == \
        _serve(model, params, prompts, "continuous", batch_admit=False)
