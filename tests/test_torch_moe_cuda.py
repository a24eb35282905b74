"""The MoE and VLM families on the card: the flash-decode kernels at their
attention shapes, the MoE block against the CPU and against itself, and
the serving seams (staged == monolithic, paged == the batch_admit=False
foil). Needs a CUDA device and nvcc (skipped without a device); imports
no JAX:

  PYTHONPATH=src python -m pytest -q tests/test_torch_moe_cuda.py

Tolerances: the kernels as ``test_torch_flash_decode_cuda.py`` (fp32
2e-5, bf16 3e-2 against the plain version); the fp32 MoE block card vs
CPU 1e-4 (TF32 off: the products are fp32 on both). Everything else is
bitwise: the combine gathers each token's routed rows and sums them in
a fixed order (no atomics), so two runs on the card agree bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_decode as fd
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models import registry
from repro_torch.models import transformer as tf
from repro_torch.serving.engine import Request, make_engine

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device")

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# (Hk, G, dh): deepseek-moe-16b (16 heads of 128, MHA) and
# phi-3-vision-4.2b (32 heads of 96: dh / 8 = 12 lanes of 16 busy)
SHAPES = [(16, 1, 128), (32, 1, 96)]
LENGTHS = [512, 1, 300, 77]


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
def test_kernels_at_the_new_head_shapes(shape, dtype):
    """Kernel 5 against its plain version, a repeat bitwise equal;
    kernel 6 on a permuted pool of 16-cell blocks against its plain
    version and bitwise against kernel 5 on the gathered view."""
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
    torch.testing.assert_close(
        paged.float(),
        fd.flash_decode_paged_torch(q, kp, vp, table, length).float(),
        rtol=TOL[dtype], atol=TOL[dtype])
    view = attn.paged_view(attn.PagedKVCache(kp, vp, table, length))
    assert torch.equal(paged, fd.flash_decode(q, view.k, view.v, length))


def _moe_layer(d, f, e, shared, dtype, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p = moe.alloc_moe(lambda *s: torch.empty(s, dtype=dtype, device="cuda"),
                      (), d, f, e, shared)
    moe.init_moe(p, gen, d, f, shared)
    return p


@needs_cuda
@pytest.mark.parametrize("full", [False, True])
def test_moe_block_card_matches_cpu(full):
    """The fp32 MoE block (reduced deepseek-moe-16b's widths, T = 256 so
    that the capacity drops routes unless ``full``) on the card within
    1e-4 of the same block on the CPU."""
    cfg = get_config("deepseek-moe-16b").reduced()
    m = cfg.moe
    p = _moe_layer(cfg.d_model, m.d_expert, m.n_experts, m.n_shared,
                   torch.float32)
    x = torch.randn((4, 64, cfg.d_model), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(2))
    kw = dict(top_k=m.top_k, capacity_factor=m.capacity_factor,
              full_capacity=full)
    got, aux = moe.apply_moe(p, x, **kw)
    cpu = {k: (v.cpu() if not isinstance(v, dict) else
               {kk: vv.cpu() for kk, vv in v.items()}) for k, v in p.items()}
    want, aux_cpu = moe.apply_moe(cpu, x.cpu(), **kw)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for key in ("lb_loss", "dropped_frac"):
        torch.testing.assert_close(aux[key].cpu(), aux_cpu[key], rtol=1e-4,
                                   atol=1e-4)
    assert (float(aux["dropped_frac"]) > 0) == (not full)


@needs_cuda
@pytest.mark.parametrize("t", [4, 1024])
def test_moe_block_repeats_bitwise(t):
    """deepseek-moe-16b's full-width MoE block (d 2048, 64 experts of
    1408, top-6, 2 shared) in bf16 at a decode batch (T = 4, full
    capacity) and a training batch (T = 1024, capacity drops): two runs
    are bitwise equal."""
    m = get_config("deepseek-moe-16b").moe
    p = _moe_layer(2048, m.d_expert, m.n_experts, m.n_shared,
                   torch.bfloat16)
    x = torch.randn((1, t, 2048), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3)
                    ).to(torch.bfloat16)
    kw = dict(top_k=m.top_k, capacity_factor=m.capacity_factor,
              full_capacity=t <= 64)
    a, aux_a = moe.apply_moe(p, x, **kw)
    b, aux_b = moe.apply_moe(p, x, **kw)
    assert torch.isfinite(a).all() and torch.equal(a, b)
    assert torch.equal(aux_a["lb_loss"], aux_b["lb_loss"])


def _bf16(arch, n_layers):
    return dataclasses.replace(get_config(arch).reduced(), n_layers=n_layers,
                               dtype="bfloat16")


@needs_cuda
@pytest.mark.parametrize("arch,n_layers", [("deepseek-moe-16b", 4),
                                           ("phi-3-vision-4.2b", 3)])
def test_staged_equals_monolithic_on_card(arch, n_layers):
    """bf16 on the card: 2 and 3 stages (dense0 on stage 0; the VLM's
    frontend into stage 0) give the monolithic prefill's and decode's
    logits bit for bit; a decode launches kernel 5 once per layer, the
    dense prefix layer included."""
    cfg = _bf16(arch, n_layers)
    model = registry.get_model(cfg, "cuda")
    params = model.init(0)
    gen = torch.Generator(device="cuda").manual_seed(4)
    toks = torch.randint(2, cfg.vocab, (2, 12), generator=gen,
                         device="cuda", dtype=torch.int32)
    front = (torch.randn((2, cfg.n_frontend, cfg.d_model), generator=gen,
                         device="cuda").to(cfg.torch_dtype)
             if cfg.n_frontend else None)
    cache_m = tf.init_cache(cfg, 2, 64)
    logits_m, _ = tf.prefill(cfg, params, toks, cache_m, frontend=front)
    tok = logits_m.argmax(-1, keepdim=True).to(torch.int32)
    fd.flash_decode.launches = 0
    dec_m, _ = tf.decode_step(cfg, params, tok, cache_m)
    assert fd.flash_decode.launches == cfg.n_layers
    for k in (2, 3):
        stages = registry.make_stages(cfg, k)
        sp = [s.slice_params(params) for s in stages]
        sc = [s.init_cache(2, 64) for s in stages]
        x = toks
        for i, (s, p, c) in enumerate(zip(stages, sp, sc)):
            x, _ = s.prefill(p, x, c, frontend=front if i == 0 else None)
        assert torch.equal(x, logits_m)
        x = tok
        for s, p, c in zip(stages, sp, sc):
            x, _ = s.decode(p, x, c)
        assert torch.equal(x, dec_m)


@needs_cuda
def test_paged_equals_foil_on_card():
    """bf16 reduced deepseek-moe-16b on the card: the paged engine (the
    dense prefix layer paged through the shared table) gives the
    batch_admit=False foil's greedy tokens, with prefix hits."""
    cfg = _bf16("deepseek-moe-16b", 3)
    model = registry.get_model(cfg, "cuda")
    params = model.init(0)
    rng = np.random.default_rng(5)
    head = rng.integers(2, cfg.vocab, size=20).astype(np.int32)
    prompts = [np.concatenate([head, rng.integers(2, cfg.vocab, size=n)
                               .astype(np.int32)]) for n in (3, 9, 14, 5, 7)]
    out = {}
    for kind, kw in (("continuous", {"batch_admit": False}),
                     ("paged", {"block_size": 8})):
        eng = make_engine(kind, model, params, batch_slots=4, max_len=64,
                          **kw)
        reqs = [Request(i, p, max_new_tokens=10) for i, p in
                enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        out[kind] = [r.out_tokens for r in reqs]
        if kind == "paged":
            assert eng.perf_summary()["prefix_hits"] > 0
    assert out["paged"] == out["continuous"]
