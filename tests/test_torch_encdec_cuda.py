"""The enc-dec family on the card: the flash-decode kernel at
seamless-m4t-medium's decode shapes (16 heads of 64, G = 1: the self
cache and the cross cache at S_max = src_len), the reduced
seamless-m4t-medium card against the CPU, and a full-width, depth-cut
model's decode against its teacher-forced decoder. Needs a CUDA device
and nvcc (skipped without a device); imports no JAX:

  PYTHONPATH=src python -m pytest -q tests/test_torch_encdec_cuda.py

Tolerances: the kernel as ``test_torch_flash_decode_cuda.py`` (fp32
2e-5, bf16 3e-2 against the plain version, repeats bitwise); the fp32
reduced model card vs CPU 1e-3 on every step's logits, greedy tokens
equal (TF32 off); fp32 decode vs teacher forcing 2e-3 (``chip_smoke.py``
phase 13's gate).
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import flash_decode as fd
from repro_torch.models import encdec
from repro_torch.models import registry

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device")

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
ARCH = "seamless-m4t-medium"
# (label, lengths) at B = 4, S_max 512, 16 kv heads of 64, G = 1
CASES = [("self", [512, 1, 300, 77]), ("cross", [512, 512, 512, 512])]


@pytest.fixture(autouse=True)
def _no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


@needs_cuda
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_at_seamless_shapes(case, dtype):
    _, lengths = case
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    q, k, v = randn(4, 1, 16, 64), randn(4, 512, 16, 64), randn(4, 512, 16,
                                                                  64)
    length = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    before = fd.flash_decode.launches
    out = fd.flash_decode(q, k, v, length)
    assert torch.equal(out, fd.flash_decode(q, k, v, length))
    assert fd.flash_decode.launches == before + 2
    torch.testing.assert_close(
        out.float(), fd.flash_decode_torch(q, k, v, length).float(),
        rtol=TOL[dtype], atol=TOL[dtype])


def _greedy(model, params, src, steps, max_len):
    b = src.shape[0]
    bos = torch.ones((b, 1), dtype=torch.int32, device=src.device)
    lg, cache = model.prefill(params, {"src_embeds": src, "bos": bos},
                              model.init_cache(b, ShapeConfig(
                                  "t", "decode", max_len, b)))
    logits, toks = [lg], [bos]
    for _ in range(steps):
        toks.append(logits[-1].argmax(-1, keepdim=True).to(torch.int32))
        lg, cache = model.decode(params, toks[-1], cache)
        logits.append(lg)
    return logits, toks


@needs_cuda
def test_reduced_encdec_card_vs_cpu():
    """Prefill + 8 greedy steps: tokens equal, logits within 1e-3; kernel
    5 launched twice per decoder layer per step (self and cross)."""
    cfg = get_config(ARCH).reduced()
    cpu, gpu = registry.get_model(cfg, "cpu"), registry.get_model(cfg, "cuda")
    params = cpu.init(0)
    gparams = _to(params, "cuda")
    src = torch.randn((3, 24, cfg.d_model),
                      generator=torch.Generator().manual_seed(1))
    lc, tc = _greedy(cpu, params, src, 8, 32)
    before = (fd.flash_decode.launches, fd.flash_decode_paged.launches)
    lg, tg = _greedy(gpu, gparams, src.cuda(), 8, 32)
    _, n_dec = encdec.n_enc_dec(cfg)
    assert fd.flash_decode.launches - before[0] == 2 * n_dec * 9
    assert fd.flash_decode_paged.launches == before[1]
    for a, b in zip(tg, tc):
        assert torch.equal(a.cpu(), b)
    for a, b in zip(lg, lc):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-3)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@needs_cuda
def test_full_width_decode_matches_teacher_forcing():
    """seamless-m4t-medium at full width, depth cut to 1 + 1, fp32: 16
    greedy steps after a 256-frame prefill, every step's logits within
    2e-3 of the teacher-forced decoder over [BOS, emitted tokens]."""
    cfg = dataclasses.replace(get_config(ARCH), n_layers=2, dtype="float32")
    model = registry.get_model(cfg, "cuda")
    params = model.init(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    src = torch.randn((2, 256, cfg.d_model), generator=gen, device="cuda")
    logits, toks = _greedy(model, params, src, 16, 256)
    with torch.no_grad():
        full = encdec.decoder_logits(cfg, params,
                                     encdec.encode(cfg, params, src),
                                     torch.cat(toks, 1))
    for j, lg in enumerate(logits):
        torch.testing.assert_close(lg, full[:, j], rtol=0, atol=2e-3)


@needs_cuda
def test_encdec_loss_gradients_finite_on_card():
    cfg = dataclasses.replace(get_config(ARCH), n_layers=2)
    model = registry.get_model(cfg, "cuda")
    params = model.init(0)
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        else:
            t.requires_grad_(True)
            leaves.append(t)
    walk(params)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"src_embeds": torch.randn((2, 64, cfg.d_model), generator=gen,
                                       device="cuda").to(cfg.torch_dtype),
             "tokens": torch.randint(2, cfg.vocab, (2, 64), generator=gen,
                                     device="cuda", dtype=torch.int32),
             "targets": torch.randint(2, cfg.vocab, (2, 64), generator=gen,
                                      device="cuda", dtype=torch.int32)}
    loss, _ = model.loss(params, batch)
    loss.backward()
    assert torch.isfinite(loss)
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in leaves)
