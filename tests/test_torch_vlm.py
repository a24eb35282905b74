"""repro_torch's VLM family (reduced phi-3-vision-4.2b: 2 layers, 4 heads
of 16, an 8-position random frontend standing in for the image patches)
against repro's on the same weights (converted with from_jax_params),
fp32 on the CPU. Floats are held at TOL = 1e-4 (absolute and relative),
as ``test_torch_model.py``; greedy tokens exactly; inside the port,
staged == monolithic and paged == the ``batch_admit=False`` foil are
bitwise."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.models import registry as jregistry
from repro.models import transformer as jtf
from repro.serving import engine as jengine
from repro_torch.configs import CONFIGS as TCONFIGS
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import from_jax_params
from repro_torch.models import registry
from repro_torch.models import transformer as tf
from repro_torch.serving import engine as tengine

torch.set_float32_matmul_precision("highest")
torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

TOL = 1e-4
ARCH = "phi-3-vision-4.2b"
MAX_LEN = 64


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def vlm():
    jcfg = dataclasses.replace(JCONFIGS[ARCH].reduced(),
                               decode_attn_impl="pallas")
    jm = jregistry.get_model(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    cfg = TCONFIGS[ARCH].reduced()
    rng = np.random.default_rng(8)
    n_front = cfg.n_frontend
    return types.SimpleNamespace(
        jcfg=jcfg, jm=jm, jp=jp, cfg=cfg,
        model=registry.get_model(cfg, "cpu"),
        params=from_jax_params(jax.tree.map(np.asarray, jp), "cpu"),
        front=rng.normal(size=(2, n_front, cfg.d_model)).astype(np.float32),
        toks=rng.integers(2, cfg.vocab, size=(2, 16)).astype(np.int32))


def test_config_is_the_vlm_family(vlm):
    assert vlm.cfg.family == "vlm" and vlm.cfg.n_frontend == 8
    assert tf.n_dense_prefix(vlm.cfg) == 0


def test_forward_with_frontend_matches_reference(vlm):
    jl, _ = jtf.forward(vlm.jcfg, vlm.jp, jnp.asarray(vlm.toks),
                        frontend=jnp.asarray(vlm.front))
    tl, aux = tf.forward(vlm.cfg, vlm.params, torch.from_numpy(vlm.toks),
                         frontend=torch.from_numpy(vlm.front))
    assert tl.shape == (2, vlm.cfg.n_frontend + 16, vlm.cfg.padded_vocab)
    _close(tl, jl)
    assert float(aux["lb_loss"]) == 0.0


def test_loss_and_grads_with_frontend_match_reference(vlm):
    """The loss masks the frontend positions off; its gradients reach
    the embedding, the layer stack and the frontend itself."""
    rng = np.random.default_rng(3)
    tgt = rng.integers(2, vlm.cfg.vocab, size=(2, 16)).astype(np.int32)
    mask = (rng.random((2, 16)) > 0.25).astype(np.float32)

    def jloss(p, front):
        return jtf.loss_fn(vlm.jcfg, p, {
            "tokens": jnp.asarray(vlm.toks), "targets": jnp.asarray(tgt),
            "mask": jnp.asarray(mask), "frontend": front})
    (jl, jmet), (jg, jgf) = jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True)(
        vlm.jp, jnp.asarray(vlm.front))
    tp = jax.tree.map(lambda t: t.detach().clone().requires_grad_(True),
                      vlm.params)
    front = torch.from_numpy(vlm.front).requires_grad_(True)
    tl, tmet = tf.loss_fn(vlm.cfg, tp, {
        "tokens": torch.from_numpy(vlm.toks),
        "targets": torch.from_numpy(tgt), "mask": torch.from_numpy(mask),
        "frontend": front})
    tl.backward()
    _close(tl, jl)
    for key in ("ce", "z", "loss"):
        _close(tmet[key], jmet[key])
    assert "lb_loss" not in tmet
    _close(tp["embed"].grad, jg["embed"])
    _close(tp["layers"]["wq"].grad, jg["layers"]["wq"])
    _close(tp["layers"]["mlp"]["down"].grad, jg["layers"]["mlp"]["down"])
    _close(front.grad, jgf)


def test_prefill_with_frontend_and_decode_match_reference(vlm):
    """A prefill that carries the frontend (registry batch key
    "frontend"), then 6 decode steps, against repro's."""
    b = 2
    jl, jc = jax.jit(vlm.jm.prefill)(
        vlm.jp, {"tokens": jnp.asarray(vlm.toks),
                 "frontend": jnp.asarray(vlm.front)},
        vlm.jm.init_cache(b, JShapeConfig("t", "decode", MAX_LEN, b)))
    tl, tc = vlm.model.prefill(
        vlm.params, {"tokens": torch.from_numpy(vlm.toks),
                     "frontend": torch.from_numpy(vlm.front)},
        vlm.model.init_cache(b, ShapeConfig("t", "decode", MAX_LEN, b)))
    _close(tl, jl)
    for name in ("k", "v", "length"):
        _close(getattr(tc["scan"], name), getattr(jc["scan"], name))
    assert tc["scan"].length.tolist()[0] == [vlm.cfg.n_frontend + 16] * b
    decode = jax.jit(vlm.jm.decode)
    tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    for _ in range(6):
        jl, jc = decode(vlm.jp, jnp.asarray(tok), jc)
        tl, tc = vlm.model.decode(vlm.params, torch.from_numpy(tok), tc)
        _close(tl, jl)
        tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)


def test_decode_matches_teacher_forcing_with_frontend(vlm):
    """prefill(frontend + t_0..t_{n-1}), then decode t_n .. t_{n+3}: each
    step's logits equal the full forward's at position F + n + j."""
    n, f = 12, vlm.cfg.n_frontend
    toks = torch.from_numpy(vlm.toks)
    front = torch.from_numpy(vlm.front)
    full, _ = tf.forward(vlm.cfg, vlm.params, toks, frontend=front)
    cache = vlm.model.init_cache(2, ShapeConfig("t", "decode", 32, 2))
    _, cache = vlm.model.prefill(
        vlm.params, {"tokens": toks[:, :n], "frontend": front}, cache)
    for j in range(4):
        lg, cache = vlm.model.decode(vlm.params, toks[:, n + j:n + j + 1],
                                     cache)
        _close(lg, full[:, f + n + j].detach().numpy())


@pytest.mark.parametrize("k", [1, 2])
def test_staged_with_frontend_equals_monolithic_bitwise(vlm, k):
    """The frontend enters on stage 0; k stages give the monolithic
    prefill's and decode's logits bit for bit."""
    front = torch.from_numpy(vlm.front)
    toks = torch.from_numpy(vlm.toks)
    cache_m = tf.init_cache(vlm.cfg, 2, MAX_LEN, device="cpu")
    logits_m, _ = tf.prefill(vlm.cfg, vlm.params, toks, cache_m,
                             frontend=front)
    stages = registry.make_stages(vlm.cfg, k, "cpu")
    sp = [s.slice_params(vlm.params) for s in stages]
    sc = [s.init_cache(2, MAX_LEN) for s in stages]
    x = toks
    for i, (s, p, c) in enumerate(zip(stages, sp, sc)):
        x, _ = s.prefill(p, x, c, frontend=front if i == 0 else None)
    assert torch.equal(x, logits_m)
    tok = logits_m.argmax(-1, keepdim=True).to(torch.int32)
    for _ in range(3):
        dec_m, _ = tf.decode_step(vlm.cfg, vlm.params, tok, cache_m)
        x = tok
        for s, p, c in zip(stages, sp, sc):
            x, _ = s.decode(p, x, c)
        assert torch.equal(x, dec_m)
        tok = dec_m.argmax(-1, keepdim=True).to(torch.int32)


def _prompts(vocab, n, seed=0):
    rng = np.random.default_rng(seed)
    head = rng.integers(2, vocab, size=18).astype(np.int32)
    return [np.concatenate([head, rng.integers(
        2, vocab, size=int(rng.integers(3, 25))).astype(np.int32)])
        for _ in range(n)]


def _serve(mod, kind, model, params, prompts, **kw):
    eng = mod.make_engine(kind, model, params, batch_slots=4,
                          max_len=MAX_LEN, **kw)
    reqs = [mod.Request(i, p, max_new_tokens=8 - i % 3)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert all(r.done for r in reqs)
    return [list(r.out_tokens) for r in reqs], eng


def test_engines_serve_text_prompts_like_reference(vlm):
    """The continuous engine's greedy tokens equal repro's; the paged
    engine's equal the batch_admit=False foil's, with prefix hits."""
    prompts = _prompts(vlm.cfg.vocab, 6)
    want, _ = _serve(jengine, "continuous", vlm.jm, vlm.jp, prompts)
    got, _ = _serve(tengine, "continuous", vlm.model, vlm.params, prompts)
    assert got == want
    foil, _ = _serve(tengine, "continuous", vlm.model, vlm.params, prompts,
                     batch_admit=False)
    paged, eng = _serve(tengine, "paged", vlm.model, vlm.params, prompts,
                        block_size=8)
    assert paged == foil
    assert eng.perf_summary()["prefix_hits"] > 0


def test_launcher_serves_vlm(capsys):
    from repro_torch.launch import serve
    base = ["--device", "cpu", "--reduced", "--arch", ARCH, "--requests",
            "3", "--max-new", "4", "--max-len", "32"]
    for engine in ("continuous", "paged"):
        s = serve.main(base + ["--engine", engine])
        assert all(s["done"]) and s["requests"] == 3
    s = serve.main(base + ["--swarm"])
    assert s["bit_identical_to_engine"] and s["failovers"] >= 1
    assert "bit_identical_to_engine=True" in capsys.readouterr().out
