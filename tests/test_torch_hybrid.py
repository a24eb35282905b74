"""repro_torch's SSM and hybrid families (``models/hybrid.py``: reduced
mamba2-130m, 2 Mamba2 layers, tied embeddings; reduced zamba2-2.7b, 4
Mamba2 layers with the shared attention block after every 2) against
repro's on the same weights (converted with from_jax_params), fp32 on
the CPU, SSD chunks of 16 so the prompts span several chunks.

Floats are held with ``allclose`` at TOL = 1e-4 (absolute and relative),
as ``test_torch_model.py``: the forward, the prefill's logits and every
cache leaf (through ``convert.from_jax_cache``), 8 decode steps (the
reference's decode attention is the Pallas kernel in interpret mode,
the port's the kernel's plain version) and the loss. Greedy tokens are
held exactly against repro's ContinuousEngine and PagedEngine; inside
the port, paged == the ``batch_admit=False`` foil and (mamba2) wave ==
continuous are exact too."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.models import hybrid as jhybrid
from repro.models import registry as jregistry
from repro.serving import engine as jengine
from repro.serving import paging as jpaging
from repro_torch.configs import CONFIGS as TCONFIGS
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import from_jax_cache, from_jax_params
from repro_torch.models import attention as tattn
from repro_torch.models import hybrid as thybrid
from repro_torch.models import registry
from repro_torch.models.ssm import SSMState
from repro_torch.serving import engine as tengine
from repro_torch.serving.paging import PagedEngine

torch.set_float32_matmul_precision("highest")
torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

TOL = 1e-4
ARCHS = ["mamba2-130m", "zamba2-2.7b"]
MAX_LEN = 64


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """repro's reduced model (decode through the Pallas kernel in
    interpret mode) and the port's on the same weights."""
    arch = request.param
    jcfg = dataclasses.replace(JCONFIGS[arch].reduced(),
                               decode_attn_impl="pallas")
    jm = jregistry.get_model(jcfg)
    jp = jax.jit(lambda k: jm.init(k)[0])(jax.random.PRNGKey(0))
    cfg = TCONFIGS[arch].reduced()
    return types.SimpleNamespace(
        arch=arch, jcfg=jcfg, jm=jm, jp=jp, cfg=cfg,
        model=registry.get_model(cfg, "cpu"),
        params=from_jax_params(jax.tree.map(np.asarray, jp), "cpu"))


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        2, cfg.vocab, size=(b, s)).astype(np.int32)


# -- model --------------------------------------------------------------------


def test_init_layout_matches_reference(pair):
    """The port's random init has repro's tree, shapes and dtypes, with
    its zeros / ones parameters exactly (a_log, dt_bias zeros; d_skip,
    the norms and the per-application gains ones)."""
    tp = pair.model.init(0)
    flat_j = jax.tree_util.tree_flatten_with_path(pair.jp)[0]
    assert len(flat_j) == len(jax.tree.leaves(
        jax.tree.map(lambda x: 0, tp)))
    for path, leaf in flat_j:
        node = tp
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype) == f"torch.{leaf.dtype}", path
        name = path[-1].key
        if name in ("a_log", "dt_bias"):
            assert not node.any()
        elif name in ("d_skip", "norm", "ln", "ln_f", "ln_attn", "ln_mlp"):
            assert bool((node == 1).all()), path
    x = tp["mamba"]["mamba"]["in_x"]
    d = pair.cfg.d_model
    assert abs(x.std().item() - d ** -0.5) < 0.1 * d ** -0.5


def test_forward_and_loss_match_reference(pair):
    """The training forward's logits and loss_fn's loss, ce and z on
    2 x 40 tokens (three SSD chunks), and the gradients of the embedding
    and one Mamba2 projection against jax.grad."""
    rng = np.random.default_rng(1)
    toks = _tokens(pair.cfg, 2, 40, 1)
    tgt = _tokens(pair.cfg, 2, 40, 2)
    mask = (rng.random((2, 40)) > 0.2).astype(np.float32)
    jlog, _ = jax.jit(lambda p, t: jhybrid.forward(pair.jcfg, p, t))(
        pair.jp, jnp.asarray(toks))
    tlog, _ = thybrid.forward(pair.cfg, pair.params, torch.from_numpy(toks))
    _close(tlog, jlog)
    jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgt),
          "mask": jnp.asarray(mask)}
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: jhybrid.loss_fn(pair.jcfg, p, jb), has_aux=True))(pair.jp)
    tp = dict(pair.params)
    emb = pair.params["embed"].clone().requires_grad_(True)
    inx = pair.params["mamba"]["mamba"]["in_x"].clone().requires_grad_(True)
    tp["embed"] = emb
    tp["mamba"] = {"ln": pair.params["mamba"]["ln"],
                   "mamba": dict(pair.params["mamba"]["mamba"], in_x=inx)}
    tl, tmet = pair.model.loss(tp, {
        "tokens": torch.from_numpy(toks), "targets": torch.from_numpy(tgt),
        "mask": torch.from_numpy(mask)})
    tl.backward()
    _close(tl, jl)
    for key in ("ce", "z", "loss"):
        _close(tmet[key], jmet[key])
    _close(emb.grad, jg["embed"])
    _close(inx.grad, jg["mamba"]["mamba"]["in_x"])


def _prefill_pair(pair, b=3, width=40):
    plen = np.array([40, 5, 23], np.int32)[:b]
    toks = _tokens(pair.cfg, b, width, 11)
    for i in range(b):
        toks[i, plen[i]:] = 0
    jl, jc = jax.jit(pair.jm.prefill)(
        pair.jp, {"tokens": jnp.asarray(toks), "prompt_len": jnp.asarray(plen)},
        pair.jm.init_cache(b, JShapeConfig("t", "decode", MAX_LEN, b)))
    tl, tc = pair.model.prefill(
        pair.params, {"tokens": torch.from_numpy(toks),
                      "prompt_len": torch.from_numpy(plen)},
        pair.model.init_cache(b, ShapeConfig("t", "decode", MAX_LEN, b)))
    return jl, jc, tl, tc


def _leaves(cache) -> list:
    """Every tensor of a cache tree: the state leaves, then each KV
    leaf's k, v and length."""
    out = list(tattn.state_leaves(cache))
    for c in tattn.kv_leaves(cache):
        out += [c.k, c.v, c.length]
    return out


def test_prefill_and_decode_match_reference(pair):
    """Right-padded prompts of 40, 5 and 23 tokens: the logits and every
    cache leaf (repro's through from_jax_cache), then 8 decode steps."""
    jl, jc, tl, tc = _prefill_pair(pair)
    _close(tl, jl)
    want = from_jax_cache(jax.tree.map(np.asarray, jc), "cpu")
    assert isinstance(want["ssm"], SSMState)
    assert (want["kv"] is None) == (pair.cfg.attn_every is None)
    got_leaves, want_leaves = _leaves(tc), _leaves(want)
    assert len(got_leaves) == len(want_leaves) == (
        4 + (3 if pair.cfg.attn_every else 0))
    for t, j in zip(got_leaves, want_leaves):
        assert t.shape == j.shape and t.dtype == j.dtype
        _close(t, j.numpy())
    decode = jax.jit(pair.jm.decode)
    tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    for _ in range(8):
        jl, jc = decode(pair.jp, jnp.asarray(tok), jc)
        tl, tc = pair.model.decode(pair.params, torch.from_numpy(tok), tc)
        _close(tl, jl)
        tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    want = from_jax_cache(jax.tree.map(np.asarray, jc), "cpu")
    for t, j in zip(_leaves(tc), _leaves(want)):
        _close(t, j.numpy())


def test_converted_cache_decodes_like_reference(pair):
    """A repro-prefilled cache, converted, decodes in the port."""
    jl, jc, _, _ = _prefill_pair(pair)
    tc = from_jax_cache(jax.tree.map(np.asarray, jc), "cpu")
    tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    jl, _ = jax.jit(pair.jm.decode)(pair.jp, jnp.asarray(tok), jc)
    tl, _ = pair.model.decode(pair.params, torch.from_numpy(tok), tc)
    _close(tl, jl)


def test_from_jax_cache_carries_a_paged_hybrid_cache():
    """repro's paged zamba2 cache (``build_paged_cache``): the shared
    attention's K/V become a PagedKVCache with one (B, nb) table, the
    SSM leaves stay dense."""
    jcfg = JCONFIGS["zamba2-2.7b"].reduced()
    jm = jregistry.get_model(jcfg)
    jc, nb, n_blocks = jpaging.build_paged_cache(
        jm, 3, JShapeConfig("t", "decode", MAX_LEN, 3), block_size=16)
    c = from_jax_cache(jax.tree.map(np.asarray, jc), "cpu")
    assert isinstance(c["kv"], tattn.PagedKVCache)
    assert c["kv"].table.shape == (3, nb) and c["kv"].k.shape[1] == n_blocks
    assert c["ssm"].state.shape[:2] == (jcfg.n_layers, 3)


def test_registry_families_and_stages():
    """Both families build on cuda by default and on the CPU when asked;
    enc-dec builds too, without a bare logits forward; the stage
    partition refuses all three."""
    for arch in ARCHS:
        cfg = TCONFIGS[arch]
        assert registry.get_model(cfg).device.type == "cuda"
        assert registry.get_model(cfg, "cpu").prefill_extend is None
        with pytest.raises(ValueError, match="stage partition"):
            registry.make_stages(cfg.reduced(), 1, "cpu")
    enc = registry.get_model(TCONFIGS["seamless-m4t-medium"], "cpu")
    assert enc.logits is None and enc.prefill_extend is None
    with pytest.raises(ValueError, match="stage partition"):
        registry.make_stages(TCONFIGS["seamless-m4t-medium"].reduced(), 1,
                             "cpu")


# -- serving ------------------------------------------------------------------


def _prompts(vocab, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, size=int(rng.integers(3, 40))
                         ).astype(np.int32) for _ in range(n)]


def _serve(mod, kind, model, params, prompts, *, slots=3, max_new=8, **kw):
    """Greedy tokens of ``prompts`` through ``mod``'s engine; budgets
    vary (max_new - i % 3), so slots retire and admit mid-run."""
    eng = mod.make_engine(kind, model, params, batch_slots=slots,
                          max_len=MAX_LEN, **kw)
    reqs = [mod.Request(i, p, max_new_tokens=max_new - i % 3)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert all(r.done for r in reqs)
    return [list(r.out_tokens) for r in reqs], eng


@pytest.mark.parametrize("kind", ["continuous", "paged"])
def test_greedy_equals_reference_engine(pair, kind):
    """The port's engine gives repro's engine's greedy tokens (the same
    kind on both sides: PagedEngine pages the hybrid's shared-attention
    K/V and degenerates to the dense path for the pure SSM)."""
    prompts = _prompts(pair.cfg.vocab, 6)
    kw = {"block_size": 16} if kind == "paged" else {}
    if kind == "paged":
        jeng = jpaging.PagedEngine(pair.jm, pair.jp, batch_slots=3,
                                   max_len=MAX_LEN, **kw)
        reqs = [jengine.Request(i, p, max_new_tokens=8 - i % 3)
                for i, p in enumerate(prompts)]
        for r in reqs:
            jeng.submit(r)
        jeng.run_until_drained()
        want = [list(r.out_tokens) for r in reqs]
    else:
        want, _ = _serve(jengine, kind, pair.jm, pair.jp, prompts)
    got, eng = _serve(tengine, kind, pair.model, pair.params, prompts, **kw)
    assert got == want
    if kind == "paged":
        assert eng.nb == (MAX_LEN // 16 if pair.cfg.attn_every else 0)
        assert eng.prefix is None and eng._extend is None


def test_paged_equals_foil_bitwise(pair):
    """Inside the port the paged engine gives the batch_admit=False
    foil's greedy tokens; a hybrid's pool drains back to empty and its
    SSM leaves stay dense."""
    prompts = _prompts(pair.cfg.vocab, 7, seed=3)
    want, _ = _serve(tengine, "continuous", pair.model, pair.params, prompts,
                     batch_admit=False)
    got, eng = _serve(tengine, "paged", pair.model, pair.params, prompts,
                      block_size=8)
    assert got == want
    assert isinstance(eng, PagedEngine)
    assert all(not isinstance(t, tattn.PagedKVCache)
               for t in tattn.state_leaves(eng.cache))
    if pair.cfg.attn_every:
        assert eng.pool.used == 0 and eng.perf_summary()["blocks_peak"] > 0
    else:
        assert tattn.kv_leaves(eng.cache) == [] and eng.capacity == MAX_LEN


def test_ssm_budget_is_capless(pair):
    """A pure SSM's budget ignores max_len (O(1) state); the hybrid's
    shared-attention cache caps it, as the reference's engine."""
    eng = tengine.make_engine("continuous", pair.model, pair.params,
                              batch_slots=1, max_len=16)
    req = tengine.Request(0, np.arange(2, 14, dtype=np.int32),
                          max_new_tokens=20)
    jeng = jengine.make_engine("continuous", pair.jm, pair.jp,
                               batch_slots=1, max_len=16)
    assert eng._budget(req) == jeng._budget(req) == (
        4 if pair.cfg.attn_every else 20)


def test_wave_equals_continuous_mamba2():
    """The reference's test_continuous_bit_identical_to_wave_greedy case
    for mamba2-130m inside the port: 8 mixed-length requests, 3 slots."""
    cfg = TCONFIGS["mamba2-130m"].reduced()
    model = registry.get_model(cfg, "cpu")
    params = model.init(0)
    prompts = _prompts(cfg.vocab, 8, seed=5)
    wave, _ = _serve(tengine, "wave", model, params, prompts)
    cont, _ = _serve(tengine, "continuous", model, params, prompts,
                     decode_chunk=5)
    assert wave == cont
