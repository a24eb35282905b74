"""repro_torch's MoE family (reduced deepseek-moe-16b: 8 experts top-2,
one shared expert, a dense first layer; reduced dbrx-132b: 8 experts
top-2, no shared, no dense prefix) against repro's on the same weights
(converted with from_jax_params), fp32 on the CPU.

Floats are held with ``allclose`` at TOL = 1e-4 (absolute and relative),
as ``test_torch_model.py``: the port sums a token's routed rows in
another order than the reference's scatter-add, so bits may differ.
Greedy tokens and engine verdicts are held exactly; inside the port,
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
from repro.core.sync_engine import SyncEngine as JSyncEngine
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import registry as jregistry
from repro.models import transformer as jtf
from repro.serving import engine as jengine
from repro_torch.configs import CONFIGS as TCONFIGS
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import from_jax_cache, from_jax_params
from repro_torch.core.sync_engine import SyncEngine
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import registry
from repro_torch.models import transformer as tf
from repro_torch.serving import engine as tengine

torch.set_float32_matmul_precision("highest")
torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

TOL = 1e-4
ARCHS = ["deepseek-moe-16b", "dbrx-132b"]
MAX_LEN = 64


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone()


def _np(t):
    return t.detach().float().numpy()


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(_np(t), np.asarray(j, np.float32), rtol=tol,
                               atol=tol)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """repro's reduced model (decode through the Pallas kernel in
    interpret mode) and the port's on the same weights, at 3 layers."""
    arch = request.param
    jcfg = dataclasses.replace(JCONFIGS[arch].reduced(), n_layers=3,
                               decode_attn_impl="pallas")
    jm = jregistry.get_model(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(TCONFIGS[arch].reduced(), n_layers=3)
    return types.SimpleNamespace(
        arch=arch, jcfg=jcfg, jm=jm, jp=jp, cfg=cfg,
        model=registry.get_model(cfg, "cpu"),
        params=from_jax_params(jax.tree.map(np.asarray, jp), "cpu"))


# -- the MoE block ------------------------------------------------------------


@pytest.mark.parametrize("case", ["small", "drops", "full", "blocks"])
def test_apply_moe_matches_reference(pair, case, monkeypatch):
    """out, lb_loss and dropped_frac: T = 32 (<= 64: no drops), T = 128
    with the capacity dropping routes, T = 128 at full capacity, and
    the token-block path (T = 256, TOKEN_BLOCK cut to 128 in both
    packages: two blocks, capacity per block)."""
    b, s = {"small": (2, 16), "blocks": (4, 64)}.get(case, (2, 64))
    if case == "blocks":
        monkeypatch.setattr(jmoe, "TOKEN_BLOCK", 128)
        monkeypatch.setattr(tmoe, "TOKEN_BLOCK", 128)
    full = case == "full"
    x = np.random.default_rng(5).normal(
        size=(b, s, pair.cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[1], pair.jp["layers"]["moe"])
    tp = tf.layer_params(pair.params, 1)["moe"]
    m = pair.cfg.moe
    jout, jaux = jmoe.apply_moe(jp, jnp.asarray(x), top_k=m.top_k,
                                capacity_factor=m.capacity_factor,
                                full_capacity=full)
    tout, taux = tmoe.apply_moe(tp, torch.from_numpy(x), top_k=m.top_k,
                                capacity_factor=m.capacity_factor,
                                full_capacity=full)
    _close(tout, jout)
    for key in ("lb_loss", "dropped_frac"):
        _close(taux[key], jaux[key])
    dropped = float(taux["dropped_frac"])
    assert (dropped > 0) == (case in ("drops", "blocks")), dropped


def test_combine_repeats_bitwise(pair):
    """The combine is a gather and a fixed-order sum: two calls give the
    same bits."""
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(3, 40, pair.cfg.d_model)).astype(np.float32))
    p = tf.layer_params(pair.params, 0)["moe"]
    a, _ = tmoe.apply_moe(p, x, top_k=pair.cfg.moe.top_k)
    b, _ = tmoe.apply_moe(p, x, top_k=pair.cfg.moe.top_k)
    assert torch.equal(a, b)


# -- training forward and loss ------------------------------------------------


def test_loss_metrics_and_grads_match_reference(pair):
    """loss_fn at T = 96 tokens (> 64: capacity drops) and the gradients
    of the router, one expert, the shared expert, the dense prefix layer
    and the embedding against jax.grad."""
    rng = np.random.default_rng(2)
    toks = rng.integers(2, pair.cfg.vocab, size=(2, 48)).astype(np.int32)
    tgt = rng.integers(2, pair.cfg.vocab, size=(2, 48)).astype(np.int32)
    mask = (rng.random((2, 48)) > 0.2).astype(np.float32)
    jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgt),
          "mask": jnp.asarray(mask)}
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jtf.loss_fn(pair.jcfg, p, jb), has_aux=True)(pair.jp)
    tp = _clone(pair.params)
    moe = tp["layers"]["moe"]
    picks = {"embed": (tp["embed"], jg["embed"]),
             "router": (moe["router"], jg["layers"]["moe"]["router"]),
             "expert 3": (moe["experts"]["down"],
                          jg["layers"]["moe"]["experts"]["down"])}
    if pair.arch == "deepseek-moe-16b":
        jd = jg["dense0"]
        picks.update({
            "dense0 wq": (tp["dense0"]["wq"], jd["wq"]),
            "dense0 up": (tp["dense0"]["mlp"]["up"], jd["mlp"]["up"]),
            "shared gate": (moe["shared"]["gate"],
                            jg["layers"]["moe"]["shared"]["gate"])})
    for t, _ in picks.values():
        t.requires_grad_(True)
    tl, tmet = tf.loss_fn(pair.cfg, tp, {
        "tokens": torch.from_numpy(toks), "targets": torch.from_numpy(tgt),
        "mask": torch.from_numpy(mask)})
    tl.backward()
    _close(tl, jl)
    for key in ("ce", "z", "lb_loss", "loss"):
        _close(tmet[key], jmet[key])
    lb, drop = float(tmet["lb_loss"].detach()), float(tmet["dropped_frac"])
    assert lb > 0 and 0 < drop < 1
    for name, (t, j) in picks.items():
        if name == "expert 3":
            _close(t.grad[:, 3], j[:, 3])
        else:
            _close(t.grad, j)


# -- serving ------------------------------------------------------------------


def _prefill_pair(pair, b=3, width=24):
    rng = np.random.default_rng(11)
    plen = np.array([24, 5, 13], np.int32)[:b]
    toks = rng.integers(2, pair.cfg.vocab, size=(b, width)).astype(np.int32)
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


def test_prefill_and_decode_match_reference(pair):
    """Right-padded mixed-length prefill (logits, the stacked cache and
    the dense prefix's), then 8 decode steps."""
    jl, jc, tl, tc = _prefill_pair(pair)
    _close(tl, jl)
    leaves = list(zip(tattn.kv_leaves(tc), [jc["scan"]] + jc["prefix"]))
    assert len(leaves) == 1 + tf.n_dense_prefix(pair.cfg)
    for t, j in leaves:
        for name in ("k", "v", "length"):
            _close(getattr(t, name), getattr(j, name))
    decode = jax.jit(pair.jm.decode)
    tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    for _ in range(8):
        jl, jc = decode(pair.jp, jnp.asarray(tok), jc)
        tl, tc = pair.model.decode(pair.params, torch.from_numpy(tok), tc)
        _close(tl, jl)
        tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    for t, j in zip(tattn.kv_leaves(tc), [jc["scan"]] + jc["prefix"]):
        np.testing.assert_array_equal(t.length.numpy(), np.asarray(j.length))


def test_decode_matches_teacher_forcing(pair):
    """prefill(t_0..t_{n-1}), then decode t_n .. t_{n+3}: each step's
    logits equal the full forward's at that position (TOL)."""
    n = 12
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        2, pair.cfg.vocab, size=(2, n + 4)).astype(np.int32))
    full, _ = tf.forward(pair.cfg, pair.params, toks)
    cache = pair.model.init_cache(2, ShapeConfig("t", "decode", 32, 2))
    _, cache = pair.model.prefill(pair.params, {"tokens": toks[:, :n]},
                                  cache)
    for j in range(4):
        lg, cache = pair.model.decode(pair.params, toks[:, n + j:n + j + 1],
                                      cache)
        _close(lg, full[:, n + j].detach().numpy())


def test_from_jax_cache_carries_the_prefix(pair):
    """A JAX-prefilled cache with its dense prefix caches decodes in the
    port like the reference."""
    jl, jc, _, _ = _prefill_pair(pair)
    tc = from_jax_cache(jax.tree.map(np.asarray, jc), "cpu")
    assert len(tc["prefix"]) == tf.n_dense_prefix(pair.cfg)
    tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    jl, _ = jax.jit(pair.jm.decode)(pair.jp, jnp.asarray(tok), jc)
    tl, _ = pair.model.decode(pair.params, torch.from_numpy(tok), tc)
    _close(tl, jl)


def test_from_jax_cache_paged_prefix_shares_the_table():
    """A paged JAX cache with a prefix leaf: every port leaf shares one
    (B, nb) table; leaves whose tables differ raise."""
    table = jnp.asarray([[1, -1]], jnp.int32)
    jc = {"scan": jattn.PagedKVCache(
        jnp.ones((2, 3, 4, 1, 8)), jnp.zeros((2, 3, 4, 1, 8)),
        jnp.broadcast_to(table, (2, 1, 2)),
        jnp.asarray([[3], [3]], jnp.int32)),
        "prefix": [jattn.PagedKVCache(
            jnp.full((3, 4, 1, 8), 2.0), jnp.zeros((3, 4, 1, 8)), table,
            jnp.asarray([3], jnp.int32))]}
    c = from_jax_cache(jax.tree.map(np.asarray, jc), "cpu")
    pre = c["prefix"][0]
    assert isinstance(pre, tattn.PagedKVCache) and pre.table is c["scan"].table
    assert pre.k.shape == (3, 4, 1, 8) and float(pre.k[0, 0, 0, 0]) == 2.0
    assert pre.length.tolist() == [3]
    bad = dict(jc, prefix=[jc["prefix"][0]._replace(
        table=jnp.asarray([[2, -1]], jnp.int32))])
    with pytest.raises(ValueError, match="differ"):
        from_jax_cache(jax.tree.map(np.asarray, bad), "cpu")


def _prompts(vocab, n, seed=0, system=0):
    rng = np.random.default_rng(seed)
    head = rng.integers(2, vocab, size=system).astype(np.int32)
    return [np.concatenate([head, rng.integers(
        2, vocab, size=int(rng.integers(3, 30))).astype(np.int32)])
        for _ in range(n)]


def _serve(mod, kind, model, params, prompts, *, slots=4, max_new=8,
           vary=True, **kw):
    """Greedy tokens of ``prompts`` through ``mod``'s engine; with
    ``vary`` the budgets differ (max_new - i % 3), so slots retire and
    admit mid-run."""
    eng = mod.make_engine(kind, model, params, batch_slots=slots,
                          max_len=MAX_LEN, **kw)
    reqs = [mod.Request(i, p, max_new_tokens=max_new - (i % 3 if vary
                                                        else 0))
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert all(r.done for r in reqs)
    return [list(r.out_tokens) for r in reqs], eng


def test_continuous_greedy_equals_reference(pair):
    prompts = _prompts(pair.cfg.vocab, 6)
    want, _ = _serve(jengine, "continuous", pair.jm, pair.jp, prompts)
    got, _ = _serve(tengine, "continuous", pair.model, pair.params, prompts)
    assert got == want


def test_paged_equals_foil_with_prefix_hits(pair):
    """The paged engine (the dense prefix layer's K/V paged through the
    same table) gives the batch_admit=False foil's greedy tokens, with
    prefix hits on a shared 20-token system prompt and a verbatim
    repeat."""
    prompts = _prompts(pair.cfg.vocab, 6, seed=3, system=20)
    prompts.append(prompts[1].copy())
    want, _ = _serve(tengine, "continuous", pair.model, pair.params,
                     prompts, batch_admit=False)
    got, eng = _serve(tengine, "paged", pair.model, pair.params, prompts,
                      block_size=8)
    assert got == want
    s = eng.perf_summary()
    assert s["prefix_hits"] > 0 and s["prefix_hit_rate"] > 0
    pool = eng.cache
    assert all(leaf.table is pool["scan"].table
               for leaf in tattn.kv_leaves(pool))


def test_batch_composition_independence(pair):
    """A request's greedy tokens alone (one slot) equal its tokens
    beside three others (four slots): serving runs the MoE at full
    capacity, so no slot's routing drops another's tokens."""
    prompts = _prompts(pair.cfg.vocab, 4, seed=9)
    together, _ = _serve(tengine, "continuous", pair.model, pair.params,
                         prompts, vary=False)
    for i, p in enumerate(prompts):
        alone, _ = _serve(tengine, "continuous", pair.model, pair.params,
                          [p], slots=1, vary=False)
        assert alone[0] == together[i]


# -- stages, swarm, sync order ------------------------------------------------


@pytest.fixture(scope="module")
def deep():
    """The port's reduced deepseek-moe-16b at 5 layers (dense0 + 4
    stacked MoE layers), so 1..4 stages each get a stacked layer."""
    cfg = dataclasses.replace(TCONFIGS["deepseek-moe-16b"].reduced(),
                              n_layers=5)
    return cfg, registry.get_model(cfg, "cpu").init(0)


def test_stage_bounds_equal_reference():
    for arch in ARCHS:
        jcfg = dataclasses.replace(JCONFIGS[arch].reduced(), n_layers=5)
        cfg = dataclasses.replace(TCONFIGS[arch].reduced(), n_layers=5)
        for k in range(1, tf.n_scan_layers(cfg) + 1):
            assert tf.stage_bounds(cfg, k) == \
                [tuple(b) for b in jtf.stage_bounds(jcfg, k)]


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_staged_equals_monolithic_bitwise(deep, k):
    """k stages (dense0 and its cache on stage 0 only) give the
    monolithic prefill's and decode's logits and caches bit for bit."""
    cfg, params = deep
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        2, cfg.vocab, size=(2, 12)).astype(np.int32))
    plen = torch.tensor([12, 5], dtype=torch.int32)
    cache_m = tf.init_cache(cfg, 2, MAX_LEN, device="cpu")
    logits_m, _ = tf.prefill(cfg, params, toks, cache_m, prompt_len=plen)
    stages = registry.make_stages(cfg, k, "cpu")
    sp = [s.slice_params(params) for s in stages]
    assert ["dense0" in p for p in sp] == [i == 0 for i in range(k)]
    sc = [s.init_cache(2, MAX_LEN) for s in stages]
    assert [len(c["prefix"]) for c in sc] == [int(i == 0) for i in range(k)]
    x = toks
    for s, p, c in zip(stages, sp, sc):
        x, _ = s.prefill(p, x, c, prompt_len=plen)
    assert torch.equal(x, logits_m)
    tok = logits_m.argmax(-1, keepdim=True).to(torch.int32)
    for _ in range(3):
        dec_m, _ = tf.decode_step(cfg, params, tok, cache_m)
        x = tok
        for s, p, c in zip(stages, sp, sc):
            x, _ = s.decode(p, x, c)
        assert torch.equal(x, dec_m)
        tok = dec_m.argmax(-1, keepdim=True).to(torch.int32)
    assert torch.equal(sc[0]["prefix"][0].k, cache_m["prefix"][0].k)
    for s, c in zip(stages, sc):
        assert torch.equal(c["scan"].k, cache_m["scan"].k[s.lo:s.hi])


@pytest.mark.parametrize("kv_layout", ["dense", "paged"])
def test_swarm_chain_with_a_crash_gives_engine_tokens(kv_layout, tmp_path):
    """A 2-stage x 2-replica fleet of reduced deepseek-moe-16b (dense0 +
    2 MoE layers; stage 0 holds dense0's cache, dense or paged), the
    stage-1 holder crashed mid-run: the router's greedy tokens are the
    B = 1 engine's."""
    from repro_torch.checkpointing import ChunkGossip, ChunkStore
    from repro_torch.checkpointing.p2p import PeerConnPool
    from repro_torch.serving import swarm_serve as sw
    cfg = dataclasses.replace(TCONFIGS["deepseek-moe-16b"].reduced(),
                              n_layers=3)
    model = registry.get_model(cfg, "cpu")
    params = model.init(0)
    prompts = _prompts(cfg.vocab, 3, seed=2)
    want, _ = _serve(tengine, "continuous", model, params, prompts, slots=1,
                     batch_admit=False)
    servers = []
    pool = gossip = None
    try:
        for sid, stage in enumerate(registry.make_stages(cfg, 2, "cpu")):
            for r in range(2):
                srv = sw.StageServer(cfg, ChunkStore(tmp_path / f"{sid}{r}"),
                                     k_stages=2, max_len=MAX_LEN,
                                     kv_layout=kv_layout, device="cpu")
                srv.serve_stage(sid, stage.slice_params(params))
                servers.append(srv)
        pool = PeerConnPool(timeout=5.0)
        gossip = ChunkGossip([s.addr for s in servers], timeout=5.0,
                             pool=pool)
        gossip.poll_once()
        router = sw.SwarmRouter(2, gossip, timeout=5.0, pool=pool,
                                max_len=MAX_LEN)
        victim = next(s for s in servers if s.addr == router._pick(1))
        victim.crash_after = victim.served_chunks + 3
        got = [router.generate(p.tolist(), 8 - (i % 3), rid=f"r{i}",
                               eos_id=1) for i, p in enumerate(prompts)]
        assert got == want
        assert router.stats["failovers"] >= 1
        assert router.stats["recoveries"] >= 1
    finally:
        if gossip is not None:
            gossip.stop()
        if pool is not None:
            pool.close()
        for s in servers:
            s.close()


def test_sync_engine_order_and_sizes_equal_reference(pair):
    """The outer sync flattens the MoE tree (dense0, embed, layers/moe
    ...) in repro's leaf order with repro's sizes."""
    eng = SyncEngine.for_tree(pair.params)
    paths, _ = zip(*jax.tree_util.tree_flatten_with_path(pair.jp)[0])
    want = [tuple(k.key for k in p) for p in paths]
    assert list(eng.paths) == want
    assert eng.sizes == JSyncEngine.for_tree(pair.jp).sizes
    if pair.arch == "deepseek-moe-16b":
        assert eng.paths[0][0] == "dense0"


def test_init_layout_matches_reference(pair):
    """The port's random init has repro's tree, shapes and dtypes."""
    got = registry.get_model(pair.cfg, "cpu").init(0)
    jt = jax.tree_util.tree_flatten_with_path(pair.jp)[0]
    tt = SyncEngine.for_tree(got)
    assert list(tt.paths) == [tuple(k.key for k in p) for p, _ in jt]
    assert list(tt.shapes) == [tuple(v.shape) for _, v in jt]
    spec = registry.stage_param_specs(pair.cfg, 2)
    assert ("dense0" in spec[0]) == (pair.arch == "deepseek-moe-16b")
    assert "dense0" not in spec[1]


def test_launcher_serves_moe_on_every_path(capsys):
    """``launch.serve`` serves the reduced deepseek-moe-16b on every
    engine, and as a swarm with a crashed holder (the engine's tokens)."""
    from repro_torch.launch import serve
    base = ["--device", "cpu", "--reduced", "--arch", "deepseek-moe-16b",
            "--requests", "3", "--max-new", "4", "--max-len", "32"]
    outs = {}
    for engine in ("wave", "continuous", "paged"):
        s = serve.main(base + ["--engine", engine])
        assert all(s["done"]) and s["requests"] == 3
        outs[engine] = s["outputs"]
    assert outs["wave"] == outs["continuous"]
    s = serve.main(base + ["--swarm", "--stages", "1"])
    assert s["bit_identical_to_engine"] and s["outputs"] == s["reference"]
    assert s["failovers"] >= 1 and s["recoveries"] >= 1
    assert "bit_identical_to_engine=True" in capsys.readouterr().out


def test_launcher_trains_moe_and_reports_lb_loss(capsys):
    """``launch.train`` on the reduced deepseek-moe-16b: every outer
    step's record has a finite loss and lb_loss."""
    import json
    from repro_torch.launch import train
    out = train.main(["--device", "cpu", "--reduced", "--arch",
                      "deepseek-moe-16b", "--workers", "2",
                      "--outer-steps", "2", "--inner-steps", "2"])
    hist = out["history"]
    assert len(hist) == 2
    assert all(np.isfinite(h["loss"]) and h["lb_loss"] > 0 for h in hist)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert all("lb_loss" in rec for rec in lines)


def test_profile_paged_copy_carries_the_prefix(pair):
    """``launch.profile_decode``'s paged copy moves every KV leaf (the
    dense prefix's too) into the pool: a decode on it gives the dense
    cache's logits."""
    from repro_torch.launch.profile_decode import _paged_copy
    _, _, tl, tc = _prefill_pair(pair)
    shape = ShapeConfig("t", "decode", MAX_LEN, 3)
    paged = _paged_copy(pair.model, tc, 3, shape, 16)
    assert len(paged["prefix"]) == tf.n_dense_prefix(pair.cfg)
    tok = tl.argmax(-1, keepdim=True).to(torch.int32)
    want, _ = pair.model.decode(pair.params, tok, tc)
    got, _ = pair.model.decode(pair.params, tok, paged)
    _close(got, want.numpy())
