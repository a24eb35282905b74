"""repro_torch's paged KV tier against repro's: BlockPool id sequences
and stats, chain digests, the paged cache write and chunked prefill
(``prefill_extend``) on the same weights, PagedEngine greedy tokens
equal to repro's PagedEngine (reduced intellect-1 and SWA h2o-danube);
inside the port, paged == ContinuousEngine(batch_admit=False) and the
JAX engine tests' counts (prefix dedup, full hits, copy-on-write,
refcounts, flush, cold LRU, exhaustion, long prompts); and overlapped
admission against serial admission."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS
from repro.models import attention as jattn
from repro.models import transformer as jtransformer
from repro.models.registry import get_model as jget_model
from repro.serving import engine as jengine
from repro.serving import paging as jpaging
from repro_torch.configs import CONFIGS as TCONFIGS
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import from_jax_cache, from_jax_params, to_tensor
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttransformer
from repro_torch.models.registry import get_model as tget_model
from repro_torch.serving import engine as tengine
from repro_torch.serving import paging as tpaging

torch.set_float32_matmul_precision("highest")
torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

ARCH = "intellect-1"
MAX_LEN = 64
CHUNK = 4


@pytest.fixture(scope="module")
def world():
    """The reduced INTELLECT-1 of the port, on the CPU."""
    cfg = TCONFIGS[ARCH].reduced()
    model = tget_model(cfg, "cpu")
    return cfg, model, model.init(0)


def _pair(arch):
    jcfg = dataclasses.replace(JCONFIGS[arch].reduced(),
                               decode_attn_impl="pallas")
    jm = jget_model(jcfg)
    params, _ = jm.init(jax.random.PRNGKey(0))
    tm = tget_model(TCONFIGS[arch].reduced(), "cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, params), "cpu")
    return jcfg, jm, params, tm, tp


def _mixed(vocab, n, seed=0, long_new=12):
    rng = np.random.default_rng(seed)
    spec = []
    for i in range(n):
        plen = int(rng.integers(20, 45)) if i % 3 == 2 else \
            int(rng.integers(3, 20))
        spec.append((i, rng.integers(2, vocab, size=plen).astype(np.int32),
                     long_new if i % 3 == 2 else 4))
    return spec


def _drain(mod, engine, spec, **req_kw):
    reqs = [mod.Request(i, p, max_new_tokens=mn, **req_kw)
            for i, p, mn in spec]
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    assert all(r.done for r in reqs)
    return [list(r.out_tokens) for r in reqs]


def _dense(model, params, **kw):
    """The port's dense foil: batch-1 admission, as the paged engine."""
    kw.setdefault("max_len", MAX_LEN)
    return tengine.ContinuousEngine(model, params, decode_chunk=CHUNK,
                                    batch_admit=False, **kw)


def _paged(model, params, **kw):
    kw.setdefault("max_len", MAX_LEN)
    return tpaging.PagedEngine(model, params, decode_chunk=CHUNK, **kw)


# -- block pool: the same ids and stats as the JAX pool ----------------------


def _pool_sequences(mod):
    """The sequences of tests/test_paging.py's pool tests, recorded."""
    log = []
    freed = []
    pool = mod.BlockPool(6, on_free=lambda bid, tags: freed.append(bid))
    a = pool.alloc(3)
    log += [a, pool.used, pool.alloc(2)]
    pool.incref(a[0])
    log += [pool.decref(a[0]), pool.decref(a[0]), list(freed), pool.used]
    with pytest.raises(mod.BlockPoolExhaustedError):
        pool.alloc(2)
    log.append(dict(pool.stats))

    pool = mod.BlockPool(4)
    held = pool.alloc(3)
    pool.on_pressure = lambda p, short: p.decref(held[0])
    log += [held, pool.alloc(1), dict(pool.stats)]

    freed = []
    pool = mod.BlockPool(6, retain_tagged=True,
                         on_free=lambda bid, tags: freed.append(bid))
    a, b, c = pool.alloc(3)
    pool.tag(a, ("block", b"da"))
    pool.tag(b, ("block", b"db"))
    log += [pool.decref(c), list(freed), pool.decref(a), pool.decref(b),
            list(pool.cold), pool.used]
    pool.incref(a)
    log += [a in pool.cold, int(pool.ref[a])]
    pool.decref(a)
    log += [list(pool.cold), pool.evict_cold(1), list(freed)]
    pool.evict(a)
    log += [list(pool.cold), pool.used, list(freed), dict(pool.stats)]

    pool = mod.BlockPool(4, retain_tagged=True)
    pool.on_pressure = lambda p, short: p.evict_cold(short)
    blocks = pool.alloc(3)
    for bid in blocks:
        pool.tag(bid, ("block", bytes([bid])))
        pool.decref(bid)
    log += [pool.cold_count, pool.alloc(2), pool.cold_count,
            dict(pool.stats), pool.ref.tolist()]
    return log


def test_block_pool_matches_reference():
    got = _pool_sequences(tpaging)
    assert got == _pool_sequences(jpaging)
    assert got[0] == [1, 2, 3] and 0 not in got[2]     # trash never leaves


def test_block_pool_rejects_bad_refs():
    pool = tpaging.BlockPool(4)
    with pytest.raises(ValueError):
        pool.decref(1)
    with pytest.raises(ValueError):
        pool.incref(2)
    with pytest.raises(ValueError):
        tpaging.BlockPool(1)


@pytest.mark.parametrize("blk", [1, 7, 16])
def test_chain_digests_equal_reference(blk):
    rng = np.random.default_rng(blk)
    for n in (1, blk, 3 * blk + 2, 40):
        p = rng.integers(0, 1 << 20, size=n).astype(np.int32)
        assert tpaging.chain_digests(p, blk) == jpaging.chain_digests(p, blk)
    p1 = np.arange(2, 42, dtype=np.int32)
    d1, t1 = tpaging.chain_digests(p1, 16)
    d2, t2 = tpaging.chain_digests(np.concatenate([p1[:32], p1[32:] + 7]),
                                   16)
    assert len(d1) == 2 and d1 == d2 and t1 != t2


# -- paged cache write and chunked prefill against the reference -------------


@pytest.mark.parametrize("rolling", [False, True])
@pytest.mark.parametrize("s_new", [1, 5])
def test_paged_cache_update_matches_reference(rolling, s_new):
    """Per-slot cursors near and past the virtual capacity, -1 entries:
    every block but trash block 0 equal to the JAX scatter, exactly."""
    rng = np.random.default_rng(s_new + 10 * rolling)
    n_blocks, blk, hk, dh, b, nb = 9, 4, 2, 8, 3, 3
    k = rng.normal(size=(n_blocks, blk, hk, dh)).astype(np.float32)
    v = rng.normal(size=(n_blocks, blk, hk, dh)).astype(np.float32)
    table = np.array([[3, 5, -1], [1, 2, 4], [8, -1, 6]], np.int32)
    length = np.array([2, 10, 11], np.int32)
    k_new = rng.normal(size=(b, s_new, hk, dh)).astype(np.float32)
    v_new = rng.normal(size=(b, s_new, hk, dh)).astype(np.float32)
    ref = jattn.paged_cache_update(
        jattn.PagedKVCache(*map(jnp.asarray, (k, v, table, length))),
        jnp.asarray(k_new), jnp.asarray(v_new), rolling=rolling)
    got = tattn.cache_update(
        tattn.PagedKVCache(*(torch.from_numpy(a.copy())
                             for a in (k, v, table, length))),
        torch.from_numpy(k_new), torch.from_numpy(v_new), rolling=rolling)
    for name in ("k", "v"):
        np.testing.assert_array_equal(getattr(got, name)[1:].numpy(),
                                      np.asarray(getattr(ref, name))[1:])
    np.testing.assert_array_equal(got.length.numpy(),
                                  np.asarray(ref.length))


def _paged_pool(cfg, n_blocks, blk, table, framework):
    hd = cfg.head_dim or cfg.d_model // cfg.n_heads
    shape = (cfg.n_layers, n_blocks, blk, cfg.n_kv_heads, hd)
    b, nb = table.shape
    if framework == "jax":
        return {"scan": jattn.PagedKVCache(
            jnp.zeros(shape), jnp.zeros(shape),
            jnp.broadcast_to(jnp.asarray(table), (cfg.n_layers, b, nb)),
            jnp.zeros((cfg.n_layers, b), jnp.int32)), "prefix": []}
    return {"scan": tattn.PagedKVCache(
        torch.zeros(shape), torch.zeros(shape), torch.from_numpy(table),
        torch.zeros((cfg.n_layers, b), dtype=torch.int32)), "prefix": []}


def test_prefill_extend_chained_equals_single_shot(world):
    """Three segments through a paged cache against one prefill of the
    whole prompt into a dense cache: logits and every live cell."""
    cfg, model, params = world
    rng = np.random.default_rng(3)
    prompt = rng.integers(2, cfg.vocab, size=40).astype(np.int32)
    table = np.array([[4, 2, 7, -1]], np.int32)
    cache = _paged_pool(cfg, 9, 16, table, "torch")
    for lo, hi in ((0, 13), (13, 29), (29, 40)):
        toks = np.zeros((1, 16), np.int32)
        toks[0, :hi - lo] = prompt[lo:hi]
        logits, cache = model.prefill_extend(
            params, {"tokens": torch.from_numpy(toks), "start": lo,
                     "seg_len": hi - lo}, cache)
    assert cache["scan"].length.eq(40).all()
    ref, dense = model.prefill(
        params, {"tokens": torch.from_numpy(prompt[None])},
        model.init_cache(1, ShapeConfig("t", "decode", MAX_LEN, 1)))
    np.testing.assert_allclose(logits.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    for i in range(cfg.n_layers):
        view = tattn.paged_view(cache["scan"].layer(i))
        np.testing.assert_allclose(view.k[:, :40].numpy(),
                                   dense["scan"].k[i, :, :40].numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_prefill_extend_matches_reference():
    jcfg, _, jparams, tm, tp = _pair(ARCH)
    rng = np.random.default_rng(4)
    prompt = rng.integers(2, jcfg.vocab, size=27).astype(np.int32)
    table = np.array([[5, 1, -1], [3, 6, 2]], np.int32)
    jc = _paged_pool(jcfg, 8, 8, table, "jax")
    tc = _paged_pool(jcfg, 8, 8, table, "torch")
    for lo, hi in ((0, 11), (11, 27)):
        toks = np.zeros((2, 16), np.int32)
        toks[:, :hi - lo] = prompt[lo:hi]
        toks[1, :hi - lo] = toks[1, :hi - lo][::-1]
        jl, jc = jtransformer.prefill_extend(jcfg, jparams, jnp.asarray(toks),
                                             jc, start=lo, seg_len=hi - lo)
        tl, tc = tm.prefill_extend(tp, {"tokens": torch.from_numpy(toks),
                                        "start": lo, "seg_len": hi - lo}, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-5)
    conv = from_jax_cache(jax.tree.map(np.asarray, jc), "cpu")["scan"]
    assert torch.equal(conv.table, tc["scan"].table)
    assert torch.equal(conv.length, tc["scan"].length)
    np.testing.assert_allclose(tc["scan"].k[:, 1:].numpy(),
                               conv.k[:, 1:].numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="full-causal"):
        ttransformer.prefill_extend(TCONFIGS["h2o-danube-1.8b"].reduced(),
                                    tp, torch.zeros((1, 4), dtype=torch.int32),
                                    tc, start=0, seg_len=4)


# -- engines ------------------------------------------------------------------


@pytest.mark.parametrize("arch", [ARCH, "h2o-danube-1.8b"])
def test_paged_greedy_equals_reference_engine(arch):
    """The same trace (with shared prefixes for the full-causal model)
    through repro's PagedEngine and the port's."""
    jcfg, jm, jparams, tm, tp = _pair(arch)
    spec = _mixed(jcfg.vocab, 6)
    shared = spec[2][1]
    spec += [(6, shared.copy(), 6),
             (7, np.concatenate([shared[:17], spec[0][1]]), 5)]
    kw = dict(batch_slots=3, max_len=MAX_LEN, decode_chunk=CHUNK)
    ref = _drain(jengine, jpaging.PagedEngine(jm, jparams, **kw), spec)
    eng = tpaging.PagedEngine(tm, tp, **kw)
    assert _drain(tengine, eng, spec) == ref
    if arch == ARCH:
        assert eng.stats["prefix_hits"] >= 2
    assert eng.pool.used == 0


@pytest.mark.parametrize("slots", [1, 3])
def test_paged_equals_dense_batch1(world, slots):
    cfg, model, params = world
    spec = _mixed(cfg.vocab, 7, seed=1)
    dense = _drain(tengine, _dense(model, params, batch_slots=slots), spec)
    eng = _paged(model, params, batch_slots=slots)
    assert _drain(tengine, eng, spec) == dense
    assert eng.stats["prefills"] == len(spec)


def test_grpo_group_prefix_dedup(world):
    """k samples of one question prompt: one prefill for the co-resident
    group, the rest admit off shared blocks, sampled tokens equal to the
    dense engine's."""
    cfg, model, params = world
    rng = np.random.default_rng(11)
    q = rng.integers(2, cfg.vocab, size=37).astype(np.int32)
    spec = [(i, q.copy(), 6) for i in range(8)]
    dense = _drain(tengine, _dense(model, params, batch_slots=4, seed=5),
                   spec, temperature=0.8)
    eng = _paged(model, params, batch_slots=4, seed=5)
    assert _drain(tengine, eng, spec, temperature=0.8) == dense
    s = eng.perf_summary()
    assert s["prefix_hits"] >= 3 and s["prefix_hit_rate"] > 0
    assert eng.stats["prefills"] < len(spec)
    assert eng.pool.used == 0


def test_full_prefix_hit_skips_prefill_entirely(world):
    cfg, model, params = world
    q = np.random.default_rng(13).integers(
        2, cfg.vocab, size=32).astype(np.int32)             # % blk == 0
    eng = _paged(model, params, batch_slots=2)
    _drain(tengine, eng, [(0, q.copy(), 4), (1, q.copy(), 4)])
    assert eng.stats["prefills"] == 1
    assert eng.stats["prefix_hit_tokens"] >= len(q)


def test_cow_fork_leaves_sibling_untouched(world):
    """Staggered admissions sharing a partial tail block: the second
    request forks before its first write, so the first one decodes on
    untouched KV; a third shares only full blocks (partial hit, resumed
    through prefill_extend)."""
    cfg, model, params = world
    rng = np.random.default_rng(17)
    pre = rng.integers(2, cfg.vocab, size=21).astype(np.int32)
    spec = [(0, pre.copy(), 10), (1, pre.copy(), 10),
            (2, np.concatenate([pre, rng.integers(2, cfg.vocab, size=9)
                                .astype(np.int32)]), 10)]

    def staggered(eng):
        reqs = [tengine.Request(i, p, max_new_tokens=mn)
                for i, p, mn in spec]
        eng.submit(reqs[0])
        eng.step()
        eng.step()
        eng.submit(reqs[1])
        eng.submit(reqs[2])
        eng.run_until_drained()
        return [r.out_tokens for r in reqs]

    dense = staggered(_dense(model, params, batch_slots=2))
    eng = _paged(model, params, batch_slots=2)
    assert staggered(eng) == dense
    assert eng.stats["cow_forks"] >= 1 and eng.stats["paged_extends"] >= 1


def test_refcount_zero_exactly_at_retire(world):
    cfg, model, params = world
    q = np.random.default_rng(19).integers(
        2, cfg.vocab, size=37).astype(np.int32)
    eng = _paged(model, params, batch_slots=3)
    for i in range(3):
        eng.submit(tengine.Request(i, q.copy(), max_new_tokens=4 + 6 * i))
    while eng.step() or eng.queue:
        for slot, req in enumerate(eng.active):
            if req is not None:
                assert all(eng.pool.ref[b] > 0
                           for b in eng._slot_blocks[slot])
    assert eng.pool.used == 0
    assert not eng.prefix.blocks and not eng.prefix.tails


def test_flush_prefix_cache_forces_reprefill(world):
    cfg, model, params = world
    q = np.random.default_rng(23).integers(
        2, cfg.vocab, size=32).astype(np.int32)
    eng = _paged(model, params, batch_slots=2)
    _drain(tengine, eng, [(0, q.copy(), 4)])
    assert eng.prefix.tails
    eng.flush_prefix_cache()
    assert not eng.prefix.blocks and not eng.prefix.tails
    _drain(tengine, eng, [(1, q.copy(), 4)])
    assert eng.stats["prefills"] == 2


def test_cache_prefixes_hit_survives_retire(world):
    cfg, model, params = world
    q = np.random.default_rng(31).integers(
        2, cfg.vocab, size=32).astype(np.int32)
    spec = [(0, q.copy(), 6)]
    dense = _drain(tengine, _dense(model, params, batch_slots=2), spec)
    eng = _paged(model, params, batch_slots=2, cache_prefixes=True)
    first = _drain(tengine, eng, spec)
    assert eng.pool.cold_count > 0 and eng.prefix.blocks
    second = _drain(tengine, eng, [(1, q.copy(), 6)])
    assert first == dense and second == dense
    assert eng.stats["prefills"] == 1 and eng.pool.stats["revived"] > 0
    eng.flush_prefix_cache()              # parked blocks free outright
    assert eng.pool.cold_count == 0 and eng.pool.used == 0


def test_cache_prefixes_pressure_evicts_instead_of_deferring(world):
    cfg, model, params = world
    rng = np.random.default_rng(37)
    spec = [(i, rng.integers(2, cfg.vocab, size=40).astype(np.int32), 8)
            for i in range(3)]
    dense = _drain(tengine, _dense(model, params, batch_slots=1), spec)
    eng = _paged(model, params, batch_slots=1, pool_blocks=7,
                 cache_prefixes=True)
    assert _drain(tengine, eng, spec) == dense
    assert eng.pool.stats["evicted"] > 0
    assert eng.stats["admit_deferred"] == 0


def test_pool_exhaustion_defers_then_raises_typed(world):
    cfg, model, params = world
    rng = np.random.default_rng(29)
    spec = [(i, rng.integers(2, cfg.vocab, size=40).astype(np.int32), 10)
            for i in range(3)]
    eng = _paged(model, params, batch_slots=4, pool_blocks=5)
    paged = _drain(tengine, eng, spec)
    assert eng.stats["admit_deferred"] > 0 and eng.pool.used == 0
    assert paged == _drain(tengine, _dense(model, params, batch_slots=1),
                           spec)
    small = _paged(model, params, batch_slots=2, pool_blocks=3)
    small.submit(tengine.Request(0, rng.integers(
        2, cfg.vocab, size=50).astype(np.int32), max_new_tokens=30))
    with pytest.raises(tpaging.BlockPoolExhaustedError):
        small.run_until_drained()
    assert len(small.queue) == 1


def test_long_prompt_chunked_prefill(world):
    """capacity_blocks widens tables past max_len: a 100-token prompt
    admits through one bucketed prefill and prefill_extend segments and
    matches a dense engine wide enough to take it in one prefill."""
    cfg, model, params = world
    p = np.random.default_rng(31).integers(
        2, cfg.vocab, size=100).astype(np.int32)
    ref = _drain(tengine, _dense(model, params, batch_slots=1, max_len=128),
                 [(0, p, 6)])
    eng = _paged(model, params, batch_slots=1, capacity_blocks=8,
                 prefill_chunk=32)
    assert _drain(tengine, eng, [(0, p, 6)]) == ref
    assert eng.stats["paged_extends"] >= 2


def test_paged_rejects_encdec():
    model = types.SimpleNamespace(
        cfg=TCONFIGS["seamless-m4t-medium"].reduced(),
        device=torch.device("cpu"))
    with pytest.raises(ValueError, match="encdec"):
        tpaging.PagedEngine(model, {}, batch_slots=2, max_len=MAX_LEN)


def test_build_paged_cache_sizes(world):
    cfg, model, _ = world
    shape = ShapeConfig("t", "decode", MAX_LEN, 3)
    cache, nb, n_blocks = tpaging.build_paged_cache(model, 3, shape,
                                                    block_size=16)
    c = cache["scan"]
    assert (nb, n_blocks) == (4, 13) and c.s_max == MAX_LEN
    assert c.k.shape == (cfg.n_layers, 13, 16, cfg.n_kv_heads, 16)
    assert c.table.shape == (3, 4) and bool((c.table == -1).all())
    _, nb, _ = tpaging.build_paged_cache(model, 3, shape, block_size=16,
                                         capacity_blocks=8)
    assert nb == 8
    with pytest.raises(ValueError, match="divide"):
        tpaging.build_paged_cache(model, 3, shape, block_size=24)


# -- overlapped admission -----------------------------------------------------


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("long_new", [12, 3])
def test_overlap_admission_equals_serial(world, temperature, long_new):
    """Prefills issued under the in-flight chunk splice at the next
    boundary with the tokens of serial batch-1 admission. With budgets
    under one chunk every slot retires each chunk while prefilled
    requests wait: the engine must not stop with them unserved."""
    cfg, model, params = world
    spec = _mixed(cfg.vocab, 8, seed=43, long_new=long_new)
    serial = _drain(tengine, _dense(model, params, batch_slots=2, seed=7),
                    spec, temperature=temperature)
    eng = _dense(model, params, batch_slots=2, seed=7,
                 overlap_admission=True)
    assert _drain(tengine, eng, spec, temperature=temperature) == serial
    assert eng.stats["prefills"] == len(spec)


def test_from_jax_cache_converts_paged():
    jc = {"scan": jattn.PagedKVCache(
        jnp.ones((2, 3, 4, 1, 8)), jnp.zeros((2, 3, 4, 1, 8)),
        jnp.broadcast_to(jnp.asarray([[1, -1]], jnp.int32), (2, 1, 2)),
        jnp.asarray([[3], [3]], jnp.int32)), "prefix": []}
    c = from_jax_cache(jax.tree.map(np.asarray, jc), "cpu")["scan"]
    assert isinstance(c, tattn.PagedKVCache)
    assert c.table.tolist() == [[1, -1]] and c.k.shape == (2, 3, 4, 1, 8)
    assert c.layer(1).length.tolist() == [3]
    bad = jc["scan"]._replace(table=jnp.asarray([[[1, -1]], [[2, -1]]],
                                                jnp.int32))
    with pytest.raises(ValueError, match="differ"):
        from_jax_cache(jax.tree.map(np.asarray, {"scan": bad, "prefix": []}),
                       "cpu")
    assert to_tensor(np.asarray(jc["scan"].length), "cpu").dtype == \
        torch.int32
