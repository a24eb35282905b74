"""repro_torch's fault-tolerant swarm serving against repro's, on the CPU.

The world is repro's swarm-serving test model: internlm2-1.8b reduced
to 4 layers, fp32, JAX weights from PRNGKey(0) converted with
``from_jax_params``. Greedy tokens must equal repro's
``ContinuousEngine`` and repro's ``SwarmRouter`` exactly, for the
healthy chain and after every failover (kill, stall, corrupt, paged
pools, adoption). Inside the port, staged serving is bitwise the
monolithic prefill / decode (the same functions); across the two
packages stage outputs agree within 1e-4 (fp32, as
``test_torch_model.py``). The wire is checked both ways: repro's router
drives a port fleet, and the port's router drives repro's
``tests.fault_harness.StageFleet``. Every socket has a timeout of a few
seconds, so a fault can fail a test but not hang it.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import registry as jregistry
from repro.models import transformer as jtf
from repro.serving import swarm_serve as jsw
from repro.serving.engine import ContinuousEngine as JContinuousEngine
from repro.serving.engine import Request as JRequest
from repro import checkpointing as jcp
from repro_torch import checkpointing as tcp
from repro_torch.checkpointing import (ChunkGossip, ChunkPeer, ChunkStore,
                                       PeerConn, PeerConnPool)
from repro_torch.checkpointing.checkpoint import _flatten
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.models import registry
from repro_torch.models import transformer as tf
from repro_torch.serving import swarm_serve as sw
from tests.fault_harness import StageFleet

torch.set_float32_matmul_precision("highest")
torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

MAX_NEW = 8
MAX_LEN = 128
TIMEOUT = 3.0
TOL = 1e-4


def _jax_baseline(cfg, params, prompts):
    eng = JContinuousEngine(jregistry.get_model(cfg), params, batch_slots=2,
                            max_len=MAX_LEN)
    reqs = [JRequest(rid=i, prompt=np.asarray(p, np.int32),
                     max_new_tokens=MAX_NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return [list(r.out_tokens) for r in reqs]


@pytest.fixture(scope="module")
def world():
    jcfg = dataclasses.replace(jget_config("internlm2-1.8b").reduced(),
                               n_layers=4)
    params, _ = jregistry.get_model(jcfg).init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config("internlm2-1.8b").reduced(),
                              n_layers=4)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(2, cfg.vocab, size=n).tolist()
               for n in (5, 9, 12)]
    return types.SimpleNamespace(
        jcfg=jcfg, jparams=params, cfg=cfg, prompts=prompts,
        params=from_jax_params(jax.tree.map(np.asarray, params), "cpu"),
        baseline=_jax_baseline(jcfg, params, prompts))


class PortFleet:
    """K-stage x R-replica fleet of the port's ``StageServer``s on the
    CPU (``tests.fault_harness.StageFleet``'s counterpart): the stage
    slices published into a seed store served by a ``ChunkPeer``,
    server ``(sid, r)`` serving stage ``sid``, the fault knobs, and
    ``router()`` wiring gossip + pool + ``SwarmRouter``."""

    def __init__(self, cfg, params, root, *, k_stages, replicas=2,
                 max_len=MAX_LEN, **server_kw):
        self.k = k_stages
        self.seed_store = ChunkStore(root / "seed")
        sw.publish_stages(self.seed_store, cfg, params, k_stages)
        self.seed_peer = ChunkPeer(self.seed_store)
        self.servers = {}
        self._closers = [self.seed_peer.close]
        for sid, stage in enumerate(registry.make_stages(cfg, k_stages,
                                                         "cpu")):
            sp = stage.slice_params(params)
            for r in range(replicas):
                srv = sw.StageServer(cfg, ChunkStore(root / f"srv_{sid}_{r}"),
                                     k_stages=k_stages, max_len=max_len,
                                     device="cpu", **server_kw)
                srv.serve_stage(sid, sp)
                self.servers[(sid, r)] = srv

    @property
    def addrs(self):
        return [s.addr for s in self.servers.values()]

    def addr_of(self, sid, r=0):
        return self.servers[(sid, r)].addr

    def kill(self, sid, r=0, after_ops=0):
        s = self.servers[(sid, r)]
        s.crash_after = s.served_chunks + after_ops

    def stall(self, sid, r=0, seconds=10.0, after_ops=0):
        s = self.servers[(sid, r)]
        s.stall_chunks, s.stall_s = s.served_chunks + after_ops, seconds

    def corrupt(self, sid, r=0, after_ops=0):
        s = self.servers[(sid, r)]
        s.corrupt_after = s.served_chunks + after_ops

    def router(self, *, timeout=TIMEOUT, max_replays=8, cls=None):
        pool = PeerConnPool(timeout=timeout)
        gossip = ChunkGossip(self.addrs, timeout=timeout, pool=pool)
        self._closers += [gossip.stop, pool.close]
        gossip.poll_once()
        return (cls or sw.SwarmRouter)(self.k, gossip, timeout=timeout,
                                       pool=pool, max_replays=max_replays,
                                       max_len=MAX_LEN)

    def close(self):
        for close in self._closers[::-1]:
            close()
        for s in self.servers.values():
            s.close()


@pytest.fixture
def fleets(tmp_path):
    """Builds port fleets under ``tmp_path`` and closes them all."""
    made = []

    def make(world, **kw):
        f = PortFleet(world.cfg, world.params, tmp_path / f"f{len(made)}",
                      **kw)
        made.append(f)
        return f
    yield make
    for f in made:
        f.close()


def _victim(fleet, router, sid):
    """The (sid, r) key of the replica the router would pick first."""
    addr = router._pick(sid)
    return next(k for k, s in fleet.servers.items() if s.addr == addr)


def _batch(world, b=2, s=12):
    toks = np.zeros((b, s), np.int32)
    plen = np.array([5, 12], np.int32)[:b]
    for i in range(b):
        toks[i, :plen[i]] = world.prompts[2][:plen[i]]
    return toks, plen


# -- stage partition seam -----------------------------------------------------


def test_stage_bounds_equal_reference_and_typed_errors(world):
    for k in range(1, 5):
        assert tf.stage_bounds(world.cfg, k) == \
            [tuple(b) for b in jtf.stage_bounds(world.jcfg, k)]
    with pytest.raises(ValueError):
        tf.stage_bounds(world.cfg, 5)         # more stages than layers
    with pytest.raises(ValueError):
        registry.make_stages(get_config("mamba2-130m").reduced(), 2)
    for arch in ("deepseek-moe-16b", "phi-3-vision-4.2b"):
        cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=4)
        jcfg = dataclasses.replace(jget_config(arch).reduced(), n_layers=4)
        stages = registry.make_stages(cfg, 2, "cpu")
        assert [(s.lo, s.hi) for s in stages] == \
            [(s.lo, s.hi) for s in jregistry.make_stages(jcfg, 2)]


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_staged_equals_monolithic_bitwise(world, k):
    cfg, params = world.cfg, world.params
    toks, plen = _batch(world)
    toks, plen = torch.from_numpy(toks), torch.from_numpy(plen)
    logits_m, cache_m = tf.prefill(cfg, params, toks,
                                   tf.init_cache(cfg, 2, MAX_LEN,
                                                 device="cpu"),
                                   prompt_len=plen)
    stages = registry.make_stages(cfg, k, "cpu")
    sp = [s.slice_params(params) for s in stages]
    # a stage's parameters are views of the full stacked tensors
    for s, p in zip(stages, sp):
        w = p["layers"]["mlp"]["up"]
        assert w.shape[0] == s.hi - s.lo and w.untyped_storage().data_ptr() \
            == params["layers"]["mlp"]["up"].untyped_storage().data_ptr()
    sc = [s.init_cache(2, MAX_LEN) for s in stages]
    x = toks
    for i, s in enumerate(stages):
        x, _ = s.prefill(sp[i], x, sc[i], prompt_len=plen)
    assert torch.equal(x, logits_m)
    tok = logits_m.argmax(-1, keepdim=True).to(torch.int32)
    for _ in range(3):
        dec_m, _ = tf.decode_step(cfg, params, tok, cache_m)
        x = tok
        for i, s in enumerate(stages):
            x, _ = s.decode(sp[i], x, sc[i])
        assert torch.equal(x, dec_m)
        tok = dec_m.argmax(-1, keepdim=True).to(torch.int32)
    for i, s in enumerate(stages):
        assert torch.equal(sc[i]["scan"].k, cache_m["scan"].k[s.lo:s.hi])
        assert torch.equal(sc[i]["scan"].length,
                           cache_m["scan"].length[s.lo:s.hi])


def test_stage_outputs_match_reference(world):
    """Each stage's prefill activations / logits and a decode step of
    the port within 1e-4 of repro's, stage by stage on the same inputs
    (each stage fed the reference's upstream output)."""
    toks, plen = _batch(world)
    jstages = jregistry.make_stages(world.jcfg, 2)
    stages = registry.make_stages(world.cfg, 2, "cpu")
    jx, jp = jnp.asarray(toks), jnp.asarray(plen)
    jcaches, caches = [], []
    for js, s in zip(jstages, stages):
        jc = js.init_cache(2, MAX_LEN)
        c = s.init_cache(2, MAX_LEN)
        inp = torch.from_numpy(np.array(jx))
        out, _ = s.prefill(s.slice_params(world.params), inp, c,
                           prompt_len=torch.from_numpy(plen))
        jx, jc = js.prefill(js.slice_params(world.jparams), jx, jc,
                            prompt_len=jp)
        np.testing.assert_allclose(out.numpy(), np.asarray(jx), rtol=TOL,
                                   atol=TOL)
        jcaches.append(jc)
        caches.append(c)
    jx = jnp.argmax(jx, -1)[:, None].astype(jnp.int32)
    for i, (js, s) in enumerate(zip(jstages, stages)):
        out, _ = s.decode(s.slice_params(world.params),
                          torch.from_numpy(np.array(jx)), caches[i])
        jx, _ = js.decode(js.slice_params(world.jparams), jx, jcaches[i])
        np.testing.assert_allclose(out.numpy(), np.asarray(jx), rtol=TOL,
                                   atol=TOL)


# -- healthy chain == repro's engine and router -------------------------------


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_router_equals_repro_engine(world, fleets, impl):
    """The port's chain (3 stages, the plain flash-decode on the CPU)
    gives the greedy tokens of repro's engine, whose decode attention is
    its ``decode_attn_impl`` ("pallas": the Pallas kernel in interpret
    mode). repro's router is held to the same tokens on a port fleet by
    ``test_wire_compatible_both_ways``."""
    jcfg = dataclasses.replace(world.jcfg, decode_attn_impl=impl)
    baseline = world.baseline if impl == "jnp" else \
        _jax_baseline(jcfg, world.jparams, world.prompts)
    assert baseline == world.baseline
    router = fleets(world, k_stages=3, replicas=1).router()
    assert [router.generate(p, MAX_NEW, eos_id=1)
            for p in world.prompts] == baseline
    assert router.stats["failovers"] == 0


# -- failover -----------------------------------------------------------------


@pytest.mark.parametrize("case", ["kill", "stall", "corrupt", "paged",
                                  "paged_kill"])
def test_failover_tokens_equal_baseline(world, fleets, case):
    """repro's scenarios on a port fleet: a kill at the 4th response of
    the stage-1 holder the router picks (1 prefill + 2 decodes land, the
    3rd decode hits a dead peer), a stall past the router's deadline, a
    corrupted frame, paged stage pools (every pool drained after
    release), and a kill during paged decode."""
    paged = case.startswith("paged")
    fleet = fleets(world, k_stages=3 if case != "stall" else 2,
                   replicas=2 if case != "paged" else 1,
                   kv_layout="paged" if paged else "dense")
    router = fleet.router()
    prompt = {"kill": 1, "stall": 0, "corrupt": 2}.get(case, 1)
    if case in ("kill", "paged_kill"):
        fleet.kill(*_victim(fleet, router, 1), after_ops=3)
    elif case == "stall":
        fleet.stall(*_victim(fleet, router, 1), seconds=10.0, after_ops=2)
    elif case == "corrupt":
        fleet.corrupt(*_victim(fleet, router, 0), after_ops=2)
    prompts = world.prompts if case == "paged" else [world.prompts[prompt]]
    want = world.baseline if case == "paged" else [world.baseline[prompt]]
    assert [router.generate(p, MAX_NEW, eos_id=1) for p in prompts] == want
    if case == "paged":
        assert router.stats["failovers"] == 0
        for srv in fleet.servers.values():
            assert srv._pools                     # the paged path ran
            for ent in srv._pools.values():
                assert ent["pool"].used == 0      # released at retire
        return
    assert router.stats["failovers"] >= 1
    if case in ("kill", "paged_kill"):
        assert router.stats["recoveries"] >= 1
        assert router.stats["replayed_tokens"] > 0


class _LogitRouter(sw.SwarmRouter):
    """Keeps the last stage's logits of every step."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.logits = []

    def _prefill_chain(self, req):
        self.logits.append(super()._prefill_chain(req))
        return self.logits[-1]

    def _decode_chain(self, req):
        self.logits.append(super()._decode_chain(req))
        return self.logits[-1]


@pytest.mark.parametrize("kv_layout", ["dense", "paged"])
@pytest.mark.parametrize("fail_sid", [0, 1, 2])
def test_recovered_logits_bitwise_uninterrupted(world, fleets, kv_layout,
                                                fail_sid):
    """The port's recovery replays the failed stage's prefix as the
    uninterrupted run computed it (prompt prefill, then a decode per
    emitted token), so every step's logits after a kill mid-decode, at
    any stage, are bitwise the healthy chain's (repro's one-pass prefill
    over the prefix is not: 1e-6 off in fp32 here)."""
    logits = {}
    for kill in (False, True):
        fleet = fleets(world, k_stages=3, replicas=2, kv_layout=kv_layout)
        router = fleet.router(cls=_LogitRouter)
        if kill:
            fleet.kill(*_victim(fleet, router, fail_sid), after_ops=3)
        assert [router.generate(p, MAX_NEW, eos_id=1)
                for p in world.prompts[:2]] == world.baseline[:2]
        assert router.stats["recoveries"] == kill
        logits[kill] = router.logits
    assert len(logits[True]) == len(logits[False])
    assert all(torch.equal(a, b) for a, b in zip(*logits.values()))


@pytest.mark.parametrize("case", ["no_holder", "replay_budget"])
def test_unservable_chain_fails_typed(world, fleets, case):
    if case == "no_holder":
        fleet = fleets(world, k_stages=3, replicas=1)
        router = fleet.router()
        fleet.kill(1, 0, after_ops=3)           # the ONLY stage-1 holder
        err = sw.StageUnservableError
    else:
        fleet = fleets(world, k_stages=2, replicas=2)
        router = fleet.router(max_replays=0)
        fleet.kill(*_victim(fleet, router, 1), after_ops=2)
        err = sw.ReplayBudgetError
    with pytest.raises(err):
        router.generate(world.prompts[0], MAX_NEW, eos_id=1)


# -- weight distribution / adoption -------------------------------------------


def test_adopt_stage_via_swarm_fetch(tmp_path, world, fleets):
    fleet = fleets(world, k_stages=2, replicas=1)
    joiner = sw.StageServer(world.cfg, ChunkStore(tmp_path / "joiner"),
                            k_stages=2, max_len=MAX_LEN, device="cpu")
    fleet.servers[(1, 99)] = joiner             # closed with the fleet
    stats = joiner.adopt_stage(1, [fleet.seed_peer.addr])
    assert stats["chunks_fetched"] > 0 and joiner.stage_ids() == [1]
    want = _flatten(registry.make_stages(world.cfg, 2, "cpu")[1]
                    .slice_params(world.params))
    got = _flatten(joiner._stages[1])
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    # kill whichever stage-1 holder the router picks first: the chain
    # must still give the baseline, so the adopted weights really serve
    router = fleet.router()
    fleet.kill(*_victim(fleet, router, 1), after_ops=3)
    assert router.generate(world.prompts[0], MAX_NEW, eos_id=1) == \
        world.baseline[0]
    assert router.stats["failovers"] >= 1


def test_adopt_stage_rpc(tmp_path, world, fleets):
    fleet = fleets(world, k_stages=2, replicas=1)
    joiner = sw.StageServer(world.cfg, ChunkStore(tmp_path / "joiner2"),
                            k_stages=2, max_len=MAX_LEN, device="cpu")
    fleet.servers[(0, 99)] = joiner
    c = PeerConn(joiner.addr, TIMEOUT)
    try:
        resp = c.request_json({"op": "adopt_stage", "sid": 0,
                               "peers": [list(fleet.seed_peer.addr)]})
    finally:
        c.close()
    assert resp["ok"] and resp["stage"] == 0 and resp["chunks_fetched"] > 0
    assert joiner.stage_ids() == [0]


def test_publish_stages_equal_repro(tmp_path, world):
    """The same weights published by both packages: equal manifests
    (keys, shapes, dtypes, chunk ids, meta), so a stage published by one
    is adopted by the other's swarm fetch."""
    got = sw.publish_stages(ChunkStore(tmp_path / "port"), world.cfg,
                            world.params, 3)
    want = jsw.publish_stages(jcp.ChunkStore(tmp_path / "jax"), world.jcfg,
                              world.jparams, 3)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["meta"] == w["meta"] and g["step"] == w["step"]
        assert g["keys"] == w["keys"]
    only = sw.publish_stages(ChunkStore(tmp_path / "one"), world.cfg,
                             world.params, 3, stage_ids=[1])
    assert [m["keys"] for m in only] == [want[1]["keys"]]
    like = registry.stage_param_specs(world.cfg, 3)[1]
    assert like["layers"]["wq"].device.type == "meta"
    back = sw.restore_stage_params(ChunkStore(tmp_path / "jax"), world.cfg,
                                   3, 1, "cpu")
    assert torch.equal(back["layers"]["wq"],
                       world.params["layers"]["wq"][2:3])


# -- gossip possession and connection reuse -----------------------------------


def test_stage_possession_rides_gossip(world, fleets):
    fleet = fleets(world, k_stages=2, replicas=2)
    router = fleet.router()
    for sid in range(2):
        assert set(router.holders(sid)) == {fleet.addr_of(sid, r)
                                            for r in range(2)}
    # dropping a stage moves the digest sha -> gossip re-pulls
    fleet.servers[(1, 0)].drop_stage(1)
    router.refresh()
    assert set(router.holders(1)) == {fleet.addr_of(1, 1)}


def test_router_pool_reuses_connections(world, fleets):
    router = fleets(world, k_stages=2, replicas=1).router()
    router.generate(world.prompts[0], MAX_NEW, eos_id=1)
    assert router.pool.stats["reused"] > 0
    created = router.pool.stats["created"]
    router.generate(world.prompts[1], MAX_NEW, eos_id=1)
    assert router.pool.stats["created"] == created   # steady state


# -- wire compatibility -------------------------------------------------------


@pytest.mark.parametrize("server", ["port", "repro"])
def test_wire_compatible_both_ways(tmp_path, world, fleets, server):
    """repro's router drives a port fleet, and the port's router
    repro's fleet, each through a mid-chain kill, to the baseline."""
    if server == "port":
        fleet = fleets(world, k_stages=3, replicas=2)
        cp, router_cls, closers = jcp, jsw.SwarmRouter, []
    else:
        fleet = StageFleet(world.jcfg, world.jparams, tmp_path / "jax",
                           k_stages=2, replicas=2, max_len=MAX_LEN)
        cp, router_cls, closers = tcp, sw.SwarmRouter, [fleet.close]
    pool = cp.PeerConnPool(timeout=TIMEOUT)
    gossip = cp.ChunkGossip(fleet.addrs, timeout=TIMEOUT, pool=pool)
    closers = [gossip.stop, pool.close] + closers
    try:
        gossip.poll_once()
        router = router_cls(fleet.k, gossip, timeout=TIMEOUT, pool=pool,
                            max_len=MAX_LEN)
        fleet.kill(*_victim(fleet, router, 1), after_ops=3)
        assert [router.generate(p, MAX_NEW, eos_id=1)
                for p in world.prompts] == world.baseline
        assert router.stats["failovers"] >= 1
    finally:
        for close in closers:
            close()
