"""The port's swarm serving on the card: the stage seam and the B = 1
chain through the flash-decode kernels. Needs a CUDA device and nvcc
(skipped without a device); imports no JAX:

  PYTHONPATH=src python -m pytest -q tests/test_torch_swarm_serve_cuda.py

Tolerances: none. Staged serving is the monolithic prefill / decode
split at layer boundaries (the same functions on the same shapes), so
on the card it is bitwise equal; a healthy chain runs every request at
B = 1, so its last-stage logits are bitwise those of a B = 1 monolithic
decode and its greedy tokens those of ``ContinuousEngine(batch_slots=1,
batch_admit=False)``. Launch counts are exact: one flash-decode launch
per layer per ``decode_stage`` a server answers (kernel 5 for dense
stage caches, kernel 6 for paged pools), none in prefill.
"""
import dataclasses
import gc
import threading

import numpy as np
import pytest
import torch

from repro_torch.checkpointing import ChunkGossip, ChunkStore, PeerConnPool
from repro_torch.configs import get_config
from repro_torch.kernels import flash_decode as fd
from repro_torch.models import registry
from repro_torch.models import transformer as tf
from repro_torch.serving import swarm_serve as sw
from repro_torch.serving.engine import ContinuousEngine, Request

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device")

MAX_LEN = 128
MAX_NEW = 8


@pytest.fixture(scope="module")
def world():
    cfg = dataclasses.replace(get_config("intellect-1").reduced(), n_layers=4)
    model = registry.get_model(cfg, "cuda")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(2, cfg.vocab, size=n).tolist()
               for n in (5, 9, 12)]
    return cfg, model, model.init(0), prompts


class _Fleet:
    """``k_stages`` x ``replicas`` port ``StageServer``s on the card and
    a router over them (gossip + pool); ``close`` ends them all."""

    def __init__(self, cfg, params, root, *, k_stages, replicas=1, **kw):
        self.servers = {}
        for sid, stage in enumerate(registry.make_stages(cfg, k_stages)):
            for r in range(replicas):
                srv = sw.StageServer(cfg, ChunkStore(root / f"s{sid}_{r}"),
                                     k_stages=k_stages, max_len=MAX_LEN,
                                     **kw)
                srv.serve_stage(sid, stage.slice_params(params))
                self.servers[(sid, r)] = srv
        self.pool = PeerConnPool(timeout=10.0)
        self.gossip = ChunkGossip([s.addr for s in self.servers.values()],
                                  timeout=10.0, pool=self.pool)
        self.gossip.poll_once()
        self.router = _LogitRouter(k_stages, self.gossip, timeout=10.0,
                                   pool=self.pool, max_len=MAX_LEN)

    def close(self):
        self.gossip.stop()
        self.pool.close()
        for s in self.servers.values():
            s.close()


class _LogitRouter(sw.SwarmRouter):
    """A ``SwarmRouter`` that keeps the last stage's logits of every
    step (prefill, then each decode) and counts the ``decode_stage``
    calls its servers answered."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.logits = []
        self.decodes = 0

    def _call(self, addr, header, arr):
        out = super()._call(addr, header, arr)
        self.decodes += header["op"] == "decode_stage"
        return out

    def _prefill_chain(self, req):
        out = super()._prefill_chain(req)
        self.logits.append(out)
        return out

    def _decode_chain(self, req):
        out = super()._decode_chain(req)
        self.logits.append(out)
        return out


def _engine_b1(model, params, prompts):
    eng = ContinuousEngine(model, params, batch_slots=1, batch_admit=False,
                           max_len=MAX_LEN)
    reqs = [Request(i, np.asarray(p, np.int32), max_new_tokens=MAX_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return [list(r.out_tokens) for r in reqs]


def _monolithic_b1_logits(cfg, params, prompt, tokens):
    """The B = 1 monolithic prefill (right-padded to the engine's
    bucket) and decode logits along ``tokens`` (teacher-forced)."""
    from repro_torch.serving.engine import bucket_len
    n = len(prompt)
    row = torch.zeros((1, max(min(bucket_len(n), MAX_LEN), n)),
                      dtype=torch.int32)
    row[0, :n] = torch.tensor(prompt, dtype=torch.int32)
    cache = tf.init_cache(cfg, 1, MAX_LEN)
    logits, _ = tf.prefill(cfg, params, row.cuda(), cache,
                           prompt_len=torch.tensor([n], dtype=torch.int32,
                                                   device="cuda"))
    out = [logits.cpu()]
    for t in tokens[:-1]:
        logits, _ = tf.decode_step(
            cfg, params, torch.tensor([[t]], dtype=torch.int32,
                                      device="cuda"), cache)
        out.append(logits.cpu())
    return out


@needs_cuda
@pytest.mark.parametrize("k", [2, 4])
def test_staged_equals_monolithic_bitwise_on_the_card(world, k):
    cfg, _, params, prompts = world
    toks = torch.zeros((2, 16), dtype=torch.int32)
    plen = torch.tensor([5, 12], dtype=torch.int32)
    for i in range(2):
        toks[i, :plen[i]] = torch.tensor(prompts[2][:plen[i]])
    toks, plen = toks.cuda(), plen.cuda()
    cache_m = tf.init_cache(cfg, 2, MAX_LEN)
    logits_m, _ = tf.prefill(cfg, params, toks, cache_m, prompt_len=plen)
    stages = registry.make_stages(cfg, k)
    sp = [s.slice_params(params) for s in stages]
    sc = [s.init_cache(2, MAX_LEN) for s in stages]
    x = toks
    for i, s in enumerate(stages):
        x, _ = s.prefill(sp[i], x, sc[i], prompt_len=plen)
    assert torch.equal(x, logits_m)
    tok = logits_m.argmax(-1, keepdim=True).to(torch.int32)
    for _ in range(4):
        dec_m, _ = tf.decode_step(cfg, params, tok, cache_m)
        x = tok
        for i, s in enumerate(stages):
            x, _ = s.decode(sp[i], x, sc[i])
        assert torch.equal(x, dec_m)
        tok = dec_m.argmax(-1, keepdim=True).to(torch.int32)


@needs_cuda
@pytest.mark.parametrize("crash", [False, True])
@pytest.mark.parametrize("kv_layout", ["dense", "paged"])
def test_b1_chain_bitwise_equals_b1_engine(tmp_path, world, kv_layout,
                                           crash):
    """A 2-stage chain's tokens equal the B = 1 engine's, its
    last-stage logits are bitwise the B = 1 monolithic decode's (with a
    stage-1 holder crashed mid-decode too: the recovery replays its
    prefix as the uninterrupted run computed it), and the decode kernel
    of the layout launched once per layer per answered ``decode_stage``
    (the other never)."""
    cfg, model, params, prompts = world
    want = _engine_b1(model, params, prompts)
    fleet = _Fleet(cfg, params, tmp_path, k_stages=2, kv_layout=kv_layout,
                   replicas=2)
    try:
        router = fleet.router
        if crash:
            first = router._pick(1)
            victim = next(v for v in fleet.servers.values()
                          if v.addr == first)
            victim.crash_after = victim.served_chunks + 3
        fd.flash_decode.launches = fd.flash_decode_paged.launches = 0
        outs = [router.generate(p, MAX_NEW, eos_id=1) for p in prompts]
        torch.cuda.synchronize()
        counts = {"dense": fd.flash_decode.launches,
                  "paged": fd.flash_decode_paged.launches}
        if kv_layout == "paged":
            for srv in fleet.servers.values():
                if srv.addr not in router.dead:
                    assert all(e["pool"].used == 0
                               for e in srv._pools.values())
    finally:
        fleet.close()
    assert outs == want
    assert router.stats["recoveries"] == crash
    assert counts == {kv_layout: cfg.n_layers // 2 * router.decodes,
                      ("paged" if kv_layout == "dense" else "dense"): 0}
    got = iter(fleet.router.logits)
    for p, toks in zip(prompts, outs):
        for ref in _monolithic_b1_logits(cfg, params, p, toks):
            assert torch.equal(next(got), ref)


@needs_cuda
def test_session_threads_keep_no_autograd_graph(tmp_path, world):
    """Grad mode is per thread and a server session is a new thread:
    with parameters that require grad, a stage call in a fresh thread
    returns no graph, and requests served by a fleet leave the card's
    memory where the first left it."""
    cfg, _, params, prompts = world

    def leaf(t):
        return {k: leaf(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.detach().clone().requires_grad_(True)
    gparams = leaf(params)
    stage = registry.make_stages(cfg, 2)[1]
    seen = {}

    def run():
        seen["grad_mode"] = torch.is_grad_enabled()
        cache = stage.init_cache(1, MAX_LEN)
        x = torch.randn((1, 8, cfg.d_model), device="cuda",
                        dtype=cfg.torch_dtype)
        out, _ = stage.prefill(stage.slice_params(gparams), x, cache)
        out2, _ = stage.decode(stage.slice_params(gparams), x[:, :1], cache)
        seen["graph"] = [t.requires_grad or t.grad_fn is not None
                         for t in (out, out2, cache["scan"].k)]
    th = threading.Thread(target=run)
    th.start()
    th.join(timeout=60)
    assert not th.is_alive()
    assert seen == {"grad_mode": True, "graph": [False, False, False]}
    fleet = _Fleet(cfg, gparams, tmp_path, k_stages=2)
    try:
        fleet.router.generate(prompts[0], MAX_NEW, eos_id=1)
        fleet.router.logits.clear()     # host tensors; the card's stay
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        for p in prompts * 2:
            fleet.router.generate(p, MAX_NEW, eos_id=1)
        fleet.router.logits.clear()
        gc.collect()
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() == base
    finally:
        fleet.close()
