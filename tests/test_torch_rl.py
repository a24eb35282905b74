"""repro_torch's asynchronous RL tier (``rl/``: the staleness buffer,
GRPO, policy publishing, rollout workers, the driver) and the serving
engines' logprob capture against repro's, on the CPU: one port of each
case of ``tests/test_rl.py`` that has a counterpart, held against
repro's function on the same numpy-seeded inputs where one exists.

Tolerances: the staleness ledger, the toy reward, ``render_example``,
the batcher's stacks, greedy tokens, ``tree_sha`` and restored chains
are exact; ``group_advantages`` and ``chosen_logprob`` within 1e-6; the
GRPO loss, its metrics and its gradient on converted params within 1e-5
(absolute and relative); a greedy engine's captured logprobs within
1e-4 of repro's (the decode attention's two implementations, as
``test_torch_model.py``). Sampled tokens come from the port's own
per-request streams and cannot match JAX's: the driver's
weight-independent counts (the ledger, versions, adoptions, fallbacks,
live versions) are held equal to repro's driver on the same
``RLConfig``, and a second port run reproduces the whole summary bar
its wall-clock rates."""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS
from repro.models import registry as jregistry
from repro.rl import buffer as jbuffer
from repro.rl import grpo as jgrpo
from repro.rl import policy_pub as jpub
from repro.serving import engine as jengine
from repro.serving import paging as jpaging
from repro_torch.checkpointing import checkpoint as tck
from repro_torch.checkpointing import delta as tdelta
from repro_torch.configs import CONFIGS as TCONFIGS
from repro_torch.convert import from_jax_params
from repro_torch.core.sync_engine import leaves
from repro_torch.models import registry
from repro_torch.rl import grpo as G
from repro_torch.rl.buffer import Rollout, RolloutBuffer
from repro_torch.rl.policy_pub import (PolicyPublisher, PolicyRetiredError,
                                      tree_sha)
from repro_torch.rl.rollout import RolloutWorker
from repro_torch.serving import engine as tengine
from repro_torch.serving.paging import PagedEngine

torch.set_float32_matmul_precision("highest")
torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

ARCH = "internlm2-1.8b"


def _ro(cls, rid, version, group=0, toks=(3, 4, 5), prompt=(5, 6)):
    toks = list(toks)
    return cls(rid=rid, prompt=np.asarray(prompt, np.int32), tokens=toks,
               logprobs=[-1.0] * len(toks), version=version, group=group)


def _both(fn):
    """fn(Rollout class, RolloutBuffer class) in each package."""
    return (fn(Rollout, RolloutBuffer),
            fn(jbuffer.Rollout, jbuffer.RolloutBuffer))


# -- staleness window ---------------------------------------------------------


@pytest.mark.parametrize("mode", ["drop", "downweight"])
def test_staleness_accepts_iff_within_window(mode):
    """A rollout k versions behind enters a batch iff k <= max_policy_lag,
    for every k; the ledger equals repro's."""
    for k in range(5):
        def run(ro, buf_cls):
            buf = buf_cls()
            buf.add([_ro(ro, 1, version=10 - k)])
            out = buf.drain(10, max_policy_lag=2, mode=mode)
            return len(out), buf.ledger.as_dict()
        (n, led), (jn, jled) = _both(run)
        assert (n == 1) == (k <= 2) and n == jn
        assert led == jled
        assert led["dropped_stale"] == (0 if k <= 2 else 1)


def test_staleness_exact_accounting_with_leftovers():
    def run(ro, buf_cls):
        buf = buf_cls(capacity=8)
        buf.add([_ro(ro, i, version=0) for i in range(10)])  # 2 evicted
        assert buf.drain(3, max_policy_lag=2) == []          # lag 3: stale
        buf.add([_ro(ro, i, version=3) for i in range(3)])
        buf.drain(3, max_policy_lag=2)
        buf.add([_ro(ro, 99, version=3)])                    # left buffered
        return buf.ledger.as_dict(), len(buf)
    (led, n), (jled, jn) = _both(run)
    assert led == jled and n == jn
    assert led["generated"] == led["accepted"] + led["dropped_stale"] \
        + led["evicted_capacity"] + n
    assert (led["accepted"], led["dropped_stale"],
            led["evicted_capacity"], n) == (3, 8, 2, 1)


def test_downweight_mode_weights_by_lag_inside_window():
    def run(ro, buf_cls):
        buf = buf_cls()
        buf.add([_ro(ro, i, version=5 - k) for i, k in enumerate(range(4))])
        out = buf.drain(5, max_policy_lag=2, mode="downweight",
                        stale_gamma=0.5)
        return [w for _, w in out], buf.ledger.as_dict()
    (w, led), (jw, jled) = _both(run)
    assert w == jw == [1.0, 0.5, 0.25]
    assert led == jled
    assert led["dropped_stale"] == 1 and led["downweighted"] == 2


def test_future_version_rollout_is_a_bug_not_a_drop():
    buf = RolloutBuffer()
    buf.add([_ro(Rollout, 1, version=7)])
    with pytest.raises(ValueError, match="FUTURE"):
        buf.drain(5, max_policy_lag=2)
    with pytest.raises(ValueError, match="unknown staleness mode"):
        buf.drain(9, max_policy_lag=2, mode="keep")


# -- GRPO ---------------------------------------------------------------------


def test_group_advantages_match_reference():
    rng = np.random.default_rng(0)
    rewards = rng.random(40).tolist() + [5.0, 5.0]
    groups = rng.integers(0, 6, size=40).tolist() + [9, 9]
    adv = G.group_advantages(rewards, groups)
    np.testing.assert_allclose(adv, jgrpo.group_advantages(rewards, groups),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(adv[-2:], [0.0, 0.0])   # zero variance
    sel = np.asarray(groups) == 0
    np.testing.assert_allclose(adv[sel].mean(), 0.0, atol=1e-6)
    np.testing.assert_allclose(adv[sel].std(), 1.0, atol=1e-6)


def test_toy_reward_matches_reference():
    vocab = 512
    assert G.toy_low_token_reward([0, 1], vocab) == 0.0
    assert G.toy_low_token_reward([2, 127], vocab) == 1.0
    assert G.toy_low_token_reward([2, 128], vocab) == 0.5
    assert G.toy_low_token_reward([], vocab) == 0.0
    rng = np.random.default_rng(1)
    for n in range(1, 12):
        toks = rng.integers(0, vocab, size=n).tolist()
        assert G.toy_low_token_reward(toks, vocab) == \
            jgrpo.toy_low_token_reward(toks, vocab)


@pytest.mark.parametrize("seq_len", [8, 5])
def test_render_example_matches_reference(seq_len):
    """The completion span only is masked; past seq_len truncates."""
    r = _ro(Rollout, 1, 0, toks=[10, 11, 12], prompt=[5, 6, 7])
    jr = _ro(jbuffer.Rollout, 1, 0, toks=[10, 11, 12], prompt=[5, 6, 7])
    ex = G.render_example(r, advantage=2.0, weight=0.5, seq_len=seq_len)
    jex = jgrpo.render_example(jr, advantage=2.0, weight=0.5,
                               seq_len=seq_len)
    for f in ("inp", "tgt", "mask", "adv"):
        np.testing.assert_array_equal(getattr(ex, f), getattr(jex, f))
    if seq_len == 8:
        np.testing.assert_array_equal(ex.inp, [5, 6, 7, 10, 11, 0, 0, 0])
        np.testing.assert_array_equal(ex.mask, [0, 0, 1, 1, 1, 0, 0, 0])


def test_grpo_model_rejects_families_without_logits():
    enc = registry.get_model(TCONFIGS["seamless-m4t-medium"].reduced(), "cpu")
    with pytest.raises(TypeError, match="logits"):
        G.GRPOModel(enc)
    for arch in ("mamba2-130m", "deepseek-moe-16b"):
        assert G.GRPOModel(registry.get_model(
            TCONFIGS[arch].reduced(), "cpu")).inner.logits is not None


@pytest.fixture(scope="module")
def lm():
    """repro's reduced internlm2-1.8b and the port's on its weights."""
    jcfg = JCONFIGS[ARCH].reduced()
    jm = jregistry.get_model(jcfg)
    jp = jax.jit(lambda k: jm.init(k)[0])(jax.random.PRNGKey(0))
    cfg = TCONFIGS[ARCH].reduced()
    return dict(jcfg=jcfg, jm=jm, jp=jp, cfg=cfg,
                model=registry.get_model(cfg, "cpu"),
                params=from_jax_params(jax.tree.map(np.asarray, jp), "cpu"))


def _grpo_batch(seed=3):
    rng = np.random.default_rng(seed)
    mask = np.ones((2, 12), np.float32)
    mask[0, :4] = 0.0
    return {"tokens": rng.integers(2, 100, (2, 12)).astype(np.int32),
            "targets": rng.integers(2, 100, (2, 12)).astype(np.int32),
            "mask": mask,
            "adv": rng.normal(size=(2, 12)).astype(np.float32) * mask}


def test_grpo_loss_and_gradient_match_reference(lm):
    """On converted params: loss, metrics and every gradient within
    1e-5 of repro's; one SGD step on an all-positive advantage raises
    the mean log-prob, as in repro's test."""
    batch = _grpo_batch()
    jgm = jgrpo.GRPOModel(lm["jm"])
    (jl, jmet), jg = jax.value_and_grad(jgm.loss, has_aux=True)(
        lm["jp"], jax.tree.map(jnp.asarray, batch))
    gm = G.GRPOModel(lm["model"])
    tp = from_jax_params(jax.tree.map(np.asarray, lm["jp"]), "cpu")
    for t in leaves(tp):
        t.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, met = gm.loss(tp, tb)
    loss.backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(jl), **tol)
    for k in ("loss", "mean_logp", "tokens"):
        np.testing.assert_allclose(met[k].item(), float(jmet[k]), **tol)
    flat = tck._flatten(tp)
    for path, g in jax.tree_util.tree_flatten_with_path(jg)[0]:
        key = tck._SEP.join(e.key for e in path)
        np.testing.assert_allclose(flat[key].grad.numpy(), np.asarray(g),
                                   **tol)
    tb["adv"] = torch.ones_like(tb["adv"])
    tb["mask"] = torch.ones_like(tb["mask"])
    for t in leaves(tp):
        t.grad = None
    loss, before = gm.loss(tp, tb)
    loss.backward()
    with torch.no_grad():
        stepped = tck.unflatten_like(tp, {k: v - 0.05 * v.grad
                                          for k, v in tck._flatten(tp).items()})
        _, after = gm.loss(stepped, tb)
    assert after["mean_logp"].item() > before["mean_logp"].item()


def test_grpo_batcher_cycles_pool_like_reference():
    """Starved: a zero fallback; after ingest, deterministic cycling over
    the pool; every stack equal to repro's batcher's."""
    b, jb = G.GRPOBatcher(seq_len=8, batch_per_worker=2), \
        jgrpo.GRPOBatcher(seq_len=8, batch_per_worker=2)
    out, jout = b(0, h=2, k=2), jb(0, h=2, k=2)
    assert b.starved_phases == jb.starved_phases == 1
    assert tuple(out["tokens"].shape) == (2, 2, 2, 8)
    assert float(out["adv"].sum()) == 0.0
    for key in out:
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(jout[key]))
    b.ingest([(_ro(Rollout, i, 0, toks=[10 + i]), 1.0, 1.0)
              for i in range(3)])
    jb.ingest([(_ro(jbuffer.Rollout, i, 0, toks=[10 + i]), 1.0, 1.0)
               for i in range(3)])
    for step in (1, 2):
        out, jout = b(step, h=1, k=2), jb(step, h=1, k=2)
        for key in out:
            np.testing.assert_array_equal(out[key].numpy(),
                                          np.asarray(jout[key]))
    assert b.starved_phases == 1
    toks = b(3, h=1, k=2)["tokens"].numpy().reshape(4, 8)
    np.testing.assert_array_equal(toks[0], toks[3])      # 4 draws, pool 3


# -- logprob capture ----------------------------------------------------------


def test_chosen_logprob_matches_reference():
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(5, 300)) * 3).astype(np.float32)
    toks = rng.integers(0, 300, size=5).astype(np.int32)
    temps = np.array([0.0, 1.0, 0.7, 1.5, 0.0], np.float32)
    got = tengine.chosen_logprob(torch.from_numpy(logits),
                                 torch.from_numpy(toks),
                                 torch.from_numpy(temps))
    want = jengine.chosen_logprob(jnp.asarray(logits), jnp.asarray(toks),
                                  jnp.asarray(temps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, size=n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("kind", ["continuous", "paged"])
def test_greedy_engine_logprobs_match_reference(lm, kind):
    """A capturing greedy engine: tokens equal to repro's, every captured
    logprob within 1e-4 of repro's, one per token."""
    prompts = _prompts(lm["cfg"].vocab, (3, 5, 4, 9, 6))
    kw = dict(batch_slots=2, max_len=32, capture_logprobs=True)
    if kind == "paged":
        kw["block_size"] = 8
    jeng = (jpaging.PagedEngine if kind == "paged"
            else jengine.ContinuousEngine)(lm["jm"], lm["jp"], **kw)
    teng = (PagedEngine if kind == "paged"
            else tengine.ContinuousEngine)(lm["model"], lm["params"], **kw)
    out = []
    for eng, req_cls in ((jeng, jengine.Request), (teng, tengine.Request)):
        reqs = [req_cls(rid=i, prompt=p, max_new_tokens=7)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        out.append(reqs)
    for j, t in zip(*out):
        assert t.out_tokens == j.out_tokens
        assert len(t.out_logprobs) == len(t.out_tokens)
        np.testing.assert_allclose(t.out_logprobs, j.out_logprobs,
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["continuous", "paged"])
def test_engine_logprob_capture_matches_uncaptured_tokens(lm, kind):
    """capture_logprobs does not change the temperature-1 stream, and
    every captured logprob is finite, <= 0 and 1:1 with out_tokens."""
    prompts = _prompts(lm["cfg"].vocab, (3, 5, 4))

    def run(capture):
        cls = PagedEngine if kind == "paged" else tengine.ContinuousEngine
        kw = {"block_size": 8} if kind == "paged" else {}
        eng = cls(lm["model"], lm["params"], batch_slots=2, max_len=32,
                  capture_logprobs=capture, seed=7, **kw)
        reqs = [tengine.Request(rid=i, prompt=p, max_new_tokens=6,
                                temperature=1.0)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        return reqs

    for a, b in zip(run(False), run(True)):
        assert a.out_tokens == b.out_tokens
        assert a.out_logprobs == []
        assert len(b.out_logprobs) == len(b.out_tokens)
        assert all(np.isfinite(lp) and lp <= 0.0 for lp in b.out_logprobs)


@pytest.mark.parametrize("kind", ["continuous", "paged"])
def test_capture_reads_each_chunk_back_in_one_transfer(lm, kind,
                                                       monkeypatch):
    """The captured log-probs come back with the token block: a
    capturing engine makes as many ``.cpu()`` reads as one that does
    not capture, and ``host_syncs`` counts every one of them."""
    prompts = _prompts(lm["cfg"].vocab, (3, 5, 4))
    reads = []
    cpu = torch.Tensor.cpu

    def counted(self, *a, **kw):
        reads[-1] += 1
        return cpu(self, *a, **kw)
    monkeypatch.setattr(torch.Tensor, "cpu", counted)

    def run(capture):
        cls = PagedEngine if kind == "paged" else tengine.ContinuousEngine
        kw = {"block_size": 8} if kind == "paged" else {}
        eng = cls(lm["model"], lm["params"], batch_slots=2, max_len=32,
                  capture_logprobs=capture, seed=7, **kw)
        reqs = [tengine.Request(rid=i, prompt=p, max_new_tokens=6,
                                temperature=1.0)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        reads.append(0)
        eng.run_until_drained()
        return eng.stats["host_syncs"], reqs

    (plain_syncs, plain), (syncs, captured) = run(False), run(True)
    assert reads[0] == reads[1] == plain_syncs == syncs
    for a, b in zip(plain, captured):
        assert a.out_tokens == b.out_tokens
        assert len(b.out_logprobs) == len(b.out_tokens)


def test_overlap_admission_captures_logprobs(lm):
    """The overlapped admission path captures too: the same tokens as
    serial batch-1 admission, logprobs within 1e-5 (a slot's decode row
    may share its product with other rows)."""
    prompts = _prompts(lm["cfg"].vocab, (3, 5, 4, 7, 2))

    def run(**kw):
        eng = tengine.ContinuousEngine(lm["model"], lm["params"],
                                       batch_slots=2, max_len=32,
                                       capture_logprobs=True, **kw)
        reqs = [tengine.Request(rid=i, prompt=p, max_new_tokens=5)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        return reqs
    for a, b in zip(run(overlap_admission=True), run(batch_admit=False)):
        assert a.out_tokens == b.out_tokens
        np.testing.assert_allclose(a.out_logprobs, b.out_logprobs,
                                   rtol=1e-5, atol=1e-5)


# -- publish -> pin -> adopt -> retire lifecycle ------------------------------


def _tree(rng, scale=1.0):
    return {"w": rng.normal(size=(64,)).astype(np.float32) * scale,
            "b": rng.normal(size=(7,)).astype(np.float32)}


def _t(tree):
    return tck.unflatten_like(tree, {k: tck.as_tensor(v) for k, v in
                                     tck._flatten(tree).items()})


def test_tree_sha_matches_reference():
    """The same tree hashes the same in both packages: fp32, bf16 and
    int leaves, nested."""
    rng = np.random.default_rng(0)
    tree = {"params": _tree(rng), "h": rng.normal(size=(3, 5)).astype(
        ml_dtypes.bfloat16), "n": np.arange(4, dtype=np.int32)}
    assert tree_sha(_t(tree)) == jpub.tree_sha(tree)
    other = _t(tree)
    other["params"]["w"][3] += 1e-6
    assert tree_sha(other) != jpub.tree_sha(tree)


@pytest.mark.parametrize("codec", ["int8", "int4"])
def test_published_chain_restores_bit_exact(tmp_path, codec):
    """Every version of the port's delta chain restores bit for bit to
    the publisher's recorded reconstruction; base versions are the raw
    tree (their sha equals repro's publisher's on the same tree)."""
    pub = PolicyPublisher(str(tmp_path / "pub"), codec=codec, base_every=4,
                          keep_live=16, device="cpu")
    jp = jpub.PolicyPublisher(str(tmp_path / "jpub"), codec=codec,
                              base_every=4, keep_live=16)
    rng = np.random.default_rng(0)
    trees, refs = [], []
    for v in range(6):
        t = _tree(rng)
        pub.publish(v, _t(t))
        jp.publish(v, t)
        trees.append(t)
        refs.append(pub.writer.reference(_t(t)))
    like = _t(trees[0])
    for v in range(6):
        got, meta = tdelta.restore(pub.store, like, step=v, device="cpu")
        assert tree_sha(got) == pub.shas[v], (codec, v)
        for k in like:
            assert torch.equal(got[k], refs[v][k])
        assert meta["policy_version"] == v
    for v in (0, 4):
        assert pub.shas[v] == jp.shas[v] == jpub.tree_sha(trees[v])
        for k in like:
            assert torch.equal(refs[v][k], torch.from_numpy(trees[v][k]))


def test_publisher_retention_respects_consumer_pins(tmp_path):
    pub = PolicyPublisher(str(tmp_path / "pub"), base_every=1, keep_live=32,
                          device="cpu")
    rng = np.random.default_rng(1)
    for v in range(4):
        pub.publish(v, _t(_tree(rng)))
    token = pub.store.pin_chain(0)          # consumer mid-stream on v0
    pub.retire(0)
    assert pub.store.load_manifest(0)["step"] == 0   # pinned: survives
    pub.store.unpin(token)
    pub.store.gc(keep_steps=tuple(pub.live_versions))
    with pytest.raises(FileNotFoundError):
        pub.store.load_manifest(0)          # pin gone: collected


def test_force_retire_refuses_to_sever_live_chains(tmp_path):
    pub = PolicyPublisher(str(tmp_path / "pub"), base_every=8, keep_live=32,
                          device="cpu")
    rng = np.random.default_rng(2)
    for v in range(3):
        pub.publish(v, _t(_tree(rng)))      # v0 base, v1/v2 deltas
    with pytest.raises(ValueError, match="chain link"):
        pub.retire(0, force=True)
    assert pub.safe_to_retire(2)            # chain tip: safe
    rec = pub.retire(2, force=True)
    assert rec["forced"] and pub.store.is_retired(2)


def test_keep_live_auto_retires_old_versions(tmp_path):
    pub = PolicyPublisher(str(tmp_path / "pub"), base_every=1, keep_live=2,
                          device="cpu")
    rng = np.random.default_rng(3)
    for v in range(5):
        rec = pub.publish(v, _t(_tree(rng)))
    assert pub.live_versions == rec["live"] == [3, 4]
    assert pub.retired == [0, 1, 2]


# -- worker adoption over the wire --------------------------------------------


@pytest.mark.parametrize("codec", ["int8", "int4"])
def test_worker_adoption_bit_exact_over_wire(tmp_path, lm, codec):
    """Full adopt path: swarm fetch of the delta chain + replay + sha
    verification against the publisher's policy_sha op. The adopted
    params EQUAL the published reconstruction; rollouts are tagged with
    the adopted version."""
    params = lm["params"]
    pub = PolicyPublisher(str(tmp_path / "pub"), codec=codec, base_every=2,
                          keep_live=8, device="cpu")
    peer = pub.serve()
    try:
        pub.publish(0, {"params": params})
        bumped = {k: v + 1e-3 for k, v in tck._flatten(params).items()}
        bumped = tck.unflatten_like(params, bumped)
        pub.publish(1, {"params": bumped})
        w = RolloutWorker(0, lm["model"], params, str(tmp_path / "w0"),
                          max_len=32)
        rec = w.adopt([peer.addr])
        assert rec["version"] == 1 and rec["sha_verified"]
        assert w.adopted_sha == pub.shas[1]
        want = pub.writer.reference({"params": bumped})["params"]
        for a, b in zip(leaves(w.engine.params), leaves(want)):
            assert torch.equal(a, b)
        ros, _ = w.generate([np.asarray([5, 6, 7], np.int32)], max_new=4)
        assert ros[0].version == 1
        assert len(ros[0].logprobs) == len(ros[0].tokens)
    finally:
        peer.close()


@pytest.mark.parametrize("codec", ["int8", "int4"])
def test_worker_adopts_a_repro_published_chain(tmp_path, lm, codec):
    """Wire compatibility: the port's worker adopts a chain repro's
    publisher wrote, served by repro's PolicyPeer, and reproduces repro's
    recorded reconstruction sha (the apply is one fp32 add in both)."""
    jp = lm["jp"]
    pub = jpub.PolicyPublisher(str(tmp_path / "jpub"), codec=codec,
                               base_every=4, keep_live=8)
    peer = pub.serve()
    try:
        pub.publish(0, {"params": jp})
        for v in (1, 2):
            pub.publish(v, {"params": jax.tree.map(
                lambda p, v=v: p + 1e-3 * v, jp)})
        w = RolloutWorker(0, lm["model"], lm["params"],
                          str(tmp_path / "w0"), max_len=32)
        for v in (1, 2):
            rec = w.adopt([peer.addr], version=v)
            assert rec["sha_verified"] and rec["sha"] == pub.shas[v]
    finally:
        peer.close()


def test_adopting_force_retired_version_raises_typed(tmp_path, lm):
    params = lm["params"]
    pub = PolicyPublisher(str(tmp_path / "pub"), base_every=1, keep_live=8,
                          device="cpu")
    peer = pub.serve()
    try:
        pub.publish(0, {"params": params})
        pub.publish(1, {"params": params})
        pub.retire(0, force=True)
        w = RolloutWorker(0, lm["model"], params, str(tmp_path / "w0"),
                          max_len=32)
        with pytest.raises(PolicyRetiredError):
            w.adopt([peer.addr], version=0)
        assert w.adopt([peer.addr])["version"] == 1   # latest still fine
    finally:
        peer.close()


def test_rollout_paged_engine_grpo_dedup(tmp_path, lm):
    """engine='paged' worker: a GRPO group's k shared-prompt samples hit
    the content-addressed prefix index (k-1 prefills skipped), and a
    policy re-adoption flushes the now-stale prefix cache."""
    params = lm["params"]
    pub = PolicyPublisher(str(tmp_path / "pub"), codec="int8", base_every=2,
                          keep_live=8, device="cpu")
    peer = pub.serve()
    try:
        pub.publish(0, {"params": params})
        w = RolloutWorker(0, lm["model"], params, str(tmp_path / "w0"),
                          max_len=64, engine="paged", block_size=8)
        w.adopt([peer.addr])
        rng = np.random.default_rng(3)
        q = rng.integers(2, lm["cfg"].vocab, size=37).astype(np.int32)
        ros, _ = w.generate([q.copy() for _ in range(4)], groups=[0] * 4,
                            max_new=4)
        assert len(ros) == 4
        assert all(len(r.logprobs) == len(r.tokens) for r in ros)
        assert w.engine.perf_summary()["prefix_hits"] >= 3
        assert w.engine.stats["prefills"] == 1   # one per group
        assert w.engine.pool.used == 0
        pub.publish(1, {"params": tck.unflatten_like(params, {
            k: v + 1e-3 for k, v in tck._flatten(params).items()})})
        w.adopt([peer.addr])
        assert not w.engine.prefix.blocks
        assert not w.engine.prefix.tails
        w.generate([q.copy() for _ in range(2)], groups=[1, 1], max_new=2)
        assert w.engine.stats["prefills"] == 2   # re-prefilled once
    finally:
        peer.close()


# -- end-to-end driver --------------------------------------------------------


CHURN = dict(outer_steps=4, inner_steps=2, n_groups=4, group_size=4,
             max_new=6, max_policy_lag=1, adopt_strides=(1, 3), base_every=1,
             kill_at=1, rejoin_at=2, force_retire_at=3)
# summary keys that do not depend on the weights or the sampled tokens
COUNTS = ("outer_steps", "versions_published", "ledger",
          "stale_drop_fraction", "mean_accepted_lag", "adoptions",
          "bit_exact", "retired_fallbacks", "live_versions",
          "starved_phases")
WALL = ("rollout_tok_s", "mean_adopt_s")


def _port_driver(tmp_path, **kw):
    from repro_torch.rl import RLConfig, RLDriver
    cfg = RLConfig(device="cpu", **CHURN, **kw)
    drv = RLDriver(cfg, tmp_path)
    try:
        return cfg, drv, drv.run()
    finally:
        drv.close()


@pytest.fixture(scope="module")
def repro_churn(tmp_path_factory):
    from repro.rl import RLConfig, RLDriver
    drv = RLDriver(RLConfig(**CHURN), tmp_path_factory.mktemp("jrl"))
    try:
        return drv.run()
    finally:
        drv.close()


@pytest.mark.parametrize("engines", [("continuous",),
                                     ("continuous", "paged")])
def test_driver_end_to_end_with_churn(tmp_path, repro_churn, engines):
    """Trainer + 2 staggered workers, one killed and rejoined mid-run,
    one old version force-retired: every adoption bit-exact, the ledger
    exact, nothing outside the staleness window trains; the
    weight-independent counts equal repro's driver's; a second port run
    reproduces the whole summary bar its wall-clock rates."""
    cfg, drv, s = _port_driver(tmp_path / "a", engines=engines)
    led = s["ledger"]
    assert s["bit_exact"]
    assert led["max_accepted_lag"] <= cfg.max_policy_lag
    assert led["generated"] == led["accepted"] + led["dropped_stale"] \
        + led["evicted_capacity"] + len(drv.buffer)
    assert s["versions_published"] == cfg.outer_steps + 1
    assert s["retired_fallbacks"] == 1
    assert len(s["reward_trend"]) == cfg.outer_steps
    assert all(np.isfinite(r) for r in s["reward_trend"] + s["loss_trend"])
    churned = [r["churn"] for r in drv.step_recs]
    assert churned[1].get("killed") == cfg.kill_worker
    assert churned[2].get("rejoined") == cfg.kill_worker
    w1 = [st for r in drv.step_recs for st in r["rollout"]["workers"]
          if st["worker"] == cfg.kill_worker]
    assert len(w1) == cfg.outer_steps - 1
    for key in COUNTS:
        assert s[key] == repro_churn[key], key
    _, _, again = _port_driver(tmp_path / "b", engines=engines)
    assert {k: v for k, v in again.items() if k not in WALL} == \
        {k: v for k, v in s.items() if k not in WALL}


def test_driver_paged_worker_dedups_groups(tmp_path):
    """With worker 1 paged, each GRPO group it serves prefills once."""
    cfg, drv, s = _port_driver(tmp_path, engines=("continuous", "paged"))
    eng = drv.workers[1].engine
    assert isinstance(eng, PagedEngine)
    assert eng.stats["prefix_hits"] > 0
    assert eng.stats["prefills"] < eng.stats["admitted"]


def test_launch_rl_on_cpu(tmp_path, capsys):
    from repro_torch.launch import rl
    s = rl.main(["--device", "cpu", "--outer-steps", "2", "--inner-steps",
                 "1", "--groups", "2", "--group-size", "2", "--max-new", "4",
                 "--root", str(tmp_path)])
    out = capsys.readouterr().out
    assert s["bit_exact"] and "bit_identical_to_publisher=True" in out
    assert s["versions_published"] == 3
    assert "staleness generated=" in out
