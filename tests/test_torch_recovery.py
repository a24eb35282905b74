"""repro_torch's live recovery (P2P, swarm fetch, gossip, the streaming
join) and its trainer's checkpoints against repro's, on the CPU.

Wire compatibility is checked both ways: a port peer is fetched by
repro's fetchers and a repro peer by the port's. The reference's swarm
and fault-injection cases run on port peers. The trainers (reduced
INTELLECT-1, fp32, the same parameters and batches in both packages)
must write the same kinds of manifest at the same steps, persist the
same steps, keep the same steps under retention and admit a stream join
at the same outer step; losses within rtol 1e-4 (fp32 forward and
backward in two frameworks, as ``test_torch_train.py``). A chain is
restored bitwise (one fp32 add per element, the same bits in both).
"""
import dataclasses
import random
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro import checkpointing as jcp
from repro.checkpointing import delta as jdelta
from repro_torch import checkpointing as tcp
from repro_torch.checkpointing import checkpoint as tck
from repro_torch.checkpointing import delta as tdelta
from repro_torch.checkpointing.swarm import _schedule_ranges
from test_torch_checkpoint import _assert_bitwise, _chain_trees, _t

torch.set_float32_matmul_precision("highest")
torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)


def _port_chain(root, steps=4, n=20_000, chunk_bytes=1 << 12):
    trees = _chain_trees(seed=5, n=n, steps=steps)
    store = tcp.ChunkStore(root, chunk_bytes=chunk_bytes)
    w = tcp.DeltaCheckpointer(store, tcp.DeltaConfig(base_every=8),
                              device="cpu")
    for t, tree in enumerate(trees):
        w.save(t, _t(tree), {"outer_step": t})
    return store, w, trees


def _repro_chain(root, steps=4, n=20_000, chunk_bytes=1 << 12):
    trees = _chain_trees(seed=5, n=n, steps=steps)
    store = jcp.ChunkStore(root, chunk_bytes=chunk_bytes)
    w = jcp.DeltaCheckpointer(store, jcp.DeltaConfig(base_every=8))
    for t, tree in enumerate(trees):
        w.save(t, tree, {"outer_step": t})
    return store, w, trees


def _restore(root, like):
    return tdelta.restore(tcp.ChunkStore(root), _t(like), device="cpu")


# -- wire compatibility ---------------------------------------------------------


@pytest.mark.parametrize("server", ["port", "repro"])
def test_swarm_wire_compatible_both_ways(tmp_path, server):
    """A chunk peer of one package serves the other's gossip and swarm
    fetch; the fetched chain restores bitwise to the writer's
    reconstruction."""
    if server == "port":
        src, w, trees = _port_chain(tmp_path / "src")
        peer, fetch, gossip = tcp.ChunkPeer(src), jcp.swarm_fetch, \
            jcp.ChunkGossip
        want = w.reference(_t(trees[-1]))
    else:
        src, w, trees = _repro_chain(tmp_path / "src")
        peer, fetch, gossip = jcp.ChunkPeer(src), tcp.swarm_fetch, \
            tcp.ChunkGossip
        want = _t(w.reference(trees[-1]))
    try:
        g = gossip([peer.addr])
        g.poll_once()
        assert g.possession[peer.addr] == frozenset(src.inventory())
        assert g.latest_step() == 3
        stats = fetch([peer.addr], tmp_path / "dst", range_chunks=3,
                      possession=g.possession)
        assert stats["step"] == 3 and stats["chunks_fetched"] == len(
            src.inventory())
    finally:
        peer.close()
    if server == "port":
        got, _ = jdelta.restore(jcp.ChunkStore(tmp_path / "dst"), trees[-1])
        _assert_bitwise(want, got)
    else:
        got, _ = _restore(tmp_path / "dst", trees[-1])
        for a, b in zip(tck._flatten(got).values(),
                        tck._flatten(want).values()):
            assert torch.equal(a, b)


@pytest.mark.parametrize("server", ["port", "repro"])
def test_flat_server_wire_compatible_both_ways(tmp_path, server):
    tree = _chain_trees(n=3_000, steps=1)[0]
    if server == "port":
        tcp.save(tmp_path / "src", 4, _t(tree), {"outer_step": 2})
        srv, fetch = tcp.CheckpointServer(tmp_path / "src"), \
            jcp.fetch_checkpoint
    else:
        jcp.save(tmp_path / "src", 4, tree, {"outer_step": 2})
        srv, fetch = jcp.CheckpointServer(tmp_path / "src"), \
            tcp.fetch_checkpoint
    try:
        path = fetch(("127.0.0.1", srv.port), tmp_path / "dst")
    finally:
        srv.close()
    assert path.name == "step_00000004"
    got, meta = tcp.restore(tmp_path / "dst", _t(tree))
    assert meta == {"outer_step": 2}
    _assert_bitwise(got, tree)


def test_fetch_errors_are_typed(tmp_path):
    srv = tcp.CheckpointServer(tmp_path / "empty")
    try:
        with pytest.raises(tcp.EmptyPeerError):
            tcp.fetch_checkpoint(("127.0.0.1", srv.port), tmp_path / "d")
    finally:
        srv.close()
    with pytest.raises(tcp.NoPeersError):
        tcp.swarm_fetch([("127.0.0.1", 1)], tmp_path / "dst")
    peer = tcp.ChunkPeer(tcp.ChunkStore(tmp_path / "e2"))
    try:
        with pytest.raises(tcp.NoPeersError):
            tcp.swarm_fetch([peer.addr], tmp_path / "dst")
    finally:
        peer.close()


# -- swarm fetch and faults on port peers ---------------------------------------


def _peers(store, *knobs):
    return [tcp.ChunkPeer(store, **k) for k in knobs]


@pytest.mark.parametrize("case", ["striped", "crash", "stall", "corrupt"])
def test_swarm_fetch_faults(tmp_path, case):
    src, w, trees = _port_chain(tmp_path / "src")
    knobs = {"striped": [{}, {}, {}, {}],
             "crash": [{"crash_after": 1}, {}],
             "stall": [{"stall_chunks": 0, "stall_s": 0.01}, {}],
             "corrupt": [{"corrupt_after": 0}, {}]}[case]
    peers = _peers(src, *knobs)
    try:
        stats = tcp.swarm_fetch([p.addr for p in peers], tmp_path / "dst",
                                range_chunks=2)
    finally:
        for p in peers:
            p.close()
    assert stats["chunks_fetched"] == len(src.inventory())
    if case == "striped":
        assert stats["dead_peers"] == [] and \
            sum(v > 0 for v in stats["per_peer"].values()) >= 2
    elif case in ("crash", "corrupt"):
        assert len(stats["dead_peers"]) == 1
        assert stats["reassigned_ranges"] >= 1
    got, _ = _restore(tmp_path / "dst", trees[-1])
    _assert_bitwise(got, _np_ref(w, trees[-1]))


def _np_ref(w, like):
    ref = w.reference(_t(like))
    from test_torch_checkpoint import _np
    return tck.unflatten_like(ref, {k: _np(v) for k, v in
                                    tck._flatten(ref).items()})


def test_swarm_all_dead_and_no_holder_fail_typed(tmp_path):
    src, _, _ = _port_chain(tmp_path / "src")
    crasher = tcp.ChunkPeer(src, crash_after=0)
    try:
        with pytest.raises(tcp.SwarmFetchError) as ei:
            tcp.swarm_fetch([crasher.addr], tmp_path / "dst")
        assert ei.value.failures
    finally:
        crasher.close()
    ids = src.inventory()
    partial = tcp.ChunkStore(tmp_path / "partial", chunk_bytes=src.chunk_bytes)
    for d in ids[: len(ids) // 2]:
        partial.put_blob(d, src.get_blob(d))
    for s in src.steps():
        partial.write_manifest(src.load_manifest(s))
    peer = tcp.ChunkPeer(partial)
    try:
        g = tcp.ChunkGossip([peer.addr])
        g.poll_once()
        with pytest.raises(tcp.SwarmFetchError):
            tcp.swarm_fetch([peer.addr], tmp_path / "dst2",
                            possession=g.possession, range_chunks=3,
                            timeout=5.0)
    finally:
        peer.close()


def test_schedule_ranges_equal_repro_and_rarest_first():
    from repro.checkpointing.swarm import _schedule_ranges as j_schedule
    rng = random.Random(3)
    ids = [f"c{i}" for i in range(40)]
    holders = {d: frozenset(rng.sample("ABCD", rng.randint(1, 4)))
               for d in ids}

    def candidates(batch):
        out = set("ABCD")
        for d in batch:
            out &= holders[d]
        return out
    for aware in (True, False):
        for rc in (1, 3, 8):
            assert _schedule_ranges(ids, candidates, rc, aware) == \
                j_schedule(ids, candidates, rc, aware)
    ranges = _schedule_ranges(ids, candidates, 2, True)
    order = [len(candidates(r)) for r in ranges]
    assert order == sorted(order)


def test_rejoining_node_fetches_only_what_changed(tmp_path):
    src, w, trees = _port_chain(tmp_path / "src", steps=2)
    peer = tcp.ChunkPeer(src)
    try:
        dst = tcp.ChunkStore(tmp_path / "dst", chunk_bytes=src.chunk_bytes)
        s0 = tcp.swarm_fetch([peer.addr], dst, step=0)
        s1 = tcp.swarm_fetch([peer.addr], dst)
        assert 0 < s1["chunks_fetched"] < s0["chunks_fetched"]
        assert tcp.swarm_fetch([peer.addr], dst)["chunks_fetched"] == 0
    finally:
        peer.close()
    got, _ = _restore(tmp_path / "dst", trees[-1])
    _assert_bitwise(got, _np_ref(w, trees[-1]))


def test_gossip_digests_expiry_and_recovery(tmp_path):
    stores = {("h", 1): tcp.ChunkStore(tmp_path / "a"),
              ("h", 2): tcp.ChunkStore(tmp_path / "b")}
    stores[("h", 1)].put(b"x" * 100)
    g = tcp.ChunkGossip(list(stores), transport=tcp.store_transport(stores),
                        expire_polls=2)
    g.poll_once()
    g.poll_once()
    assert g.stats["digests"] == 4 and g.stats["inventories"] == 2
    assert len(g.possession[("h", 1)]) == 1
    stores[("h", 2)].put(b"y" * 100)
    g.poll_once()
    assert g.stats["inventories"] == 3
    dead = stores.pop(("h", 1))
    g.poll_once()
    assert ("h", 1) in g.possession            # one miss: still believed
    g.poll_once()
    assert ("h", 1) not in g.possession and g.stats["expired"] == 1
    stores[("h", 1)] = dead
    g.poll_once()
    assert ("h", 1) in g.possession
    g.remove_peer(("h", 2))
    assert g.peers() == [("h", 1)]


def test_streamed_restore_equals_one_shot_restore(tmp_path):
    src, w, trees = _port_chain(tmp_path / "src", steps=5)
    peers = _peers(src, {"crash_after": 3}, {}, {"stall_chunks": 0,
                                                 "stall_s": 0.002})
    try:
        f = tcp.StreamingFetcher([p.addr for p in peers], tmp_path / "dst",
                                 _t(trees[-1]), range_chunks=2,
                                 device="cpu").start()
        stats = f.wait_ready(timeout=60)
        tree, meta, _ = f.result()
        f.close()
    finally:
        for p in peers:
            p.close()
    assert meta == {"outer_step": 4} and stats["step"] == 4
    assert stats["replayed_on_stream"] == stats["replayed_steps"] == 5
    one_shot, _ = tdelta.restore(src, _t(trees[-1]), device="cpu")
    for a, b in zip(tck._flatten(tree).values(),
                    tck._flatten(one_shot).values()):
        assert torch.equal(a, b)


def test_streaming_fetcher_honors_its_budget(tmp_path):
    f = tcp.StreamingFetcher([("127.0.0.1", 1)], tmp_path / "dst",
                             {"w": torch.zeros(3)}, max_rounds=50,
                             round_wait=0.05, max_elapsed_s=0.3,
                             device="cpu").start()
    with pytest.raises((tcp.RetryDeadlineError, tcp.NoPeersError)):
        f.wait_ready(timeout=10)
    f.close()


def test_retry_call_schedule_deadline_and_carve_out():
    sleeps = []

    class Rng:
        def random(self):
            return 0.5

    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise tcp.PeerClosedError("x")
        return "ok"
    pol = tcp.RetryPolicy(attempts=4, base_delay=0.1, jitter=0.5)
    assert tcp.retry_call(flaky, policy=pol, sleep=sleeps.append,
                          rng=Rng()) == "ok"
    assert sleeps == [0.1 * 1.25, 0.2 * 1.25]
    with pytest.raises(tcp.EmptyPeerError):
        tcp.retry_call(lambda: (_ for _ in ()).throw(
            tcp.EmptyPeerError("e")), policy=pol, sleep=sleeps.append)
    t = [0.0]
    with pytest.raises(tcp.RetryDeadlineError):
        tcp.retry_call(lambda: (_ for _ in ()).throw(OSError("o")),
                       policy=tcp.RetryPolicy(attempts=10, base_delay=1.0,
                                              max_elapsed_s=2.5),
                       sleep=lambda d: t.__setitem__(0, t[0] + d),
                       clock=lambda: t[0], rng=Rng())


def test_pool_reuses_and_discards(tmp_path):
    src, _, _ = _port_chain(tmp_path / "src", steps=1, n=2_000)
    peer = tcp.ChunkPeer(src)
    pool = tcp.PeerConnPool(timeout=5.0, max_idle_per_peer=1)
    try:
        send = tcp.socket_transport(pool=pool)
        for _ in range(3):
            assert send(peer.addr, {"op": "digest"})["latest"] == 0
        assert pool.stats["created"] == 1 and pool.stats["reused"] == 2
        tcp.swarm_fetch([peer.addr], tmp_path / "dst", pool=pool)
        assert pool.idle_count(peer.addr) == 1
    finally:
        pool.close()
        peer.close()


# -- the trainers ----------------------------------------------------------------

H, OUTER, SEQ, BATCH, ARCH = 2, 3, 16, 2, "intellect-1"


def _trainers(tmp_path, **ckpt):
    from repro.configs import CONFIGS as JCONFIGS
    from repro.core import diloco as jdl
    from repro.core import fault_tolerance as jft
    from repro.data.pipeline import DataConfig as JDataConfig
    from repro.models.registry import get_model as jget_model
    from repro.train.loop import ElasticTrainer as JTrainer
    from repro.train.loop import TrainerConfig as JTrainerConfig
    from repro_torch.configs import CONFIGS as TCONFIGS
    from repro_torch.convert import from_jax_params
    from repro_torch.core import diloco as tdl
    from repro_torch.core import fault_tolerance as tft
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.registry import get_model as tget_model
    from repro_torch.train.loop import ElasticTrainer as TTrainer
    from repro_torch.train.loop import TrainerConfig as TTrainerConfig
    from test_torch_train import _provider

    jcfg = JCONFIGS[ARCH].reduced()
    jm = jget_model(jcfg)
    params, _ = jm.init(jax.random.PRNGKey(0))
    dcfg = JDataConfig(vocab=jcfg.vocab, seq_len=SEQ,
                       batch_per_worker=BATCH, total_steps=2 * OUTER * H)
    provide = _provider(dcfg, 2)
    out = {}
    for name in ("j", "t"):
        kw = dict(ckpt)
        if "ckpt_dir" in kw:
            kw["ckpt_dir"] = str(tmp_path / name / kw["ckpt_dir"])
        if name == "j":
            out[name] = JTrainer(
                jm, JTrainerConfig(jdl.DiLoCoConfig(inner_steps=H,
                                                    quant="fp32"),
                                   inner_lr=3e-3, max_workers=2, **kw),
                dcfg, params, jft.ClusterSimulator(range(2)),
                batch_provider=provide)
        else:
            out[name] = TTrainer(
                tget_model(TCONFIGS[ARCH].reduced(), "cpu"),
                TTrainerConfig(tdl.DiLoCoConfig(inner_steps=H, quant="fp32"),
                               inner_lr=3e-3, max_workers=2, **kw),
                DataConfig(vocab=jcfg.vocab, seq_len=SEQ,
                           batch_per_worker=BATCH),
                from_jax_params(jax.tree.map(np.asarray, params), "cpu"),
                tft.ClusterSimulator(range(2)), batch_provider=provide)
    return out["j"], out["t"]


def _equal_trees(got, want):
    g, w = tck._flatten(got), tck._flatten(want)
    assert list(g) == list(w)
    for k in w:
        assert torch.equal(g[k], w[k]), k


def _wait_flat(root, step):
    for _ in range(500):
        if tcp.latest_step(root) == step:
            return
        time.sleep(0.01)
    raise AssertionError(f"no flat checkpoint {step} under {root}")


@pytest.mark.parametrize("engine", ["flat", "store", "delta"])
def test_trainer_checkpoints_match_repro(tmp_path, engine):
    kw = {"ckpt_dir": "ck", "ckpt_engine": engine}
    if engine != "flat":
        kw.update(ckpt_delta_base_every=2, ckpt_keep=2,
                  ckpt_chunk_bytes=1 << 14)
    jt, tt = _trainers(tmp_path, **kw)
    jh, th = jt.run(OUTER), tt.run(OUTER)
    for a, b in zip(th, jh):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
    like = tt.checkpoint_like()
    if engine == "flat":
        for name in ("j", "t"):
            _wait_flat(tmp_path / name / "ck", OUTER * H)
        steps = [sorted(p.name for p in (tmp_path / n / "ck").iterdir())
                 for n in ("j", "t")]
        assert steps[0] == steps[1] == [f"step_{(t + 1) * H:08d}"
                                        for t in range(OUTER)]
        got, meta = tcp.restore(tmp_path / "t" / "ck", like)
        assert meta == {"outer_step": OUTER}
        _equal_trees(got, like)
        return
    assert tt.persisted_steps == jt.persisted_steps == \
        [(t + 1) * H for t in range(OUTER)]
    kinds = [[s.load_manifest(m)["kind"] for m in s.steps()]
             for s in (jt.ckpt_store, tt.ckpt_store)]
    assert tt.ckpt_store.steps() == jt.ckpt_store.steps()
    assert kinds[0] == kinds[1]
    if engine == "delta":
        assert kinds[1] == ["base", "delta", "base"][-len(kinds[1]):]
    got, meta = tt.ckpt_store.restore_tree(like, device="cpu")
    assert meta == {"outer_step": OUTER}
    _equal_trees(got, tt.ckpt_writer.reference(like) if engine == "delta"
                 else like)
    tt.close()
    jt.close()


def test_trainer_stream_join_matches_repro(tmp_path):
    """Writers of both packages checkpoint (delta engine) and serve;
    a joiner of each streams its package's checkpoint, and a port
    joiner also streams repro's. Each is admitted at its first outer
    boundary with the writer's step, and adopts the writer's
    reconstruction bit for bit."""
    jw, tw = _trainers(tmp_path, ckpt_dir="ck", ckpt_engine="delta",
                       ckpt_chunk_bytes=1 << 14)
    jw.run(OUTER)
    tw.run(OUTER)
    jpeer, tpeer = jw.serve_checkpoints(), tw.serve_checkpoints()
    try:
        jj, tj = _trainers(tmp_path / "joiners")
        _, tj2 = _trainers(tmp_path / "joiners2")
        fj = jj.begin_stream_join([jpeer.addr], store_root=tmp_path / "jj")
        ft = tj.begin_stream_join([tpeer.addr], store_root=tmp_path / "tj")
        ft2 = tj2.begin_stream_join([jpeer.addr],
                                    store_root=tmp_path / "tj2")
        for f in (fj, ft, ft2):
            f.wait_ready(timeout=60)
        hj, ht, ht2 = jj.run(1), tj.run(1), tj2.run(1)
    finally:
        jpeer.close()
        tpeer.close()
    recs = [h[0]["stream_join"] for h in (hj, ht, ht2)]
    assert all(r["admitted"] for r in recs)
    assert [r["step"] for r in recs] == [OUTER * H] * 3
    assert [r["outer_step"] for r in recs] == [OUTER] * 3
    np.testing.assert_allclose(ht[0]["loss"], hj[0]["loss"], rtol=1e-4)
    from repro_torch.core.sync_engine import SyncEngine
    twant = tw.ckpt_writer.reference(tw.checkpoint_like())
    assert torch.equal(tj.outer.anchor_flat, SyncEngine.for_tree(
        twant["anchor"]).flatten(twant["anchor"]))
    jref = jax.tree.map(np.asarray,
                        jw.snapshotter.write_fn.__self__.reference(
                            jax.tree.map(np.asarray, jw.checkpoint_like())))
    _assert_bitwise(ft2.result()[0], jref)
    assert tj2.outer.outer_step == OUTER == tj.outer.outer_step
