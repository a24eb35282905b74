"""The port's distributed outer sync (``repro_torch.train.step``: a ring
of gloo rank processes, one wire hop per command) on the CPU, against
the port's stacked simulator bit for bit and against ``repro``'s
simulator within the ring tolerance of ``tests/test_torch_ring.py``
(int8: within 1e-5 but for rare codes flipped at a bucket edge, each
within one bucket width per quantization passed).

The cases are the reference's (``tests/test_distributed.py``): the
per-hop ring op (plain, fused first hop, a non-identity order, partial
weights, a restart after two hops), the hierarchical (4, 2) ring
against the per-slice simulator, and the trainer with the delayed
overlap, error feedback and a crash that tears the sync in flight, on
the reference's reduced mamba2-130m and on the reduced INTELLECT-1 (the
simulated trainer is held against ``repro``'s in
``tests/test_torch_elastic.py``). Codec calls, summed
over the ranks, equal k x ``codec_calls`` per reduction. The mesh
bookkeeping is held against ``repro``'s, which needs forced host
devices, in a subprocess. One rank pool per mesh shape per module.
"""
import dataclasses
import json
import os
import pathlib
import signal
import subprocess
import sys
import textwrap
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ring_reduce as jrr
from repro_torch.configs import get_config
from repro_torch.core import diloco as tdl
from repro_torch.core import elastic_mesh as tem
from repro_torch.core import fault_tolerance as tft
from repro_torch.core import ring_reduce as trr
from repro_torch.core.rank_mesh import RankFailure
from repro_torch.core.sync_engine import leaves
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models.registry import get_model
from repro_torch.sharding import partition
from repro_torch.train import step as ts
from repro_torch.train.loop import ElasticTrainer, TrainerConfig
from test_torch_ring import check_ring_close, int8_bound

torch.set_float32_matmul_precision("highest")
torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

_SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
K, SIZE, ORDER = 4, 37, (2, 0, 3, 1)
CFG = trr.RingConfig(quant="int8", buckets=3)
W = np.asarray([1.0, 0.0, 1.0, 1.0], np.float32)


@pytest.fixture(scope="module")
def mesh4():
    with make_host_mesh(K, device="cpu") as mesh:
        yield mesh


@pytest.fixture(scope="module")
def mesh42():
    with make_mesh((K, 2), ("data", "model"), device="cpu") as mesh:
        yield mesh


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _against_repro(got, xs, weights, fused=None):
    """``got`` within the ring tolerance of ``repro``'s simulator."""
    want = jrr.simulate_ring_all_reduce(
        jnp.asarray(xs), cfg=jrr.RingConfig(quant="int8", buckets=3),
        ring_order=ORDER, weights=jnp.asarray(weights),
        fused_src=None if fused is None else tuple(map(jnp.asarray, fused)))
    check_ring_close(got.numpy(), np.asarray(want), "int8",
                     int8_bound(xs, weights, K))


def _calls_per_rank(rec, fused, hops=None, cfg=CFG):
    """Codec calls summed over the ranks of one reduction equal the
    rank count times the geometry's ``codec_calls``."""
    want = trr.codec_calls(K, cfg, fused, hops=hops)
    return rec["calls"] == {n: rec["ranks"] * c for n, c in want.items()}


def test_dist_ring_op_bit_matches_sim_op(mesh4):
    """The per-hop distributed ring equals the simulator bit for bit:
    plain, fused first hop, non-identity order, partial weights, and the
    torn-reduction restart. Each rank makes ``codec_calls`` codec calls
    per reduction (the torn ring's two hops counted apart)."""
    rng = np.random.default_rng(0)
    pr = ts.DistSyncPrograms(mesh4, "data", SIZE, CFG, ring_order=ORDER)
    a = rng.normal(size=(SIZE,)).astype(np.float32)
    thetas = rng.normal(size=(K, SIZE)).astype(np.float32)
    pgs = a[None] - thetas
    w = _t(W)
    # plain
    ref = trr.simulate_ring_all_reduce(_t(pgs), ORDER, CFG, w)
    op = ts.DistRingSyncOp(pr, _t(pgs), weights=w)
    hops = 0
    while op.step():
        hops += 1
    assert hops == op.hops_total == 2 * (K - 1)
    got = op.finish()
    assert torch.equal(ref, got)
    _against_repro(got, pgs, W)
    assert _calls_per_rank(pr.log[-1], fused=False)
    assert pr.log[-1]["ranks"] == K and len(pr.log[-1]["hop_times"]) == hops
    # fused first-hop transmit
    fused = (_t(a), _t(thetas))
    ref2 = trr.simulate_ring_all_reduce(_t(pgs), ORDER, CFG, w, fused)
    got2 = ts.DistRingSyncOp(pr, _t(pgs), weights=w,
                             fused_src=fused).finish()
    assert torch.equal(ref2, got2)
    _against_repro(got2, pgs, W, (a, thetas))
    assert _calls_per_rank(pr.log[-1], fused=True)
    # restart (torn reduction): re-reduce the retained inputs over the
    # survivors, the mid-flight state discarded
    op3 = ts.DistRingSyncOp(pr, _t(pgs), weights=w, fused_src=fused)
    op3.step()
    op3.step()
    w2 = np.asarray([1.0, 0.0, 1.0, 0.0], np.float32)
    ref3 = trr.simulate_ring_all_reduce(_t(pgs), ORDER, CFG, _t(w2), fused)
    got3 = op3.restart(_t(w2))
    assert torch.equal(ref3, got3)
    _against_repro(got3, pgs, w2, (a, thetas))
    torn, again = pr.log[-2:]
    assert torn["hops"] == 2 and _calls_per_rank(torn, True, hops=2)
    assert again["hops"] == 6 and _calls_per_rank(again, True)


def test_step_returns_without_waiting(mesh4):
    """``step()`` sends a hop and returns: with one rank stopped, no hop
    can complete, yet every ``step()`` returns at once; once the rank
    runs again, ``finish()`` gives the simulator's result."""
    rng = np.random.default_rng(2)
    xs = _t(rng.normal(size=(K, SIZE)).astype(np.float32))
    pr = ts.DistSyncPrograms(mesh4, "data", SIZE, CFG, ring_order=ORDER)
    op = ts.DistRingSyncOp(pr, xs, weights=_t(W))
    pid = mesh4.pids[1]
    os.kill(pid, signal.SIGSTOP)
    try:
        t0 = time.monotonic()
        while op.step():
            pass
        sent_s = time.monotonic() - t0
    finally:
        os.kill(pid, signal.SIGCONT)
    assert op.hops_done == op.hops_total and sent_s < 2.0
    assert torch.equal(op.finish(), trr.simulate_ring_all_reduce(
        xs, ORDER, CFG, _t(W)))


def test_aborted_sync_is_dropped_on_the_ranks(mesh4):
    """Aborting a handle whose ring is in flight closes its op: the ranks
    run the hops already sent, record them (k x their codec calls) and
    forget the reduction; the op sends no further hop, and the same
    programs then reduce as the simulator does."""
    rng = np.random.default_rng(4)
    xs = _t(rng.normal(size=(K, SIZE)).astype(np.float32))
    pr = ts.DistSyncPrograms(mesh4, "data", SIZE, CFG, ring_order=ORDER)
    op = ts.DistRingSyncOp(pr, xs, weights=_t(W))
    h = tdl.OuterSyncHandle(op, tdl.DiLoCoConfig(), None, None, _t(W), K)
    assert h.step() and h.step()
    n_log = len(pr.log)
    h.abort()
    assert h.aborted and h.op is None
    assert len(pr.log) == n_log + 1 and pr.log[-1]["hops"] == 2
    assert _calls_per_rank(pr.log[-1], False, hops=2)
    assert mesh4.call(ts._rank_drop, op._id) == [None] * K
    assert not op.step() and op.hops_done == 2
    with pytest.raises(RuntimeError, match="closed"):
        op.finish()
    assert torch.equal(
        ts.DistRingSyncOp(pr, xs, weights=_t(W)).finish(),
        trr.simulate_ring_all_reduce(xs, ORDER, CFG, _t(W)))


def test_hierarchical_ring_matches_per_slice_sim(mesh42):
    """Hierarchical mode ((4, 2) mesh: WAN ring over 'data', intra-node
    split over 'model', the local group gloo) equals the PER-SLICE
    simulator: each 1/n_local slice ringed with its own codebooks, then
    concatenated."""
    hier = tem.hierarchy(mesh42, "data")
    assert hier.split and hier.n_local == 2
    rng = np.random.default_rng(1)
    pgs = rng.normal(size=(K, SIZE)).astype(np.float32)
    pr = ts.DistSyncPrograms(mesh42, "data", SIZE, CFG, ring_order=ORDER,
                             hierarchy=hier)
    out = ts.DistRingSyncOp(pr, _t(pgs), weights=_t(W)).finish()
    sl = pr.slice_len
    pad = np.pad(pgs, ((0, 0), (0, hier.n_local * sl - SIZE)))
    parts = [trr.simulate_ring_all_reduce(_t(pad[:, i * sl:(i + 1) * sl]),
                                          ORDER, CFG, _t(W))
             for i in range(hier.n_local)]
    assert torch.equal(torch.cat(parts, dim=1)[:, :SIZE], out)
    jparts = [jrr.simulate_ring_all_reduce(
        jnp.asarray(pad[:, i * sl:(i + 1) * sl]),
        cfg=jrr.RingConfig(quant="int8", buckets=3), ring_order=ORDER,
        weights=jnp.asarray(W)) for i in range(hier.n_local)]
    want = np.concatenate([np.asarray(p) for p in jparts], 1)[:, :SIZE]
    check_ring_close(out.numpy(), want, "int8", int8_bound(pgs, W, K))
    rec = pr.log[-1]
    assert rec["ranks"] == 2 * K and not rec["fused"]
    assert _calls_per_rank(rec, fused=False)
    # not hierarchical on the same mesh: each local rank rings a replica
    # of the whole row, which equals the flat simulator
    flat = ts.DistSyncPrograms(mesh42, "data", SIZE, CFG, ring_order=ORDER)
    assert torch.equal(
        ts.DistRingSyncOp(flat, _t(pgs), weights=_t(W)).finish(),
        trr.simulate_ring_all_reduce(_t(pgs), ORDER, CFG, _t(W)))


INNER, CHUNKS, STEPS = 5, 7, 4


def _trainer(backend=None, arch="intellect-1"):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    model = get_model(cfg, "cpu")
    tcfg = TrainerConfig(
        tdl.DiLoCoConfig(inner_steps=INNER, quant="int8",
                         overlap="delayed", error_feedback=True),
        inner_lr=3e-3, max_workers=K, inner_chunks=CHUNKS)
    events = [tft.NodeEvent(2, tft.EventKind.CRASH, 1)]
    return ElasticTrainer(
        model, tcfg, DataConfig(vocab=cfg.vocab, seq_len=32,
                                batch_per_worker=2,
                                total_steps=INNER * 32),
        model.init(0), tft.ClusterSimulator(list(range(K)), events=events),
        sync_backend=backend)


def _links(t):
    """Every link 10 Gb/s but 0-1 (crossed by the identity ring) from
    step 1 on: one reorder."""
    bw = np.full((K, K), 10.0)
    if t >= 1:
        bw[0, 1] = bw[1, 0] = 1.0
    np.fill_diagonal(bw, 0.0)
    return bw


@pytest.mark.parametrize("reorder", [False, True])
def test_dist_backend_trainer_bit_identical_to_sim(mesh4, reorder):
    """The acceptance test: an ElasticTrainer running overlap='delayed'
    with error feedback through DistSyncBackend (a 4-rank gloo mesh)
    equals the simulator trainer bit for bit over 4 outer steps,
    including a worker CRASHING mid-overlap at step 2, which takes the
    torn-reduction fallback on both paths. A stable ring is formed once;
    a reorder forms it once more."""
    sampler = _links if reorder else None
    t_dist, hist_dist, backend = _dist_equals_sim(mesh4, "intellect-1",
                                                  sampler)
    assert backend.recompiles == (2 if reorder else 1)
    assert t_dist.reorders == (1 if reorder else 0)
    # every reduction that ran: syncs begun and finished, the torn ring's
    # dispatched hops and its restart; EF is on, so no fused first hop
    fb = next(r["sync_fallback"] for r in hist_dist if "sync_fallback" in r)
    assert sorted(r["hops"] for r in backend.reductions) == sorted(
        [fb["hops_done"]] + [2 * (K - 1)] * STEPS)
    for rec in backend.reductions:
        assert rec["ranks"] == K and not rec["fused"]
        assert _calls_per_rank(rec, False, rec["hops"],
                               t_dist.cfg.diloco.ring)


def _dist_equals_sim(mesh, arch, sampler):
    """The simulated and the distributed trainer of ``arch`` over the
    same 4 outer steps: histories, losses, ring orders, parameters and
    anchor bitwise equal, the crash tearing the in-flight sync on both.
    Returns the distributed trainer, its history and its backend."""
    t_sim = _trainer(arch=arch)
    hist_sim = t_sim.run(STEPS, bandwidth_sampler=sampler)
    backend = ts.DistSyncBackend(mesh, "data")
    t_dist = _trainer(backend, arch=arch)
    hist_dist = t_dist.run(STEPS, bandwidth_sampler=sampler)
    torn = [("sync_fallback" in r) for r in hist_dist]
    assert torn == [("sync_fallback" in r) for r in hist_sim]
    assert any(torn), "crash at step 2 must tear the in-flight sync"
    for ls, ld in zip(leaves(t_sim.params), leaves(t_dist.params)):
        assert torch.equal(ls, ld)
    assert torch.equal(t_sim.outer.anchor_flat, t_dist.outer.anchor_flat)
    assert [r["loss"] for r in hist_dist] == [r["loss"] for r in hist_sim]
    assert [r["ring_order"] for r in hist_dist] == \
        [r["ring_order"] for r in hist_sim]
    return t_dist, hist_dist, backend


def test_dist_backend_trainer_mamba2_bit_identical_to_sim(mesh4):
    """The reference's own trainer case (``tests/test_distributed.py``):
    the reduced mamba2-130m, overlap='delayed' with error feedback, a
    worker crashing at step 2; the distributed trainer equals the
    simulated one bit for bit and forms its stable ring once."""
    t_dist, _, backend = _dist_equals_sim(mesh4, "mamba2-130m", None)
    assert backend.recompiles == 1
    assert t_dist.reorders == 0
    for rec in backend.reductions:
        assert rec["ranks"] == K and not rec["fused"]
        assert _calls_per_rank(rec, False, rec["hops"],
                               t_dist.cfg.diloco.ring)


def _repro_bookkeeping() -> dict:
    """``repro``'s ElasticDeviceMesh on a (4, 2) and a (2, 2) mesh of
    forced host devices, in a subprocess (the test process keeps ONE
    JAX device)."""
    prog = textwrap.dedent("""
        import os, json, sys
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        sys.path.insert(0, {src!r})
        import numpy as np
        from repro import compat
        from repro.core import elastic_mesh as em
        from repro.sharding import partition
        mesh = compat.make_mesh((4, 2), ("data", "model"))
        edm = em.ElasticDeviceMesh(mesh, "data")
        for nid in (7, 3, 5, 9):
            edm.admit(nid)
        edm.evict(3)
        edm.admit(11)
        h = em.hierarchy(mesh, "data")
        out = {{"capacity": edm.capacity,
               "ranks": [[edm.global_rank({{"data": d, "model": m}}),
                          edm.local_rank({{"data": d, "model": m}})]
                         for d in range(4) for m in range(2)],
               "hier": [h.wan_axis, list(h.local_axes), h.n_local, h.split],
               "weights": np.asarray(edm.weights(
                   [7, 5, 9, 11], joining_ids=[9],
                   straggler_ids=[5])).tolist(),
               "specs": [[list(p) for p in partition.wan_ring_specs(
                   "data", *axes)] for axes in ((("model",),), ())]}}
        small = em.ElasticDeviceMesh(
            compat.make_mesh((2, 2), ("data", "model"),
                             devices=np.asarray(mesh.devices)[:2].reshape(-1)),
            "data")
        for nid in (4, 8):
            small.admit(nid)
        re = small.remesh(1)
        out["remesh"] = [dict(re.mesh.shape), re.capacity,
                         sorted(re.slots.slot_of.items())]
        print("JSON" + json.dumps(out))
    """).format(src=_SRC)
    res = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    line = next(l for l in res.stdout.splitlines() if l.startswith("JSON"))
    return json.loads(line[4:])


def test_elastic_device_mesh_matches_repro(mesh42):
    """global/local ranks, the hierarchy split, the slot weights, the
    ring buffers' specs and a remesh (new store, new rendezvous, slots below the new size kept)
    equal ``repro``'s; the remesh closes the old rank pool."""
    want = _repro_bookkeeping()
    edm = tem.ElasticDeviceMesh(mesh42, "data")
    for nid in (7, 3, 5, 9):
        edm.admit(nid)
    edm.evict(3)
    edm.admit(11)
    h = tem.hierarchy(mesh42, "data")
    w = edm.weights([7, 5, 9, 11], joining_ids=[9], straggler_ids=[5])
    assert w.device == mesh42.device
    got = {"capacity": edm.capacity,
           "ranks": [[edm.global_rank({"data": d, "model": m}),
                      edm.local_rank({"data": d, "model": m})]
                     for d in range(4) for m in range(2)],
           "hier": [h.wan_axis, list(h.local_axes), h.n_local, h.split],
           "weights": w.tolist()}
    # the rank processes agree with the bookkeeping: rank r sits at
    # coords(r), and a fiber along the local axes is its local group
    for r in range(mesh42.size):
        c = mesh42.coords(r)
        assert got["ranks"][r] == [edm.global_rank(c), edm.local_rank(c)]
    got["specs"] = json.loads(json.dumps([
        partition.wan_ring_specs("data", ("model",)),
        partition.wan_ring_specs("data")]))
    small = tem.ElasticDeviceMesh(
        make_mesh((2, 2), ("data", "model"), device="cpu"), "data")
    old_pids = small.mesh.pids
    for nid in (4, 8):
        small.admit(nid)
    re = small.remesh(1)
    try:
        got["remesh"] = [dict(re.mesh.shape), re.capacity,
                         [list(kv) for kv in sorted(re.slots.slot_of.items())]]
        assert not any(small.mesh.alive())
        assert all(re.mesh.alive()) and set(re.mesh.pids).isdisjoint(old_pids)
    finally:
        re.mesh.close()
    want["remesh"][2] = [list(kv) for kv in want["remesh"][2]]
    assert got == want


def _gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


@pytest.mark.parametrize("fault", ["exit", "raise"])
def test_failed_rank_raises_within_timeout(fault):
    """A rank that dies mid-hop, or raises, makes the controller raise
    ``RankFailure`` within the group timeout (never a hang); the mesh is
    then unusable and ``close()`` leaves no live child process."""
    timeout = 10.0
    mesh = make_host_mesh(2, device="cpu", timeout=timeout)
    try:
        pr = ts.DistSyncPrograms(mesh, "data", 4096, trr.RingConfig())
        rows = torch.randn(2, 4096)
        op = ts.DistRingSyncOp(pr, rows)
        t0 = time.monotonic()
        if fault == "exit":
            op.step()                     # the hop is in flight
            os.kill(mesh.pids[1], signal.SIGKILL)
            with pytest.raises(RankFailure, match="rank 1 exited"):
                op.finish()
        else:
            mesh.submit(ts._rank_hop, 12345, 0)   # no such reduction
            with pytest.raises(RankFailure, match="KeyError"):
                op.finish()
        assert time.monotonic() - t0 < timeout + 5.0
        with pytest.raises(RankFailure):
            mesh.call(ts._rank_drop, 1)
    finally:
        mesh.close()
    assert not any(mesh.alive())
    assert all(_gone(pid) for pid in mesh.pids)
