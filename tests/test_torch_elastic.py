"""The port's elastic DiLoCo trainer: joins, crashes, poison, a ring
reorder, contribution validation, the overlapped outer sync and int4
with error feedback.

Against ``repro`` (reduced INTELLECT-1 in fp32, the same parameters
through ``from_jax_params``, the same batches through
``batch_provider``): one schedule of 5 outer steps on 4 slots, nodes
0-2 live, a JOIN of node 3 at step 1, a POISON "huge" of node 1 at
step 2 (flagged and quarantined), a CRASH of node 2 at step 4 while
its delayed sync is in flight (torn, re-reduced over the survivors), a
fixed bandwidth matrix whose slow edge lies on the identity ring (one
reorder), ``overlap="delayed"`` over 7 inner chunks. Discrete fields
(live, joined, left, attempts, wire bytes, ring order, admission
verdicts, quarantine events, the fallback's ``torn_by``) are equal;
per-step losses within rtol 1e-4 (int4: 1e-3, since a code flipped at
a bucket edge moves its element 16 times as far as an int8 flip, and
later phases start from that anchor); final anchors under the ring rule of
``test_torch_ring.py`` (within 1e-5 but for rare code flips), with the
bound of every reduction that ran scaled by the outer step as in
``test_torch_train.py`` (16 buckets for int4). int4 codes equal the
reference's but at rounding edges: at most 1 in 1000 elements.

Inside the port, each bitwise: ``RingSyncOp`` stepped one hop at a
time == ``simulate_ring_all_reduce`` (with ``hop_codec_calls`` wrapper
calls per hop); chunked inner phase == one chunk; begin + finish ==
``outer_sync_sim``; a torn sync's re-reduce == a synchronous sync over
the survivors; delayed ``run(1)`` + drain == synchronous ``run(1)``;
``abort`` then ``finish`` raises."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS
from repro.core import compression as jcomp
from repro.core import diloco as jdl
from repro.core import fault_tolerance as jft
from repro.core import ring_reduce as jrr
from repro.core import validation as jvd
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.models.registry import get_model as jget_model
from repro.train.loop import ElasticTrainer as JTrainer
from repro.train.loop import TrainerConfig as JTrainerConfig
from repro_torch.configs import CONFIGS as TCONFIGS
from repro_torch.convert import from_jax_params
from repro_torch.core import compression as tcomp
from repro_torch.core import diloco as tdl
from repro_torch.core import fault_tolerance as tft
from repro_torch.core import ring_reduce as trr
from repro_torch.core import validation as tvd
from repro_torch.core.sync_engine import leaves
from repro_torch.data.pipeline import DataConfig
from repro_torch.kernels import int8_quant
from repro_torch.models.registry import get_model as tget_model
from repro_torch.train.loop import ElasticTrainer as TTrainer
from repro_torch.train.loop import TrainerConfig as TTrainerConfig
from test_torch_ring import _case, check_ring_close

torch.set_float32_matmul_precision("highest")
torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

ARCH = "intellect-1"
H, K, OUTER, SEQ, BATCH = 7, 4, 5, 16, 2
LR, MU = 0.7, 0.9
EVENTS = [(1, "join", 3, ""), (2, "poison", 1, "huge"), (4, "crash", 2, "")]
# every link 10 Gb/s but 0-1, which the identity ring crosses
BW = np.full((K, K), 10.0)
BW[0, 1] = BW[1, 0] = 1.0
np.fill_diagonal(BW, 0.0)


@pytest.fixture(scope="module")
def reference_model():
    """The model, its parameters and a batch provider whose batches are
    made once and served to every trainer of the module."""
    cfg = dataclasses.replace(JCONFIGS[ARCH].reduced(), dtype="float32")
    model = jget_model(cfg)
    params, _ = model.init(jax.random.PRNGKey(0))
    dcfg = JDataConfig(vocab=cfg.vocab, seq_len=SEQ, batch_per_worker=BATCH,
                       total_steps=OUTER * H)
    return cfg, model, params, _provider(dcfg, K)


def _provider(dcfg, k):
    pipes = [JTokenPipeline(dcfg, s, k) for s in range(k)]
    made = {}

    def provide(global_step, h, kk):
        assert kk == k
        if (global_step, h) not in made:
            steps = [[jax.tree.map(np.asarray, p.batch_at(global_step + i))
                      for p in pipes] for i in range(h)]
            made[global_step, h] = {
                key: np.stack([np.stack([b[key] for b in row])
                               for row in steps]) for key in steps[0][0]}
        return made[global_step, h]
    return provide


def _record_losses(trainer, out):
    run_inner = trainer._run_inner_phase

    def wrapped(batches, active):
        losses = run_inner(batches, active)
        out.append(np.asarray(losses))
        return losses
    trainer._run_inner_phase = wrapped


def _ring_bound(xs, weights, k, buckets):
    """One bucket width of the widest quantization (6 sigma over
    ``buckets`` buckets), k times, over the total weight."""
    width = 12.0 * sum(float(np.std(w * x)) for w, x in
                       zip(weights, xs)) / buckets
    return k * width / max(float(weights.sum()), 1e-20)


@pytest.mark.parametrize("quant,ef", [("int8", False), ("int4", True)])
def test_elastic_schedule_matches_reference(reference_model, quant, ef,
                                            monkeypatch):
    jcfg, jm, params, provide = reference_model
    tcfg = dataclasses.replace(TCONFIGS[ARCH].reduced(), dtype="float32")
    dcfg = JDataConfig(vocab=jcfg.vocab, seq_len=SEQ,
                       batch_per_worker=BATCH, total_steps=OUTER * H)
    jev = [jft.NodeEvent(t, jft.EventKind(kind), nid, arg)
           for t, kind, nid, arg in EVENTS]
    tev = [tft.NodeEvent(t, tft.EventKind(kind), nid, arg)
           for t, kind, nid, arg in EVENTS]
    dkw = dict(inner_steps=H, overlap="delayed", quant=quant,
               error_feedback=ef)
    jt = JTrainer(jm, JTrainerConfig(
        jdl.DiLoCoConfig(**dkw), inner_lr=3e-3, max_workers=K,
        inner_chunks=7, validation=jvd.ValidationConfig()), dcfg, params,
        jft.ClusterSimulator(range(3), events=jev), batch_provider=provide)
    tt = TTrainer(tget_model(tcfg, "cpu"), TTrainerConfig(
        tdl.DiLoCoConfig(**dkw), inner_lr=3e-3, max_workers=K,
        inner_chunks=7, validation=tvd.ValidationConfig()),
        DataConfig(vocab=jcfg.vocab, seq_len=SEQ, batch_per_worker=BATCH),
        from_jax_params(jax.tree.map(np.asarray, params), "cpu"),
        tft.ClusterSimulator(range(3), events=tev), batch_provider=provide)
    rtol = 1e-3 if quant == "int4" else 1e-4
    jl, tl, bounds = [], [], []
    _record_losses(jt, jl)
    _record_losses(tt, tl)
    finish = trr.RingSyncOp.finish

    def bounded_finish(op):
        if op._out is None and op.k > 1:    # every reduction, restarts too
            bounds.append(_ring_bound(op.xs.numpy(), op.weights.numpy(),
                                      op.k, 16 if quant == "int4" else 256))
        return finish(op)
    monkeypatch.setattr(trr.RingSyncOp, "finish", bounded_finish)

    jh = jt.run(OUTER, bandwidth_sampler=lambda t: BW)
    th = tt.run(OUTER, bandwidth_sampler=lambda t: BW)
    assert len(th) == len(jh) == OUTER
    for a, b in zip(th, jh):
        for key in ("outer_step", "live", "joined", "left", "attempts",
                    "wire_bytes", "ring_order", "admission"):
            assert a[key] == b[key], (a["outer_step"], key)
        assert ("sync_fallback" in a) == ("sync_fallback" in b)
        if "sync_fallback" in a:
            for key in ("torn_by", "resync_hops"):
                assert a["sync_fallback"][key] == b["sync_fallback"][key]
        assert a["overlap"]["hops"] == b["overlap"]["hops"]
        assert ("rejected" in a["overlap"]) == ("rejected" in b["overlap"])
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=rtol)
    for a, b in zip(tl, jl):
        live = ~np.isnan(a[0])
        np.testing.assert_allclose(a[:, live], b[:, live], rtol=rtol)
    assert tt.quarantine_events == jt.quarantine_events
    assert tt.reorders == jt.reorders == 1
    assert tt.sim.quarantined_ids() == jt.sim.quarantined_ids()
    # the schedule shows every event it was built for
    assert th[1]["joined"] == [3]
    assert th[2]["admission"]["quarantined"] == [1]
    assert th[4]["sync_fallback"]["torn_by"] == [2]
    assert th[4]["sync_fallback"]["hops_done"] == 1
    assert th[0]["ring_order"] != tuple(range(K))
    assert "drain" in th[-1]["overlap"]
    assert len(bounds) == OUTER      # 3 finished, 1 sanitized, 1 torn
    check_ring_close(tt.outer.anchor_flat.numpy(),
                     np.asarray(jt.outer.anchor_flat), quant,
                     LR * (1 + MU) ** 2 * sum(bounds))
    assert tuple(tt.outer.residual.shape) == \
        tuple(np.asarray(jt.outer.residual).shape)


def test_launcher_events_on_cpu():
    """``--events`` (the reference's JSON) through the port's launcher:
    the membership of every step equals the reference simulator's plans
    for the same events, and the crash of a participant tears the
    delayed sync in flight."""
    from repro_torch.launch import train
    events = [[1, "join", 3], [2, "crash", 0]]
    out = train.main(["--device", "cpu", "--reduced", "--workers", "3",
                      "--max-workers", "4", "--outer-steps", "3",
                      "--inner-steps", "2", "--seq-len", "16",
                      "--batch-per-worker", "2", "--overlap", "delayed",
                      "--inner-chunks", "3", "--events",
                      json.dumps(events)])
    hist = out["history"]
    sim = jft.ClusterSimulator(range(3), events=[
        jft.NodeEvent(t, jft.EventKind(kind), nid) for t, kind, nid in events])
    for rec in hist:
        plan = sim.begin_outer_step(rec["outer_step"])
        for key in ("live", "joined", "left"):
            assert rec[key] == plan[key]
    assert hist[2]["sync_fallback"]["torn_by"] == [0]
    assert all(np.isfinite(h["loss"]) for h in hist)


# -- int4 codec ---------------------------------------------------------------


def test_quantize4_matches_reference():
    """Codes equal but at rounding edges (lo and width come from two
    frameworks' reductions): at most 1 in 1000 elements, each off by
    one code; codebooks within 1e-6 of a bucket's width; the packing is
    the reference's."""
    rng = np.random.default_rng(3)
    for n in (7, 4097):
        x = (rng.normal(size=n) * rng.uniform(0.1, 3)).astype(np.float32)
        x[0] = 40.0
        jq = jcomp.quantize4(jnp.asarray(x))
        tq = tcomp.quantize4(torch.from_numpy(x)[None])
        jp, tp = np.asarray(jq.packed), tq.packed[0].numpy()
        assert tp.dtype == np.uint8 and tp.shape == jp.shape
        jc = np.stack([jp // 16, jp % 16], -1).reshape(-1)[:n]
        tc = np.stack([tp // 16, tp % 16], -1).reshape(-1)[:n]
        assert np.abs(jc.astype(int) - tc).max() <= 1
        assert (jc != tc).sum() <= max(1, n // 1000)
        width = 12 * float(np.std(x)) / 16
        np.testing.assert_allclose(tq.codebook[0].numpy(),
                                   np.asarray(jq.codebook),
                                   atol=1e-6 * width + 1e-7, rtol=1e-6)
        np.testing.assert_array_equal(
            tcomp.dequantize4(tq, n)[0].numpy(),
            tq.codebook[0].numpy()[tc])
        assert tq.wire_bytes == jq.wire_bytes


def test_int4_ring_matches_reference():
    k = 4
    anchor, thetas, xs, order, weights = _case(k)
    want = jrr.simulate_ring_all_reduce(
        jnp.asarray(xs), ring_order=order,
        cfg=jrr.RingConfig(quant="int4", buckets=2),
        weights=jnp.asarray(weights))
    got = trr.simulate_ring_all_reduce(
        torch.from_numpy(xs), ring_order=order,
        cfg=trr.RingConfig(quant="int4", buckets=2),
        weights=torch.from_numpy(weights))
    assert torch.equal(got, got[:1].expand_as(got))
    check_ring_close(got.numpy(), np.asarray(want), "int4",
                     _ring_bound(xs, weights, k, 16))
    assert trr.codec_calls(k, trr.RingConfig(quant="int4")) == \
        dict.fromkeys(trr.CODEC, 0)


def test_ef_residual_shapes_match_reference():
    params = {"w": np.ones((3, 5), np.float32), "b": np.zeros(4, np.float32)}
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    for ef, overlap in [(False, "none"), (True, "none"), (True, "delayed"),
                        (False, "delayed")]:
        kw = dict(error_feedback=ef, overlap=overlap, quant="int4")
        want = jdl.init_outer_state_sim(jax.tree.map(jnp.asarray, params),
                                        jdl.DiLoCoConfig(**kw), 3)
        got = tdl.init_outer_state_sim(tparams, tdl.DiLoCoConfig(**kw), 3)
        assert tuple(got.residual.shape) == \
            tuple(np.asarray(want.residual).shape)


# -- inside the port, bitwise -------------------------------------------------


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("quant", ["int8", "fp32", "int4"])
@pytest.mark.parametrize("buckets", [1, 2])
@pytest.mark.parametrize("fused", [True, False])
def test_ring_sync_op_stepped_equals_oneshot(k, quant, buckets, fused,
                                             monkeypatch):
    """One hop per ``step()`` with other work in between gives the
    one-shot result bit for bit, leaves its inputs as they were, and
    calls each codec wrapper ``hop_codec_calls`` times per hop."""
    anchor, thetas, xs, order, weights = _case(k)
    cfg = trr.RingConfig(quant=quant, buckets=buckets, fused=fused)
    src = (torch.from_numpy(anchor), torch.from_numpy(thetas))
    want = trr.simulate_ring_all_reduce(
        torch.from_numpy(xs), order, cfg, torch.from_numpy(weights), src)
    calls = dict.fromkeys(trr.CODEC, 0)
    for name in trr.CODEC:
        fn = getattr(int8_quant, name)

        def counted(*a, _n=name, _fn=fn, **kw):
            calls[_n] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(int8_quant, name, counted)
    x = torch.from_numpy(xs.copy())
    op = trr.RingSyncOp(x, order, cfg, torch.from_numpy(weights), src)
    assert op.hops_total == 2 * (k - 1) and op.pending
    noise = torch.randn(64, 64)
    for hop in range(op.hops_total):
        before = dict(calls)
        assert op.step()
        noise = noise @ noise.T / 64        # unrelated work between hops
        assert {n: calls[n] - before[n] for n in calls} == \
            trr.hop_codec_calls(hop, k, cfg, True)
    assert not op.step() and not op.pending
    got = op.finish()
    assert torch.equal(got, want)
    assert op.finish() is got
    assert torch.equal(x, torch.from_numpy(xs))
    assert calls == trr.codec_calls(k, cfg, True)


def _port_trainer(overlap="none", chunks=1, events=(), workers=3, ef=False,
                  quant="int8", h=3):
    cfg = dataclasses.replace(TCONFIGS[ARCH].reduced(), dtype="float32")
    model = tget_model(cfg, "cpu")
    return TTrainer(
        model, TTrainerConfig(
            tdl.DiLoCoConfig(inner_steps=h, overlap=overlap, quant=quant,
                             error_feedback=ef),
            inner_lr=3e-3, max_workers=4, inner_chunks=chunks),
        DataConfig(vocab=cfg.vocab, seq_len=SEQ, batch_per_worker=BATCH),
        model.init(0), tft.ClusterSimulator(range(workers),
                                            events=list(events)))


def test_chunked_inner_phase_equals_one_chunk():
    a, b = _port_trainer(chunks=1), _port_trainer(chunks=3)
    ha, hb = a.run(2), b.run(2)
    assert [h["loss"] for h in ha] == [h["loss"] for h in hb]
    assert len(hb[0]["inner_chunk_s"]) == 3
    assert torch.equal(a.outer.anchor_flat, b.outer.anchor_flat)
    for x, y in zip(leaves(a.opt_state.m), leaves(b.opt_state.m)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("quant,ef", [("int8", False), ("int4", True)])
def test_begin_finish_equals_outer_sync_sim(quant, ef):
    tr = _port_trainer(quant=quant, ef=ef)
    tr.run(1)
    tr._run_inner_phase({k: v[None] for k, v in tr._batches(100).items()},
                        tr.slots.live_mask([0, 1, 2]))
    w = torch.tensor([1.0, 0.0, 1.0, 1.0])
    cfg = tr.cfg.diloco
    want_p, want_s = tdl.outer_sync_sim(tr.params, tr.outer, cfg,
                                        ring_order=(2, 0, 3, 1), weights=w)
    h = tdl.begin_outer_sync_sim(tr.params, tr.outer, cfg,
                                 ring_order=(2, 0, 3, 1), weights=w)
    while h.step():
        pass
    got_p, got_s = tdl.finish_outer_sync_sim(h, tr.params, tr.outer)
    for x, y in zip(leaves(got_p), leaves(want_p)):
        assert torch.equal(x, y)
    assert torch.equal(got_s.anchor_flat, want_s.anchor_flat)
    assert torch.equal(got_s.residual, want_s.residual)
    assert got_s.outer_step == want_s.outer_step == tr.outer.outer_step + 1


def test_torn_sync_resync_equals_sync_over_survivors():
    """A sync torn after two hops, re-reduced over the survivors, equals
    the synchronous sync with the dead worker's weight at zero; the
    handle's anchor snapshot survives in-place writes to the params."""
    tr = _port_trainer()
    tr.run(1)
    tr._run_inner_phase({k: v[None] for k, v in tr._batches(50).items()},
                        tr.slots.live_mask([0, 1, 2]))
    cfg = tr.cfg.diloco
    w = torch.tensor([1.0, 1.0, 1.0, 0.0])
    survivors = torch.tensor([1.0, 0.0, 1.0, 0.0])
    want_p, want_s = tdl.outer_sync_sim(tr.params, tr.outer, cfg,
                                        weights=survivors)
    h = tdl.begin_outer_sync_sim(tr.params, tr.outer, cfg, weights=w)
    assert h.step() and h.step()
    snapshot = [p.clone() for p in leaves(tr.params)]
    tr._reset_to_anchor()                  # in-place writes under the handle
    got_p, got_s = tdl.resync_outer_sim(h, tr.params, tr.outer, survivors)
    assert torch.equal(got_s.anchor_flat, want_s.anchor_flat)
    for x, y in zip(leaves(got_p), leaves(want_p)):
        assert torch.equal(x, y)
    assert not all(torch.equal(a, b) for a, b in
                   zip(snapshot, leaves(tr.params)))


def test_delayed_one_step_with_drain_equals_sync():
    a, b = _port_trainer(), _port_trainer("delayed", 3)
    a.run(1)
    hb = b.run(1)
    assert torch.equal(a.outer.anchor_flat, b.outer.anchor_flat)
    assert b.outer.outer_step == 1 and b._inflight is None
    assert hb[0]["overlap"]["drain"]["hops"] == 2 * (b.k - 1)
    for x, y in zip(leaves(a.params), leaves(b.params)):
        assert torch.equal(x, y)


def test_delayed_ef_two_lineages_across_runs():
    tr = _port_trainer("delayed", 3, ef=True, quant="int4")
    hist = tr.run(3)
    assert all(np.isfinite(h["loss"]) for h in hist)
    res = tr.outer.residual
    assert tuple(res.shape) == (2, tr.k, tr.outer.anchor_flat.numel())
    assert res[0].abs().max() > 0 and res[1].abs().max() > 0
    assert tr._ef_begins == 3
    tr.run(1)
    assert tr._ef_begins == 4


def test_abort_then_finish_raises_and_close():
    tr = _port_trainer("delayed", 3)
    tr.run(1)
    h = tdl.begin_outer_sync_sim(tr.params, tr.outer, tr.cfg.diloco)
    h.abort()
    assert not h.step() and h.hops_total == 0
    for call in (lambda: tdl.finish_outer_sync_sim(h, tr.params, tr.outer),
                 lambda: tdl.resync_outer_sim(h, tr.params, tr.outer,
                                              torch.ones(4)),
                 h.norm_sideband, lambda: h.sanitize([0])):
        with pytest.raises(tdl.SyncAbortedError):
            call()
    # a trainer left with a sync in flight: discard aborts it, a clean
    # close drains and applies it
    for discard in (True, False):
        tr = _port_trainer("delayed", 3)
        tr.run(1)
        tr._run_inner_phase({k: v[None] for k, v in tr._batches(9).items()},
                            tr.slots.live_mask([0, 1, 2]))
        a0 = tr.outer.anchor_flat.clone()
        tr._inflight = tr._begin_sync(torch.ones(4), ef_slot=0)
        tr.comm_ledger.begin_sync(1.0)
        rec = tr.close(discard=discard)
        assert rec["discarded"] is discard and tr._inflight is None
        assert torch.equal(tr.outer.anchor_flat, a0) is discard
