"""repro_torch's ElasticTrainer against repro's on the reduced
INTELLECT-1 (fp32), from the same parameters (``from_jax_params``) and
the same batches (repro's TokenPipeline, fed to both through
``batch_provider``): synchronous int8 DiLoCo, H = 2, 2 outer steps.
Also: the cluster simulator's plans, the port's launcher on the CPU and
the data pipeline's contract.

Tolerances: per-step losses rtol 1e-4 (fp32 forward and backward in two
frameworks; 2e-3 in bf16); final fp32 anchors under the ring test's int8
rule, with the bound of each outer sync's pseudo-gradients scaled by the
outer step (bf16: see the test);
wire bytes, live sets and attempts identical."""
import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from fault_harness import seeded_events
from repro.configs import CONFIGS as JCONFIGS
from repro.core import diloco as jdl
from repro.core import fault_tolerance as jft
from repro.core.sync_engine import SyncEngine as JSyncEngine
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.models.registry import get_model as jget_model
from repro.train.loop import ElasticTrainer as JTrainer
from repro.train.loop import TrainerConfig as JTrainerConfig
from repro_torch.configs import CONFIGS as TCONFIGS
from repro_torch.convert import from_jax_params
from repro_torch.core import diloco as tdl
from repro_torch.core import fault_tolerance as tft
from repro_torch.core.sync_engine import SyncEngine, leaves, tree_map
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models.registry import get_model as tget_model
from repro_torch.train.loop import ElasticTrainer as TTrainer
from repro_torch.train.loop import TrainerConfig as TTrainerConfig
from test_torch_ring import check_ring_close, int8_bound

torch.set_float32_matmul_precision("highest")
torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

ARCH = "intellect-1"
H, OUTER, SEQ, BATCH = 2, 2, 16, 2


def _provider(dcfg, k):
    pipes = [JTokenPipeline(dcfg, s, k) for s in range(k)]

    def provide(global_step, h, kk):
        assert kk == k
        steps = [[jax.tree.map(np.asarray, p.batch_at(global_step + i))
                  for p in pipes] for i in range(h)]
        return {key: np.stack([np.stack([b[key] for b in row])
                               for row in steps]) for key in steps[0][0]}
    return provide


def _record_losses(trainer, out):
    run_inner = trainer._run_inner_phase

    def wrapped(batches, active):
        losses = run_inner(batches, active)
        out.append(np.asarray(losses))
        return losses
    trainer._run_inner_phase = wrapped


@pytest.mark.parametrize("workers,slots,dtype", [(2, 3, "float32"),
                                                 (3, 3, "float32"),
                                                 (2, 2, "bfloat16")])
def test_trainer_matches_reference(workers, slots, dtype):
    """bf16 (the full-width runs' type) rounds the parameters after each
    AdamW step in both frameworks: losses within rtol 2e-3 there, and
    the anchors within a tenth of how far training moved them."""
    jcfg = dataclasses.replace(JCONFIGS[ARCH].reduced(), dtype=dtype)
    tcfg = dataclasses.replace(TCONFIGS[ARCH].reduced(), dtype=dtype)
    rtol = 1e-4 if dtype == "float32" else 2e-3
    jm = jget_model(jcfg)
    params, _ = jm.init(jax.random.PRNGKey(0))
    dcfg = JDataConfig(vocab=jcfg.vocab, seq_len=SEQ,
                       batch_per_worker=BATCH, total_steps=OUTER * H)
    provide = _provider(dcfg, slots)

    jt = JTrainer(jm, JTrainerConfig(jdl.DiLoCoConfig(inner_steps=H),
                                     inner_lr=3e-3, max_workers=slots),
                  dcfg, params, jft.ClusterSimulator(range(workers)),
                  batch_provider=provide)
    tm = tget_model(tcfg, "cpu")
    tt = TTrainer(tm, TTrainerConfig(tdl.DiLoCoConfig(inner_steps=H),
                                     inner_lr=3e-3, max_workers=slots),
                  DataConfig(vocab=jcfg.vocab, seq_len=SEQ,
                             batch_per_worker=BATCH),
                  from_jax_params(jax.tree.map(np.asarray, params), "cpu"),
                  tft.ClusterSimulator(range(workers)),
                  batch_provider=provide)
    jl, tl, bounds = [], [], []
    _record_losses(jt, jl)
    _record_losses(tt, tl)
    sync = tt._outer_sync

    def bounded_sync(weights):
        eng = SyncEngine.for_tree(tree_map(lambda p: p[0], tt.params))
        xs = tt.outer.anchor_flat[None] - eng.flatten_rows(tt.params)
        bounds.append(int8_bound(xs.numpy(), weights.numpy(), slots))
        return sync(weights)
    tt._outer_sync = bounded_sync

    jh = jt.run(OUTER)
    th = tt.run(OUTER)
    live = slice(0, workers)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a[:, live], b[:, live], rtol=rtol)
    assert np.isnan(tl[0][:, workers:]).all()       # not computed
    for a, b in zip(th, jh):
        for key in ("outer_step", "live", "joined", "left", "attempts",
                    "wire_bytes", "ring_order"):
            assert a[key] == b[key], key
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=rtol)
    lr, mu = 0.7, 0.9
    a_t, a_j = tt.outer.anchor_flat.numpy(), np.asarray(jt.outer.anchor_flat)
    if dtype == "float32":
        check_ring_close(a_t, a_j, "int8", lr * (1 + mu) ** 2 * sum(bounds))
    else:
        # a bf16 parameter that rounds the other way once takes other
        # AdamW steps from then on: hold the anchors' difference to a
        # tenth of how far training moved them
        a0 = JSyncEngine.for_tree(params).flatten(params)
        moved = np.linalg.norm(a_j - np.asarray(a0))
        assert np.linalg.norm(a_t - a_j) < 0.1 * moved
    # inactive slots: AdamW state untouched, params reset to the anchor
    steps = np.asarray(jt.opt_state.step)
    assert tt.opt_state.step.tolist() == steps.tolist() == \
        [OUTER * H] * workers + [0] * (slots - workers)
    for v in leaves(tt.opt_state.m):
        assert not bool(v[workers:].any())


def test_cluster_simulator_plans_match_reference():
    ev = seeded_events(7, 8, joiner_ids=[5, 6], crash_ids=[1],
                       stall_ids=[2])
    jsim = jft.ClusterSimulator(range(4), events=ev)
    tsim = tft.ClusterSimulator(range(4), events=[
        tft.NodeEvent(e.outer_step, tft.EventKind(e.kind.value), e.node_id,
                      e.arg) for e in ev])
    for t in range(8):
        assert tsim.begin_outer_step(t) == jsim.begin_outer_step(t)
    assert tsim.history == jsim.history
    retry_j, retry_t = jft.RetryPolicy(), tft.RetryPolicy()
    fail = lambda a, live: frozenset({2}) if a == 0 else frozenset()
    assert retry_t.run_collective(sorted, range(4), fail) == \
        retry_j.run_collective(sorted, range(4), fail)


def test_launcher_trains_on_cpu():
    from repro_torch.launch import train
    out = train.main(["--device", "cpu", "--reduced", "--workers", "2",
                      "--outer-steps", "2", "--inner-steps", "2",
                      "--seq-len", "16", "--batch-per-worker", "2"])
    hist, tr = out["history"], out["trainer"]
    assert [h["outer_step"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert tr.k == 4                       # max(2w, w+2)
    n = SyncEngine.for_tree(tr.outer.anchor).numel
    assert hist[-1]["wire_bytes"] == tdl.sync_wire_bytes(
        tr.outer.anchor, 2, tr.cfg.diloco)
    assert hist[-1]["wire_bytes"] == 2 * (-(-n // 2) + 1024)
    assert train.build_parser().parse_args([]).device == "cuda"


CKPT_ARGV = ["--device", "cpu", "--reduced", "--workers", "2",
             "--inner-steps", "2", "--seq-len", "8", "--batch-per-worker",
             "1"]


def _writer(tmp_path, engine="delta", outer=3):
    from repro_torch.launch import train
    argv = CKPT_ARGV + ["--outer-steps", str(outer), "--ckpt-dir",
                        str(tmp_path / "writer"), "--ckpt-engine", engine]
    out = train.main(argv)
    args = train.build_parser().parse_args(argv + ["--serve-ckpt-port", "0"])
    return args, out["trainer"], out["history"]


def test_launcher_delta_checkpoint_then_restore(tmp_path):
    from repro_torch.checkpointing import ChunkStore, delta
    _, tr, hist = _writer(tmp_path)
    store = ChunkStore(tmp_path / "writer")
    assert store.steps() == [2, 4, 6] == tr.persisted_steps
    assert [store.load_manifest(s)["kind"] for s in store.steps()] == \
        ["base", "delta", "delta"]
    like = tr.checkpoint_like()
    got, meta = delta.restore(store, like, device="cpu")
    assert meta == {"outer_step": 3}
    want = tr.ckpt_writer.reference(like)
    for a, b in zip(leaves(got), leaves(want)):
        assert torch.equal(a, b)
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)


@pytest.mark.parametrize("engine", ["store", "delta"])
def test_launcher_blocking_join_from_a_served_peer(tmp_path, engine):
    """``--join-from`` against a peer that ``serve_checkpoints`` runs on
    its own thread: the joiner starts from the writer's checkpoint."""
    from repro_torch.launch import train
    args, tr, _ = _writer(tmp_path, engine)
    peer = train.serve_checkpoints(args, tr)
    try:
        out = train.main(CKPT_ARGV + [
            "--outer-steps", "1", "--ckpt-dir", str(tmp_path / "joiner"),
            "--ckpt-engine", engine,
            "--join-from", f"127.0.0.1:{peer.port}"])
    finally:
        peer.close()
    jt = out["trainer"]
    assert jt.outer.outer_step == 4           # resumed at 3, one more
    assert out["history"][0]["outer_step"] == 0
    assert np.isfinite(out["history"][0]["loss"])
    # the fetched chain (a delta chain from its base), then its own save
    assert jt.ckpt_store.steps() == \
        ([2, 4, 6] if engine == "delta" else [6]) + [8]


def test_launcher_stream_join(tmp_path):
    """``--join-mode stream`` begins the streaming join before training;
    the trainer adopts it at the first boundary where it is ready."""
    from repro_torch.launch import train
    args, tr, _ = _writer(tmp_path)
    peer = train.serve_checkpoints(args, tr)
    try:
        jargs = train.build_parser().parse_args(CKPT_ARGV + [
            "--outer-steps", "1", "--ckpt-dir", str(tmp_path / "joiner"),
            "--ckpt-engine", "delta", "--join-mode", "stream",
            "--join-from", f"127.0.0.1:{peer.port}"])
        jt = train.build_trainer(jargs)
        assert train.join(jargs, jt) is None
        jt._stream_join.wait_ready(timeout=60)
        hist = jt.run(1, inner_steps=jargs.inner_steps)
    finally:
        peer.close()
    rec = hist[0]["stream_join"]
    assert rec["admitted"] and rec["step"] == 6 and rec["outer_step"] == 3
    want = tr.ckpt_writer.reference(tr.checkpoint_like())
    for a, b in zip(leaves(jt.outer.anchor), leaves(want["anchor"])):
        assert torch.equal(a, b)


def test_launcher_serves_flat_checkpoints(tmp_path):
    from repro_torch.checkpointing import fetch_checkpoint, restore
    from repro_torch.launch import train
    args, tr, _ = _writer(tmp_path, "flat", outer=1)
    for _ in range(500):
        if (tmp_path / "writer" / "step_00000002").exists():
            break
        time.sleep(0.01)
    peer = train.serve_checkpoints(args, tr)
    try:
        path = fetch_checkpoint(("127.0.0.1", peer.port), tmp_path / "got")
    finally:
        peer.close()
    got, meta = restore(tmp_path / "got", tr.checkpoint_like())
    assert path.name == "step_00000002" and meta == {"outer_step": 1}
    for a, b in zip(leaves(got), leaves(tr.checkpoint_like())):
        assert torch.equal(a, b)


@pytest.mark.parametrize("argv", [["--overlap", "delayed"],
                                  ["--events", '[[1, "crash", 0]]'],
                                  ["--quant", "int4"],
                                  ["--error-feedback"],
                                  ["--inner-chunks", "2"]])
def test_launcher_runs_elastic_options(argv):
    from repro_torch.launch import train
    hist = train.main(["--device", "cpu", "--reduced", "--workers", "2",
                       "--outer-steps", "2", "--inner-steps", "2",
                       "--seq-len", "8", "--batch-per-worker", "1"]
                      + argv)["history"]
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    if argv[0] == "--events":
        assert hist[1]["left"] == [0] and hist[1]["live"] == [1]


def test_pipeline_contract():
    cfg = DataConfig(vocab=1000, seq_len=32, batch_per_worker=16,
                     total_steps=100)
    b = TokenPipeline(cfg, 0, 4).batch_at(17)
    assert torch.equal(b["tokens"], TokenPipeline(cfg, 0, 4).batch_at(17)[
        "tokens"])                                       # pure
    assert torch.equal(b["tokens"][:, 1:], b["targets"][:, :-1])
    assert b["tokens"].dtype == torch.int32 and b["tokens"].shape == (16, 32)
    assert b["mask"].dtype == torch.float32 and bool((b["mask"] == 1).all())
    others = [TokenPipeline(cfg, w, 4).batch_at(17)["tokens"]
              for w in (1, 2, 3)]
    assert not any(torch.equal(b["tokens"], o) for o in others)  # disjoint
    assert not torch.equal(b["tokens"],
                           TokenPipeline(cfg, 0, 4).batch_at(18)["tokens"])
    assert int(b["tokens"][:, 1:].min()) >= 8
    assert int(b["tokens"].max()) < cfg.vocab
    big = DataConfig(vocab=1000, seq_len=8, batch_per_worker=512,
                     total_steps=100)
    p = TokenPipeline(big, 0, 1)
    for step in (0, 90):                       # stable, then annealing
        markers = np.concatenate([p.batch_at(step + s)["tokens"][:, 0]
                                  .numpy() for s in range(5)])
        frac = np.bincount(markers, minlength=5)[:5] / markers.size
        np.testing.assert_allclose(frac, p.mixture_at(step), atol=0.03)
    np.testing.assert_allclose(
        p.mixture_at(90), JTokenPipeline(
            JDataConfig(vocab=1000, seq_len=8, batch_per_worker=1,
                        total_steps=100), 0, 1).mixture_at(90))
