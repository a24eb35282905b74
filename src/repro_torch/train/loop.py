"""ElasticTrainer: the PRIME training loop, stacked single-process
simulation (port of ``repro.train.loop``).

Per outer step t (paper Alg. 1 + §2.4):
  1. ``ClusterSimulator.begin_outer_step`` applies membership events
     (join / graceful leave / crash / straggler / poison); a joiner
     takes the anchor and a fresh AdamW state in its slot; a crash of a
     participant of the sync in flight tears it, and the trainer
     re-reduces its retained rows over the survivors;
  2. every live slot runs H inner AdamW steps on its data shard, in
     ``inner_chunks`` chunks; between chunks one hop of the overlapped
     sync in flight is dispatched;
  3. the bandwidth monitor re-solves the max-min ring order when the
     links drift (``bandwidth_sampler``);
  4. the ring all-reduce averages the pseudo-gradients over the live
     workers (weight 0 for joiners, stragglers and re-admitted nodes),
     behind the contribution-admission gates when ``validation`` is
     set (flagged contributors are sanitized out and quarantined);
  5. the shared Nesterov outer step updates the anchor and every slot
     resets to it: at once (``overlap="none"``), or one phase late
     (``"delayed"``), the ring of boundary t running under phase t+1;
     a streaming join that finished during the phase is adopted, and the
     checkpoint (slot 0's parameters, the outer momentum and the anchor)
     is written every ``ckpt_every_outer`` steps: flat npy directories,
     the chunk store or an int8/int4 delta chain, persisted off the
     critical path by an ``AsyncSnapshotter``, with retention gc.

The k slots are stacked ``(k, ...)`` tensors on the model's device. The
inner step loops over the live slots with ``torch.autograd`` where the
JAX package ``vmap``s every slot and masks the inactive ones with
``jnp.where``; skipping them is the same result: their parameters and
AdamW state (``step`` included) stay untouched. Parameters and moments
are updated in place (AdamW, the post-sync reset, a joiner's slot,
poison); the sync in flight keeps copies of what it needs.

With ``sync_backend=train.step.DistSyncBackend(mesh, axis)`` the outer
sync runs as a ring of rank processes (one wire hop per command, the
same handle surface), which gives the simulator's results bit for bit.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core import diloco as dl
from repro_torch.core import ring_reduce as rr
from repro_torch.core import topology
from repro_torch.core import validation as vd
from repro_torch.core.elastic_mesh import SlotAssignment
from repro_torch.core.fault_tolerance import (ClusterSimulator,
                                              CommOverlapLedger, RetryPolicy)
from repro_torch.core.sync_engine import SyncEngine, leaves, tree_map
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.optim.adamw import AdamW, AdamWState


@dataclasses.dataclass
class TrainerConfig:
    diloco: dl.DiLoCoConfig
    inner_lr: float | Callable = 7.5e-5
    ckpt_dir: str | None = None
    ckpt_every_outer: int = 1
    # 'flat'  — npy-per-leaf dirs (CheckpointServer-served)
    # 'store' — content-addressed chunk store (dedup + swarm-fetchable)
    # 'delta' — chunk store + int8/int4 delta chain between base anchors
    ckpt_engine: str = "flat"
    ckpt_delta_base_every: int = 8
    ckpt_codec: str = "int8"       # delta codec: 'int8' | 'int4'
    ckpt_chunk_bytes: int = 1 << 20
    # retention: keep the newest N store/delta checkpoints, gc the rest
    # (FIFO behind the async persists); None keeps everything
    ckpt_keep: int | None = None
    max_workers: int = 16
    seconds_per_outer_step: float = 60.0
    # inner phase as this many chunks; the gaps between chunks are where
    # hops of the sync in flight are dispatched (overlap='delayed')
    inner_chunks: int = 1
    # modeled WAN link for the CommOverlapLedger's logical-time
    # hidden/exposed accounting, until the BandwidthMonitor has observed
    # every edge of the current ring
    sync_link_bytes_per_s: float = 500e6
    # unit conversion for BandwidthMonitor matrices (Gb/s -> bytes/s)
    link_bytes_per_gbps: float = 125e6
    # contribution admission: None disables it (core/validation.py)
    validation: vd.ValidationConfig | None = None


def _stack(tree, k: int):
    return tree_map(lambda x: x[None].repeat((k,) + (1,) * x.dim()), tree)


def _slot(tree, s: int):
    return tree_map(lambda x: x[s], tree)


class ElasticTrainer:
    def __init__(self, model, cfg: TrainerConfig, data_cfg: DataConfig,
                 init_params, sim: ClusterSimulator, *,
                 batch_provider: Callable | None = None,
                 boundary_hook: Callable | None = None,
                 sync_backend=None):
        self.model = model
        self.device = torch.device(model.device)
        self.cfg = cfg
        self.data_cfg = data_cfg
        self.sim = sim
        # batch_provider(global_step, h, k) -> (H, k, ...) batch dict;
        # boundary_hook(t, trainer) runs after each boundary's sync and
        # bookkeeping, and what it returns goes into the history
        self.batch_provider = batch_provider
        self.boundary_hook = boundary_hook
        # sync_backend (train.step.DistSyncBackend) stages the outer
        # sync as a ring of rank processes; None = the stacked simulator
        # (the same OuterSyncHandle surface either way)
        self.sync_backend = sync_backend
        self.optimizer = AdamW(lr=cfg.inner_lr)
        self.retry = RetryPolicy()
        self.slots = SlotAssignment(cfg.max_workers)
        for nid in sim.hb.live_ids():
            self.slots.assign(nid)
        k = self.k = cfg.max_workers
        init_params = tree_map(lambda x: x.to(self.device), init_params)
        self.params = _stack(init_params, k)
        zeros = lambda: tree_map(
            lambda x: torch.zeros_like(x, dtype=torch.float32), self.params)
        self.opt_state = AdamWState(
            torch.zeros((k,), dtype=torch.int32, device=self.device),
            zeros(), zeros())         # per-slot AdamW.init
        self.outer = dl.init_outer_state_sim(init_params, cfg.diloco, k)
        self.bw = topology.BandwidthMonitor(k)
        self.ring_order = tuple(range(k))
        self.overlap = cfg.diloco.overlap == "delayed"
        if self.overlap and cfg.inner_chunks <= 1:
            warnings.warn(
                "overlap='delayed' with inner_chunks<=1: the inner "
                "phase has no interleave points, so all but the first "
                "ring hop drain EXPOSED at the boundary. Set "
                "TrainerConfig.inner_chunks >= 2*(k-1)+1 = "
                f"{2 * (k - 1) + 1} to hide the whole ring.", stacklevel=2)
        self._inflight: dl.OuterSyncHandle | None = None
        # two-slot EF lineage counter: alternates 0/1 per begin
        self._ef_begins = 0
        self.comm_ledger = CommOverlapLedger()
        # the ring walks 2(k-1) hops; only the live workers' 2(n_live-1)
        # carry bytes on a real cluster, the rest are charged 0 s
        self._live_hops = 0
        self._window_hop_i = 0
        self.reorders = 0
        self._adm_stats = (vd.AdmissionStats(cfg.validation)
                           if cfg.validation is not None else None)
        self.quarantine_events: list[dict] = []
        self.history: list[dict] = []
        self._pipelines: dict[int, TokenPipeline] = {}
        # wall seconds of the last inner phase's chunks and of the hops
        # dispatched after them
        self._chunk_s: list[float] = []
        self._hop_s: list[float] = []
        self.ckpt_store = None
        self.ckpt_writer = None                # the DeltaCheckpointer
        self.snapshotter = None
        self._ckpt_steps: list[int] = []
        self.persisted_steps: list[int] = []   # on disk, not just queued
        self._stream_join = None               # in-flight StreamingFetcher
        if cfg.ckpt_dir and cfg.ckpt_engine != "flat":
            from repro_torch.checkpointing import (AsyncSnapshotter,
                                                   ChunkStore,
                                                   DeltaCheckpointer,
                                                   DeltaConfig)
            self.ckpt_store = ChunkStore(
                cfg.ckpt_dir, chunk_bytes=cfg.ckpt_chunk_bytes)
            if cfg.ckpt_engine == "delta":
                self.ckpt_writer = DeltaCheckpointer(
                    self.ckpt_store,
                    DeltaConfig(base_every=cfg.ckpt_delta_base_every,
                                codec=cfg.ckpt_codec), device=self.device)
                write_fn = self.ckpt_writer.save
            elif cfg.ckpt_engine == "store":
                write_fn = self.ckpt_store.save_tree
            else:
                raise ValueError(
                    f"unknown ckpt_engine {cfg.ckpt_engine!r}")
            # double-buffered: persists overlap the next inner phase, FIFO
            # so the delta chain is written in step order; on_persist
            # tracks what is actually on disk, which the retention gc's
            # keep set reads when the task runs
            self.snapshotter = AsyncSnapshotter(
                write_fn,
                on_persist=lambda step, _m:
                    self.persisted_steps.append(step))

    # -- inner phase ----------------------------------------------------------

    def _inner_step(self, params, opt_state, batch, active) -> torch.Tensor:
        """One inner step of every live slot, in place. Returns the (k,)
        losses (NaN for inactive slots, which are not computed); an MoE
        model's load-balance losses go to ``self._lb_losses``."""
        losses = torch.full((self.k,), float("nan"), device=self.device)
        self._lb_losses = torch.full_like(losses, float("nan"))
        for s in np.flatnonzero(np.asarray(active) > 0).tolist():
            p = tree_map(lambda x: x[s].detach().requires_grad_(True), params)
            b = {key: v[s] for key, v in batch.items()}
            with spans.span("train.forward", self.device):
                loss, metrics = self.model.loss(p, b)
            with spans.span("train.backward", self.device):
                loss.backward()
            grads = tree_map(lambda x: x.grad, p)
            with spans.span("train.adamw", self.device):
                self.optimizer.update_(
                    grads, AdamWState(opt_state.step[s],
                                      _slot(opt_state.m, s),
                                      _slot(opt_state.v, s)),
                    _slot(params, s))
            losses[s] = metrics["loss"].detach()
            if "lb_loss" in metrics:
                self._lb_losses[s] = metrics["lb_loss"].detach()
            del p, grads, loss, metrics
        return losses

    def _inner_phase(self, params, opt_state, batches, active):
        """Inner steps over pre-stacked (h, k, ...) batches -> (h, k)
        losses on the device."""
        h = batches["tokens"].shape[0]
        return torch.stack([
            self._inner_step(params, opt_state,
                             {key: v[i] for key, v in batches.items()},
                             active) for i in range(h)])

    def _run_inner_phase(self, batches, active):
        """The inner phase as ``cfg.inner_chunks`` chunks of near-equal
        length (bounds from ``np.linspace``, as the reference). After
        each chunk, one hop of the sync in flight is dispatched. The
        per-step work is the same, so the losses and parameters equal
        those of one chunk bit for bit."""
        h = batches["tokens"].shape[0]
        c = max(1, min(int(self.cfg.inner_chunks), h))
        sec_per_step = self.cfg.seconds_per_outer_step / max(1, h)
        bounds = np.linspace(0, h, c + 1).astype(int)
        losses = []
        self._chunk_s, self._hop_s = [], []
        for ci in range(c):
            lo, hi = int(bounds[ci]), int(bounds[ci + 1])
            if hi == lo:
                continue
            t0 = time.perf_counter()
            losses.append(self._inner_phase(
                self.params, self.opt_state,
                {key: v[lo:hi] for key, v in batches.items()}, active))
            self._sync()
            t1 = time.perf_counter()
            self._chunk_s.append(t1 - t0)
            if self.overlap:
                self.comm_ledger.compute((hi - lo) * sec_per_step)
                if c > 1 and self._inflight is not None \
                        and self._inflight.step():
                    self._dispatch_ledger_hop()
                    self._sync()
                    self._hop_s.append(time.perf_counter() - t1)
        return torch.cat(losses, dim=0)

    def _pipeline(self, slot: int) -> TokenPipeline:
        if slot not in self._pipelines:
            self._pipelines[slot] = TokenPipeline(self.data_cfg, slot, self.k)
        return self._pipelines[slot]

    def _batches(self, step: int) -> dict:
        bs = [self._pipeline(s).batch_at(step) for s in range(self.k)]
        return {key: torch.stack([b[key] for b in bs]) for key in bs[0]}

    # -- outer loop -----------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _weights_tensor(self, weights) -> torch.Tensor:
        return torch.as_tensor(np.asarray(weights, np.float32),
                               device=self.device)

    def _set_params(self, new_params) -> None:
        """Write the outer step's (stacked, broadcast) parameters into
        every slot, in place."""
        with torch.no_grad(), spans.span("outer.apply", self.device):
            for dst, src in zip(leaves(self.params), leaves(new_params)):
                dst.copy_(src)

    def run(self, n_outer_steps: int, *, inner_steps: int | None = None,
            bandwidth_sampler=None) -> list[dict]:
        h = inner_steps or self.cfg.diloco.inner_steps
        global_step = int(self.outer.outer_step) * h
        for t in range(n_outer_steps):
            # spans (repro_torch.spans) record while a profiler runs
            spans_on = spans.follow_profiler()
            plan = self.sim.begin_outer_step(t)
            # a participant of the sync in flight left: the partial
            # reduction is torn; re-reduce over the survivors BEFORE the
            # dead node's slot is released (its slot zeroes its weight)
            fallback_rec = None
            if self._inflight is not None and plan.get("sync_torn"):
                fallback_rec = self._fallback_resync(plan)
            self._sync_membership(plan)
            active = self.slots.live_mask(plan["live"])

            if self.batch_provider is not None:
                batches = self.batch_provider(global_step, h, self.k)
            else:
                per_step = [self._batches(global_step + i) for i in range(h)]
                batches = {key: torch.stack([b[key] for b in per_step])
                           for key in per_step[0]}
            batches = {key: torch.as_tensor(v).to(self.device)
                       for key, v in batches.items()}
            t0 = time.perf_counter()
            losses = self._run_inner_phase(batches, active)
            t1 = time.perf_counter()
            global_step += h

            # POISON events corrupt the scheduled nodes' contributions
            # after the inner phase, before the sync
            self._apply_poison(plan.get("poison", {}), t)

            # bandwidth-aware ring re-ordering (paper §2.5)
            if bandwidth_sampler is not None:
                self.bw.observe_matrix(bandwidth_sampler(t))
                changed, order = self.bw.maybe_reorder()
                if changed:
                    self.ring_order = order
                    self.reorders += 1

            # re-admitted (probation-complete) nodes re-enter like
            # joiners: zero weight for their first round
            weights = self.slots.live_mask(
                plan["live"],
                zero_weight_ids=plan["joined"] + plan["stragglers"]
                + list(plan.get("readmitted", ())))

            adm_report = None
            if self.overlap:
                overlap_rec = self._overlapped_boundary(t, weights)
                adm_report = overlap_rec.pop("_report", None)
                attempts = 1
            elif self._validation_on():
                overlap_rec = None
                adm_report = self._validated_outer_sync(t, weights)
                attempts = 1
            else:
                overlap_rec = None

                def attempt(live_set):
                    w = np.array(weights)
                    for nid, slot in self.slots.slot_of.items():
                        if nid not in live_set:
                            w[slot] = 0.0
                    return self._outer_sync(self._weights_tensor(w))

                (new_params, self.outer), _, attempts = \
                    self.retry.run_collective(attempt, plan["live"])
                self._set_params(new_params)
                del new_params
            self._sync()
            t2 = time.perf_counter()
            span_rec = spans.collect() if spans_on else None

            live_w = np.asarray(weights) > 0
            mask = torch.as_tensor(live_w, device=self.device)
            mean_loss = (float(losses[-1][mask].mean()) if live_w.any()
                         else float("nan"))
            rec = {"outer_step": t, "live": plan["live"],
                   "joined": plan["joined"], "left": plan["left"],
                   "loss": mean_loss, "ring_order": self.ring_order,
                   "attempts": attempts,
                   "wire_bytes": dl.sync_wire_bytes(
                       _slot(self.params, 0), max(1, int(live_w.sum())),
                       self.cfg.diloco),
                   "inner_s": t1 - t0, "sync_s": t2 - t1,
                   "inner_chunk_s": self._chunk_s,
                   "inner_hop_s": self._hop_s}
            if span_rec is not None:
                rec["spans"] = span_rec
            if self.model.cfg.moe is not None:
                # the last inner step's load-balance loss, beside its loss
                rec["lb_loss"] = (float(self._lb_losses[mask].mean())
                                  if live_w.any() else float("nan"))
            if overlap_rec is not None:
                rec["overlap"] = overlap_rec
            if adm_report is not None:
                rec["admission"] = {
                    "accepted": adm_report.accepted,
                    "flagged": {s: list(r) for s, r in
                                adm_report.flagged.items()},
                    "quarantined": list(adm_report.quarantined_nodes)}
            if fallback_rec is not None:
                rec["sync_fallback"] = fallback_rec
            # a streamed recovery that completed during this inner phase
            # is adopted HERE: the fetch ran under compute, admission
            # costs one restore
            join_rec = self.poll_stream_join()
            if join_rec is not None:
                rec["stream_join"] = join_rec
            if self.boundary_hook is not None:
                hook_rec = self.boundary_hook(t, self)
                if hook_rec:
                    rec["boundary_hook"] = hook_rec
            self.history.append(rec)

            if self.cfg.ckpt_dir and \
                    (t + 1) % self.cfg.ckpt_every_outer == 0:
                self._checkpoint(global_step, t + 1)
        # drain: the last boundary's sync is still in flight; apply it
        # so the returned anchor includes the final phase's progress
        if self._inflight is not None:
            t0 = time.perf_counter()
            self._drain_hops(self._inflight)
            self.history[-1].setdefault("overlap", {})["drain"] = \
                self.comm_ledger.finish_sync()
            new_params, self.outer = dl.finish_outer_sync_sim(
                self._inflight, self.params, self.outer)
            self._set_params(new_params)
            del new_params
            self._inflight = None
            self.sim.note_sync_end()
            self._sync()
            self.history[-1]["drain_s"] = time.perf_counter() - t0
        if self.snapshotter is not None:
            self.snapshotter.flush()
        return self.history

    # -- checkpoints and live recovery ----------------------------------------

    def _checkpoint(self, global_step: int, outer_step: int) -> None:
        tree = self.checkpoint_like()
        meta = {"outer_step": outer_step}
        if self.snapshotter is None:
            from repro_torch.checkpointing import save_async
            save_async(self.cfg.ckpt_dir, global_step, tree, meta)
            return
        self.snapshotter.submit(global_step, tree, meta)
        self._ckpt_steps.append(global_step)
        keep = self.cfg.ckpt_keep
        if keep and len(self._ckpt_steps) > keep:
            # the keep set is computed when the task RUNS (FIFO behind
            # every pending persist), from what is on disk by then
            self.snapshotter.submit_task(
                lambda: self.ckpt_store.gc(
                    keep_steps=tuple(self.persisted_steps[-keep:])))

    def begin_stream_join(self, peers, *, store_root=None,
                          step: int | None = None,
                          range_chunks: int = 8, timeout: float = 20.0):
        """Start an overlapped streaming recovery from ``peers`` on a
        background thread (paper §2.4.2). The fetch gossips chunk
        availability, streams the manifest chain into this node's store
        and replays the delta chain on this trainer's device as it
        lands; ``run()`` adopts the result at the first outer boundary
        where it is ready. Returns the fetcher."""
        assert self._stream_join is None or self._stream_join.done, \
            "a streaming join is already in flight"
        from repro_torch.checkpointing import ChunkStore, StreamingFetcher
        # an explicit store_root wins (a joiner in the same process as
        # the cluster streams into its OWN store); a real joiner
        # defaults to its configured chunk store
        if store_root is not None:
            store = ChunkStore(store_root)
        else:
            store = self.ckpt_store
            assert store is not None, \
                "streaming join needs a chunk store: configure " \
                "ckpt_engine store|delta or pass store_root"
        self._stream_join = StreamingFetcher(
            peers, store, self.checkpoint_like(), step=step,
            range_chunks=range_chunks, timeout=timeout,
            device=self.device).start()
        return self._stream_join

    def poll_stream_join(self) -> dict | None:
        """Non-blocking: adopt a finished streaming recovery (called at
        every outer boundary by ``run()``). Returns the admission record,
        a failure record, or None while still streaming."""
        f = self._stream_join
        if f is None or not f.done:
            return None
        self._stream_join = None
        if f.failed:
            f.close()
            return {"admitted": False, "error": str(f.error),
                    "stats": f.stats()}
        tree, meta, stats = f.result()
        self.adopt_checkpoint(tree, meta)
        f.close()
        return {"admitted": True, "step": stats["step"],
                "outer_step": meta.get("outer_step"), "stats": stats}

    def checkpoint_like(self) -> dict:
        """The tree ``run()`` checkpoints (slot 0's parameters, the outer
        momentum, the anchor; views of the live state): the template of
        every restore."""
        return {"params": _slot(self.params, 0),
                "outer_momentum": self.outer.opt.momentum,
                "anchor": self.outer.anchor}

    def serve_checkpoints(self, port: int = 0):
        """Expose this node's chunk store to joining peers."""
        from repro_torch.checkpointing import ChunkPeer
        assert self.ckpt_store is not None, \
            "serve_checkpoints requires ckpt_engine 'store' or 'delta'"
        return ChunkPeer(self.ckpt_store, port=port)

    def adopt_checkpoint(self, tree, meta: dict) -> None:
        """Enter at the next outer boundary from a recovered checkpoint:
        the anchor (a new flat buffer) and outer momentum are replaced,
        every slot's parameters are reset to the recovered ones and
        every slot's AdamW state to a fresh one."""
        eng = SyncEngine.for_tree(_slot(self.params, 0))
        on_dev = lambda t: tree_map(
            lambda x: torch.as_tensor(x).to(self.device), t)
        f32 = torch.float32
        a_flat = eng.flatten(on_dev(tree["anchor"]))
        m_flat = eng.flatten(on_dev(tree["outer_momentum"]))
        self.outer = self.outer._replace(
            anchor=eng.unflatten(a_flat, dtype=f32),
            opt=self.outer.opt._replace(
                momentum=eng.unflatten(m_flat, dtype=f32)),
            outer_step=int(meta.get("outer_step", 0)),
            anchor_flat=a_flat)
        with torch.no_grad():
            for dst, src in zip(leaves(self.params),
                                leaves(on_dev(tree["params"]))):
                dst.copy_(src)       # broadcast over the slots
            self.opt_state.step.zero_()
            for m in leaves(self.opt_state.m) + leaves(self.opt_state.v):
                m.zero_()
        self._sync()

    def _quarantined_slots(self) -> list[int]:
        return sorted(self.slots.slot_of[nid]
                      for nid in self.sim.quarantined_ids()
                      if nid in self.slots.slot_of)

    def _ring_for_sync(self) -> tuple[int, ...]:
        """Quarantine-aware ring order: quarantined slots move to the
        tail (zero-weighted rows do not sit between healthy peers)."""
        order = tuple(self.ring_order[: self.k])
        q = self._quarantined_slots()
        return topology.exclude_slots(order, q) if q else order

    def _begin_sync(self, weights, ef_slot: int) -> dl.OuterSyncHandle:
        """Stage the outer sync: through the distributed backend when
        one is plugged in, the simulator ring otherwise (same handle
        surface either way)."""
        if self.sync_backend is not None:
            return self.sync_backend.begin(
                self.params, self.outer, self.cfg.diloco,
                ring_order=self._ring_for_sync(), weights=weights,
                ef_slot=ef_slot)
        return dl.begin_outer_sync_sim(
            self.params, self.outer, self.cfg.diloco,
            ring_order=self._ring_for_sync(), weights=weights,
            ef_slot=ef_slot)

    def _outer_sync(self, weights):
        if self.sync_backend is not None:
            # non-overlapped path through the distributed ring: begin +
            # immediate finish (the EF residual is slot-free here)
            h = self._begin_sync(weights, ef_slot=0)
            return dl.finish_outer_sync_sim(h, self.params, self.outer)
        return dl.outer_sync_sim(self.params, self.outer, self.cfg.diloco,
                                 ring_order=self._ring_for_sync(),
                                 weights=weights)

    # -- contribution admission (untrusted-contributor defense) ---------------

    def _validation_on(self) -> bool:
        v = self.cfg.validation
        return v is not None and v.enabled

    def _apply_poison(self, poison: dict, t: int) -> None:
        """Corrupt the scheduled LIVE nodes' post-phase params in
        pseudo-gradient space (``p' = a - poison(a - p)``), as a faulty
        peer would, seeded per (node, step) with the reference's numpy
        generator, so the values equal the reference's. On the host:
        one round trip of the anchor and of each poisoned slot."""
        if not poison:
            return
        eng = SyncEngine.for_tree(_slot(self.params, 0))
        a_np = self.outer.anchor_flat.cpu().numpy()
        live = set(self.sim.hb.live_ids())
        for nid in sorted(poison):
            slot = self.slots.slot_of.get(nid)
            if nid not in live or slot is None:
                # quarantined/dead nodes have no contribution to spoil
                continue
            p_np = eng.flatten(_slot(self.params, slot)).cpu().numpy()
            rng = np.random.default_rng([nid, t])
            bad = vd.poison_pseudograd(a_np - p_np, poison[nid], rng)
            new_p = eng.unflatten(
                torch.from_numpy(a_np - bad).to(self.device))
            with torch.no_grad():
                for dst, src in zip(leaves(self.params), leaves(new_p)):
                    dst[slot].copy_(src)

    def _admission_check(self, handle: dl.OuterSyncHandle,
                         t: int) -> vd.AdmissionReport:
        """Judge the staged pseudo-gradients BEFORE any reduced value is
        applied; quarantine flagged contributors and feed the accepted
        rows back into the cross-step statistics."""
        report = vd.validate_pseudograds(
            handle.op.xs, handle.weights, handle.norm_sideband(),
            self._adm_stats, self.cfg.validation)
        slot_node = {slot: nid for nid, slot in self.slots.slot_of.items()}
        for slot in sorted(report.flagged):
            nid = slot_node.get(slot)
            if nid is not None and self.sim.record_violation(
                    nid, t, report.flagged[slot]):
                report.quarantined_nodes.append(nid)
        self.sim.record_clean(
            [slot_node[s] for s in report.accepted if s in slot_node])
        self._adm_stats.update(report)
        if report.sanitize:
            self.quarantine_events.append({
                "outer_step": t,
                "flagged": {s: list(r) for s, r in report.flagged.items()},
                "bad_chunks": {s: list(c)
                               for s, c in report.bad_chunks.items()},
                "quarantined": list(report.quarantined_nodes)})
        return report

    def _resync_sanitized(self, h: dl.OuterSyncHandle, report) -> None:
        """Sanitize the flagged rows and re-reduce over the clean
        survivors, applied to the handle's own anchor snapshot. The
        staged accumulators absorbed the raw rows, so they are never
        finished."""
        h.sanitize(report.sanitize)
        w2 = h.weights.clone()
        w2[[s for s in report.sanitize if s < len(w2)]] = 0.0
        new_params, self.outer = dl.resync_outer_sim(h, self.params,
                                                     self.outer, w2)
        self._set_params(new_params)

    def _validated_outer_sync(self, t: int, weights) -> vd.AdmissionReport:
        """Non-overlapped outer sync behind the admission gates:
        begin -> judge -> (sanitize + restart) or finish."""
        h = self._begin_sync(self._weights_tensor(weights), ef_slot=0)
        report = self._admission_check(h, t)
        if report.sanitize:
            self._resync_sanitized(h, report)
        else:
            new_params, self.outer = dl.finish_outer_sync_sim(
                h, self.params, self.outer)
            self._set_params(new_params)
        return report

    # -- teardown -------------------------------------------------------------

    def close(self, discard: bool = False) -> dict | None:
        """Tear down any sync in flight. ``discard=False`` drains and
        applies it; ``discard=True`` aborts it (the partial reduction is
        dropped and the handle raises ``SyncAbortedError`` on any
        further use). Pending async snapshots are flushed either way."""
        h, self._inflight = self._inflight, None
        rec = None
        if h is not None and not h.aborted:
            if discard:
                h.abort()
                rec = {"discarded": True,
                       "ledger": self.comm_ledger.tear_sync(resync_hops=0)}
            else:
                self._drain_hops(h)
                rec = {"discarded": False,
                       "ledger": self.comm_ledger.finish_sync()}
                new_params, self.outer = dl.finish_outer_sync_sim(
                    h, self.params, self.outer)
                self._set_params(new_params)
            self.sim.note_sync_end()
        if self.snapshotter is not None:
            self.snapshotter.flush()
        return rec

    def __enter__(self) -> "ElasticTrainer":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        # an exception mid-overlap leaves the reduction torn: discard it;
        # on a clean exit the sync in flight drains and applies
        self.close(discard=exc_type is not None)
        return False

    # -- overlapped outer sync (diloco.overlap == 'delayed') ------------------

    def _link_rate(self) -> float:
        """Bytes/s of the slowest link on the current ring (the
        BandwidthMonitor's EWMA), or the modeled link until every ring
        edge has an observation."""
        bn = self.bw.ring_bottleneck(self.ring_order[: self.k])
        if bn is None or bn <= 0:
            return self.cfg.sync_link_bytes_per_s
        return bn * self.cfg.link_bytes_per_gbps

    def _hop_seconds(self, weights) -> float:
        """Modeled wire time of ONE live ring hop of the n_live ring."""
        n_live = max(1, int(np.sum(np.asarray(weights) > 0)))
        numel = sum(l[0].numel() for l in leaves(self.params))
        ring = self.cfg.diloco.ring
        per_hop = rr.ring_hop_bytes(numel, n_live, quant=ring.quant,
                                    buckets=ring.buckets)
        return per_hop / self._link_rate()

    def _dispatch_ledger_hop(self) -> None:
        """Charge one dispatched hop to the ledger; hops past the live
        ring's 2(n_live-1) are charged 0 s."""
        if self._window_hop_i < self._live_hops:
            self.comm_ledger.dispatch_hop()
        else:
            self.comm_ledger.dispatch_hop(seconds=0.0)
        self._window_hop_i += 1

    def _participants(self, weights) -> frozenset:
        w = np.asarray(weights)
        return frozenset(nid for nid, slot in self.slots.slot_of.items()
                         if slot < len(w) and w[slot] > 0)

    def _overlapped_boundary(self, t: int, weights) -> dict:
        """Boundary protocol of the delayed overlap (paper §2.2):

          1. stage THIS phase's pseudo-gradients against the current
             anchor (begin before finish, so they never see the
             about-to-land update), and judge them;
          2. drain + apply the PREVIOUS boundary's reduction;
          3. dispatch the new sync's first hop, so its transfer hides
             under the next inner phase from the start.
        """
        h_new = self._begin_sync(self._weights_tensor(weights),
                                 ef_slot=self._ef_begins % 2)
        self._ef_begins += 1
        # admission runs on the staged rows before any hop is dispatched
        report = (self._admission_check(h_new, t)
                  if self._validation_on() else None)
        rec: dict = {"hops": h_new.hops_total, "_report": report}
        prev = self._inflight
        if prev is not None:
            self._drain_hops(prev)
            rec["prev"] = self.comm_ledger.finish_sync()
            new_params, self.outer = dl.finish_outer_sync_sim(
                prev, self.params, self.outer)
            self._set_params(new_params)
            self._inflight = prev = None
            del new_params
        else:
            # first boundary: reset every worker to the (unchanged)
            # anchor; this phase's progress lands at the next boundary
            self._reset_to_anchor()
        if report is not None and report.sanitize:
            # rejected population: apply this boundary's sync now as a
            # synchronous re-reduce over the clean survivors; all of it
            # is exposed comm, charged like a torn sync
            self._resync_sanitized(h_new, report)
            self.comm_ledger.begin_sync(self._hop_seconds(weights))
            rec["rejected"] = self.comm_ledger.tear_sync(
                resync_hops=h_new.hops_total)
            return rec
        self.sim.note_sync_begin(t, self._participants(weights))
        self._inflight = h_new
        self.comm_ledger.begin_sync(self._hop_seconds(weights))
        n_live = max(1, int(np.sum(np.asarray(weights) > 0)))
        self._live_hops = 2 * (n_live - 1)
        self._window_hop_i = 0
        if h_new.step():
            self._dispatch_ledger_hop()
        return rec

    def _fallback_resync(self, plan) -> dict:
        """A participant of the sync in flight left: discard the torn
        partial reduction and re-reduce the retained pseudo-gradients
        with the dead workers' weights zeroed. ``hops_done`` (not in the
        reference's record) is how many hops the torn ring had
        dispatched."""
        h = self._inflight
        self._inflight = None
        self.sim.note_sync_end()
        hops_done = h.hops_done
        w = h.weights.clone()
        for nid in plan["sync_torn"]:
            slot = self.slots.slot_of.get(nid)
            if slot is not None and slot < len(w):
                w[slot] = 0.0
        new_params, self.outer = dl.resync_outer_sim(h, self.params,
                                                     self.outer, w)
        self._set_params(new_params)
        led = self.comm_ledger.tear_sync(resync_hops=h.hops_total)
        return {"torn_by": list(plan["sync_torn"]),
                "resync_hops": h.hops_total, "ledger": led,
                "hops_done": hops_done}

    def _drain_hops(self, handle: dl.OuterSyncHandle) -> None:
        """Dispatch every remaining hop of ``handle`` (exposed comm:
        the boundary waits on the wire)."""
        while handle.step():
            self._dispatch_ledger_hop()

    def _reset_to_anchor(self) -> None:
        with torch.no_grad():
            for dst, a in zip(leaves(self.params),
                              leaves(self.outer.anchor)):
                dst.copy_(a)

    def _sync_membership(self, plan) -> list[int]:
        """Release the nodes that left; assign every live node a slot. A
        joiner takes the anchor and a fresh AdamW state (step 0, zero
        moments) in its slot only."""
        for nid in plan["left"]:
            self.slots.release(nid)
        slots = []
        for nid in plan["live"]:
            slot = self.slots.assign(nid)
            slots.append(slot)
            if nid in plan["joined"]:
                with torch.no_grad():
                    for dst, a in zip(leaves(self.params),
                                      leaves(self.outer.anchor)):
                        dst[slot].copy_(a)
                    self.opt_state.step[slot] = 0
                    for m in leaves(self.opt_state.m) + \
                            leaves(self.opt_state.v):
                        m[slot].zero_()
        return slots
