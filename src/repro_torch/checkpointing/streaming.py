"""Overlapped streaming checkpoint recovery (port of
``repro.checkpointing.streaming``; paper §2.4.2: joiners
recover WHILE the cluster trains, so elastic churn costs almost no
utilization; SWARM Parallelism overlaps communication with compute the
same way).

``StreamingFetcher`` runs the whole joiner recovery on a background
thread while the trainer's inner phase computes:

    INIT ──start()──▶ DISCOVER ──▶ STREAM ──▶ READY
                          │            │
                          ╰────────────┴─────▶ FAILED

* **DISCOVER** — gossip-poll the peers (``ChunkGossip``), pick the
  newest step any live peer holds (or the pinned ``step``), pull the
  manifest chain with holder failover;
* **STREAM** — possession-aware ``swarm_fetch`` rounds: ranges are
  assigned only to peers gossip says hold them, chunks arrive in
  manifest (chain) order and the ``ChainReplayer`` assembles the
  reconstruction incrementally, on the fetcher's ``device``, as each
  chain step completes — delta
  replay is hidden under the transfer, not a lump at the end. Between
  rounds (a peer died / a range went unservable) gossip re-polls, so
  peers that joined or recovered mid-stream start serving immediately;
* **READY** — every chunk verified + replayed; ``result()`` hands the
  bit-exact tree to the trainer, which admits the joiner at the next
  outer boundary (``ElasticTrainer.poll_stream_join``).

Overlap accounting: ``stats()`` reports ``fetch_seconds`` (wall time
DISCOVER→READY) and the trainer records how much of it was hidden
under compute — the benchmark's overlap ratio.
"""
from __future__ import annotations

import pathlib
import threading
import time
from typing import Any, Sequence

from repro_torch.checkpointing import delta as _delta
from repro_torch.checkpointing.gossip import ChunkGossip
from repro_torch.checkpointing.p2p import (FetchError, PeerConn,
                                     RetryDeadlineError)
from repro_torch.checkpointing.store import ChunkStore, chunk_ids
from repro_torch.checkpointing.swarm import (NoPeersError, SwarmFetchError,
                                       _manifest_chain_any, swarm_fetch)

Addr = tuple


class StreamingFetcher:
    """Background joiner recovery: gossip + streamed chunks + chain
    assembly, overlapped with whatever the caller computes meanwhile."""

    def __init__(self, peers: Sequence[Addr],
                 store: ChunkStore | str | pathlib.Path, like: Any, *,
                 step: int | None = None, range_chunks: int = 8,
                 timeout: float = 20.0, max_rounds: int = 8,
                 round_wait: float = 0.05,
                 max_elapsed_s: float | None = None,
                 gossip: ChunkGossip | None = None, device="cuda"):
        self.store = store if isinstance(store, ChunkStore) \
            else ChunkStore(store)
        self.like = like
        self.device = device
        self.step = step
        self._step_pinned = step is not None   # caller chose the step
        self.range_chunks = range_chunks
        self.timeout = timeout
        self.max_rounds = max_rounds
        self.round_wait = round_wait
        # total wall-clock budget for the whole recovery (None =
        # unbounded): retry rounds under churn back off repeatedly, so
        # without a deadline a joiner can spin far past the point where
        # re-fetching from scratch would be cheaper
        self.max_elapsed_s = max_elapsed_s
        self._deadline: float | None = None
        self.gossip = gossip or ChunkGossip(peers, timeout=timeout)
        for addr in peers:
            self.gossip.add_peer(addr)
        self.state = "init"
        self.error: Exception | None = None
        self._ready = threading.Event()
        self._result: tuple[Any, dict] | None = None
        self._fetch_stats: dict = {}
        self._replayer: _delta.ChainReplayer | None = None
        self._thread: threading.Thread | None = None
        self._t0 = self._t_ready = None
        self._rounds = 0

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "StreamingFetcher":
        assert self._thread is None, "fetcher already started"
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _check_deadline(self, last: Exception | None = None) -> None:
        """Raise :class:`RetryDeadlineError` once the total recovery
        budget is spent (checked before every between-round backoff)."""
        if self._deadline is not None and \
                time.monotonic() > self._deadline:
            raise RetryDeadlineError(
                f"streaming recovery budget {self.max_elapsed_s}s "
                f"exhausted in state {self.state!r} "
                f"(round {self._rounds})") from last

    def _run(self) -> None:
        self._t0 = time.perf_counter()
        if self.max_elapsed_s is not None:
            self._deadline = time.monotonic() + self.max_elapsed_s
        try:
            chain = self._discover()
            self._stream(chain)
            self._t_ready = time.perf_counter()
            self.state = "ready"
        except Exception as e:   # surfaced via result()/wait_ready()
            self.error = e
            self.state = "failed"
        finally:
            self._ready.set()

    def _discover(self) -> list[dict]:
        self.state = "discover"
        step = self.step
        for attempt in range(self.max_rounds):
            self.gossip.poll_once()
            if step is None:
                step = self.gossip.latest_step()
            if step is not None:
                break
            self._check_deadline()
            time.sleep(self.round_wait * (attempt + 1))
        if step is None:
            raise NoPeersError("no live peer holds a checkpoint")
        self.step = step
        failures: dict = {}
        conns = []
        for addr in self.gossip.live_peers():
            try:
                conns.append(PeerConn(addr, self.timeout))
            except OSError as e:
                failures[tuple(addr)] = f"connect: {e}"
        try:
            holders = [c for c in conns]
            chain = _manifest_chain_any(holders, step, failures)
        finally:
            for c in conns:
                c.close()
        return chain

    def _set_chain(self, chain: list[dict], pin_token) -> dict:
        """(Re)build the replayer for ``chain`` and pin its chunk ids
        in the LOCAL store: when the joiner streams into its own live
        store (a trainer that is also checkpointing + running
        retention gc), in-flight streamed chunks must not be collected
        out from under the replay."""
        if pin_token is not None:
            self.store.unpin(pin_token)
        ids: dict[str, None] = {}
        for m in chain:
            for d in chunk_ids(m):
                ids.setdefault(d, None)
        token = self.store.pin_ids(list(ids))
        self._replayer = _delta.ChainReplayer(self.store, chain,
                                              self.device)
        # everything already local (rejoiner dedup) replays immediately
        self._replayer.advance()
        return token

    def _stream(self, chain: list[dict]) -> None:
        self.state = "stream"
        pin = self._set_chain(chain, None)
        last: Exception | None = None
        try:
            for rnd in range(self.max_rounds):
                self._rounds = rnd + 1
                peers = self.gossip.live_peers()
                if not peers:
                    raise SwarmFetchError(
                        f"no live peers left after round {rnd}: {last}")
                try:
                    st = swarm_fetch(
                        peers, self.store, step=self.step,
                        range_chunks=self.range_chunks,
                        timeout=self.timeout,
                        possession=self.gossip.possession,
                        progress=self._replayer.on_chunk)
                    self._merge_stats(st)
                    break
                except (FetchError, OSError) as e:
                    last = e
                    # the store kept everything that landed; re-gossip
                    # so recovered/new peers serve the remainder next
                    # round
                    if isinstance(e, SwarmFetchError) and e.failures:
                        self._merge_failures(e.failures)
                    self._check_deadline(last)
                    time.sleep(self.round_wait)
                    self.gossip.poll_once()
                    # if the caller didn't pin a step and ours
                    # vanished from the swarm (serving-side retention
                    # advanced during a slow fetch), re-target the
                    # newest step instead of failing all rounds on a
                    # checkpoint nobody can serve anymore — everything
                    # already streamed dedups into the new chain
                    if not self._step_pinned:
                        latest = self.gossip.latest_step()
                        if latest is not None and latest != self.step:
                            try:
                                self.step = latest
                                pin = self._set_chain(
                                    self._discover(), pin)
                            except (FetchError, OSError) as e2:
                                last = e2
                            finally:
                                self.state = "stream"
            else:
                raise SwarmFetchError(
                    f"streaming fetch failed after {self.max_rounds} "
                    f"rounds: {last}") from last
            # the replay ran under the transfer; anything left (e.g.
            # chunks that were already local mid-chain) completes here
            self._replayer.advance()
            self._result = self._replayer.finish(self.like)
        finally:
            self.store.unpin(pin)

    def _merge_stats(self, st: dict) -> None:
        f = self._fetch_stats
        f["step"] = st["step"]
        for k in ("chunks_fetched", "bytes_fetched",
                  "reassigned_ranges"):
            f[k] = f.get(k, 0) + st[k]
        per = f.setdefault("per_peer", {})
        for name, n in st["per_peer"].items():
            per[name] = per.get(name, 0) + n
        f.setdefault("dead_peers", []).extend(st["dead_peers"])

    def _merge_failures(self, failures: dict) -> None:
        dead = self._fetch_stats.setdefault("dead_peers", [])
        for addr in failures:
            name = f"{addr[0]}:{addr[1]}" if isinstance(addr, tuple) \
                else str(addr)
            if name not in dead:
                dead.append(name)

    # -- consumer side -------------------------------------------------------

    @property
    def ready(self) -> bool:
        return self.state == "ready"

    @property
    def failed(self) -> bool:
        return self.state == "failed"

    @property
    def done(self) -> bool:
        return self._ready.is_set()

    def wait_ready(self, timeout: float | None = None) -> dict:
        """Block until READY/FAILED; returns :meth:`stats`. Raises the
        recovery error on failure, ``TimeoutError`` on timeout."""
        if not self._ready.wait(timeout):
            raise TimeoutError(
                f"streaming recovery still {self.state} after "
                f"{timeout}s")
        if self.error is not None:
            raise self.error
        return self.stats()

    def result(self) -> tuple[Any, dict, dict]:
        """(tree, meta, stats) once READY (call after wait_ready /
        polling ``ready``)."""
        if self.error is not None:
            raise self.error
        assert self._result is not None, \
            f"recovery not ready (state={self.state})"
        tree, meta = self._result
        return tree, meta, self.stats()

    def stats(self) -> dict:
        rp = self._replayer
        out = dict(self._fetch_stats)
        out.update({
            "state": self.state,
            "rounds": self._rounds,
            # perf_counter anchors so a caller can intersect the fetch
            # window with its own compute window (overlap accounting)
            "t_start": self._t0,
            "t_ready": self._t_ready,
            "fetch_seconds": (
                (self._t_ready or time.perf_counter()) - self._t0
                if self._t0 is not None else 0.0),
            "gossip": dict(self.gossip.stats),
            "replayed_steps": rp.stats["replayed_steps"] if rp else 0,
            "replayed_on_stream":
                rp.stats["replayed_on_stream"] if rp else 0,
        })
        return out

    def close(self) -> None:
        self.gossip.stop()
