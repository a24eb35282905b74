"""Swarm P2P checkpoint fetch over the chunk store (port of
``repro.checkpointing.swarm``; host code but for ``recover``'s replay;
paper §2.4.2 +
SWARM Parallelism: stripe transfers across unreliable peers and
rebalance when one dies).

A joining node needs the latest checkpoint but no central storage
exists — only other training peers, each running a ``ChunkPeer`` next
to its ``ChunkStore``. ``swarm_fetch``:

  1. asks every peer for its latest step and targets the newest;
  2. pulls the manifest chain (base + deltas) from any holder;
  3. dedups against the local store (a rejoining node only fetches
     what changed since it left);
  4. splits the missing chunk ids into contiguous ranges on a shared
     work queue and downloads them from the live peers in parallel —
     each range is served by exactly one peer (disjoint striping).
     With a gossip ``possession`` map, a range is only ever handed to
     a peer that actually HOLDS all its chunks (peers are partial
     replicas, not full mirrors) and ranges are scheduled
     RAREST-FIRST (fewest holders lead the queue) so scarce chunks
     don't wait behind well-replicated ones and overlap-joins spread
     across the swarm; without one, the legacy every-peer-has-all
     assumption applies in manifest order;
  5. verifies every chunk by its content address on arrival;
  6. when a peer dies mid-transfer (connection drop, bad bytes,
     missing chunk), re-queues that peer's unfinished range so the
     surviving HOLDERS pick it up; the fetch fails only when no live
     peer can serve a still-missing range.

Protocol: length-prefixed sha256-checked frames (same framing as
``p2p``). Requests are JSON; chunk payloads are the store's deflated
blobs, verified end-to-end by chunk id after inflation. Gossip ops
(``digest`` / ``inventory`` / ``have``) ride the same connection — see
``gossip.py``.
"""
from __future__ import annotations

import collections
import json
import pathlib
import socket
import threading
import time
from typing import Callable, Sequence

from repro_torch.checkpointing import delta as _delta
from repro_torch.checkpointing.p2p import (FetchError, PeerConn, PeerConnPool,
                                     RetryPolicy, _recv_frame,
                                     _send_frame, retry_call)
from repro_torch.checkpointing.store import ChunkCorruptError, ChunkStore

Addr = tuple  # (host, port)

# kept importable under the old private name (tests, older callers)
_PeerConn = PeerConn


class SwarmFetchError(FetchError):
    """The swarm fetch could not complete; ``failures`` maps peer
    address -> reason."""

    def __init__(self, msg: str, failures: dict | None = None):
        super().__init__(msg)
        self.failures = failures or {}


class NoPeersError(SwarmFetchError):
    """No reachable peer holds a checkpoint."""


class StepRetiredError(SwarmFetchError):
    """The requested step was DELIBERATELY removed at the source
    (``ChunkStore.retire_step`` tombstone — e.g. a policy version the
    publisher force-expired). Unlike a missing step this is terminal:
    the consumer should move to a newer version, not retry."""


class ChunkPeer:
    """Serves a ``ChunkStore`` to joining peers.

    Request frames (JSON):
      * ``{"op": "latest"}`` -> ``{"step": int|null}``;
      * ``{"op": "manifest", "step": n}`` -> the manifest (or
        ``{"error": "no-such-step"}``); serving a manifest PINS its
        chain in the store until the session closes, so a concurrent
        retention gc can never truncate a checkpoint mid-stream;
      * ``{"op": "chunks", "ids": [...]}`` -> one blob frame per id, in
        order (an empty frame means the peer doesn't hold that chunk);
      * ``{"op": "digest"}`` -> ``{"latest", "n_chunks", "sha",
        "version"}`` — the compact possession summary gossip polls;
      * ``{"op": "inventory"}`` -> ``{"ids": [...]}`` full chunk-id
        list (pulled only when the digest sha changed);
      * ``{"op": "have", "ids": [...]}`` -> ``{"have": [0/1, ...]}``.

    Fault-injection knobs used by the cluster simulator and the
    deterministic fault harness:
      * ``crash_after`` — serve that many chunks, then drop every
        connection and stop accepting (silent mid-transfer crash);
      * ``corrupt_after`` — serve that many good chunks, then ship
        flipped bytes (checksum mismatch at the receiver);
      * ``stall_chunks`` / ``stall_s`` — after ``stall_chunks`` chunks
        sleep ``stall_s`` before EVERY subsequent chunk (a throttled /
        stalling WAN link; also what the overlap benchmark uses to give
        the fetch non-trivial wall time).
    """

    def __init__(self, store: ChunkStore, host: str = "127.0.0.1",
                 port: int = 0, crash_after: int | None = None,
                 corrupt_after: int | None = None,
                 stall_chunks: int | None = None,
                 stall_s: float = 0.0):
        self.store = store
        self.crash_after = crash_after
        self.corrupt_after = corrupt_after
        self.stall_chunks = stall_chunks
        self.stall_s = stall_s
        self.served_chunks = 0
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(8)
        self.port = self._sock.getsockname()[1]
        self.addr = (host, self.port)
        self._stop = threading.Event()
        self._accept = threading.Thread(target=self._serve, daemon=True)
        self._accept.start()

    def _serve(self) -> None:
        self._sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=self._session, args=(conn,),
                             daemon=True).start()

    def _send_chunk(self, conn: socket.socket, digest: str) -> None:
        if self.stall_chunks is not None and \
                self.served_chunks >= self.stall_chunks:
            time.sleep(self.stall_s)
        try:
            blob = self.store.get_blob(digest)
        except KeyError:
            blob = b""
        if self.corrupt_after is not None and \
                self.served_chunks >= self.corrupt_after and blob:
            blob = bytes(b ^ 0xFF for b in blob[:64]) + blob[64:]
        _send_frame(conn, blob)
        self.served_chunks += 1

    def _session(self, conn: socket.socket) -> None:
        pins: list[dict] = []
        try:
            conn.settimeout(10.0)
            # responses are often two frames (see ``PeerConn``)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            while not self._stop.is_set():
                req = json.loads(_recv_frame(conn))
                if not self._handle_op(conn, req, pins):
                    return
        except (FetchError, OSError, json.JSONDecodeError):
            pass
        finally:
            for token in pins:
                self.store.unpin(token)
            conn.close()

    def _handle_op(self, conn: socket.socket, req: dict,
                   pins: list[dict]) -> bool:
        """Dispatch one request frame; returns False to end the
        session (unknown op or injected crash). Subclasses
        (swarm serving's ``StageServer``) extend the op set by
        overriding and delegating unmatched ops here."""
        op = req.get("op")
        if op == "latest":
            _send_frame(conn, json.dumps(
                {"step": self.store.latest_step()}).encode())
        elif op == "manifest":
            # tombstone check FIRST: a retired step must answer
            # "retired" even while its manifest still exists on disk
            # (retire is announced before gc physically removes it)
            if self.store.is_retired(req["step"]):
                _send_frame(conn, json.dumps(
                    {"error": "retired", "step": req["step"]}).encode())
                return True
            try:
                m = self.store.load_manifest(req["step"])
                pins.append(self.store.pin_chain(req["step"]))
                _send_frame(conn, json.dumps(m).encode())
            except FileNotFoundError:
                _send_frame(conn, json.dumps(
                    {"error": "no-such-step"}).encode())
        elif op == "chunks":
            for digest in req["ids"]:
                if self.crash_after is not None and \
                        self.served_chunks >= self.crash_after:
                    self.crash()
                    return False
                self._send_chunk(conn, digest)
        elif op == "digest":
            n, sha = self.store.inventory_digest()
            _send_frame(conn, json.dumps(
                {"latest": self.store.latest_step(),
                 "n_chunks": n, "sha": sha,
                 "version": self.store.version}).encode())
        elif op == "inventory":
            _send_frame(conn, json.dumps(
                {"ids": self.store.inventory()}).encode())
        elif op == "have":
            _send_frame(conn, json.dumps(
                {"have": [int(self.store.has(d))
                          for d in req["ids"]]}).encode())
        else:
            return False
        return True

    def crash(self) -> None:
        """Die silently mid-transfer (fault injection)."""
        self._stop.set()
        self._sock.close()

    def close(self) -> None:
        self._stop.set()
        self._accept.join(timeout=2)
        try:
            self._sock.close()
        except OSError:
            pass


def _manifest_chain(conn: PeerConn, step: int) -> list[dict]:
    """The full manifest chain for ``step`` (base first), fetched from
    one peer."""
    chain = []
    s = step
    while True:
        m = json.loads(conn.request({"op": "manifest", "step": s}))
        if m.get("error") == "retired":
            raise StepRetiredError(
                f"peer {conn.addr} retired step {s}")
        if "error" in m:
            raise SwarmFetchError(
                f"peer {conn.addr} lost step {s} mid-chain")
        if m.get("step") != s:
            raise SwarmFetchError(
                f"peer {conn.addr} served a stale manifest "
                f"({m.get('step')} for requested step {s})")
        chain.append(m)
        if m["kind"] != "delta":
            return chain[::-1]
        s = m["prev_step"]


def _manifest_chain_any(holders: list[PeerConn], step: int,
                        failures: dict) -> list[dict]:
    """Chain fetch with failover: a bad first holder must not abort a
    recovery two healthy holders could serve."""
    last: Exception | None = None
    for c in list(holders):
        try:
            return _manifest_chain(c, step)
        except (FetchError, OSError) as e:
            failures[c.addr] = f"manifest chain: {e}"
            holders.remove(c)
            c.close()
            last = e
    if isinstance(last, StepRetiredError):
        # the step isn't lost, it was withdrawn — surface the typed
        # terminal error instead of a retryable-looking fetch failure
        raise StepRetiredError(str(last), failures)
    raise SwarmFetchError(f"no peer could serve the manifest chain "
                          f"for step {step}: {last}", failures)


def _schedule_ranges(ids: list[str], candidates, range_chunks: int,
                     possession_aware: bool) -> list[list[str]]:
    """Split the missing chunk ids into download ranges.

    Without a possession map: plain manifest-order ranges (legacy
    full-replica assumption). With one: group ids by holder set so
    ranges stay candidate-homogeneous (a partial holder gets ranges
    made ONLY of chunks it has), then schedule RAREST-FIRST — groups
    with the fewest holders lead the queue. Fetching scarce chunks
    first means (a) the single holder of a rare range starts on it
    immediately instead of burning its window on chunks everyone has,
    and (b) the well-replicated remainder is left for the drain phase,
    where every peer qualifies — so concurrent overlap-joins don't all
    pile onto the same (well-known) peer for the scarce tail. Manifest
    order is preserved inside each group (the chain replayer tolerates
    any order; in-order keeps its incremental replay warm).
    """
    if not possession_aware:
        return [ids[i:i + range_chunks]
                for i in range(0, len(ids), range_chunks)]
    groups: dict[frozenset, list[str]] = {}
    for d in ids:
        groups.setdefault(frozenset(candidates([d])), []).append(d)
    rarest = sorted(groups.items(), key=lambda kv: len(kv[0]))
    return [grp[i:i + range_chunks]
            for _, grp in rarest
            for i in range(0, len(grp), range_chunks)]


class _WorkQueue:
    """Shared range queue with per-range candidate tracking.

    Each range carries the set of peers believed (via gossip) to hold
    ALL its chunks; a worker only pops ranges it is a candidate for.
    When a peer dies it is struck from every range's candidate set —
    a range with no candidates left fails the fetch immediately
    instead of hanging (the caller may re-gossip and retry: the store
    keeps whatever already landed)."""

    def __init__(self, ranges: list[list[str]],
                 candidates: Callable[[list[str]], set[Addr]]):
        self.cv = threading.Condition()
        self.pending: collections.deque = collections.deque(
            (batch, candidates(batch)) for batch in ranges)
        self.inflight = 0
        self.dead: set[Addr] = set()
        self.unservable: list[list[str]] = []
        self.aborted = False

    def abort(self) -> None:
        """Fatal consumer-side error (e.g. the progress hook raised):
        wake every worker and make them drain out — the fetch must
        fail typed, never hang on a dead sibling's inflight count."""
        with self.cv:
            self.aborted = True
            self.cv.notify_all()

    def pop(self, addr: Addr):
        """Next range ``addr`` can serve, or None when the queue has
        fully drained (or this peer can serve nothing that's left).
        The scan preserves queue order (no rotation): the scheduler's
        rarest-first ordering survives peers skipping ranges they
        don't hold."""
        with self.cv:
            while True:
                if self.aborted:
                    return None
                i = 0
                while i < len(self.pending):
                    batch, cand = self.pending[i]
                    cand -= self.dead
                    if not cand:
                        del self.pending[i]
                        self.unservable.append(batch)
                        self.cv.notify_all()
                        continue
                    if addr in cand:
                        del self.pending[i]
                        self.inflight += 1
                        return batch
                    i += 1
                if addr in self.dead or self.unservable:
                    return None
                if not self.pending and self.inflight == 0:
                    return None
                # everything left is assigned to others or in flight;
                # an in-flight batch may yet fail and come back to us
                self.cv.wait()

    def done(self) -> None:
        with self.cv:
            self.inflight -= 1
            self.cv.notify_all()

    def requeue(self, batch: list[str], addr: Addr,
                candidates: set[Addr]) -> None:
        """Peer ``addr`` failed mid-range: mark it dead and hand the
        remainder to the surviving candidates."""
        with self.cv:
            self.inflight -= 1
            self.dead.add(addr)
            if batch:
                cand = candidates - self.dead
                if cand:
                    # front of the queue: losing a holder made this
                    # range RARER, so rarest-first puts it next
                    self.pending.appendleft((batch, cand))
                else:
                    self.unservable.append(batch)
            self.cv.notify_all()


def swarm_fetch(peers: Sequence[Addr], store: ChunkStore | str,
                *, step: int | None = None, range_chunks: int = 8,
                timeout: float = 20.0,
                possession: dict | None = None,
                progress: Callable[[str, int], None] | None = None,
                pool: PeerConnPool | None = None,
                retry: RetryPolicy | None = None
                ) -> dict:
    """Fetch the newest checkpoint (manifest chain + all missing
    chunks) from ``peers`` into ``store``, striping disjoint chunk
    ranges across every live peer and reassigning on peer death.

    ``possession`` (optional, from ``ChunkGossip.possession``) maps
    peer addr -> set of chunk ids that peer holds; ranges are then only
    assigned to actual holders instead of assuming full replicas. A
    peer absent from the map is assumed full (legacy behavior).
    ``progress(chunk_id, n_bytes)`` fires after each verified chunk
    lands (the streaming assembler's hook).

    ``pool`` (optional ``PeerConnPool``): connections are leased
    instead of opened fresh and returned healthy at the end, so
    repeated fetch rounds (streaming retries, multi-step catch-up)
    stop paying one TCP setup per peer per round. ``retry`` wraps the
    initial per-peer connect in the shared backoff schedule — the only
    idempotent spot worth retrying here (a mid-stream failure already
    reassigns to surviving holders, which IS the retry).

    Returns stats: ``{"step", "chunks_fetched", "bytes_fetched",
    "per_peer", "reassigned_ranges", "dead_peers"}``.
    """
    if isinstance(store, (str, pathlib.Path)):
        store = ChunkStore(store)
    failures: dict[Addr, str] = {}
    conns: list[PeerConn] = []

    def _connect(addr: Addr) -> PeerConn:
        if pool is not None:
            return pool.acquire(addr)
        return PeerConn(addr, timeout)

    for addr in peers:
        try:
            if retry is not None:
                conns.append(retry_call(
                    lambda a=addr: _connect(a), policy=retry))
            else:
                conns.append(_connect(addr))
        except (FetchError, OSError) as e:
            failures[tuple(addr)] = f"connect: {e}"
    try:
        # -- pick the newest step any peer holds -------------------------
        latest: dict[Addr, int] = {}
        for c in list(conns):
            try:
                got = json.loads(c.request({"op": "latest"}))["step"]
            except (FetchError, OSError) as e:
                conns.remove(c)
                c.close()
                if pool is not None:
                    # a pooled conn can be stale (peer restarted since
                    # the last round): one fresh-socket retry before
                    # declaring the peer dead
                    try:
                        c = PeerConn(c.addr, pool.timeout)
                        conns.append(c)
                        got = json.loads(
                            c.request({"op": "latest"}))["step"]
                    except (FetchError, OSError) as e2:
                        if c in conns:
                            conns.remove(c)
                        c.close()
                        failures[c.addr] = f"latest: {e2}"
                        continue
                else:
                    failures[c.addr] = f"latest: {e}"
                    continue
            if got is not None:
                latest[c.addr] = got
        if step is None:
            if not latest:
                raise NoPeersError("no reachable peer holds a "
                                   "checkpoint", failures)
            step = max(latest.values())
        holders = [c for c in conns if latest.get(c.addr, -1) >= step]
        if not holders:
            raise NoPeersError(f"no peer holds step {step}", failures)
        chain = _manifest_chain_any(holders, step, failures)

        # -- dedup against local state, stripe the remainder -------------
        need: dict[str, None] = {}
        for m in chain:
            for d in store.missing(m):
                need.setdefault(d, None)
        ids = list(need)

        # with a possession map, chunks a peer lacks never get routed
        # to it — and a lagging peer (latest < target, or no manifest
        # at all, e.g. a half-synced fellow joiner) still serves the
        # chunks gossip says it holds. A peer the map doesn't cover
        # falls back to the legacy assumption: full replica iff it
        # holds the target step.
        streamers = [c for c in conns
                     if c.addr in latest
                     or (possession is not None
                         and c.addr in possession)]

        def candidates(batch: list[str]) -> set[Addr]:
            out = set()
            for c in streamers:
                if possession is not None and c.addr in possession:
                    held = possession[c.addr]
                    if all(d in held for d in batch):
                        out.add(c.addr)
                elif latest.get(c.addr, -1) >= step:
                    out.add(c.addr)
            return out

        ranges = _schedule_ranges(ids, candidates, range_chunks,
                                  possession is not None)

        queue = _WorkQueue(ranges, candidates)
        lock = threading.Lock()
        stats = {"step": step, "chunks_fetched": 0, "bytes_fetched": 0,
                 "per_peer": {f"{a[0]}:{a[1]}": 0 for a in
                              (c.addr for c in streamers)},
                 "reassigned_ranges": 0, "dead_peers": []}

        fatal: list[BaseException] = []

        def worker(conn: PeerConn) -> None:
            name = f"{conn.addr[0]}:{conn.addr[1]}"
            while True:
                batch = queue.pop(conn.addr)
                if batch is None:
                    return
                done = 0
                try:
                    payload = conn.request({"op": "chunks",
                                            "ids": batch})
                    for i, digest in enumerate(batch):
                        blob = payload if i == 0 else conn.recv_frame()
                        if not blob:
                            raise ChunkCorruptError(
                                f"peer missing chunk {digest[:12]}")
                        store.put_blob(digest, blob)
                        done += 1
                        with lock:
                            stats["chunks_fetched"] += 1
                            stats["bytes_fetched"] += len(blob)
                            stats["per_peer"][name] += 1
                        if progress is not None:
                            # a consumer-side failure (e.g. the chain
                            # replayer rejecting a diverged chain) is
                            # fatal to the whole fetch, not this peer:
                            # abort every worker and re-raise after
                            # join — never leave siblings waiting on
                            # our inflight count
                            try:
                                progress(digest, len(blob))
                            except BaseException as e:
                                with lock:
                                    fatal.append(e)
                                queue.abort()
                                return
                    queue.done()
                except (FetchError, ChunkCorruptError, OSError) as e:
                    rest = batch[done:]
                    with lock:
                        if rest:
                            stats["reassigned_ranges"] += 1
                        failures[conn.addr] = str(e)
                        stats["dead_peers"].append(name)
                    queue.requeue(rest, conn.addr, candidates(rest))
                    return

        threads = [threading.Thread(target=worker, args=(c,),
                                    daemon=True) for c in streamers]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

        if fatal:
            raise fatal[0]

        still_missing = [d for d in ids if not store.has(d)]
        if still_missing:
            raise SwarmFetchError(
                f"{len(still_missing)} chunks unfetched after all "
                f"candidate peers failed", failures)
        # chunks are all present and verified: publish the manifests
        # (base first) so a local restore sees a complete chain
        for m in chain:
            store.write_manifest(m)
        return stats
    finally:
        for c in conns:
            if pool is not None:
                # conns that saw a transport error are in ``failures``
                # — never put those back in rotation
                pool.release(c, healthy=c.addr not in failures)
            else:
                c.close()


def recover(peers: Sequence[Addr], store_root: str | pathlib.Path,
            like, *, step: int | None = None, timeout: float = 20.0,
            device="cuda"):
    """One-call joiner recovery: swarm-fetch into a local store, then
    restore into the structure of ``like`` (a delta chain is replayed on
    ``device``). Returns (tree, meta, fetch_stats)."""
    store = ChunkStore(store_root)
    stats = swarm_fetch(peers, store, step=step, timeout=timeout)
    manifest = store.load_manifest(stats["step"])
    if manifest["kind"] == "delta":
        tree, meta = _delta.restore(store, like, step=stats["step"],
                                    device=device)
    else:
        tree, meta = store.restore_tree(like, step=stats["step"])
    return tree, meta, stats
