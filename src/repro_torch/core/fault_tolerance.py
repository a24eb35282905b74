"""Fault tolerance and dynamic node management (port of
``repro.core.fault_tolerance``; INTELLECT-1 §2.4). Host-only Python,
ported whole and unchanged in behaviour:

  * ``HeartbeatMonitor`` — 2 s heartbeats, 6 s eviction, deathrattle;
  * ``RetryPolicy`` — all-reduce retry excluding failed workers (§2.4.5);
  * ``ClusterSimulator`` — replays join/leave/crash/straggler/poison
    schedules at outer-step boundaries (logical clock), tracks the sync
    in flight, and quarantine with escalating probation;
  * ``CommOverlapLedger`` — logical-time accounting of ring hops hidden
    under chunked inner compute.

Nothing here touches wall-clock time, so plans are deterministic and
equal the reference's on the same schedule.
"""
from __future__ import annotations

import dataclasses
import enum
import warnings
from typing import Callable, Iterable


class NodeState(enum.Enum):
    JOINING = "joining"      # downloading checkpoint (P2P), not yet live
    LIVE = "live"
    LEFT = "left"            # graceful (deathrattle)
    DEAD = "dead"            # evicted by heartbeat timeout
    QUARANTINED = "quarantined"  # admission violation: excluded from the
    #                              sync (zero weight, tail of the ring)
    #                              but still heartbeating; re-admitted on
    #                              probation after N clean outer steps


@dataclasses.dataclass
class Node:
    node_id: int
    state: NodeState = NodeState.JOINING
    last_heartbeat: float = -1.0
    joined_at: float = 0.0
    # -- contribution reputation (untrusted-contributor defense) -----------
    violations: int = 0        # admission checks failed, lifetime
    clean_credits: int = 0     # contributions accepted, lifetime
    quarantines: int = 0       # times quarantined (escalates probation)
    quarantine_steps: int = 0  # outer steps served in CURRENT quarantine

    @property
    def reputation(self) -> float:
        """Accepted fraction of judged contributions in [0, 1]
        (1.0 for a node never judged)."""
        judged = self.violations + self.clean_credits
        return self.clean_credits / judged if judged else 1.0


class HeartbeatMonitor:
    """Paper §2.4.3: 2 s heartbeats, 6 s eviction, deathrattle fast path."""

    def __init__(self, interval: float = 2.0, timeout: float = 6.0):
        assert timeout > interval
        self.interval = interval
        self.timeout = timeout
        self.nodes: dict[int, Node] = {}

    def register(self, node_id: int, now: float) -> Node:
        node = Node(node_id, NodeState.JOINING, last_heartbeat=now,
                    joined_at=now)
        self.nodes[node_id] = node
        return node

    def mark_live(self, node_id: int) -> None:
        self.nodes[node_id].state = NodeState.LIVE

    def heartbeat(self, node_id: int, now: float) -> None:
        n = self.nodes.get(node_id)
        if n is not None and n.state in (NodeState.LIVE, NodeState.JOINING,
                                         NodeState.QUARANTINED):
            n.last_heartbeat = now

    def deathrattle(self, node_id: int) -> None:
        n = self.nodes.get(node_id)
        if n is not None:
            n.state = NodeState.LEFT

    def sweep(self, now: float) -> list[int]:
        """Evict nodes whose heartbeat is older than ``timeout``;
        returns the newly evicted ids."""
        evicted = []
        for n in self.nodes.values():
            if n.state in (NodeState.LIVE, NodeState.JOINING,
                           NodeState.QUARANTINED) and \
                    now - n.last_heartbeat > self.timeout:
                n.state = NodeState.DEAD
                evicted.append(n.node_id)
        return evicted

    def live_ids(self) -> list[int]:
        return sorted(n.node_id for n in self.nodes.values()
                      if n.state == NodeState.LIVE)

    def quarantined_ids(self) -> list[int]:
        return sorted(n.node_id for n in self.nodes.values()
                      if n.state == NodeState.QUARANTINED)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    max_attempts: int = 3

    def run_collective(self, attempt_fn: Callable[[frozenset], object],
                       participants: Iterable[int],
                       failures_by_attempt: Callable[[int, frozenset],
                                                     frozenset] = None):
        """Run ``attempt_fn(live_set)``, excluding nodes that fail
        mid-collective and retrying with the survivors (paper §2.4.5).

        ``failures_by_attempt(attempt, live)`` models which nodes die
        during a given attempt (empty set = success). Returns
        (result, final_live_set, attempts_used)."""
        live = frozenset(participants)
        for attempt in range(self.max_attempts):
            failed = (failures_by_attempt(attempt, live)
                      if failures_by_attempt else frozenset())
            failed = frozenset(failed) & live
            if not failed:
                return attempt_fn(live), live, attempt + 1
            live = live - failed
            if not live:
                break
        raise RuntimeError(
            f"collective failed after {self.max_attempts} attempts")


# -- event-driven cluster simulation ------------------------------------------


class EventKind(enum.Enum):
    JOIN = "join"                  # new node requests onboarding
    LEAVE = "leave"                # graceful deathrattle
    CRASH = "crash"                # heartbeats stop silently
    STRAGGLE = "straggle"          # node too slow for this outer sync
    ANNOUNCE = "announce"          # node intends to join soon: start
    #                                streaming its checkpoint NOW so the
    #                                fetch overlaps the inner phases
    #                                before its JOIN boundary
    STALL = "stall"                # a node's serving link stalls (its
    #                                ChunkPeer stops answering for a
    #                                while); membership is unaffected —
    #                                subscribers throttle/kill the peer
    POISON = "poison"              # node's contribution is corrupted
    #                                this outer step (arg = mode:
    #                                'nan' | 'huge' | 'signflip' |
    #                                'bitflip'); membership unchanged —
    #                                the admission layer must catch it


@dataclasses.dataclass(frozen=True)
class NodeEvent:
    outer_step: int
    kind: EventKind
    node_id: int
    arg: str = ""                  # kind-specific payload (POISON mode)


@dataclasses.dataclass(frozen=True)
class QuarantinePolicy:
    """Quarantine / probation knobs for the contribution-admission
    layer. A violating node is QUARANTINED immediately (zero sync
    weight, tail of the ring); after ``probation_steps`` outer steps of
    quarantine it is re-admitted as a joiner (anchor reset, zero-weight
    first round). Repeat offenders serve escalating probations:
    ``probation_steps * escalation**(quarantines - 1)``, capped at
    ``max_probation_steps``."""

    probation_steps: int = 2
    escalation: float = 2.0
    max_probation_steps: int = 16

    def required_steps(self, quarantines: int) -> int:
        n = self.probation_steps * self.escalation ** max(
            0, quarantines - 1)
        return min(int(n), self.max_probation_steps)


class ClusterSimulator:
    """Replays a membership schedule against an elastic DiLoCo loop.

    The trainer calls ``begin_outer_step``/``end_outer_step``; the
    simulator advances logical time, injects heartbeats for healthy
    nodes, applies scheduled events, and reports the live worker set the
    ring must use for this sync (stragglers excluded for one round)."""

    def __init__(self, initial_nodes: Iterable[int],
                 events: Iterable[NodeEvent] = (),
                 heartbeat: HeartbeatMonitor | None = None,
                 seconds_per_outer_step: float = 60.0,
                 quarantine: QuarantinePolicy | None = None):
        self.hb = heartbeat or HeartbeatMonitor()
        self.events = sorted(events, key=lambda e: e.outer_step)
        self.now = 0.0
        self.dt = seconds_per_outer_step
        self.crashed: set[int] = set()
        self.history: list[tuple[int, tuple[int, ...]]] = []
        # side-effect hooks fired as each event is applied — the
        # recovery tests use these to kill a node's ChunkPeer the
        # moment its CRASH event lands (so a swarm fetch in flight
        # loses that peer mid-transfer)
        self._subscribers: list[Callable[[NodeEvent], None]] = []
        self._inflight_sync: dict | None = None
        self.quarantine = quarantine or QuarantinePolicy()
        # (outer_step, node_id, reasons) of every recorded violation
        self.violations: list[tuple[int, int, tuple[str, ...]]] = []
        for nid in initial_nodes:
            self.hb.register(nid, self.now)
            self.hb.mark_live(nid)

    def subscribe(self, fn: Callable[[NodeEvent], None]) -> None:
        """Call ``fn(event)`` whenever an event is applied. A raising
        subscriber is DROPPED (and warned about) rather than wedging
        the event pump — one faulty observer must not take the
        membership machinery down with it."""
        self._subscribers.append(fn)

    def _notify(self, ev: NodeEvent) -> None:
        for fn in list(self._subscribers):
            try:
                fn(ev)
            except Exception as e:  # noqa: BLE001 — isolation boundary
                try:
                    self._subscribers.remove(fn)
                except ValueError:
                    pass
                warnings.warn(
                    f"ClusterSimulator subscriber {fn!r} raised "
                    f"{type(e).__name__}: {e} — dropped", RuntimeWarning,
                    stacklevel=2)

    # -- contribution admission / quarantine ---------------------------------

    def record_violation(self, node_id: int, outer_step: int,
                         reasons: Iterable[str] = ()) -> bool:
        """The admission layer rejected this node's contribution:
        quarantine it (LIVE nodes only). Returns True iff the node
        transitioned to QUARANTINED."""
        n = self.hb.nodes.get(node_id)
        self.violations.append((outer_step, node_id, tuple(reasons)))
        if n is None or n.state != NodeState.LIVE:
            return False
        n.violations += 1
        n.quarantines += 1
        n.quarantine_steps = 0
        n.state = NodeState.QUARANTINED
        return True

    def record_clean(self, node_ids: Iterable[int]) -> None:
        """The admission layer accepted these nodes' contributions."""
        for nid in node_ids:
            n = self.hb.nodes.get(nid)
            if n is not None and n.state == NodeState.LIVE:
                n.clean_credits += 1

    def quarantined_ids(self) -> list[int]:
        return self.hb.quarantined_ids()

    # -- in-flight overlapped sync -------------------------------------------

    def note_sync_begin(self, outer_step: int,
                        participants: Iterable[int]) -> None:
        """The trainer kicked off an overlapped outer sync at this
        boundary; its ring hops ride under the NEXT inner phase. Until
        ``note_sync_end``, any participant leaving the cluster tears
        the in-flight reduction (reported via ``plan['sync_torn']``)."""
        self._inflight_sync = {"outer_step": outer_step,
                               "nodes": frozenset(participants)}

    def note_sync_end(self) -> None:
        """The in-flight sync was applied (or abandoned)."""
        self._inflight_sync = None

    @property
    def inflight_sync(self) -> dict | None:
        return self._inflight_sync

    def begin_outer_step(self, outer_step: int) -> dict:
        """Apply events for this step; return the sync plan:
        {'live': [...], 'stragglers': [...], 'joined': [...],
        'left': [...], 'announced': [...], 'sync_torn': [...],
        'quarantined': [...], 'readmitted': [...], 'poison': {...}}.

        ``sync_torn`` lists in-flight-sync participants that left the
        cluster at this boundary (crash eviction or graceful leave
        while their pseudo-gradient reduction was still on the wire).
        ``quarantined`` lists nodes serving quarantine THIS step;
        ``readmitted`` lists nodes whose probation completed at this
        boundary (the trainer treats them exactly like joiners: anchor
        reset, zero-weight first round). ``poison`` maps node id ->
        corruption mode the harness injects into that node's
        contribution this step."""
        # -- probation: quarantined nodes serve one step per boundary;
        # completed probations re-admit as joiners
        readmitted = []
        for nid in self.hb.quarantined_ids():
            n = self.hb.nodes[nid]
            n.quarantine_steps += 1
            if n.quarantine_steps >= self.quarantine.required_steps(
                    n.quarantines):
                n.state = NodeState.LIVE
                n.quarantine_steps = 0
                readmitted.append(nid)

        joined, left, stragglers, announced = [], [], [], []
        poison: dict[int, str] = {}
        for ev in self.events:
            if ev.outer_step != outer_step:
                continue
            self._notify(ev)
            if ev.kind in (EventKind.ANNOUNCE, EventKind.STALL):
                # no membership change: ANNOUNCE kicks off a streaming
                # fetch via the subscriber hooks; STALL is a peer-level
                # fault the hooks inject into the serving ChunkPeer
                if ev.kind == EventKind.ANNOUNCE:
                    announced.append(ev.node_id)
            elif ev.kind == EventKind.JOIN:
                self.hb.register(ev.node_id, self.now)
                # joiner downloads a checkpoint P2P, becomes live at THIS
                # boundary with zero pseudo-gradient (paper non-blocking)
                self.hb.mark_live(ev.node_id)
                joined.append(ev.node_id)
            elif ev.kind == EventKind.LEAVE:
                self.hb.deathrattle(ev.node_id)
                left.append(ev.node_id)
            elif ev.kind == EventKind.CRASH:
                self.crashed.add(ev.node_id)
            elif ev.kind == EventKind.STRAGGLE:
                stragglers.append(ev.node_id)
            elif ev.kind == EventKind.POISON:
                poison[ev.node_id] = ev.arg or "nan"

        # advance logical time by one inner phase; crashed nodes stop
        # heartbeating and age out (6 s timeout << 38 min inner phase).
        # Quarantined nodes KEEP heartbeating: they are excluded from
        # the sync, not from the cluster.
        self.now += self.dt
        for nid in self.hb.live_ids() + self.hb.quarantined_ids():
            if nid not in self.crashed:
                self.hb.heartbeat(nid, self.now)
        evicted = self.hb.sweep(self.now)
        left.extend(evicted)

        live = self.hb.live_ids()
        self.history.append((outer_step, tuple(live)))
        torn: list[int] = []
        if self._inflight_sync is not None:
            torn = sorted(self._inflight_sync["nodes"] & set(left))
        return {"live": live,
                "stragglers": [s for s in stragglers if s in live],
                "joined": joined, "left": sorted(set(left)),
                "announced": announced, "sync_torn": torn,
                "quarantined": self.hb.quarantined_ids(),
                "readmitted": [r for r in readmitted
                               if r in live],
                "poison": poison}


# -- logical-time overlap accounting ------------------------------------------


class CommOverlapLedger:
    """Models ring-hop transfers on a WAN link running concurrently
    with (chunked) inner compute, in the simulator's logical time.

    The wire is a serial resource: a dispatched hop starts when the
    link frees up (``max(clock, busy)``) and occupies it for the hop's
    transfer time. Compute windows advance ``clock`` without touching
    the link, so transfers in flight during compute are HIDDEN; at
    ``finish_sync`` whatever the link still owes past the clock is
    EXPOSED stall time (the cluster waits at the boundary). This is the
    quantity the paper's 83–96% compute-utilization figures hide.
    """

    def __init__(self):
        self.clock = 0.0            # logical time consumed by compute
        self.busy_until = 0.0       # when the wire frees up
        self.records: list[dict] = []
        self._cur: dict | None = None

    def begin_sync(self, hop_seconds: float) -> None:
        """A new outer sync's comm window opens (at the boundary).
        ``hop_seconds`` is the default per-hop transfer time; individual
        hops may override it via ``dispatch_hop(seconds=...)``."""
        assert self._cur is None, "previous sync window still open"
        self._cur = {"hop_s": float(hop_seconds), "hops": 0,
                     "charged_s": 0.0, "t_open": self.clock}

    def dispatch_hop(self, n: int = 1, seconds: float | None = None) -> None:
        """``n`` ring hops handed to the wire at the current clock.
        ``seconds`` charges each of these hops its ACTUAL transfer time
        (hop payloads are uneven when bucket sub-chunks don't divide the
        shard, and each hop crosses a different link); None falls back to
        the window's uniform ``hop_seconds``."""
        assert self._cur is not None, "no sync window open"
        hop_s = self._cur["hop_s"] if seconds is None else float(seconds)
        for _ in range(n):
            self.busy_until = max(self.busy_until, self.clock) + hop_s
            self._cur["hops"] += 1
            self._cur["charged_s"] += hop_s

    def compute(self, seconds: float) -> None:
        """A compute window (inner-phase scan chunk) ran."""
        self.clock += float(seconds)

    def finish_sync(self) -> dict:
        """Close the window: the wire's remaining debt is exposed."""
        assert self._cur is not None, "no sync window open"
        cur, self._cur = self._cur, None
        total = cur["charged_s"]
        exposed = max(0.0, self.busy_until - self.clock)
        exposed = min(exposed, total)   # debt older than this window
        #                                 belongs to earlier records
        self.clock = max(self.clock, self.busy_until)
        rec = {"comm_total_s": total, "comm_exposed_s": exposed,
               "comm_hidden_s": total - exposed,
               "hidden_frac": (total - exposed) / total if total else 1.0,
               "hops": cur["hops"], "torn": False}
        self.records.append(rec)
        return rec

    def tear_sync(self, resync_hops: int) -> dict:
        """The in-flight sync was torn by a death: its partial comm is
        discarded and the synchronous re-reduction of ``resync_hops``
        hops runs fully exposed at the boundary."""
        assert self._cur is not None, "no sync window open"
        cur, self._cur = self._cur, None
        total = resync_hops * cur["hop_s"]
        self.busy_until = max(self.busy_until, self.clock)
        self.clock += total
        self.busy_until = self.clock
        rec = {"comm_total_s": total, "comm_exposed_s": total,
               "comm_hidden_s": 0.0, "hidden_frac": 0.0,
               "hops": resync_hops, "torn": True}
        self.records.append(rec)
        return rec

    @property
    def hidden_fraction(self) -> float:
        """Aggregate hidden fraction over every closed sync window."""
        total = sum(r["comm_total_s"] for r in self.records)
        hidden = sum(r["comm_hidden_s"] for r in self.records)
        return hidden / total if total else 1.0
