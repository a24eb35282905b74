"""Asynchronous rollout buffer with an outer-boundary staleness window
(port of ``repro.rl.buffer``: host numpy, unchanged).

Rollout workers append trajectories tagged with the policy version that
generated them; the trainer drains the buffer at each outer boundary.
Because workers adopt policy versions asynchronously (INTELLECT-2's
async RL), a drained rollout may be up to several versions behind the
trainer. The staleness window bounds the off-policy gap:

    lag = trainer_version - rollout.version     (>= 0)
    lag <= max_policy_lag  -> accepted  (weight 1, or gamma**lag when
                              mode == 'downweight' and lag > 0)
    lag >  max_policy_lag  -> dropped, never enters a training batch

Every decision is counted in a :class:`StalenessLedger` — the
accounting is exact (generated == accepted + dropped + still-buffered +
capacity-evicted at all times) and tested, because silent drops would
make reward trends unreadable.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Iterable

import numpy as np


@dataclasses.dataclass
class Rollout:
    """One sampled trajectory from a rollout worker."""
    rid: int
    prompt: np.ndarray          # (S,) int32
    tokens: list                # sampled completion token ids
    logprobs: list              # behavior-policy logprob per token
    version: int                # policy version that generated it
    group: int                  # GRPO group id (same prompt -> same group)
    worker: int = -1
    reward: float | None = None


@dataclasses.dataclass
class StalenessLedger:
    """Exact accounting of every rollout's fate at the staleness gate."""
    generated: int = 0          # appended to the buffer
    accepted: int = 0           # entered a training batch (weight > 0)
    dropped_stale: int = 0      # lag > max_policy_lag
    downweighted: int = 0       # accepted with weight < 1
    evicted_capacity: int = 0   # pushed out by the capacity bound
    max_accepted_lag: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class RolloutBuffer:
    """Thread-safe FIFO of rollouts between workers and the trainer.

    Workers ``add()`` from their own threads / call sites; the trainer
    ``drain()``s at outer boundaries with its CURRENT policy version,
    which is where the staleness window is enforced (the buffer itself
    never inspects versions on the way in — a rollout fresh at add time
    can be stale by the time it is consumed, and that is exactly the
    case the ledger must count).
    """

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self._items: list[Rollout] = []
        self._lock = threading.Lock()
        self.ledger = StalenessLedger()

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    @property
    def occupancy(self) -> float:
        return len(self) / max(1, self.capacity)

    def add(self, rollouts: Iterable[Rollout]) -> int:
        """Append rollouts (FIFO). Returns how many were evicted to
        honor the capacity bound (oldest first)."""
        rollouts = list(rollouts)
        with self._lock:
            self._items.extend(rollouts)
            self.ledger.generated += len(rollouts)
            evict = max(0, len(self._items) - self.capacity)
            if evict:
                del self._items[:evict]
                self.ledger.evicted_capacity += evict
        return evict

    def drain(self, current_version: int, max_policy_lag: int,
              mode: str = "drop", stale_gamma: float = 0.5
              ) -> list[tuple[Rollout, float]]:
        """Remove everything buffered and apply the staleness window.

        Returns ``[(rollout, weight), ...]`` for the accepted rollouts:
        weight 1.0 when on-window; ``stale_gamma ** lag`` for lagged
        rollouts under ``mode='downweight'``. Rollouts with
        ``lag > max_policy_lag`` are dropped (counted, not returned) —
        under 'downweight' too: the window is a hard boundary, the mode
        only shapes weights inside it.
        """
        if mode not in ("drop", "downweight"):
            raise ValueError(f"unknown staleness mode {mode!r}")
        with self._lock:
            items, self._items = self._items, []
        out: list[tuple[Rollout, float]] = []
        led = self.ledger
        for r in items:
            lag = int(current_version) - int(r.version)
            if lag < 0:
                raise ValueError(
                    f"rollout from FUTURE version {r.version} vs "
                    f"trainer {current_version} — version bookkeeping "
                    "is broken")
            if lag > max_policy_lag:
                led.dropped_stale += 1
                continue
            w = 1.0
            if mode == "downweight" and lag > 0:
                w = float(stale_gamma) ** lag
                led.downweighted += 1
            led.accepted += 1
            led.max_accepted_lag = max(led.max_accepted_lag, lag)
            out.append((r, w))
        return out
