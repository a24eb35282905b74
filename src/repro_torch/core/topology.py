"""Bandwidth-aware ring topology optimization (port of
``repro.core.topology``; INTELLECT-1 §2.5). Host-only numpy, copied
whole: importing the JAX package's module would run ``repro.core``'s
``__init__``, which imports JAX.

The paper continuously measures pairwise bandwidth and picks the ring
order that maximizes the minimum edge bandwidth along the cycle — a
max–min *bottleneck* variant of the Traveling Salesperson Problem:

    max_{C in HamiltonianCycles}  min_{(u,v) in C}  w(u, v)

Solvers:
  * ``solve_exact``  — binary search over the sorted edge weights with a
    Held–Karp-style Hamiltonicity DP on the thresholded graph.  O(2^n n^2)
    per check; exact for n <= ~16 (the paper ran up to 14 nodes).
  * ``solve_greedy`` — nearest-available-neighbor construction + 2-opt-
    style bottleneck improvement for larger fleets.
  * ``optimize_ring_order`` — dispatches on n.

The returned order is a tuple of node ids; edge (order[-1], order[0])
closes the cycle.  The simulated ring all-reduce consumes it as its
permutation of the stacked worker rows.
"""
from __future__ import annotations

import itertools

import numpy as np


def cycle_bottleneck(w: np.ndarray, order) -> float:
    """Minimum edge bandwidth along the closed cycle ``order``."""
    n = len(order)
    return float(min(w[order[i], order[(i + 1) % n]] for i in range(n)))


def _hamiltonian_cycle_at_least(w: np.ndarray, thresh: float):
    """Held–Karp reachability DP: find a Hamiltonian cycle using only
    edges with weight >= thresh. Returns the cycle or None."""
    n = w.shape[0]
    if n == 1:
        return (0,)
    if n == 2:
        return (0, 1) if w[0, 1] >= thresh else None
    adj = w >= thresh
    # dp[mask][v] = predecessor of v on a path 0->...->v covering `mask`
    full = 1 << n
    pred = [[-2] * n for _ in range(full)]
    pred[1][0] = -1
    for mask in range(1, full):
        if not mask & 1:
            continue
        for v in range(n):
            if pred[mask][v] == -2 or not (mask >> v) & 1:
                continue
            for u in range(1, n):
                if (mask >> u) & 1 or not adj[v, u]:
                    continue
                nm = mask | (1 << u)
                if pred[nm][u] == -2:
                    pred[nm][u] = v
    last = full - 1
    for v in range(1, n):
        if pred[last][v] != -2 and adj[v, 0]:
            path = []
            mask, cur = last, v
            while cur != -1:
                path.append(cur)
                p = pred[mask][cur]
                mask ^= 1 << cur
                cur = p
            return tuple(reversed(path))
    return None


def solve_exact(w: np.ndarray) -> tuple[int, ...]:
    """Exact max–min bottleneck cycle via binary search over edge weights."""
    n = w.shape[0]
    if n <= 2:
        return tuple(range(n))
    weights = sorted({float(w[i, j]) for i in range(n) for j in range(n)
                      if i != j})
    lo, hi = 0, len(weights) - 1
    best = None
    while lo <= hi:
        mid = (lo + hi) // 2
        cyc = _hamiltonian_cycle_at_least(w, weights[mid])
        if cyc is not None:
            best = cyc
            lo = mid + 1
        else:
            hi = mid - 1
    assert best is not None  # the complete graph always has a cycle
    return best


def solve_greedy(w: np.ndarray, restarts: int = 8,
                 seed: int = 0) -> tuple[int, ...]:
    """Greedy + pairwise-swap improvement; near-optimal for large n."""
    n = w.shape[0]
    if n <= 2:
        return tuple(range(n))
    rng = np.random.default_rng(seed)
    # NN construction is deterministic given the start node, so colliding
    # starts would duplicate work — draw distinct starts (0 first).
    starts = [0] + [int(s) for s in
                    rng.permutation(np.arange(1, n))[:max(0, restarts - 1)]]
    best, best_val = None, -np.inf
    for start in starts:
        order = [start]
        left = set(range(n)) - {start}
        while left:
            cur = order[-1]
            nxt = max(left, key=lambda v: w[cur, v])
            order.append(nxt)
            left.remove(nxt)
        improved = True
        while improved:
            improved = False
            val = cycle_bottleneck(w, order)
            for i, j in itertools.combinations(range(n), 2):
                order[i], order[j] = order[j], order[i]
                if cycle_bottleneck(w, order) > val:
                    improved = True
                    break
                order[i], order[j] = order[j], order[i]
        val = cycle_bottleneck(w, order)
        if val > best_val:
            best, best_val = tuple(order), val
    return best


def optimize_ring_order(bandwidth: np.ndarray,
                        exact_limit: int = 14) -> tuple[int, ...]:
    """Ring order maximizing the bottleneck bandwidth (paper's objective)."""
    w = np.asarray(bandwidth, dtype=np.float64)
    assert w.ndim == 2 and w.shape[0] == w.shape[1]
    w = (w + w.T) / 2.0  # links are symmetric for our purposes
    if w.shape[0] <= exact_limit:
        return solve_exact(w)
    return solve_greedy(w)


def exclude_slots(order, excluded) -> tuple[int, ...]:
    """Quarantine-aware ring order: keep the relative order of the
    retained slots and move ``excluded`` slots to the TAIL (in their
    original relative order).

    The result is still a permutation of ``order`` — excluded slots
    stay in the ring geometry (they contribute zero-weighted rows), but
    they no longer sit between healthy peers, so a wedged or
    quarantined contributor cannot stall a healthy-to-healthy wire
    edge. When the excluded slots already sit at the tail the order is
    unchanged — no recompile of the distributed hop programs."""
    excluded = set(excluded)
    kept = tuple(s for s in order if s not in excluded)
    tail = tuple(s for s in order if s in excluded)
    return kept + tail


class BandwidthMonitor:
    """Models the paper's background bandwidth-probing process.

    Keeps an EWMA of observed pairwise bandwidths and re-solves the ring
    order when the current ring's bottleneck drifts below ``reorder_ratio``
    of the achievable optimum (avoiding needless recompiles).
    """

    def __init__(self, n: int, ewma: float = 0.5, reorder_ratio: float = 0.8):
        self.n = n
        self.ewma = ewma
        self.reorder_ratio = reorder_ratio
        self.bandwidth = np.full((n, n), np.inf)
        np.fill_diagonal(self.bandwidth, 0.0)
        self.order: tuple[int, ...] = tuple(range(n))

    def observe(self, i: int, j: int, gbps: float) -> None:
        old = self.bandwidth[i, j]
        new = gbps if not np.isfinite(old) else (
            self.ewma * gbps + (1 - self.ewma) * old)
        self.bandwidth[i, j] = self.bandwidth[j, i] = new

    def observe_matrix(self, w) -> None:
        w = np.asarray(w, dtype=np.float64)
        for i in range(self.n):
            for j in range(i + 1, self.n):
                self.observe(i, j, float(w[i, j]))

    def ring_bottleneck(self, order=None) -> float | None:
        """Measured bottleneck bandwidth (Gb/s) of ``order`` (default: the
        current ring), or None while any edge on it is still unobserved."""
        order = self.order if order is None else tuple(order)
        n = len(order)
        if n <= 1:
            return None
        edges = [self.bandwidth[order[i], order[(i + 1) % n]]
                 for i in range(n)]
        if not all(np.isfinite(e) for e in edges):
            return None
        return float(min(edges))

    def maybe_reorder(self) -> tuple[bool, tuple[int, ...]]:
        """(changed, order). ``changed`` implies the caller must recompile
        the sync step with the new static ring permutation.

        Unobserved links (still ``inf``) are UNKNOWN, not zero: until every
        edge on the current ring has an observation we cannot score it, so
        we never reorder off a partially-observed matrix (a spurious
        reorder costs a recompile)."""
        cur_val = self.ring_bottleneck()
        if cur_val is None:
            return False, self.order
        # unobserved edges score 0 only as *candidates* — the solver will
        # route around them, and can never beat a fully-observed ring with
        # a cycle through an unmeasured link
        w = np.where(np.isfinite(self.bandwidth), self.bandwidth, 0.0)
        best = optimize_ring_order(w)
        best_val = cycle_bottleneck(w, best)
        if best_val > 0 and cur_val < self.reorder_ratio * best_val:
            self.order = best
            return True, best
        return False, self.order
