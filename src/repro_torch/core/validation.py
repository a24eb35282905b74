"""Contribution-admission checks for the DiLoCo outer step (port of
``repro.core.validation``).

Every outer sync reduces one pseudo-gradient per contributor
(``pg = anchor_flat - theta_flat``).  A single corrupted contribution —
NaN'd buffers, a mis-scaled optimizer, a bit-flipped frame — poisons the
ring reduce and silently destroys the shared anchor for *everyone*.
This module computes cheap admission checks on the already-staged
pseudo-gradient rows *before* any reduced value is applied:

1. **Finite guard** — any non-finite element disqualifies the row
   outright (and the row must be sanitized before a re-reduce, because
   ``NaN * 0.0 == NaN``: zero-weighting is NOT sufficient).
2. **Per-bucket norm gate** — per-bucket log10-norms are compared
   against running median + MAD statistics accumulated across accepted
   outer steps (cross-step gate), and against the median + MAD of the
   current population (within-step gate, which covers step-0 attacks
   before history is armed).
3. **Leave-one-out cosine gate** — each candidate's cosine against the
   sum of the *other* candidates; a strongly anti-aligned row (e.g. a
   sign-flipped contribution) is flagged.

The rows stay where they are: one fp64 pass on their own device
(:func:`row_summary`) reduces them to a finite mask per row and their
(k, k) Gram matrix, from which the row norms and every leave-one-out dot
product follow; ``ring_reduce.chunk_norms`` gives the per-chunk norms.
Only these small arrays reach the host, where the gates are the
reference's numpy float64. The reference computes the same sums from a
float64 host copy of the rows, so norms and cosines agree to fp64
rounding and the verdicts are the same.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = [
    "ValidationConfig",
    "AdmissionStats",
    "AdmissionReport",
    "row_summary",
    "validate_pseudograds",
    "poison_pseudograd",
    "POISON_MODES",
]

# columns per fp64 block of the row-summary pass: k x 4 Mi x 8 bytes
_BLOCK = 1 << 22
# Norms at or below this are treated as exactly zero in log space.
ZERO_EPS = 1e-30
# A bucket whose median log-norm sits at the zero floor carries no
# signal (padding, frozen params, empty slots) — the norm gates skip it.
ARMED_FLOOR = -25.0


@dataclass(frozen=True)
class ValidationConfig:
    """Knobs for the contribution-admission layer.

    The defaults are deliberately loose: a false quarantine costs a
    healthy contributor's compute for ``probation_steps`` outer rounds,
    while a missed soft corruption costs one averaged-down outer step.
    """

    enabled: bool = True
    #: Outer steps of accepted per-bucket log-norms kept for the
    #: cross-step median/MAD gate.
    norm_window: int = 8
    #: Accepted steps required before the cross-step gate arms.
    min_history: int = 2
    #: Norm gate threshold: median + max(norm_nmads * MAD, min_decades),
    #: upper side only, in log10 space.
    norm_nmads: float = 6.0
    #: Absolute floor on the norm-gate margin (decades). Guards against
    #: a hair-trigger MAD when the population is nearly identical.
    min_decades: float = 1.0
    #: Leave-one-out cosine below this flags the row.  -0.4 catches a
    #: sign-flipped contribution (whose LOO cosine is minus the natural
    #: alignment) without tripping on ordinary gradient noise.
    cos_threshold: float = -0.4
    #: Minimum candidates for the cosine gate to run.
    min_workers_cos: int = 3
    #: Minimum candidates for the *within-step* norm gate to run.
    min_workers_cross: int = 4


def row_summary(pgs) -> tuple[np.ndarray, np.ndarray]:
    """(finite (k,) bool, Gram (k, k) float64) of the (k, n) rows ``pgs``
    (a tensor on any device, or an array), in one fp64 pass on the rows'
    device, a block of columns at a time. Non-finite values count as 0
    in the Gram matrix (its diagonal is the squared row norms of
    :func:`_log_norms` in the reference); a finite row's entries are
    exact dot products up to fp64 rounding."""
    rows = torch.as_tensor(pgs)
    k, n = rows.shape
    finite = torch.ones((k,), dtype=torch.bool, device=rows.device)
    gram = torch.zeros((k, k), dtype=torch.float64, device=rows.device)
    for lo in range(0, n, _BLOCK):
        x = rows[:, lo:lo + _BLOCK].double()
        finite &= torch.isfinite(x).all(dim=1)
        x.nan_to_num_(nan=0.0, posinf=0.0, neginf=0.0)
        gram += x @ x.T
    return finite.cpu().numpy(), gram.cpu().numpy()


def _median_mad(x: np.ndarray, axis: int = 0) -> tuple[np.ndarray, np.ndarray]:
    med = np.median(x, axis=axis)
    mad = np.median(np.abs(x - np.expand_dims(med, axis)), axis=axis)
    return med, mad


class AdmissionStats:
    """Running cross-step statistics of *accepted* contributions.

    Keeps the last ``norm_window`` outer steps' accepted per-bucket
    log-norm rows.  Purely deterministic: both the simulator and the
    distributed backend update it with the same accepted rows, so
    thresholds stay bit-identical across paths.
    """

    def __init__(self, cfg: ValidationConfig):
        self.cfg = cfg
        self.window: deque[np.ndarray] = deque(maxlen=cfg.norm_window)

    def thresholds(self, ncols: int) -> tuple[np.ndarray, np.ndarray] | None:
        """(median, mad) per bucket over the window, or None if unarmed."""
        rows = [w for w in self.window if w.shape[1] == ncols]
        if len(rows) < self.cfg.min_history:
            return None
        stacked = np.concatenate(rows, axis=0)
        if stacked.shape[0] < self.cfg.min_history:
            return None
        return _median_mad(stacked, axis=0)

    def update(self, report: "AdmissionReport") -> None:
        if report.accepted:
            idx = np.array(sorted(report.accepted), dtype=np.int64)
            self.window.append(report.log_norms[idx])


@dataclass
class AdmissionReport:
    """Outcome of one admission pass over a pseudo-gradient population."""

    #: Slots with nonzero weight this step (the judged population).
    candidates: list[int]
    #: slot -> list of reason strings ("nonfinite", "norm", "cosine").
    flagged: dict[int, list[str]]
    #: slot -> bucket columns that tripped the norm gate (localization).
    bad_chunks: dict[int, list[int]]
    #: Candidate slots that passed every gate.
    accepted: list[int]
    #: ALL slots whose rows must be zeroed before any re-reduce
    #: (flagged candidates plus non-finite non-candidates — a weight-0
    #: NaN row still poisons the reduce).
    sanitize: list[int]
    #: slot -> leave-one-out cosine (only for slots the gate judged).
    cosines: dict[int, float]
    #: (k, buckets) per-bucket log10 norms of every row.
    log_norms: np.ndarray
    #: Filled in by the trainer after mapping slots to node ids.
    quarantined_nodes: list[int] = field(default_factory=list)

    @property
    def clean(self) -> bool:
        return not self.sanitize


def validate_pseudograds(
    pgs,
    weights,
    bucket_norms: np.ndarray | None,
    stats: AdmissionStats | None,
    cfg: ValidationConfig,
) -> AdmissionReport:
    """Run the admission gates over one population of pseudo-gradients.

    Args:
      pgs: (k, n) pseudo-gradient rows (a tensor on any device, or a
        host array; any float dtype), reduced by :func:`row_summary`.
      weights: (k,) contribution weights (tensor or array); only slots
        with weight > 0 are candidates, but *every* row is checked for
        finiteness (a NaN row with weight 0 still contaminates the
        staged accumulators).
      bucket_norms: optional (k, ncols) per-chunk norm sideband
        (``ring_reduce.chunk_norms``).  When given it is used for the
        norm gates directly (so sim and distributed judge the identical
        sideband values); otherwise norms are derived from ``pgs``.
      stats: running cross-step statistics, or None for stateless use.
      cfg: thresholds.

    Gates run in order — finite, cross-step norm, within-step norm,
    leave-one-out cosine — with the pending-candidate set recomputed
    between gates so an already-flagged row never distorts a later gate.
    """
    finite, gram = row_summary(pgs)
    weights = np.asarray(torch.as_tensor(weights).cpu(), dtype=np.float64)
    k = finite.shape[0]

    if bucket_norms is not None:
        log_norms = np.log10(np.asarray(bucket_norms, dtype=np.float64) + ZERO_EPS)
    else:
        log_norms = np.log10(np.sqrt(np.diag(gram))[:, None] + ZERO_EPS)
    ncols = log_norms.shape[1]

    candidates = [i for i in range(k) if weights[i] > 0.0]
    flagged: dict[int, list[str]] = {}
    bad_chunks: dict[int, list[int]] = {}
    cosines: dict[int, float] = {}
    sanitize: set[int] = set()

    def _flag(slot: int, reason: str) -> None:
        flagged.setdefault(slot, []).append(reason)
        sanitize.add(slot)

    # --- gate 1: finite guard (every row, candidate or not) -----------
    for i in range(k):
        if not finite[i]:
            sanitize.add(i)
            if i in candidates:
                _flag(i, "nonfinite")

    def _pending() -> list[int]:
        return [i for i in candidates if i not in flagged]

    def _norm_gate(rows_idx: list[int], med, mad, reason: str) -> None:
        margin = np.maximum(cfg.norm_nmads * mad, cfg.min_decades)
        armed = med > ARMED_FLOOR
        for i in rows_idx:
            over = armed & (log_norms[i] > med + margin)
            if over.any():
                _flag(i, reason)
                bad_chunks.setdefault(i, []).extend(
                    int(c) for c in np.nonzero(over)[0]
                )

    # --- gate 2: cross-step norm gate --------------------------------
    if stats is not None:
        th = stats.thresholds(ncols)
        if th is not None:
            _norm_gate(_pending(), th[0], th[1], "norm")

    # --- gate 3: within-step population norm gate --------------------
    pend = _pending()
    if len(pend) >= cfg.min_workers_cross:
        med, mad = _median_mad(log_norms[np.array(pend, dtype=np.int64)], axis=0)
        _norm_gate(pend, med, mad, "norm")

    # --- gate 4: leave-one-out cosine gate ---------------------------
    pend = _pending()
    if len(pend) >= cfg.min_workers_cos:
        # from the Gram matrix G of the pending rows: row j's norm is
        # sqrt(G[j, j]), its dot with the sum of the others is the sum of
        # row j of G off the diagonal, and that sum's squared norm is the
        # sum of G over the others
        idx = np.array(pend, dtype=np.int64)
        g = gram[np.ix_(idx, idx)]
        norms = np.sqrt(np.diag(g))
        row_sums = g.sum(axis=1)
        total_sq = g.sum()
        for j, i in enumerate(pend):
            dot = float(row_sums[j] - g[j, j])
            rest_sq = float(total_sq - 2.0 * row_sums[j] + g[j, j])
            rest_n = float(np.sqrt(max(rest_sq, 0.0)))
            denom = float(norms[j]) * rest_n
            if denom <= ZERO_EPS:
                continue
            c = dot / denom
            cosines[i] = c
            if c < cfg.cos_threshold:
                _flag(i, "cosine")

    accepted = [i for i in candidates if i not in flagged]
    # Dedup bad-chunk columns while preserving order.
    bad_chunks = {s: sorted(set(cols)) for s, cols in bad_chunks.items()}
    return AdmissionReport(
        candidates=candidates,
        flagged=flagged,
        bad_chunks=bad_chunks,
        accepted=accepted,
        sanitize=sorted(sanitize),
        cosines=cosines,
        log_norms=log_norms,
    )


# ---------------------------------------------------------------------------
# Poison injection (fault harness / ClusterSimulator POISON events)
# ---------------------------------------------------------------------------

POISON_MODES = ("nan", "huge", "signflip", "bitflip")


def poison_pseudograd(pg: np.ndarray, mode: str, rng: np.random.Generator) -> np.ndarray:
    """Corrupt one pseudo-gradient row the way a faulty peer would.

    Modes mirror real open-run failure classes: NaN'd buffers from a
    diverged inner phase ("nan"), a mis-scaled optimizer or fp16
    overflow ("huge"), an adversarial anti-update ("signflip"), and a
    corrupted wire frame ("bitflip" — flips the float32 exponent MSB of
    scattered elements, the classic silent-corruption signature).
    """
    out = np.array(pg, dtype=np.float32, copy=True)
    n = out.size
    if mode == "nan":
        idx = rng.choice(n, size=max(1, n // 64), replace=False)
        out[idx] = np.nan
    elif mode == "huge":
        out *= np.float32(1e6)
    elif mode == "signflip":
        out = -out
    elif mode == "bitflip":
        idx = rng.choice(n, size=max(1, n // 128), replace=False)
        bits = out.view(np.uint32)
        bits[idx] ^= np.uint32(1 << 30)
    else:
        raise ValueError(f"unknown poison mode: {mode!r}")
    return out
