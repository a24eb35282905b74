"""The comparison that decides ``correct``.

Both sides report the same readings of the first outer steps (see
``bench/reference/diloco.py``): ``loss`` (one number an outer step),
``moment1`` and ``change`` ({tensor name: one norm a worker}). Three
numbers are compared, each against its own limit from the cell's
limits file (``bench/limits/<cell>.json``; a limit of null: not
compared):

* ``loss_gap``: the largest |program - reference| / |reference| over
  the outer steps' losses;
* ``moment1_gap``: the worst tensor's |program's norm - reference's
  norm| of AdamW's first moment after the first outer step (the
  gradients of its inner steps as the optimizer holds them), over the
  larger of the reference's norm of that tensor and of the median
  tensor, over all workers;
* ``change_gap``: the same of each tensor's change after the outer
  steps, leaving out the tensors whose first moment in the reference
  is below a thousandth of the median tensor's (they move by round-off
  alone).

A reading that is not finite compares as infinitely far.
"""
from __future__ import annotations

import math
import statistics

NAMES = ("loss_gap", "moment1_gap", "change_gap")
QUIET = 1e-3


def _norm_gap(prog: dict, ref: dict, names) -> float:
    worst = 0.0
    workers = len(next(iter(ref.values())))
    for w in range(workers):
        med = statistics.median(ref[n][w] for n in ref)
        for n in names:
            a, b = prog[n][w], ref[n][w]
            if not (math.isfinite(a) and math.isfinite(b)):
                return math.inf
            den = max(b, med)
            if den > 0:
                worst = max(worst, abs(a - b) / den)
    return worst


def gaps(prog: dict, ref: dict) -> dict:
    if set(prog["moment1"]) != set(ref["moment1"]):
        raise ValueError("the program's tensors are not the reference's")
    loss = 0.0
    for a, b in zip(prog["loss"], ref["loss"], strict=True):
        loss = max(loss, abs(a - b) / abs(b) if math.isfinite(a)
                   else math.inf)
    g = ref["moment1"]
    workers = len(next(iter(g.values())))
    moving = [n for n in g if all(
        g[n][w] >= QUIET * statistics.median(g[m][w] for m in g)
        for w in range(workers))]
    return {"loss_gap": loss,
            "moment1_gap": _norm_gap(prog["moment1"], g, list(g)),
            "change_gap": _norm_gap(prog["change"], ref["change"], moving)}


def judge(found: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for the compared numbers."""
    out, ok = {}, True
    for n in NAMES:
        lim = limits.get(n)
        if lim is None:
            continue
        v = found[n]
        out[n] = {"value": v, "limit": lim}
        ok = ok and v <= lim
    return ok, out
