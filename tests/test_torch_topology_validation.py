"""The port's ring topology solver and contribution-admission layer
against ``repro`` on the same numpy-seeded inputs.

Exact: ring orders (``optimize_ring_order``, ``solve_exact``,
``solve_greedy``, ``exclude_slots``), ``BandwidthMonitor`` decisions
and bottlenecks over a drifting, partly observed link matrix, every
admission verdict (candidates, flagged reasons, localized bad chunks,
accepted, sanitize) over one population per poison mode and over a
sequence of steps that arms the cross-step gate, and the poisoned rows
themselves. Floats: the chunk-norm sideband and the log-norms within
rtol 1e-12, cosines within 1e-9 (the port adds its fp64 squares and
dot products on the rows' device, in another order than numpy)."""
import numpy as np
import pytest
import torch

from repro.core import ring_reduce as jrr
from repro.core import topology as jtop
from repro.core import validation as jvd
from repro_torch.core import ring_reduce as trr
from repro_torch.core import topology as ttop
from repro_torch.core import validation as tvd

torch.set_num_threads(2)


def _rand_w(rng, n):
    w = rng.uniform(1, 10, size=(n, n))
    np.fill_diagonal(w, 0)
    return w                 # asymmetric: the solvers symmetrize


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 9])
def test_ring_orders_match_reference(n):
    rng = np.random.default_rng(n)
    for _ in range(3):
        w = _rand_w(rng, n)
        assert ttop.optimize_ring_order(w) == jtop.optimize_ring_order(w)
        ws = (w + w.T) / 2
        assert ttop.solve_exact(ws) == jtop.solve_exact(ws)
        assert ttop.solve_greedy(ws, restarts=4, seed=n) == \
            jtop.solve_greedy(ws, restarts=4, seed=n)
        order = tuple(rng.permutation(n).tolist())
        assert ttop.cycle_bottleneck(ws, order) == \
            jtop.cycle_bottleneck(ws, order)
        excl = rng.choice(n, size=n // 2, replace=False).tolist()
        assert ttop.exclude_slots(order, excl) == \
            jtop.exclude_slots(order, excl)


def test_greedy_above_exact_limit_matches_reference():
    w = _rand_w(np.random.default_rng(20), 18)
    assert ttop.optimize_ring_order(w) == jtop.optimize_ring_order(w)


def test_bandwidth_monitor_matches_reference():
    """Partly observed, then degrading, then recovering links: the same
    reorder decisions, orders and bottlenecks at every step."""
    n = 6
    rng = np.random.default_rng(7)
    tm, jm = ttop.BandwidthMonitor(n), jtop.BandwidthMonitor(n)
    for step in range(12):
        w = _rand_w(rng, n)
        if step < 2:                          # a few links only
            for i, j in [(0, 1), (1, 2), (2, 3)]:
                tm.observe(i, j, w[i, j])
                jm.observe(i, j, w[i, j])
        else:
            if 4 <= step < 8:
                w[0, :] = w[:, 0] = 0.5        # node 0's links degrade
            tm.observe_matrix(w)
            jm.observe_matrix(w)
        assert tm.maybe_reorder() == jm.maybe_reorder()
        assert tm.ring_bottleneck() == jm.ring_bottleneck()
        np.testing.assert_array_equal(tm.bandwidth, jm.bandwidth)


@pytest.mark.parametrize("k,buckets", [(1, 1), (2, 1), (3, 2), (5, 3)])
def test_chunk_norms_match_reference(k, buckets):
    rng = np.random.default_rng(k)
    rows = rng.normal(size=(k, 1001)).astype(np.float32)
    rows[0, 5] = np.nan
    rows[-1, 7] = np.inf
    want = jrr.chunk_norms(rows, buckets)
    for x in (rows, torch.from_numpy(rows)):
        got = trr.chunk_norms(x, buckets)
        assert got.shape == want.shape and got.dtype == np.float64
        np.testing.assert_allclose(got, want, rtol=1e-12)
    op = trr.RingSyncOp(torch.from_numpy(rows), cfg=trr.RingConfig(
        buckets=buckets))
    np.testing.assert_allclose(op.norm_sideband(), want, rtol=1e-12)


def test_row_summary():
    rows = np.random.default_rng(0).normal(size=(4, 3000))
    rows[2, 11] = np.nan
    finite, gram = tvd.row_summary(torch.from_numpy(rows))
    assert finite.tolist() == [True, True, False, True]
    safe = np.nan_to_num(rows)
    np.testing.assert_allclose(gram, safe @ safe.T, rtol=1e-12)


def _correlated(rng, k, n, scale=1.0, noise=0.2):
    common = rng.normal(size=(n,))
    return (scale * (common[None] + noise * rng.normal(size=(k, n)))
            ).astype(np.float32)


def _populations():
    """(label, rows fp32, weights, buckets) of each gate's case."""
    rng = np.random.default_rng(11)
    out = [("clean", _correlated(rng, 6, 512), None, 4)]
    rows = _correlated(rng, 6, 512)
    rows[3, ::17] = np.nan
    out.append(("nan", rows, None, 1))
    rows = _correlated(rng, 5, 256)
    rows[4] = np.nan
    out.append(("nan weight 0", rows, [1, 1, 1, 1, 0], 1))
    rows = _correlated(rng, 6, 512)
    rows[2] *= 1e6
    out.append(("huge", rows, None, 4))
    rows = _correlated(rng, 6, 1024)
    rows[5] = -rows[5]
    out.append(("signflip", rows, None, 1))
    iid = rng.normal(size=(6, 1024)).astype(np.float32)
    iid[5] = -iid[5]
    out.append(("signflip iid", iid, None, 1))
    rows = _correlated(rng, 6, 2048, scale=1e-2)
    bits = rows[1].view(np.uint32)
    bits[3 * 86:4 * 86] ^= np.uint32(1 << 30)
    out.append(("bitflip", rows, None, 4))
    out.append(("zeros", np.zeros((4, 64), np.float32), None, 2))
    for mode in jvd.POISON_MODES:
        rows = _correlated(rng, 5, 700, scale=1e-3)
        rows[2] = jvd.poison_pseudograd(rows[2], mode,
                                        np.random.default_rng(5))
        out.append((f"poison {mode}", rows, [1, 1, 1, 1, 0.5], 2))
    return out


def _same_report(got, want, label):
    for key in ("candidates", "flagged", "bad_chunks", "accepted",
                "sanitize"):
        assert getattr(got, key) == getattr(want, key), (label, key)
    assert got.cosines.keys() == want.cosines.keys(), label
    for s in want.cosines:
        np.testing.assert_allclose(got.cosines[s], want.cosines[s],
                                   rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got.log_norms, want.log_norms, rtol=1e-12)


@pytest.mark.parametrize("sideband", [True, False])
def test_admission_verdicts_match_reference(sideband):
    cfg_t, cfg_j = tvd.ValidationConfig(), jvd.ValidationConfig()
    flagged = set()
    for label, rows, w, buckets in _populations():
        w = np.ones(rows.shape[0]) if w is None else np.asarray(w, float)
        side = jrr.chunk_norms(rows, buckets) if sideband else None
        want = jvd.validate_pseudograds(
            rows.astype(np.float64), w, side, jvd.AdmissionStats(cfg_j),
            cfg_j)
        tside = (trr.chunk_norms(torch.from_numpy(rows), buckets)
                 if sideband else None)
        got = tvd.validate_pseudograds(
            torch.from_numpy(rows), torch.from_numpy(w).float(), tside,
            tvd.AdmissionStats(cfg_t), cfg_t)
        _same_report(got, want, label)
        if got.flagged:
            flagged.add(label)
    assert {"nan", "huge", "signflip", "bitflip", "poison nan",
            "poison huge"} <= flagged
    assert not flagged & {"clean", "signflip iid", "zeros",
                          "nan weight 0"}


def test_cross_step_sequence_matches_reference():
    """Three slots (below the within-step minimum): accepted steps arm
    the cross-step gate, which then catches a 1e3x row; the stats'
    thresholds agree at every step."""
    rng = np.random.default_rng(2)
    cfg_t, cfg_j = tvd.ValidationConfig(), jvd.ValidationConfig()
    st_t, st_j = tvd.AdmissionStats(cfg_t), jvd.AdmissionStats(cfg_j)
    for step in range(6):
        rows = _correlated(rng, 3, 900, scale=1e-2)
        if step >= 3:
            rows[step % 3] *= 1e3
        side = jrr.chunk_norms(rows, 2)
        want = jvd.validate_pseudograds(rows.astype(np.float64),
                                        np.ones(3), side, st_j, cfg_j)
        got = tvd.validate_pseudograds(torch.from_numpy(rows), np.ones(3),
                                       trr.chunk_norms(rows, 2), st_t,
                                       cfg_t)
        _same_report(got, want, step)
        st_j.update(want)
        st_t.update(got)
        tj, tt = st_j.thresholds(6), st_t.thresholds(6)
        assert (tt is None) == (tj is None)
        if tj is not None:
            np.testing.assert_allclose(tt, tj, rtol=1e-12)
        if step >= 3:
            assert got.flagged == {step % 3: ["norm"]}


@pytest.mark.parametrize("mode", list(jvd.POISON_MODES))
def test_poison_matches_reference(mode):
    pg = np.random.default_rng(9).normal(size=1001).astype(np.float32)
    got = tvd.poison_pseudograd(pg, mode, np.random.default_rng([3, 4]))
    want = jvd.poison_pseudograd(pg, mode, np.random.default_rng([3, 4]))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tvd.poison_pseudograd(pg, "nope", np.random.default_rng(0))
