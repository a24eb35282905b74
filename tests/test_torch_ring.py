"""repro_torch's stacked ring all-reduce simulator against
repro.core.ring_reduce (``impl="jnp"``, the reference's main path) on
the same numpy-seeded rows, over ring sizes, fp32/int8, sub-buckets,
fused transmit and receive on and off, ring orders and zero weights.

Tolerances: fp32 is allclose to 1e-6. int8: every element is within
1e-5, apart from elements whose code flipped at a bucket edge (lo and
width come from two frameworks' reductions); those stay within one
bucket width per quantization they passed (k of them), and they are
rare. Byte counts are identical integers."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ring_reduce as jrr
from repro_torch.core import ring_reduce as trr

torch.set_float32_matmul_precision("highest")
torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

D = 1001          # not a multiple of k * buckets: the padding is exercised


def _case(k, seed=0):
    rng = np.random.default_rng(seed + k)
    anchor = rng.normal(size=D).astype(np.float32)
    thetas = (anchor[None] + 0.05 * rng.normal(size=(k, D))
              * rng.uniform(0.5, 2.0, size=(k, 1))).astype(np.float32)
    xs = (anchor[None] - thetas).astype(np.float32)
    order = tuple(range(k)) if k == 2 else tuple(rng.permutation(k).tolist())
    weights = np.ones((k,), np.float32)
    if k > 2:
        weights[1] = 0.0
    return anchor, thetas, xs, order, weights


def int8_bound(xs, weights, k):
    """One bucket width of the widest quantization (6-sigma range over
    256 buckets, std of a sum <= sum of stds), k times, over the total
    weight: what a flipped code can move an averaged element by."""
    width = 12.0 * sum(float(np.std(w * x)) for w, x in
                       zip(weights, xs)) / 256
    return k * width / max(float(weights.sum()), 1e-20)


def check_ring_close(got, want, quant, bound):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if quant == "fp32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        return 0
    err = np.abs(got - want)
    flipped = err > 1e-5
    assert err.max() <= bound, (err.max(), bound)
    assert flipped.mean() < 0.01, flipped.mean()
    return int(flipped.sum())


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("quant", ["fp32", "int8"])
@pytest.mark.parametrize("buckets", [1, 2])
@pytest.mark.parametrize("fused", [True, False])
def test_simulated_ring_matches_reference(k, quant, buckets, fused):
    anchor, thetas, xs, order, weights = _case(k)
    jcfg = jrr.RingConfig(quant=quant, impl="jnp", buckets=buckets,
                          fused=fused)
    want = jrr.simulate_ring_all_reduce(
        jnp.asarray(xs), ring_order=order, cfg=jcfg,
        weights=jnp.asarray(weights),
        fused_src=(jnp.asarray(anchor), jnp.asarray(thetas)))
    tcfg = trr.RingConfig(quant=quant, buckets=buckets, fused=fused)
    got = trr.simulate_ring_all_reduce(
        torch.from_numpy(xs), ring_order=order, cfg=tcfg,
        weights=torch.from_numpy(weights),
        fused_src=(torch.from_numpy(anchor), torch.from_numpy(thetas)))
    assert got.shape == (k, D) and got.dtype == torch.float32
    # every worker ends with the same vector
    assert torch.equal(got, got[:1].expand_as(got))
    check_ring_close(got.numpy(), want, quant, int8_bound(xs, weights, k))


def test_single_worker_ring_is_a_weighted_copy():
    xs = np.random.default_rng(0).normal(size=(1, 37)).astype(np.float32)
    got = trr.simulate_ring_all_reduce(torch.from_numpy(xs),
                                       weights=torch.tensor([2.0]))
    want = jrr.simulate_ring_all_reduce(jnp.asarray(xs),
                                        weights=jnp.asarray([2.0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_codec_call_counts(monkeypatch):
    """One int8 all-reduce makes exactly ``codec_calls`` calls of each
    codec wrapper (counted through the CPU route)."""
    from repro_torch.kernels import int8_quant
    names = ("pseudograd_encode_hist", "encode_hist", "decode_add",
             "decode")
    for k, nb, fused_src in [(2, 1, True), (3, 2, True), (4, 1, False)]:
        calls = dict.fromkeys(names, 0)
        for n in names:
            fn = getattr(int8_quant, n)

            def counted(*a, _n=n, _fn=fn, **kw):
                calls[_n] += 1
                return _fn(*a, **kw)
            monkeypatch.setattr(int8_quant, n, counted)
        anchor, thetas, xs, order, weights = _case(k)
        cfg = trr.RingConfig(buckets=nb)
        trr.simulate_ring_all_reduce(
            torch.from_numpy(xs), order, cfg, torch.from_numpy(weights),
            (torch.from_numpy(anchor), torch.from_numpy(thetas))
            if fused_src else None)
        assert calls == trr.codec_calls(k, cfg, fused_src), (k, nb, calls)
        monkeypatch.undo()
    assert trr.codec_calls(2) == {"pseudograd_encode_hist": 1,
                                  "encode_hist": 1, "decode_add": 1,
                                  "decode": 2}


@pytest.mark.parametrize("quant", ["int8", "fp32", "int4"])
def test_wire_bytes_identical(quant):
    for numel in [1, 999, 757_071_872, 10_200_000_000]:
        for n in [1, 2, 3, 4, 8, 14]:
            for b in [1, 2, 4]:
                assert trr.ring_hop_bytes(numel, n, quant, b) == \
                    jrr.ring_hop_bytes(numel, n, quant, b)
                got = trr.ring_wire_bytes(numel, n, quant, b)
                assert isinstance(got, int)
                assert got == jrr.ring_wire_bytes(numel, n, quant, b)


def test_pad_to_chunks_matches_reference():
    x = np.arange(2 * 1001, dtype=np.float32).reshape(2, 1001)
    for n, b in [(2, 1), (3, 2), (4, 4), (7, 3)]:
        jp, jc, jb = jrr._pad_to_chunks(jnp.asarray(x), n, b)
        tp, tc, tb = trr._pad_to_chunks(torch.from_numpy(x), n, b)
        assert (tc, tb) == (jc, jb)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
