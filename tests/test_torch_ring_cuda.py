"""The hop-steppable ring and the overlapped outer sync on the card,
against the same ops on the CPU tensor path (the codec's plain
versions). Needs a CUDA device and nvcc (skipped without a device);
imports no JAX, so it runs on the GPU machine:

  PYTHONPATH=src python -m pytest -q tests/test_torch_ring_cuda.py

fp32 rings agree to 1e-6. int8 and int4 rings agree within 1e-5 but
for rare elements whose code flipped at a bucket edge (lo and width
come from reductions on two devices), which stay within one bucket
width per quantization they passed. On the card a ``RingSyncOp``
stepped one hop at a time equals the one-shot ring bit for bit and
launches ``hop_codec_calls`` codec kernels per hop; a restart launches
one whole reduction's; a sanitized restart equals the ring over the
clean rows.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import diloco as dl
from repro_torch.core import ring_reduce as rr
from repro_torch.core import validation as vd
from repro_torch.kernels import int8_quant as iq

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device")

D = 100_003       # not a multiple of k * buckets: the padding is exercised


def _case(k, seed=0):
    rng = np.random.default_rng(seed + k)
    anchor = rng.normal(size=D).astype(np.float32)
    thetas = (anchor[None] + 0.05 * rng.normal(size=(k, D))
              * rng.uniform(0.5, 2.0, size=(k, 1))).astype(np.float32)
    order = tuple(rng.permutation(k).tolist())
    weights = np.ones((k,), np.float32)
    weights[min(1, k - 1)] = 0.0 if k > 2 else 1.0
    return anchor, thetas, order, weights


def _bound(xs, weights, k, quant):
    buckets = 16 if quant == "int4" else 256
    width = 12.0 * sum(float(np.std(w * x)) for w, x in
                       zip(weights, xs)) / buckets
    return k * width / max(float(weights.sum()), 1e-20)


def _close(got, want, quant, bound):
    got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
    if quant == "fp32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        return
    err = np.abs(got - want)
    assert err.max() <= bound, (err.max(), bound)
    assert (err > 1e-5).mean() < 0.01


def _launches():
    return {name: getattr(iq, name).launches for name in rr.CODEC}


def _delta(before):
    now = _launches()
    return {name: now[name] - before[name] for name in rr.CODEC}


@needs_cuda
@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("quant", ["int8", "fp32", "int4"])
@pytest.mark.parametrize("buckets", [1, 2])
@pytest.mark.parametrize("fused", [True, False])
def test_stepped_ring_on_card(k, quant, buckets, fused):
    anchor, thetas, order, weights = _case(k)
    xs = anchor[None] - thetas
    cfg = rr.RingConfig(quant=quant, buckets=buckets, fused=fused)

    def op(dev):
        return rr.RingSyncOp(
            torch.from_numpy(xs).to(dev), order, cfg,
            torch.from_numpy(weights).to(dev),
            (torch.from_numpy(anchor).to(dev),
             torch.from_numpy(thetas).to(dev)))
    want = op("cpu").finish()
    card = op("cuda")
    for hop in range(card.hops_total):
        before = _launches()
        assert card.step()
        torch.cuda.synchronize()
        assert _delta(before) == rr.hop_codec_calls(hop, k, cfg, True)
    got = card.finish()
    assert torch.equal(got, op("cuda").finish())          # deterministic
    assert torch.equal(got, got[:1].expand_as(got))
    _close(got, want, quant, _bound(xs, weights, k, quant))


@needs_cuda
@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_restart_and_sanitize_on_card(quant):
    """A handle torn after two hops, one row poisoned: sanitize, then
    restart over the survivors, on the card and on the CPU; the
    restart's codec launches are one whole reduction's; the sideband and
    the admission verdicts agree."""
    k = 4
    rng = np.random.default_rng(1)
    base = rng.normal(size=(1, D)).astype(np.float32)
    params = {"w": base + 0.05 * rng.normal(size=(k, D)).astype(np.float32)}
    params["w"][2, ::7] = np.nan
    anchor = {"w": base[0]}
    cfg = dl.DiLoCoConfig(quant=quant, overlap="delayed")
    survivors = np.array([1, 1, 0, 1], np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        p = {"w": torch.from_numpy(params["w"]).to(dev)}
        state = dl.init_outer_state_sim(
            {"w": torch.from_numpy(anchor["w"]).to(dev)}, cfg, k)
        h = dl.begin_outer_sync_sim(p, state, cfg, ring_order=(3, 1, 0, 2),
                                    weights=torch.ones(k, device=dev))
        assert h.step() and h.step()
        report = vd.validate_pseudograds(
            h.op.xs, h.weights, h.norm_sideband(), None, vd.ValidationConfig())
        assert report.sanitize == [2] and report.flagged == {2: ["nonfinite"]}
        h.sanitize(report.sanitize)
        assert not bool(h.op.xs[2].any())
        before = _launches()
        _, new = dl.resync_outer_sim(h, p, state,
                                     torch.from_numpy(survivors).to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert _delta(before) == rr.codec_calls(
                k, cfg.ring, dl._fused_src_ok(cfg))
        out[dev] = (new.anchor_flat, h.norm_sideband(), report)
    xs = anchor["w"][None] - np.nan_to_num(params["w"])
    xs[2] = 0
    bound = 0.7 * 1.9 * _bound(xs, survivors, k, quant)
    _close(out["cuda"][0], out["cpu"][0], quant, bound)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-12)
    assert out["cuda"][2].accepted == out["cpu"][2].accepted
