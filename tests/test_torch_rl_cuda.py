"""The asynchronous RL tier on the card: logprob capture in the
continuous and paged engines (the flash-decode kernels), policy
publishing and adoption through the codec kernels (kernel 2 encodes a
delta, kernel 4 applies it), and the reduced driver card against the
CPU. Needs a CUDA device and nvcc (skipped without a device); imports no
JAX:

  PYTHONPATH=src python -m pytest -q tests/test_torch_rl_cuda.py

Tolerances: greedy tokens equal card vs CPU and captured logprobs within
1e-3 (fp32, TF32 off; as ``chip_smoke.py``'s reduced models); adopted
trees bitwise the publisher's reconstruction; the driver's
weight-independent counts equal.
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpointing import checkpoint as ck
from repro_torch.configs import get_config
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import int8_quant as iq
from repro_torch.models import registry
from repro_torch.rl.policy_pub import PolicyPublisher
from repro_torch.rl.rollout import RolloutWorker
from repro_torch.serving.engine import Request, make_engine

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device")

ARCH = "internlm2-1.8b"
COUNTS = ("outer_steps", "versions_published", "ledger", "adoptions",
          "bit_exact", "retired_fallbacks", "live_versions",
          "starved_phases")


@pytest.fixture(autouse=True)
def _no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _run(kind, model, params, prompts, *, capture, temperature=0.0):
    kw = {"block_size": 8} if kind == "paged" else {}
    eng = make_engine(kind, model, params, batch_slots=2, max_len=32,
                      capture_logprobs=capture, seed=3, **kw)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=6,
                    temperature=temperature) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return reqs


@needs_cuda
@pytest.mark.parametrize("kind", ["continuous", "paged"])
def test_capture_on_card(kind):
    """Greedy: tokens equal to the CPU engine's, logprobs within 1e-3,
    the engine's decode kernel launched; temperature 1: capture does not
    change the stream, logprobs finite and <= 0."""
    cfg = get_config(ARCH).reduced()
    cpu = registry.get_model(cfg, "cpu")
    params = cpu.init(0)
    gpu = registry.get_model(cfg, "cuda")
    gparams = _to(params, "cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab, size=n).astype(np.int32)
               for n in (3, 9, 5, 12)]
    kernel = fd.flash_decode_paged if kind == "paged" else fd.flash_decode
    before = kernel.launches
    got = _run(kind, gpu, gparams, prompts, capture=True)
    assert kernel.launches > before
    want = _run(kind, cpu, params, prompts, capture=True)
    for g, w in zip(got, want):
        assert g.out_tokens == w.out_tokens
        np.testing.assert_allclose(g.out_logprobs, w.out_logprobs,
                                   rtol=0, atol=1e-3)
    a = _run(kind, gpu, gparams, prompts, capture=False, temperature=1.0)
    b = _run(kind, gpu, gparams, prompts, capture=True, temperature=1.0)
    for x, y in zip(a, b):
        assert x.out_tokens == y.out_tokens and x.out_logprobs == []
        assert len(y.out_logprobs) == len(y.out_tokens)
        assert all(np.isfinite(lp) and lp <= 0 for lp in y.out_logprobs)


@needs_cuda
@pytest.mark.parametrize("codec", ["int8", "int4"])
def test_publish_and_adopt_on_card(tmp_path, codec):
    """A card publisher's chain adopted by a card worker over the wire:
    the sha the publisher's, the params bitwise its reconstruction; int8
    deltas encode through kernel 2 and apply through kernel 4, once per
    float leaf (int4: kernel 4 only)."""
    cfg = get_config(ARCH).reduced()
    model = registry.get_model(cfg, "cuda")
    params = model.init(0)
    n_float = len(ck._flatten(params))
    pub = PolicyPublisher(str(tmp_path / "pub"), codec=codec, base_every=4,
                          keep_live=8, device="cuda")
    peer = pub.serve()
    try:
        pub.publish(0, {"params": params})
        enc0, add0 = (iq.pseudograd_encode_hist.launches,
                      iq.decode_add.launches)
        bumped = ck.unflatten_like(params, {
            k: v + 1e-3 for k, v in ck._flatten(params).items()})
        pub.publish(1, {"params": bumped})
        assert iq.pseudograd_encode_hist.launches - enc0 == \
            (n_float if codec == "int8" else 0)
        assert iq.decode_add.launches - add0 == n_float
        w = RolloutWorker(0, model, params, str(tmp_path / "w0"), max_len=32)
        add0 = iq.decode_add.launches
        rec = w.adopt([peer.addr])
        assert iq.decode_add.launches - add0 == n_float
        assert rec["version"] == 1 and rec["sha_verified"]
        assert rec["sha"] == pub.shas[1]
        want = pub.writer.reference({"params": bumped})["params"]
        for k, v in ck._flatten(want).items():
            assert torch.equal(ck._flatten(w.engine.params)[k].cpu(), v)
        ros, _ = w.generate([np.asarray([5, 6, 7], np.int32)], max_new=4)
        assert len(ros[0].logprobs) == len(ros[0].tokens)
    finally:
        peer.close()


@needs_cuda
def test_reduced_driver_card_vs_cpu(tmp_path):
    from repro_torch.rl import RLConfig, RLDriver
    out = {}
    for dev in ("cpu", "cuda"):
        cfg = RLConfig(device=dev, outer_steps=3, inner_steps=2,
                       engines=("continuous", "paged"))
        drv = RLDriver(cfg, tmp_path / dev)
        try:
            s = drv.run()
        finally:
            drv.close()
        out[dev] = {k: s[k] for k in COUNTS}
    assert out["cuda"] == out["cpu"]
    assert out["cuda"]["bit_exact"]
