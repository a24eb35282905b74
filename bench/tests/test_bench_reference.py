"""The plain reference agrees with the port at a CPU test's size, in
fp32: the same first outer steps of the dense and the MoE families, the
int8 ring mean, and the layout of the weights the benchmark makes."""
from __future__ import annotations

import sys

import pytest

torch = pytest.importorskip("torch")

from bench_tiny import ROOT, make_root, register  # noqa: E402

sys.path[:0] = [str(ROOT), str(ROOT / "src")]
from bench import harness, weights  # noqa: E402
from bench.reference import codec, model  # noqa: E402


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_reference_follows_the_port(tmp_path, monkeypatch, family):
    root, name = make_root(tmp_path, monkeypatch, family)
    cell = harness.load_cell(name, root)
    seed = 2 ** 33 + 11
    spec = model.spec_from_config(cell.config)
    w0 = weights.make(spec, seed, "cpu")
    tokens = harness.traffic_mod.Tokens(cell.traffic, spec.vocab, seed,
                                        "cpu")
    tr = harness.build_trainer(cell, w0, tokens, "cpu")
    prog = harness.first_steps(tr, cell, w0)
    ref = harness.reference_readings(cell, seed, "cpu")
    g = harness.check.gaps(prog, ref)
    # fp32 on both sides: rounding alone (sums in other orders, the
    # codec's statistics in fp64 here and fp32 in the port)
    assert g["loss_gap"] < 1e-5
    assert g["moment1_gap"] < 1e-5
    assert g["change_gap"] < 1e-3
    assert prog["loss"] == pytest.approx(ref["loss"], rel=1e-5)


@pytest.mark.parametrize("n", [1000, 4097])
def test_ring_mean_is_the_ports_ring(n):
    from repro_torch.core.ring_reduce import simulate_ring_all_reduce
    gen = torch.Generator().manual_seed(n)
    rows = torch.randn((2, n), generator=gen) * 1e-3
    mine = codec.ring_mean(rows)
    port = simulate_ring_all_reduce(rows.clone())
    assert torch.allclose(port[0], port[1])
    scale = rows.abs().max()
    assert (mine - port[0]).abs().max() < 1e-5 * scale
    # and the int8 codec is lossy: the mean is not the exact one
    assert (mine - rows.mean(0)).abs().max() > 1e-4 * scale


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_weights_have_the_ports_layout(monkeypatch, family):
    from bench_tiny import config
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    name = register(monkeypatch, family)
    spec = model.spec_from_config(config(name, family, "float32"))
    mine = dict(weights._walk(weights.shapes(spec)))
    port = dict((p, tuple(t.shape)) for p, t in weights._walk(
        transformer.alloc_lm(get_config(name), device="meta")))
    assert mine == port
    a = weights.make(spec, 9, "cpu")
    b = weights.make(spec, 9, "cpu")
    assert all(torch.equal(x, y) for (_, x), (_, y) in
               zip(weights._walk(a), weights._walk(b)))
