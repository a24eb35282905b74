"""The correctness check fails what it must, at a CPU test's size with
the cells' own limits: the reference computed in fp8 (the control: the
next precision below the configurations' bf16), and a run whose timed
path is broken underneath (a step that leaves its state unchanged, half
of each batch left out, every inner step trained on its outer step's
first batch, the ring's exchange between workers left out). A sound run
of the same size passes."""
from __future__ import annotations

import sys

import pytest

torch = pytest.importorskip("torch")

from bench_tiny import ROOT, make_root  # noqa: E402

sys.path[:0] = [str(ROOT), str(ROOT / "src")]
from bench import check, harness  # noqa: E402
from bench.reference import model  # noqa: E402

SEED = 2 ** 31 + 101


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(tmp_path, monkeypatch, family):
    root, name = make_root(tmp_path, monkeypatch, family)
    return harness.run(harness.load_cell(name, root), SEED, 0.1, False,
                       device="cpu", log=lambda msg: None)


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_control_in_fp8_fails(tmp_path, monkeypatch, family):
    root, name = make_root(tmp_path, monkeypatch, family, "bfloat16")
    cell = harness.load_cell(name, root)
    ref = harness.reference_readings(cell, SEED, "cpu")
    ctl = harness.reference_readings(cell, SEED, "cpu",
                                     prec=model.Precision("fp8"))
    ok, _ = check.judge(check.gaps(ctl, ref), cell.limits)
    assert not ok


@pytest.mark.parametrize("fault", ["half_batch", "same_batch",
                                   "no_exchange"])
def test_faults_planted_in_the_reference_fail(tmp_path, monkeypatch, fault):
    root, name = make_root(tmp_path, monkeypatch, "dense", "bfloat16")
    cell = harness.load_cell(name, root)
    ref = harness.reference_readings(cell, SEED, "cpu")
    bad = harness.reference_readings(cell, SEED, "cpu", fault=fault)
    ok, _ = check.judge(check.gaps(bad, ref), cell.limits)
    assert not ok


def _unchanged(monkeypatch):
    from repro_torch.optim import adamw
    monkeypatch.setattr(adamw.AdamW, "update_",
                        lambda self, grads, state, params: None)


def _half_batch(monkeypatch):
    from repro_torch.models import transformer
    loss_fn = transformer.loss_fn

    def half(cfg, params, batch, **kw):
        return loss_fn(cfg, params, {k: v[: v.shape[0] // 2]
                                     for k, v in batch.items()}, **kw)
    monkeypatch.setattr(transformer, "loss_fn", half)


def _same_batch(monkeypatch):
    from repro_torch.train.loop import ElasticTrainer
    inner_phase = ElasticTrainer._inner_phase

    def first(self, params, opt_state, batches, active):
        return inner_phase(self, params, opt_state,
                           {k: v[:1].expand_as(v) for k, v in
                            batches.items()}, active)
    monkeypatch.setattr(ElasticTrainer, "_inner_phase", first)


def _no_exchange(monkeypatch):
    from repro_torch.core import ring_reduce
    monkeypatch.setattr(ring_reduce.RingSyncOp, "finish",
                        lambda self: self.xs.clone())


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_sound_run_passes(tmp_path, monkeypatch, family):
    assert _run(tmp_path, monkeypatch, family)["correct"] is True


@pytest.mark.parametrize("family", ["dense", "moe"])
@pytest.mark.parametrize(
    "plant", [_unchanged, _half_batch, _same_batch, _no_exchange],
    ids=["unchanged", "half_batch", "same_batch", "no_exchange"])
def test_broken_timed_path_fails(tmp_path, monkeypatch, family, plant):
    plant(monkeypatch)
    res = _run(tmp_path, monkeypatch, family)
    assert res["correct"] is False
    assert any(v["value"] > v["limit"] for v in res["checks"].values())
