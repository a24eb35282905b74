"""The trainer's spans (``repro_torch.spans``) on the CPU: inert without a
profiler, one span per unit of work under one (forward, backward and
AdamW per live worker and inner step; ``codec`` per codec wrapper call
of the ring; ``outer.apply`` per Nesterov apply and per reset), at the
profiler's FUNCTION scope, and without effect on what training
computes (losses, parameters and AdamW state bitwise). Imports no
JAX."""
import dataclasses
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs import get_config
from repro_torch.core import ring_reduce as rr
from repro_torch.core.diloco import DiLoCoConfig
from repro_torch.core.fault_tolerance import ClusterSimulator
from repro_torch.core.sync_engine import leaves
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.registry import get_model
from repro_torch.train.loop import ElasticTrainer, TrainerConfig

torch.set_num_threads(2)

ARCHS = {"dense": "internlm2-1.8b", "moe": "deepseek-moe-16b"}
WORKERS, SLOTS, H = 2, 3, 2
TRAIN = ("train.forward", "train.backward", "train.adamw")
# the history record's keys before the trainer had spans
PARENT_KEYS = {"outer_step", "live", "joined", "left", "loss", "ring_order",
               "attempts", "wire_bytes", "inner_s", "sync_s",
               "inner_chunk_s", "inner_hop_s"}


def _trainer(family: str) -> ElasticTrainer:
    cfg = dataclasses.replace(get_config(ARCHS[family]).reduced(),
                              dtype="float32")
    model = get_model(cfg, "cpu")
    tcfg = TrainerConfig(diloco=DiLoCoConfig(inner_steps=H, quant="int8"),
                         max_workers=SLOTS, validation=None)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=16, batch_per_worker=2)
    return ElasticTrainer(model, tcfg, dcfg, model.init(0),
                          ClusterSimulator(list(range(WORKERS)), events=[]))


def _keys(family: str) -> set:
    return PARENT_KEYS | ({"lb_loss"} if family == "moe" else set())


@pytest.fixture(autouse=True)
def _spans_off():
    yield
    spans.follow_profiler()


def test_span_is_inert_without_a_profiler(monkeypatch):
    """Off, a span is the one shared no-op context: it opens no profiler
    range and takes no CUDA event, and ``collect`` finds nothing."""
    def refuse(*a, **k):
        raise AssertionError("a span touched the profiler or CUDA")
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert spans.follow_profiler() is False
    ctx = spans.span("train.forward", torch.device("cuda"))
    assert ctx is spans.span("codec", torch.device("cpu"))
    with ctx:
        pass
    assert spans.collect() == {}


def test_spans_record_on_the_following_thread_alone():
    """A checkpoint writer's thread may run the codec while the trainer
    records: its spans are not the step's."""
    cpu = torch.device("cpu")

    def writer():
        with spans.span("codec", cpu):
            pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.follow_profiler() is True
        t = threading.Thread(target=writer)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        with spans.span("train.forward", cpu):
            pass
        got = spans.collect()
    assert {n: s["n"] for n, s in got.items()} == {"train.forward": 1}
    assert got["train.forward"]["device_ms"] is None


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_history_keeps_its_keys_without_a_profiler(family, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span touched the profiler")
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    tr = _trainer(family)
    for rec in tr.run(2):
        assert set(rec) == _keys(family)


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_spans_count_the_work_at_function_scope(family):
    tr = _trainer(family)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        hist = tr.run(2)
    codec = sum(rr.codec_calls(SLOTS, tr.cfg.diloco.ring).values())
    for rec in hist:
        assert set(rec) == _keys(family) | {"spans"}
        got = rec["spans"]
        want = dict.fromkeys(TRAIN, WORKERS * H)
        # the Nesterov apply and the reset of every slot
        want.update({"codec": codec, "outer.apply": 2})
        assert {n: s["n"] for n, s in got.items()} == want
        for s in got.values():
            assert s["device_ms"] is None and s["host_ms"] > 0
    scopes = {(e.name, e.scope) for e in prof.events() if e.name in want}
    fn = int(torch._C._profiler.RecordScope.FUNCTION)
    assert scopes == {(n, fn) for n in want}


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_spans_leave_training_bitwise_unchanged(family):
    off, on = _trainer(family), _trainer(family)
    loss_off = [h["loss"] for h in off.run(2)]
    with profile(activities=[ProfilerActivity.CPU]):
        loss_on = [h["loss"] for h in on.run(2)]
    assert loss_on == loss_off
    for a, b in [(off.params, on.params), (off.opt_state.m, on.opt_state.m),
                 (off.opt_state.v, on.opt_state.v)]:
        a, b = leaves(a), leaves(b)
        assert len(a) == len(b)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(off.opt_state.step, on.opt_state.step)
    assert torch.equal(off.outer.anchor_flat, on.outer.anchor_flat)
