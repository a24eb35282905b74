"""The six readers of the program's spans on a hand-made window: records
with and without ``spans``, with and without device times, and a device
trace with two idle gaps, one under ``train.backward`` and one under
the benchmark's own ``bench.outer_step``."""
from __future__ import annotations

import sys

import pytest

pytest.importorskip("torch")

from bench_tiny import ROOT  # noqa: E402

sys.path[:0] = [str(ROOT), str(ROOT / "src")]
from bench import harness  # noqa: E402
from bench.devtrace import DeviceTrace  # noqa: E402

SPAN_READERS = ("forward_ms", "backward_ms", "adamw_ms", "codec_ms",
                "outer_apply_ms")
READERS = SPAN_READERS + ("step_idle_ms",)
MS = 1_000_000   # ns


def _rec(forward, backward, adamw, codec, apply):
    def s(n, dev):
        return {"n": n, "host_ms": 1.0, "device_ms": dev}
    return {"loss": 1.0, "inner_s": 1.0, "sync_s": 0.1, "spans": {
        "train.forward": s(*forward), "train.backward": s(*backward),
        "train.adamw": s(*adamw), "codec": s(*codec),
        "outer.apply": s(*apply)}}


def _trace():
    """A 1000 ms window: the card idle over 100-200 ms (under
    ``train.backward``, inside one of its operators) and over 600-700 ms
    (under ``bench.outer_step`` alone)."""
    dev = [(0, 100 * MS, "k0", 0), (200 * MS, 600 * MS, "k1", 0),
           (700 * MS, 1000 * MS, "k2", 0)]
    host = sorted([(0, 1000 * MS, "bench.outer_step"),
                   (10 * MS, 90 * MS, "train.forward"),
                   (95 * MS, 300 * MS, "train.backward"),
                   (140 * MS, 160 * MS, "aten::mm"),
                   (310 * MS, 500 * MS, "train.forward"),
                   (520 * MS, 580 * MS, "train.adamw"),
                   (620 * MS, 680 * MS, "codec")])
    return DeviceTrace(0, 1000 * MS, dev, host)


def _window(steps, trace=None):
    return harness.Window({}, {}, steps, 1.0, 1, 1, trace)


@pytest.fixture(scope="module")
def read():
    return {n: harness._reader(ROOT, n) for n in READERS}


def test_span_readers_average_the_device_times(read):
    w = _window([_rec((4, 400.0), (4, 800.0), (4, 240.0), (6, 30.0),
                      (2, 20.0)),
                 _rec((4, 440.0), (4, 840.0), (4, 260.0), (6, 34.0),
                      (2, 24.0))])
    got = {n: read[n](w) for n in SPAN_READERS}
    assert got == pytest.approx({
        "forward_ms": 105.0, "backward_ms": 205.0, "adamw_ms": 62.5,
        # per outer step, not per span
        "codec_ms": 32.0, "outer_apply_ms": 22.0})


def test_step_idle_counts_the_gaps_under_train_spans(read):
    # 100 ms under train.backward, over the trace's 2 train.forward
    # spans; the gap under bench.outer_step and codec is not the step's
    assert read["step_idle_ms"](_window([], _trace())) == \
        pytest.approx(50.0)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_readers_read_nothing_without_device_spans(read, name):
    parent = [{"loss": 1.0, "inner_s": 1.0, "sync_s": 0.1}]
    cpu = [_rec((4, None), (4, None), (4, None), (6, None), (2, None))]
    assert read[name](_window(parent)) is None
    assert read[name](_window(cpu)) is None
    assert read[name](_window([])) is None


def test_step_idle_reads_nothing_without_its_trace(read):
    t = _trace()
    assert read["step_idle_ms"](_window([])) is None
    no_device = DeviceTrace(t.start_ns, t.end_ns, [], t.host)
    assert read["step_idle_ms"](_window([], no_device)) is None
    # a program without spans: nothing on the host names the step
    parent = DeviceTrace(t.start_ns, t.end_ns, t.device,
                         [h for h in t.host if not
                          h[2].startswith("train.")])
    assert read["step_idle_ms"](_window([], parent)) is None
