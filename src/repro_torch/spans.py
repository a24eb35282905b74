"""Named spans of the training main path, on the profiler's clock.

Spans record only while a ``torch.profiler`` session is active: the
trainer calls ``follow_profiler()`` at the top of each outer step and
``collect()`` once the step's closing synchronise is done. There is no
other switch. Only the thread that called ``follow_profiler`` records
(a checkpoint writer's thread may run the codec meanwhile). Off,
``span`` returns one shared no-op context, at the cost of a module flag
check. On, a span

- opens ``torch._C._profiler._RecordFunctionFast(name)``: a range at
  FUNCTION scope on the profiler's host timeline, on the clock of its
  device events (``record_function`` opens one at USER_SCOPE, which
  kineto mirrors onto the device's timeline, where a trace reader
  would count it as device work);
- takes ``time.perf_counter_ns()`` at entry and exit;
- on a CUDA device, records a pair of timing events on the current
  stream, drawn from a pool that ``collect`` refills, so that no event
  is created after the first outer step.

Spans are not meant to nest: each aggregate is the span's whole time.
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch

_OFF = contextlib.nullcontext()
_owner = None           # the recording thread's ident while spans are on
_closed: list = []      # (name, host ns, (device, start, end) or None)
_pool: dict = {}        # device -> free (start, end) event pairs


def follow_profiler() -> bool:
    """Turn spans on exactly when a profiler session is active, and
    drop any span left uncollected. Returns whether they are on."""
    global _owner
    on = torch._C._autograd._profiler_enabled()
    _owner = threading.get_ident() if on else None
    _closed.clear()
    return on


def span(name: str, device: torch.device):
    """A context that records ``name`` while spans are on; ``device``
    is where the work inside runs."""
    if _owner is not None and _owner == threading.get_ident():
        return _Span(name, device)
    return _OFF


class _Span:
    __slots__ = ("name", "ev", "rf", "t0")

    def __init__(self, name: str, device: torch.device):
        self.name = name
        self.ev = None
        if device.type == "cuda":
            free = _pool.setdefault(device, [])
            self.ev = (device,) + (free.pop() if free else tuple(
                torch.cuda.Event(enable_timing=True) for _ in range(2)))

    def __enter__(self):
        self.rf = torch._C._profiler._RecordFunctionFast(self.name)
        self.rf.__enter__()
        if self.ev is not None:
            self.ev[1].record(torch.cuda.current_stream(self.ev[0]))
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.ev is not None:
            self.ev[2].record(torch.cuda.current_stream(self.ev[0]))
        self.rf.__exit__(*exc)
        _closed.append((self.name, t1 - self.t0, self.ev))
        return False


def collect() -> dict:
    """``{name: {"n", "host_ms", "device_ms"}}`` of the spans closed
    since ``follow_profiler``, summed by name (``device_ms`` None where
    a span ran off a CUDA device); turns spans off. Call it after a
    device synchronise: reading an event pair then never blocks."""
    global _owner
    _owner = None
    out: dict = {}
    for name, ns, ev in _closed:
        r = out.setdefault(name, {"n": 0, "host_ms": 0.0, "device_ms": 0.0})
        r["n"] += 1
        r["host_ms"] += ns * 1e-6
        if ev is None:
            r["device_ms"] = None
            continue
        if r["device_ms"] is not None:
            r["device_ms"] += ev[1].elapsed_time(ev[2])
        _pool[ev[0]].append(ev[1:])
    _closed.clear()
    return out
