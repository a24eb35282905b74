"""The device trace of a measured window, from ``torch.profiler``.

``DeviceTrace.from_profile`` reads the profiler's raw events once: the
window is the span of the benchmark's ``bench.window`` annotation on
the host; the device's work is every event on a CUDA device inside it
(kernels, copies, fills) but the benchmark's own annotations, which the
profiler mirrors onto the device's timeline; the host's activity is
every operator, annotation and runtime call.
Busy time is the union of the device intervals; the idle gaps are what
is left of the window, each named by what the host was doing at its
middle (the innermost host event open then).
"""
from __future__ import annotations

import bisect
import dataclasses

WINDOW = "bench.window"
OWN = "bench."            # the prefix of the benchmark's annotations
TOP = 10


def _span(e) -> tuple[int, int]:
    s = e.start_ns()
    return s, s + e.duration_ns()


@dataclasses.dataclass
class DeviceTrace:
    start_ns: int
    end_ns: int
    # (start_ns, end_ns, name, device index) of the device's work
    device: list
    # (start_ns, end_ns, name) of the host's activity, by start
    host: list

    @classmethod
    def from_profile(cls, prof) -> "DeviceTrace":
        from torch.autograd import DeviceType
        evs = prof.profiler.kineto_results.events()
        win = [e for e in evs if e.name() == WINDOW
               and e.device_type() == DeviceType.CPU]
        if not win:
            raise RuntimeError(f"no {WINDOW} span in the trace")
        lo, hi = _span(win[0])
        dev, host = [], []
        for e in evs:
            s, t = _span(e)
            name = e.name()
            if t <= lo or s >= hi:
                continue
            if e.device_type() == DeviceType.CUDA:
                if not name.startswith(OWN):
                    dev.append((max(s, lo), min(t, hi), name,
                                e.device_index()))
            elif name != WINDOW:
                host.append((s, t, name))
        host.sort()
        return cls(lo, hi, dev, host)

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def _busy_intervals(self, device_index=None) -> list:
        iv = sorted((s, t) for s, t, _, d in self.device
                    if device_index is None or d == device_index)
        out = []
        for s, t in iv:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return out

    def busy_s(self) -> float:
        """Seconds in which some operation ran, averaged over the
        devices that ran any."""
        devs = sorted({d for *_, d in self.device})
        if not devs:
            return 0.0
        return sum(sum(t - s for s, t in self._busy_intervals(d))
                   for d in devs) * 1e-9 / len(devs)

    def device_time_by_name(self) -> dict:
        out: dict = {}
        for s, t, name, _ in self.device:
            out[name] = out.get(name, 0) + (t - s) * 1e-9
        return out

    def idle_gaps(self) -> list:
        """(start_ns, end_ns) of every idle stretch of the window,
        longest first."""
        gaps, at = [], self.start_ns
        for s, t in self._busy_intervals():
            if s > at:
                gaps.append((at, s))
            at = max(at, t)
        if at < self.end_ns:
            gaps.append((at, self.end_ns))
        return sorted(gaps, key=lambda g: g[0] - g[1])

    def host_at(self, ns: int) -> str:
        """The innermost host event open at ``ns`` (the one that began
        last), or ``"python"``."""
        i = bisect.bisect_right(self.host, (ns, float("inf"), ""))
        best = None
        # host events nest; look back over those that began before ns
        for s, t, name in reversed(self.host[max(0, i - 4096):i]):
            if t > ns:
                best = name
                break
        return best or "python"

    def breakdown(self) -> dict:
        ops = sorted(self.device_time_by_name().items(),
                     key=lambda kv: -kv[1])[:TOP]
        gaps = [(self.host_at((s + t) // 2), (t - s) * 1e-9)
                for s, t in self.idle_gaps()[:TOP]]
        return {"device_ops": [[n, v] for n, v in ops],
                "idle_gaps": [[n, v] for n, v in gaps]}
