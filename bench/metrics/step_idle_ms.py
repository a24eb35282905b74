"""step_idle_ms: the device's idle time that the model step's own host
work causes, a worker-step: each idle gap of the traced window is put
down to the program's ``train.*`` span (forward, backward, AdamW; they
do not nest) open on the host timeline at the gap's middle, and the
gaps so attributed are summed and divided by the window's
``train.forward`` spans. ``device_idle_share`` mixes this with the
sync and the outer-step boundary."""
import bisect


def read(w):
    if w.trace is None or not w.trace.device:
        return None
    train = [(s, t) for s, t, name in w.trace.host
             if name.startswith("train.")]
    steps = sum(1 for *_, name in w.trace.host if name == "train.forward")
    if not steps:
        return None
    starts = [s for s, _ in train]
    idle = 0
    for a, b in w.trace.idle_gaps():
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and train[i][1] > mid:
            idle += b - a
    return idle * 1e-6 / steps
