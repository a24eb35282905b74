"""The program's own spans in a window's history records: the trainer
(``repro_torch.spans``) stores ``{name: {"n", "host_ms", "device_ms"}}``
as ``rec["spans"]`` of each outer step taken under the profiler. A
program without spans, an untraced run or a run off the card leaves
nothing to read here, and the readers then return None."""


def device_totals(w, name: str):
    """(spans, their device ms, outer steps) of the span ``name`` over
    the window's records that hold spans, or None where none holds it
    or one of them ran without device times."""
    recs = [h["spans"] for h in w.steps if "spans" in h]
    got = [r[name] for r in recs if name in r]
    if not got or any(g["device_ms"] is None for g in got):
        return None
    return (sum(g["n"] for g in got), sum(g["device_ms"] for g in got),
            len(recs))


def per_span(w, name: str):
    """Device ms of one ``name`` span, averaged over the window."""
    t = device_totals(w, name)
    return t[1] / t[0] if t else None


def per_outer_step(w, name: str):
    """Device ms of the ``name`` spans of one outer step, averaged."""
    t = device_totals(w, name)
    return t[1] / t[2] if t else None
