"""outer_sync_ms: the trainer's own ``sync_s`` of each outer step of the
window (the host clock from the end of the inner phase to the synced
end of the outer step: pseudo-gradients, the ring, the Nesterov step
and the reset), averaged."""


def read(w):
    s = [h["sync_s"] for h in w.steps if "sync_s" in h]
    return 1e3 * sum(s) / len(s) if s else None
