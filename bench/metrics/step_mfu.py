"""step_mfu: the whole outer step's share of the card's published peak
in the configuration's dtype: the window's model FLOPs over the wall
time of its ``run(1)`` calls (batch staging, the inner phases, the ring,
the Nesterov step and the reset). It bounds what any kernel's gain can
give end to end."""
from bench import flops, peaks


def read(w):
    if w.seconds <= 0 or w.tokens <= 0:
        return None
    f = flops.flops_per_token(w.config, w.traffic["seq_len"]) * w.tokens
    return 100.0 * f / w.seconds / peaks.FLOPS[w.config["torch_dtype"]]
