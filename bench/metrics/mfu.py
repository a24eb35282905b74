"""mfu: the model step's share of the card's published peak in the
configuration's dtype: the window's model FLOPs (``bench.flops``: from
the configuration and the tokens trained) over the trainer's own
``inner_s`` summed over the window's outer steps (the host clock around
the inner phase, which ends in a device synchronise: forward, backward
and AdamW of every live slot, without the outer sync)."""
from bench import flops, peaks


def read(w):
    inner = sum(h["inner_s"] for h in w.steps)
    if inner <= 0 or w.tokens <= 0:
        return None
    f = flops.flops_per_token(w.config, w.traffic["seq_len"]) * w.tokens
    return 100.0 * f / inner / peaks.FLOPS[w.config["torch_dtype"]]
