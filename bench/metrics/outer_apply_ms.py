"""outer_apply_ms: device ms of the outer apply a sync: the program's
``outer.apply`` spans (the flat Nesterov step with the unflatten, and
the reset of every slot to the new anchor) summed over the window and
divided by its outer steps."""
from bench import program_spans


def read(w):
    return program_spans.per_outer_step(w, "outer.apply")
