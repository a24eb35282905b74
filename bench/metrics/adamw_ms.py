"""adamw_ms: device ms of one worker-step's AdamW update (the eager
per-leaf update of one slot): the program's ``train.adamw`` spans
summed over the window and divided by their count."""
from bench import program_spans


def read(w):
    return program_spans.per_span(w, "train.adamw")
