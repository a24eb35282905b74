"""forward_ms: device ms of one worker-step's forward (one slot's loss
over its rows): the program's ``train.forward`` spans, each a CUDA
event pair around ``model.loss``, summed over the window and divided by
their count."""
from bench import program_spans


def read(w):
    return program_spans.per_span(w, "train.forward")
