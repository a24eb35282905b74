"""backward_ms: device ms of one worker-step's backward: the program's
``train.backward`` spans, each a CUDA event pair around
``loss.backward()`` (autograd's kernels run on the calling thread's
stream, between the pair), summed over the window and divided by their
count."""
from bench import program_spans


def read(w):
    return program_spans.per_span(w, "train.backward")
