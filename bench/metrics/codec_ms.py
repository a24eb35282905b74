"""codec_ms: device ms of the int8 codec a sync: the program's ``codec``
spans (each wrapper of ``repro_torch.kernels.ops`` with its per-row
stats pass, the kernel and the codebook) summed over the window and
divided by its outer steps. ``codec_roofline`` sees the kernels
alone."""
from bench import program_spans


def read(w):
    return program_spans.per_outer_step(w, "codec")
