"""codec_roofline: the int8 codec kernels' least time at the card's
published HBM rate (``bench.flops.codec_bytes_per_sync`` over the
window's syncs) over their summed device time in the traced window."""
from bench import flops, peaks

KERNELS = ("encode_hist_kernel", "hist_finish_kernel", "decode_kernel")
THETA_BYTES = {"bfloat16": 2, "float32": 4}


def read(w):
    if w.trace is None or not w.steps:
        return None
    dev = sum(t for name, t in w.trace.device_time_by_name().items()
              if any(k in name for k in KERNELS))
    if dev <= 0:
        return None
    need = len(w.steps) * flops.codec_bytes_per_sync(
        w.n_params, w.traffic["workers"],
        THETA_BYTES[w.config["torch_dtype"]])
    return 100.0 * need / peaks.HBM_BYTES_PER_S / dev
