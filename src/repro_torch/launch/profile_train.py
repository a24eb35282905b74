"""Where one training outer step's time goes: the inner phase and the
outer sync, each traced with ``torch.profiler`` on the card.

  PYTHONPATH=src python -m repro_torch.launch.profile_train \
      --arch internlm2-1.8b --n-layers 6 --workers 2 --max-workers 2 \
      --seq-len 512 --batch-per-worker 4 --inner-steps 4

It takes ``repro_torch.launch.train``'s arguments, builds the same
trainer, runs one outer step untimed (warm-up), then traces one inner
phase and one outer sync of the next step. For each it prints the host
wall time, the device's busy time and share of it, the kernel launches
and the top kernels by device time; for the sync also the int8 codec
kernels' device time and share. Then one JSON line with the same
numbers. Needs a CUDA device.
"""
from __future__ import annotations

import json
import time

TOP = 8
CODEC_KERNELS = ("encode_hist_kernel", "hist_reduce_kernel",
                 "decode_kernel")


def _traced(fn) -> dict:
    """Host wall time and device-side kernel times of ``fn()``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side entries only: the CPU ops that launched them carry the
    # same device time and would count it twice
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    dev = lambda e: e.self_device_time_total / 1e3
    busy = sum(dev(e) for e in kernels)
    codec = sum(dev(e) for e in kernels
                if any(k in e.key for k in CODEC_KERNELS))
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_busy_share": busy / wall_ms,
            "launches": sum(e.count for e in kernels),
            "codec_ms": codec,
            "top_kernels": [{"name": e.key[:80], "count": e.count,
                             "device_ms": dev(e)} for e in
                            sorted(kernels, key=dev, reverse=True)[:TOP]]}


def main(argv=None) -> dict:
    import torch

    from repro_torch.launch.train import build_parser, build_trainer

    args = build_parser().parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_train needs a CUDA device")
    tr = build_trainer(args)
    tr.run(1)                                        # warm-up step
    live = tr.sim.hb.live_ids()
    batches = {key: torch.stack([tr._batches(tr.cfg.diloco.inner_steps + i)
                                 [key] for i in range(
                                     tr.cfg.diloco.inner_steps)]).cuda()
               for key in ("tokens", "targets", "mask")}
    inner = _traced(lambda: tr._run_inner_phase(batches,
                                                tr.slots.live_mask(live)))
    weights = torch.as_tensor(tr.slots.live_mask(live), device="cuda")
    sync = _traced(lambda: tr._outer_sync(weights))
    out = {"arch": tr.model.cfg.name, "n_layers": tr.model.cfg.n_layers,
           "workers": len(live), "slots": tr.k,
           "inner_steps": tr.cfg.diloco.inner_steps,
           "device": torch.cuda.get_device_name(0),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "inner_phase": inner, "outer_sync": sync}
    for name, ph in (("inner phase", inner), ("outer sync", sync)):
        print(f"{name}: {ph['wall_ms']:.1f} ms wall, device busy "
              f"{ph['device_busy_ms']:.1f} ms = "
              f"{100 * ph['device_busy_share']:.1f}%, "
              f"{ph['launches']} launches, codec kernels "
              f"{ph['codec_ms']:.2f} ms")
        for t in ph["top_kernels"]:
            print(f"  {t['device_ms']:9.3f} ms  x{t['count']:<6} "
                  f"{t['name']}")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
