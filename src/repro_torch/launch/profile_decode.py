"""Where a decode step's time goes: host clock per step and a
``torch.profiler`` trace of a few steps of the serving model on the card.

  PYTHONPATH=src python -m repro_torch.launch.profile_decode \
      --arch intellect-1 --slots 4 --prompt-len 64 --max-len 512

It prefills ``--slots`` random prompts (random weights from ``--seed``),
with ``--block-size N`` copies the cache into a paged pool of N-cell
blocks (the paged engine's cache: decode then writes through the block
table and reads through the paged flash-decode kernel), then runs greedy
decode steps: 3 untimed, 8 timed with the host clock
around work that ends in a synchronize, and 8 more under the profiler.
It prints the step time, the
device's busy share of the profiled wall time, kernel launches per step,
the top kernels by device time and the flash-decode kernel's time per
launch, then one JSON line with the same numbers. ``--kernel-trace``
adds where one flash-decode launch's time goes, block by block: a
traced build of the dense kernel (``flash_decode.trace_phases``) runs
once at the model's attention shape, random q/K/V and the decode's
cache length, and the median and largest time of each phase over the
blocks that reach it go into the JSON line (``kernel_trace_us``). Needs
a CUDA device.

The SSM and hybrid families profile alike: ``--arch zamba2-2.7b``
(54 Mamba2 layers and 9 shared-attention applications a step, the
flash-decode kernel at 32 heads of 80) and ``--arch mamba2-130m``
(attention-free: no flash-decode launch, no kernel trace).
"""
from __future__ import annotations

import argparse
import json
import time

WARMUP, STEPS, TOP = 3, 8, 8


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.profile_decode")
    ap.add_argument("--arch", default="intellect-1")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--block-size", type=int, default=None,
                    help="decode on a paged cache of this block size")
    ap.add_argument("--kernel-trace", action="store_true",
                    help="also stamp the phases of one flash-decode launch")
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import flash_decode
    from repro_torch.models.registry import get_model

    if not torch.cuda.is_available():
        raise RuntimeError("profile_decode needs a CUDA device")
    cfg = get_config(args.arch)
    if args.kernel_trace and cfg.family == "ssm":
        raise ValueError(f"{cfg.name} is attention-free: no flash-decode "
                         "launch to trace")
    model = get_model(cfg, "cuda")
    params = model.init(args.seed)
    shape = ShapeConfig("profile", "decode", args.max_len, args.slots)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    prompts = torch.randint(2, cfg.vocab, (args.slots, args.prompt_len),
                            generator=gen, device="cuda", dtype=torch.int32)
    logits, cache = model.prefill(params, {"tokens": prompts},
                                  model.init_cache(args.slots, shape))
    tok = logits.argmax(-1, keepdim=True).to(torch.int32)
    if args.block_size:
        cache = _paged_copy(model, cache, args.slots, shape, args.block_size)

    def steps(n):
        nonlocal tok, cache
        for _ in range(n):
            logits, cache = model.decode(params, tok, cache)
            tok = logits.argmax(-1, keepdim=True).to(torch.int32)

    steps(WARMUP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(STEPS)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / STEPS * 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps(STEPS)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return e.self_device_time_total
    # device-side entries only (kernels, memcpy, memset): the CPU ops that
    # launched them carry the same device time and would count it twice
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    top = sorted(kernels, key=dev_us, reverse=True)[:TOP]
    fd = [e for e in kernels if flash_decode.KERNEL_NAME in e.key]
    fd_us = sum(dev_us(e) for e in fd)
    fd_calls = max((e.count for e in fd), default=0)
    out = {
        "arch": cfg.name, "slots": args.slots, "cache_len": args.prompt_len,
        "block_size": args.block_size,
        "device": torch.cuda.get_device_name(0),
        "step_ms": step_ms,
        "profiled_step_ms": wall_ms / STEPS,
        "device_busy_ms_per_step": busy_ms / STEPS,
        "device_busy_share": busy_ms / wall_ms if wall_ms else None,
        "kernel_launches_per_step": launches / STEPS,
        "flash_decode_us_per_call": fd_us / fd_calls if fd_calls else None,
        "flash_decode_share_of_busy": (fd_us / 1e3 / busy_ms
                                       if busy_ms else None),
        "top_kernels": [{"name": e.key[:80], "count": e.count,
                         "device_ms": dev_us(e) / 1e3} for e in top],
    }
    if args.kernel_trace:
        out["kernel_trace_us"] = _kernel_trace(cfg, args, flash_decode)
        print(f"flash-decode phases, us from the first block's entry "
              f"(median, max over blocks): {out['kernel_trace_us']}")
    paged = f" paged blk={args.block_size}" if args.block_size else ""
    print(f"{cfg.name} decode B={args.slots}{paged}: {step_ms:.2f} ms/step "
          f"(host clock), device busy {out['device_busy_ms_per_step']:.2f} "
          f"ms/step = {100 * (out['device_busy_share'] or 0):.1f}% of the "
          f"profiled wall, {out['kernel_launches_per_step']:.0f} kernel "
          f"launches/step")
    for t in out["top_kernels"]:
        print(f"  {t['device_ms']:9.3f} ms  x{t['count']:<6} {t['name']}")
    print(json.dumps(out))
    return out


def _kernel_trace(cfg, args, flash_decode) -> dict:
    """``flash_decode.trace_phases`` at the model's attention shape with
    every slot at the cache length the profiled steps reached: phase ->
    [median, max] microseconds over the blocks that reach it."""
    import torch
    hd = cfg.head_dim or cfg.d_model // cfg.n_heads
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            cfg.torch_dtype)
    q = randn(args.slots, 1, cfg.n_heads, hd)
    k = randn(args.slots, args.max_len, cfg.n_kv_heads, hd)
    v = randn(args.slots, args.max_len, cfg.n_kv_heads, hd)
    cache_len = min(args.prompt_len + WARMUP + 2 * STEPS, args.max_len)
    length = torch.full((args.slots,), cache_len, dtype=torch.int32,
                        device="cuda")
    stamps = flash_decode.trace_phases(q, k, v, length)
    out = {}
    for i, name in enumerate(flash_decode.PHASES):
        t = stamps[:, i][stamps[:, i] >= 0]
        out[name] = ([round(float(t.median()), 3), round(float(t.max()), 3)]
                     if len(t) else None)
    return out


def _paged_copy(model, cache, slots, shape, blk):
    """The dense cache's contents in a paged pool, every KV leaf (the
    dense prefix layers' too): slot b's virtual block i is pool block
    1 + b * nb + i (block 0 is trash); state leaves (an SSM's) copied
    as they are."""
    import torch

    from repro_torch.models.attention import kv_leaves, state_leaves
    from repro_torch.serving.paging import build_paged_cache
    paged, nb, _ = build_paged_cache(model, slots, shape, block_size=blk)
    pools = kv_leaves(paged)
    for dense, pool in zip(kv_leaves(cache), pools, strict=True):
        lead = pool.k.shape[:-4]
        cells = (slots, nb * blk) + tuple(pool.k.shape[-2:])
        pool.k[..., 1:, :, :, :].view(*lead, *cells).copy_(dense.k)
        pool.v[..., 1:, :, :, :].view(*lead, *cells).copy_(dense.v)
        pool.length.copy_(dense.length)
    for dense, same in zip(state_leaves(cache), state_leaves(paged),
                           strict=True):
        same.copy_(dense)
    if pools:                       # one table, shared by every KV leaf
        pools[0].table.copy_(torch.arange(
            1, slots * nb + 1, dtype=torch.int32,
            device=pools[0].table.device).view(slots, nb))
    return paged


if __name__ == "__main__":
    main()
