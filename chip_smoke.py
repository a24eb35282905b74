"""Chip smoke test of the PyTorch / H100 port (``src/repro_torch``).

  python3 chip_smoke.py

Needs one CUDA card and nvcc; imports nothing of JAX or of ``repro``.
Phases, each of which raises on failure (nothing is caught):

1. environment: the card (nvidia-smi name and power limit), torch, CUDA
   and nvcc versions;
2. build: every CUDA kernel of the ported paths, from the sources in
   this checkout (``src/repro_torch/kernels/csrc``), one nvcc per source;
3. kernels: each kernel against its plain PyTorch version on the card,
   at its main path's shapes (flash-decode and paged flash-decode at the
   serving shape, the four int8 codec kernels at the training ring's
   2 x 378,549,248 fp32 hop), with its time, its plain version's time,
   the time of the nearest PyTorch call (a yardstick the port never
   calls) and the least time the card could take; the paged kernel must
   also be bitwise equal to the dense one on the gathered view; the two
   encode kernels also on constant and heavy-tailed rows, and the device
   time of each of their launches (torch.profiler); both flash-decode
   kernels must repeat bit for bit, show exactly one device record per
   call in torch.profiler, and are also checked and timed at a long
   shape (B=4, S_max=8192, lengths [8192, 4096, 2048, 1]) beside SDPA;
4. reduced models: the reduced INTELLECT-1 served (continuous and paged
   engines) and trained on the card must agree with the same model on
   the CPU; the elastic schedule (below) on the reduced model, int8 and
   int4 with error feedback, must give the CPU's discrete history;
5. main path, serving: ``repro_torch.launch.serve`` serves INTELLECT-1
   at full width and depth (random weights from a seed) with the
   continuous, the wave and the paged engine; every request must finish
   with in-vocabulary tokens and the engine's flash-decode kernel (dense
   or paged) must launch once per layer per decode step, the other
   never; the paged engine's greedy tokens must equal the continuous
   engine's with batch-1 admission on the same trace; then the paged
   engine serves 48 requests with a shared system prompt at the dense
   engine's KV budget (4 slots x 512 cells) and must hold at least 4x
   the dense engine's 4 streams, with prefix hits and a copy-on-write
   fork;
6. main path, training: ``repro_torch.launch.train`` trains
   internlm2-1.8b at full width, depth cut to 6, two DiLoCo workers, the
   int8 ring, two outer steps; losses must be finite and every codec
   kernel must launch exactly as often per outer sync as the ring's
   formula says; one outer sync is then replayed from the same inputs
   with the plain codec on the card and the anchors must agree;
7. main path, elastic training: the trainer's ``run`` on internlm2-1.8b
   at full width, depth cut to 2, 4 DiLoCo slots (nodes 0-2 live), the
   int8 ring overlapped with the next inner phase over 7 chunks,
   contribution validation and a fixed link matrix whose slow edge the
   identity ring crosses; node 3 joins, node 1's contribution is
   poisoned and quarantined, node 2 crashes while its sync is in flight.
   Every event must show in the history, losses must be finite and the
   codec launches must equal what the ring geometry gives for the
   reductions that ran (restarts and the torn ring's hops included);
   the last delayed sync is replayed with the plain codec (anchors
   within the ring tolerance), and one ``RingSyncOp`` over the
   full-width rows, stepped one hop at a time, must equal
   ``simulate_ring_all_reduce`` bit for bit;
8. main path, checkpointed training and live recovery: a writer built
   by ``launch.train``'s parser and ``build_trainer`` trains
   internlm2-1.8b at full width, depth 1, 2 workers, the int8 ring,
   H = 4, 3 outer steps, with a delta checkpoint after each (one base,
   two int8 deltas: kernel 2 encodes, kernel 4 applies on the card),
   then serves its chunk store (``launch.train.serve_checkpoints``); a
   second trainer of the same configuration streams the checkpoint into
   its own store (``begin_stream_join``, the chain replayed through
   kernel 4 on the card) and runs one outer step. The join must be
   admitted at the writer's last step with a tree bitwise equal to the
   writer's reference, launches must equal the ring's plus one per
   float leaf per delta (writer: encode and apply; joiner: apply),
   losses finite, peak under 70 GiB; kernels 2 and 4 are also held
   against their plain versions at the embedding leaf's (1, 189,792,256)
   row and timed there. On the reduced INTELLECT-1 (bf16 parameters) a
   chain written on the card replays on the CPU and one written on the
   CPU on the card, each bitwise equal to its writer's reference, and
   the first delta's codes are the CPU writer's (bar elements within
   1e-4 bucket widths of an edge, which may move by one);
9. main path, the distributed outer sync: at the ring's full-width
   chunk, one (1, n) row a call as the ranks launch them, kernels 1, 3
   and 4 must agree with their plain versions and the one-row encode
   with the k-row encode bit for bit; internlm2-1.8b at full width, depth 1, 3 DiLoCo slots, int8,
   H = 7 in 7 chunks, the delayed overlap, error feedback, 3 outer
   steps, node 2 crashing at step 2 with its sync in flight, is trained
   with the simulated ring, then with ``DistSyncBackend`` over a (3,)
   mesh of rank processes on the card (the WAN ring over gloo through
   pinned host buffers, kernels 1-4 in the ranks). History, losses,
   parameters and anchor must be bitwise the simulated trainer's, the
   ring formed once, every reduction's launches summed over the ranks
   k x ``codec_calls`` (the torn ring's hops and the restart too), the
   controller peak under 70 GiB; then a (2, 2) mesh (WAN x local, both
   gloo) reduces 2 x 442,505,216 rows hierarchically, bitwise equal to
   the per-slice simulator (its chunk's rows checked as above).

10. main path, swarm serving: INTELLECT-1 at full width, depth cut to
   6, split into 3 stages of 2 layers with 2 ``StageServer`` replicas
   each over loopback (views of one weight set on the card), driven by
   a ``SwarmRouter`` on the serving trace (8 requests, 32 new tokens,
   greedy). Runs: the B = 1 engine; the healthy chain with dense stage
   caches and with paged stage pools (last-stage logits bitwise the
   B = 1 reference's); each again with stage 1's first holder crashed 3
   responses in (failover, re-prefill); stage 1 published into a seed
   store, adopted by a fresh server by swarm fetch and served by it
   alone. Every run's tokens equal the B = 1 engine's, paged pools
   drain, and kernel 5 (dense) or 6 (paged) launches once per layer per
   computed ``decode_stage``, the other never; kernels 5 and 6 are held
   against their plain versions at B = 1 and timed there.

11. the MoE and VLM families: kernels 5 and 6 at deepseek-moe-16b's
   and phi-3-vision-4.2b's attention shapes (16 heads of 128; 32 of 96,
   where 12 of 16 lanes work) at B = 4, S_max 512, at the VLM decode's
   own B = 2, S_max 1024, lengths 641 and 656, and at the MoE swarm's
   B = 1, against their plain versions and timed beside SDPA;
   ``launch.serve`` serves deepseek-moe-16b at full width and depth (28
   layers: dense0 + 27 MoE; 16.4 B parameters counted on the meta
   device) with the
   continuous and paged engines on phase 5's trace, kernel 5 (6)
   launching 28 times a decode step, the paged tokens equal to
   ``ContinuousEngine(batch_admit=False)``'s; its depth-4 swarm (2
   stages x 2 replicas, dense0 and its cache on stage 0) healthy dense
   and paged and with a stage-1 crash, tokens and every step's logits
   bitwise the B = 1 engine's; phi-3-vision-4.2b at full width and
   depth, a B = 2 prefill behind a 576-patch random frontend and 16
   greedy steps, each within ``VLM_TOL`` of the full forward (teacher
   forcing), and 2 stages bitwise the monolithic; the MoE loss at
   depth 2 on 2 x 512 tokens under autograd, loss, load-balance loss
   and dropped share finite, every gradient finite.

``python3 chip_smoke.py --dist-slots N`` builds and runs phase 9 alone
with N slots (how its slot count was sized), ``--swarm-only`` phase 10
alone, ``--moe-only`` phase 11 alone; none prints a result.

The last three lines are the kernels (JSON), the card (name, power
limit) and the result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import re
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 3e-2, torch.float32: 2e-5}
SERVE_ARGS = ["--arch", "intellect-1", "--slots", "4", "--requests", "8",
              "--prompt-len", "64", "--max-new", "32", "--max-len", "512"]
TRAIN_ARGS = ["--arch", "internlm2-1.8b", "--n-layers", "6", "--workers", "2",
              "--max-workers", "2", "--quant", "int8", "--seq-len", "512",
              "--batch-per-worker", "4", "--inner-steps", "4",
              "--outer-steps", "2"]
CODEC = ("pseudograd_encode_hist", "encode_hist", "decode_add", "decode")
# the elastic run: internlm2-1.8b at full width on 4 DiLoCo slots, nodes
# 0-2 live, int8 ring, the sync overlapped with the next inner phase
# over 2(k-1)+1 = 7 chunks, contribution validation on
ELASTIC = {"arch": "internlm2-1.8b", "n_layers": 2, "slots": 4, "live": 3,
           "inner_steps": 7, "inner_chunks": 7, "outer_steps": 5,
           "seq_len": 512, "batch_per_worker": 4, "inner_lr": 3e-4,
           "seed": 0}
# (outer step, kind, node, arg): node 3 joins; node 1's contribution is
# scaled by 1e6 (flagged, quarantined); node 2 crashes while the sync
# begun at step 3 is in flight (torn, re-reduced over the survivors)
ELASTIC_EVENTS = [(1, "join", 3, ""), (2, "poison", 1, "huge"),
                  (4, "crash", 2, "")]
# phase 8: internlm2-1.8b at full width, depth cut to 1 (the phase's host
# deflate and fetch scale with the parameters; a second layer added about
# 12% to its 200 s), 2 workers, int8 ring, H = 4, 3 outer steps, a delta
# checkpoint after each outer step: one base, then two int8 deltas
CKPT_ARGS = ["--arch", "internlm2-1.8b", "--n-layers", "1", "--workers", "2",
             "--max-workers", "2", "--quant", "int8", "--seq-len", "512",
             "--batch-per-worker", "4", "--inner-steps", "4",
             "--outer-steps", "3", "--ckpt-engine", "delta",
             "--ckpt-codec", "int8", "--ckpt-base-every", "8"]
PEAK_LIMIT_BYTES = 70 * 2**30
# phase 9: the distributed outer sync at full width: internlm2-1.8b,
# depth cut to 1, every slot a rank process on the card, int8, H = 7 in
# 7 chunks, the delayed overlap, error feedback on; node 2 crashes at
# step 2 while the sync begun at step 1 is in flight (torn, re-reduced).
# 3 slots, not 4: with error feedback the (2, k, n) fp32 residual and
# its commit-time copy are 13.19 GiB each at k = 4, and at 4 slots the
# simulated trainer runs out of an 80 GB card's memory at that copy
# (66.00 GiB allocated; ``--dist-slots 4`` shows it)
DIST = {"arch": "internlm2-1.8b", "n_layers": 1, "slots": 3,
        "inner_steps": 7, "inner_chunks": 7, "outer_steps": 3,
        "seq_len": 512, "batch_per_worker": 4, "inner_lr": 3e-4, "seed": 0}
DIST_EVENTS = [(2, "crash", 2, "")]
DIST_HIER = (2, 2)     # (WAN, local) ranks of the hierarchical check
# phase 10: swarm serving of INTELLECT-1 at full width, depth cut to 6
# (2,359,296,000 parameters, 4.72 GB bf16): publishing and adopting a
# stage go through the chunk store's host deflate and the swarm fetch,
# about 11 and 20 s a GB (phase 8's base write and fetch on the H100
# machine's host), so full depth would take minutes. 3
# stages of 2 layers, 2 replicas a stage, max_len 512, the serving trace
# (8 requests of 32-64 random prompt tokens, 32 new, greedy)
SWARM = {"arch": "intellect-1", "n_layers": 6, "stages": 3, "replicas": 2,
         "max_len": 512, "requests": 8, "prompt_len": 64, "max_new": 32,
         "seed": 0}
SWARM_B1_LENGTHS = (1, 63, 95, 511)   # kernels 5 and 6 at B = 1
# phase 11: the MoE and VLM families. deepseek-moe-16b at full width and
# depth (28 layers: dense0 + 27 MoE; 16.4 B parameters, 32.8 GB bf16)
# on the serving trace of phase 5; its swarm at depth 4 (dense0 + 3 MoE)
# in 2 stages x 2 replicas; phi-3-vision-4.2b at full width and depth
# (32 layers, 32 heads of 96) with a 576-patch frontend; the MoE loss
# under autograd at depth 2 on 2 x 512 tokens (T > 64: routes dropped)
MOE_SERVE = ["--arch", "deepseek-moe-16b", "--slots", "4", "--requests",
             "8", "--prompt-len", "64", "--max-new", "32", "--max-len",
             "512", "--block-size", "16"]
MOE_SWARM = {"arch": "deepseek-moe-16b", "n_layers": 4, "stages": 2,
             "replicas": 2, "max_len": 512, "requests": 8, "prompt_len": 64,
             "max_new": 32, "seed": 0}
VLM = {"arch": "phi-3-vision-4.2b", "batch": 2, "prompt_len": 64,
       "steps": 16, "max_len": 1024, "seed": 0}
# decode against the full forward (teacher forcing) in bf16 at 32 layers:
# logits are about unit scale (final RMSNorm, head at fan_in ** -0.5), a
# (1, D) and an (S, D) product round differently in bf16 (8 significant
# bits) in every layer, and prefill attention is not the flash-decode
# kernel, so the gate is a quarter of that scale
VLM_TOL = 0.25
MOE_TRAIN = {"arch": "deepseek-moe-16b", "n_layers": 2, "batch": 2,
             "seq_len": 512, "seed": 0}
# kernels 5 and 6 at the families' attention shapes: (label, B, S_max,
# Hk, G, dh, lengths); the last is phase 11's VLM decode itself (its
# cache of max_len cells, 576 patches + 64 tokens + steps 1 and 16); the
# MoE swarm's B = 1 stage calls are held by ``b1_flash_decode``
MOE_FD_CASES = [("deepseek-moe-16b", 4, 512, 16, 1, 128, [512, 1, 300, 77]),
                ("phi-3-vision-4.2b", 4, 512, 32, 1, 96, [512, 1, 300, 77]),
                ("phi-3-vision-4.2b decode", 2, 1024, 32, 1, 96, [641, 656])]
# (B, S_max, Hk, G, dh, lengths): INTELLECT-1's attention at a long cache,
# where the bytes rather than the latency chain should set the pace
FD_LONG = (4, 8192, 8, 4, 128, [8192, 4096, 2048, 1])
L2_FLUSH_BYTES = 256 << 20       # > the 50 MB L2: each timed call starts cold
SPIN_CYCLES = 2_000_000          # ~1 ms at the H100's 1.98 GHz boost clock
LEAD_SPINS = 4                   # spin kernels opening a profiled window


def log(msg: str) -> None:
    print(msg, flush=True)


def environment() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device visible: chip_smoke needs the GPU")
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    log(f"env: gpu=[{smi}] torch={torch.__version__} "
        f"cuda={torch.version.cuda} python={sys.version.split()[0]} "
        f"nvcc=[{nvcc}]")
    return smi


def build() -> None:
    from repro_torch.kernels import _build
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:   # one nvcc per source
        libs = list(pool.map(_build.build, names))
    log(f"build: {names} in {time.perf_counter() - t0:.1f}s")
    for lib in libs:    # ptxas -v, summed over the source's instances
        text = lib.with_suffix(".log").read_text()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill", text))
        log(f"  ptxas {lib.stem}: {len(regs)} kernels, {min(regs)}-"
            f"{max(regs)} registers, {spills} bytes of spills")


def time_ms(fn, iters: int = 50) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, each timed
    with CUDA events after a write of more than the L2 cache. A device
    spin of about a millisecond before the start event keeps the card
    busy while the host enqueues ``fn``, so the host's launch overhead
    stays out of the measurement."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def flash_decode_inputs(b, s_max, hk, g, dh, dtype, lengths, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return (randn(b, 1, hk * g, dh), randn(b, s_max, hk, dh),
            randn(b, s_max, hk, dh),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))


def flash_decode_bound(q, k, length, window,
                       extra_bytes: int = 0) -> tuple[float, str]:
    """Least time for this call: the live K/V cells, q and the output
    (and ``extra_bytes``, a paged call's block table) moved once,
    against the QK and PV products done once."""
    from repro_torch.models.attention import decode_valid_mask
    b, _, hq, dh = q.shape
    hk = k.shape[2]
    live = int(decode_valid_mask(length, k.shape[1], window).sum())
    size = q.element_size()
    nbytes = (2 * live * hk * dh * size + 2 * q.numel() * size
              + length.numel() * 4 + extra_bytes)
    flops = 4 * live * hq * dh
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def paged_pool(k, v, length, blk, seed):
    """A dense cache (B, S, Hk, dh) scattered into a PERMUTED pool of
    B * S / blk + 1 blocks (block 0 = trash, filled with noise); table
    entries past each slot's live blocks are -1."""
    b, s, hk, dh = k.shape
    nb = s // blk
    gen = torch.Generator().manual_seed(seed)
    table = (torch.randperm(b * nb, generator=gen) + 1).reshape(b, nb)
    kp = torch.randn((b * nb + 1, blk, hk, dh), device="cuda").to(k.dtype)
    vp = torch.randn_like(kp)
    for i in range(b):
        kp[table[i]] = k[i].reshape(nb, blk, hk, dh)
        vp[table[i]] = v[i].reshape(nb, blk, hk, dh)
        table[i, min(nb, -(-int(length[i]) // blk)):] = -1
    return kp, vp, table.to(device="cuda", dtype=torch.int32)


def check_repeat_and_close(label, out, again, ref, dtype) -> float:
    """``out`` within TOL of the plain ``ref``, finite, and a second
    call ``again`` bitwise equal to it; returns max |out - ref|."""
    err = (out.float() - ref.float()).abs().max().item()
    if not torch.isfinite(out).all() or err > TOL[dtype]:
        raise AssertionError(f"{label}: max |err| {err} > {TOL[dtype]}")
    if not torch.equal(out, again):
        raise AssertionError(f"{label}: a second call differs")
    return err


def one_kernel_per_call(label, fn) -> dict:
    """torch.profiler over ``calls`` calls of ``fn``: the flash-decode
    kernel is the only device kernel, recorded exactly once a call; its
    device ms a launch. A trace with no record at all (seen once) is
    taken again, up to three times."""
    from repro_torch.kernels import flash_decode as fd
    calls = 10
    for _ in range(3):
        kernels = device_kernels(fn, calls)
        if kernels:
            break
    if (len(kernels) != 1 or fd.KERNEL_NAME not in kernels[0][0]
            or kernels[0][1] != calls):
        raise AssertionError(f"{label}: want one {fd.KERNEL_NAME} launch a "
                             f"call, torch.profiler saw {kernels} over "
                             f"{calls} calls")
    name, recorded, ms = kernels[0]
    split = {name[name.index(fd.KERNEL_NAME):].split("(")[0]:
             ms / recorded}
    log(f"kernel {label} launches, device ms per call (torch.profiler, "
        f"{recorded} of {calls} launches recorded): {json.dumps(split)}")
    return split


def kernel_records(run) -> dict:
    """Over one ``run()`` under ``torch.profiler``, from its raw events
    rather than ``key_averages()``: the device records by kind (paged or
    dense flash-decode, spin, other), how many of them have no self
    device time, and the CPU launch calls."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kinds, zero, launches = Counter(), 0, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kinds["spin" if "spin" in e.name else "paged"
                  if ", true>" in e.name else "dense"
                  if "flash_decode_kernel" in e.name else "other"] += 1
            zero += e.self_device_time_total <= 0
        elif "LaunchKernel" in e.name:
            launches += 1
    return {"records": dict(kinds), "zero_time": zero,
            "launch_calls": launches}


def paged_record_loss(q, kp, vp, table, length) -> dict:
    """What torch.profiler records of the flash-decode kernels with no
    lead kernels in the window: over 10, 20 and 40 paged calls, 10 paged
    calls alternating with the dense kernel, 10 paged calls after 4 spin
    kernels, and 10 dense calls. Call i takes q * (1 + i/64); every
    output is checked bitwise against the dense kernel on the gathered
    view afterwards, so a call whose record is missing is still shown
    to have run."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models.attention import PagedKVCache, paged_view
    view = paged_view(PagedKVCache(kp, vp, table, length))
    out = {}
    for calls, mode in ((10, ""), (20, ""), (40, ""), (10, "alternating"),
                        (10, "after 4 spins"), (10, "dense only")):
        qs = [q * (1 + i / 64) for i in range(calls)]
        want = [fd.flash_decode(qi, view.k, view.v, length) for qi in qs]
        got = []

        def run():
            if mode == "after 4 spins":
                for _ in range(4):
                    torch.cuda._sleep(1000)
            for qi in qs:
                if mode == "dense only":
                    got.append(fd.flash_decode(qi, view.k, view.v, length))
                    continue
                got.append(fd.flash_decode_paged(qi, kp, vp, table, length))
                if mode == "alternating":
                    fd.flash_decode(qi, view.k, view.v, length)
        out[f"{calls} {mode}".strip()] = dict(
            kernel_records(run), calls=calls,
            outputs_right=sum(torch.equal(g, w) for g, w in zip(got, want)))
    log(f"flash-decode under torch.profiler, no lead kernels: "
        f"{json.dumps(out)}")
    return out


def check_flash_decode_paged() -> dict:
    """Kernel 6 at the serving shape: a permuted 129-block pool of
    16-cell blocks, against its plain version and bitwise against the
    dense kernel on the gathered view. Library yardstick: the gather
    (``paged_view``) and SDPA with ``enable_gqa`` timed together; SDPA
    alone on the gathered view beside it."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models.attention import (PagedKVCache, decode_valid_mask,
                                              paged_view)
    cases = [  # (label, B, S_max, Hk, G, dh, dtype, lengths, window, blk)
        ("serve-bf16", 4, 512, 8, 4, 128, torch.bfloat16, [0, 1, 300, 512],
         None, 16),
        ("serve-fp32", 4, 512, 8, 4, 128, torch.float32, [0, 1, 300, 512],
         None, 16),
        ("swa-wrap-bf16", 11, 256, 8, 4, 128, torch.bfloat16,
         list(range(255, 266)), 256, 16),
    ]
    result = None
    for i, (label, b, s, hk, g, dh, dtype, lengths, window, blk) in \
            enumerate(cases):
        q, k, v, length = flash_decode_inputs(b, s, hk, g, dh, dtype,
                                              lengths, seed=10 + i)
        # an SWA ring that wrapped has every block live
        kp, vp, table = paged_pool(k, v, [s] * b if window else lengths,
                                   blk, seed=i)
        del k, v
        out = fd.flash_decode_paged(q, kp, vp, table, length, window=window)
        again = fd.flash_decode_paged(q, kp, vp, table, length,
                                      window=window)
        torch.cuda.synchronize()
        ref = fd.flash_decode_paged_torch(q, kp, vp, table, length,
                                          window=window)
        err = check_repeat_and_close(f"flash_decode_paged {label}", out,
                                     again, ref, dtype)
        view = paged_view(PagedKVCache(kp, vp, table, length))
        dense = fd.flash_decode(q, view.k, view.v, length, window=window)
        if not torch.equal(out, dense):
            raise AssertionError(f"flash_decode_paged {label}: not bitwise "
                                 "equal to flash_decode on the gathered view")
        if lengths[0] == 0 and out[0].abs().max().item() != 0.0:
            raise AssertionError(f"flash_decode_paged {label}: empty slot "
                                 "not 0")
        log(f"kernel flash_decode_paged {label}: max|err|={err:.3g} "
            f"(tol {TOL[dtype]}), a second call bitwise equal, bitwise "
            f"equal to flash_decode on the gathered view")
        if label != "serve-bf16":
            continue
        valid = decode_valid_mask(length, s, window)[:, None, None, :]
        qt = q.transpose(1, 2)

        def library():
            vw = paged_view(PagedKVCache(kp, vp, table, length))
            return torch.nn.functional.scaled_dot_product_attention(
                qt, vw.k.transpose(1, 2), vw.v.transpose(1, 2),
                attn_mask=valid, enable_gqa=True)
        kt, vt = view.k.transpose(1, 2), view.v.transpose(1, 2)

        def sdpa_only():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=valid, enable_gqa=True)
        bound, bound_by = flash_decode_bound(q, view.k, length, window,
                                             extra_bytes=table.numel() * 4)
        result = {
            "name": "flash_decode_paged", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/flash_decode.py:262",
            "launches": None, "max_abs_err": err,
            "ms": time_ms(lambda: fd.flash_decode_paged(q, kp, vp, table,
                                                        length)),
            "plain_ms": time_ms(lambda: fd.flash_decode_paged_torch(
                q, kp, vp, table, length)),
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": time_ms(library),
            "library_sdpa_only_ms": time_ms(sdpa_only),
            "dense_kernel_ms": time_ms(lambda: fd.flash_decode(
                q, view.k, view.v, length)),
            "shape": {"B": b, "S_max": s, "Hk": hk, "G": g, "dh": dh,
                      "blk": blk, "pool_blocks": kp.shape[0],
                      "dtype": "bfloat16", "lengths": lengths},
        }
        log(f"kernel flash_decode_paged serve-bf16: {result['ms']:.5f} ms, "
            f"dense kernel on the view {result['dense_kernel_ms']:.5f} ms, "
            f"bound {bound:.6f} ms, plain {result['plain_ms']:.5f} ms, "
            f"gather+SDPA {result['library_ms']:.5f} ms, SDPA alone "
            f"{result['library_sdpa_only_ms']:.5f} ms")
        result["launch_split_ms"] = one_kernel_per_call(
            "flash_decode_paged serve-bf16",
            lambda: fd.flash_decode_paged(q, kp, vp, table, length))
        result["profiler_records"] = paged_record_loss(q, kp, vp, table,
                                                       length)
    result.update(flash_decode_paged_long())
    return result


def flash_decode_paged_long() -> dict:
    """Kernel 6 at ``FD_LONG`` on a permuted pool of 16-cell blocks:
    against its plain version, bitwise against the dense kernel on the
    gathered view, repeated bitwise; timed beside gather + SDPA."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models.attention import (PagedKVCache, decode_valid_mask,
                                              paged_view)
    b, s, hk, g, dh, lengths = FD_LONG
    blk = 16
    q, k, v, length = flash_decode_inputs(b, s, hk, g, dh, torch.bfloat16,
                                          lengths, seed=21)
    kp, vp, table = paged_pool(k, v, lengths, blk, seed=21)
    del k, v
    torch.cuda.empty_cache()
    out = fd.flash_decode_paged(q, kp, vp, table, length)
    again = fd.flash_decode_paged(q, kp, vp, table, length)
    torch.cuda.synchronize()
    err = check_repeat_and_close(
        "flash_decode_paged long", out, again,
        fd.flash_decode_paged_torch(q, kp, vp, table, length), q.dtype)
    view = paged_view(PagedKVCache(kp, vp, table, length))
    if not torch.equal(out, fd.flash_decode(q, view.k, view.v, length)):
        raise AssertionError("flash_decode_paged long: not bitwise equal to "
                             "flash_decode on the gathered view")
    valid = decode_valid_mask(length, s, None)[:, None, None, :]
    qt = q.transpose(1, 2)

    def library():
        vw = paged_view(PagedKVCache(kp, vp, table, length))
        return torch.nn.functional.scaled_dot_product_attention(
            qt, vw.k.transpose(1, 2), vw.v.transpose(1, 2),
            attn_mask=valid, enable_gqa=True)
    bound, _ = flash_decode_bound(q, view.k, length, None,
                                  extra_bytes=table.numel() * 4)
    long = {
        "long_ms": time_ms(lambda: fd.flash_decode_paged(q, kp, vp, table,
                                                         length)),
        "long_bound_ms": bound, "long_library_ms": time_ms(library),
        "long_dense_kernel_ms": time_ms(lambda: fd.flash_decode(
            q, view.k, view.v, length)),
        "long_max_abs_err": err,
        "long_shape": {"B": b, "S_max": s, "Hk": hk, "G": g, "dh": dh,
                       "blk": blk, "pool_blocks": kp.shape[0],
                       "dtype": "bfloat16", "lengths": lengths},
    }
    long["long_launch_split_ms"] = one_kernel_per_call(
        "flash_decode_paged long",
        lambda: fd.flash_decode_paged(q, kp, vp, table, length))
    log(f"kernel flash_decode_paged long {FD_LONG[:5]} {lengths}: "
        f"max|err|={err:.3g}, repeat and dense-view bitwise equal; "
        f"{long['long_ms']:.5f} ms, dense kernel on the view "
        f"{long['long_dense_kernel_ms']:.5f} ms, bound {bound:.6f} ms, "
        f"gather+SDPA {long['long_library_ms']:.5f} ms")
    del q, kp, vp, table, view
    torch.cuda.empty_cache()
    return long


def check_flash_decode() -> dict:
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models.attention import decode_valid_mask
    cases = [  # (label, B, S_max, Hk, G, dh, dtype, lengths, window)
        ("serve-bf16", 4, 512, 8, 4, 128, torch.bfloat16, [0, 1, 300, 512],
         None),
        ("serve-fp32", 4, 512, 8, 4, 128, torch.float32, [0, 1, 300, 512],
         None),
        ("swa-wrap-bf16", 11, 256, 8, 4, 128, torch.bfloat16,
         list(range(255, 266)), 256),
    ]
    result = None
    for i, (label, b, s, hk, g, dh, dtype, lengths, window) in \
            enumerate(cases):
        q, k, v, length = flash_decode_inputs(b, s, hk, g, dh, dtype,
                                              lengths, seed=i)
        out = fd.flash_decode(q, k, v, length, window=window)
        again = fd.flash_decode(q, k, v, length, window=window)
        torch.cuda.synchronize()
        ref = fd.flash_decode_torch(q, k, v, length, window=window)
        err = check_repeat_and_close(f"flash_decode {label}", out, again,
                                     ref, dtype)
        if lengths[0] == 0 and out[0].abs().max().item() != 0.0:
            raise AssertionError(f"flash_decode {label}: empty slot not 0")
        log(f"kernel flash_decode {label}: max|err|={err:.3g} "
            f"(tol {TOL[dtype]}), a second call bitwise equal")
        if label != "serve-bf16":
            continue
        valid = decode_valid_mask(length, s, window)[:, None, None, :]
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=valid, enable_gqa=True)
        bound, bound_by = flash_decode_bound(q, k, length, window)
        result = {
            "name": "flash_decode", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/flash_decode.py:282",
            "launches": None, "max_abs_err": err,
            "ms": time_ms(lambda: fd.flash_decode(q, k, v, length)),
            "plain_ms": time_ms(
                lambda: fd.flash_decode_torch(q, k, v, length)),
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": time_ms(library),
            "shape": {"B": b, "S_max": s, "Hk": hk, "G": g, "dh": dh,
                      "dtype": "bfloat16", "lengths": lengths},
        }
        log(f"kernel flash_decode serve-bf16: {result['ms']:.5f} ms, bound "
            f"{bound:.6f} ms, plain {result['plain_ms']:.5f} ms, SDPA "
            f"{result['library_ms']:.5f} ms")
        result["launch_split_ms"] = one_kernel_per_call(
            "flash_decode serve-bf16", lambda: fd.flash_decode(q, k, v,
                                                               length))
    result.update(flash_decode_long())
    return result


def flash_decode_long() -> dict:
    """Kernel 5 at ``FD_LONG``: against its plain version, repeated
    bitwise; timed beside SDPA."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models.attention import decode_valid_mask
    b, s, hk, g, dh, lengths = FD_LONG
    q, k, v, length = flash_decode_inputs(b, s, hk, g, dh, torch.bfloat16,
                                          lengths, seed=20)
    out = fd.flash_decode(q, k, v, length)
    again = fd.flash_decode(q, k, v, length)
    torch.cuda.synchronize()
    err = check_repeat_and_close("flash_decode long", out, again,
                                 fd.flash_decode_torch(q, k, v, length),
                                 q.dtype)
    valid = decode_valid_mask(length, s, None)[:, None, None, :]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=valid, enable_gqa=True)
    bound, _ = flash_decode_bound(q, k, length, None)
    long = {
        "long_ms": time_ms(lambda: fd.flash_decode(q, k, v, length)),
        "long_bound_ms": bound, "long_library_ms": time_ms(library),
        "long_max_abs_err": err,
        "long_shape": {"B": b, "S_max": s, "Hk": hk, "G": g, "dh": dh,
                       "dtype": "bfloat16", "lengths": lengths},
    }
    long["long_launch_split_ms"] = one_kernel_per_call(
        "flash_decode long", lambda: fd.flash_decode(q, k, v, length))
    log(f"kernel flash_decode long {FD_LONG[:5]} {lengths}: "
        f"max|err|={err:.3g}, repeat bitwise equal; {long['long_ms']:.5f} "
        f"ms, bound {bound:.6f} ms, SDPA {long['long_library_ms']:.5f} ms")
    del q, k, v, kt, vt
    torch.cuda.empty_cache()
    return long


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def check_reduced_model() -> None:
    """The reduced INTELLECT-1 in fp32 on the card (flash-decode kernel)
    against the same weights on the CPU (its plain version)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.registry import get_model
    cfg = get_config("intellect-1").reduced()
    cpu, gpu = get_model(cfg, "cpu"), get_model(cfg, "cuda")
    params = cpu.init(0)
    gparams = to_device(params, "cuda")
    shape = ShapeConfig("smoke", "decode", 64, 3)
    toks = torch.randint(2, cfg.vocab, (3, 16),
                         generator=torch.Generator().manual_seed(0),
                         dtype=torch.int32)
    plen = torch.tensor([16, 5, 11], dtype=torch.int32)
    lc, cc = cpu.prefill(params, {"tokens": toks, "prompt_len": plen},
                         cpu.init_cache(3, shape))
    lg, cg = gpu.prefill(gparams, {"tokens": toks.cuda(),
                                   "prompt_len": plen.cuda()},
                         gpu.init_cache(3, shape))
    worst = (lg.cpu() - lc).abs().max().item()
    tok = lc.argmax(-1, keepdim=True).to(torch.int32)
    for _ in range(6):
        lc, cc = cpu.decode(params, tok, cc)
        lg, cg = gpu.decode(gparams, tok.cuda(), cg)
        worst = max(worst, (lg.cpu() - lc).abs().max().item())
        tok = lc.argmax(-1, keepdim=True).to(torch.int32)
    if worst > 1e-3:
        raise AssertionError(f"reduced model GPU vs CPU: max|err| {worst}")
    log(f"reduced intellect-1 fp32 GPU vs CPU: max|logit err|={worst:.3g}"
        " (tol 1e-3)")


def check_reduced_paged() -> None:
    """The reduced INTELLECT-1 in fp32 on the paged engine, card (paged
    kernel) against CPU (its plain version), on a shared-prefix trace
    with a verbatim repeat: greedy tokens equal, each request's
    first-token logits within 1e-3, and prefix hits, a copy-on-write
    fork and chunked-prefill segments on both."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.serving.engine import Request
    from repro_torch.serving.paging import PagedEngine
    cfg = get_config("intellect-1").reduced()
    params = get_model(cfg, "cpu").init(0)
    rng = np.random.default_rng(0)
    system = rng.integers(2, cfg.vocab, size=37).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(
        2, cfg.vocab, size=n).astype(np.int32)]) for n in (5, 9, 2)]
    prompts += [prompts[0].copy(), rng.integers(2, cfg.vocab, size=20)
                .astype(np.int32)]
    runs = {}
    for dev in ("cpu", "cuda"):
        eng = PagedEngine(get_model(cfg, dev), to_device(params, dev),
                          batch_slots=5, max_len=64, decode_chunk=4)
        firsts, admit = {}, eng._admit_state

        def record(req, slot, logits, firsts=firsts, admit=admit):
            firsts[req.rid] = logits.float().cpu()
            admit(req, slot, logits)
        eng._admit_state = record
        reqs = [Request(i, p, max_new_tokens=8) for i, p in
                enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        del eng._admit_state
        s = eng.perf_summary()
        if not all(r.done for r in reqs) or not all(
                s[k] > 0 for k in ("prefix_hits", "cow_forks",
                                   "paged_extends")):
            raise AssertionError(f"reduced paged {dev}: {s}")
        runs[dev] = ([r.out_tokens for r in reqs], firsts, s)
    (tc, fc, sc), (tg, fg, sg) = runs["cpu"], runs["cuda"]
    if tg != tc:
        raise AssertionError(f"reduced paged GPU vs CPU tokens: {tg} vs {tc}")
    worst = max((fg[r] - fc[r]).abs().max().item() for r in fc)
    if worst > 1e-3:
        raise AssertionError(f"reduced paged GPU vs CPU: first-token logits "
                             f"max|err| {worst}")
    log(f"reduced intellect-1 fp32 paged GPU vs CPU: tokens equal, "
        f"first-token max|logit err|={worst:.3g} (tol 1e-3); "
        f"prefix_hits={sg['prefix_hits']} cow_forks={sg['cow_forks']} "
        f"paged_extends={sg['paged_extends']}")


def check_launches(label, counts, kernel, want) -> int:
    """``kernel`` launched ``want`` times, the other decode kernel never."""
    for name, n in counts.items():
        if n != (want if name == kernel else 0):
            raise AssertionError(
                f"{label}: {name} launched {n} times, want "
                f"{want if name == kernel else 0} ({kernel} = layers x "
                f"decode steps)")
    return counts[kernel]


def decode_counts() -> dict:
    from repro_torch.kernels import flash_decode as fd
    return {"flash_decode": fd.flash_decode.launches,
            "flash_decode_paged": fd.flash_decode_paged.launches}


def reset_decode_counts() -> None:
    from repro_torch.kernels import flash_decode as fd
    fd.flash_decode.launches = 0
    fd.flash_decode_paged.launches = 0


def serve(engine: str, run: int) -> dict:
    from repro_torch.launch import serve as serve_mod
    argv = SERVE_ARGS + ["--engine", engine]
    torch.cuda.reset_peak_memory_stats()
    reset_decode_counts()
    s = serve_mod.main(argv)
    counts = decode_counts()
    torch.cuda.synchronize()
    if not all(s["done"]) or s["requests"] != 8:
        raise AssertionError(f"{engine}: not every request finished")
    toks = [t for o in s["outputs"] for t in o]
    if not toks or not all(0 <= t < s["padded_vocab"] for t in toks):
        raise AssertionError(f"{engine}: token outside the vocabulary")
    kernel = "flash_decode_paged" if engine == "paged" else "flash_decode"
    launches = check_launches(engine, counts, kernel,
                              s["n_layers"] * s["decode_steps"])
    extra = (f" blocks_peak={s['blocks_peak']}/{s['pool_blocks']}"
             if engine == "paged" else "")
    log(f"main path {engine} run {run}: tok/s={s['tokens_per_s']:.1f} "
        f"p50={s['latency_p50_s'] * 1e3:.1f}ms "
        f"p95={s['latency_p95_s'] * 1e3:.1f}ms "
        f"decode_steps={s['decode_steps']} launches={launches} "
        f"tokens={s['tokens_out']} wall={s['wall_s']:.3f}s peak_mem="
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f}GiB{extra}")
    s["launches"] = launches
    gc.collect()
    torch.cuda.empty_cache()
    return s


def serve_paged_checks(paged_outputs) -> dict:
    """Beside the paged main path, on the same weights: (1) the
    launcher's trace through ContinuousEngine with batch-1 admission
    must give the paged run's greedy tokens; (2) the paged engine at the
    dense engine's KV budget (4 slots x 512 cells = 128 blocks of 16 +
    trash) serves 32 slots: 48 requests of a 48-token system prompt and
    8 distinct tokens (two repeat an earlier prompt verbatim), 8 new
    tokens each; concurrency is probed at ``_before_chunk``."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models.registry import get_model
    from repro_torch.serving.engine import Request, make_engine
    from repro_torch.serving.paging import PagedEngine
    args = serve_mod.build_parser().parse_args(SERVE_ARGS)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = get_model(cfg, args.device)
    params = model.init(args.seed)
    out = {}
    for run in (1, 2):
        eng = make_engine("continuous", model, params, batch_admit=False,
                          **serve_mod.engine_kwargs(args))
        reqs = serve_mod.make_requests(args, cfg.vocab)
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        toks = [list(r.out_tokens) for r in reqs]
        if toks != paged_outputs:
            raise AssertionError("paged greedy tokens differ from "
                                 "ContinuousEngine(batch_admit=False)'s")
        out["continuous_b1"] = eng.perf_summary()
        log(f"continuous batch_admit=False run {run}: identical greedy "
            f"tokens to the paged run; tok/s="
            f"{out['continuous_b1']['tokens_per_s']:.1f} "
            f"p50={out['continuous_b1']['latency_p50_s'] * 1e3:.1f}ms "
            f"p95={out['continuous_b1']['latency_p95_s'] * 1e3:.1f}ms")
        del eng
    torch.cuda.empty_cache()

    dense_slots, blk = args.slots, 16
    budget = dense_slots * args.max_len // blk
    rng = np.random.default_rng(3)
    system = rng.integers(2, cfg.vocab, size=48).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(
        2, cfg.vocab, size=8).astype(np.int32)]) for _ in range(48)]
    prompts[5], prompts[9] = prompts[2].copy(), prompts[3].copy()
    eng = PagedEngine(model, params, batch_slots=32, max_len=args.max_len,
                      decode_chunk=args.decode_chunk, block_size=blk,
                      pool_blocks=budget + 1, seed=args.seed)
    pool = eng.cache["scan"]
    pool_bytes = 2 * pool.k.numel() * pool.k.element_size()
    peak, seam = 0, eng._before_chunk

    def probe():
        nonlocal peak
        peak = max(peak, sum(r is not None for r in eng.active))
        seam()
    eng._before_chunk = probe
    reqs = [Request(i, p, max_new_tokens=8) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    reset_decode_counts()
    eng.run_until_drained()
    counts = decode_counts()
    torch.cuda.synchronize()
    del eng._before_chunk, seam, probe    # no cycle keeps the weights
    s = eng.perf_summary()
    launches = check_launches("paged at fixed KV memory", counts,
                              "flash_decode_paged",
                              cfg.n_layers * s["decode_steps"])
    if not all(r.done for r in reqs):
        raise AssertionError("paged at fixed KV memory: a request did not "
                             "finish")
    if (peak < 4 * dense_slots or s["prefix_hit_rate"] <= 0
            or s["cow_forks"] < 1 or eng.stats["prefills"] >= len(reqs)):
        raise AssertionError(f"paged at fixed KV memory: peak {peak} "
                             f"streams (want >= {4 * dense_slots}), {s}")
    log(f"paged at fixed KV memory ({budget} blocks of {blk} cells = "
        f"{dense_slots} dense slots x {args.max_len}, pool "
        f"{pool_bytes / 1e6:.1f} MB): peak {peak} concurrent streams "
        f"({peak / dense_slots:.1f}x the dense {dense_slots}), "
        f"prefix_hit_rate={s['prefix_hit_rate']:.3f} "
        f"prefix_hits={s['prefix_hits']} cow_forks={s['cow_forks']} "
        f"paged_extends={s['paged_extends']} prefills="
        f"{eng.stats['prefills']} blocks_peak={s['blocks_peak']} "
        f"tok/s={s['tokens_per_s']:.1f} p50={s['latency_p50_s'] * 1e3:.1f}ms"
        f" p95={s['latency_p95_s'] * 1e3:.1f}ms "
        f"decode_steps={s['decode_steps']} launches={launches}")
    out["fixed_kv"] = dict(s, peak_streams=peak, pool_bytes=pool_bytes,
                           prefills=eng.stats["prefills"],
                           launches=launches)
    del eng, params, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_hop_shape() -> tuple[int, int]:
    """(rows, n) of the training ring's codec calls: one row per ring
    position, one bucket of ceil(ceil(numel / k) / buckets) elements,
    numel counted over the trainer's tensors (built on the meta device,
    so nothing is allocated)."""
    from repro_torch.configs import get_config
    from repro_torch.core.sync_engine import leaves
    from repro_torch.launch.train import build_parser
    from repro_torch.models import transformer
    a = build_parser().parse_args(TRAIN_ARGS)
    cfg = dataclasses.replace(get_config(a.arch), n_layers=a.n_layers)
    params = transformer.init_lm(cfg, torch.Generator(), device="meta")
    numel = sum(t.numel() for t in leaves(params))
    chunk = -(-numel // a.max_workers)
    return a.max_workers, -(-chunk // a.sync_buckets)


def check_hist(label, x, lo, width, got, want, again) -> float:
    """Codes and counts exact; a second call bitwise equal; sums within
    1e-4 of each bucket's sum of |x| of the plain version's (which adds
    in fp64; the kernel adds 64-bit fixed-point integers, each term off
    by at most 2^-45 of the row's range bound); codebooks within 1e-4
    of the bucket's mean |x| (+1e-6 widths). Returns the largest
    codebook difference."""
    from repro_torch.kernels import ref
    codes, sums, counts = got
    wc, ws, wn = want
    if not torch.equal(codes, wc):
        raise AssertionError(f"{label}: codes differ from the plain version")
    if not torch.equal(counts, wn):
        raise AssertionError(f"{label}: counts differ from the plain version")
    for a, b in zip(got, again):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: a second call differs")
    abs_sums = ref.bucket_stats(x.abs(), codes)[0]
    rel = ((sums - ws).abs() / abs_sums.clamp_min(1e-30)).max().item()
    log(f"  {label}: bucket sums, max |kernel - plain| / sum|x| = {rel:.3g}")
    if rel > 1e-4:
        raise AssertionError(f"{label}: sums off the plain version")
    cb = ref.make_codebook(sums, counts, lo, width)
    cb_plain = ref.make_codebook(ws, wn, lo, width)
    tol = 1e-4 * abs_sums / counts.clamp_min(1) + 1e-6 * width[:, None]
    err = (cb - cb_plain).abs()
    if (err > tol).any():
        raise AssertionError(f"{label}: codebooks off the plain version")
    return err.max().item()


def codec_entry(name, err, ms, plain_ms, bound_bytes, library_ms, shape):
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/int8_quant.cu",
            "replaces": "src/repro/kernels/int8_quant.py:" + {
                "encode_hist": "160", "pseudograd_encode_hist": "174",
                "decode": "254", "decode_add": "266"}[name],
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": library_ms,
            "shape": {"rows": shape[0], "n": shape[1], "dtype": "float32"}}


def check_int8_codec() -> list[dict]:
    """Kernels 1-4 at the training ring's hop shape. Library yardsticks:
    ``torch.bincount(codes, weights=x)`` per row for the histogram half
    of encode, ``torch.gather(codebook, 1, codes.long())`` (one
    codebook per row) for decode, ``acc.add_(that)`` for decode_add."""
    from repro_torch.kernels import int8_quant as iq
    from repro_torch.kernels import ref
    rows, n = shape = train_hop_shape()
    gen = torch.Generator(device="cuda").manual_seed(0)
    anchor = torch.randn(shape, generator=gen, device="cuda").mul_(0.02)
    theta = torch.randn(shape, generator=gen, device="cuda").mul_(1e-3)
    theta.add_(anchor)
    scale = torch.tensor([1.0, 0.5, 0.0, 2.0], device="cuda")[:rows]
    out = []

    def encode_phase(name, x, kernel, plain):
        lo, width = ref.quant_params(x)
        got, again = kernel(lo, width), kernel(lo, width)
        want = plain(lo, width)
        torch.cuda.synchronize()
        err = check_hist(name, x, lo, width, got, want, again)
        codes = got[0]
        del got, again, want

        def library():
            return [torch.bincount(codes[r], weights=x[r], minlength=256)
                    for r in range(rows)]
        in_bytes = 9 if name == "pseudograd_encode_hist" else 5
        out.append(codec_entry(
            name, err, time_ms(lambda: kernel(lo, width)),
            time_ms(lambda: plain(lo, width), iters=10),
            rows * n * in_bytes + rows * 256 * 8,
            time_ms(library, iters=10), shape))
        log(f"kernel {name} {shape}: codes and counts exact, repeatable; "
            f"codebook max|err|={err:.3g}; {out[-1]['ms']:.3f} ms "
            f"(bound {out[-1]['bound_ms']:.3f}, plain "
            f"{out[-1]['plain_ms']:.3f}, bincount "
            f"{out[-1]['library_ms']:.3f})")
        split = launch_split_ms(lambda: kernel(lo, width))
        log(f"kernel {name} launches, device ms per call (torch.profiler): "
            f"{json.dumps(split)}")
        return codes, ref.make_codebook(*kernel(lo, width)[1:], lo, width)

    # kernel 1 on a pseudo-gradient, kernel 2 fused with per-row scales
    x = ref.pseudograd(anchor, theta)
    codes, book = encode_phase(
        "encode_hist", x, lambda lo, w: iq.encode_hist(x, lo, w),
        lambda lo, w: iq.encode_hist_torch(x, lo, w))
    del x, codes, book
    x = ref.pseudograd(anchor, theta, scale)
    codes, book = encode_phase(
        "pseudograd_encode_hist", x,
        lambda lo, w: iq.pseudograd_encode_hist(anchor, theta, lo, w,
                                                scale=scale),
        lambda lo, w: iq.pseudograd_encode_hist_torch(anchor, theta, lo, w,
                                                      scale=scale))
    del x, anchor, theta
    torch.cuda.empty_cache()

    # kernels 3 and 4 on the fused encode's codes and codebooks
    dec = iq.decode(codes, book)
    torch.cuda.synchronize()
    if not torch.equal(dec, iq.decode_torch(codes, book)):
        raise AssertionError("decode differs from its plain version")
    acc = torch.randn(shape, generator=gen, device="cuda")
    want = acc + dec
    del dec
    got = iq.decode_add(codes, book, acc)
    torch.cuda.synchronize()
    if got.data_ptr() != acc.data_ptr() or not torch.equal(got, want):
        raise AssertionError("decode_add differs from its plain version")
    del want, got
    for name, kernel, plain, library, nbytes in (
            ("decode", lambda: iq.decode(codes, book),
             lambda: iq.decode_torch(codes, book),
             lambda: torch.gather(book, 1, codes.long()), 5),
            ("decode_add", lambda: iq.decode_add(codes, book, acc),
             lambda: iq.decode_add_torch(codes, book, acc),
             lambda: acc.add_(torch.gather(book, 1, codes.long())), 9)):
        out.append(codec_entry(name, 0.0, time_ms(kernel),
                               time_ms(plain, iters=10),
                               rows * n * nbytes + rows * 256 * 4,
                               time_ms(library, iters=10), shape))
        log(f"kernel {name} {shape}: exact; {out[-1]['ms']:.3f} ms "
            f"(bound {out[-1]['bound_ms']:.3f})")
    del codes, book, acc
    torch.cuda.empty_cache()
    check_encode_skewed(shape, gen)
    return out


def device_kernels(fn, calls: int) -> list[tuple[str, int, float]]:
    """(name, launches, device ms) of each kernel that ``calls`` calls
    of ``fn()`` launch, from ``torch.profiler``. The window opens with
    ``LEAD_SPINS`` spin kernels, left out of the result: on the H100 a
    window may lose its first device records (none or two of them, of
    whatever kernel comes first: ``paged_record_loss``), and the spins
    take that loss in place of the kernels counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_SPINS):
            torch.cuda._sleep(1000)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0 and "spin" not in e.key]


def launch_split_ms(fn, calls: int = 5) -> dict:
    """Device ms per call of each kernel that ``fn()`` launches (the
    encode, its finish kernel, the fill of the zeroed scratch), from
    ``torch.profiler`` over ``calls`` calls."""
    kernels = device_kernels(fn, calls)
    if not kernels:
        raise AssertionError("torch.profiler saw no device time")
    return {name.split("(")[0][:48]: ms / calls for name, _, ms in kernels}


def check_encode_skewed(shape, gen) -> dict:
    """Kernels 1 and 2 on rows the ring meets besides Gaussian ones, at
    the hop shape: constant rows (encode: a row of zeros beside a row of
    0.5; fused: both workers at scale 0, so both rows are 0) and
    heavy-tailed rows (Student-t with 2 degrees of freedom, 1e-3 wide,
    with outliers of +-1e3 on both sides of every row). Checked as the
    Gaussian rows are; times printed here, not in the kernels line."""
    from repro_torch.kernels import int8_quant as iq
    from repro_torch.kernels import ref
    rows, n = shape
    times = {}

    def phase(label, x, kernel, plain, nbytes):
        lo, width = ref.quant_params(x)
        got, again = kernel(lo, width), kernel(lo, width)
        want = plain(lo, width)
        torch.cuda.synchronize()
        check_hist(label, x, lo, width, got, want, again)
        del got, again, want
        ms = time_ms(lambda: kernel(lo, width))
        bound = rows * n * nbytes / HBM_BYTES_PER_S * 1e3
        times[label] = {"ms": ms, "bound_ms": bound}
        log(f"kernel {label} {shape}: codes and counts exact, repeatable; "
            f"{ms:.3f} ms (bound {bound:.3f})")

    def heavy_tail():
        z = torch.randn(shape, generator=gen, device="cuda")
        w = torch.randn(shape, generator=gen, device="cuda").square_()
        w.add_(torch.randn(shape, generator=gen, device="cuda").square_())
        z.div_(w.div_(2.0).sqrt_()).mul_(1e-3)
        del w
        z[:, :4] = torch.tensor([1e3, -1e3, 5e2, -2e3], device="cuda")
        return z

    x = torch.full(shape, 0.5, device="cuda")
    x[0].zero_()
    phase("encode_hist constant rows", x,
          lambda lo, w: iq.encode_hist(x, lo, w),
          lambda lo, w: iq.encode_hist_torch(x, lo, w), 5)
    x = heavy_tail()
    phase("encode_hist heavy-tailed rows", x,
          lambda lo, w: iq.encode_hist(x, lo, w),
          lambda lo, w: iq.encode_hist_torch(x, lo, w), 5)
    anchor = x
    theta = torch.randn(shape, generator=gen, device="cuda").mul_(1e-3)
    for label, scale in (("constant rows (scale 0)", [0.0, 0.0]),
                         ("heavy-tailed rows", [1.0, 0.5])):
        s = torch.tensor(scale, device="cuda")[:rows]
        th = theta if scale[0] == 0.0 else torch.zeros_like(anchor)
        pg = ref.pseudograd(anchor, th, s)
        phase(f"pseudograd_encode_hist {label}", pg,
              lambda lo, w: iq.pseudograd_encode_hist(anchor, th, lo, w,
                                                      scale=s),
              lambda lo, w: iq.pseudograd_encode_hist_torch(
                  anchor, th, lo, w, scale=s), 9)
        del pg, th
    del x, anchor, theta
    torch.cuda.empty_cache()
    log(f"codec skewed rows: {json.dumps(times)}")
    return times


def ring_bound(trainer, weights) -> float:
    """What a flipped code can move the outer step's anchor by: one
    bucket width of the widest quantization (6-sigma range over 256
    buckets; std of a sum <= sum of stds), once per ring position, over
    the total weight, times the outer step's lr (1 + mu)."""
    from repro_torch.core.sync_engine import SyncEngine, tree_map
    one = tree_map(lambda p: p[0], trainer.params)
    eng = SyncEngine.for_tree(one)
    a_flat = trainer.outer.anchor_flat
    w = weights.float().cpu()
    stds = [float(w[i]) * float(torch.std(
        a_flat - eng.flatten(tree_map(lambda p: p[i], trainer.params)),
        correction=0)) for i in range(trainer.k)]
    width = 12.0 * sum(stds) / 256
    d = trainer.cfg.diloco
    return (d.outer_lr * (1 + d.outer_momentum) * trainer.k * width
            / max(float(w.sum()), 1e-20))


def check_anchor(label, got, want, bound) -> tuple[float, float]:
    """Ring tolerance: within 1e-5, but for elements whose code flipped
    at a bucket edge, which stay within ``bound`` and are rare."""
    err = (got.float() - want.float()).abs()
    worst, flipped = err.max().item(), (err > 1e-5).float().mean().item()
    if worst > bound or flipped > 0.01:
        raise AssertionError(f"{label}: anchors differ by {worst:.3g} "
                             f"(bound {bound:.3g}), {flipped:.2%} flipped")
    return worst, flipped


@contextlib.contextmanager
def plain_codec():
    """Route the codec wrappers to their plain versions, on any device."""
    from repro_torch.kernels import int8_quant as iq
    saved = {name: getattr(iq, name) for name in CODEC}
    for name in CODEC:
        setattr(iq, name, getattr(iq, name + "_torch"))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(iq, name, fn)


def check_reduced_trainer() -> None:
    """The reduced INTELLECT-1 (fp32) trained by the port on the card
    and on the CPU from the same weights and batches: per-step losses
    within rtol 1e-4, final anchors under the ring tolerance."""
    from repro_torch.configs import get_config
    from repro_torch.core.diloco import DiLoCoConfig
    from repro_torch.core.fault_tolerance import ClusterSimulator
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.registry import get_model
    from repro_torch.train.loop import ElasticTrainer, TrainerConfig
    cfg = get_config("intellect-1").reduced()
    params = get_model(cfg, "cpu").init(0)
    runs, bounds = {}, []
    for dev in ("cpu", "cuda"):
        tr = ElasticTrainer(
            get_model(cfg, dev),
            TrainerConfig(DiLoCoConfig(inner_steps=2), inner_lr=3e-3,
                          max_workers=3),
            DataConfig(vocab=cfg.vocab, seq_len=32, batch_per_worker=2),
            params, ClusterSimulator(range(3)))
        losses, inner, sync = [], tr._run_inner_phase, tr._outer_sync

        def run_inner(b, a, inner=inner, losses=losses):
            losses.append(inner(b, a))
            return losses[-1]

        def outer_sync(w, tr=tr, sync=sync):
            if tr.device.type == "cuda":
                bounds.append(ring_bound(tr, w))
            return sync(w)
        tr._run_inner_phase, tr._outer_sync = run_inner, outer_sync
        tr.run(2)
        runs[dev] = (torch.stack(losses).cpu(), tr.outer.anchor_flat.cpu())
    (lc, ac), (lg, ag) = runs["cpu"], runs["cuda"]
    if not torch.allclose(lg, lc, rtol=1e-4, atol=0.0):
        raise AssertionError(f"reduced trainer GPU vs CPU losses: "
                             f"{lg.tolist()} vs {lc.tolist()}")
    bound = (1 + 0.9) * sum(bounds)
    worst, flipped = check_anchor("reduced trainer GPU vs CPU", ag, ac, bound)
    log(f"reduced intellect-1 trainer GPU vs CPU: losses rtol 1e-4, "
        f"anchor max|err|={worst:.3g} (bound {bound:.3g}), "
        f"flipped {flipped:.2e}")
    check_reduced_elastic()


def train_main_path() -> dict:
    """``launch.train`` at full width; every codec count is set to 0
    just before and read just after."""
    from repro_torch.core import ring_reduce as rr
    from repro_torch.core.sync_engine import leaves
    from repro_torch.kernels import int8_quant as iq
    from repro_torch.launch import train as train_mod
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for name in CODEC:
        getattr(iq, name).launches = 0
    t0 = time.perf_counter()
    res = train_mod.main(TRAIN_ARGS)
    launches = {name: getattr(iq, name).launches for name in CODEC}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    hist, tr = res["history"], res["trainer"]
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"training: non-finite loss {hist}")
    per_sync = rr.codec_calls(tr.k, tr.cfg.diloco.ring, fused_src=True)
    want = {name: per_sync[name] * len(hist) for name in CODEC}
    if launches != want:
        raise AssertionError(f"training: codec launches {launches}, want "
                             f"{want} ({per_sync} per outer sync)")
    n_params = sum(p[0].numel() for p in leaves(tr.params))
    for h in hist:
        log(f"main path train step {h['outer_step']}: loss={h['loss']:.4f} "
            f"inner={h['inner_s'] * 1e3:.1f}ms "
            f"({h['inner_s'] / tr.cfg.diloco.inner_steps * 1e3:.1f} ms "
            f"per inner step, {tr.k} workers) "
            f"outer_sync={h['sync_s'] * 1e3:.1f}ms "
            f"wire_bytes={h['wire_bytes']}")
    log(f"main path train: params={n_params} launches={launches} "
        f"({per_sync} per outer sync) peak_mem={peak / 2**30:.2f}GiB "
        f"wall={wall:.1f}s")
    return {"history": hist, "trainer": tr, "launches": launches,
            "peak_bytes": peak, "per_sync": per_sync, "params": n_params}


def replay_outer_sync(tr) -> dict:
    """One more inner step gives the workers distinct parameters; the
    outer sync from those inputs then runs with the kernels and again
    with the plain codec on the card, and the anchors must agree."""
    from repro_torch.core import diloco as dl
    live = tr.sim.hb.live_ids()
    batches = {key: v[None].to(tr.device) for key, v in
               tr._batches(tr.cfg.diloco.inner_steps * 10).items()}
    tr._run_inner_phase(batches, tr.slots.live_mask(live))
    tr.opt_state = None                       # the replay needs no AdamW
    torch.cuda.empty_cache()
    weights = torch.as_tensor(tr.slots.live_mask(live), device=tr.device)
    bound = ring_bound(tr, weights)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, state = dl.outer_sync_sim(tr.params, tr.outer, tr.cfg.diloco,
                                 weights=weights)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    a_kernel = state.anchor_flat
    del state
    torch.cuda.empty_cache()
    with plain_codec():
        _, state = dl.outer_sync_sim(tr.params, tr.outer, tr.cfg.diloco,
                                     weights=weights)
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    worst, flipped = check_anchor("outer sync replay, kernels vs plain",
                                  a_kernel, state.anchor_flat, bound)
    log(f"outer sync replay: kernels {1e3 * (t1 - t0):.1f} ms, plain codec "
        f"{1e3 * (t2 - t1):.1f} ms; anchor max|err|={worst:.3g} "
        f"(bound {bound:.3g}), flipped {flipped:.2e}")
    return {"kernel_s": t1 - t0, "plain_s": t2 - t1, "max_err": worst}


def elastic_bandwidth(k: int):
    """A fixed link matrix (Gb/s): 10 everywhere but the 0-1 link at 1,
    which the identity ring crosses, so the monitor reorders once."""
    import numpy as np
    w = np.full((k, k), 10.0)
    w[0, 1] = w[1, 0] = 1.0
    np.fill_diagonal(w, 0.0)
    return w


def elastic_trainer(model, params, *, quant="int8", ef=False, seq_len,
                    batch_per_worker, inner_steps, inner_chunks, slots=4,
                    live=3, inner_lr=3e-4):
    """The elastic schedule's trainer: ``ELASTIC_EVENTS`` on ``slots``
    slots, nodes 0..live-1 live, the delayed overlap, validation on."""
    from repro_torch.core.diloco import DiLoCoConfig
    from repro_torch.core.fault_tolerance import (ClusterSimulator,
                                                  EventKind, NodeEvent)
    from repro_torch.core.validation import ValidationConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.loop import ElasticTrainer, TrainerConfig
    events = [NodeEvent(t, EventKind(kind), nid, arg)
              for t, kind, nid, arg in ELASTIC_EVENTS]
    return ElasticTrainer(
        model, TrainerConfig(
            DiLoCoConfig(inner_steps=inner_steps, quant=quant,
                         overlap="delayed", error_feedback=ef),
            inner_lr=inner_lr, max_workers=slots, inner_chunks=inner_chunks,
            validation=ValidationConfig()),
        DataConfig(vocab=model.cfg.vocab, seq_len=seq_len,
                   batch_per_worker=batch_per_worker,
                   total_steps=ELASTIC["outer_steps"] * inner_steps),
        params, ClusterSimulator(range(live), events=events))


def check_elastic_events(label, hist, tr) -> None:
    """Each event of ``ELASTIC_EVENTS`` shows in the history: the join,
    the flagged and quarantined node, the torn sync's fallback; and the
    ring was reordered off the identity."""
    got = {"joined": hist[1]["joined"],
           "quarantined": hist[2].get("admission", {}).get("quarantined"),
           "rejected": "rejected" in hist[2].get("overlap", {}),
           "torn_by": hist[4].get("sync_fallback", {}).get("torn_by"),
           "reorders": tr.reorders,
           "identity_ring": hist[0]["ring_order"] == tuple(range(tr.k))}
    want = {"joined": [3], "quarantined": [1], "rejected": True,
            "torn_by": [2], "reorders": 1, "identity_ring": False}
    if got != want:
        raise AssertionError(f"{label}: events {got}, want {want}")


def elastic_launches(hist, tr) -> dict:
    """Codec launches the ring geometry gives for the reductions of an
    elastic run: a whole reduction for every sync begun and finished,
    for every sanitized or torn sync's restart, and the hops a torn
    ring had dispatched before it tore."""
    from repro_torch.core import diloco as dl
    from repro_torch.core import ring_reduce as rr
    ring, fused = tr.cfg.diloco.ring, dl._fused_src_ok(tr.cfg.diloco)
    parts = []
    for t, rec in enumerate(hist):
        if "rejected" in rec["overlap"]:
            parts.append(rr.codec_calls(tr.k, ring, fused))      # restart
            continue
        nxt = hist[t + 1] if t + 1 < len(hist) else {}
        torn = nxt.get("sync_fallback")
        if torn is not None:
            parts.append(rr.codec_calls(tr.k, ring, fused,
                                        hops=torn["hops_done"]))
        parts.append(rr.codec_calls(tr.k, ring, fused))
    return {name: sum(p[name] for p in parts) for name in CODEC}


@contextlib.contextmanager
def ring_bounds(bounds: list, outer_lr: float, outer_momentum: float):
    """Append, for every ring reduction that finishes (restarts too),
    what a flipped code can move the anchor by: ``ring_bound``'s rule on
    the reduction's own rows and weights (16 buckets for int4)."""
    from repro_torch.core import ring_reduce as rr
    finish = rr.RingSyncOp.finish

    def bounded(op):
        if op._out is None and op.k > 1:
            w = op.weights.float()
            stds = torch.stack([torch.std(w[i] * op.xs[i], correction=0)
                                for i in range(op.k)])
            width = 12.0 * float(stds.sum()) / (
                16 if op.cfg.quant == "int4" else 256)
            bounds.append(outer_lr * (1 + outer_momentum) * op.k * width
                          / max(float(w.sum()), 1e-20))
        return finish(op)
    rr.RingSyncOp.finish = bounded
    try:
        yield bounds
    finally:
        rr.RingSyncOp.finish = finish


def check_reduced_elastic() -> None:
    """The elastic schedule on the reduced INTELLECT-1 (fp32), card
    against CPU from the same weights and batches, int8 and int4 with
    error feedback: the discrete fields equal, per-slot losses within
    rtol 1e-4, final anchors under the ring tolerance (the bound of
    every reduction, scaled once more by the outer step)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    cfg = get_config("intellect-1").reduced()
    params = get_model(cfg, "cpu").init(0)
    keys = ("outer_step", "live", "joined", "left", "attempts",
            "wire_bytes", "ring_order", "admission")
    for quant, ef in (("int8", False), ("int4", True)):
        runs, bounds = {}, []
        for dev in ("cpu", "cuda"):
            tr = elastic_trainer(get_model(cfg, dev), params, quant=quant,
                                 ef=ef, seq_len=32, batch_per_worker=2,
                                 inner_steps=7, inner_chunks=7, inner_lr=3e-3)
            losses, inner = [], tr._run_inner_phase

            def run_inner(b, a, inner=inner, losses=losses):
                losses.append(inner(b, a))
                return losses[-1]
            tr._run_inner_phase = run_inner
            with ring_bounds(bounds if dev == "cuda" else [], 0.7, 0.9):
                hist = tr.run(ELASTIC["outer_steps"],
                              bandwidth_sampler=lambda t: elastic_bandwidth(4))
            check_elastic_events(f"reduced elastic {quant} {dev}", hist, tr)
            disc = [({k: h[k] for k in keys},
                     h.get("sync_fallback", {}).get("torn_by")) for h in hist]
            runs[dev] = (disc, torch.cat(losses).cpu(),
                         tr.outer.anchor_flat.cpu(), tr.quarantine_events)
        (dc, lc, ac, qc), (dg, lg, ag, qg) = runs["cpu"], runs["cuda"]
        if dg != dc or qg != qc:
            raise AssertionError(f"reduced elastic {quant}: GPU history "
                                 f"{dg} {qg} vs CPU {dc} {qc}")
        live = ~torch.isnan(lc)
        if not torch.equal(live, ~torch.isnan(lg)) or not torch.allclose(
                lg[live], lc[live], rtol=1e-4, atol=0.0):
            raise AssertionError(f"reduced elastic {quant}: GPU vs CPU "
                                 f"losses {lg.tolist()} vs {lc.tolist()}")
        bound = (1 + 0.9) * sum(bounds)
        worst, flipped = check_anchor(f"reduced elastic {quant}", ag, ac,
                                      bound)
        log(f"reduced intellect-1 elastic {quant}{' + EF' if ef else ''} "
            f"GPU vs CPU: discrete fields equal ({len(dg)} steps, "
            f"{len(qg)} quarantine events), losses rtol 1e-4, anchor "
            f"max|err|={worst:.3g} (bound {bound:.3g}), flipped "
            f"{flipped:.2e}, {int(np.asarray(live).sum())} live losses")


def codec_counts() -> dict:
    from repro_torch.kernels import int8_quant as iq
    return {name: getattr(iq, name).launches for name in CODEC}


def train_elastic() -> dict:
    """The elastic main path at full width (``ELASTIC``): the trainer's
    ``run`` with ``ELASTIC_EVENTS`` and ``elastic_bandwidth``; every
    codec count is set to 0 just before and read just after. A boundary
    hook reads the launches and the peak memory of each outer step and
    keeps the inputs of the last delayed sync for the plain-codec
    replay."""
    from repro_torch.configs import get_config
    from repro_torch.core import diloco as dl
    from repro_torch.core.sync_engine import leaves
    from repro_torch.kernels import int8_quant as iq
    from repro_torch.models.registry import get_model
    e = ELASTIC
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(e["arch"]), n_layers=e["n_layers"])
    model = get_model(cfg, "cuda")
    tr = elastic_trainer(model, model.init(e["seed"]),
                         seq_len=e["seq_len"],
                         batch_per_worker=e["batch_per_worker"],
                         inner_steps=e["inner_steps"],
                         inner_chunks=e["inner_chunks"], slots=e["slots"],
                         live=e["live"], inner_lr=e["inner_lr"])
    steps, last, capture = [], dict.fromkeys(CODEC, 0), {}
    finish = dl.finish_outer_sync_sim

    def hook(t, trainer):
        now = codec_counts()
        steps.append({"launches": {n: now[n] - last[n] for n in CODEC},
                      "peak_bytes": torch.cuda.max_memory_allocated(),
                      **parts})
        parts.update(poison_s=0.0, admission_s=0.0)
        last.update(now)
        capture["armed"] = t == e["outer_steps"] - 1   # the drain is next

    def finish_and_keep(h, params, state):
        out = finish(h, params, state)
        if capture.pop("armed", False):
            capture.update(handle=h, state=state, anchor=out[1].anchor_flat)
        return out
    parts = {"poison_s": 0.0, "admission_s": 0.0}

    def timed(name, fn):
        def call(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            parts[name] += time.perf_counter() - t0
            return out
        return call
    tr._apply_poison = timed("poison_s", tr._apply_poison)
    tr._admission_check = timed("admission_s", tr._admission_check)
    tr.boundary_hook = hook
    dl.finish_outer_sync_sim = finish_and_keep
    torch.cuda.reset_peak_memory_stats()
    for name in CODEC:
        getattr(iq, name).launches = 0
    t0 = time.perf_counter()
    try:
        hist = tr.run(e["outer_steps"],
                      bandwidth_sampler=lambda t: elastic_bandwidth(tr.k))
        launches = codec_counts()
        torch.cuda.synchronize()
    finally:
        dl.finish_outer_sync_sim = finish
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check_elastic_events("elastic main path", hist, tr)
    if not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"elastic: non-finite loss {hist}")
    want = elastic_launches(hist, tr)
    if launches != want:
        raise AssertionError(f"elastic: codec launches {launches}, want "
                             f"{want} from the ring geometry")
    n_params = sum(p[0].numel() for p in leaves(tr.params))
    drain = {n: launches[n] - last[n] for n in CODEC}
    for h, st in zip(hist, steps):
        ov = h["overlap"]
        led = ov.get("prev") or ov.get("rejected") or {}
        extra = ""
        if "rejected" in ov:
            extra += f" rejected(flagged={h['admission']['flagged']})"
        if "sync_fallback" in h:
            extra += (f" torn_by={h['sync_fallback']['torn_by']} after "
                      f"{h['sync_fallback']['hops_done']} hop(s)")
        log(f"elastic step {h['outer_step']}: live={h['live']} "
            f"joined={h['joined']} left={h['left']} loss={h['loss']:.4f} "
            f"ring={list(h['ring_order'])} inner={h['inner_s'] * 1e3:.1f}ms "
            f"chunks_ms={[round(c * 1e3, 1) for c in h['inner_chunk_s']]} "
            f"hops_ms={[round(c * 1e3, 1) for c in h['inner_hop_s']]} "
            f"boundary={h['sync_s'] * 1e3:.1f}ms (poison "
            f"{st['poison_s'] * 1e3:.1f}ms, admission "
            f"{st['admission_s'] * 1e3:.1f}ms) ledger hidden="
            f"{led.get('comm_hidden_s', 0.0):.6f}s exposed="
            f"{led.get('comm_exposed_s', 0.0):.6f}s launches="
            f"{json.dumps(st['launches'])} peak="
            f"{st['peak_bytes'] / 2**30:.2f}GiB{extra}")
    dr = hist[-1]["overlap"]["drain"]
    log(f"elastic drain: {hist[-1]['drain_s'] * 1e3:.1f}ms ledger hidden="
        f"{dr['comm_hidden_s']:.6f}s exposed={dr['comm_exposed_s']:.6f}s "
        f"launches={json.dumps(drain)}")
    log(f"elastic main path: {e['arch']} depth {e['n_layers']} "
        f"params={n_params} slots={tr.k} launches={json.dumps(launches)} "
        f"(= ring geometry) quarantine_events={tr.quarantine_events} "
        f"hidden_fraction={tr.comm_ledger.hidden_fraction:.3f} "
        f"peak_mem={peak / 2**30:.2f}GiB wall={wall:.1f}s")
    return {"history": hist, "trainer": tr, "launches": launches,
            "peak_bytes": peak, "params": n_params, "capture": capture,
            "wall_s": wall}


def replay_elastic(run) -> dict:
    """The last delayed sync (drained at the end of the run) again from
    its retained inputs, with the plain codec on the card: the anchor
    within the ring tolerance of the kernels' one."""
    from repro_torch.core import diloco as dl
    from repro_torch.core import ring_reduce as rr
    cap, tr = run["capture"], run["trainer"]
    h, state = cap.pop("handle"), cap.pop("state")
    bounds = []
    t0 = time.perf_counter()
    with plain_codec(), ring_bounds(bounds, tr.cfg.diloco.outer_lr,
                                    tr.cfg.diloco.outer_momentum):
        reduced = rr.simulate_ring_all_reduce(
            h.op.xs, h.op.ring_order, h.op.cfg, h.weights, h.op.fused_src)
        _, replayed = dl._finish_apply(h, reduced, tr.params, state)
        torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    del reduced, h, state
    worst, flipped = check_anchor("elastic replay, kernels vs plain",
                                  cap.pop("anchor"), replayed.anchor_flat,
                                  bounds[0])
    del replayed
    log(f"elastic replay of the last delayed sync with the plain codec: "
        f"{plain_s * 1e3:.1f} ms; anchor max|err|={worst:.3g} (bound "
        f"{bounds[0]:.3g}), flipped {flipped:.2e}")
    torch.cuda.empty_cache()
    return {"plain_s": plain_s, "max_err": worst}


def stepped_ring_bitwise(run) -> dict:
    """One more inner step gives the slots distinct parameters; a
    ``RingSyncOp`` over their full-width rows, stepped one hop at a time
    with a matmul between hops, launches ``codec_calls`` codec kernels
    and equals ``simulate_ring_all_reduce`` bit for bit."""
    from repro_torch.core import diloco as dl
    from repro_torch.core import ring_reduce as rr
    tr = run["trainer"]
    live = tr.sim.hb.live_ids()
    batches = {key: v[None].to(tr.device) for key, v in
               tr._batches(tr.cfg.diloco.inner_steps * 10).items()}
    tr._run_inner_phase(batches, tr.slots.live_mask(live))
    tr.opt_state = None                       # the ring needs no AdamW
    torch.cuda.empty_cache()
    weights = torch.as_tensor(tr.slots.live_mask(live), device=tr.device)
    h = dl.begin_outer_sync_sim(tr.params, tr.outer, tr.cfg.diloco,
                                ring_order=tr._ring_for_sync(),
                                weights=weights)
    noise = torch.randn(4096, 4096, device=tr.device)
    before = codec_counts()
    t0 = time.perf_counter()
    while h.step():
        noise = noise @ noise.T / 4096        # other work between hops
    got = h.op.finish()
    torch.cuda.synchronize()
    stepped_s = time.perf_counter() - t0
    launches = {n: codec_counts()[n] - before[n] for n in CODEC}
    want_launches = rr.codec_calls(tr.k, tr.cfg.diloco.ring, True)
    if launches != want_launches:
        raise AssertionError(f"stepped ring: launches {launches}, want "
                             f"{want_launches}")
    want = rr.simulate_ring_all_reduce(h.op.xs, h.op.ring_order, h.op.cfg,
                                       h.weights, h.op.fused_src)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("stepped ring: not bitwise equal to "
                             "simulate_ring_all_reduce")
    shape = tuple(h.op.xs.shape)
    del got, want, h, noise
    torch.cuda.empty_cache()
    log(f"stepped RingSyncOp at the full-width rows {shape}: bitwise equal "
        f"to simulate_ring_all_reduce, launches {json.dumps(launches)} "
        f"(= codec_calls), {stepped_s * 1e3:.1f} ms with a matmul between "
        f"hops")
    return {"shape": shape, "launches": launches}


def reset_codec_counts() -> None:
    from repro_torch.kernels import int8_quant as iq
    for name in CODEC:
        getattr(iq, name).launches = 0


def float_leaves(tree) -> int:
    from repro_torch.core.sync_engine import leaves
    return sum(1 for t in leaves(tree) if t.is_floating_point())


def equal_trees(label, got, want) -> None:
    """Every leaf of ``got`` bitwise equal to ``want``'s (same keys,
    dtypes and shapes)."""
    from repro_torch.checkpointing import checkpoint as ck
    g, w = ck._flatten(got), ck._flatten(want)
    if list(g) != list(w):
        raise AssertionError(f"{label}: keys differ")
    for k in w:
        if not torch.equal(g[k].cpu(), w[k].cpu()):
            raise AssertionError(f"{label}: leaf {k!r} differs")


def train_checkpointed(workdir: Path) -> dict:
    """Phase 8's main path (``CKPT_ARGS``): the writer trains and
    checkpoints, then serves; the joiner streams the checkpoint in and
    runs one outer step. Every codec count is set to 0 just before each
    trainer's run (the joiner's from ``begin_stream_join``) and read
    just after. Returns the kernel entries' additions."""
    from repro_torch.core import ring_reduce as rr
    from repro_torch.core.sync_engine import leaves
    from repro_torch.launch import train as lt
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = lt.build_parser().parse_args(
        CKPT_ARGS + ["--ckpt-dir", str(workdir / "writer"),
                     "--serve-ckpt-port", "0"])
    tr = lt.build_trainer(args)
    writes = []
    write_fn = tr.snapshotter.write_fn

    def timed_write(step, tree, meta):
        t0 = time.perf_counter()
        m = write_fn(step, tree, meta)
        writes.append({"step": step, "kind": m["kind"],
                       "write_s": time.perf_counter() - t0, **m["stats"]})
        return m
    tr.snapshotter.write_fn = timed_write
    reset_codec_counts()
    t0 = time.perf_counter()
    hist = tr.run(args.outer_steps, inner_steps=args.inner_steps)
    torch.cuda.synchronize()
    writer_launches = codec_counts()
    writer_wall = time.perf_counter() - t0
    if not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"checkpointed training: non-finite loss {hist}")
    kinds = [w["kind"] for w in writes]
    if kinds != ["base", "delta", "delta"]:
        raise AssertionError(f"checkpointed training: wrote {kinds}")
    n_float = float_leaves(tr.checkpoint_like())
    deltas = kinds.count("delta")
    per_sync = rr.codec_calls(tr.k, tr.cfg.diloco.ring, fused_src=True)

    def want(syncs, encodes, applies):
        out = {n: per_sync[n] * syncs for n in CODEC}
        out["pseudograd_encode_hist"] += encodes
        out["decode_add"] += applies
        return out
    want_w = want(len(hist), n_float * deltas, n_float * deltas)
    if writer_launches != want_w:
        raise AssertionError(f"writer: codec launches {writer_launches}, "
                             f"want {want_w}")
    for h in hist:
        log(f"ckpt writer step {h['outer_step']}: loss={h['loss']:.4f} "
            f"inner={h['inner_s'] * 1e3:.1f}ms "
            f"sync={h['sync_s'] * 1e3:.1f}ms")
    for w in writes:
        ratio = w["logical_bytes"] / max(1, w["new_bytes"])
        log(f"ckpt write step {w['step']} {w['kind']}: "
            f"{w['write_s']:.2f}s logical_bytes={w['logical_bytes']} "
            f"new_bytes={w['new_bytes']} "
            f"codes_bytes={w.get('codes_bytes')} "
            f"logical/new={ratio:.2f}x")
    reference = tr.ckpt_writer.reference(tr.checkpoint_like())
    last_step = tr.persisted_steps[-1]
    peer = lt.serve_checkpoints(args, tr)
    writer_peak = torch.cuda.max_memory_allocated()
    # the writer thread holds the trainer (its on_persist callback) and
    # the delta writer's reference on the card: end it before the joiner
    tr.snapshotter.close()
    log(f"ckpt writer: {n_float} float leaves, launches={writer_launches} "
        f"(ring {per_sync} per sync x {len(hist)}), wall={writer_wall:.1f}s,"
        f" peak_mem={writer_peak / 2**30:.2f}GiB, cpu_count={os.cpu_count()}")
    del tr, hist
    gc.collect()
    torch.cuda.empty_cache()
    try:
        jargs = lt.build_parser().parse_args(CKPT_ARGS + ["--outer-steps",
                                                          "1"])
        jt = lt.build_trainer(jargs)
        reset_codec_counts()
        t0 = time.perf_counter()
        fetcher = jt.begin_stream_join([peer.addr],
                                       store_root=workdir / "joiner")
        fetcher.wait_ready(timeout=900)
        ready_s = time.perf_counter() - t0
        jhist = jt.run(1, inner_steps=jargs.inner_steps)
        torch.cuda.synchronize()
        joiner_launches = codec_counts()
    finally:
        peer.close()
    chain_chunks = len(peer.store.inventory())
    join = jhist[0].get("stream_join")
    if not join or not join["admitted"] or join["step"] != last_step:
        raise AssertionError(f"joiner: stream join {join}, want admitted "
                             f"at step {last_step}")
    if not math.isfinite(jhist[0]["loss"]):
        raise AssertionError(f"joiner: non-finite loss {jhist}")
    equal_trees("joiner: fetched tree vs the writer's reference",
                fetcher.result()[0], reference)
    equal_trees("joiner: adopted anchor vs the writer's reference",
                jt.outer.anchor, reference["anchor"])
    want_j = want(1, 0, n_float * deltas)
    if joiner_launches != want_j:
        raise AssertionError(f"joiner: codec launches {joiner_launches}, "
                             f"want {want_j}")
    peak = torch.cuda.max_memory_allocated()
    st = join["stats"]
    # a round that fails (the peer drops a session idle past its 10 s
    # timeout while the fetch worker replays the base) is retried; only
    # the last round's chunks are counted in chunks_fetched
    log(f"ckpt joiner: admitted at step {join['step']} (outer step "
        f"{join['outer_step']}), fetch {st['fetch_seconds']:.2f}s "
        f"(ready after {ready_s:.2f}s), rounds={st['rounds']} "
        f"dead_peers={st.get('dead_peers')} chunks={st['chunks_fetched']} "
        f"of {chain_chunks} bytes={st['bytes_fetched']} "
        f"replayed_steps={st['replayed_steps']}"
        f" replayed_on_stream={st['replayed_on_stream']} "
        f"loss={jhist[0]['loss']:.4f} launches={joiner_launches}; "
        f"tree bitwise equal to the writer's reference")
    log(f"ckpt phase: peak_mem={peak / 2**30:.2f}GiB")
    if peak >= PEAK_LIMIT_BYTES:
        raise AssertionError(f"checkpoint phase peak {peak / 2**30:.2f} GiB")
    n_embed = max(t.numel() for t in leaves(reference["params"]))
    del jt, jhist, fetcher, reference
    gc.collect()
    torch.cuda.empty_cache()
    extra = ckpt_kernel_times(n_embed)
    for name in ("pseudograd_encode_hist", "decode_add"):
        extra[name]["launches_ckpt"] = (writer_launches[name]
                                        + joiner_launches[name])
    return {"kernels": extra}


def ckpt_kernel_times(n: int) -> dict:
    """Kernels 2 and 4 at a delta leaf's (1, n) row, against their plain
    versions (codes and counts exact, decode_add bitwise) and timed:
    the delta encode reads theta and ref and writes codes, the apply
    reads codes and ref and writes ref."""
    from repro_torch.kernels import int8_quant as iq
    from repro_torch.kernels import ref as qref
    shape = (1, n)
    gen = torch.Generator(device="cuda").manual_seed(8)
    ref = torch.randn(shape, generator=gen, device="cuda").mul_(0.02)
    new = torch.randn(shape, generator=gen, device="cuda").mul_(1e-3)
    new.add_(ref)
    x = qref.pseudograd(new, ref)
    lo, width = qref.quant_params(x)
    got = iq.pseudograd_encode_hist(new, ref, lo, width)
    again = iq.pseudograd_encode_hist(new, ref, lo, width)
    want = iq.pseudograd_encode_hist_torch(new, ref, lo, width)
    torch.cuda.synchronize()
    err = check_hist("delta encode (1, n)", x, lo, width, got, want, again)
    codes = got[0]
    book = qref.make_codebook(got[1], got[2], lo, width)
    del x, got, again, want
    acc = ref.clone()
    plain = acc + iq.decode_torch(codes, book)
    iq.decode_add(codes, book, acc)
    torch.cuda.synchronize()
    if not torch.equal(acc, plain):
        raise AssertionError("delta apply (1, n): decode_add differs from "
                             "its plain version")
    del plain
    enc_ms = time_ms(lambda: iq.pseudograd_encode_hist(new, ref, lo, width),
                     iters=20)
    app_ms = time_ms(lambda: iq.decode_add(codes, book, acc), iters=20)
    out = {"pseudograd_encode_hist": {
               "ckpt_ms": enc_ms, "ckpt_max_abs_err": err,
               "ckpt_bound_ms": (9 * n + 256 * 8) / HBM_BYTES_PER_S * 1e3},
           "decode_add": {
               "ckpt_ms": app_ms, "ckpt_max_abs_err": 0.0,
               "ckpt_bound_ms": (9 * n + 256 * 4) / HBM_BYTES_PER_S * 1e3}}
    for entry in out.values():
        entry["ckpt_shape"] = {"rows": 1, "n": n, "dtype": "float32"}
    log(f"ckpt kernels at (1, {n}): delta encode {enc_ms:.3f} ms (bound "
        f"{out['pseudograd_encode_hist']['ckpt_bound_ms']:.3f}), codes and "
        f"counts exact, codebook max|err|={err:.3g}; delta apply "
        f"{app_ms:.3f} ms (bound {out['decode_add']['ckpt_bound_ms']:.3f}),"
        f" bitwise")
    del ref, new, codes, book, acc
    torch.cuda.empty_cache()
    return out


def check_ckpt_cross_device(workdir: Path) -> None:
    """The reduced INTELLECT-1 (bf16 parameters): the same three trees
    checkpointed by a delta writer on the card and one on the CPU; each
    chain replays on the other device bitwise equal to its writer's
    reference, and the first delta's codes agree (an element may move by
    one only within 1e-4 bucket widths of an edge, where the two
    devices' mean/std reductions can round lo and width apart)."""
    from repro_torch.checkpointing import (ChunkStore, DeltaCheckpointer,
                                           DeltaConfig)
    from repro_torch.checkpointing import checkpoint as ck
    from repro_torch.checkpointing import delta
    from repro_torch.configs import get_config
    from repro_torch.core.sync_engine import tree_map
    from repro_torch.kernels import ref as qref
    from repro_torch.models.registry import get_model
    cfg = dataclasses.replace(get_config("intellect-1").reduced(),
                              dtype="bfloat16")
    params = get_model(cfg, "cpu").init(0)
    gen = torch.Generator().manual_seed(1)
    anchor = tree_map(lambda p: p.float(), params)
    mom = tree_map(torch.zeros_like, anchor)
    trees = []
    for _ in range(3):
        trees.append({"params": params, "outer_momentum": mom,
                      "anchor": anchor})
        upd = tree_map(lambda a: torch.randn(a.shape, generator=gen) * 1e-3,
                       anchor)
        anchor = tree_map(torch.add, anchor, upd)
        mom = tree_map(lambda m, u: 0.9 * m + u, mom, upd)
        params = tree_map(lambda a, p: a.to(p.dtype), anchor, params)
    like = trees[-1]
    stores, refs = {}, {}
    for dev in ("cuda", "cpu"):
        stores[dev] = ChunkStore(workdir / f"cross_{dev}")
        w = DeltaCheckpointer(stores[dev], DeltaConfig(base_every=8),
                              device=dev)
        for t, tree in enumerate(trees):
            w.save(t, tree, {"outer_step": t})
        refs[dev] = w.reference(like)
    for wdev, rdev in (("cuda", "cpu"), ("cpu", "cuda")):
        got, _ = delta.restore(stores[wdev], like, device=rdev)
        equal_trees(f"chain written on {wdev}, replayed on {rdev}", got,
                    refs[wdev])
    m_gpu, m_cpu = (stores[d].load_manifest(1) for d in ("cuda", "cpu"))
    base = ck._flatten(trees[0])
    new = ck._flatten(trees[1])
    flips = total = 0
    for key, entry in m_cpu["keys"].items():
        if entry.get("delta") is None:
            continue
        codes = [torch.frombuffer(m_store.read_bytes(
            [c["id"] for c in m["keys"][key]["delta"]["codes_chunks"]]),
            dtype=torch.uint8).long()
            for m_store, m in ((stores["cuda"], m_gpu),
                               (stores["cpu"], m_cpu))]
        diff = torch.nonzero(codes[0] != codes[1]).flatten()
        total += codes[0].numel()
        if diff.numel():
            x = (new[key].float() - base[key].float()).reshape(1, -1)
            lo, width = qref.quant_params(x)
            pos = ((x[0, diff].double() - lo.double()) / width.double())
            if ((codes[0][diff] - codes[1][diff]).abs() != 1).any() or \
                    ((pos - pos.round()).abs() >= 1e-4).any():
                raise AssertionError(f"first delta's codes of {key!r} "
                                     f"differ away from a bucket edge")
            flips += diff.numel()
    log(f"ckpt cross-device (reduced INTELLECT-1, bf16 params): chains "
        f"card->CPU and CPU->card replay bitwise equal to their writers' "
        f"references; first delta's codes: {flips} of {total} differ, all "
        f"at bucket edges by one")


def dist_trainer(model, params, backend=None):
    """Phase 9's trainer (``DIST``): every slot live, int8, the delayed
    overlap over 7 chunks, error feedback, ``DIST_EVENTS``."""
    from repro_torch.core.diloco import DiLoCoConfig
    from repro_torch.core.fault_tolerance import (ClusterSimulator,
                                                  EventKind, NodeEvent)
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.loop import ElasticTrainer, TrainerConfig
    d = DIST
    events = [NodeEvent(t, EventKind(kind), nid, arg)
              for t, kind, nid, arg in DIST_EVENTS]
    return ElasticTrainer(
        model, TrainerConfig(
            DiLoCoConfig(inner_steps=d["inner_steps"], quant="int8",
                         overlap="delayed", error_feedback=True),
            inner_lr=d["inner_lr"], max_workers=d["slots"],
            inner_chunks=d["inner_chunks"]),
        DataConfig(vocab=model.cfg.vocab, seq_len=d["seq_len"],
                   batch_per_worker=d["batch_per_worker"],
                   total_steps=d["outer_steps"] * d["inner_steps"]),
        params, ClusterSimulator(range(d["slots"]), events=events),
        sync_backend=backend)


def dist_codec_rows(n: int, k: int) -> dict:
    """The codec at a distributed ring's hop shape, one (1, n) row a
    call as each rank launches it (with ``n`` odd, rows 1.. of the (k, n)
    buffer start off the 16-byte boundary, as the ranks' chunks do):
    kernels 1, 3 and 4 on each row against their plain versions on the
    same inputs (``check_hist``'s tolerances; decode and decode_add
    exact), and the one-row encode bitwise equal to the k-row encode,
    which the distributed ring's bits rest on. Also says whether a
    batched ``std_mean`` over k rows, or one on a row that starts off
    the 16-byte boundary, would have differed from one call on an
    aligned row (the hazards ``ref.row_std_mean`` removes)."""
    from repro_torch.kernels import int8_quant as iq
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn((k, n), generator=gen, device="cuda").mul_(1e-3)
    accs = torch.randn((k, n), generator=gen, device="cuda")
    q = ops.quantize(x)
    worst = 0.0
    for r in range(k):
        row, acc = x[r:r + 1], accs[r:r + 1]
        one = ops.quantize(row)
        if not (torch.equal(one.codes, q.codes[r:r + 1])
                and torch.equal(one.codebook, q.codebook[r:r + 1])):
            raise AssertionError(f"one-row encode of row {r} differs from "
                                 f"the {k}-row encode at (1, {n})")
        lo, width = ref.quant_params(row)
        got = iq.encode_hist(row, lo, width)
        again = iq.encode_hist(row, lo, width)
        want = iq.encode_hist_torch(row, lo, width)
        torch.cuda.synchronize()
        worst = max(worst, check_hist(
            f"dist encode_hist row {r} (1, {n}), offset "
            f"{row.data_ptr() % 16} B", row, lo, width, got, want, again))
        del got, again, want
        dec = iq.decode(one.codes, one.codebook)
        if not torch.equal(dec, iq.decode_torch(one.codes, one.codebook)):
            raise AssertionError(f"dist decode of row {r} (1, {n}) differs "
                                 f"from its plain version")
        want = iq.decode_add_torch(one.codes, one.codebook, acc.clone())
        got = iq.decode_add(one.codes, one.codebook, acc)
        torch.cuda.synchronize()
        if got.data_ptr() != acc.data_ptr() or not torch.equal(got, want):
            raise AssertionError(f"dist decode_add of row {r} (1, {n}) "
                                 f"differs from its plain version")
        del one, dec, got, want
    sigma, mu = torch.std_mean(x, dim=-1, correction=0)
    per_row = [torch.std_mean(x[r:r + 1], dim=-1, correction=0)
               for r in range(k)]
    batched_differs = not all(
        torch.equal(sigma[r], s[0]) and torch.equal(mu[r], m[0])
        for r, (s, m) in enumerate(per_row))
    misaligned = [r for r in range(k) if x[r:r + 1].data_ptr() % 16]
    misaligned_differs = not all(
        torch.equal(torch.stack(per_row[r]),
                    torch.stack(torch.std_mean(x[r:r + 1].clone(), dim=-1,
                                               correction=0)))
        for r in misaligned)
    torch.cuda.synchronize()
    del x, accs, q
    torch.cuda.empty_cache()
    log(f"dist codec at (1, {n}), {k} rows: encode_hist, decode and "
        f"decode_add equal their plain versions (codes, counts exact; "
        f"codebook max|err|={worst:.3g}); one-row encode bitwise equal to "
        f"the {k}-row encode; a batched std_mean over {k} rows "
        f"{'differs from' if batched_differs else 'equals'} one call per "
        f"row; on the misaligned rows {misaligned} std_mean "
        f"{'differs from' if misaligned_differs else 'equals'} std_mean of "
        f"an aligned copy")
    return {"batched_std_mean_differs": batched_differs,
            "misaligned_std_mean_differs": misaligned_differs,
            "codebook_max_abs_err": worst}


def dist_history_check(hist_sim, hist_dist) -> None:
    torn = [("sync_fallback" in r) for r in hist_dist]
    if torn != [("sync_fallback" in r) for r in hist_sim] or not any(torn):
        raise AssertionError(f"dist: sync_fallback flags {torn} vs the "
                             f"simulated trainer's")
    for key in ("loss", "ring_order", "live"):
        got, want = [r[key] for r in hist_dist], [r[key] for r in hist_sim]
        if got != want:
            raise AssertionError(f"dist: {key} {got} vs simulated {want}")


def dist_reduction_launches(backend, k: int, ring) -> list:
    """Per reduction that ran, the launches summed over the ranks must be
    k x ``codec_calls`` of the hops it ran (the torn ring's and the
    restart's too); every codec call launched its kernel."""
    from repro_torch.core import ring_reduce as rr
    out = []
    for rec in backend.reductions:
        want = {n: rec["ranks"] * c for n, c in rr.codec_calls(
            k, ring, rec["fused"], hops=rec["hops"]).items()}
        if rec["launches"] != want or rec["calls"] != want:
            raise AssertionError(f"dist: reduction of {rec['hops']} hops "
                                 f"launched {rec['launches']} (calls "
                                 f"{rec['calls']}), want {want}")
        out.append(rec["launches"])
    return out


def train_distributed() -> dict:
    """Phase 9's main path (``DIST``): the simulated trainer first (kept:
    history, parameters and anchor on the host), then the same trainer
    with ``DistSyncBackend`` over a (slots,) rank mesh on the card. The
    ranks' codec counts are set to 0 just before the distributed run and
    read just after."""
    from repro_torch.configs import get_config
    from repro_torch.core.sync_engine import leaves
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.registry import get_model
    from repro_torch.train import step as ts
    d = DIST
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(d["arch"]), n_layers=d["n_layers"])
    model = get_model(cfg, "cuda")
    n_params = sum(p.numel() for p in leaves(model.init(d["seed"])))
    probe = dist_codec_rows(-(-n_params // d["slots"]), d["slots"])
    tr = dist_trainer(model, model.init(d["seed"]))
    t0 = time.perf_counter()
    hist_sim = tr.run(d["outer_steps"])
    torch.cuda.synchronize()
    sim_wall = time.perf_counter() - t0
    sim_params = [p[0].cpu() for p in leaves(tr.params)]
    sim_anchor = tr.outer.anchor_flat.cpu()
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    with make_host_mesh(d["slots"], timeout=300.0) as mesh:
        backend = ts.DistSyncBackend(mesh, "data")
        tr = dist_trainer(model, model.init(d["seed"]), backend)
        card = []
        tr.boundary_hook = lambda t, trainer: card.append(
            torch.cuda.mem_get_info())
        mesh.call(ts.rank_codec_counts, True)
        reset_codec_counts()
        t0 = time.perf_counter()
        hist = tr.run(d["outer_steps"])
        torch.cuda.synchronize()
        dist_wall = time.perf_counter() - t0
        ranks = mesh.call(ts.rank_codec_counts)
        controller = codec_counts()
        launches = {n: sum(r["launches"][n] for r in ranks) for n in CODEC}
        dist_history_check(hist_sim, hist)
        for got, want in zip(leaves(tr.params), sim_params):
            if not torch.equal(got[0].cpu(), want):
                raise AssertionError("dist: parameters differ from the "
                                     "simulated trainer's")
        if not torch.equal(tr.outer.anchor_flat.cpu(), sim_anchor):
            raise AssertionError("dist: anchor_flat differs from the "
                                 "simulated trainer's")
        if backend.recompiles != 1:
            raise AssertionError(f"dist: {backend.recompiles} ring builds")
        per_red = dist_reduction_launches(backend, tr.k, tr.cfg.diloco.ring)
        total = {n: sum(p[n] for p in per_red) for n in CODEC}
        if launches != total:
            raise AssertionError(f"dist: rank launches {launches} vs the "
                                 f"reductions' {total}")
        # the controller's own launches: the EF round trip of each begin
        begins = len(hist)
        want_c = dict.fromkeys(CODEC, 0)
        want_c.update(encode_hist=begins, decode=begins)
        if controller != want_c:
            raise AssertionError(f"dist: controller launches {controller},"
                                 f" want {want_c} (one EF round trip a "
                                 f"begin)")
        peak = torch.cuda.max_memory_allocated()
        used = max(total_b - free for free, total_b in card)
        for h in hist:
            extra = ""
            if "sync_fallback" in h:
                fb = h["sync_fallback"]
                extra = (f" torn_by={fb['torn_by']} after {fb['hops_done']}"
                         f" hop(s)")
            log(f"dist step {h['outer_step']}: live={h['live']} "
                f"loss={h['loss']:.4f} inner={h['inner_s'] * 1e3:.1f}ms "
                f"hops_ms={[round(c * 1e3, 1) for c in h['inner_hop_s']]} "
                f"boundary={h['sync_s'] * 1e3:.1f}ms{extra}")
        for i, rec in enumerate(backend.reductions):
            hops = [{f: round(v * 1e3, 2) for f, v in ht.items()}
                    for ht in rec["hop_times"]]
            log(f"dist reduction {i}: {rec['hops']} hops over "
                f"{rec['ranks']} ranks, launches {json.dumps(rec['launches'])}"
                f" (= {rec['ranks']} x codec_calls), per hop ms (max over "
                f"ranks) {json.dumps(hops)}")
        hop_ms = [ht for rec in backend.reductions for ht in rec["hop_times"]]
        mean = {f: 1e3 * sum(h[f] for h in hop_ms) / len(hop_ms)
                for f in hop_ms[0]}
        log(f"dist main path: {d['arch']} depth {d['n_layers']} "
            f"params={n_params} slots={tr.k} ({tr.k} rank processes on one "
            f"card, time-sliced: no MPS) recompiles={backend.recompiles} "
            f"launches={json.dumps(launches)} (ranks) + {json.dumps(controller)}"
            f" (controller, EF); bitwise equal to the simulated trainer "
            f"(history, params, anchor); sim wall={sim_wall:.1f}s dist "
            f"wall={dist_wall:.1f}s drain={hist[-1]['drain_s'] * 1e3:.1f}ms"
            f" mean hop ms {json.dumps({f: round(v, 2) for f, v in mean.items()})}"
            f" controller peak={peak / 2**30:.2f}GiB card used "
            f"(all processes)={used / 2**30:.2f}GiB")
        if peak >= PEAK_LIMIT_BYTES:
            raise AssertionError(f"dist phase peak {peak / 2**30:.2f} GiB")
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    hier = dist_hierarchical(n_params)
    log(f"dist phase: {time.perf_counter() - t_phase:.1f}s")
    return {"launches": launches, "peak_bytes": peak, "hier": hier,
            "probe": probe, "mean_hop_ms": mean}


def dist_hierarchical(n: int) -> dict:
    """A (2, 2) rank mesh (WAN x local, both gloo) reduces two random
    rows of ``n`` through ``DistRingSyncOp`` with ``hierarchy(...)``;
    the result must equal each 1/2 slice ringed by the simulator with
    its own codebooks, concatenated, bit for bit."""
    import torch.nn.functional as F
    from repro_torch.core import elastic_mesh as em
    from repro_torch.core import ring_reduce as rr
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import step as ts
    wan, local = DIST_HIER
    cfg = rr.RingConfig()
    gen = torch.Generator(device="cuda").manual_seed(10)
    xs = torch.randn((wan, n), generator=gen, device="cuda").mul_(1e-3)
    w = torch.ones((wan,), device="cuda")
    order = tuple(reversed(range(wan)))
    with make_mesh((wan, local), ("data", "model"), timeout=300.0) as mesh:
        hier = em.hierarchy(mesh, "data")
        pr = ts.DistSyncPrograms(mesh, "data", n, cfg, ring_order=order,
                                 hierarchy=hier)
        t0 = time.perf_counter()
        out = ts.DistRingSyncOp(pr, xs, weights=w).finish()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rec = pr.log[-1]
    want_l = {k: rec["ranks"] * c
              for k, c in rr.codec_calls(wan, cfg, False).items()}
    if rec["launches"] != want_l:
        raise AssertionError(f"dist hierarchical: launches "
                             f"{rec['launches']}, want {want_l}")
    sl = pr.slice_len
    pad = F.pad(xs, (0, hier.n_local * sl - n))
    del xs
    for i in range(hier.n_local):
        part = rr.simulate_ring_all_reduce(pad[:, i * sl:(i + 1) * sl],
                                           order, cfg, w)
        hi = min((i + 1) * sl, n)
        if not torch.equal(part[:, :hi - i * sl], out[:, i * sl:hi]):
            raise AssertionError(f"dist hierarchical: slice {i} differs "
                                 f"from the per-slice simulator")
        del part
    del pad, out
    torch.cuda.empty_cache()
    dist_codec_rows(pr.chunk, wan)
    hops = [{f: round(v * 1e3, 2) for f, v in ht.items()}
            for ht in rec["hop_times"]]
    log(f"dist hierarchical ({wan}, {local}) mesh, local group gloo: "
        f"{wan} x {n} rows bitwise equal to the per-slice simulator, "
        f"launches {json.dumps(rec['launches'])} (= {rec['ranks']} x "
        f"codec_calls), {wall * 1e3:.1f} ms, per hop ms {json.dumps(hops)}")
    return {"wall_s": wall, "launches": rec["launches"], "hops": hops}


# -- phase 10: swarm serving --------------------------------------------------


def b1_flash_decode(label: str = "intellect-1", hk: int = 8, g: int = 4,
                    dh: int = 128, seed: int = 40) -> dict:
    """Kernels 5 and 6 at the swarm path's shape: B = 1 (one request a
    stage call) at ``label``'s heads (Hk, G, dh), S_max 512, at lengths
    ``SWARM_B1_LENGTHS``; kernel 6 on a permuted pool of 16-cell blocks
    the size of a stage server's default pool (4 requests' worth + trash),
    bitwise equal to kernel 5 on the gathered view. Each against its plain
    version within ``TOL`` and a repeat bitwise equal, timed beside SDPA
    (kernel 6: the gather + SDPA)."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models.attention import (PagedKVCache, decode_valid_mask,
                                              paged_view)
    s_max, blk = 512, 16
    out = {"flash_decode": {"ms": [], "bound_ms": [], "library_ms": [],
                            "max_abs_err": 0.0},
           "flash_decode_paged": {"ms": [], "bound_ms": [], "library_ms": [],
                                  "max_abs_err": 0.0}}
    for i, n in enumerate(SWARM_B1_LENGTHS):
        q, k, v, length = flash_decode_inputs(1, s_max, hk, g, dh,
                                              torch.bfloat16, [n],
                                              seed=seed + i)
        kp, vp, table = paged_pool(k, v, [n], blk, seed=seed + i)
        pad = torch.randn((4 * s_max // blk + 1 - kp.shape[0], blk, hk, dh),
                          device="cuda").to(kp.dtype)
        kp, vp = torch.cat([kp, pad]), torch.cat([vp, pad])  # more blocks
        dense = fd.flash_decode(q, k, v, length)
        paged = fd.flash_decode_paged(q, kp, vp, table, length)
        torch.cuda.synchronize()
        view = paged_view(PagedKVCache(kp, vp, table, length))
        if not torch.equal(paged, fd.flash_decode(q, view.k, view.v, length)):
            raise AssertionError(f"flash_decode_paged {label} B=1 length "
                                 f"{n}: not bitwise equal to flash_decode "
                                 "on the gathered view")
        valid = decode_valid_mask(length, s_max, None)[:, None, None, :]
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        bound, _ = flash_decode_bound(q, k, length, None)
        for name, got, ref, run, library, extra in (
                ("flash_decode", dense, fd.flash_decode_torch(q, k, v, length),
                 lambda: fd.flash_decode(q, k, v, length),
                 lambda: torch.nn.functional.scaled_dot_product_attention(
                     qt, kt, vt, attn_mask=valid, enable_gqa=True), 0),
                ("flash_decode_paged", paged,
                 fd.flash_decode_paged_torch(q, kp, vp, table, length),
                 lambda: fd.flash_decode_paged(q, kp, vp, table, length),
                 lambda: torch.nn.functional.scaled_dot_product_attention(
                     qt, paged_view(PagedKVCache(kp, vp, table, length))
                     .k.transpose(1, 2), paged_view(PagedKVCache(
                         kp, vp, table, length)).v.transpose(1, 2),
                     attn_mask=valid, enable_gqa=True), table.numel() * 4)):
            err = check_repeat_and_close(f"{name} {label} B=1 length {n}",
                                         got, run(), ref, torch.bfloat16)
            e = out[name]
            e["max_abs_err"] = max(e["max_abs_err"], err)
            e["ms"].append(time_ms(run))
            e["bound_ms"].append(flash_decode_bound(
                q, k, length, None, extra_bytes=extra)[0])
            e["library_ms"].append(time_ms(library))
        del q, k, v, kp, vp, pad, view
    for name, e in out.items():
        e.update(lengths=list(SWARM_B1_LENGTHS),
                 shape={"B": 1, "S_max": s_max, "Hk": hk, "G": g, "dh": dh,
                        "dtype": "bfloat16"})
        log(f"kernel {name} {label} Hk={hk} G={g} dh={dh} B=1 (swarm stage "
            f"calls) lengths "
            f"{SWARM_B1_LENGTHS}: max|err|={e['max_abs_err']:.3g} (tol "
            f"{TOL[torch.bfloat16]}); ms {[round(t, 5) for t in e['ms']]}, "
            f"bound {[round(t, 6) for t in e['bound_ms']]}, "
            f"{'gather+' if 'paged' in name else ''}SDPA "
            f"{[round(t, 5) for t in e['library_ms']]}")
    torch.cuda.empty_cache()
    return out


def swarm_classes():
    """A ``SwarmRouter`` that keeps the last stage's logits of every step
    and the wall time of every stage RPC by (op, stage)."""
    from repro_torch.serving.swarm_serve import SwarmRouter

    class TimedRouter(SwarmRouter):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.logits, self.rpc_s = [], {}

        def _call(self, addr, header, arr):
            t0 = time.perf_counter()
            out = super()._call(addr, header, arr)
            self.rpc_s.setdefault((header["op"], header["sid"]), []).append(
                time.perf_counter() - t0)
            return out

        def _prefill_chain(self, req):
            self.logits.append(super()._prefill_chain(req))
            return self.logits[-1]

        def _decode_chain(self, req):
            self.logits.append(super()._decode_chain(req))
            return self.logits[-1]
    return TimedRouter


class SwarmFleet:
    """``SWARM``'s fleet on the card: ``stages x replicas`` StageServers
    over loopback serving views of one weight set, a gossip and a pooled
    ``TimedRouter`` over them; ``close`` stops every server and thread."""

    def __init__(self, cfg, params, root: Path, kv_layout: str,
                 extra=(), dead=(), conf=None):
        from repro_torch.checkpointing import (ChunkGossip, ChunkStore,
                                               PeerConnPool)
        from repro_torch.models import registry
        from repro_torch.serving.swarm_serve import StageServer
        s = conf or SWARM
        self.servers = {}
        for sid, stage in enumerate(registry.make_stages(cfg, s["stages"])):
            sp = stage.slice_params(params)
            for r in range(s["replicas"]):
                srv = StageServer(cfg, ChunkStore(root / f"{kv_layout}{sid}{r}"),
                                  k_stages=s["stages"], max_len=s["max_len"],
                                  kv_layout=kv_layout)
                srv.serve_stage(sid, sp)
                self.servers[(sid, r)] = srv
        for key in dead:                  # killed before the first poll
            self.servers[key].crash()
        self.pool = PeerConnPool(timeout=30.0)
        self.gossip = ChunkGossip(
            [v.addr for v in self.servers.values()] + [e.addr for e in extra],
            timeout=30.0, pool=self.pool)
        self.gossip.poll_once()
        self.router = swarm_classes()(s["stages"], self.gossip, timeout=30.0,
                                      pool=self.pool, max_len=s["max_len"])

    def close(self) -> None:
        self.gossip.stop()
        self.pool.close()
        for srv in self.servers.values():
            srv.close()


def swarm_reference(model, params, cfg, reqs, conf=None) -> tuple[list,
                                                                  list]:
    """Run 1: the B = 1 single-host engine (ContinuousEngine, one slot,
    batch-1 admission) on the trace, and the B = 1 monolithic prefill and
    decode along its tokens (the engine's computation), whose logits the
    healthy chains must equal bitwise."""
    import numpy as np

    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import ContinuousEngine, bucket_len
    s = conf or SWARM
    eng = ContinuousEngine(model, params, batch_slots=1, batch_admit=False,
                           max_len=s["max_len"])
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = [list(r.out_tokens) for r in reqs]
    logits = []
    for r, toks in zip(reqs, tokens):
        n = len(r.prompt)
        row = torch.zeros((1, max(min(bucket_len(n), s["max_len"]), n)),
                          dtype=torch.int32)
        row[0, :n] = torch.from_numpy(np.asarray(r.prompt, np.int32))
        cache = tf.init_cache(cfg, 1, s["max_len"])
        lg, _ = tf.prefill(cfg, params, row.cuda(), cache,
                           prompt_len=torch.tensor([n], dtype=torch.int32,
                                                   device="cuda"))
        steps = [lg.cpu()]
        for t in toks[:-1]:
            lg, _ = tf.decode_step(cfg, params, torch.tensor(
                [[t]], dtype=torch.int32, device="cuda"), cache)
            steps.append(lg.cpu())
        if [int(x[0].float().argmax()) for x in steps] != toks:
            raise AssertionError("swarm reference: the B=1 monolithic decode's"
                                 " greedy tokens differ from the B=1 engine's")
        logits.append(steps)
    ntok = sum(len(t) for t in tokens)
    log(f"swarm run 1, B=1 engine: {ntok} tokens in {wall:.3f}s "
        f"({ntok / wall:.1f} tok/s); its B=1 monolithic decode gives the "
        f"same greedy tokens")
    return tokens, logits


def swarm_run(label, fleet, prompts, ref_tokens, ref_logits, *, kernel,
              stage_layers, crash=None, conf=None) -> dict:
    """Drive ``prompts`` through ``fleet``'s router; the decode kernel
    counts are set to 0 just before and read just after. Gates: tokens
    equal the reference's, and every step's last-stage logits its
    logits bitwise (the recovered steps too: the router replays a failed
    stage's prefix as the uninterrupted run computed it); ``kernel``
    launched ``stage_layers[sid]`` (the layers stage sid runs) times a
    ``decode_stage`` call a server of stage sid answered (k calls a
    healthy step; the replay's too), the other decode kernel never;
    paged pools drained. ``crash`` (a server) fails the stage-1 holder
    the router plans first 3 responses in, and then one failover and one
    recovery (the pools of live servers drain; the crashed one's died
    with it, mid-request)."""
    conf = conf or SWARM
    router, k = fleet.router, conf["stages"]
    if crash is not None:
        crash.crash_after = crash.served_chunks + 3
    reset_decode_counts()
    t0 = time.perf_counter()
    outs = [router.generate(p, conf["max_new"], rid=f"req{i}", eos_id=1)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = decode_counts()
    st = dict(router.stats)
    if outs != ref_tokens:
        raise AssertionError(f"swarm {label}: greedy tokens differ from the "
                             "B=1 engine's")
    decodes = sum(len(v) for (op, _), v in router.rpc_s.items()
                  if op == "decode_stage")
    if crash is None and decodes != k * st["decode_steps"]:
        raise AssertionError(f"swarm {label}: {decodes} decode_stage calls "
                             f"for {st['decode_steps']} steps of {k} stages")
    launches = check_launches(
        f"swarm {label}", counts, kernel,
        sum(stage_layers[sid] * len(v) for (op, sid), v in
            router.rpc_s.items() if op == "decode_stage"))
    flat_ref = [x for steps in ref_logits for x in steps]
    if len(router.logits) != len(flat_ref):
        raise AssertionError(f"swarm {label}: {len(router.logits)} logit "
                             f"rows, want {len(flat_ref)}")
    diffs = [(a.float() - b.float()).abs().max().item()
             for a, b in zip(router.logits, flat_ref)]
    if any(diffs):
        raise AssertionError(f"swarm {label}: logits not bitwise the B=1 "
                             f"reference's (max |diff| {max(diffs)})")
    if (st["failovers"], st["recoveries"]) != ((0, 0) if crash is None
                                                else (1, 1)):
        raise AssertionError(f"swarm {label}: failovers {st['failovers']}, "
                             f"recoveries {st['recoveries']}")
    peak_blocks = 0
    for srv in fleet.servers.values():
        if srv.addr in router.dead:       # a crashed server's pool died
            continue                      # with it, mid-request
        for ent in srv._pools.values():
            peak_blocks = max(peak_blocks, ent["pool"].stats["peak_used"])
            if ent["pool"].used:
                raise AssertionError(f"swarm {label}: {ent['pool'].used} "
                                     "blocks still held after release")
    if kernel == "flash_decode_paged" and not peak_blocks:
        raise AssertionError(f"swarm {label}: no paged pool was used")
    ntok = sum(len(o) for o in outs)
    rpc = {f"{op[0][:-6]}{op[1]}": 1e3 * sum(v) / len(v)
           for op, v in sorted(router.rpc_s.items())}
    rpc_max = {f"{op[0][:-6]}{op[1]}": 1e3 * max(v)
               for op, v in sorted(router.rpc_s.items())}
    log(f"swarm {label}: {ntok} tokens in {wall:.3f}s "
        f"({ntok / wall:.1f} tok/s) decode_steps={st['decode_steps']} "
        f"launches {kernel}={launches} failovers={st['failovers']} "
        f"recoveries={st['recoveries']} replayed_tokens="
        f"{st['replayed_tokens']} recovery_s={st['recovery_s']:.4f} "
        f"fresh_retries={st['fresh_retries']} paged_blocks_peak={peak_blocks}"
        f" decode_stage calls={decodes}; every step's logits bitwise the B=1 "
        f"reference's; mean rpc ms "
        f"{json.dumps({k_: round(v, 3) for k_, v in rpc.items()})}, max "
        f"{json.dumps({k_: round(v, 3) for k_, v in rpc_max.items()})}")
    return {"tok_s": ntok / wall, "wall_s": wall, "launches": launches,
            "stats": st, "rpc_ms": rpc, "paged_blocks_peak": peak_blocks,
            "decode_stage_calls": decodes}


def stage_compute_ms(cfg, params) -> dict:
    """Each stage's ``decode`` on the card at B = 1 (a fresh stage cache
    prefilled with 48 tokens), host clock around the call and a
    synchronize, as a server computes it: mean ms over 20 calls."""
    from repro_torch.models import registry
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(3)
    for stage in registry.make_stages(cfg, SWARM["stages"]):
        sp = stage.slice_params(params)
        cache = stage.init_cache(1, SWARM["max_len"])
        if stage.first:
            x = torch.randint(2, cfg.vocab, (1, 48), generator=gen,
                              device="cuda", dtype=torch.int32)
        else:
            x = torch.randn((1, 48, cfg.d_model), generator=gen,
                            device="cuda").to(cfg.torch_dtype)
        stage.prefill(sp, x, cache)
        one = x[:, :1]
        times = []
        for _ in range(23):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y, _ = stage.decode(sp, one, cache)
            y.cpu()
            times.append(time.perf_counter() - t0)
        out[stage.index] = 1e3 * sum(times[3:]) / 20
    return out


def recovery_kv_delta(cfg, params, prompt, tokens, n_done: int) -> dict:
    """Why the port's router replays a failed stage's prefix token by
    token: when stage 1 fails at decode step ``n_done`` (0-based), the
    JAX package's recovery rebuilds its KV cache by one prefill over the
    prefix (an (S, D) product, prefill attention). Against the cache the
    uninterrupted chain built (prefill, then one (1, D) row a step
    through the flash-decode kernel), and the last stage's logits of the
    recovered step against the uninterrupted step's: max |diff| of
    each, and whether the greedy token survives."""
    from repro_torch.models import registry
    from repro_torch.serving.engine import bucket_len
    stages = registry.make_stages(cfg, SWARM["stages"])
    sp = [s.slice_params(params) for s in stages]
    caches = [s.init_cache(1, SWARM["max_len"]) for s in stages]

    def padded(toks):
        n = len(toks)
        row = torch.zeros((1, max(min(bucket_len(n), SWARM["max_len"]), n)),
                          dtype=torch.int32, device="cuda")
        row[0, :n] = torch.tensor(toks, dtype=torch.int32)
        return row, torch.tensor([n], dtype=torch.int32, device="cuda")
    x, plen = padded(prompt)
    for s, p, c in zip(stages, sp, caches):
        x, _ = s.prefill(p, x, c, prompt_len=plen)
    for t in tokens[:n_done + 1]:
        x = torch.tensor([[t]], dtype=torch.int32, device="cuda")
        for s, p, c in zip(stages, sp, caches):
            x, _ = s.decode(p, x, c)
    want_logits = x
    prefix = list(prompt) + list(tokens[:n_done + 1])
    L = len(prefix)
    x, plen = padded(prefix)
    x, _ = stages[0].prefill(sp[0], x, stages[0].init_cache(1, SWARM["max_len"]),
                             prompt_len=plen)
    rebuilt = stages[1].init_cache(1, SWARM["max_len"])
    x, _ = stages[1].prefill(sp[1], x, rebuilt, prompt_len=plen)
    # stage 2 holds the uninterrupted cache one position short: take it
    # back to L - 1 and append the recovered last position
    c2 = caches[2]["scan"]
    c2.length.fill_(L - 1)
    got_logits, _ = stages[2].decode(sp[2], x[:, L - 1:L], caches[2])
    a, b = rebuilt["scan"], caches[1]["scan"]
    kv = max((x[:, :, :L].float() - y[:, :, :L].float()).abs().max().item()
             for x, y in ((a.k, b.k), (a.v, b.v)))
    lg = (got_logits.float() - want_logits.float()).abs().max().item()
    same = int(got_logits[0].float().argmax()) == int(
        want_logits[0].float().argmax())
    log(f"swarm one-pass recovery numerics (the JAX package's: stage 1 "
        f"rebuilt by one prefill over {L} tokens vs built one row a step): "
        f"max|K/V diff|={kv:.4g}, recovered step max|logit diff|={lg:.4g}, "
        f"same greedy token: {same}")
    return {"kv_max_abs_diff": kv, "logit_max_abs_diff": lg,
            "same_token": same, "prefix_len": L}


def swarm_serve_phase() -> dict:
    """Phase 10 (``SWARM``): INTELLECT-1 at full width, depth cut, served
    by a 3-stage x 2-replica fleet on the card. Runs: (1) the B = 1
    engine, (2) the healthy dense chain, (3) the healthy paged chain,
    (4) dense and (5) paged with stage 1's first holder crashed 3
    responses in, (6) stage 1 published into a seed store, adopted by a
    fresh server by swarm fetch, and served by it alone."""
    from repro_torch.checkpointing import ChunkPeer, ChunkStore
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import transformer as tf
    from repro_torch.models.registry import get_model
    from repro_torch.serving.swarm_serve import StageServer, publish_stages
    s = SWARM
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(s["arch"]), n_layers=s["n_layers"])
    bounds = tf.stage_bounds(cfg, s["stages"])
    per_stage = bounds[0][1] - bounds[0][0]
    if any(hi - lo != per_stage for lo, hi in bounds):
        raise AssertionError(f"swarm: uneven stages {bounds}")
    model = get_model(cfg, "cuda")
    params = model.init(s["seed"])
    args = serve_mod.build_parser().parse_args(
        ["--requests", str(s["requests"]), "--prompt-len",
         str(s["prompt_len"]), "--max-new", str(s["max_new"]),
         "--seed", str(s["seed"])])
    reqs = serve_mod.make_requests(args, cfg.vocab)
    prompts = [r.prompt.tolist() for r in reqs]
    ref_tokens, ref_logits = swarm_reference(model, params, cfg, reqs)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_swarm_"))
    runs, open_ = {}, []            # what is still running, closed last
    try:
        for layout, kernel in (("dense", "flash_decode"),
                               ("paged", "flash_decode_paged")):
            for crashed in (False, True):
                fleet = SwarmFleet(cfg, params, root / f"{layout}{crashed}",
                                   layout)
                open_.append(fleet)
                victim = None
                if crashed:
                    first = fleet.router._pick(1)
                    victim = next(v for v in fleet.servers.values()
                                  if v.addr == first)
                label = (f"run {2 + (layout == 'paged') + 2 * crashed}, "
                         f"{layout}{', stage-1 crash' if crashed else ''}")
                runs[(layout, crashed)] = swarm_run(
                    label, fleet, prompts, ref_tokens, ref_logits,
                    kernel=kernel, stage_layers=[per_stage] * s["stages"],
                    crash=victim)
                open_.pop().close()
        # run 6: adoption through the chunk swarm
        seed_store = ChunkStore(root / "seed")
        t0 = time.perf_counter()
        publish_stages(seed_store, cfg, params, s["stages"], stage_ids=[1])
        publish_s = time.perf_counter() - t0
        seed = ChunkPeer(seed_store)
        open_.append(seed)
        adopter = StageServer(cfg, ChunkStore(root / "adopter"),
                              k_stages=s["stages"], max_len=s["max_len"])
        open_.append(adopter)
        t0 = time.perf_counter()
        fetched = adopter.adopt_stage(1, [seed.addr], timeout=120.0)
        torch.cuda.synchronize()
        adopt_s = time.perf_counter() - t0
        open_.append(SwarmFleet(cfg, params, root / "adopt", "dense",
                                extra=[adopter],
                                dead=[(1, r) for r in range(s["replicas"])]))
        fleet = open_[-1]
        if fleet.router.holders(1) != [adopter.addr]:
            raise AssertionError(f"swarm adopt: stage 1 holders "
                                 f"{fleet.router.holders(1)}")
        runs["adopt"] = swarm_run("run 6, stage 1 adopted", fleet, prompts,
                                  ref_tokens, ref_logits,
                                  kernel="flash_decode",
                                  stage_layers=[per_stage] * s["stages"])
        served = adopter.served_chunks
        want = s["requests"] + runs["adopt"]["stats"]["decode_steps"]
        if served != want:
            raise AssertionError(f"swarm adopt: the adopter served {served} "
                                 f"stage responses, want {want}")
        log(f"swarm adopt: stage 1 ({per_stage} layers) published in "
            f"{publish_s:.2f}s, adopted by swarm fetch in {adopt_s:.2f}s "
            f"({fetched['chunks_fetched']} chunks), then served all "
            f"{served} stage-1 responses")
    finally:
        for obj in reversed(open_):
            obj.close()
        shutil.rmtree(root, ignore_errors=True)
    recovery = recovery_kv_delta(cfg, params, prompts[0], ref_tokens[0], 2)
    compute = stage_compute_ms(cfg, params)
    wire = {sid: runs[("dense", False)]["rpc_ms"][f"decode{sid}"] - ms
            for sid, ms in compute.items()}
    peak = torch.cuda.max_memory_allocated()
    log(f"swarm stage compute ms a decode_stage (B=1, host clock to the "
        f"output on the host) {json.dumps({k: round(v, 3) for k, v in compute.items()})}"
        f", wire ms (healthy dense run's mean rpc - compute) "
        f"{json.dumps({k: round(v, 3) for k, v in wire.items()})}")
    b1 = b1_flash_decode()
    wall = time.perf_counter() - t_phase
    log(f"swarm phase: {s['arch']} depth {s['n_layers']} "
        f"params={cfg.param_count()} (norms apart) "
        f"stages={s['stages']}x{s['replicas']} peak_mem={peak / 2**30:.2f}GiB "
        f"in {wall:.1f}s")
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"runs": runs, "recovery": recovery, "compute_ms": compute,
            "wire_ms": wire, "peak_bytes": peak, "b1": b1,
            "adopt_s": adopt_s, "publish_s": publish_s,
            "adopt_chunks": fetched["chunks_fetched"], "wall_s": wall}



# -- phase 11: the MoE and VLM families ---------------------------------------


def moe_flash_decode() -> dict:
    """Kernels 5 and 6 at ``MOE_FD_CASES`` (bf16), and at the MoE swarm's
    B = 1 (``b1_flash_decode`` at 16 heads of 128): each against its
    plain version within ``TOL``, a repeat bitwise equal, kernel 6 on a
    permuted pool of 16-cell blocks bitwise equal to kernel 5 on the
    gathered view; timed beside SDPA (kernel 6: the gather + SDPA),
    bound from the bytes."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models.attention import (PagedKVCache, decode_valid_mask,
                                              paged_view)
    out = {"flash_decode": {}, "flash_decode_paged": {}}
    for i, (label, b, s_max, hk, g, dh, lengths) in enumerate(MOE_FD_CASES):
        q, k, v, length = flash_decode_inputs(b, s_max, hk, g, dh,
                                              torch.bfloat16, lengths,
                                              seed=60 + i)
        kp, vp, table = paged_pool(k, v, length, 16, seed=60 + i)
        dense = fd.flash_decode(q, k, v, length)
        paged = fd.flash_decode_paged(q, kp, vp, table, length)
        torch.cuda.synchronize()
        view = paged_view(PagedKVCache(kp, vp, table, length))
        if not torch.equal(paged, fd.flash_decode(q, view.k, view.v, length)):
            raise AssertionError(f"flash_decode_paged {label}: not bitwise "
                                 "equal to flash_decode on the gathered view")
        valid = decode_valid_mask(length, s_max, None)[:, None, None, :]
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        shape = {"B": b, "S_max": s_max, "Hk": hk, "G": g, "dh": dh,
                 "dtype": "bfloat16", "lengths": lengths}
        for name, got, run, plain, library, extra in (
                ("flash_decode", dense,
                 lambda: fd.flash_decode(q, k, v, length),
                 lambda: fd.flash_decode_torch(q, k, v, length),
                 lambda: torch.nn.functional.scaled_dot_product_attention(
                     qt, kt, vt, attn_mask=valid), 0),
                ("flash_decode_paged", paged,
                 lambda: fd.flash_decode_paged(q, kp, vp, table, length),
                 lambda: fd.flash_decode_paged_torch(q, kp, vp, table,
                                                     length),
                 lambda: torch.nn.functional.scaled_dot_product_attention(
                     qt, paged_view(PagedKVCache(kp, vp, table, length))
                     .k.transpose(1, 2), paged_view(PagedKVCache(
                         kp, vp, table, length)).v.transpose(1, 2),
                     attn_mask=valid), table.numel() * 4)):
            err = check_repeat_and_close(f"{name} {label}", got, run(),
                                         plain(), torch.bfloat16)
            bound, bound_by = flash_decode_bound(q, k, length, None,
                                                 extra_bytes=extra)
            e = {"ms": time_ms(run), "plain_ms": time_ms(plain),
                 "bound_ms": bound, "bound_by": bound_by,
                 "library_ms": time_ms(library), "max_abs_err": err,
                 "shape": shape}
            out[name][label] = e
            log(f"kernel {name} {label} (Hq=Hk={hk}, dh={dh}, B={b}, "
                f"S_max={s_max}, lengths {lengths}): max|err|={err:.3g} "
                f"(tol {TOL[torch.bfloat16]}), repeat bitwise; "
                f"{e['ms']:.5f} ms, bound {bound:.6f} ms ({bound_by}), plain "
                f"{e['plain_ms']:.5f} ms, {'gather+' if extra else ''}SDPA "
                f"{e['library_ms']:.5f} ms")
        del q, k, v, kp, vp, view, kt, vt
    torch.cuda.empty_cache()
    b1 = b1_flash_decode("deepseek-moe-16b swarm", 16, 1, 128, seed=70)
    for name, e in b1.items():
        out[name]["deepseek-moe-16b swarm B=1"] = e
    return out


def meta_param_count(cfg) -> int:
    """Parameters of ``cfg``'s tree, counted on the ``meta`` device."""
    from repro_torch.core.sync_engine import leaves
    from repro_torch.models import transformer as tf
    return sum(t.numel() for t in leaves(tf.alloc_lm(cfg, device="meta")))


def moe_serve() -> dict:
    """deepseek-moe-16b at full width and depth through ``launch.serve``
    (``MOE_SERVE``): the continuous engine twice (run 1 warms the card
    up), the paged engine twice, then ``ContinuousEngine(batch_admit=
    False)`` on the same trace and weights. Gates: every request done,
    tokens in the vocabulary, kernel 5 (6) launched n_layers = 28 times
    a decode step (the dense first layer counted), the other never; the
    paged tokens equal the foil's."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models.registry import get_model
    from repro_torch.serving.engine import make_engine
    args = serve_mod.build_parser().parse_args(MOE_SERVE)
    cfg = get_config(args.arch)
    n_meta = meta_param_count(cfg)
    if n_meta != cfg.param_count() + (2 * cfg.n_layers + 1) * cfg.d_model:
        raise AssertionError(f"moe: {n_meta} parameters on meta, the config "
                             f"counts {cfg.param_count()} + the norms")
    runs = {}
    for engine in ("continuous", "paged"):
        for run in (1, 2):
            torch.cuda.reset_peak_memory_stats()
            reset_decode_counts()
            s = serve_mod.main(MOE_SERVE + ["--engine", engine])
            counts = decode_counts()
            torch.cuda.synchronize()
            if not all(s["done"]) or s["requests"] != 8:
                raise AssertionError(f"moe {engine}: a request did not finish")
            if not all(0 <= t < s["padded_vocab"]
                       for o in s["outputs"] for t in o):
                raise AssertionError(f"moe {engine}: token outside the "
                                     "vocabulary")
            kernel = "flash_decode_paged" if engine == "paged" \
                else "flash_decode"
            s["launches"] = check_launches(
                f"moe {engine}", counts, kernel,
                cfg.n_layers * s["decode_steps"])
            s["peak_bytes"] = torch.cuda.max_memory_allocated()
            extra = (f" blocks_peak={s['blocks_peak']}/{s['pool_blocks']} "
                     f"prefix_hit_rate={s['prefix_hit_rate']:.3f}"
                     if engine == "paged" else "")
            log(f"moe {args.arch} {engine} run {run}: "
                f"tok/s={s['tokens_per_s']:.1f} "
                f"p50={s['latency_p50_s'] * 1e3:.1f}ms "
                f"p95={s['latency_p95_s'] * 1e3:.1f}ms "
                f"decode_steps={s['decode_steps']} launches={s['launches']} "
                f"({s['launches'] // s['decode_steps']} a step) "
                f"tokens={s['tokens_out']} wall={s['wall_s']:.3f}s "
                f"peak_mem={s['peak_bytes'] / 2**30:.2f}GiB{extra}")
            runs[(engine, run)] = s
            gc.collect()
            torch.cuda.empty_cache()
    if runs[("paged", 2)]["outputs"] != runs[("paged", 1)]["outputs"]:
        raise AssertionError("moe paged: the two runs differ")
    model = get_model(cfg, "cuda")
    params = model.init(args.seed)
    eng = make_engine("continuous", model, params, batch_admit=False,
                      **serve_mod.engine_kwargs(args))
    reqs = serve_mod.make_requests(args, cfg.vocab)
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    foil = eng.perf_summary()
    if [list(r.out_tokens) for r in reqs] != runs[("paged", 2)]["outputs"]:
        raise AssertionError("moe: paged greedy tokens differ from "
                             "ContinuousEngine(batch_admit=False)'s")
    log(f"moe continuous batch_admit=False: identical greedy tokens to the "
        f"paged run; tok/s={foil['tokens_per_s']:.1f} "
        f"p50={foil['latency_p50_s'] * 1e3:.1f}ms "
        f"p95={foil['latency_p95_s'] * 1e3:.1f}ms; parameters {n_meta} "
        f"(meta device)")
    del eng, params, model, reqs
    gc.collect()
    torch.cuda.empty_cache()
    keys = ("tokens_per_s", "latency_p50_s", "latency_p95_s",
            "decode_steps", "tokens_out", "wall_s", "launches", "peak_bytes")
    out = {e: {k: runs[(e, 2)][k] for k in keys}
           for e in ("continuous", "paged")}
    out["paged"].update({k: runs[("paged", 2)][k] for k in
                         ("blocks_peak", "pool_blocks", "prefix_hit_rate")})
    out["foil"] = {k: foil[k] for k in keys[:6]}
    out["params"] = n_meta
    return out


def moe_swarm() -> dict:
    """deepseek-moe-16b at full width, depth ``MOE_SWARM["n_layers"]``,
    2 stages x 2 replicas over loopback on the serving trace: stage 0
    holds dense0 (and its cache, dense or paged) and 2 MoE layers, stage
    1 one. Runs: the B = 1 engine; healthy dense and paged chains; the
    dense chain with stage 1's first holder crashed 3 responses in.
    Gates (``swarm_run``): tokens and every step's last-stage logits
    bitwise the B = 1 engine's; launches the layers of each answered
    ``decode_stage``."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import transformer as tf
    from repro_torch.models.registry import get_model
    s = MOE_SWARM
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(s["arch"]), n_layers=s["n_layers"])
    stage_layers = [hi - lo + (tf.n_dense_prefix(cfg) if i == 0 else 0)
                    for i, (lo, hi) in enumerate(tf.stage_bounds(
                        cfg, s["stages"]))]
    model = get_model(cfg, "cuda")
    params = model.init(s["seed"])
    args = serve_mod.build_parser().parse_args(
        ["--requests", str(s["requests"]), "--prompt-len",
         str(s["prompt_len"]), "--max-new", str(s["max_new"]),
         "--seed", str(s["seed"])])
    reqs = serve_mod.make_requests(args, cfg.vocab)
    prompts = [r.prompt.tolist() for r in reqs]
    ref_tokens, ref_logits = swarm_reference(model, params, cfg, reqs,
                                             conf=s)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_moe_swarm_"))
    runs = {}
    try:
        for layout, kernel, crashed in (("dense", "flash_decode", False),
                                        ("paged", "flash_decode_paged",
                                         False),
                                        ("dense", "flash_decode", True)):
            fleet = SwarmFleet(cfg, params, root / f"{layout}{crashed}",
                               layout, conf=s)
            try:
                victim = None
                if crashed:
                    first = fleet.router._pick(1)
                    victim = next(v for v in fleet.servers.values()
                                  if v.addr == first)
                runs[(layout, crashed)] = swarm_run(
                    f"moe {layout}{', stage-1 crash' if crashed else ''}",
                    fleet, prompts, ref_tokens, ref_logits, kernel=kernel,
                    stage_layers=stage_layers, crash=victim, conf=s)
            finally:
                fleet.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated()
    log(f"moe swarm: {s['arch']} depth {s['n_layers']} stages "
        f"{tf.stage_bounds(cfg, s['stages'])} (layers a stage "
        f"{stage_layers}) x{s['replicas']} peak_mem={peak / 2**30:.2f}GiB in "
        f"{time.perf_counter() - t0:.1f}s")
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"runs": runs, "peak_bytes": peak, "stage_layers": stage_layers}


def vlm_decode() -> dict:
    """phi-3-vision-4.2b at full width and depth: one prefill of B = 2
    prompts of ``VLM["prompt_len"]`` tokens behind a random 576-patch
    frontend (embedding scale), then ``VLM["steps"]`` greedy decode
    steps. Gates: every step's logits within ``VLM_TOL`` of the full
    forward's (teacher forcing) at its position; kernel 5 launched 32
    times a step; 2 stages (the frontend into stage 0) bitwise the
    monolithic prefill and decode."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import registry
    from repro_torch.models import transformer as tf
    v = VLM
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(v["arch"])
    model = registry.get_model(cfg, "cuda")
    params = model.init(v["seed"])
    gen = torch.Generator(device="cuda").manual_seed(v["seed"])
    b, n = v["batch"], v["prompt_len"]
    toks = torch.randint(2, cfg.vocab, (b, n), generator=gen, device="cuda",
                         dtype=torch.int32)
    front = (0.02 * torch.randn((b, cfg.n_frontend, cfg.d_model),
                                generator=gen, device="cuda")
             ).to(cfg.torch_dtype)
    shape = ShapeConfig("vlm", "decode", v["max_len"], b)
    logits, cache = model.prefill(params, {"tokens": toks, "frontend": front},
                                  model.init_cache(b, shape))
    steps, gen_toks = [logits], []
    reset_decode_counts()
    for _ in range(v["steps"]):
        tok = steps[-1].argmax(-1, keepdim=True).to(torch.int32)
        gen_toks.append(tok)
        lg, cache = model.decode(params, tok, cache)
        steps.append(lg)
    torch.cuda.synchronize()
    counts = decode_counts()
    launches = check_launches("vlm decode", counts, "flash_decode",
                              cfg.n_layers * v["steps"])
    with torch.no_grad():
        full, _ = tf.forward(cfg, params, torch.cat([toks] + gen_toks, 1),
                             frontend=front)
    f = cfg.n_frontend
    errs, agree = [], 0
    for j, lg in enumerate(steps):
        want = full[:, f + n - 1 + j]
        errs.append((lg.float() - want.float()).abs().max().item())
        agree += int((lg.argmax(-1) == want.argmax(-1)).sum())
    scale = full[:, f + n - 1:].float().abs().max().item()
    if not all(math.isfinite(e) for e in errs) or max(errs) > VLM_TOL:
        raise AssertionError(f"vlm: decode vs teacher forcing max|err| "
                             f"{max(errs)} > {VLM_TOL}")
    stages = registry.make_stages(cfg, 2)
    sp = [st.slice_params(params) for st in stages]
    sc = [st.init_cache(b, v["max_len"]) for st in stages]
    x = toks
    for i, (st, p, c) in enumerate(zip(stages, sp, sc)):
        x, _ = st.prefill(p, x, c, frontend=front if i == 0 else None)
    staged = [x]
    for tok in gen_toks:
        x = tok
        for st, p, c in zip(stages, sp, sc):
            x, _ = st.decode(p, x, c)
        staged.append(x)
    if not all(torch.equal(a, c) for a, c in zip(staged, steps)):
        raise AssertionError("vlm: 2 stages not bitwise the monolithic "
                             "prefill and decode")
    peak = torch.cuda.max_memory_allocated()
    wall = time.perf_counter() - t0
    log(f"vlm {cfg.name}: {cfg.n_layers} layers dh={cfg.d_model // cfg.n_heads}"
        f", prefill B={b} of {f} patches + {n} tokens, {v['steps']} decode "
        f"steps: max|logit err| vs teacher forcing {max(errs):.4g} (tol "
        f"{VLM_TOL}; logits' max |value| {scale:.3g}), greedy agreement "
        f"{agree}/{len(steps) * b}, launches {launches} "
        f"({launches // v['steps']} a step); 2 stages bitwise the monolithic; "
        f"peak_mem={peak / 2**30:.2f}GiB in {wall:.1f}s")
    del params, model, cache, sc, full
    gc.collect()
    torch.cuda.empty_cache()
    return {"max_abs_err": max(errs), "errs": errs, "agree": agree,
            "launches": launches, "peak_bytes": peak, "wall_s": wall}


def moe_train() -> dict:
    """The MoE loss under autograd (``MOE_TRAIN``): deepseek-moe-16b at
    full width, depth 2 (dense0 + 1 MoE), one batch of 2 x 512 random
    tokens through ``ModelDef.loss`` and ``backward``. Gates: loss,
    lb_loss (> 0) and dropped_frac (> 0: T = 1024 > 64, capacity
    int(1.25 * 6 * 1024 / 64) = 120 of 1024) finite; every parameter's
    gradient finite."""
    from repro_torch.configs import get_config
    from repro_torch.core.sync_engine import leaves
    from repro_torch.models.registry import get_model
    m = MOE_TRAIN
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(m["arch"]), n_layers=m["n_layers"])
    model = get_model(cfg, "cuda")
    params = model.init(m["seed"])
    for t in leaves(params):
        t.requires_grad_(True)
    gen = torch.Generator(device="cuda").manual_seed(m["seed"])
    shape = (m["batch"], m["seq_len"])
    batch = {"tokens": torch.randint(2, cfg.vocab, shape, generator=gen,
                                     device="cuda", dtype=torch.int32),
             "targets": torch.randint(2, cfg.vocab, shape, generator=gen,
                                      device="cuda", dtype=torch.int32),
             "mask": torch.ones(shape, device="cuda")}
    loss, metrics = model.loss(params, batch)
    loss.backward()
    torch.cuda.synchronize()
    vals = {k: float(metrics[k].detach()) for k in
            ("loss", "ce", "lb_loss", "dropped_frac")}
    bad = [k for k, x in vals.items() if not math.isfinite(x)]
    if bad or vals["lb_loss"] <= 0 or vals["dropped_frac"] <= 0:
        raise AssertionError(f"moe train: {vals}")
    grads = leaves(params)
    if any(t.grad is None or not torch.isfinite(t.grad).all() for t in grads):
        raise AssertionError("moe train: a gradient is missing or not finite")
    peak = torch.cuda.max_memory_allocated()
    wall = time.perf_counter() - t0
    log(f"moe train {cfg.name} depth {cfg.n_layers}: loss={vals['loss']:.4f} "
        f"ce={vals['ce']:.4f} lb_loss={vals['lb_loss']:.4f} dropped_frac="
        f"{vals['dropped_frac']:.4f} on {shape[0]}x{shape[1]} tokens; "
        f"{len(grads)} gradients finite; peak_mem={peak / 2**30:.2f}GiB in "
        f"{wall:.1f}s")
    del params, grads, loss, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return dict(vals, peak_bytes=peak, wall_s=wall)


def moe_vlm_phase() -> dict:
    """Phase 11: (a) kernels 5 and 6 at the MoE and VLM attention
    shapes, (b) deepseek-moe-16b served at full width and depth, (c) its
    swarm with a crash, (d) phi-3-vision-4.2b decode against teacher
    forcing and staged, (e) the MoE loss under autograd."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"kernels": moe_flash_decode(), "serve": moe_serve(),
           "swarm": moe_swarm(), "vlm": vlm_decode(), "train": moe_train()}
    out["wall_s"] = time.perf_counter() - t0
    log(f"moe/vlm phase: {out['wall_s']:.1f}s")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dist-slots", type=int, default=None,
                    help="run only phase 9 (after the build) with this "
                         "many DiLoCo slots, and print no result: how "
                         "its slot count was sized")
    ap.add_argument("--swarm-only", action="store_true",
                    help="run only phase 10, swarm serving (after the "
                         "build), and print no result")
    ap.add_argument("--moe-only", action="store_true",
                    help="run only phase 11, the MoE and VLM families "
                         "(after the build), and print no result")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    smi = environment()
    build()
    if args.dist_slots is not None:
        DIST["slots"] = args.dist_slots
        train_distributed()
        log(f"phase 9 alone at {args.dist_slots} slots passed in "
            f"{time.perf_counter() - t0:.1f}s")
        return
    if args.swarm_only:
        swarm_serve_phase()
        log(f"phase 10 alone passed in {time.perf_counter() - t0:.1f}s")
        return
    if args.moe_only:
        moe_vlm_phase()
        log(f"phase 11 alone passed in {time.perf_counter() - t0:.1f}s")
        return
    kernels = ([check_flash_decode()] + check_int8_codec()
               + [check_flash_decode_paged()])
    check_reduced_model()
    check_reduced_paged()
    check_reduced_trainer()
    runs = {}
    engines = ("continuous", "wave", "paged")
    for engine in engines:
        for run in (1, 2):          # run 1 also warms the card up
            runs[(engine, run)] = serve(engine, run)
    for run in (1, 2):
        if runs[("paged", run)]["outputs"] != runs[("paged", 1)]["outputs"]:
            raise AssertionError("paged main path: the two runs differ")
    extra = serve_paged_checks(runs[("paged", 2)]["outputs"])
    gc.collect()
    kernels[0]["launches"] = runs[("continuous", 2)]["launches"]
    kernels[5]["launches"] = runs[("paged", 2)]["launches"]
    keys = ("tokens_per_s", "latency_p50_s", "latency_p95_s",
            "decode_steps", "tokens_out", "wall_s")
    summary = {e: {k: runs[(e, 2)][k] for k in keys + ("launches",)}
               for e in engines}
    summary["continuous_batch_admit_false"] = {
        k: extra["continuous_b1"][k] for k in keys}
    summary["paged_fixed_kv"] = {k: extra["fixed_kv"][k] for k in keys + (
        "launches", "peak_streams", "prefix_hit_rate", "prefix_hits",
        "cow_forks", "paged_extends", "prefills", "blocks_peak",
        "pool_bytes")}
    log(f"serve: {json.dumps(summary)}")
    train = train_main_path()
    for entry in kernels[1:5]:
        entry["launches"] = train["launches"][entry["name"]]
    last = train["history"][-1]
    codec_ms = sum(e["ms"] * train["per_sync"][e["name"]]
                   for e in kernels[1:5])
    log(f"train: outer step {last['outer_step']}: inner phase "
        f"{last['inner_s'] * 1e3:.1f} ms, outer sync "
        f"{last['sync_s'] * 1e3:.1f} ms, codec kernels "
        f"{codec_ms:.2f} ms per sync by their timed ms "
        f"({codec_ms / (last['sync_s'] * 1e3):.1%} of the sync), peak "
        f"{train['peak_bytes'] / 2**30:.2f} GiB")
    replay_outer_sync(train["trainer"])
    del train
    gc.collect()
    elastic = train_elastic()
    replay_elastic(elastic)
    stepped_ring_bitwise(elastic)
    for entry in kernels[1:5]:
        entry["launches_elastic"] = elastic["launches"][entry["name"]]
    del elastic
    gc.collect()
    torch.cuda.empty_cache()
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        ckpt = train_checkpointed(workdir)
        check_ckpt_cross_device(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for entry in kernels[1:5]:
        if entry["name"] in ckpt["kernels"]:
            entry.update(ckpt["kernels"][entry["name"]])
    gc.collect()
    torch.cuda.empty_cache()
    dist = train_distributed()
    for entry in kernels[1:5]:
        entry["launches_dist"] = dist["launches"][entry["name"]]
    gc.collect()
    torch.cuda.empty_cache()
    swarm = swarm_serve_phase()
    for entry, layout in ((kernels[0], "dense"), (kernels[5], "paged")):
        entry["launches_swarm"] = {
            "healthy": swarm["runs"][(layout, False)]["launches"],
            "crash": swarm["runs"][(layout, True)]["launches"]}
        if layout == "dense":
            entry["launches_swarm"]["adopt"] = swarm["runs"]["adopt"][
                "launches"]
        entry["swarm_b1"] = swarm["b1"][entry["name"]]
    gc.collect()
    torch.cuda.empty_cache()
    moe = moe_vlm_phase()
    for entry, engine, layout in ((kernels[0], "continuous", "dense"),
                                  (kernels[5], "paged", "paged")):
        entry["moe_shapes"] = moe["kernels"][entry["name"]]
        entry["launches_moe"] = {
            "serve": moe["serve"][engine]["launches"],
            "swarm": moe["swarm"]["runs"][(layout, False)]["launches"]}
        if layout == "dense":
            entry["launches_moe"]["swarm_crash"] = \
                moe["swarm"]["runs"][("dense", True)]["launches"]
            entry["launches_moe"]["vlm"] = moe["vlm"]["launches"]
    log(f"total {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
