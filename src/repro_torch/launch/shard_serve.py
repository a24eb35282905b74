"""Sharded serving on a mesh of rank processes (the rank driver of
``train/step.py``'s ``build_serve_step``).

A ("data", "model") ``RankMesh``: every rank builds the model (from
``SEED``, one rank after another so that one whole copy is on the device
at a time, or cut from a given parameter tree), keeps its block of every
parameter as ``make_plan`` lays it out for serving and its block of the
cache (``local_cache``: KV heads over 'model' where they divide it, else
the sequence), and runs the serve step: one prefill, then greedy decode
steps. The controller picks each next token from rank 0's logits (every
rank holds them whole) and sends it to all ranks.

Groups along 'model' are gloo: NCCL takes one card a rank, and the
ranks of this driver share one card on the H100 machine. Ranks of one
card move a gather's payload through device buffers they share by CUDA
IPC, gloo only ordering it (``rank_mesh.CardMailboxes``): through host
copies, gloo over loopback is far too slow for the 10.2 GB a rank that
a decode step of INTELLECT-1 gathers (``rank_gather_probe`` times both;
PERF.md). Every kernel runs on the card. ``run`` returns the plan, the
bytes each rank holds and one record per step: the tokens, rank 0's
logits, each rank's kernel-5 launches (the kernel and its block
variant), seconds, share in the 'model' collectives and peak of
allocated bytes.
"""
from __future__ import annotations

import time

import torch

KEY = "shard_serve"
# the seed of the ranks' random weights
SEED = 0
# all-gathers ``rank_gather_probe`` times, after one that warms up
PROBE_CALLS = 3


def _launches() -> dict:
    from repro_torch.kernels import flash_decode as fd
    return {"flash_decode": fd.flash_decode.launches,
            "flash_decode_partial": fd.flash_decode_partial.launches}


def serve_shape(kind: str, max_len: int, batch_size: int):
    from repro_torch.configs.base import ShapeConfig
    return ShapeConfig("serve", kind, max_len, batch_size)


def _sync(ctx) -> None:
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)


# -- rank side ----------------------------------------------------------------


def rank_build(ctx, cfg, batch_size: int, max_len: int,
               params=None) -> dict:
    """Build this rank's model, plan, serve steps, parameter blocks and
    cache (kept in ``ctx.state``). The parameters are ``params`` (the
    whole tree, shared by the caller) or ``model.init(SEED)``, drawn by
    one rank at a time. Returns the plan, the bytes this rank holds and
    its peak of allocated bytes while building (the card)."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.launch.dryrun import tree_nbytes
    from repro_torch.models.registry import get_model
    from repro_torch.sharding.plans import make_plan
    from repro_torch.train import step as ts
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    mesh = ctx.device_mesh(None, "gloo")
    amap = ts.mesh_axes(mesh)
    model = get_model(cfg, ctx.device)
    shape = serve_shape("decode", max_len, batch_size)
    plan = make_plan(cfg, shape, amap)
    if params is not None:
        local = _to(ts.local_params(model, plan, mesh, params), ctx.device)
    else:
        local = None
        for r in range(dist.get_world_size()):
            if r == ctx.rank:
                whole = model.init(SEED)
                local = ts.local_params(model, plan, mesh, whole)
                del whole
                if ctx.device.type == "cuda":
                    torch.cuda.empty_cache()
            dist.barrier()
    cache = ts.local_cache(model, plan, mesh, batch_size, shape)
    prefill, _ = ts.build_serve_step(model, plan, mesh, "prefill")
    decode, _ = ts.build_serve_step(model, plan, mesh, "decode")
    ctx.state[KEY] = {"params": local, "cache": cache, "prefill": prefill,
                      "decode": decode}
    return {"plan": dataclasses.asdict(plan),
            "param_bytes": tree_nbytes(local),
            "cache_bytes": tree_nbytes(cache),
            "peak_bytes": (torch.cuda.max_memory_allocated(ctx.device)
                           if ctx.device.type == "cuda" else 0)}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def rank_step(ctx, kind: str, inputs) -> dict:
    """One prefill (``inputs``: the whole batch) or decode step
    (``inputs``: the (B, 1) tokens). Returns rank 0's logits (on the
    host), this rank's kernel-5 launches in the step, its seconds, its
    seconds in collectives and its peak of allocated bytes."""
    from repro_torch.core import rank_mesh
    f = ctx.state[KEY]
    if isinstance(inputs, dict):
        inputs = {k: v.to(ctx.device) for k, v in inputs.items()}
    else:
        inputs = inputs.to(ctx.device)
    before = _launches()
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    _sync(ctx)
    t0 = time.perf_counter()
    with rank_mesh.timed_collectives() as clock:
        logits, f["cache"] = f[kind](f["params"], inputs, f["cache"])
    _sync(ctx)
    sec = time.perf_counter() - t0
    after = _launches()
    return {"logits": logits.float().cpu() if ctx.rank == 0 else None,
            "launches": {k: after[k] - before[k] for k in after},
            "seconds": sec, "collective_s": clock["collective_s"],
            "peak_bytes": (torch.cuda.max_memory_allocated(ctx.device)
                           if ctx.device.type == "cuda" else 0)}


def rank_gather_probe(ctx, mbytes: int) -> dict:
    """Seconds of one all-gather of ``mbytes`` MB a rank over this rank's
    'model' group (gloo), the fastest of ``PROBE_CALLS``: through the
    card mailboxes (CUDA IPC, when the group's ranks share the card) and
    through host copies."""
    from repro_torch.core import rank_mesh
    from repro_torch.train import step as ts
    mesh = ctx.device_mesh(None, "gloo")
    group = ts._group(mesh, ("model",))
    t = torch.ones(mbytes << 19, dtype=torch.bfloat16, device=ctx.device)
    out = {}
    for name, fn in (("card", rank_mesh.all_gather_list),
                     ("host", rank_mesh.host_all_gather)):
        if (name == "card"
                and not rank_mesh.use_card_mailboxes(group, ctx.device)):
            continue
        best = None
        for _ in range(PROBE_CALLS + 1):    # the first warms up
            _sync(ctx)
            t0 = time.perf_counter()
            fn(t, group)
            _sync(ctx)
            best = (time.perf_counter() - t0 if best is None
                    else min(best, time.perf_counter() - t0))
        out[name] = best
    return out


def rank_launches(ctx, reset: bool = False) -> dict:
    """This rank's kernel-5 launches so far (the kernel and its block
    variant); ``reset`` sets them to 0 first."""
    from repro_torch.kernels import flash_decode as fd
    if reset:
        fd.flash_decode.launches = 0
        fd.flash_decode_partial.launches = 0
    return _launches()


def rank_cache(ctx) -> object:
    """This rank's cache blocks on the host, every KV leaf a plain
    ``KVCache`` (an enc-dec's ``cross_layout`` left out)."""
    from repro_torch.models.attention import KVCache, KVLayout

    def host(t):
        if isinstance(t, dict):
            return {k: host(v) for k, v in t.items()
                    if not isinstance(v, KVLayout)}
        if isinstance(t, list):
            return [host(v) for v in t]
        if isinstance(t, KVCache):
            return KVCache(host(t.k), host(t.v), host(t.length))
        if isinstance(t, tuple):
            return type(t)(*(host(v) for v in t))
        return t.cpu() if isinstance(t, torch.Tensor) else t
    return host(ctx.state[KEY]["cache"])


def rank_drop(ctx) -> None:
    """Free this rank's model, cache and card mailboxes (collective)."""
    from repro_torch.core import rank_mesh
    ctx.state.pop(KEY, None)
    rank_mesh.release_card_mailboxes()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


# -- controller side ----------------------------------------------------------


def greedy(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """(B, V) logits -> (B, 1) int32 argmax over the real vocabulary."""
    return logits[:, :vocab].argmax(dim=-1).to(torch.int32)[:, None]


def run(mesh, cfg, batch: dict, n_decode: int, *, max_len: int) -> dict:
    """Prefill ``batch`` (the whole one, on the host) and ``n_decode``
    greedy steps on ``mesh``'s ranks, the weights drawn from ``SEED``.
    Returns {"build": each rank's build record, "steps": [{"tokens",
    "logits", "launches" (per rank), "seconds", "collective_s",
    "peak_bytes" (per rank)}, ...]}; the ranks' state is dropped."""
    lead = next(iter(batch.values()))
    build = mesh.call(rank_build, cfg, lead.shape[0], max_len)
    steps = []
    token = None
    for i in range(n_decode + 1):
        res = mesh.call(rank_step, "prefill" if i == 0 else "decode",
                        batch if i == 0 else token)
        logits = res[0]["logits"]
        token = greedy(logits, cfg.vocab)
        steps.append({"tokens": token[:, 0].clone(), "logits": logits,
                      **{k: [r[k] for r in res] for k in
                         ("launches", "seconds", "collective_s",
                          "peak_bytes")}})
    mesh.call(rank_drop)
    return {"build": build, "steps": steps}
