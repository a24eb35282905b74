"""Rank-side commands of ``test_torch_serve_step.py``: each runs in
every process of a ``RankMesh`` as ``fn(ctx, *args)``. This module
imports no JAX, so the rank processes stay light."""
import torch

from repro_torch.launch import shard_serve as ss
from repro_torch.train import step as ts


def serve(ctx, cfg, params, batch, n_decode, max_len):
    """``build_serve_step``'s prefill and ``n_decode`` greedy decode
    steps from ``params`` (the whole tree), every rank picking the next
    token from its (whole) logits. Returns every step's logits and
    tokens, the plan, and this rank's cache blocks (plain, on the
    host)."""
    torch.set_float32_matmul_precision("highest")
    build = ss.rank_build(ctx, cfg, next(iter(batch.values())).shape[0],
                          max_len, params=params)
    f = ctx.state[ss.KEY]
    logits, tokens = [], []
    inputs, kind = batch, "prefill"
    for _ in range(n_decode + 1):
        lg, f["cache"] = f[kind](f["params"], inputs, f["cache"])
        inputs, kind = ss.greedy(lg, cfg.vocab), "decode"
        logits.append(lg)
        tokens.append(inputs[:, 0].clone())
    cache = ss.rank_cache(ctx)
    ss.rank_drop(ctx)
    return {"logits": logits, "tokens": tokens, "cache": cache,
            "plan": build["plan"]}

