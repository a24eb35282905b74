"""Weights and caches from the JAX package into the port.

``repro`` keeps parameters as nested dicts of arrays in the same layout
the port uses (stacked ``(L, ...)`` layers, ``x @ W`` orientation), so
conversion is a copy. The caller turns JAX arrays into numpy first
(``jax.tree.map(np.asarray, params)``); this module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.attention import KVCache, PagedKVCache


def to_tensor(a, device="cuda", dtype: torch.dtype | None = None
              ) -> torch.Tensor:
    """numpy array -> tensor on ``device``. bfloat16 arrays (ml_dtypes)
    are carried bit for bit; ``dtype`` casts floating tensors."""
    a = np.array(a)                   # a writable copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def from_jax_params(tree, device="cuda", dtype: torch.dtype | None = None):
    """``repro`` parameter tree (nested dicts of numpy arrays) -> the
    port's parameter dict on ``device``."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device, dtype) for k, v in tree.items()}
    return to_tensor(tree, device, dtype)


def from_jax_cache(cache, device="cuda") -> dict:
    """``repro`` cache ``{"scan": KVCache, "prefix": [KVCache, ...]}``
    with numpy leaves (anything with ``k``, ``v`` and ``length``, plus
    ``table`` for a ``PagedKVCache``) -> the port's cache on
    ``device``, the dense prefix layers' caches included. A stacked
    paged leaf's (L, B, nb) table, which the JAX package broadcasts over
    layers, becomes the port's one (B, nb) table, which every leaf then
    shares; the layers' and leaves' tables must agree."""
    shared = []

    def one(c):
        k, v = to_tensor(c.k, device), to_tensor(c.v, device)
        length = to_tensor(c.length, device)
        if not hasattr(c, "table"):
            return KVCache(k, v, length)
        table = to_tensor(c.table, device)
        if table.dim() == 3:
            if not bool((table == table[:1]).all()):
                raise ValueError("paged cache: per-layer block tables "
                                 "differ; the port shares one table")
            table = table[0].contiguous()
        if shared:
            if not torch.equal(table, shared[0]):
                raise ValueError("paged cache: the KV leaves' block tables "
                                 "differ; the port shares one table")
            table = shared[0]
        shared.append(table)
        return PagedKVCache(k, v, table, length)
    return {"scan": one(cache["scan"]),
            "prefix": [one(c) for c in cache["prefix"]]}
