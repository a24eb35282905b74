"""SyncEngine: flatten / unflatten metadata of the DiLoCo outer sync
(port of ``repro.core.sync_engine``).

Parameters are nested dicts of tensors. The flat order is the JAX
package's: ``jax.tree.flatten`` visits a dict's keys in sorted order, so
``leaves`` does too. Any other order would cut the ring's chunks across
other parameters and give every codebook other values than the
reference's.

The engine holds no tensors, only static metadata (paths, shapes,
dtypes, offsets), computed once per structure and cached.
"""
from __future__ import annotations

from typing import Any

import torch

_ENGINES: dict[Any, "SyncEngine"] = {}


def leaves_with_paths(tree, prefix=()) -> list[tuple[tuple, torch.Tensor]]:
    """(key path, leaf) pairs of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(leaves_with_paths(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def leaves(tree) -> list[torch.Tensor]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of trees of the same
    structure in ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def from_paths(paths, values) -> dict:
    """Nested dict from (key path, value) pairs."""
    out: dict = {}
    for path, v in zip(paths, values):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


class SyncEngine:
    """Static flatten/unflatten metadata for one parameter structure."""

    def __init__(self, paths, shapes, dtypes):
        self.paths = tuple(paths)
        self.shapes = tuple(tuple(s) for s in shapes)
        self.dtypes = tuple(dtypes)
        self.sizes = tuple(int(torch.Size(s).numel()) for s in self.shapes)
        offsets = [0]
        for s in self.sizes:
            offsets.append(offsets[-1] + s)
        self.offsets = tuple(offsets)
        self.numel = offsets[-1]

    @classmethod
    def for_tree(cls, tree) -> "SyncEngine":
        """Engine for ``tree``'s structure (cached on paths, shapes and
        dtypes)."""
        pl = leaves_with_paths(tree)
        key = (tuple(p for p, _ in pl), tuple(tuple(l.shape) for _, l in pl),
               tuple(l.dtype for _, l in pl))
        eng = _ENGINES.get(key)
        if eng is None:
            eng = _ENGINES[key] = cls(*key)
        return eng

    def flatten(self, tree) -> torch.Tensor:
        """All leaves as one flat fp32 vector (a new tensor)."""
        ls = leaves(tree)
        return torch.cat([l.reshape(-1).float() for l in ls])

    def flatten_rows(self, stacked,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Stacked ``(k, ...)`` leaves -> (k, numel) in ``dtype`` (a new
        tensor), one flat row per worker (the JAX package's
        ``vmap(flatten)``)."""
        ls = leaves(stacked)
        k = ls[0].shape[0]
        return torch.cat([l.reshape(k, -1).to(dtype) for l in ls], dim=1)

    def unflatten(self, vec: torch.Tensor, like=None,
                  dtype: torch.dtype | None = None) -> dict:
        """Rebuild the tree from a flat vector. Leaf dtypes come from
        ``like``'s leaves, else ``dtype``, else the template's. A leaf
        whose dtype is the vector's is a view into ``vec``, not a copy."""
        if like is not None:
            dtypes = [l.dtype for l in leaves(like)]
        else:
            dtypes = [dtype] * len(self.paths) if dtype else self.dtypes
        vals = [vec[o:o + n].view(shape).to(dt) for o, n, shape, dt in
                zip(self.offsets, self.sizes, self.shapes, dtypes)]
        return from_paths(self.paths, vals)


# -- per-shard flat view ------------------------------------------------------


def shard_flat_size(shapes, specs, axis_sizes: dict) -> int:
    """Per-RANK flat length of the concat of local parameter shards: the
    sum over leaves of prod(shape) / prod(mesh axes named in the leaf's
    spec). ``shapes`` is a tree of tensors (``meta`` ones will do) or
    shape tuples, ``specs`` the matching tree of spec tuples
    (``sharding.partition``), ``axis_sizes`` mesh axis -> size. The
    sharded outer sync sizes the buffer it threads with it."""
    if isinstance(specs, dict):
        return sum(shard_flat_size(shapes[k], specs[k], axis_sizes)
                   for k in specs)
    shape = tuple(getattr(shapes, "shape", shapes))
    size = int(torch.Size(shape).numel())
    div = 1
    for entry in specs:
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            div *= int(axis_sizes.get(a, 1))
    if size % div:
        raise ValueError(f"spec {specs} does not divide leaf {shape}")
    return size // div
