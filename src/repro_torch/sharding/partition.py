"""Logical axes -> layouts over a mesh (port of
``repro.sharding.partition``).

A spec is a tuple with one entry per leading dimension of a tensor: the
mesh axis, or the tuple of axes (row-major), that the dimension is laid
over, or None, as a ``PartitionSpec``'s entries are; trailing Nones are
dropped. A rank's part of the tensor is the index its coordinates give
along those dimensions (``core.rank_mesh.axes_index``; ``local_block``).

Every parameter's logical axis tuple (``ModelDef.axes()``) is mapped
through the plan's rules with the reference's conflict resolution: a
mesh axis is used at most once per parameter (first logical axis wins)
and a dim is only sharded when the mesh axes divide it (no padded
shards on the memory-critical parameters).

``placements`` turns a spec into DTensor placements over a
``DeviceMesh`` (the FSDP train step's layout of each parameter).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

from repro_torch.sharding.plans import ParallelismPlan


def _entry_axes(entry) -> tuple:
    """The mesh axes a spec entry names (none for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def param_pspec(axes: tuple, shape: tuple, plan: ParallelismPlan,
                mesh_axes: dict[str, int]) -> tuple:
    rules = plan.rules_dict()
    used: set[str] = set()
    out = []
    for logical, dim in zip(axes, shape):
        rule = rules.get(logical)
        # rule: None | 'axis' | ('a','b') combined | ['pref1', 'pref2']
        prefs = rule if isinstance(rule, list) else [rule]
        chosen = None
        for cand in prefs:
            if cand is None:
                continue
            parts = (cand,) if isinstance(cand, str) else tuple(cand)
            if any(p in used or p not in mesh_axes for p in parts):
                continue
            if dim % math.prod(mesh_axes[p] for p in parts) == 0:
                chosen = cand if isinstance(cand, str) else parts
                used.update(parts)
                break
        out.append(chosen)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def tree_map_axes(fn, axes_tree, *rest):
    """``fn`` over the tuples (axis names, specs) of ``axes_tree`` and
    the matching leaves of the trees in ``rest`` (nested dicts)."""
    if not isinstance(axes_tree, dict):
        return fn(axes_tree, *rest)
    return {k: tree_map_axes(fn, axes_tree[k], *(r[k] for r in rest))
            for k in axes_tree}


def param_pspecs(axes_tree: Any, shapes_tree: Any, plan: ParallelismPlan,
                 mesh_axes: dict[str, int]) -> Any:
    """Spec tree of a parameter tree: ``shapes_tree``'s leaves are
    tensors (``meta`` ones will do) or shape tuples."""
    return tree_map_axes(
        lambda a, s: param_pspec(a, tuple(getattr(s, "shape", s)), plan,
                                 mesh_axes),
        axes_tree, shapes_tree)


def with_leading(spec_tree: Any, axis: str | None) -> Any:
    """Prepend the DiLoCo worker axis to every spec (stacked state)."""
    if axis is None:
        return spec_tree
    return tree_map_axes(lambda s: (axis,) + s, spec_tree)


def wan_ring_specs(wan_axis: str,
                   local_axes: tuple[str, ...] = ()) -> tuple[tuple, tuple]:
    """Specs of the distributed outer-sync ring's buffers.

    Returns ``(row_spec, acc_spec)``: per-worker flat rows —
    pseudo-gradients, thetas, weights — lie over the WAN (DiLoCo) axis
    only (``(wan_axis,)``); the in-flight ring accumulators add a
    dimension over the intra-node axes (``(wan_axis, local_axes)``), one
    slice per local rank in hierarchical mode, one replica per local rank
    otherwise (the paper's ElasticDeviceMesh split, see
    ``core.elastic_mesh.hierarchy``)."""
    row = (wan_axis,)
    if not local_axes:
        return row, row
    # one axis stands alone, as a ``PartitionSpec`` entry normalizes
    local = local_axes[0] if len(local_axes) == 1 else tuple(local_axes)
    return row, (wan_axis, local)


def batch_pspec(plan: ParallelismPlan, batch_size: int | None = None,
                mesh_axes: dict[str, int] | None = None) -> tuple:
    """Batch-leading activation/input layout (dim 0 over batch axes).
    When ``batch_size`` is given, axes are dropped (outermost first)
    until the product divides it."""
    ax = list(plan.batch_axes)
    if batch_size is not None and mesh_axes is not None:
        while ax:
            prod = math.prod(mesh_axes[a] for a in ax)
            if batch_size % prod == 0 and batch_size >= prod:
                break
            ax.pop()
    if not ax:
        return ()
    return (ax[0] if len(ax) == 1 else tuple(ax),)


def cache_pspec(shape: tuple, plan: ParallelismPlan,
                mesh_axes: dict[str, int], *, batch_dim: int,
                heads_dim: int | None, seq_dim: int | None) -> tuple:
    """KV/SSM cache layout: batch over data axes; heads over 'model'
    when divisible; else SP over the sequence dim for long contexts."""
    out: list = [None] * len(shape)
    bsz = shape[batch_dim]
    ax = plan.batch_axes
    if ax:
        n = math.prod(mesh_axes[a] for a in ax)
        if bsz % n == 0 and bsz >= n:
            out[batch_dim] = ax[0] if len(ax) == 1 else ax
    model = mesh_axes.get("model")
    if model:
        if heads_dim is not None and shape[heads_dim] % model == 0:
            out[heads_dim] = "model"
        elif (plan.seq_axis and seq_dim is not None
              and shape[seq_dim] % model == 0):
            out[seq_dim] = plan.seq_axis
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def cache_leaf_pspec(name: str, shape: tuple, plan: ParallelismPlan,
                     mesh_axes: dict[str, int]) -> tuple:
    """The layout of one cache leaf by its name (the last key of its
    path) and rank, the reference's ``ModelDef.cache_pspecs`` rule: KV
    caches (``k``/``v``, ``cross*``) shard batch and heads or, when the
    heads do not divide 'model', the sequence; SSM states (L, B, H, P,
    N) batch and heads; conv rings (L, B, K-1, C) batch and channels;
    lengths and scalars replicate; anything else shards its batch dim."""
    rank = len(shape)
    if rank == 0 or name in ("length", "src_len"):
        return ()
    if name in ("k", "v") or name.startswith("cross"):
        if rank == 5:                    # (L, B, S, Hk, dh)
            return cache_pspec(shape, plan, mesh_axes, batch_dim=1,
                               heads_dim=3, seq_dim=2)
        if rank == 4:                    # (B, S, Hk, dh) unstacked
            return cache_pspec(shape, plan, mesh_axes, batch_dim=0,
                               heads_dim=2, seq_dim=1)
    if name == "state" and rank == 5:    # (L, B, H, P, N)
        return cache_pspec(shape, plan, mesh_axes, batch_dim=1,
                           heads_dim=2, seq_dim=None)
    if name.startswith("conv") and rank == 4:    # (L, B, K-1, C)
        return cache_pspec(shape, plan, mesh_axes, batch_dim=1,
                           heads_dim=3, seq_dim=None)
    return cache_pspec(shape, plan, mesh_axes,
                       batch_dim=1 if rank >= 3 else 0, heads_dim=None,
                       seq_dim=None)


def cache_pspecs(tree: Any, plan: ParallelismPlan,
                 mesh_axes: dict[str, int], name: str = "") -> Any:
    """The spec tree of a cache tree (dicts, lists, dataclasses such as
    ``KVCache``, named tuples such as ``SSMState``; tensors, ``meta``
    ones included, or None): its structure, each tensor replaced by
    ``cache_leaf_pspec`` of its name (a dict key or a field name; a
    list element takes none)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: cache_pspecs(v, plan, mesh_axes, k)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [cache_pspecs(v, plan, mesh_axes) for v in tree]
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: cache_pspecs(getattr(tree, f.name), plan, mesh_axes,
                                 f.name)
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(cache_pspecs(v, plan, mesh_axes, f)
                            for f, v in zip(tree._fields, tree)))
    return cache_leaf_pspec(name, tuple(tree.shape), plan, mesh_axes)


# -- local layout -------------------------------------------------------------


def local_shape(shape, spec: tuple, mesh_axes: dict[str, int]) -> tuple:
    """A rank's block shape of a ``shape`` tensor laid out as ``spec``
    (each sharded dim divided by its axes' sizes; they must divide)."""
    out = list(shape)
    for d, entry in enumerate(spec):
        n = math.prod(mesh_axes[a] for a in _entry_axes(entry))
        if out[d] % n:
            raise ValueError(f"spec {spec} does not divide shape {shape}")
        out[d] //= n
    return tuple(out)


def local_block(x, spec: tuple, mesh_axes: dict[str, int],
                coords: dict[str, int]):
    """The block of ``x`` (laid out as ``spec``) at mesh ``coords``: a
    view, each sharded dim cut to the chunk the coordinates index
    (row-major over a combined entry's axes)."""
    for d, entry in enumerate(spec):
        names = _entry_axes(entry)
        if not names:
            continue
        n = math.prod(mesh_axes[a] for a in names)
        idx = 0
        for a in names:
            idx = idx * mesh_axes[a] + coords.get(a, 0)
        size = x.shape[d] // n
        x = x.narrow(d, idx * size, size)
    return x


def stacked_blocks(x, spec: tuple, mesh_axes: dict[str, int],
                   axes: tuple):
    """Every block of ``x`` (laid out as ``spec``) over the ranks of
    ``axes`` (each an axis ``spec`` lays a dim over), stacked in their
    row-major order (mesh order): (n, *block), row r the
    ``local_block`` of rank r, in one copy."""
    shape, pos, local = [], {}, []
    spec = tuple(spec) + (None,) * (x.dim() - len(spec))
    for d, entry in enumerate(spec):
        names = _entry_axes(entry)
        for a in names:
            pos[a] = len(shape)
            shape.append(mesh_axes[a])
        local.append(len(shape))
        shape.append(x.shape[d] // math.prod(mesh_axes[a] for a in names))
    order = [pos[a] for a in axes] + local
    block = tuple(shape[i] for i in local)
    return x.reshape(shape).permute(order).reshape((-1,) + block)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of a ``spec``-laid tensor over ``mesh`` (a
    ``DeviceMesh`` with named dims): ``Shard(d)`` on each mesh dim that
    tensor dim d is laid over, ``Replicate()`` elsewhere. A combined
    entry ``("data", "model")`` shards its dim over both mesh dims (row-
    major, as a ``PartitionSpec``'s combined entry), or over one
    flattened dim named ``"data_model"``."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if not axes:
            continue
        if "_".join(axes) in names and len(axes) > 1:
            out[names.index("_".join(axes))] = Shard(d)
            continue
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec}: mesh {names} has no dim "
                                 f"{a!r}")
            out[names.index(a)] = Shard(d)
    return tuple(out)
