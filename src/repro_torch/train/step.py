"""Train and sync steps (port of ``repro.train.step``): the distributed
outer sync's per-hop ring (``DistSyncPrograms``, ``DistRingSyncOp``,
``DistSyncBackend``) and the hybrid DiLoCo-FSDP train step and its
sharded outer sync (``build_train_step``, ``build_outer_sync``, below).

The reference runs each wire hop of the int8 ring as a jitted
``shard_map`` program over a mesh of devices, one ring position per
device, the payload moved by a static ``ppermute``. Here the mesh is a
``core.rank_mesh.RankMesh`` of rank processes under the trainer's
process (the controller), and a hop is one command to every rank:

  * each rank runs the simulator's hop body (``ring_reduce._rs_hop_rows``
    / ``_ag_init_rows`` / ``_ag_hop_rows``) at its ONE ring position,
    with the codec on its own device (kernels 1-4 on the card, one row a
    launch), and ``shift`` is a point-to-point exchange with its ring
    neighbours over the WAN group (gloo, as PRIME's global group: the
    codes and codebooks cross it through host buffers, pinned on the
    card);
  * the payload never passes through the controller. The accumulators
    are the controller's buffers (laid out as
    ``sharding.partition.wan_ring_specs``'s accumulator spec says: slot
    by local rank), which each rank updates in
    place through ``torch.multiprocessing``'s sharing (CUDA IPC on the
    card), so ``finish`` reads the reduced rows where they lie;
  * the codec's per-row results do not depend on how many rows a call
    holds (``kernels/ref.row_std_mean``), so the distributed ring equals
    the simulator hop for hop, bit for bit.

Hierarchical mode (``core.elastic_mesh.HierarchySpec``, the paper's
ElasticDeviceMesh split): each rank rings only its 1/n_local slice over
the WAN axis and the full vector is rebuilt with an all-gather over the
local group (backend: the mesh's ``local_backend``). Codebooks become
per-slice, so results equal the PER-SLICE simulator.

A changed ring order or geometry re-forms the ranks' peer map
(``DistSyncBackend.recompiles`` counts the builds, the first included).

The serve step (``build_serve_step``, below) runs a rank's rows with
each layer's weights gathered and its block of the cache: kernel 5 at
the rank's KV heads, or the kernel's block variant on the rank's cells
merged over 'model', and a prefill split by sequence when the KV heads
do not divide that axis.
"""
from __future__ import annotations

import dataclasses
import math
import time
import weakref

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import diloco as dl
from repro_torch.core import elastic_mesh, rank_mesh
from repro_torch.core import ring_reduce as rr
from repro_torch.core.sync_engine import (SyncEngine, from_paths, leaves,
                                          leaves_with_paths,
                                          shard_flat_size, tree_map)
from repro_torch.kernels import int8_quant as iq
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.optim.nesterov import NesterovState
from repro_torch.sharding import partition

_HOP_TIMES = ("hop_s", "codec_s", "d2h_s", "wire_s", "h2d_s")


# -- rank side: run inside each rank process ---------------------------------


@dataclasses.dataclass
class _RankPrograms:
    """One rank's view of a ring geometry: its position and peers."""

    k: int
    bsize: int
    nb: int
    cfg: rr.RingConfig
    positions: torch.Tensor       # (1,): this rank's ring position
    wan: object                   # the WAN ProcessGroup
    next: int                     # global rank of position + 1
    prev: int                     # global rank of position - 1
    index: tuple                  # (slot, local index) in the acc buffer
    local_key: tuple | None       # hierarchical: the local group's key
    slice_len: int


@dataclasses.dataclass
class _RankOp:
    """One reduction in flight, as a rank holds it."""

    prog: _RankPrograms
    acc: torch.Tensor             # (1, padded) view of the controller's
    fused: tuple | None           # (a_flat, theta row, weight row)
    payloads: tuple | None = None
    calls: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(rr.CODEC, 0))
    launches: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(rr.CODEC, 0))
    hops: list = dataclasses.field(default_factory=list)


def _codec_counts() -> dict:
    return {n: (iq.calls[n], getattr(iq, n).launches) for n in rr.CODEC}


def _rank_programs(ctx, pid: int, dax: str, order: tuple, geo: tuple,
                   wan_key: tuple, local_key, slice_len: int) -> None:
    """Form this rank's peer map for ring ``order`` over axis ``dax``."""
    k = len(order)
    group, ranks = ctx.groups[wan_key]
    local = [a for a in ctx.shape if a != dax]
    pos = int(np.argsort(order)[ctx.coords[dax]])
    ctx.state.setdefault("programs", {})[pid] = _RankPrograms(
        k, geo[0], geo[1], geo[2],
        torch.tensor([pos], device=ctx.device), group,
        ranks[order[(pos + 1) % k]], ranks[order[(pos - 1) % k]],
        (ctx.coords[dax], rank_mesh.axes_index(ctx.shape, local,
                                               ctx.coords)),
        local_key, slice_len)


def _rank_prep(ctx, pid: int, op_id: int, accs: torch.Tensor, fused,
               dead: list) -> None:
    """Take this rank's accumulator (and fused first-hop operands) of a
    new reduction; forget the reductions the controller dropped."""
    ops = ctx.state.setdefault("ops", {})
    for i in dead:
        ops.pop(i, None)
    if accs.device.type != ctx.device.type:
        raise ValueError(f"rank on {ctx.device} was given buffers on "
                         f"{accs.device}")
    prog = ctx.state["programs"][pid]
    slot, local = prog.index
    if fused is not None:
        a_flat, thetas, w = fused
        fused = (a_flat, thetas[slot:slot + 1], w[slot:slot + 1])
    ops[op_id] = _RankOp(prog, accs[slot, local:local + 1], fused)


def _exchange(ctx, prog: _RankPrograms, payload: tuple, times: dict):
    """The ring's shift at one position: send ``payload`` (a tuple of
    tensors) to the next position and receive the previous position's,
    of the same shapes and dtypes, through host buffers over the WAN
    group (``ring_reduce.staged_shift``, which adds its seconds to
    ``times``)."""
    ctx.sync()
    return rr.staged_shift(payload, prog.wan, prog.next, prog.prev,
                           ctx.timeout, times)


def _rank_hop(ctx, op_id: int, i: int) -> None:
    """Wire hop ``i`` of reduction ``op_id`` at this rank's position."""
    op = ctx.state["ops"][op_id]
    prog = op.prog
    times = dict.fromkeys(_HOP_TIMES, 0.0)
    before = _codec_counts()
    t0 = time.perf_counter()
    geo = (prog.k, prog.bsize, prog.nb, prog.cfg)

    def shift(payload):
        return _exchange(ctx, prog, payload, times)
    if i < prog.k - 1:
        rr._rs_hop_rows(i, op.acc, *geo, op.fused if i == 0 else None,
                        positions=prog.positions, shift=shift)
        op.fused = None
    else:
        s = i - (prog.k - 1)
        if s == 0:
            op.acc, op.payloads = rr._ag_init_rows(
                op.acc, *geo, positions=prog.positions)
        op.acc, op.payloads = rr._ag_hop_rows(
            s, op.acc, op.payloads, *geo, positions=prog.positions,
            shift=shift)
    ctx.sync()
    times["hop_s"] = time.perf_counter() - t0
    times["codec_s"] = times["hop_s"] - (times["d2h_s"] + times["wire_s"]
                                         + times["h2d_s"])
    for n, (c, l) in _codec_counts().items():
        op.calls[n] += c - before[n][0]
        op.launches[n] += l - before[n][1]
    op.hops.append(times)


def local_all_gather(ctx, key: tuple, row: torch.Tensor) -> torch.Tensor:
    """Concatenate ``row`` over this rank's group ``key`` (fiber order;
    ``rank_mesh.all_gather_list``)."""
    return torch.cat(rank_mesh.all_gather_list(row, ctx.groups[key][0]))


def _tally(op: _RankOp) -> dict:
    return {"calls": op.calls, "launches": op.launches, "hops": op.hops}


def _rank_finish(ctx, op_id: int, out) -> dict:
    """End reduction ``op_id``: in hierarchical mode gather the full row
    over the local group into ``out`` (written by local rank 0). Returns
    this rank's codec counts and hop times."""
    op = ctx.state["ops"].pop(op_id)
    prog = op.prog
    if prog.local_key is not None:
        row = local_all_gather(ctx, prog.local_key,
                               op.acc[0, :prog.slice_len])
        slot, local = prog.index
        if local == 0:
            out[slot].copy_(row)
    ctx.sync()
    return _tally(op)


def _rank_drop(ctx, op_id: int):
    """Forget a torn reduction once its dispatched hops are done; its
    counts, or None if this rank never held it."""
    op = ctx.state.get("ops", {}).pop(op_id, None)
    ctx.sync()
    return None if op is None else _tally(op)


def rank_codec_counts(ctx, reset: bool = False) -> dict:
    """This rank's codec calls and kernel launches so far; ``reset``
    sets them to 0 first."""
    if reset:
        for n in rr.CODEC:
            iq.calls[n] = 0
            getattr(iq, n).launches = 0
    counts = _codec_counts()
    return {key: {n: counts[n][i] for n in rr.CODEC}
            for i, key in enumerate(("calls", "launches"))}


# -- controller side ----------------------------------------------------------


def _sum_tallies(tallies) -> dict:
    """Codec counts summed over ranks, hop times maxed over ranks."""
    tallies = [t for t in tallies if t is not None]
    out = {key: {n: sum(t[key][n] for t in tallies) for n in rr.CODEC}
           for key in ("calls", "launches")}
    n_hops = max((len(t["hops"]) for t in tallies), default=0)
    out["hop_times"] = [{f: max(t["hops"][h][f] for t in tallies
                                if h < len(t["hops"])) for f in _HOP_TIMES}
                        for h in range(n_hops)]
    return out


class DistSyncPrograms:
    """A ring geometry formed on the ranks of ``mesh``: the order, the
    chunk and bucket sizes, each rank's position and peers (one build;
    the reference compiles one ``shard_map`` program per hop kind).
    ``log`` receives one record per reduction that ran: its hops, the
    codec calls and launches summed over ranks, the hop times."""

    def __init__(self, mesh, dax: str, size: int, cfg: rr.RingConfig,
                 ring_order=None, hierarchy=None, log: list | None = None):
        self.mesh, self.dax, self.cfg = mesh, dax, cfg
        self.k = k = int(mesh.shape[dax])
        self.size = size
        order = (tuple(ring_order) if ring_order is not None
                 else tuple(range(k)))
        if sorted(order) != list(range(k)):
            raise ValueError("ring order must be a permutation of the "
                             "DiLoCo slots")
        if k <= 1:
            raise ValueError("use RingSyncOp for the degenerate "
                             "1-worker ring")
        self.ring_order = order
        self.hier = hierarchy if (hierarchy is not None
                                  and hierarchy.split) else None
        local_axes = tuple(a for a in mesh.axis_names if a != dax)
        # ranks per DiLoCo slot: each rings its own accumulator (a slice
        # in hierarchical mode, a replica of the whole row otherwise)
        self.n_rep = math.prod(mesh.shape[a] for a in local_axes)
        self.n_local = nl = self.hier.n_local if self.hier else 1
        self.slice_len = sl = -(-size // nl)
        nb = max(1, cfg.buckets)
        bsize = -(-(-(-sl // k)) // nb)
        self.chunk, self.bsize, self.nb = bsize * nb, bsize, nb
        self.padded = k * self.chunk
        wan = mesh.group((dax,), "gloo")
        local = (mesh.group(local_axes, mesh.local_backend) if self.hier
                 else None)
        self.log = [] if log is None else log
        self.id = mesh.new_id()
        self._ops: dict[int, weakref.ref] = {}
        mesh.call(_rank_programs, self.id, dax, order, (bsize, nb, cfg),
                  wan, local, sl)

    def prep(self, op: "DistRingSyncOp") -> torch.Tensor:
        """Stage ``op`` on the ranks: its weighted, ring-padded
        accumulators ((k, n_rep, padded) fp32 on the controller's device,
        rank (d, l) owning [d, l]) and, with the fused first hop, the
        padded (anchor, thetas, weights). Returns the accumulators."""
        if op.xs.device.type != self.mesh.device.type:
            raise ValueError(f"rows on {op.xs.device}, ranks on "
                             f"{self.mesh.device}")
        k, sl, size = self.k, self.slice_len, self.size
        accs = op.xs.new_zeros((k, self.n_rep, self.padded))
        w = op.weights[:, None]
        for l in range(self.n_rep):
            if self.hier:
                lo, hi = min(l * sl, size), min((l + 1) * sl, size)
                torch.mul(op.xs[:, lo:hi], w, out=accs[:, l, :hi - lo])
            elif l == 0:
                torch.mul(op.xs, w, out=accs[:, 0, :size])
            else:
                accs[:, l].copy_(accs[:, 0])
        fused = None
        if op._fused0:
            a_flat, thetas = op.fused_src
            pad = self.padded - size
            a_flat = a_flat.float()
            if pad:
                a_flat, thetas = F.pad(a_flat, (0, pad)), F.pad(thetas,
                                                                (0, pad))
            fused = (a_flat, thetas, op.weights)
        if accs.is_cuda:
            torch.cuda.synchronize(accs.device)   # the ranks read it next
        op_id = self.mesh.new_id()
        dead = [i for i, ref in self._ops.items() if ref() is None]
        for i in dead:
            del self._ops[i]
        self._ops[op_id] = weakref.ref(op)
        self.mesh.submit(_rank_prep, self.id, op_id, accs, fused, dead)
        op._id = op_id
        return accs

    def finalize(self, op: "DistRingSyncOp") -> torch.Tensor:
        """Wait for the ranks, record the reduction, and return the (k,
        size) reduced rows (identical; worker-major) on the controller's
        device, divided by the total weight as ``RingSyncOp.finish``
        does, so the values equal the simulator's bit for bit."""
        out = None
        if self.hier:
            out = op._accs.new_empty((self.k, self.n_local
                                      * self.slice_len))
        self.record(op, self.mesh.call(_rank_finish, op._id, out))
        self._ops.pop(op._id, None)
        res = (out if self.hier else op._accs[:, 0])[:, :self.size]
        if self.cfg.average:
            res.div_(op._total_w.clamp_min(1e-20))
        return res

    def drop(self, op: "DistRingSyncOp") -> None:
        """Forget a torn reduction on the ranks (after its dispatched
        hops) and record what they did."""
        self.record(op, self.mesh.call(_rank_drop, op._id))
        self._ops.pop(op._id, None)

    def record(self, op: "DistRingSyncOp", tallies) -> None:
        self.log.append({"hops": op.hops_done, "fused": op._fused0,
                         "ranks": self.mesh.size, **_sum_tallies(tallies)})


class DistRingSyncOp:
    """Distributed mirror of :class:`ring_reduce.RingSyncOp` with the same
    public surface (``step``/``finish``/``restart``/``pending``/
    ``hops_total``/``hops_done``/``norm_sideband``, retained ``xs`` and
    ``fused_src``), so ``diloco.OuterSyncHandle``, ``finish_outer_sync_sim``
    and ``resync_outer_sim`` operate on it unchanged. Each ``step()``
    sends ONE wire hop to the ranks and returns without waiting for it,
    so the transfer runs under the next inner-phase chunk. The ranks are
    staged at the first hop (as the simulator builds its accumulator
    there). Like the simulator op it RETAINS its inputs: ``restart``
    re-reduces them over the survivors through the same ranks."""

    def __init__(self, programs: DistSyncPrograms, xs: torch.Tensor,
                 weights: torch.Tensor | None = None, fused_src=None):
        pr = programs
        k, orig = xs.shape
        if (k, orig) != (pr.k, pr.size):
            raise ValueError(f"geometry mismatch: op ({k}, {orig}) vs "
                             f"programs ({pr.k}, {pr.size})")
        self.programs = pr
        self.cfg = pr.cfg
        self.k, self.orig_size = k, orig
        self.ring_order = pr.ring_order
        self.xs = xs.float()
        self.weights = (torch.ones((k,), dtype=torch.float32,
                                   device=xs.device) if weights is None
                        else weights.float())
        self.fused_src = fused_src
        self.hops_done = 0
        self.hops_total = 2 * (k - 1)
        self._total_w = self.weights.sum()
        self._fused0 = (fused_src is not None and self.cfg.fused
                        and self.cfg.quant == "int8" and pr.hier is None)
        self._id = self._accs = self._out = None
        self._closed = False

    @property
    def pending(self) -> bool:
        return self.hops_done < self.hops_total

    def step(self) -> bool:
        """Send ONE wire hop to the ranks (without waiting for it); True
        iff a hop was sent."""
        if self._closed or self._out is not None or not self.pending:
            return False
        if self._id is None:
            self._accs = self.programs.prep(self)
        self.programs.mesh.submit(_rank_hop, self._id, self.hops_done)
        self.hops_done += 1
        return True

    def finish(self) -> torch.Tensor:
        """Send the remaining hops, wait for the ranks and return the
        (k, D) reduced result (identical rows across workers)."""
        if self._out is None:
            if self._closed:
                raise RuntimeError("finish on a closed reduction")
            while self.step():
                pass
            self._out = self.programs.finalize(self)
            self._accs = None
        return self._out

    def close(self) -> None:
        """Drop a reduction that will not finish on the ranks, once its
        dispatched hops are done (recorded with the hops it ran)."""
        if self._id is not None and self._out is None and not self._closed:
            self.programs.drop(self)
        self._closed = True
        self._accs = None

    def restart(self, weights: torch.Tensor) -> torch.Tensor:
        """Torn-reduction fallback: re-reduce the RETAINED inputs under
        ``weights`` through the same ranks; the partial accumulators are
        dropped."""
        self.close()
        return DistRingSyncOp(self.programs, self.xs, weights=weights,
                              fused_src=self.fused_src).finish()

    def norm_sideband(self) -> np.ndarray:
        """(k, k * buckets) per-chunk norm sideband of the retained rows,
        the same ``ring_reduce.chunk_norms`` the simulator op uses."""
        return rr.chunk_norms(self.xs, self.cfg.buckets)


class DistSyncBackend:
    """Plugs the distributed ring into ``ElasticTrainer`` (pass
    ``sync_backend=DistSyncBackend(mesh, dax)``).

    ``begin`` mirrors ``diloco.begin_outer_sync_sim``, through the same
    pseudo-gradient front half (``_sim_pseudograds``, the two-slot error
    feedback included), but stages the ring as a :class:`DistRingSyncOp`
    over the mesh's DiLoCo axis, so ``overlap='delayed'`` gives the
    simulator's results bit for bit. The ranks' peer map is re-formed
    whenever the ring order or geometry changes; ``recompiles`` counts
    the builds, the first included. ``reductions`` holds one record per
    reduction that ran (``DistSyncPrograms.log``)."""

    def __init__(self, mesh, dax: str, hierarchical: bool | None = None):
        self.mesh, self.dax = mesh, dax
        self._split = elastic_mesh.hierarchy(mesh, dax)
        # None -> follow DiLoCoConfig.hierarchical per begin() call
        self.hierarchical = hierarchical
        self.recompiles = 0
        self.reductions: list[dict] = []
        self._programs: DistSyncPrograms | None = None
        self._key = None

    def _want_hier(self, cfg) -> bool:
        use = (cfg.hierarchical if self.hierarchical is None
               else self.hierarchical)
        return bool(use) and self._split.split

    def begin(self, stacked_params, state, cfg, ring_order=None,
              weights=None, ef_slot: int = 0) -> dl.OuterSyncHandle:
        """Distributed analogue of ``diloco.begin_outer_sync_sim``."""
        k, _, a_flat, pgs, new_residuals, fused_src = \
            dl._sim_pseudograds(stacked_params, state, cfg,
                                ef_slot=ef_slot)
        if k != int(self.mesh.shape[self.dax]):
            raise ValueError(f"trainer has {k} DiLoCo slots but mesh axis "
                             f"{self.dax!r} has {self.mesh.shape[self.dax]}")
        if weights is None:
            weights = torch.ones((k,), dtype=torch.float32,
                                 device=pgs.device)
        if k == 1:
            op = rr.RingSyncOp(pgs, ring_order=ring_order, cfg=cfg.ring,
                               weights=weights, fused_src=fused_src)
            return dl.OuterSyncHandle(op, cfg, a_flat, new_residuals,
                                      weights, k, ef_slot=ef_slot)
        hier = self._want_hier(cfg)
        if hier:
            # per-slice codebooks make the fused whole-vector transmit
            # inapplicable; the materialized slice is quantized instead
            fused_src = None
        order = (tuple(ring_order) if ring_order is not None
                 else tuple(range(k)))
        key = (k, pgs.shape[-1], cfg.ring, order, hier)
        if key != self._key:
            self._programs = DistSyncPrograms(
                self.mesh, self.dax, pgs.shape[-1], cfg.ring,
                ring_order=order,
                hierarchy=self._split if hier else None,
                log=self.reductions)
            self._key = key
            self.recompiles += 1
        op = DistRingSyncOp(self._programs, pgs, weights=weights,
                            fused_src=fused_src)
        return dl.OuterSyncHandle(op, cfg, a_flat, new_residuals,
                                  weights, k, ef_slot=ef_slot)


# -- the hybrid DiLoCo-FSDP train step and its sharded outer sync -------------
#
# The reference runs the inner step as one pjit program over (data,
# model) and the outer sync inside a shard_map region manual over the
# DiLoCo axis (paper §2.3: FSDP inside, DiLoCo outside). Here both are
# ONE body per rank over a ``DeviceMesh`` (``launch.mesh``): in a mesh of
# rank processes (``RankContext.device_mesh``) it trains; in the fake
# world of the dry run (``make_production_mesh``) it is traced on fake
# tensors. A rank holds its local block of every state tensor, as the
# state specs lay it out; a stacked (DiLoCo) state keeps a leading
# worker dim of local size 1.
#
# FSDP is done on DTensors, not ``fully_shard`` (the models are
# functional trees, not modules; torchtitan's "SimpleFSDP" design):
# before a layer uses its weights, the loss's ``fetch`` gathers them over
# the worker's mesh dims (``_Gather``: all-gather forward, reduce-scatter
# of the summed gradient backward; with remat the gather is redone in
# backward).


def mesh_axes(mesh) -> dict[str, int]:
    """Axis name -> size of a ``DeviceMesh``, a ``RankMesh`` or a dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def param_specs(model, plan, mesh):
    """Spec tree of the model's parameters under ``plan``."""
    return partition.param_pspecs(model.axes(), model.param_shapes(), plan,
                                  mesh_axes(mesh))


def _sharded(specs) -> bool:
    return any(any(e is not None for e in s) for s in _spec_leaves(specs))


def _spec_leaves(specs) -> list:
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in _spec_leaves(specs[k])]
    return [specs]


def _shard_flat_dims(shapes, pspecs, amap: dict,
                     diloco_axis: str | None) -> tuple[int, int]:
    """(padded_local_len, tile) of the per-shard flat anchor buffer a
    sharded plan threads through its sync: the concat of a rank's local
    anchor shards PLUS ONE SENTINEL element, tiled over the non-DiLoCo
    mesh axes. The sentinel makes the threaded layout's length differ
    from a global flatten's (numel) even when every leaf shards evenly,
    so ``sync`` can always tell a global-layout buffer
    (``init_outer_state``'s) from its own and rebuild it."""
    local = shard_flat_size(shapes, pspecs, amap) + 1
    tile = math.prod(n for a, n in amap.items() if a != diloco_axis)
    return local, tile


def flat_anchor_len(model, plan, mesh) -> int:
    """GLOBAL length of the flat anchor buffer the outer sync threads:
    numel for replicated-parameter plans; for sharded plans the
    per-shard length (``_shard_flat_dims``) tiled over the non-DiLoCo
    mesh axes (an opaque rank-major concat; a rank holds its block)."""
    shapes = model.param_shapes()
    amap = mesh_axes(mesh)
    pspecs = partition.param_pspecs(model.axes(), shapes, plan, amap)
    if not _sharded(pspecs):
        return sum(l.numel() for l in leaves(shapes))
    local, tile = _shard_flat_dims(shapes, pspecs, amap, plan.diloco_axis)
    return local * tile


def batch_pspecs(model, shape, plan, mesh, *, stacked: bool) -> dict:
    """Leading-batch-dim specs for every input leaf (+ worker dim)."""
    per_worker = shape.global_batch // plan.n_workers
    bp = partition.batch_pspec(plan, per_worker, mesh_axes(mesh))
    if stacked and plan.diloco_axis:
        bp = (plan.diloco_axis,) + bp
    return {k: bp for k in model.input_specs(shape)}


def _coords(mesh) -> dict[str, int]:
    """This rank's coordinate along each dim of ``mesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def _worker_mesh(mesh, dax):
    """The submesh of one DiLoCo worker: every dim but ``dax`` (None if
    there is none)."""
    inner = tuple(n for n in mesh.mesh_dim_names if n != dax)
    return mesh[inner] if inner else None


def _wait(t: torch.Tensor) -> torch.Tensor:
    """The tensor behind a functional collective's pending result."""
    return t.wait() if hasattr(t, "wait") else t


class _Gather(torch.autograd.Function):
    """A parameter's local block -> the whole parameter over ``mesh``
    (all-gather along each sharded dim; a replicated one passes as is).
    Backward takes the gradient as a partial sum over every rank of the
    mesh (each saw its own batch slice) and reduces it back to the
    block's layout: reduce-scatter on sharded dims, all-reduce on
    replicated ones. The result is the SUM over the mesh's ranks."""

    @staticmethod
    def forward(ctx, x, mesh, pl):
        from torch.distributed.tensor import DTensor, Replicate
        ctx.mesh, ctx.pl = mesh, pl
        rep = (Replicate(),) * len(pl)
        if pl == rep:
            return x.view_as(x)
        return _wait(DTensor.from_local(x, mesh, pl, run_check=False)
                     .redistribute(mesh, rep).to_local())

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Partial
        part = (Partial(),) * len(ctx.pl)
        out = DTensor.from_local(g.contiguous(), ctx.mesh, part,
                                 run_check=False)
        return _wait(out.redistribute(ctx.mesh, ctx.pl).to_local()), None, None


def _layer_layouts(axes, specs, prefix=()) -> list:
    """(path inside its layer tree, spec) of every parameter. A stacked
    leaf (logical axes led by "layers") is seen by ``fetch`` one layer
    at a time, so its spec loses the lead; a top-level tensor's path is
    its own name."""
    if isinstance(axes, dict):
        return [lay for k in axes
                for lay in _layer_layouts(axes[k], specs[k], prefix + (k,))]
    spec = specs[1:] if axes[:1] == ("layers",) else specs
    return [(prefix if len(prefix) == 1 else prefix[1:], spec)]


def _make_fetch(model, pspecs, sub, flat):
    """The loss's ``fetch`` over the worker mesh ``sub`` (``flat``: the
    same ranks as one mesh dim): each tensor of a layer tree goes
    through ``_Gather`` with its layout, found by its path inside the
    layer tree (each such path must name one layout)."""
    if sub is None:
        return None
    from torch.distributed.tensor import Replicate
    table: dict = {}
    for rel, spec in _layer_layouts(model.axes(), pspecs):
        pl = partition.placements(spec, sub)
        # a replicated tensor's gradient: ONE all-reduce over all ranks
        lay = ((flat, (Replicate(),)) if not any(e is not None
                                                  for e in spec)
               else (sub, pl))
        if table.setdefault(rel, lay) != lay:
            raise ValueError(f"parameter path {rel} has two layouts")

    def fetch(tree, prefix=()):
        if isinstance(tree, dict):
            return {k: fetch(v, prefix + (k,)) for k, v in tree.items()}
        return _Gather.apply(tree, *table[prefix])
    return fetch


@dataclasses.dataclass(frozen=True)
class _ListLayout:
    """How ``_ListGather`` moves one parameter: its spec, the group of
    each sharded dim (in dim order), the worker axes the spec lays it
    over and their group (None: replicated), and the group over the
    worker axes it is replicated on (None: no such axis of more than
    one rank)."""
    spec: tuple
    dims: tuple                   # ((dim, group), ...)
    laid: tuple                   # the worker axes the spec lays
    scatter: object               # their group, or None
    replicas: object              # group over the other worker axes
    amap: dict


class _ListGather(torch.autograd.Function):
    """``_Gather`` through ``rank_mesh``'s list collectives, the
    sequence-parallel step's transport (``CardMailboxes`` where the
    worker's ranks share a card, which NCCL cannot serve). Forward: the
    block all-gathered along each sharded dim over that dim's group.
    Backward: the gradient, a partial sum on each of the worker's
    ranks, reduce-scattered over the axes the spec lays it over (rank
    r's row its block: ``partition.stacked_blocks``), then summed over
    the axes it is replicated on. The result is the SUM over the
    worker's ranks, as ``_Gather``'s."""

    @staticmethod
    def forward(ctx, x, lay):
        ctx.lay = lay
        if not lay.dims:
            return x.view_as(x)
        for d, group in lay.dims:
            x = torch.cat(rank_mesh.all_gather_list(x.contiguous(), group,
                                                    "weights"), dim=d)
        return x

    @staticmethod
    def backward(ctx, g):
        lay = ctx.lay
        if lay.scatter is not None:
            g = rank_mesh.reduce_scatter_rows(partition.stacked_blocks(
                g, lay.spec, lay.amap, lay.laid), lay.scatter, "weights")
        if lay.replicas is not None:
            g = rank_mesh.all_reduce_sum(g.contiguous(), lay.replicas,
                                         "weights")
        return g, None


def _make_list_fetch(model, pspecs, mesh, worker_axes: tuple):
    """The loss's ``fetch`` through ``_ListGather`` (see ``_make_fetch``
    for the paths). Collective: every rank makes the groups, and their
    card mailboxes, in one order."""
    amap = mesh_axes(mesh)
    specs: dict = {}
    for rel, spec in _layer_layouts(model.axes(), pspecs):
        if specs.setdefault(rel, spec) != spec:
            raise ValueError(f"parameter path {rel} has two layouts")

    def laid(spec) -> tuple:
        axes = {a for e in spec for a in partition._entry_axes(e)}
        return tuple(a for a in worker_axes if a in axes)

    wanted = set()
    for spec in specs.values():
        wanted |= {partition._entry_axes(e) for e in spec}
        on = laid(spec)
        wanted |= {on, tuple(a for a in worker_axes if a not in on)}
    groups = {axes: _group(mesh, axes) for axes in sorted(wanted)
              if axes and math.prod(amap[a] for a in axes) > 1}
    for g in groups.values():
        rank_mesh.use_card_mailboxes(g, model.device)

    def layout(spec):
        on = laid(spec)
        off = tuple(a for a in worker_axes if a not in on)
        return _ListLayout(
            spec, tuple((d, groups[partition._entry_axes(e)])
                        for d, e in enumerate(spec)
                        if partition._entry_axes(e) in groups),
            on, groups.get(on), groups.get(off), amap)
    table = {rel: layout(spec) for rel, spec in specs.items()}

    def fetch(tree, prefix=()):
        if isinstance(tree, dict):
            return {k: fetch(v, prefix + (k,)) for k, v in tree.items()}
        return _ListGather.apply(tree, table[prefix])
    return fetch


def _flat(sub):
    """``sub`` as one mesh dim (flattened when it has more)."""
    return sub._flatten() if sub.ndim > 1 else sub


def _sum_over(t: torch.Tensor, sub) -> torch.Tensor:
    """Sum of ``t`` over the ranks of ``sub`` (one flat mesh dim, or
    None), forward only."""
    if sub is None or sub.size() == 1:
        return t
    from torch.distributed.tensor import DTensor, Partial, Replicate
    tot = DTensor.from_local(t, sub, (Partial(),), run_check=False)
    return _wait(tot.redistribute(sub, (Replicate(),)).to_local())


def local_train_state(model, plan, mesh, params=None):
    """This rank's block of a fresh train state (``build_train_step``'s
    layout): the parameters cut from ``params`` (the whole tree, e.g.
    ``model.init(seed)``) or, without it, allocated unfilled (under
    ``FakeTensorMode`` the dry run's fake state); zero AdamW moments in
    fp32; a leading worker dim of 1 when the plan has a DiLoCo axis."""
    from repro_torch.train.state import TrainState
    amap, coords = mesh_axes(mesh), _coords(mesh)
    pspecs = param_specs(model, plan, mesh)
    dax = plan.diloco_axis
    shapes = model.param_shapes()

    def block(spec, shape, src=None):
        if src is None:
            t = torch.empty(partition.local_shape(shape.shape, spec, amap),
                            dtype=shape.dtype, device=model.device)
        else:
            t = partition.local_block(src, spec, amap, coords).clone()
        return t[None] if dax else t
    if params is None:
        p = tree_map(block, pspecs, shapes)
    else:
        p = tree_map(block, pspecs, shapes, params)
    some = leaves(p)[0]
    step = torch.zeros((1,) if dax else (), dtype=torch.int32,
                       device=some.device)
    zeros = tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                           device=t.device), p)
    return TrainState(p, AdamWState(step, zeros,
                                    tree_map(torch.clone, zeros)))


def _group(mesh, axes: tuple):
    """The process group over the mesh dims ``axes`` (in mesh order;
    flattened when more than one: ranks row-major, as a combined spec
    entry lays a dim)."""
    return _flat(mesh[axes[0]] if len(axes) == 1 else mesh[axes]).get_group()


class _GatherRows(torch.autograd.Function):
    """Rows of the group's blocks, concatenated in group order. Backward
    sums the ranks' gradients of the whole and returns this rank's rows
    (``act_hints.BatchSplit.gather``)."""

    @staticmethod
    def forward(ctx, t, group, index):
        ctx.group, ctx.index, ctx.n = group, index, t.shape[0]
        return torch.cat(rank_mesh.all_gather_list(t, group))

    @staticmethod
    def backward(ctx, g):
        g = rank_mesh.all_reduce_sum(g.contiguous(), ctx.group)
        return g[ctx.index * ctx.n:(ctx.index + 1) * ctx.n], None, None


def _batch_split(mesh, entry, coords):
    """The ``act_hints.BatchSplit`` of a batch laid over spec ``entry``
    (None when it is not split)."""
    from repro_torch.sharding import act_hints
    axes = partition._entry_axes(entry)
    amap = mesh_axes(mesh)
    size = math.prod(amap[a] for a in axes)
    if size == 1:
        return None
    group = _group(mesh, axes)
    index = rank_mesh.axes_index(amap, axes, coords)
    return act_hints.BatchSplit(
        index, size, lambda t: _GatherRows.apply(t, group, index))


def _sp_hints(mesh, plan, entry, worker_axes: tuple, wgroup, device):
    """The sequence-parallel step's hint maker: ``hint(rows)`` for
    microbatches of ``rows`` rows a rank (``act_hints.Hint``: the
    sequence split over ``plan.act_seq_axis``, the worker's token grid
    for the MoE routing and the loss split over the worker's ranks).
    Collective: every rank makes the groups, and their card mailboxes,
    in one order."""
    from repro_torch.sharding import act_hints
    amap, coords = mesh_axes(mesh), _coords(mesh)
    sp = plan.act_seq_axis
    n_sp = amap[sp]
    sgroup = _group(mesh, (sp,))
    for g in (sgroup, wgroup):
        rank_mesh.use_card_mailboxes(g, device)
    # n_sp blocks, which the model lays over each stream (``over``)
    seq = act_hints.SeqSplit(
        coords[sp], act_hints.even_bounds(n_sp, n_sp),
        lambda t: rank_mesh.all_gather_list(t, sgroup, "kv"),
        lambda rows: rank_mesh.reduce_scatter_rows(rows, sgroup, "kv"))
    loss = act_hints.LossSplit(
        math.prod(amap[a] for a in worker_axes),
        lambda t: rank_mesh.all_reduce_sum(t, wgroup))
    ranks = [dict(zip(worker_axes, (int(i) for i in idx)))
             for idx in np.ndindex(*(amap[a] for a in worker_axes))]
    me = rank_mesh.axes_index(amap, worker_axes, coords)
    blocks = [rank_mesh.axes_index(amap, partition._entry_axes(entry), c)
              for c in ranks]

    def hint(rows: int):
        grid = act_hints.GridSplit(
            me, tuple((b * rows, (b + 1) * rows) for b in blocks),
            tuple(c[sp] for c in ranks), n_sp,
            lambda t: rank_mesh.all_gather_list(t, wgroup, "routing"),
            lambda rows: rank_mesh.reduce_scatter_rows(rows, wgroup,
                                                       "routing"))
        return act_hints.Hint(batch=grid, seq=seq, loss=loss)
    return hint


def build_train_step(model, plan, mesh, optimizer: AdamW):
    """Returns (train_step, state_specs): the hybrid DiLoCo-FSDP inner
    step of one rank over ``mesh`` (a ``DeviceMesh`` with the plan's
    axis names).

    The state and batch carry a leading DiLoCo-worker dim iff
    ``plan.diloco_axis``; the state is this rank's block of each tensor
    as ``state_specs`` lays it out (``local_train_state``), the batch
    the whole one or this rank's worker's block of it (leading dim 1);
    the rank takes its rows over ``plan.batch_axes``.
    ``train_step(state, batch) -> (state, metrics)`` updates the state
    in place (the reference donates it) and returns the loss's metrics,
    the worker's.

    Each rank computes the loss of its batch slice with every layer's
    weights gathered over the worker's mesh dims (``_Gather``; ``remat``
    per layer as the plan says), and its loss is its rows' masked sum
    over the mask sum of the worker's (micro)batch
    (``act_hints.LossSplit``: one scalar all-reduced), so the ranks'
    losses add up to the reference's one loss under any mask: the
    gradients come back summed over the worker's ranks and are not
    divided, and the metrics are the ranks' terms summed. Ranks that
    share a slice count it as often in the mask sum as in the summed
    gradient. A token-choice MoE layer routes over the worker's whole
    (micro)batch, as the reference's one program does
    (``act_hints.BatchSplit``, ``models.moe``); its ``lb_loss`` and
    ``dropped_frac`` enter each rank's terms divided by the rank count.
    ``plan.microbatches`` accumulates in fp32 (metrics from the last
    microbatch); microbatch i is rows [i B / n, (i + 1) B / n) of the
    worker's batch, as in the reference, cut over the batch axes. When
    that cut does not divide (dbrx-132b single-pod: one row a rank), the
    rank splits its own rows into as many microbatches as divide them:
    each rank's rows are then its own microbatches, its loss their mean,
    and the reference's mean over microbatches is the ranks' mean (the
    gradients summed and divided by the rank count, the metrics
    averaged).
    AdamW runs on the local shards.

    Sequence parallelism (``plan.act_seq_axis`` of more than one rank;
    the reference's residual spec ``P(batch_entry, act_seq_axis)``):
    each rank runs its rows' positions [lo, hi) of every microbatch
    (``act_hints.SeqSplit``, even bounds; the models gather K/V and an
    MoE's routing over the worker with summing backwards), and its loss
    is its tokens' share of the worker's, as above. The weights move
    through ``_ListGather`` (card mailboxes where the ranks share a
    card). Microbatches must be the reference's rows cut over the batch
    axes."""
    from repro_torch.sharding import act_hints
    from repro_torch.train.state import TrainState
    amap = mesh_axes(mesh)
    pspecs = param_specs(model, plan, mesh)
    dax = plan.diloco_axis
    sub = _worker_mesh(mesh, dax)
    worker_axes = tuple(a for a in amap if a != dax)
    n_ranks = math.prod(amap[a] for a in worker_axes)
    flat = None if sub is None else _flat(sub)
    bspec = partition.batch_pspec(plan)
    entry = bspec[0] if bspec else None
    n_shards = math.prod(amap[a] for a in partition._entry_axes(entry))
    sp = plan.act_seq_axis
    sp_on = sp is not None and amap.get(sp, 1) > 1
    if sp_on:
        if sp in partition._entry_axes(entry) or sp == dax:
            raise ValueError(f"plan: the SP axis {sp!r} also splits the "
                             f"batch or the workers")
        if model.cfg.family in ("ssm", "hybrid"):
            # their losses score the whole sequence on every rank, which
            # the summed gradient would count once a rank
            raise ValueError(f"sequence parallelism: the {model.cfg.family}"
                             f" family's loss does not split by positions")
        wgroup = _group(mesh, worker_axes)
        fetch = _make_list_fetch(model, pspecs, mesh, worker_axes)
        sp_hint = _sp_hints(mesh, plan, entry, worker_axes, wgroup,
                            model.device)
        hint = None
    else:
        fetch = _make_fetch(model, pspecs, sub, flat)
        hint = act_hints.Hint(
            batch=_batch_split(mesh, entry, _coords(mesh)),
            loss=act_hints.LossSplit(n_ranks, lambda t: _sum_over(t, flat))
            if n_ranks > 1 else None)
    lead = lambda t: partition.with_leading(t, dax)
    state_specs = TrainState(lead(pspecs), AdamWState(
        (dax,) if dax else (), lead(pspecs), lead(pspecs)))

    def worker_rows(v, coords):
        """The worker's whole batch of one input: from the whole
        (stacked) batch, or from its worker's block (leading dim 1)."""
        if not dax:
            return v
        return v[0] if v.shape[0] == 1 < amap[dax] else v[coords[dax]]

    def microbatches(batch, coords):
        """This rank's rows of each microbatch, and whether they are the
        reference's microbatches."""
        rows = next(iter(batch.values())).shape[0]
        nmb = plan.microbatches
        cut = lambda v: partition.local_block(v, (entry,), amap, coords)
        if rows % nmb == 0 and (rows // nmb) % n_shards == 0:
            mbs = rows // nmb
            return [{k: cut(v[i * mbs:(i + 1) * mbs])
                     for k, v in batch.items()} for i in range(nmb)], True
        local = {k: cut(v) for k, v in batch.items()}
        rows = rows // n_shards
        nmb = math.gcd(nmb, rows)
        return [{k: v[i * rows // nmb:(i + 1) * rows // nmb]
                 for k, v in local.items()} for i in range(nmb)], False

    def grads_of(params, mbs, summed: bool):
        nmb = len(mbs)
        req = tree_map(lambda p: p.detach().requires_grad_(), params)
        ws = leaves(req)
        acc, metrics = None, None
        for b in mbs:
            loss, metrics = model.loss(req, b, remat=plan.remat,
                                       fetch=fetch)
            gs = torch.autograd.grad(loss, ws, allow_unused=True)
            gs = [torch.zeros_like(p) if g is None else g
                  for g, p in zip(gs, ws)]
            if nmb == 1:
                acc = gs
            elif acc is None:
                acc = [g.float() for g in gs]
            else:
                for a, g in zip(acc, gs):
                    a.add_(g.float())
        # the ranks' losses add up to the worker's, or (the fallback)
        # each is a mean of its own microbatches
        scale = nmb if summed else nmb * n_ranks
        grads = [g / scale if scale > 1 else g for g in acc]
        return grads, {k: v.detach() for k, v in metrics.items()}

    def step(state, batch):
        coords = _coords(mesh)
        own = (lambda t: t[0]) if dax else (lambda t: t)
        params = tree_map(own, state.params)
        opt = AdamWState(own(state.opt.step), tree_map(own, state.opt.m),
                         tree_map(own, state.opt.v))
        mbs, aligned = microbatches({k: worker_rows(v, coords)
                                     for k, v in batch.items()}, coords)
        if sp_on:
            if not aligned:
                raise ValueError(
                    f"sequence parallelism: {plan.microbatches} "
                    f"microbatches of the worker's rows do not divide "
                    f"over the batch axes' {n_shards} ranks")
            use = sp_hint(next(iter(mbs[0].values())).shape[0])
        else:
            # the whole batch's routing and loss hold only for
            # microbatches of the reference's rows; the fallback routes
            # and scores each rank's own
            use = hint if aligned else None
        with act_hints.activation_hints(use):
            grads, metrics = grads_of(params, mbs, aligned)
        paths = [p for p, _ in leaves_with_paths(params)]
        optimizer.update_(from_paths(paths, grads), opt, params)
        keys = sorted(metrics)
        vals = torch.stack([metrics[k].float() for k in keys])
        if sp_on:
            vals = rank_mesh.all_reduce_sum(vals, wgroup)
        else:
            vals = _sum_over(vals, flat)
            if not aligned:
                vals = vals / n_ranks
        return state, dict(zip(keys, vals.unbind()))

    return step, state_specs


def shard_tree(tree, specs, mesh) -> dict:
    """This rank's block (a copy) of every tensor of ``tree`` laid out
    as ``specs`` (e.g. ``partition.with_leading(param_specs(...), dax)``
    for stacked parameters)."""
    amap, coords = mesh_axes(mesh), _coords(mesh)
    return tree_map(lambda spec, t: partition.local_block(
        t, spec, amap, coords).clone(), specs, tree)


def local_outer_state(model, plan, mesh, anchor_local,
                      cfg: dl.DiLoCoConfig):
    """This rank's block of a fresh outer state for ``build_outer_sync``
    from its block of the (unstacked) anchor parameters: the fp32
    anchor (views of a flat buffer), zero momentum, an empty residual
    ((1, 0) with a DiLoCo axis) and the flat buffer the sync threads
    (for a sharded plan, the per-shard view with its sentinel)."""
    st = dl.init_outer_state(anchor_local, cfg)
    if plan.diloco_axis:
        st = st._replace(residual=st.residual[None])
        if _sharded(param_specs(model, plan, mesh)):
            # the per-shard view with its sentinel, the anchor's leaves
            # its views (no second copy at the first sync)
            flat = F.pad(st.anchor_flat, (0, 1))
            eng = SyncEngine.for_tree(anchor_local)
            st = st._replace(anchor=eng.unflatten(flat[:-1],
                                                  dtype=torch.float32),
                             anchor_flat=flat)
    return st


def build_outer_sync(model, plan, mesh, diloco_cfg: dl.DiLoCoConfig,
                     ring_order=None):
    """Returns (sync_step, outer_specs): the DiLoCo outer step of one
    rank over ``mesh``.

    ``sync_step(params_stacked, outer_state, weights) -> (params_stacked,
    outer_state)``, every tensor this rank's block (``weights`` (1,) with
    a DiLoCo axis). The outer state (fp32 anchor + Nesterov momentum) is
    shared by the workers and laid out like the parameters. Three
    branches, as in the reference:

      * no DiLoCo axis: the per-leaf step on the local shards (no
        communication; flattening would concat sharded leaves);
      * replicated inner parameters: ``diloco.outer_sync`` over the
        DiLoCo group, threading the flat fp32 anchor (the returned
        buffer is the one the new anchor's leaves view);
      * sharded parameters (paper §2.3: "only ranks responsible for the
        same shard communicate"): each rank rings the flat concat of its
        own shards over its DiLoCo group (one ring per shard position,
        all in parallel), and threads a per-shard flat anchor of that
        length plus one sentinel element (``_shard_flat_dims``); a
        buffer of any other length is rebuilt from the anchor tree.
        Error feedback raises ``NotImplementedError`` there (per-shard
        residuals are not kept), as in the reference."""
    amap = mesh_axes(mesh)
    pspecs = param_specs(model, plan, mesh)
    dax = plan.diloco_axis

    if dax is None:
        def sync_single(params, outer_state, weights):
            del weights
            delta = tree_map(lambda a, p: a - p.float(), outer_state.anchor,
                             params)
            new_anchor, new_opt = diloco_cfg.outer_opt.update(
                delta, outer_state.opt, outer_state.anchor)
            # copies: the train step writes the parameters in place
            new_params = tree_map(lambda a, p: a.to(p.dtype, copy=True),
                                  new_anchor, params)
            return new_params, dl.OuterState(
                new_anchor, new_opt, outer_state.residual,
                outer_state.outer_step + 1)
        return sync_single, dl.OuterState(pspecs, NesterovState(pspecs),
                                          (), ())

    sharded = _sharded(pspecs)
    if diloco_cfg.error_feedback and sharded:
        raise NotImplementedError(
            "error feedback requires per-shard residual bookkeeping; "
            "supported with replicated-inner-params plans only")
    group = mesh.get_group(dax)
    nondax = tuple(a for a in amap if a != dax)
    if sharded:
        padded_local, _ = _shard_flat_dims(model.param_shapes(), pspecs,
                                           amap, dax)

    def sync(params_stacked, outer_state, weights):
        p_i = tree_map(lambda x: x[0], params_stacked)
        a_flat = outer_state.anchor_flat
        if sharded:
            if a_flat is None or tuple(a_flat.shape) != (padded_local,):
                # first sync, or a global-layout buffer: build the
                # per-shard view once; later syncs thread the result
                a_flat = F.pad(SyncEngine.for_tree(outer_state.anchor)
                               .flatten(outer_state.anchor), (0, 1))
            a_flat = a_flat[:-1]                 # drop the sentinel
        st = outer_state._replace(residual=outer_state.residual[0],
                                  anchor_flat=a_flat)
        new_p, new_st = dl.outer_sync(p_i, st, diloco_cfg, group,
                                      ring_order=ring_order,
                                      weight=weights[0])
        new_flat = new_st.anchor_flat
        if sharded:
            new_flat = F.pad(new_flat, (0, 1))
            eng = SyncEngine.for_tree(new_st.anchor)
            new_st = new_st._replace(
                anchor=eng.unflatten(new_flat[:-1], dtype=torch.float32))
        # an fp32 parameter is a view of the flat anchor: copy it, as the
        # train step writes the parameters in place
        new_p = tree_map(lambda x: (x.clone() if x.dtype == torch.float32
                                    else x)[None], new_p)
        return new_p, new_st._replace(residual=new_st.residual[None],
                                      anchor_flat=new_flat)

    flat_spec = ()
    if sharded and nondax:
        flat_spec = (nondax[0] if len(nondax) == 1 else nondax,)
    return sync, dl.OuterState(pspecs, NesterovState(pspecs), (dax,), (),
                               flat_spec)


# -- serve --------------------------------------------------------------------
#
# The reference jits ``model.prefill`` / ``model.decode`` over the mesh
# with the parameters laid out by the plan and the cache by
# ``ModelDef.cache_pspecs`` (XLA's partitioner does the rest). Here each
# rank runs the one-device model code on its rows with every layer's
# weights gathered as it runs (forward only), and the cache's layout is
# carried by its leaves: a KV cache laid over 'model' is a
# ``ShardedKVCache`` (decode runs kernel 5 at the rank's heads, or its
# block variant on the rank's cells, and gathers the rest); an SSM state
# or conv ring laid over 'model' is gathered for the step and its block
# written back. Collectives go over the ranks' process groups
# (``rank_mesh.all_gather_list``: a gloo group takes CUDA tensors
# through the card mailboxes of ranks that share a card, else through
# host copies).


def local_params(model, plan, mesh, params=None):
    """This rank's block of every parameter under ``plan``: cut from
    ``params`` (the whole tree), or allocated unfilled (under
    ``FakeTensorMode`` the dry run's fake blocks)."""
    amap = mesh_axes(mesh)
    pspecs = param_specs(model, plan, mesh)
    if params is not None:
        return shard_tree(params, pspecs, mesh)
    return tree_map(lambda spec, s: torch.empty(
        partition.local_shape(s.shape, spec, amap), dtype=s.dtype,
        device=model.device), pspecs, model.param_shapes())


def _model_gather(mesh, device):
    """The forward all-gather over this rank's 'model' group (a list in
    rank order; one element without such an axis). Collective: ranks of
    one card share ``CardMailboxes``."""
    amap = mesh_axes(mesh)
    if amap.get("model", 1) == 1:
        return lambda t: [t]
    group = _group(mesh, ("model",))
    rank_mesh.use_card_mailboxes(group, device)
    return lambda t: rank_mesh.all_gather_list(t, group)


def local_cache(model, plan, mesh, batch_size: int, shape):
    """This rank's block of a fresh serving cache for ``batch_size``
    slots at ``shape`` (``ModelDef.init_cache``'s arguments): every
    leaf laid out by ``model.cache_pspecs``, as zeros. A KV cache laid
    over 'model' becomes an ``attention.ShardedKVCache`` carrying its
    layout (kv heads [lo, hi) of n, or cells [off, off + S_blk) of S)
    and the group's gather; an enc-dec's cross K/V laid over 'model'
    stay tensors and their own layout (its capacity the cross cache's)
    is the tree's ``cross_layout`` (an ``attention.KVLayout``); lengths
    stay whole. Collective (it makes the 'model' group's transport):
    every rank calls it."""
    from repro_torch.models import attention as attn
    amap, coords = mesh_axes(mesh), _coords(mesh)
    meta = model.init_cache(batch_size, shape, device="meta")
    specs = model.cache_pspecs(meta, plan, amap)
    gather = _model_gather(mesh, model.device)
    m = coords.get("model", 0)

    def block(spec, t):
        return torch.zeros(partition.local_shape(t.shape, spec, amap),
                           dtype=t.dtype, device=model.device)

    def layout(spec, whole):
        """The ``KVLayout`` of a (..., S, Hk, dh) tensor laid out as
        ``spec`` (None unless laid over 'model')."""
        ks = tuple(spec) + (None,) * (whole.dim() - len(spec))
        if ks[-2] == "model":
            n = whole.shape[-2] // amap["model"]
            return attn.KVLayout(heads=(m * n, (m + 1) * n, whole.shape[-2]),
                                 all_gather=gather)
        if ks[-3] == "model":
            n = whole.shape[-3] // amap["model"]
            return attn.KVLayout(seq=(m * n, whole.shape[-3]),
                                 all_gather=gather)
        return None

    def walk(t, spec):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: walk(t[k], spec[k]) for k in t}
            if "cross_k" in t:
                lay = layout(spec["cross_k"], t["cross_k"])
                if lay is not None:
                    out["cross_layout"] = lay
            return out
        if isinstance(t, list):
            return [walk(a, b) for a, b in zip(t, spec)]
        if isinstance(t, attn.KVCache):
            k, v = block(spec.k, t.k), block(spec.v, t.v)
            length = block(spec.length, t.length)
            lay = layout(spec.k, t.k)
            return (attn.KVCache(k, v, length) if lay is None
                    else lay.view(k, v, length))
        if isinstance(t, tuple):
            return type(t)(*(walk(a, b) for a, b in zip(t, spec)))
        return block(spec, t)
    return walk(meta, specs)


def _rows_view(cache, rows: slice, lengths: list):
    """The cache as the model sees it on a rank's rows: every length
    (whole on the rank, laid out replicated) cut to ``rows`` as a view,
    so the model's writes land in the whole; (whole, view) pairs are
    appended to ``lengths``."""
    from repro_torch.models import attention as attn
    if isinstance(cache, dict):
        out = {k: _rows_view(v, rows, lengths) for k, v in cache.items()}
        if "src_len" in cache:
            out["src_len"] = cache["src_len"][rows]
            lengths.append((cache["src_len"], out["src_len"]))
        return out
    if isinstance(cache, list):
        return [_rows_view(v, rows, lengths) for v in cache]
    if isinstance(cache, attn.KVCache):
        view = cache.length[..., rows]
        lengths.append((cache.length, view))
        return dataclasses.replace(cache, length=view)
    return cache


def _serve_fetch(model, pspecs, mesh):
    """The serve step's ``fetch``: each tensor of a layer (or top-level)
    tree gathered along every dim its spec lays over mesh axes, forward
    only; replicated tensors pass as they are."""
    groups = {}
    table: dict = {}
    for rel, spec in _layer_layouts(model.axes(), pspecs):
        if table.setdefault(rel, spec) != spec:
            raise ValueError(f"parameter path {rel} has two layouts")
        for entry in spec:
            axes = partition._entry_axes(entry)
            if axes and axes not in groups:
                groups[axes] = None
    for axes in sorted(groups):      # collective: one order on every rank
        groups[axes] = _group(mesh, axes)
        rank_mesh.use_card_mailboxes(groups[axes], model.device)

    def whole(t, spec):
        for d, entry in enumerate(spec):
            axes = partition._entry_axes(entry)
            if axes:
                t = torch.cat(rank_mesh.all_gather_list(t, groups[axes]),
                              dim=d)
        return t

    def fetch(tree, prefix=()):
        if isinstance(tree, dict):
            return {k: fetch(v, prefix + (k,)) for k, v in tree.items()}
        return whole(tree, table[prefix])
    return fetch


def _state_gather(model, mesh):
    """(gather, write_back) of a hybrid cache's SSM leaves laid over
    'model' (state by heads, conv rings by channels): ``gather(ssm)``
    returns the whole-width SSMState of the rank's rows, ``write_back
    (ssm, whole)`` copies the rank's block of it into ``ssm``."""
    from repro_torch.models import hybrid
    gather = _model_gather(mesh, model.device)
    m = _coords(mesh).get("model", 0)

    def dims(local, b):
        full = hybrid._dummy_states(model.cfg, b, device="meta")
        return [next((d for d in range(t.dim())
                      if t.shape[d] != f.shape[d]), None)
                for t, f in zip(local, full)]

    def whole(ssm):
        ds = dims(ssm, ssm.state.shape[1])
        return type(ssm)(*(t if d is None else torch.cat(gather(t), dim=d)
                           for t, d in zip(ssm, ds)))

    def write_back(ssm, full):
        for t, f, d in zip(ssm, full, dims(ssm, ssm.state.shape[1])):
            if d is not None:
                t.copy_(f.narrow(d, m * t.shape[d], t.shape[d]))
    return whole, write_back


def build_serve_step(model, plan, mesh, kind: str):
    """kind in {'prefill', 'decode'}. Returns (fn, param_specs): one
    rank's serve step over ``mesh`` (a ``DeviceMesh`` with the plan's
    axis names), the reference's contract.

    ``fn(params, batch, cache)`` (prefill; ``batch`` the whole one:
    tokens and a VLM's frontend, or an enc-dec's src_embeds and bos) and
    ``fn(params, token, cache)`` (decode; token (B, 1)) take this rank's
    block of every parameter (``local_params``, laid out by
    ``param_specs``) and of the cache (``local_cache``), write the cache
    in place and return ``(logits (B, V), cache)``, the logits whole on
    every rank (the reference's ``out_shardings=None``). The rank takes
    the rows its cache holds (the batch axes, where they divide) and
    runs the model on them with each layer's weights gathered before
    use.

    The prefill shards the sequence over 'model' when the KV heads do
    not divide that axis (the reference's ``act_hints`` SP hint, not for
    the SSM and hybrid families): each rank runs the residual stream of
    its positions (``act_hints.SeqSplit``, ``models.transformer``); an
    enc-dec's split is laid over its source frames (the encoder, whose
    memory is gathered once for the cross K/V of the rank's cells,
    ``models.encdec.prefill``), and its BOS token, as every decode
    step, runs whole on every rank."""
    from repro_torch.sharding import act_hints
    if kind not in ("prefill", "decode"):
        raise ValueError(f"serve step kind {kind!r}")
    cfg = model.cfg
    amap = mesh_axes(mesh)
    pspecs = param_specs(model, plan, mesh)
    n_model = amap.get("model", 1)
    split = (n_model > 1 and cfg.n_kv_heads % n_model != 0
             and cfg.family not in ("ssm", "hybrid"))
    coords = _coords(mesh)
    fetch = _serve_fetch(model, pspecs, mesh)
    gather_m = _model_gather(mesh, model.device)
    batch_axes = tuple(a for a in plan.batch_axes if amap.get(a, 1) > 1)
    row_group = _group(mesh, batch_axes) if batch_axes else None
    if row_group is not None:
        rank_mesh.use_card_mailboxes(row_group, model.device)
    state_whole, state_back = (_state_gather(model, mesh)
                               if cfg.family in ("ssm", "hybrid")
                               else (None, None))

    def rows_entry(b: int):
        spec = partition.cache_pspec((b,), plan, amap, batch_dim=0,
                                     heads_dim=None, seq_dim=None)
        return spec[0] if spec else None

    def fn(params, inputs, cache):
        lead = (inputs if kind == "decode"
                else next(iter(inputs.values())))
        entry = rows_entry(lead.shape[0])
        cut = lambda v: partition.local_block(v, (entry,), amap, coords)
        hint = None
        if kind == "decode":
            local = cut(inputs)
        else:
            local = {k: cut(v) for k, v in inputs.items()}
            if split:
                # the prompt's positions (a VLM's frontend first); an
                # enc-dec lays the split over its source frames itself
                s = sum(local[k].shape[1] for k in ("frontend", "tokens")
                        if k in local)
                hint = act_hints.Hint(seq=act_hints.SeqSplit(
                    coords["model"], act_hints.even_bounds(s, n_model),
                    gather_m))
        # lengths are whole on every rank (replicated, as the reference
        # lays them); the model sees its rows' and they are gathered back
        sharded_rows = entry is not None and row_group is not None
        n_rows = lead.shape[0] // (row_group.size() if sharded_rows else 1)
        r0 = (rank_mesh.axes_index(amap, partition._entry_axes(entry),
                                   coords) * n_rows if sharded_rows else 0)
        lengths = []
        mcache = _rows_view(cache, slice(r0, r0 + n_rows), lengths)
        if state_whole is not None:
            mcache = dict(mcache, ssm=state_whole(cache["ssm"]))
        with torch.no_grad(), act_hints.activation_hints(hint):
            if kind == "decode":
                logits, _ = model.decode(params, local, mcache, fetch=fetch)
            else:
                logits, _ = model.prefill(params, local, mcache, fetch=fetch)
        if state_back is not None:
            state_back(cache["ssm"], mcache["ssm"])
        if sharded_rows:
            logits = torch.cat(rank_mesh.all_gather_list(logits,
                                                         row_group))
            for whole, rows in lengths:
                whole.copy_(torch.cat(rank_mesh.all_gather_list(
                    rows.contiguous(), row_group), dim=-1))
        return logits, cache

    return fn, pspecs
