"""The distributed outer sync (port of ``repro.train.step``'s per-hop
ring: ``DistSyncPrograms``, ``DistRingSyncOp``, ``DistSyncBackend``).

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
Not ported yet: the FSDP-inside-DiLoCo train step and its sharded outer
sync (``build_train_step``, ``build_outer_sync``).
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
from repro_torch.kernels import int8_quant as iq

_ALIGN = 16          # bytes: each payload part starts on this boundary
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


def _staging(ctx, nbytes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(send, recv) host buffers of ``nbytes``, kept for reuse; pinned
    when the rank's device is a card."""
    cache = ctx.state.setdefault("staging", {})
    if nbytes not in cache:
        pin = ctx.device.type == "cuda"
        cache[nbytes] = tuple(torch.empty(nbytes, dtype=torch.uint8,
                                          pin_memory=pin) for _ in range(2))
    return cache[nbytes]


def _exchange(ctx, prog: _RankPrograms, payload: tuple, times: dict):
    """The ring's shift at one position: send ``payload`` (a tuple of
    tensors) to the next position and receive the previous position's,
    of the same shapes and dtypes, through host buffers over the WAN
    group."""
    import torch.distributed as dist
    parts = [p.contiguous() for p in payload]
    sizes = [p.numel() * p.element_size() for p in parts]
    offsets = np.cumsum([0] + [-(-n // _ALIGN) * _ALIGN
                               for n in sizes]).tolist()
    ctx.sync()
    t0 = time.perf_counter()
    send, recv = _staging(ctx, offsets[-1])
    for p, off, n in zip(parts, offsets, sizes):
        send[off:off + n].copy_(p.reshape(-1).view(torch.uint8))
    t1 = time.perf_counter()
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, prog.next, prog.wan),
        dist.P2POp(dist.irecv, recv, prog.prev, prog.wan)])
    for w in works:
        w.wait(ctx.timeout)
    t2 = time.perf_counter()
    got = recv.to(ctx.device) if ctx.device.type == "cuda" else recv.clone()
    out = tuple(got[off:off + n].view(p.dtype).view(p.shape)
                for p, off, n in zip(parts, offsets, sizes))
    t3 = time.perf_counter()
    times["d2h_s"] += t1 - t0
    times["wire_s"] += t2 - t1
    times["h2d_s"] += t3 - t2
    return out


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
    """Concatenate ``row`` over this rank's group ``key`` (fiber order).
    An NCCL group gathers on the card; a gloo group through host
    copies."""
    import torch.distributed as dist
    group, ranks = ctx.groups[key]
    src = row.contiguous() if key[1] == "nccl" else row.cpu()
    parts = [torch.empty_like(src) for _ in ranks]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(row.device)


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
