"""Int8 ring all-reduce with fp32 accumulation (INTELLECT-1 §2.2), the
stacked single-process simulator (port of ``repro.core.ring_reduce``).

  * ring reduce-scatter then ring all-gather over k worker rows; every
    transmitted chunk is quantized to int8 (6-sigma clip + bucket-mean
    codebook, 1 KiB sideband per chunk-hop) while the running reduction
    stays fp32;
  * in the all-gather each reduced chunk is quantized ONCE by its owner
    and the codes are forwarded verbatim, so every worker decodes
    identical bytes;
  * ``ring_order`` is a permutation of the workers; each contribution is
    pre-scaled by a per-worker weight (0 for dead or joining workers)
    and the average divides by the total weight;
  * each chunk-hop splits into ``RingConfig.buckets`` sub-buckets with
    their own codebooks; the reduce-scatter receive is the fused
    ``ops.dequantize_add``; with ``fused_src=(anchor_flat, thetas)`` the
    first hop quantizes straight off the model buffers through
    ``ops.quantize_pseudograd``;
  * ``quant="int4"`` carries ``core/compression.py``'s packed codes
    (plain PyTorch on either device, as the JAX package's is plain
    ``jnp``); ``"fp32"`` is the paper's uncompressed baseline.

``RingSyncOp`` splits the all-reduce at wire-hop granularity so a
training loop can dispatch one hop between inner-phase chunks (the
overlapped outer sync); it retains its inputs so a torn or sanitized
reduction can ``restart`` from them. ``simulate_ring_all_reduce`` is the
same op run to its end in one call, so the two agree bit for bit.

One call of a codec op covers all k rows (the JAX package ``vmap``s
per-row calls), so with k workers and nb buckets one int8 all-reduce
makes ``nb`` fused-encode, ``nb*(k-1)`` encode, ``nb*(k-1)`` decode_add
and ``nb*k`` decode calls on the fused main path (``codec_calls``, hop
by hop ``hop_codec_calls``). The accumulator is updated in place.
``chunk_norms`` is the admission layer's per-chunk norm sideband,
computed in fp64 on the rows' own device. The distributed rings run
the same hop bodies at one ring position: ``train/step.py``'s
``DistRingSyncOp`` (a hop per command to a mesh of rank processes) and
``ring_all_reduce`` (the whole ring inside one rank, over a process
group: the sharded outer sync's, one ring per shard).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import compression
from repro_torch.kernels import ops as qops
from repro_torch.kernels.ref import NUM_BUCKETS

CODEC = ("pseudograd_encode_hist", "encode_hist", "decode_add", "decode")
# columns per fp64 block of the sideband passes: k x 4 Mi x 8 bytes
_NORM_BLOCK = 1 << 22


@dataclasses.dataclass(frozen=True)
class RingConfig:
    quant: str = "int8"          # 'int8' | 'fp32' (paper baseline) | 'int4'
    average: bool = True
    buckets: int = 1             # sub-buckets per chunk-hop
    fused: bool = True           # fused dequantize_add / pseudograd tx


def _bytes_per_elem(quant: str) -> float:
    return {"int8": 1.0, "int4": 0.5, "fp32": 4.0}[quant]


def ring_hop_bytes(numel: int, n_workers: int, quant: str = "int8",
                   buckets: int = 1) -> float:
    """Per-worker bytes of ONE wire hop: one chunk of ``buckets``
    sub-buckets plus their codebook sidebands (padding rides too)."""
    if n_workers <= 1:
        return 0.0
    chunk = -(-numel // n_workers)
    chunk = -(-chunk // buckets) * buckets
    payload = chunk * _bytes_per_elem(quant)
    sideband = 0 if quant == "fp32" else 4 * NUM_BUCKETS * buckets
    return float(payload + sideband)


def ring_wire_bytes(numel: int, n_workers: int, quant: str = "int8",
                    buckets: int = 1) -> int:
    """Per-worker bytes on the wire for one all-reduce: 2·(n−1) hops."""
    if n_workers <= 1:
        return 0
    return int(2 * (n_workers - 1)
               * ring_hop_bytes(numel, n_workers, quant, buckets))


def hop_codec_calls(hop: int, k: int, cfg: RingConfig = RingConfig(),
                    fused_src: bool = True) -> dict:
    """Codec wrapper calls of wire hop ``hop`` (0 <= hop < 2(k-1)) of one
    int8 all-reduce over a ring of k: hops below k-1 reduce-scatter (hop
    0 transmits through the fused encode when the caller passes
    ``fused_src``); hop k-1 also carries the owners' quantization."""
    calls = dict.fromkeys(CODEC, 0)
    if k <= 1 or cfg.quant != "int8":
        return calls
    nb = max(1, cfg.buckets)
    if hop < k - 1:
        fused_tx = hop == 0 and cfg.fused and fused_src
        calls["pseudograd_encode_hist" if fused_tx else "encode_hist"] = nb
        calls["decode_add" if cfg.fused else "decode"] = nb
    else:
        if hop == k - 1:
            calls["encode_hist"] = calls["decode"] = nb
        calls["decode"] += nb
    return calls


def codec_calls(k: int, cfg: RingConfig = RingConfig(),
                fused_src: bool = True, hops: int | None = None) -> dict:
    """Codec wrapper calls of the first ``hops`` wire hops (default:
    all 2(k-1), one whole int8 all-reduce) over a ring of k."""
    total = dict.fromkeys(CODEC, 0)
    for hop in range(2 * (k - 1) if hops is None else hops):
        for name, n in hop_codec_calls(hop, k, cfg, fused_src).items():
            total[name] += n
    return total


# -- chunk/bucket helpers -----------------------------------------------------


def _pad_to_chunks(x: torch.Tensor, n: int,
                   buckets: int = 1) -> tuple[torch.Tensor, int, int]:
    """Pad the last dim so it splits into ``n`` chunks of ``buckets``
    equal sub-buckets. Returns (padded, chunk, bucket_size)."""
    size = x.shape[-1]
    chunk = -(-size // n)
    bsize = -(-chunk // buckets)
    chunk = bsize * buckets
    pad = n * chunk - size
    if pad:
        x = F.pad(x, (0, pad))
    return x, chunk, bsize


def _bucket_index(idxs: torch.Tensor, b: int, nb: int) -> torch.Tensor:
    """Row r's sub-bucket b of chunk idxs[r], in the (k*nb, bsize) view."""
    return idxs * nb + b


def _get_bucket_rows(accs, idxs, b: int, nb: int, bsize: int):
    rows = torch.arange(accs.shape[0], device=accs.device)
    return accs.view(accs.shape[0], -1, bsize)[
        rows, _bucket_index(idxs, b, nb)]


def _set_bucket_rows(accs, idxs, b: int, vals, nb: int, bsize: int):
    rows = torch.arange(accs.shape[0], device=accs.device)
    accs.view(accs.shape[0], -1, bsize)[
        rows, _bucket_index(idxs, b, nb)] = vals
    return accs


def _row_deq(cfg: RingConfig, bsize: int):
    """Row-wise dequant fn for (k, bsize) stacked payloads."""
    if cfg.quant == "fp32":
        return lambda p: p[0]
    if cfg.quant == "int4":
        return lambda p: compression.dequantize4(
            compression.Quantized4(*p), bsize)
    return lambda p: qops.dequantize(qops.Quantized(*p))


def _quant_rows(vals: torch.Tensor, cfg: RingConfig):
    """Row-wise transmit quantization of (k, bsize) buckets -> (payload
    tuple, row-wise dequant fn)."""
    bsize = vals.shape[-1]
    if cfg.quant == "fp32":
        return (vals,), _row_deq(cfg, bsize)
    if cfg.quant == "int4":
        return tuple(compression.quantize4(vals)), _row_deq(cfg, bsize)
    return tuple(qops.quantize(vals)), _row_deq(cfg, bsize)


def _rx_add_rows(payload, deq, acc_vals: torch.Tensor, cfg: RingConfig):
    if cfg.fused and cfg.quant == "int8":
        return qops.dequantize_add(qops.Quantized(*payload), acc_vals)
    return acc_vals + deq(payload)


def _roll1(payload):
    """Position p receives from position p-1."""
    return tuple(torch.roll(p, 1, dims=0) for p in payload)


# -- hop bodies ---------------------------------------------------------------


# ``k`` is always the RING size; the row count is ``positions.shape[0]``:
# all k positions in the simulator, ONE row in a rank process of the
# distributed ring (``train/step.py``), where ``positions`` is the rank's
# own position and ``shift`` a point-to-point exchange along the ring in
# place of ``torch.roll``. The codec's per-row results do not depend on
# how many rows a call holds, so both ways give the same bits.


def _rs_hop_rows(s: int, accs, k: int, bsize: int, nb: int,
                 cfg: RingConfig, fused_operands=None, *,
                 positions=None, shift=_roll1):
    """One reduce-scatter hop across the given ring positions and
    buckets. ``fused_operands=(a_flat, t_pos, w_pos)`` routes the
    transmit through the fused pseudo-gradient quantizer (hop 0 only)."""
    if positions is None:
        positions = torch.arange(k, device=accs.device)
    send_idx = torch.remainder(positions - s, k)
    recv_idx = torch.remainder(positions - s - 1, k)
    staged = []
    for b in range(nb):
        if fused_operands is not None:
            a_flat, t_pos, w_pos = fused_operands
            a_rows = a_flat.view(-1, bsize)[_bucket_index(send_idx, b, nb)]
            t_rows = _get_bucket_rows(t_pos, send_idx, b, nb, bsize)
            q = qops.quantize_pseudograd(a_rows, t_rows, scale=w_pos)
            staged.append((tuple(q), _row_deq(cfg, bsize)))
        else:
            staged.append(_quant_rows(
                _get_bucket_rows(accs, send_idx, b, nb, bsize), cfg))
    for b, (payload, deq) in enumerate(staged):
        payload = shift(payload)
        acc_vals = _get_bucket_rows(accs, recv_idx, b, nb, bsize)
        _set_bucket_rows(accs, recv_idx, b,
                         _rx_add_rows(payload, deq, acc_vals, cfg),
                         nb, bsize)
    return accs


def _ag_init_rows(accs, k: int, bsize: int, nb: int, cfg: RingConfig, *,
                  positions=None):
    """All-gather prologue: every owner quantizes its reduced chunk ONCE
    (per bucket) and keeps the decoded values. Returns (accs, payloads)."""
    if positions is None:
        positions = torch.arange(k, device=accs.device)
    own_idx = torch.remainder(positions + 1, k)
    payloads = []
    for b in range(nb):
        vals = _get_bucket_rows(accs, own_idx, b, nb, bsize)
        payload, deq = _quant_rows(vals, cfg)
        _set_bucket_rows(accs, own_idx, b, deq(payload), nb, bsize)
        payloads.append(payload)
    return accs, tuple(payloads)


def _ag_hop_rows(s: int, accs, payloads, k: int, bsize: int, nb: int,
                 cfg: RingConfig, *, positions=None, shift=_roll1):
    """One all-gather hop: shift every bucket's forwarded codes one
    position and decode in place."""
    if positions is None:
        positions = torch.arange(k, device=accs.device)
    recv_idx = torch.remainder(positions - s, k)
    deq = _row_deq(cfg, bsize)
    new_payloads = []
    for b in range(nb):
        payload = shift(payloads[b])
        _set_bucket_rows(accs, recv_idx, b, deq(payload), nb, bsize)
        new_payloads.append(payload)
    return accs, tuple(new_payloads)


def _permute_rows_(x: torch.Tensor, src: Sequence[int]) -> None:
    """``x[w] = x[src[w]]`` for every row w, in place, one row of
    scratch per cycle of the permutation."""
    done = [False] * len(src)
    for start in range(len(src)):
        if done[start] or src[start] == start:
            continue
        tmp, w = x[start].clone(), start
        while True:
            done[w] = True
            if src[w] == start:
                x[w].copy_(tmp)
                break
            x[w].copy_(x[src[w]])
            w = src[w]


class RingSyncOp:
    """The ring all-reduce over (k, D) stacked per-worker vectors, one
    wire hop per ``step()`` (port of ``repro.core.ring_reduce.
    RingSyncOp``): (k-1) reduce-scatter hops, then (k-1) all-gather
    forwards, the owners' quantization riding with the first.
    ``finish()`` drains the rest and returns the (k, D) result,
    identical across workers. ``fused_src=(anchor_flat, thetas)``
    (``anchor_flat`` (D,) shared, ``thetas`` (k, D) in any float dtype)
    mirrors the fused first-hop transmit.

    The op RETAINS its inputs (``xs``, ``weights``, ``fused_src``) and
    owns them: ``xs`` is not copied when it is fp32 already, and
    ``OuterSyncHandle.sanitize`` writes it in place. A worker dying
    mid-overlap leaves the accumulator torn, so recovery re-reduces the
    retained rows over the survivors (``restart``). The accumulator and
    the padded transmit copies are built at the first hop, not here, so
    a staged op holds only its inputs until the ring starts.
    """

    def __init__(self, xs: torch.Tensor,
                 ring_order: Sequence[int] | None = None,
                 cfg: RingConfig = RingConfig(),
                 weights: torch.Tensor | None = None,
                 fused_src=None):
        k, orig_size = xs.shape
        self.k, self.orig_size, self.cfg = k, orig_size, cfg
        self.xs = xs.float()
        self.weights = (torch.ones((k,), dtype=torch.float32,
                                   device=xs.device) if weights is None
                        else weights.float())
        self.ring_order = (tuple(ring_order) if ring_order is not None
                           else tuple(range(k)))
        if sorted(self.ring_order) != list(range(k)):
            raise ValueError(f"ring order {self.ring_order} is not a "
                             "permutation")
        self.fused_src = fused_src
        self._total_w = self.weights.sum()
        self.hops_done = 0
        self.hops_total = 2 * (k - 1) if k > 1 else 0
        self._accs = self._payloads = self._fused_ops = None
        self._out: torch.Tensor | None = None

    @property
    def pending(self) -> bool:
        return self.hops_done < self.hops_total

    def _stage(self) -> None:
        """Position-major weighted accumulators (row p belongs to worker
        ring_order[p]) and the fused transmit's padded operands."""
        k, cfg = self.k, self.cfg
        perm = torch.as_tensor(self.ring_order, device=self.xs.device)
        self._nb = nb = max(1, cfg.buckets)
        w_pos = self.weights[perm]
        self._accs, _, self._bsize = _pad_to_chunks(
            self.xs[perm] * w_pos[:, None], k, nb)
        if (self.fused_src is not None and cfg.fused
                and cfg.quant == "int8"):
            a_flat, thetas = self.fused_src
            pad = self._accs.shape[-1] - self.orig_size
            a_flat = a_flat.float()
            # an identity ring reads the caller's rows without a copy;
            # thetas keep their dtype (the encode widens them exactly)
            t_pos = (thetas if self.ring_order == tuple(range(k))
                     else thetas[perm])
            if pad:
                a_flat = F.pad(a_flat, (0, pad))
                t_pos = F.pad(t_pos, (0, pad))
            self._fused_ops = (a_flat, t_pos, w_pos)

    def step(self) -> bool:
        """Dispatch ONE wire hop (asynchronous device work); True iff a
        hop was dispatched."""
        if self._out is not None or not self.pending:
            return False
        if self.hops_done == 0:
            self._stage()
        i, k = self.hops_done, self.k
        geom = (k, self._bsize, self._nb, self.cfg)
        if i < k - 1:
            _rs_hop_rows(i, self._accs, *geom, self._fused_ops)
            self._fused_ops = None           # free the padded copies
        else:
            s = i - (k - 1)
            if s == 0:
                self._accs, self._payloads = _ag_init_rows(self._accs,
                                                           *geom)
            self._accs, self._payloads = _ag_hop_rows(
                s, self._accs, self._payloads, *geom)
        self.hops_done += 1
        return True

    def finish(self) -> torch.Tensor:
        """Drain any remaining hops and return the (k, D) reduced result
        (identical rows across workers)."""
        if self._out is not None:
            return self._out
        if self.k == 1:
            self._out = (self.xs * self.weights[:, None]
                         / self._total_w.clamp_min(1e-20)
                         if self.cfg.average else self.xs)
            return self._out
        while self.step():
            pass
        out = self._accs[:, :self.orig_size]
        self._accs = self._payloads = None
        if self.cfg.average:
            out.div_(self._total_w.clamp_min(1e-20))
        # out[worker w] from ring position inv[w]
        _permute_rows_(out, np.argsort(self.ring_order).tolist())
        self._out = out
        return out

    def restart(self, weights: torch.Tensor) -> torch.Tensor:
        """Torn-reduction fallback: re-reduce the RETAINED inputs under
        ``weights`` (dead workers zeroed) in one call, discarding the
        partial accumulator. Returns the (k, D) reduced result."""
        self._accs = self._payloads = self._fused_ops = None
        return simulate_ring_all_reduce(
            self.xs, ring_order=self.ring_order, cfg=self.cfg,
            weights=weights, fused_src=self.fused_src)

    def norm_sideband(self) -> np.ndarray:
        """(k, k * buckets) per-chunk norm sideband of the retained
        inputs (:func:`chunk_norms`) for the admission layer."""
        return chunk_norms(self.xs, self.cfg.buckets)


def simulate_ring_all_reduce(xs: torch.Tensor,
                             ring_order: Sequence[int] | None = None,
                             cfg: RingConfig = RingConfig(),
                             weights: torch.Tensor | None = None,
                             fused_src=None) -> torch.Tensor:
    """Single-process ring over (k, D) stacked per-worker vectors, all
    hops in one call (``RingSyncOp`` run to its end). Returns (k, D)
    results, identical across workers."""
    return RingSyncOp(xs, ring_order, cfg, weights, fused_src).finish()


# -- the ring inside one rank, over a process group --------------------------

# (device type, nbytes) -> (send, recv) host buffers of the staged
# exchange, kept for reuse (one pair per hop size a process has used)
_STAGING: dict = {}
_ALIGN = 16          # bytes: each staged payload part starts on this boundary


def _staged(device, nbytes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(send, recv) host buffers of ``nbytes``; pinned for a card."""
    key = (device.type, nbytes)
    if key not in _STAGING:
        pin = device.type == "cuda"
        _STAGING[key] = tuple(torch.empty(nbytes, dtype=torch.uint8,
                                          pin_memory=pin)
                              for _ in range(2))
    return _STAGING[key]


def staged_shift(payload, group, nxt: int, prv: int, timeout=None,
                 times: dict | None = None):
    """The ring's shift through host buffers: pack ``payload`` (a tuple
    of tensors on one device) into one send buffer, exchange it with
    ``batch_isend_irecv`` (send to global rank ``nxt``, receive global
    rank ``prv``'s buffer of the same layout) and unpack copies on the
    payload's device. ``times``, if given, gains the seconds of the
    pack (``d2h_s``), the wire (``wire_s``) and the unpack (``h2d_s``)."""
    import torch.distributed as dist
    parts = [p.contiguous() for p in payload]
    device = parts[0].device
    sizes = [p.numel() * p.element_size() for p in parts]
    offsets = np.cumsum([0] + [-(-n // _ALIGN) * _ALIGN
                               for n in sizes]).tolist()
    t0 = time.perf_counter()
    send, recv = _staged(device, offsets[-1])
    for p, off, n in zip(parts, offsets, sizes):
        send[off:off + n].copy_(p.reshape(-1).view(torch.uint8))
    t1 = time.perf_counter()
    for w in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, nxt, group),
            dist.P2POp(dist.irecv, recv, prv, group)]):
        w.wait() if timeout is None else w.wait(timeout)
    t2 = time.perf_counter()
    got = recv.to(device) if device.type == "cuda" else recv.clone()
    out = tuple(got[off:off + n].view(p.dtype).view(p.shape)
                for p, off, n in zip(parts, offsets, sizes))
    if times is not None:
        times["d2h_s"] += t1 - t0
        times["wire_s"] += t2 - t1
        times["h2d_s"] += time.perf_counter() - t2
    return out


def p2p_shift(payload, group, nxt: int, prv: int):
    """The ring's shift at one position over ``group``: send ``payload``
    (a tuple of tensors) to global rank ``nxt`` and receive global rank
    ``prv``'s, of the same shapes and dtypes (``batch_isend_irecv``).
    Gloo with CUDA tensors goes through ``staged_shift``'s pinned host
    buffers."""
    import torch.distributed as dist
    parts = [p.contiguous() for p in payload]
    if parts[0].is_cuda and dist.get_backend(group) == "gloo":
        return staged_shift(parts, group, nxt, prv)
    recv = [torch.empty_like(p) for p in parts]
    ops = []
    for s, r in zip(parts, recv):
        ops += [dist.P2POp(dist.isend, s, nxt, group),
                dist.P2POp(dist.irecv, r, prv, group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return tuple(recv)


def _group_weights(weight: torch.Tensor, group) -> torch.Tensor:
    """(n,) every rank's weight, by group rank (gathered on the host for
    gloo, which gathers no CUDA tensors)."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    src = weight.reshape(1)
    if src.is_cuda and dist.get_backend(group) == "gloo":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(weight.device)


def ring_all_reduce(x: torch.Tensor, group,
                    ring_order: Sequence[int] | None = None,
                    cfg: RingConfig = RingConfig(),
                    weight: torch.Tensor | None = None,
                    fused_src=None) -> torch.Tensor:
    """All-reduce (mean by default) of flat fp32 ``x`` over the ranks of
    ``group`` (a process group: the DiLoCo group of one shard), this
    rank at ring position ``inv(ring_order)[group rank]``.

    The hops are the simulator's bodies (``_rs_hop_rows``,
    ``_ag_init_rows``, ``_ag_hop_rows``) at this one position, the
    shift a point-to-point exchange with the ring neighbours
    (``p2p_shift``), the codec on this rank's device (kernels 1-4 on the
    card, one row a call: ``codec_calls(n)`` per reduction). ``weight``
    scales this rank's contribution and the mean divides by the group's
    total, summed in group-rank order as the simulator sums its
    ``weights``; ``fused_src=(anchor_flat, theta_flat)`` (``x == anchor
    - theta``) routes the first hop's transmit through the fused
    encode. So the result is the simulator's row for these inputs, bit
    for bit."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    orig = x.shape[-1]
    x = x.float()
    if weight is None:
        weight = torch.ones((), dtype=torch.float32, device=x.device)
    weight = weight.float().reshape(())
    total_w = _group_weights(weight, group).sum()
    if n == 1:
        return (x * weight / total_w.clamp_min(1e-20) if cfg.average
                else x)
    order = tuple(ring_order) if ring_order is not None else tuple(range(n))
    if sorted(order) != list(range(n)):
        raise ValueError(f"ring order {order} is not a permutation")
    me = dist.get_group_rank(group, dist.get_rank())
    pos = int(np.argsort(order)[me])
    nxt = dist.get_global_rank(group, order[(pos + 1) % n])
    prv = dist.get_global_rank(group, order[(pos - 1) % n])
    nb = max(1, cfg.buckets)
    acc, _, bsize = _pad_to_chunks(x[None] * weight.reshape(1, 1), n, nb)
    fused = None
    if fused_src is not None and cfg.fused and cfg.quant == "int8":
        pad = acc.shape[-1] - orig
        a_flat, t_rows = fused_src[0].float(), fused_src[1][None]
        if pad:
            a_flat, t_rows = F.pad(a_flat, (0, pad)), F.pad(t_rows, (0, pad))
        fused = (a_flat, t_rows, weight.reshape(1))
    positions = torch.tensor([pos], device=x.device)
    geo = (n, bsize, nb, cfg)

    def shift(payload):
        return p2p_shift(payload, group, nxt, prv)
    for s in range(n - 1):
        _rs_hop_rows(s, acc, *geo, fused if s == 0 else None,
                     positions=positions, shift=shift)
    acc, payloads = _ag_init_rows(acc, *geo, positions=positions)
    for s in range(n - 1):
        acc, payloads = _ag_hop_rows(s, acc, payloads, *geo,
                                     positions=positions, shift=shift)
    out = acc[0, :orig]
    if cfg.average:
        out.div_(total_w.clamp_min(1e-20))
    return out


# -- chunk-norm sideband (contribution admission / localization) -------------


def chunk_norms(xs, buckets: int = 1) -> np.ndarray:
    """Per-(chunk, bucket) L2 norms of stacked contributions.

    ``xs``: (k, D) per-worker rows (a tensor on any device, or an
    array). Returns (k, k * buckets) float64 on the host — one column
    per wire sub-bucket, laid out like the ring's chunk geometry (the
    ceil-div padding of :func:`_pad_to_chunks` adds zeros), non-finite
    values counted as 0. The squares add in fp64 on the rows' device,
    a block of columns at a time, so no fp64 copy of the rows exists;
    the reference adds them in numpy on the host, so the two agree to
    fp64 rounding."""
    rows = torch.as_tensor(xs)
    k, size = rows.shape
    nb = max(1, buckets)
    bsize = -(-(-(-size // k)) // nb)
    sq = torch.zeros((k, k * nb), dtype=torch.float64, device=rows.device)
    for c in range(k * nb):
        end = min((c + 1) * bsize, size)
        for lo in range(c * bsize, end, _NORM_BLOCK):
            x = rows[:, lo:min(lo + _NORM_BLOCK, end)].double()
            x.nan_to_num_(nan=0.0, posinf=0.0, neginf=0.0)
            sq[:, c] += (x * x).sum(dim=1)
    return sq.sqrt_().cpu().numpy()
