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
    ``ops.quantize_pseudograd``.

One call of a codec op covers all k rows (the JAX package ``vmap``s
per-row calls), so with k workers and nb buckets one all-reduce makes
``nb`` fused-encode, ``nb*(k-1)`` encode, ``nb*(k-1)`` decode_add and
``nb*k`` decode calls on the fused main path (``codec_calls``). The
accumulator is updated in place. The distributed ring
(``ring_all_reduce``), the hop-steppable ``RingSyncOp`` and the
chunk-norm sideband are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as qops
from repro_torch.kernels.ref import NUM_BUCKETS


@dataclasses.dataclass(frozen=True)
class RingConfig:
    quant: str = "int8"          # 'int8' | 'fp32' (paper baseline)
    average: bool = True
    buckets: int = 1             # sub-buckets per chunk-hop
    fused: bool = True           # fused dequantize_add / pseudograd tx

    def __post_init__(self):
        if self.quant not in ("int8", "fp32"):
            raise NotImplementedError(
                f"ring quant {self.quant!r} is not ported yet (int4 comes "
                "with core/compression.py in a later slice)")


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


def codec_calls(k: int, cfg: RingConfig = RingConfig(),
                fused_src: bool = True) -> dict:
    """Codec wrapper calls of one int8 all-reduce over a ring of k
    (``fused_src``: the caller passes ``fused_src`` to the simulator)."""
    if k <= 1 or cfg.quant != "int8":
        return {"pseudograd_encode_hist": 0, "encode_hist": 0,
                "decode_add": 0, "decode": 0}
    nb = max(1, cfg.buckets)
    tx = nb if (cfg.fused and fused_src) else 0
    rx = nb * (k - 1)
    return {"pseudograd_encode_hist": tx, "encode_hist": nb * k - tx,
            "decode_add": rx if cfg.fused else 0,
            "decode": nb * k + (0 if cfg.fused else rx)}


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


def _row_deq(cfg: RingConfig):
    if cfg.quant == "fp32":
        return lambda p: p[0]
    return lambda p: qops.dequantize(qops.Quantized(*p))


def _quant_rows(vals: torch.Tensor, cfg: RingConfig):
    """Row-wise transmit quantization of (k, bsize) buckets -> (payload
    tuple, row-wise dequant fn)."""
    if cfg.quant == "fp32":
        return (vals,), _row_deq(cfg)
    return tuple(qops.quantize(vals)), _row_deq(cfg)


def _rx_add_rows(payload, deq, acc_vals: torch.Tensor, cfg: RingConfig):
    if cfg.fused and cfg.quant == "int8":
        return qops.dequantize_add(qops.Quantized(*payload), acc_vals)
    return acc_vals + deq(payload)


def _roll1(payload):
    """Position p receives from position p-1."""
    return tuple(torch.roll(p, 1, dims=0) for p in payload)


# -- hop bodies ---------------------------------------------------------------


def _rs_hop_rows(s: int, accs, k: int, bsize: int, nb: int,
                 cfg: RingConfig, fused_operands=None):
    """One reduce-scatter hop over all ring positions and buckets.
    ``fused_operands=(a_flat, t_pos, w_pos)`` routes the transmit
    through the fused pseudo-gradient quantizer (hop 0 only)."""
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
            staged.append((tuple(q), _row_deq(cfg)))
        else:
            staged.append(_quant_rows(
                _get_bucket_rows(accs, send_idx, b, nb, bsize), cfg))
    for b, (payload, deq) in enumerate(staged):
        payload = _roll1(payload)
        acc_vals = _get_bucket_rows(accs, recv_idx, b, nb, bsize)
        _set_bucket_rows(accs, recv_idx, b,
                         _rx_add_rows(payload, deq, acc_vals, cfg),
                         nb, bsize)
    return accs


def _ag_init_rows(accs, k: int, bsize: int, nb: int, cfg: RingConfig):
    """All-gather prologue: every owner quantizes its reduced chunk ONCE
    (per bucket) and keeps the decoded values. Returns (accs, payloads)."""
    own_idx = torch.remainder(torch.arange(k, device=accs.device) + 1, k)
    payloads = []
    for b in range(nb):
        vals = _get_bucket_rows(accs, own_idx, b, nb, bsize)
        payload, deq = _quant_rows(vals, cfg)
        _set_bucket_rows(accs, own_idx, b, deq(payload), nb, bsize)
        payloads.append(payload)
    return accs, tuple(payloads)


def _ag_hop_rows(s: int, accs, payloads, k: int, bsize: int, nb: int,
                 cfg: RingConfig):
    """One all-gather hop: shift every bucket's forwarded codes one
    position and decode in place."""
    recv_idx = torch.remainder(torch.arange(k, device=accs.device) - s, k)
    deq = _row_deq(cfg)
    new_payloads = []
    for b in range(nb):
        payload = _roll1(payloads[b])
        _set_bucket_rows(accs, recv_idx, b, deq(payload), nb, bsize)
        new_payloads.append(payload)
    return accs, tuple(new_payloads)


def simulate_ring_all_reduce(xs: torch.Tensor,
                             ring_order: Sequence[int] | None = None,
                             cfg: RingConfig = RingConfig(),
                             weights: torch.Tensor | None = None,
                             fused_src=None) -> torch.Tensor:
    """Single-process ring over (k, D) stacked per-worker vectors.
    Returns (k, D) results, identical across workers.
    ``fused_src=(anchor_flat, thetas)`` (``anchor_flat`` (D,) shared,
    ``thetas`` (k, D)) mirrors the fused first-hop transmit."""
    k, orig_size = xs.shape
    xs = xs.float()
    if weights is None:
        weights = torch.ones((k,), dtype=torch.float32, device=xs.device)
    weights = weights.float()
    total_w = weights.sum()
    if k == 1:
        return (xs * weights[:, None] / total_w.clamp_min(1e-20)
                if cfg.average else xs)

    order = tuple(ring_order) if ring_order is not None else tuple(range(k))
    if sorted(order) != list(range(k)):
        raise ValueError(f"ring order {order} is not a permutation")
    perm = torch.as_tensor(order, device=xs.device)
    inv = torch.argsort(perm)        # worker w sits at ring position inv[w]

    nb = max(1, cfg.buckets)
    w_pos = weights[perm]
    accs, _, bsize = _pad_to_chunks(xs[perm] * w_pos[:, None], k, nb)

    fused_ops = None
    if fused_src is not None and cfg.fused and cfg.quant == "int8":
        a_flat, thetas = fused_src
        pad = accs.shape[-1] - orig_size
        a_flat = a_flat.float()
        # an identity ring reads the caller's rows without a copy
        t_pos = (thetas.float() if order == tuple(range(k))
                 else thetas.float()[perm])
        if pad:
            a_flat = F.pad(a_flat, (0, pad))
            t_pos = F.pad(t_pos, (0, pad))
        fused_ops = (a_flat, t_pos, w_pos)

    # reduce-scatter; hop 0 carries the fused transmit
    _rs_hop_rows(0, accs, k, bsize, nb, cfg, fused_ops)
    fused_ops = a_flat = t_pos = None        # free the padded copies
    for s in range(1, k - 1):
        _rs_hop_rows(s, accs, k, bsize, nb, cfg)

    # all-gather with forwarded codes
    accs, payloads = _ag_init_rows(accs, k, bsize, nb, cfg)
    for s in range(k - 1):
        accs, payloads = _ag_hop_rows(s, accs, payloads, k, bsize, nb, cfg)
    del payloads

    out = accs[:, :orig_size][inv]   # out[worker w] from position inv[w]
    del accs
    if cfg.average:
        out.div_(total_w.clamp_min(1e-20))
    return out
