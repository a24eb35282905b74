"""Mamba2, State Space Duality (SSD), arXiv:2405.21060 (port of
``repro.models.ssm``).

Chunked SSD: the sequence is split into chunks of Q tokens; the
intra-chunk interactions are masked products (the "attention-like" dual
form), the inter-chunk ones a state recurrence over the chunks (a
Python loop here, ``lax.scan`` in the JAX package). The scan has no
Pallas kernel in the JAX package, so it stays plain PyTorch: einsums
and the loop, with ``x``, ``dt``, ``B`` and ``C`` in fp32.

Projections are split per stream (z, x, B, C, dt) as in the JAX package.
Decode keeps a recurrent state (B, H, P, N) and a causal-conv ring of
the last K-1 inputs per stream: O(1) per token. ``decode_mamba2``
writes the new state and rings IN PLACE into the ``SSMState`` it is
given (one layer's views of the stacked cache), as the port's KV caches
are written.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import common


class SSMConfig(NamedTuple):
    d_model: int
    d_state: int = 64
    head_dim: int = 64
    n_groups: int = 1
    conv_kernel: int = 4
    expand: int = 2
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


class SSMState(NamedTuple):
    """Per-slot recurrent state of one layer: state (B, H, P, N) fp32,
    conv_x (B, K-1, d_inner), conv_b / conv_c (B, K-1, G*N) in the
    model's dtype. Stacked over layers (``hybrid.init_cache``) every
    field gains a leading L dim; ``layer(i)`` returns views."""
    state: torch.Tensor
    conv_x: torch.Tensor
    conv_b: torch.Tensor
    conv_c: torch.Tensor

    def layer(self, i: int) -> "SSMState":
        return SSMState(*(t[i] for t in self))


def alloc_mamba2(empty, zeros, ones, lead: tuple, cfg: SSMConfig) -> dict:
    """One Mamba2 block's parameter subtree in ``repro``'s layout, each
    tensor made by ``empty`` / ``zeros`` / ``ones`` (``*lead, ...)``
    (``lead`` = (L,) for a layer stack)."""
    d, di, h = cfg.d_model, cfg.d_inner, cfg.n_heads
    gn = cfg.n_groups * cfg.d_state
    k = cfg.conv_kernel
    return {"in_z": empty(*lead, d, di), "in_x": empty(*lead, d, di),
            "in_b": empty(*lead, d, gn), "in_c": empty(*lead, d, gn),
            "in_dt": empty(*lead, d, h),
            "conv_x": empty(*lead, k, di), "conv_b": empty(*lead, k, gn),
            "conv_c": empty(*lead, k, gn),
            "a_log": zeros(*lead, h), "dt_bias": zeros(*lead, h),
            "d_skip": ones(*lead, h), "norm": ones(*lead, di),
            "out": empty(*lead, di, d)}


def mamba2_axes() -> dict:
    """Logical axes of one layer's ``alloc_mamba2`` subtree (the
    reference's ``init_mamba2`` axes)."""
    return {"in_z": ("embed", "ff"), "in_x": ("embed", "ff"),
            "in_b": ("embed", None), "in_c": ("embed", None),
            "in_dt": ("embed", None), "conv_x": (None, "ff"),
            "conv_b": (None, None), "conv_c": (None, None),
            "a_log": (None,), "dt_bias": (None,), "d_skip": (None,),
            "norm": ("ff",), "out": ("ff", "embed")}


def init_mamba2(p: dict, generator: torch.Generator, cfg: SSMConfig) -> None:
    """Fill one layer's Mamba2 tensors (views) with ``repro``'s scales:
    the input projections fan_in = d_model, the convs K ** -0.5, the
    output projection d_inner ** -0.5 (``a_log``, ``dt_bias`` zeros and
    ``d_skip``, ``norm`` ones come from ``alloc_mamba2``)."""
    for name in ("in_z", "in_x", "in_b", "in_c", "in_dt"):
        common.normal_(p[name], generator)
    for name in ("conv_x", "conv_b", "conv_c"):
        common.normal_(p[name], generator, scale=cfg.conv_kernel ** -0.5)
    common.normal_(p["out"], generator, scale=cfg.d_inner ** -0.5)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 history: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv1d + SiLU. x: (B, L, C), w: (K, C);
    ``history``: (B, K-1, C) left context (decode / continuation). The
    taps are summed in order i = 0..K-1 in x's dtype, as the JAX
    package's ``sum``."""
    k, n = w.shape[0], x.shape[1]
    if history is None:
        history = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([history.to(x.dtype), x], dim=1)
    out = xp[:, 0:n] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + n] * w[i]
    return F.silu(out)


def _segsum(dta: torch.Tensor) -> torch.Tensor:
    """(..., Q) -> (..., Q, Q) with out[i, j] = sum_{j<k<=i} dta_k
    (i >= j), -inf above the diagonal."""
    q = dta.shape[-1]
    cs = torch.cumsum(dta, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=dta.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, a, bmat, cmat, cfg: SSMConfig,
                init_state: torch.Tensor | None = None):
    """Chunked SSD scan.

    x: (B, L, H, P); dt: (B, L, H) (post-softplus); a: (H,) negative;
    bmat / cmat: (B, L, G, N). Returns (y (B, L, H, P), final state
    (B, H, P, N) fp32)."""
    bsz, l, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    q = min(cfg.chunk, l)
    nc = -(-l // q)
    pad = nc * q - l
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, 0, 0, pad))

    hpg = h // g
    xc = x.reshape(bsz, nc, q, g, hpg, p)
    dtc = dt.reshape(bsz, nc, q, g, hpg)
    bc = bmat.reshape(bsz, nc, q, g, n)
    cc = cmat.reshape(bsz, nc, q, g, n)
    dta = dtc * a.reshape(g, hpg)                       # (b,c,q,g,hpg)
    xdt = xc * dtc[..., None]

    # intra-chunk (dual "attention" form)
    lmat = torch.exp(_segsum(dta.movedim(2, -1)))       # (b,c,g,hpg,q,q)
    scores = torch.einsum("bcqgn,bckgn->bcgqk", cc, bc)
    y_diag = torch.einsum("bcgqk,bcghqk,bckghp->bcqghp", scores, lmat, xdt)

    # per-chunk boundary states
    cum = torch.cumsum(dta, dim=2)                      # (b,c,q,g,hpg)
    total = cum[:, :, -1:]                              # (b,c,1,g,hpg)
    decay_to_end = torch.exp(total - cum)
    chunk_states = torch.einsum("bckgn,bckgh,bckghp->bcghpn",
                                bc, decay_to_end, xdt).float()

    # inter-chunk recurrence: the state ENTERING each chunk is kept
    chunk_decay = torch.exp(total[:, :, 0]).float()     # (b,c,g,hpg)
    if init_state is None:
        s = x.new_zeros((bsz, g, hpg, p, n), dtype=torch.float32)
    else:
        s = init_state.reshape(bsz, g, hpg, p, n).float()
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, c, ..., None, None] + chunk_states[:, c]
    prev_states = torch.stack(prev, dim=1)              # (b,c,g,hpg,p,n)

    y_off = torch.einsum("bcqgn,bcghpn,bcqgh->bcqghp", cc,
                         prev_states.to(cc.dtype), torch.exp(cum).to(cc.dtype))
    y = (y_diag + y_off).reshape(bsz, nc * q, h, p)[:, :l]
    return y, s.reshape(bsz, h, p, n)


def _project(p, x):
    return (x @ p["in_z"], x @ p["in_x"], x @ p["in_b"], x @ p["in_c"],
            x @ p["in_dt"])


def _gate_out(p, y, z, x_dtype):
    """(B, L, d_inner) fp32 SSD output -> the block's output (B, L, d)."""
    y = common.rms_norm(y.to(x_dtype) * F.silu(z), p["norm"])
    return y @ p["out"]


def apply_mamba2(p, x: torch.Tensor, cfg: SSMConfig,
                 state: SSMState | None = None, return_state: bool = False,
                 prompt_len: torch.Tensor | None = None):
    """Full Mamba2 block. x: (B, L, d_model) -> (out, new SSMState or
    None).

    ``prompt_len``: optional (B,) true lengths for RIGHT-padded serving
    prefill. dt is multiplied by the length mask AFTER softplus, which
    freezes the SSD recurrence exactly at pad positions (decay
    exp(0) = 1, input x * dt = 0), so the final state equals the
    unpadded run's; each slot's conv tail is gathered at its own true
    last K-1 inputs. Outputs at pad positions are garbage: callers
    gather logits at ``prompt_len - 1``."""
    bsz, l, _ = x.shape
    h, pd, g, n = cfg.n_heads, cfg.head_dim, cfg.n_groups, cfg.d_state
    z, xs, bs, cs, dt = _project(p, x)
    hist = (state.conv_x, state.conv_b, state.conv_c) if state is not None \
        else (None, None, None)
    xs_in, bs_in, cs_in = xs, bs, cs
    xs = _causal_conv(xs, p["conv_x"], hist[0])
    bs = _causal_conv(bs, p["conv_b"], hist[1])
    cs = _causal_conv(cs, p["conv_c"], hist[2])

    dt = F.softplus(dt.float() + p["dt_bias"].float())
    if prompt_len is not None:
        seq_mask = (torch.arange(l, device=x.device)[None, :]
                    < prompt_len.to(x.device)[:, None]).float()
        dt = dt * seq_mask[..., None]
    a = -torch.exp(p["a_log"].float())
    xh = xs.reshape(bsz, l, h, pd)
    y, final = ssd_chunked(
        xh.float(), dt, a, bs.reshape(bsz, l, g, n).float(),
        cs.reshape(bsz, l, g, n).float(), cfg,
        init_state=state.state if state is not None else None)
    y = y + xh.float() * p["d_skip"].reshape(1, 1, h, 1)
    out = _gate_out(p, y.reshape(bsz, l, cfg.d_inner), z, x.dtype)
    if not return_state:
        return out, None
    k = cfg.conv_kernel

    def tail(seq, old):
        if prompt_len is not None:
            # the last K-1 TRUE inputs per slot: the combined (history,
            # tokens) stream ends at position (k-1) + len, so the tail
            # is rows [len, len + k - 1) of it
            hist_ = (old.to(seq.dtype) if old is not None
                     else seq.new_zeros((bsz, k - 1, seq.shape[-1])))
            full = torch.cat([hist_, seq], dim=1)
            idx = (prompt_len.to(x.device).long()[:, None]
                   + torch.arange(k - 1, device=x.device)[None, :])
            return torch.gather(
                full, 1, idx[:, :, None].expand(-1, -1, seq.shape[-1]))
        if l >= k - 1:
            return seq[:, l - (k - 1):]
        keep = old[:, l:] if old is not None else seq.new_zeros(
            (bsz, k - 1 - l, seq.shape[-1]))
        return torch.cat([keep.to(seq.dtype), seq], dim=1)

    return out, SSMState(final, tail(xs_in, hist[0]), tail(bs_in, hist[1]),
                         tail(cs_in, hist[2]))


def decode_mamba2(p, x: torch.Tensor, cfg: SSMConfig,
                  state: SSMState) -> tuple[torch.Tensor, SSMState]:
    """One-token recurrent step. x: (B, 1, d_model). The new state and
    the conv rings (shifted by one, the new input appended) are written
    IN PLACE into ``state``'s tensors, which are returned."""
    bsz = x.shape[0]
    h, pd, g, n = cfg.n_heads, cfg.head_dim, cfg.n_groups, cfg.d_state
    z, xs, bs, cs, dt = _project(p, x)
    rings = [torch.cat([old[:, 1:], new.to(old.dtype)], dim=1)
             for old, new in ((state.conv_x, xs), (state.conv_b, bs),
                              (state.conv_c, cs))]
    xs = _causal_conv(xs, p["conv_x"], state.conv_x)[:, -1:]
    bs = _causal_conv(bs, p["conv_b"], state.conv_b)[:, -1:]
    cs = _causal_conv(cs, p["conv_c"], state.conv_c)[:, -1:]

    dt = F.softplus(dt.float() + p["dt_bias"].float())[:, 0]       # (B, H)
    a = -torch.exp(p["a_log"].float())
    da = torch.exp(dt * a)                                         # (B, H)
    xh = xs.reshape(bsz, h, pd).float()
    hpg = h // g
    bh = bs.reshape(bsz, g, n).repeat_interleave(hpg, dim=1)       # (B, H, N)
    ch = cs.reshape(bsz, g, n).repeat_interleave(hpg, dim=1)
    xdt = xh * dt[..., None]
    s_new = (state.state * da[..., None, None]
             + xdt[..., :, None] * bh[:, :, None, :].float())
    y = torch.einsum("bhpn,bhn->bhp", s_new, ch.float())
    y = y + xh * p["d_skip"].reshape(1, h, 1)
    out = _gate_out(p, y.reshape(bsz, 1, cfg.d_inner), z, x.dtype)
    state.state.copy_(s_new)
    for ring, new in zip(state[1:], rings):
        ring.copy_(new)
    return out, state
