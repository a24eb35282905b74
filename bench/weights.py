"""Random weights for a configuration, made on the device from the seed.

The layout is the one the port's decoder-only models take (the JAX
package's): ``embed`` (V, d), ``lm_head`` (d, V) and ``ln_f`` (d);
``layers``, every tensor led by the stacked layer dim: ``ln_attn``,
``wq`` (d, H dh), ``wk`` and ``wv`` (d, Hk dh), ``wo`` (H dh, d),
``ln_mlp``, and ``mlp`` {gate, up (d, f), down (f, d)} or, for a
mixture of experts, ``moe`` {router (d, E), experts {gate, up
(E, d, f), down (E, f, d)}, shared {gate, up (d, S f), down (S f, d)}};
and the leading dense layers of a mixture of experts unstacked as
``dense{i}``. V is the padded vocabulary.

All matrices are drawn in one ``torch.randn`` call in the stored dtype
and scaled in place: a product's weight by its fan-in ** -0.5, the
embedding by 0.02; norm gains are ones. Every tensor is a view of one
flat buffer.
"""
from __future__ import annotations

import math

import torch

from bench.reference.model import ModelSpec
from bench.seeds import derive

EMBED_STD = 0.02


def _layer(spec: ModelSpec, lead: tuple, moe: bool) -> dict:
    d, hd = spec.d_model, spec.head_dim
    hq, hk = spec.n_heads * hd, spec.n_kv_heads * hd
    p = {"ln_attn": lead + (d,), "wq": lead + (d, hq),
         "wk": lead + (d, hk), "wv": lead + (d, hk), "wo": lead + (hq, d),
         "ln_mlp": lead + (d,)}
    if moe:
        m = spec.moe
        e, f = m.n_experts, m.d_expert
        p["moe"] = {"router": lead + (d, e),
                    "experts": {"gate": lead + (e, d, f),
                                "up": lead + (e, d, f),
                                "down": lead + (e, f, d)}}
        if m.n_shared:
            fs = m.n_shared * f
            p["moe"]["shared"] = {"gate": lead + (d, fs),
                                  "up": lead + (d, fs),
                                  "down": lead + (fs, d)}
    else:
        p["mlp"] = {"gate": lead + (d, spec.d_ff), "up": lead + (d, spec.d_ff),
                    "down": lead + (spec.d_ff, d)}
    return p


def shapes(spec: ModelSpec) -> dict:
    """The parameter tree's shapes."""
    d, v = spec.d_model, spec.padded_vocab
    tree = {"embed": (v, d), "lm_head": (d, v), "ln_f": (d,),
            "layers": _layer(spec, (spec.n_stacked,), spec.moe is not None)}
    for i in range(spec.moe.first_dense if spec.moe else 0):
        tree[f"dense{i}"] = _layer(spec, (), False)
    return tree


def _walk(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def numel(spec: ModelSpec) -> int:
    return sum(math.prod(s) for _, s in _walk(shapes(spec)))


def make(spec: ModelSpec, seed: int, device) -> dict:
    """The weights of ``seed``: the same seed gives the same tensors on
    the same device."""
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    flat = torch.randn(numel(spec), generator=gen, dtype=spec.dtype,
                       device=device)
    out: dict = {}
    off = 0
    for path, shape in _walk(shapes(spec)):
        n = math.prod(shape)
        t = flat[off:off + n].view(shape)
        off += n
        name = path[-1]
        if name.startswith("ln_"):
            t.fill_(1.0)
        elif name == "embed":
            t.mul_(EMBED_STD)
        else:
            t.mul_(shape[-2] ** -0.5)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[name] = t
    return out
