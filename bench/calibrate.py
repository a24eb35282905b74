"""The readings a cell's correctness limits are set from, on the card at
the cell's own size (not part of a benchmark run).

  python3 bench/calibrate.py --workload <name> --seeds 1 2 ... \
      --control-seeds 1 2 3 [--load-seeds 1 2 3 [--zipf 1.0]]

For each of ``--seeds`` the program drives its first outer steps as a
run's set-up does and the reference follows them: the gaps are the
lower readings. For each of ``--control-seeds`` the reference in fp8
(the control) and the reference with each planted fault (half of each
batch left out; every inner step on its outer step's first rows; the
ring's exchange left out) are read against the reference: their gaps
are the upper readings. A step that leaves its state unchanged reads 1
on ``moment1_gap`` and ``change_gap`` by construction. For each of
``--load-seeds`` (a mixture of experts) the reference routes the first
rows of every worker through its first expert layer and reports the
routes each expert gets (``--zipf`` draws the ids under another
exponent). One JSON line a reading, then a summary line.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "bench":
    sys.path.pop(0)
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from bench import check, harness, traffic as traffic_mod, weights  # noqa: E402
from bench.reference import model  # noqa: E402


def program_readings(cell, seed: int, device) -> dict:
    spec = model.spec_from_config(cell.config)
    tokens = traffic_mod.Tokens(cell.traffic, spec.vocab, seed, device)
    w0 = weights.make(spec, seed, device)
    tr = harness.build_trainer(cell, w0, tokens, device)
    out = harness.first_steps(tr, cell, w0)
    del tr, w0, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return out


@torch.no_grad()
def routing_load(cell, seed: int, device, zipf=None) -> dict:
    """Routes each expert of the first expert layer gets from the rows
    of global step 0 (each worker's), under the seed's weights, in fp32
    (the reference's layers; the expert layer's attention, then its
    router's top-k)."""
    spec = model.spec_from_config(cell.config)
    t = dict(cell.traffic)
    if zipf is not None:
        t["zipf_exponent"] = zipf
    rows = traffic_mod.Tokens(t, spec.vocab, seed, device).rows(0)
    w = weights.make(spec, seed, device)
    params = _fp32(w)
    del w
    m, fp32, out = spec.moe, model.Precision(), []
    layers = model.layers_of(spec, params)
    lp = layers[m.first_dense]
    hd = spec.head_dim
    for r in rows:
        x = params["embed"][r[:, :-1].long()]
        for dense in layers[:m.first_dense]:
            x, _ = model._layer(spec, fp32, dense, x)
        b, s, d = x.shape
        h = model.rms_norm(x, lp["ln_attn"], spec.eps)
        q = model.rope((h @ lp["wq"]).reshape(b, s, spec.n_heads, hd),
                       spec.rope_theta)
        k = model.rope((h @ lp["wk"]).reshape(b, s, spec.n_kv_heads, hd),
                       spec.rope_theta)
        v = (h @ lp["wv"]).reshape(b, s, spec.n_kv_heads, hd)
        x = x + model.attention(q, k, v, fp32) @ lp["wo"]
        h = model.rms_norm(x, lp["ln_mlp"], spec.eps).reshape(-1, d)
        probs = torch.softmax(h @ lp["moe"]["router"], dim=-1)
        gi = torch.topk(probs, m.top_k, dim=-1).indices
        load = torch.bincount(gi.reshape(-1), minlength=m.n_experts).float()
        cap = model.capacity(h.shape[0], m)
        out.append({"max": int(load.max()), "min": int(load.min()),
                    "mean": float(load.mean()),
                    "cv": float(load.std() / load.mean()),
                    "capacity": cap,
                    "dropped_share": float((load - cap).clamp_min(0).sum()
                                           / gi.numel()),
                    "top_id_share": float(torch.bincount(
                        r.reshape(-1).long()).max() / r.numel())})
    return {"workers": out}


def _fp32(tree):
    if isinstance(tree, dict):
        return {k: _fp32(v) for k, v in tree.items()}
    return tree.float()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--load-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--zipf", type=float, default=None)
    args = ap.parse_args()
    dev = torch.device("cuda:0")
    cell = harness.load_cell(args.workload, ROOT)
    lows, highs = [], {}

    def emit(seed, kind, g, t0):
        print(json.dumps({"seed": seed, "kind": kind, "seconds":
                          round(time.perf_counter() - t0, 3), **g}),
              flush=True)

    for seed in args.seeds:
        t0 = time.perf_counter()
        prog = program_readings(cell, seed, dev)
        ref = harness.reference_readings(cell, seed, dev)
        g = check.gaps(prog, ref)
        lows.append(g)
        emit(seed, "program", {**g, "reference_s": ref["seconds"]}, t0)
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        ref = harness.reference_readings(cell, seed, dev)
        emit(seed, "reference", ref["seconds"], t0)
        for kind, kw in (("fp8", {"prec": model.Precision("fp8")}),
                         ("half_batch", {"fault": "half_batch"}),
                         ("same_batch", {"fault": "same_batch"}),
                         ("no_exchange", {"fault": "no_exchange"})):
            t0 = time.perf_counter()
            g = check.gaps(harness.reference_readings(cell, seed, dev, **kw),
                           ref)
            highs.setdefault(kind, []).append(g)
            emit(seed, kind, g, t0)
    for seed in args.load_seeds:
        t0 = time.perf_counter()
        emit(seed, "load", routing_load(cell, seed, dev, args.zipf), t0)
    summary = {"lower": {n: max(g[n] for g in lows) for n in check.NAMES}
               if lows else {},
               "upper": {k: {n: min(g[n] for g in v) for n in check.NAMES}
                         for k, v in highs.items()},
               "device": torch.cuda.get_device_name(dev)}
    print(json.dumps({"summary": summary}), flush=True)


if __name__ == "__main__":
    main()
