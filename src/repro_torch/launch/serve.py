"""Serving launcher (port of ``repro.launch.serve``): batched generation
with the wave or continuous engine, with tokens/sec and request-latency
percentiles at exit.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch intellect-1 \
      --engine continuous --slots 4 --requests 8 --max-new 32

It runs on the GPU (``--device cuda``, the default), where decode
attention goes through the hand-written flash-decode kernel;
``--device cpu`` runs the same path with the kernel's plain PyTorch
version. ``--attn-impl`` is accepted for command-line parity with
``repro.launch.serve`` and sets ``decode_attn_impl`` on the config; the
port picks the kernel from the device. The paged engine and ``--swarm``
are not ported yet and raise.
"""
from __future__ import annotations

import argparse
import dataclasses


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", default="intellect-1")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--engine", default="continuous",
                    choices=["wave", "continuous", "paged"])
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged engine: KV cells per physical block")
    ap.add_argument("--pool-blocks", type=int, default=None,
                    help="paged engine: physical pool size")
    ap.add_argument("--top-p", type=float, default=0.0,
                    help="nucleus sampling threshold (0 = off)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--decode-chunk", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--attn-impl", default="pallas",
                    choices=["jnp", "pallas"])
    ap.add_argument("--no-bucket", action="store_true",
                    help="disable power-of-two prompt pad bucketing")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--swarm", action="store_true",
                    help="fault-tolerant swarm inference (not ported yet)")
    ap.add_argument("--stages", type=int, default=2)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=5.0)
    return ap


def main(argv=None) -> dict:
    """Parse ``argv``, serve, print the exit summary and return it."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.engine == "wave" and args.temperature > 0:
        ap.error("--engine wave is greedy-only; use --engine "
                 "continuous for --temperature > 0")
    if args.swarm:
        raise NotImplementedError("--swarm is not ported yet (swarm "
                                  "serving is a later slice)")

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.serving.engine import Request, make_engine

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is visible; "
                           "pass --device cpu to run on the CPU")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.attn_impl != cfg.decode_attn_impl:
        cfg = dataclasses.replace(cfg, decode_attn_impl=args.attn_impl)
    model = get_model(cfg, args.device)
    params = model.init(args.seed)
    engine_kw = dict(batch_slots=args.slots, max_len=args.max_len,
                     bucket_prompts=not args.no_bucket,
                     decode_chunk=args.decode_chunk,
                     top_k=args.top_k, top_p=args.top_p, seed=args.seed)
    engine = make_engine(args.engine, model, params, **engine_kw)
    rng = np.random.default_rng(args.seed)
    reqs = []
    for i in range(args.requests):
        plen = max(1, int(rng.integers(args.prompt_len // 2,
                                       args.prompt_len + 1)))
        reqs.append(Request(
            rid=i,
            prompt=rng.integers(2, cfg.vocab, size=plen).astype(np.int32),
            max_new_tokens=args.max_new,
            temperature=args.temperature))
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    s = engine.perf_summary()
    print(f"engine={s['engine']} requests={s['requests']} "
          f"tokens={s['tokens_out']} decode_steps={s['decode_steps']}")
    print(f"tok/s={s['tokens_per_s']:.1f} "
          f"p50_latency={s['latency_p50_s'] * 1e3:.1f}ms "
          f"p95_latency={s['latency_p95_s'] * 1e3:.1f}ms "
          f"occupancy={s['slot_occupancy']:.2f} "
          f"host_syncs={s['host_syncs']} "
          f"prefill_widths={s['prefill_widths']}")
    s["outputs"] = [list(r.out_tokens) for r in reqs]
    s["done"] = [r.done for r in reqs]
    s["padded_vocab"] = cfg.padded_vocab
    s["n_layers"] = cfg.n_layers
    return s


if __name__ == "__main__":
    main()
