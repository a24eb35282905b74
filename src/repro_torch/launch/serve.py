"""Serving launcher (port of ``repro.launch.serve``): batched generation
with the wave, continuous or paged engine, with tokens/sec and
request-latency percentiles at exit (and, for the paged engine, its
block-pool and prefix-sharing counters).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch intellect-1 \
      --engine continuous --slots 4 --requests 8 --max-new 32

It runs on the GPU (``--device cuda``, the default), where decode
attention goes through the hand-written flash-decode kernel (its paged
variant with ``--engine paged --block-size 16 --pool-blocks N``);
``--device cpu`` runs the same path with the kernel's plain PyTorch
version. ``--attn-impl`` is accepted for command-line parity with
``repro.launch.serve`` and sets ``decode_attn_impl`` on the config; the
port picks the kernel from the device.

``--swarm`` runs fault-tolerant swarm inference instead: it brings up an
in-process fleet of ``--stages x --replicas`` StageServers over loopback
(serving views of one weight set; the stage weights are also published
into a seed chunk store, from which a joiner could adopt them), routes
the same requests through a ``SwarmRouter``, crashes one mid-chain
holder a few responses into the run, and checks that the emitted tokens
equal the single-host engine's, exiting non-zero if they do not:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
      --reduced --swarm --stages 2 --replicas 2 --requests 4

The transformer families serve alike: ``--arch deepseek-moe-16b`` (MoE,
its dense first layer's cache on stage 0), ``dbrx-132b`` (MoE; on one
card only ``--reduced``: its weights outgrow the card) and
``phi-3-vision-4.2b`` (VLM, served on text prompts). The reduced
deepseek-moe-16b has one stacked layer after its dense one, so its swarm
is one stage (``dense0`` rides with it), two replicas, one crashed:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b \
      --reduced --swarm --stages 1 --device cpu

The single-host reference is ``ContinuousEngine(batch_slots=1,
batch_admit=False)``: a chain runs every request at B = 1, and on the
card a matmul row's bits may depend on how many rows share the call.

The SSM and hybrid families serve on every engine: ``--arch
mamba2-130m`` (attention-free: no flash-decode launch; the paged engine
has no KV to page and admits as the dense one) and ``zamba2-2.7b`` (the
shared attention block's K/V, 32 heads of 80, dense or paged through
the flash-decode kernels). Neither has the stage seam, so ``--swarm``
raises ``ValueError``, as in the JAX package:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
      --reduced --engine paged --device cpu

The enc-dec family (``seamless-m4t-medium``) has no engine: its prefill
takes source frame embeddings and a BOS token, so ``--arch
seamless-m4t-medium`` raises ``ValueError`` (it is served through
``ModelDef.prefill`` / ``decode`` directly).
"""
from __future__ import annotations

import argparse
import dataclasses


def _run_swarm(args, cfg, model, params) -> dict:
    import tempfile
    import time
    from pathlib import Path

    from repro_torch.checkpointing import (ChunkGossip, ChunkPeer,
                                           ChunkStore, PeerConnPool)
    from repro_torch.models import registry
    from repro_torch.serving import StageServer, SwarmRouter, publish_stages
    from repro_torch.serving.engine import ContinuousEngine

    # the stage seam first: the families without one raise ValueError
    stages = registry.make_stages(cfg, args.stages, args.device)
    reqs = make_requests(args, cfg.vocab)
    prompts = [r.prompt.tolist() for r in reqs]
    engine = ContinuousEngine(model, params, batch_slots=1,
                              batch_admit=False, max_len=args.max_len,
                              bucket_prompts=not args.no_bucket)
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    reference = [list(r.out_tokens) for r in reqs]

    servers, pool, gossip, seed_peer = {}, None, None, None
    with tempfile.TemporaryDirectory() as td:
        root = Path(td)
        seed_store = ChunkStore(root / "seed")
        publish_stages(seed_store, cfg, params, args.stages)
        try:
            seed_peer = ChunkPeer(seed_store)
            for sid in range(args.stages):
                sp = stages[sid].slice_params(params)
                for r in range(args.replicas):
                    srv = StageServer(
                        cfg, ChunkStore(root / f"srv_{sid}_{r}"),
                        k_stages=args.stages, max_len=args.max_len,
                        device=args.device)
                    srv.serve_stage(sid, sp)
                    servers[(sid, r)] = srv
            pool = PeerConnPool(timeout=args.timeout)
            gossip = ChunkGossip([s.addr for s in servers.values()],
                                 timeout=args.timeout, pool=pool)
            gossip.poll_once()
            router = SwarmRouter(args.stages, gossip, timeout=args.timeout,
                                 pool=pool, max_len=args.max_len,
                                 bucket_prompts=not args.no_bucket)
            if args.replicas > 1 and args.requests > 1:
                # crash the mid-chain holder the router plans first a few
                # responses into the run: it must fail over and re-prefill
                first = router._pick(args.stages // 2)
                victim = next(s for s in servers.values()
                              if s.addr == first)
                victim.crash_after = victim.served_chunks + 3
            t0 = time.perf_counter()
            outs = [router.generate(p, args.max_new, rid=f"req{i}",
                                    eos_id=engine.eos_id)
                    for i, p in enumerate(prompts)]
            wall = time.perf_counter() - t0
            st = dict(router.stats)
            ntok = sum(len(o) for o in outs)
            identical = outs == reference
            print(f"swarm stages={args.stages} replicas={args.replicas} "
                  f"requests={len(outs)} tokens={ntok} "
                  f"tok/s={ntok / max(wall, 1e-9):.1f}")
            print(f"failovers={st['failovers']} "
                  f"recoveries={st['recoveries']} "
                  f"replayed_tokens={st['replayed_tokens']} "
                  f"recovery_s={st['recovery_s']:.3f} "
                  f"pool_reused={pool.stats['reused']}")
            print(f"bit_identical_to_engine={identical}")
            if not identical:
                raise SystemExit("swarm outputs diverged from engine")
        finally:
            if gossip is not None:
                gossip.stop()
            if pool is not None:
                pool.close()
            for s in servers.values():
                s.close()
            if seed_peer is not None:
                seed_peer.close()
    return dict(st, engine="swarm", outputs=outs, reference=reference,
                tokens_out=ntok, wall_s=wall,
                bit_identical_to_engine=identical)


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
                    help="fault-tolerant swarm-inference demo")
    ap.add_argument("--stages", type=int, default=2)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=5.0)
    return ap


def engine_kwargs(args) -> dict:
    """The engine's keyword arguments from the parsed flags."""
    kw = dict(batch_slots=args.slots, max_len=args.max_len,
              bucket_prompts=not args.no_bucket,
              decode_chunk=args.decode_chunk, top_k=args.top_k,
              top_p=args.top_p, seed=args.seed)
    if args.engine == "paged":
        kw.update(block_size=args.block_size, pool_blocks=args.pool_blocks)
    return kw


def make_requests(args, vocab: int) -> list:
    """The launcher's request trace: ``args.requests`` random prompts of
    ``prompt_len // 2`` to ``prompt_len`` tokens, from ``args.seed``."""
    import numpy as np

    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(args.seed)
    reqs = []
    for i in range(args.requests):
        plen = max(1, int(rng.integers(args.prompt_len // 2,
                                       args.prompt_len + 1)))
        reqs.append(Request(
            rid=i,
            prompt=rng.integers(2, vocab, size=plen).astype(np.int32),
            max_new_tokens=args.max_new,
            temperature=args.temperature))
    return reqs


def main(argv=None) -> dict:
    """Parse ``argv``, serve, print the exit summary and return it."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.engine == "wave" and args.temperature > 0:
        ap.error("--engine wave is greedy-only; use --engine "
                 "continuous for --temperature > 0")
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.serving.engine import make_engine

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is visible; "
                           "pass --device cpu to run on the CPU")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family == "encdec":
        # before any weights: no engine serves an enc-dec prefill (the
        # JAX package's launcher fails on it with a KeyError)
        raise ValueError(f"{cfg.name}: serving unsupported for family "
                         "'encdec' (its prefill takes src_embeds and bos, "
                         "not prompt tokens)")
    if args.device == "cuda":
        need = cfg.param_count() * torch.finfo(cfg.torch_dtype).bits // 8
        have = torch.cuda.get_device_properties(0).total_memory
        if need > have:          # dbrx-132b: 264 GB of bf16 weights
            raise ValueError(f"{cfg.name}: {need / 1e9:.1f} GB of weights "
                             f"do not fit the card's {have / 1e9:.1f} GB; "
                             "pass --reduced")
    if args.attn_impl != cfg.decode_attn_impl:
        cfg = dataclasses.replace(cfg, decode_attn_impl=args.attn_impl)
    model = get_model(cfg, args.device)
    params = model.init(args.seed)
    if args.swarm:
        return _run_swarm(args, cfg, model, params)
    engine = make_engine(args.engine, model, params, **engine_kwargs(args))
    reqs = make_requests(args, cfg.vocab)
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
    if args.engine == "paged":
        print(f"block_size={s['block_size']} "
              f"blocks_peak={s['blocks_peak']}/{s['pool_blocks']} "
              f"prefix_hit_rate={s['prefix_hit_rate']:.2f} "
              f"cow_forks={s['cow_forks']} "
              f"paged_extends={s['paged_extends']}")
    s["outputs"] = [list(r.out_tokens) for r in reqs]
    s["done"] = [r.done for r in reqs]
    s["padded_vocab"] = cfg.padded_vocab
    s["n_layers"] = cfg.n_layers
    return s


if __name__ == "__main__":
    main()
