"""Training launcher (port of ``repro.launch.train``): the elastic PRIME
protocol with k stacked DiLoCo workers in one process — join, leave and
crash schedules (``--events``), H inner AdamW steps per worker, the
int8 ring all-reduce (the hand-written codec kernels on the GPU; int4
and fp32 plain) with optional error feedback, and the Nesterov outer
step, synchronous or overlapped with the next inner phase.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --reduced --workers 2 --outer-steps 2 --inner-steps 2

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --reduced --workers 3 --max-workers 4 --outer-steps 4 \
      --inner-steps 4 --overlap delayed --inner-chunks 7 \
      --events '[[1, "join", 3], [2, "crash", 0]]'

Checkpoints, joining and serving them, on the CPU:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --reduced --workers 2 --outer-steps 3 --inner-steps 2 \
      --ckpt-dir /tmp/ck --ckpt-engine delta --serve-ckpt-port 0
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --reduced --workers 2 --outer-steps 1 --inner-steps 2 \
      --ckpt-dir /tmp/joiner --ckpt-engine delta \
      --join-from 127.0.0.1:<port> [--join-mode stream]

It runs on the GPU (``--device cuda``, the default). ``--max-workers``
sets the number of stacked slots (default: the reference's
``max(2w, w+2)``). ``--events`` is the reference's JSON list of
``[outer_step, kind, node_id]``. ``--ckpt-engine`` picks flat npy
directories, the content-addressed chunk store or the store with an
int8/int4 delta chain (its reference on the training device: the codec
kernels encode and apply it on the GPU). ``--join-from`` swarm-fetches
the peers' newest checkpoint into ``--ckpt-dir`` before step 0
(``--join-mode blocking``) or streams it under the inner phases and
adopts it at the first outer boundary where it is ready (``stream``).
``--serve-ckpt-port`` serves the checkpoints after training until
interrupted (``serve_checkpoints`` starts the server without blocking).
"""
from __future__ import annotations

import argparse
import json
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", default="intellect-1")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale sibling config")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth to this many layers (full width)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--max-workers", type=int, default=None,
                    help="stacked DiLoCo slots (default max(2w, w+2))")
    ap.add_argument("--outer-steps", type=int, default=4)
    ap.add_argument("--inner-steps", type=int, default=None,
                    help="H (default: DiLoCo config, paper=100)")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch-per-worker", type=int, default=4)
    ap.add_argument("--quant", default="int8",
                    choices=["int8", "int4", "fp32"])
    ap.add_argument("--overlap", default="none", choices=["none", "delayed"])
    ap.add_argument("--inner-chunks", type=int, default=1)
    ap.add_argument("--sync-buckets", type=int, default=1)
    ap.add_argument("--error-feedback", action="store_true")
    ap.add_argument("--inner-lr", type=float, default=3e-4)
    ap.add_argument("--outer-lr", type=float, default=0.7)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-engine", default="flat",
                    choices=["flat", "store", "delta"],
                    help="flat npy dirs | content-addressed chunk store | "
                         "chunk store + int8/int4 delta chain")
    ap.add_argument("--ckpt-base-every", type=int, default=8,
                    help="delta engine: full re-anchor every N saves")
    ap.add_argument("--ckpt-codec", default="int8", choices=["int8", "int4"])
    ap.add_argument("--serve-ckpt-port", type=int, default=None,
                    help="serve the checkpoints to joiners on this port "
                         "after training (0 = ephemeral)")
    ap.add_argument("--join-from", default=None,
                    help="comma-separated host:port peers; swarm-fetch the "
                         "latest checkpoint into --ckpt-dir and start "
                         "from it")
    ap.add_argument("--join-mode", default="blocking",
                    choices=["blocking", "stream"],
                    help="blocking: the fetch completes before step 0; "
                         "stream: gossip + background chunk streaming "
                         "under the inner phases, adopted at the first "
                         "outer boundary where the chain is assembled")
    ap.add_argument("--events", default=None)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def build_trainer(args):
    """The trainer that ``args`` (from ``build_parser``) describe."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.diloco import DiLoCoConfig
    from repro_torch.core.fault_tolerance import (ClusterSimulator,
                                                  EventKind, NodeEvent)
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.registry import get_model
    from repro_torch.train.loop import ElasticTrainer, TrainerConfig

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is visible; "
                           "pass --device cpu to run on the CPU")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    model = get_model(cfg, args.device)
    h = args.inner_steps or 100
    tcfg = TrainerConfig(
        diloco=DiLoCoConfig(
            inner_steps=h, quant=args.quant, outer_lr=args.outer_lr,
            overlap=args.overlap, sync_buckets=args.sync_buckets,
            error_feedback=args.error_feedback),
        inner_lr=args.inner_lr, inner_chunks=args.inner_chunks,
        ckpt_dir=args.ckpt_dir, ckpt_engine=args.ckpt_engine,
        ckpt_delta_base_every=args.ckpt_base_every,
        ckpt_codec=args.ckpt_codec,
        max_workers=(args.max_workers if args.max_workers is not None
                     else max(args.workers * 2, args.workers + 2)))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                      batch_per_worker=args.batch_per_worker,
                      total_steps=args.outer_steps * h)
    events = [NodeEvent(step, EventKind(kind), nid)
              for step, kind, nid in json.loads(args.events or "[]")]
    sim = ClusterSimulator(list(range(args.workers)), events=events)
    return ElasticTrainer(model, tcfg, dcfg, model.init(args.seed), sim)


def parse_peers(spec: str) -> list[tuple[str, int]]:
    """``host:port,host:port`` -> [(host, port), ...] (host defaults to
    127.0.0.1)."""
    peers = []
    for hp in spec.split(","):
        host, _, port = hp.rpartition(":")
        peers.append((host or "127.0.0.1", int(port)))
    return peers


def join(args, trainer) -> dict | None:
    """``--join-from``: a blocking swarm recovery adopted now (returns
    its fetch stats), or a streaming join begun in the background
    (adopted by ``run()``; returns None)."""
    if not args.join_from:
        return None
    assert args.ckpt_dir, "--join-from needs --ckpt-dir"
    assert args.ckpt_engine != "flat", \
        "--join-from fetches into a chunk store; use --ckpt-engine " \
        "store|delta"
    peers = parse_peers(args.join_from)
    if args.join_mode == "stream":
        trainer.begin_stream_join(peers)
        print(f"streaming join from {len(peers)} peers "
              f"(gossip + background chunk streaming)")
        return None
    from repro_torch.checkpointing import recover
    tree, meta, stats = recover(peers, args.ckpt_dir,
                                trainer.checkpoint_like(),
                                device=trainer.device)
    trainer.adopt_checkpoint(tree, meta)
    print(f"joined via swarm: step {stats['step']}, "
          f"{stats['chunks_fetched']} chunks ({stats['bytes_fetched']} B) "
          f"from {len(stats['per_peer'])} peers "
          f"(reassigned={stats['reassigned_ranges']})")
    return stats


def serve_checkpoints(args, trainer):
    """``--serve-ckpt-port``: start serving the checkpoints (a
    ``CheckpointServer`` for the flat engine, else the chunk store's
    ``ChunkPeer``) and return it without blocking; ``close()`` stops
    it."""
    assert args.ckpt_dir, "--serve-ckpt-port needs --ckpt-dir"
    if args.ckpt_engine == "flat":
        from repro_torch.checkpointing import CheckpointServer
        peer = CheckpointServer(args.ckpt_dir, port=args.serve_ckpt_port)
        print(f"serving flat checkpoints on 127.0.0.1:{peer.port}")
    else:
        peer = trainer.serve_checkpoints(port=args.serve_ckpt_port)
        print(f"serving chunk store on 127.0.0.1:{peer.port}")
    return peer


def main(argv=None) -> dict:
    """Parse ``argv``, join if asked, train, print one JSON line per
    outer step, serve the checkpoints if asked (until interrupted) and
    return ``{"history", "trainer"}``."""
    args = build_parser().parse_args(argv)
    trainer = build_trainer(args)
    join(args, trainer)
    hist = trainer.run(args.outer_steps, inner_steps=args.inner_steps)
    for j in (h["stream_join"] for h in hist if "stream_join" in h):
        st = j.get("stats", {})
        print(f"stream join: admitted={j['admitted']} step={j.get('step')} "
              f"fetch={st.get('fetch_seconds', 0):.3f}s "
              f"chunks={st.get('chunks_fetched', 0)} "
              f"replayed_on_stream={st.get('replayed_on_stream', 0)}")
    if args.serve_ckpt_port is not None:
        peer = serve_checkpoints(args, trainer)
        print("(ctrl-C to stop)")
        try:
            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            peer.close()
    for rec in hist:
        print(json.dumps({k: v for k, v in rec.items()
                          if k != "ring_order"}, default=str))
    if args.overlap == "delayed":
        led = trainer.comm_ledger
        falls = sum(1 for h in hist if "sync_fallback" in h)
        print(f"overlapped sync: {led.hidden_fraction:.0%} of ring comm "
              f"hidden under the chunked inner phase ({len(led.records)} "
              f"windows, {falls} torn fallbacks)")
    bpe = {"int4": 0.5, "int8": 1.0, "fp32": 4.0}[args.quant]
    print(f"final loss: {hist[-1]['loss']:.4f}  bandwidth reduction vs "
          f"fp32 DP: {trainer.cfg.diloco.inner_steps * 4 / bpe:.0f}x")
    return {"history": hist, "trainer": trainer}


if __name__ == "__main__":
    main()
