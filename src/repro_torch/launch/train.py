"""Training launcher (port of ``repro.launch.train``): the elastic PRIME
protocol with k stacked DiLoCo workers in one process, synchronous and
fault-free — H inner AdamW steps per worker, then the int8 ring
all-reduce (the hand-written codec kernels on the GPU) and the Nesterov
outer step.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --reduced --workers 2 --outer-steps 2 --inner-steps 2

It runs on the GPU (``--device cuda``, the default). ``--max-workers``
sets the number of stacked slots (default: the reference's
``max(2w, w+2)``). Options of the reference that are not ported yet
(``--overlap delayed``, ``--inner-chunks`` > 1, ``--error-feedback``,
int4, ``--events``, checkpoints, joining and serving checkpoints) raise.
"""
from __future__ import annotations

import argparse
import json


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
    ap.add_argument("--join-from", default=None)
    ap.add_argument("--serve-ckpt-port", type=int, default=None)
    ap.add_argument("--events", default=None)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def build_trainer(args):
    """The trainer that ``args`` (from ``build_parser``) describe."""
    for flag, value in (("--events", args.events),
                        ("--ckpt-dir", args.ckpt_dir),
                        ("--join-from", args.join_from),
                        ("--serve-ckpt-port", args.serve_ckpt_port)):
        if value is not None:
            raise NotImplementedError(f"{flag} is not ported yet")

    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.diloco import DiLoCoConfig
    from repro_torch.core.fault_tolerance import ClusterSimulator
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
        max_workers=(args.max_workers if args.max_workers is not None
                     else max(args.workers * 2, args.workers + 2)))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                      batch_per_worker=args.batch_per_worker,
                      total_steps=args.outer_steps * h)
    sim = ClusterSimulator(list(range(args.workers)))
    return ElasticTrainer(model, tcfg, dcfg, model.init(args.seed), sim)


def main(argv=None) -> dict:
    """Parse ``argv``, train, print one JSON line per outer step and
    return ``{"history", "trainer"}``."""
    args = build_parser().parse_args(argv)
    trainer = build_trainer(args)
    hist = trainer.run(args.outer_steps, inner_steps=args.inner_steps)
    for rec in hist:
        print(json.dumps({k: v for k, v in rec.items()
                          if k != "ring_order"}, default=str))
    bpe = {"int4": 0.5, "int8": 1.0, "fp32": 4.0}[args.quant]
    print(f"final loss: {hist[-1]['loss']:.4f}  bandwidth reduction vs "
          f"fp32 DP: {trainer.cfg.diloco.inner_steps * 4 / bpe:.0f}x")
    return {"history": hist, "trainer": trainer}


if __name__ == "__main__":
    main()
