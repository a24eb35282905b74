"""Async decentralized RL launcher (port of ``repro.launch.rl``): trainer
+ publisher + rollout fleet in one process, with the reward trend,
staleness ledger and adoption bit-exactness printed at exit.

  PYTHONPATH=src python -m repro_torch.launch.rl --device cpu \\
      --outer-steps 8 --workers 2 --groups 6 --kill-at 2 --rejoin-at 4

Workers re-adopt on staggered strides (``--adopt-strides``), so the
fleet genuinely spans policy versions; ``--kill-at``/``--rejoin-at``
crash and rejoin one worker mid-run; ``--force-retire-at`` tombstones
an old version and exercises the typed retired-version fallback.

It runs on the GPU (``--device cuda``, the default): the GRPO trainer's
int8 ring and every policy delta go through the hand-written codec
kernels, and the rollouts through the flash-decode kernel. As the reference
it runs the preset's ``reduced()`` sibling; ``--full`` keeps the
preset's width and ``--n-layers`` cuts its depth (``launch.train``'s
``--n-layers``). The launcher exits non-zero when an adopted policy is
not bit-identical to the published one.
"""
from __future__ import annotations

import argparse
import tempfile


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.rl")
    ap.add_argument("--arch", default="internlm2-1.8b",
                    help="preset name; the launcher runs its reduced() "
                         "unless --full")
    ap.add_argument("--full", action="store_true",
                    help="the preset's full width (default: reduced())")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--outer-steps", type=int, default=8)
    ap.add_argument("--inner-steps", type=int, default=3)
    ap.add_argument("--groups", type=int, default=6)
    ap.add_argument("--group-size", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=10)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--lr", type=float, default=2e-2)
    ap.add_argument("--max-policy-lag", type=int, default=1)
    ap.add_argument("--stale-mode", default="drop",
                    choices=["drop", "downweight"])
    ap.add_argument("--codec", default="int8", choices=["int8", "int4"])
    ap.add_argument("--base-every", type=int, default=4)
    ap.add_argument("--adopt-strides", type=int, nargs="+",
                    default=[1, 3])
    ap.add_argument("--kill-at", type=int, default=None)
    ap.add_argument("--rejoin-at", type=int, default=None)
    ap.add_argument("--force-retire-at", type=int, default=None)
    ap.add_argument("--root", default=None,
                    help="fleet store root (default: a temp dir)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> dict:
    """Parse ``argv``, run the RL loop, print the exit summary and return
    it; raise ``SystemExit`` if an adoption was not bit-exact."""
    args = build_parser().parse_args(argv)
    import torch

    from repro_torch.rl import RLConfig, RLDriver

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is visible; "
                           "pass --device cpu to run on the CPU")
    cfg = RLConfig(
        arch=args.arch, reduced=not args.full, n_layers=args.n_layers,
        device=args.device, n_workers=args.workers,
        outer_steps=args.outer_steps, inner_steps=args.inner_steps,
        n_groups=args.groups, group_size=args.group_size,
        prompt_len=args.prompt_len, max_new=args.max_new,
        seq_len=args.prompt_len + args.max_new,
        temperature=args.temperature, inner_lr=args.lr,
        max_policy_lag=args.max_policy_lag, stale_mode=args.stale_mode,
        codec=args.codec, base_every=args.base_every,
        adopt_strides=tuple(args.adopt_strides),
        kill_at=args.kill_at, rejoin_at=args.rejoin_at,
        force_retire_at=args.force_retire_at, seed=args.seed)

    def run(root):
        drv = RLDriver(cfg, root)
        try:
            return drv.run()
        finally:
            drv.close()

    if args.root:
        s = run(args.root)
    else:
        with tempfile.TemporaryDirectory() as td:
            s = run(td)

    led = s["ledger"]
    print(f"rl workers={args.workers} outer_steps={s['outer_steps']} "
          f"versions={s['versions_published']} "
          f"rollout_tokens={s['rollout_tokens']} "
          f"tok/s={s['rollout_tok_s']:.1f}")
    print(f"reward {s['reward_first']:.3f}->{s['reward_last']:.3f} "
          f"trend={['%.3f' % r for r in s['reward_trend']]}")
    print(f"staleness generated={led['generated']} "
          f"accepted={led['accepted']} "
          f"dropped_stale={led['dropped_stale']} "
          f"drop_frac={s['stale_drop_fraction']:.2f} "
          f"max_lag={led['max_accepted_lag']} "
          f"mean_lag={s['mean_accepted_lag']:.2f}")
    print(f"adoptions={s['adoptions']} "
          f"mean_adopt_s={s['mean_adopt_s']:.3f} "
          f"adopt_bytes={s['adopt_bytes']} "
          f"retired_fallbacks={s['retired_fallbacks']} "
          f"live_versions={s['live_versions']}")
    print(f"bit_identical_to_publisher={s['bit_exact']}")
    if not s["bit_exact"]:
        raise SystemExit("adopted policy diverged from published anchor")
    return s


if __name__ == "__main__":
    main()
