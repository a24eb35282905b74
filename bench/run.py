"""Run one cell of ``BENCHMARK.json`` on the card this process sees and
print its result as the last line of standard output.

  python3 bench/run.py --workload <name> --seed <n> --seconds <s> \
      --trace <0|1>

Run from the root of a checkout. ``--trace 0`` prints the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics (the window
under ``torch.profiler``) with ``device.busy_s``, ``device.window_s``
and ``breakdown``. The numbers of the correctness check, each beside
its limit, close standard error and the result line (``checks``). The
run exits with 2, printing no result, without a CUDA device, and with
3 if modules of the JAX stack were loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the script's own folder goes first on the path; its modules are
# imported as ``bench.*``, never by their bare names
if sys.path and Path(sys.path[0]).resolve() == ROOT / "bench":
    sys.path.pop(0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"no program under {src}", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(src)]
    import torch

    from bench import harness
    cell = harness.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         device="cuda:0", t_start=T_START)
    # once the window has closed: nothing of the JAX stack may be loaded
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules of the JAX stack are loaded: {bad}",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
