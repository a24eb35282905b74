"""The dry run's tables (port of ``repro.analysis.report``) from the
JSON cells ``launch/dryrun.py`` writes, with the H100 constants of
``analysis.roofline`` in the titles.

    PYTHONPATH=src python -m repro_torch.analysis.report
"""
from __future__ import annotations

import json
import pathlib

from repro_torch.analysis.roofline import HBM_BW, LINK_BW, PEAK_FLOPS
from repro_torch.configs import ASSIGNED, SHAPES

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" \
    / "dryrun_torch"
HBM_GIB = 80          # H100 SXM


def load_cells(mesh: str, out_dir: pathlib.Path = OUT_DIR) -> dict:
    cells = {}
    for arch in ASSIGNED:
        for shape in SHAPES:
            p = out_dir / mesh / arch / f"{shape}.json"
            if p.exists():
                cells[(arch, shape)] = json.loads(p.read_text())
    return cells


def _fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def _peak(cell_step: dict) -> int:
    return cell_step["memory"].get("peak_live_bytes", 0)


def roofline_table(mesh: str = "single",
                   out_dir: pathlib.Path = OUT_DIR) -> str:
    cells = load_cells(mesh, out_dir)
    lines = [
        f"### Roofline — {mesh}-pod mesh "
        f"({'512' if mesh == 'multi' else '256'} H100 SXM: "
        f"{PEAK_FLOPS/1e12:.0f} TF/s bf16 dense, {HBM_BW/1e12:.2f} TB/s "
        f"HBM3, {LINK_BW/1e9:.0f} GB/s NVLink 4; memory term from "
        f"unfused bytes, an upper bound)",
        "",
        "| arch | shape | step | compute | memory | collective | "
        "bottleneck | MODEL/traced flops | roofline MFU bound | "
        f"peak GiB/rank | fits {HBM_GIB}G |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for (arch, shape), cell in sorted(cells.items()):
        if "skipped" in cell:
            lines.append(
                f"| {arch} | {shape} | — | — | — | — | skipped | — | — "
                f"| — | ({cell['skipped']}) |")
        for tag in ("train_step", "serve_step", "sync_step"):
            if tag not in cell:
                continue
            r = cell[tag]["roofline"]
            mem = _peak(cell[tag])
            fits = "yes" if mem <= HBM_GIB * 2**30 else \
                f"NO ({mem/2**30:.0f}G)"
            lines.append(
                f"| {arch} | {shape} | {tag.split('_')[0]} | "
                f"{_fmt_s(r['compute_s'])} | {_fmt_s(r['memory_s'])} | "
                f"{_fmt_s(r['collective_s'])} | {r['bottleneck']} | "
                f"{r['useful_ratio']:.2f} | {r['mfu']:.3f} | "
                f"{mem/2**30:.2f} | {fits} |")
    return "\n".join(lines)


def summary(mesh: str, out_dir: pathlib.Path = OUT_DIR) -> str:
    cells = load_cells(mesh, out_dir)
    skipped = sum(1 for c in cells.values() if "skipped" in c)
    over = [k for k, c in cells.items() if any(
        _peak(c[t]) > HBM_GIB * 2**30
        for t in ("train_step", "serve_step", "sync_step") if t in c)]
    return (f"{mesh}: {len(cells) - skipped} traced, {skipped} skipped "
            f"(documented), {len(over)} cells over {HBM_GIB} GiB/rank: "
            f"{over}")


if __name__ == "__main__":
    for mesh in ("single", "multi"):
        print(summary(mesh))
        print()
        print(roofline_table(mesh))
        print()
