"""Roofline analysis over the port's dry-run records (the reference's
``launch/roofline.py``, at the H100's peaks).

For every (arch × shape × mesh) JSON that :mod:`repro_torch.launch.dryrun`
writes, derive the three per-step roofline terms on one card:

    compute    = flops_per_device          / 989e12  (bf16 dense, tensor cores)
    memory     = bytes_accessed_per_device / 3.35e12 (HBM3)
    collective = coll_bytes_per_device     / 450e9   (NVLink 4, one direction)

They are bounds from the data sheet's peaks, not measurements. The
records are already per device (``dryrun.py`` says how each is made). A
mesh of 256 or 512 cards spans many NVLink domains of 8; the slower
network between them is not modelled, so the collective term is a lower
bound. The dominant term is the bottleneck; step-time lower bound =
max(term); and

    roofline_fraction = (model_flops / chips / 989e12) / max(term)

i.e. what fraction of the no-overlap roofline step is useful model math.
MODEL_FLOPS/counted flops is also reported (remat/redundancy waste).
``fits_hbm`` holds a cell's bytes per device against the card's memory.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.roofline
        [--dir results/dryrun_torch] [--write results/roofline_torch.md]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

# NVIDIA H100 80GB HBM3, 700 W (nvidia-smi's name and power limit on the
# machine with the card): the data sheet's dense bf16 tensor-core peak
PEAK_FLOPS = 989e12
# NVIDIA H100 80GB HBM3, 700 W: the data sheet's HBM3 bandwidth, B/s
HBM_BW = 3.35e12
# NVIDIA H100 80GB HBM3, 700 W: NVLink 4, 900 GB/s both ways, per direction
LINK_BW = 450e9
# NVIDIA H100 80GB HBM3, 700 W: torch.cuda.get_device_properties(0)
# .total_memory there (torch 2.11.0+cu128), bytes
HBM_BYTES = 85_017_493_504

DEFAULT_DIR = os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "results", "dryrun_torch"
)

__all__ = ["load_cells", "roofline_row", "render_markdown", "main"]


def load_cells(d: str, include_iterations: bool = False) -> List[Dict]:
    out = []
    for f in sorted(glob.glob(os.path.join(d, "*.json"))):
        if not include_iterations and "__it" in os.path.basename(f):
            continue  # perf-iteration artifacts are not in the table
        with open(f) as fh:
            out.append(json.load(fh))
    return out


def roofline_row(rec: Dict) -> Dict:
    chips = rec["chips"]
    t_comp = rec["flops"] / PEAK_FLOPS
    t_mem = rec["bytes_accessed"] / HBM_BW
    t_coll = rec["collectives"]["total_bytes"] / LINK_BW
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    useful = rec["model_flops"] / chips / PEAK_FLOPS
    frac = useful / bound if bound > 0 else 0.0
    counted_total = rec["flops"] * chips
    return {
        "arch": rec["arch"],
        "shape": rec["shape"],
        "mesh": rec["mesh"],
        "chips": chips,
        "t_compute_s": t_comp,
        "t_memory_s": t_mem,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "step_lower_bound_s": bound,
        "roofline_fraction": frac,
        "model_over_counted_flops": (
            rec["model_flops"] / counted_total if counted_total else 0.0
        ),
        "mem_gib": rec["bytes_per_device"] / 2**30,
        "fits_hbm": rec["bytes_per_device"] <= HBM_BYTES,
    }


def _fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def render_markdown(rows: List[Dict], skips: List[Dict]) -> str:
    lines = [
        "| arch | shape | mesh | compute | memory | collective | dominant | "
        "roofline frac | model/counted | mem/dev | fits HBM |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {_fmt_s(r['t_compute_s'])} | {_fmt_s(r['t_memory_s'])} "
            f"| {_fmt_s(r['t_collective_s'])} | **{r['dominant']}** "
            f"| {r['roofline_fraction']:.3f} "
            f"| {r['model_over_counted_flops']:.2f} "
            f"| {r['mem_gib']:.2f} GiB | {'yes' if r['fits_hbm'] else 'NO'} |"
        )
    if skips:
        lines.append("")
        lines.append("Skipped cells (per brief):")
        for s in skips:
            lines.append(
                f"- {s['arch']} × {s['shape']} × {s['mesh']}: {s['skip_reason']}"
            )
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.normpath(DEFAULT_DIR))
    ap.add_argument("--write", default=None)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    cells = load_cells(args.dir)
    rows = [roofline_row(c) for c in cells if c.get("ok") is True]
    skips = [c for c in cells if c.get("ok") == "skipped"]
    rows.sort(key=lambda r: (r["arch"], r["shape"], r["mesh"]))
    md = render_markdown(rows, skips)
    print(md)

    worst = sorted(rows, key=lambda r: r["roofline_fraction"])[:5]
    print("\nworst roofline fractions:")
    for r in worst:
        print(f"  {r['arch']} × {r['shape']} × {r['mesh']}: "
              f"{r['roofline_fraction']:.4f} ({r['dominant']}-bound)")
    coll = sorted(
        rows, key=lambda r: r["t_collective_s"] / max(r["step_lower_bound_s"], 1e-12),
        reverse=True,
    )[:5]
    print("\nmost collective-bound:")
    for r in coll:
        print(f"  {r['arch']} × {r['shape']} × {r['mesh']}: "
              f"coll {_fmt_s(r['t_collective_s'])} of {_fmt_s(r['step_lower_bound_s'])}")

    if args.write:
        os.makedirs(os.path.dirname(args.write) or ".", exist_ok=True)
        with open(args.write, "w") as f:
            f.write(md + "\n")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
