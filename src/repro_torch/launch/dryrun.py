"""The multi-pod dry run: the reference's ``launch/dryrun.py`` on
``meta`` tensors.

For every (architecture × input shape × mesh) cell: build the cell on
``torch.device("meta")`` inside ``mesh_rules`` of the production mesh's
shape on meta positions (:func:`repro_torch.launch.mesh.make_dryrun_mesh`:
256 or 512 of them), run ``cell.fn(*cell.args)`` once under
:func:`repro_torch.launch.op_cost.count_cost`, and write a record per cell
to ``--out`` (``results/dryrun_torch/*.json``, not committed).
:mod:`repro_torch.launch.roofline` reads them. Nothing is allocated and no
card is needed; no XLA flag is set and no JAX is imported.

The reference compiles each cell into one SPMD program a device and reads
its cost per device. Nothing partitions the port's model program: one
controller runs the whole cell, and only the port's mesh branches (the
PIR butterfly, the vocab-sharded lookups, the MoE expert blocks, the GCN's
aggregation) loop over the mesh's positions. So a record's per-device
numbers follow three rules:

* ``flops`` and ``bytes_accessed`` are the counted totals of the whole
  run ÷ ``chips``: the work of every position, spread evenly.
* ``collectives`` are taken as counted: each collective reports the bytes
  at one position (``dist/collectives.py``), as the reference counts them
  per device.
* ``bytes_per_device`` is the arguments' bytes at one position, exact
  from each argument's sanitized spec (the block ``device_put`` would give
  it), plus the counted ``peak_bytes`` of the run ÷ ``chips``.

The model cells report only the collectives that the port's mesh branches
run by hand: the LM and recsys cells the vocab-sharded lookups' (and
Moonlight's and Kimi-K2's MoE blocks') all-reduces, the full-graph GCN
cells the aggregation's all-gather and reduce-scatter. The tensor- and
data-parallel collectives that XLA inserts into the reference's model
programs (activation all-reduces, FSDP all-gathers, gradient
reduce-scatters) have no counterpart in the single-controller port, so
these cells' collective bytes are far below the reference's. The PIR
``xorbfly`` cells report the butterfly's collective-permutes, as the
reference does.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gcn-cora \\
        --shape full_graph_sm --mesh single --out /tmp/dryrun_torch --force
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.configs import get_arch, list_archs
from repro_torch.dist.sharding import DEFAULT_RULES, MULTIPOD_RULES, mesh_rules
from repro_torch.launch.cells import _map_shardings
from repro_torch.launch.cells import build_cell_sanitized as build_cell
from repro_torch.launch.cells import rules_for_cell
from repro_torch.launch.mesh import make_dryrun_mesh
from repro_torch.launch.op_cost import count_cost

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

__all__ = ["run_cell", "iter_cells", "arg_bytes_per_position", "main"]


def arg_bytes_per_position(args, shardings) -> int:
    """Bytes of one position's blocks of ``args`` under their (sanitized)
    ``shardings``: each tensor's bytes ÷ the mesh-axis product of every
    dim its spec shards. A Python scalar argument counts 0."""
    total = []

    def one(sh, arg):
        if not isinstance(arg, torch.Tensor):
            return sh
        mesh, spec = sh
        split = 1
        for part in spec:
            if part is None:
                continue
            for a in ((part,) if isinstance(part, str) else part):
                split *= mesh.shape[a]
        total.append(arg.numel() * arg.element_size() // split)
        return sh

    for sh, arg in zip(shardings, args):
        _map_shardings(one, sh, arg)
    return int(sum(total))


def run_cell(arch_id: str, sp, multi_pod: bool, out_dir: str, force=False,
             tag_suffix: str = ""):
    mesh_name = "multipod_2x16x16" if multi_pod else "pod_16x16"
    tag = f"{arch_id}__{sp.name}__{mesh_name}{tag_suffix}"
    path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            rec = json.load(f)
        if rec.get("ok"):  # failures are always retried (they are bugs)
            print(f"[cached] {tag}: ok={rec.get('ok')}")
            return rec

    rec = {
        "arch": arch_id, "shape": sp.name, "kind": sp.kind, "mesh": mesh_name,
        "chips": 512 if multi_pod else 256, "ok": False,
    }
    t0 = time.time()
    try:
        mesh = make_dryrun_mesh(multi_pod=multi_pod)
        chips = mesh.size
        base = MULTIPOD_RULES if multi_pod else DEFAULT_RULES
        rules = dict(base, **rules_for_cell(sp, multi_pod=multi_pod))
        with mesh_rules(mesh, rules):
            cell = build_cell(arch_id, sp, device="meta")
            if cell.skip_reason:
                rec.update(ok="skipped", skip_reason=cell.skip_reason)
                _write(path, rec)
                print(f"[skip]   {tag}: {cell.skip_reason}")
                return rec

            t1 = time.time()
            cost = count_cost(cell.fn, *cell.args)
            count_s = time.time() - t1
            args_dev = arg_bytes_per_position(cell.args, cell.in_shardings)

        live = args_dev + cost.peak_bytes / chips
        rec.update(
            ok=True,
            count_s=round(count_s, 2),
            flops=cost.flops / chips,
            bytes_accessed=cost.bytes / chips,
            collectives={
                "bytes": dict(cost.coll_bytes),
                "counts": dict(cost.coll_counts),
                "total_bytes": cost.total_collective_bytes,
            },
            memory={
                "argument_size_in_bytes": args_dev,
                "temp_size_in_bytes": int(cost.peak_bytes / chips),
                "peak_bytes": int(cost.peak_bytes),
            },
            bytes_per_device=int(live),
            model_flops=cell.model_flops,
            kernels=dict(cost.kernels),
        )
        print(
            f"[ok]     {tag}: count={count_s:.1f}s "
            f"mem/dev={live/2**30:.2f}GiB flops/dev={rec['flops']:.3g} "
            f"coll/dev={cost.total_collective_bytes:.3g}B"
        )
    except Exception as e:  # record the failure — dry-run bugs are bugs
        rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        print(f"[FAIL]   {tag}: {type(e).__name__}: {e}")
    _write(path, rec)
    return rec


def _write(path, rec):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def iter_cells(arch_filter="all", shape_filter=None):
    for arch_id in list_archs():
        if arch_filter not in ("all", arch_id):
            continue
        mod = get_arch(arch_id)
        for sp in mod.SHAPES:
            if shape_filter and sp.name != shape_filter:
                continue
            yield arch_id, sp


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=os.path.normpath(RESULTS_DIR))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="", help="suffix for perf-iteration runs")
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    n_ok = n_fail = n_skip = 0
    for arch_id, sp in iter_cells(args.arch, args.shape):
        for multi_pod in meshes:
            rec = run_cell(arch_id, sp, multi_pod, args.out, force=args.force,
                           tag_suffix=args.tag)
            if rec["ok"] == "skipped":
                n_skip += 1
            elif rec["ok"]:
                n_ok += 1
            else:
                n_fail += 1
    print(f"\ndry-run complete: {n_ok} ok, {n_skip} skipped, {n_fail} FAILED")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
