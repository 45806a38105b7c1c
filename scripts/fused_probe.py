#!/usr/bin/env python3
"""Time a tree's fused Sparse-PIR kernels (``fused_gather_fold``,
``fused_multi_gather_fold``) at the shapes of ``PERF.md`` rows 4, 4', 5 and
5', so that two trees can be compared on one card.

    python3 scripts/fused_probe.py [--src DIR] [--label NAME]

Imports ``repro_torch`` from ``--src`` (default: this tree's ``src``; give
an unpacked older tree's ``src`` to time that one) and builds its kernels.
Two stores, random from seed 0: the reduced config's (2048 records of 64
bytes, W 16) and the widest slab the shared-memory gate admits at the CT
record (7264 records of 1536 bytes, W 384, block_w 8). On each, θ = 0.25
index rows from numpy masks (seed 7) at the Sparse-PIR budget: the flat
kernel at q 8 (the lookup path's batch) and q 32, the multi kernel at 8
requests of k_max 4, every row live (the multi path's layout). Each case
runs in both grid orders at the planner's block_w, is held bit for bit
against ``gather_xor``, and is timed with CUDA events (2 warm-ups, mean of
50) and by the card's own time of one call (torch.profiler over 20 calls:
every kernel the call launches, and the fused kernel's alone). In a tree
that has ``fused_schedule`` each staging path is also forced and timed, with
the schedule it ran. Prints one JSON object per case, then the card's name
and power limit. Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet


def time_ms(fn, warmup: int = 2, iters: int = 50) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, calls: int = 20):
    """The card's time of one call of ``fn`` (torch.profiler): all its
    kernels, and those whose name names a fused kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = mine = 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.end - e.time_range.start
        total += us
        if "fused" in e.name or "slab_kernel" in e.name:
            mine += us
    return total / 1e3 / calls, mine / 1e3 / calls


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fused_probe: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.db import make_synthetic_store
    from repro_torch.kernels import fused, ops
    from repro_torch.kernels.gather_xor import gather_xor, indices_from_mask

    dev = torch.device("cuda")
    theta, q_multi, k_max = 0.25, 8, 4
    budget = fused.fused_smem_budget(dev)
    rng = np.random.default_rng(7)
    for shape, n, rb in (("reduced", 2048, 64), ("gate", budget // 32, 1536)):
        db = make_synthetic_store(n, rb, seed=0, device=dev).packed
        w = db.shape[1]
        bw = fused.fused_block_w(n, w, device=dev)
        m = ops.sparse_index_budget(n, theta)
        for kind, rows in (("flat", 8), ("flat", 32),
                           ("multi", q_multi * k_max)):
            mask = torch.from_numpy((rng.random((rows, n), dtype=np.float32)
                                     < theta).astype(np.uint8)).to(dev)
            idx = indices_from_mask(mask, m)
            off = torch.arange(q_multi + 1, dtype=torch.int32,
                               device=dev) * k_max
            want = gather_xor(db, idx)
            distinct = int(torch.unique(idx[idx >= 0]).numel())
            bound = ((distinct * w * 4 + rows * m * 4 + rows * w * 4
                      + (4 * (q_multi + 1) if kind == "multi" else 0))
                     / HBM_BYTES_PER_S * 1e3)
            runs = []
            orders = ("qw", "wq") if kind == "flat" else ("rw", "wr")
            for go in orders:
                if kind == "flat":
                    def fn(go=go):
                        return fused.fused_gather_fold(
                            db, idx, block_w=bw, grid_order=go)
                else:
                    def fn(go=go):
                        return fused.fused_multi_gather_fold(
                            db, idx, off, k_max=k_max, block_w=bw,
                            grid_order=go)
                forms = [("wrapper", fn, None)]
                if hasattr(fused, "fused_schedule"):
                    for st in fused.STAGINGS:
                        try:
                            sched = fused.fused_schedule(
                                n, w, rows, bw, grid_order=go,
                                k_max=1 if kind == "flat" else k_max,
                                budget=budget, staging=st)
                        except ValueError:
                            continue
                        forms.append((st, lambda s=sched: fused._launch(
                            db, idx, None if kind == "flat" else off,
                            1 if kind == "flat" else k_max, s), sched))
                for form, f, sched in forms:
                    if not torch.equal(f(), want):
                        raise AssertionError(
                            f"{shape} {kind} {go} {form} != gather_xor")
                    dev_all, dev_kernel = device_ms(f)
                    run = {"grid_order": go, "form": form,
                           "ms": time_ms(f), "device_ms": dev_all,
                           "kernel_device_ms": dev_kernel}
                    if sched is not None:
                        run["schedule"] = {k: sched[k] for k in (
                            "cluster", "grid", "rows_per_cta",
                            "warps_per_row", "smem_bytes")}
                    runs.append(run)
            print(json.dumps({
                "label": args.label, "shape": shape, "kernel": kind,
                "n": n, "W": w, "rows": rows, "m": m, "block_w": bw,
                "distinct_rows": distinct, "bound_ms": bound, "runs": runs,
            }), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
