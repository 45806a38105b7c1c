#!/usr/bin/env python3
"""Time a tree's ``gather_xor`` and ``indices_from_mask`` at the CT store's
Sparse-PIR shapes, so that two trees can be compared on one card.

    python3 scripts/gather_xor_probe.py [--src DIR] [--label NAME]

Imports ``repro_torch`` from ``--src`` (default: this tree's ``src``; give
an unpacked older tree's ``src`` to time that one) and builds its kernels.
On the CT store (10^6 records of 1536 bytes, random from seed 0) and
θ = 0.25 masks at batches of 8 (the lookup path), 32 (the multi-index
path's flat bucket) and 1, it times with CUDA events (2 warm-ups, mean of
10): ``gather_xor`` on the ascending ids the compaction emits (block_w
128, grid order "qwm") and on the same ids shuffled within each row,
``indices_from_mask`` at the Sparse-PIR budget, and ``xor_fold`` on the
same masks; each gather is checked bit for bit against ``xor_fold``. The
card's own time of one ``gather_xor`` and one ``indices_from_mask`` call,
summed over the kernels each launches, comes from ``torch.profiler``.
Prints one JSON object per batch, then the card's name and power limit.
Needs a CUDA device and ``nvcc``.
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


def time_ms(fn, warmup: int = 2, iters: int = 10) -> float:
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


def device_ms(fn, calls: int = 10) -> float:
    """The card's kernel time of one call of ``fn`` (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / calls


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gather_xor_probe: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.db import make_synthetic_store
    from repro_torch.kernels import ops
    from repro_torch.kernels.gather_xor import gather_xor, indices_from_mask
    from repro_torch.kernels.xor_fold import xor_fold

    dev = torch.device("cuda")
    n, rb, theta = 10**6, 1536, 0.25
    db = make_synthetic_store(n, rb, seed=0, device=dev).packed
    w = db.shape[1]
    m = ops.sparse_index_budget(n, theta)
    rng = np.random.default_rng(7)
    for q in (8, 32, 1):
        mask = torch.from_numpy(
            (rng.random((q, n), dtype=np.float32) < theta).astype(np.uint8)
        ).to(dev)
        idx = indices_from_mask(mask, m)
        g = torch.Generator(device=dev).manual_seed(q)
        perm = torch.argsort(torch.rand(idx.shape, generator=g, device=dev),
                             dim=1)
        shuffled = torch.gather(idx, 1, perm).contiguous()
        fold = xor_fold(db, mask)
        for ids in (idx, shuffled):
            if not torch.equal(gather_xor(db, ids), fold):
                raise AssertionError(f"gather_xor q={q} != xor_fold")
        distinct = int(torch.unique(idx[idx >= 0]).numel())
        print(json.dumps({
            "label": args.label, "q": q, "n": n, "W": w, "m": m,
            "distinct_rows": distinct,
            "gather_xor_ms": time_ms(lambda: gather_xor(db, idx)),
            "gather_xor_device_ms": device_ms(lambda: gather_xor(db, idx)),
            "gather_xor_shuffled_ms": time_ms(
                lambda: gather_xor(db, shuffled)),
            "gather_bound_ms": (distinct * w * 4 + q * m * 4 + q * w * 4)
            / HBM_BYTES_PER_S * 1e3,
            "indices_from_mask_ms": time_ms(
                lambda: indices_from_mask(mask, m)),
            "indices_from_mask_device_ms": device_ms(
                lambda: indices_from_mask(mask, m)),
            "indices_bound_ms": (q * n + q * m * 4) / HBM_BYTES_PER_S * 1e3,
            "xor_fold_ms": time_ms(lambda: xor_fold(db, mask)),
        }), flush=True)
        del mask, idx, shuffled, perm, fold
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
