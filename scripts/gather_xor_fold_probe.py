#!/usr/bin/env python3
"""What the per-query fold costs in the gather kernel
(``csrc/gather_xor.cu``) at the CT store's Sparse-PIR shapes.

    python3 scripts/gather_xor_fold_probe.py

Builds that source twice into ``build/gather_xor_fold_probe/``: as the
package builds it, and with ``-DPIR_GATHER_FOLD=0``, which keeps every
row's staging (the prep pass, the query sets, the live-row list, the
``cp.async`` ring and its barriers, the combine) but drops the XORs of the
staged rows into the queries' accumulators. On the CT store (10^6 records
of 1536 bytes, random from seed 0) and θ = 0.25 masks at batches of 8 and
32, it times both with CUDA events (2 warm-ups, mean of 10) on the ascending
ids the compaction emits, and checks the package's build bit for bit
against ``xor_fold``. Prints one JSON object per batch, then the card's
name and power limit. Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.db import make_synthetic_store  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels._common import stream_ptr  # noqa: E402
from repro_torch.kernels.gather_xor import (  # noqa: E402
    gather_schedule, indices_from_mask,
)
from repro_torch.kernels.xor_fold import xor_fold  # noqa: E402

VARIANTS = {"as_built": [], "no_fold": ["-DPIR_GATHER_FOLD=0"]}


def build(out_dir: Path):
    """{variant: (the library's pir_gather_xor, ptxas registers)}."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, flags in VARIANTS.items():
        lib = out_dir / f"{name}.so"
        cmd = [_build._find_nvcc(), *_build.NVCC_FLAGS, *flags, "-shared",
               str(_build.CSRC / "gather_xor.cu"), "-o", str(lib)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        fn = ctypes.CDLL(str(lib)).pir_gather_xor
        fn.argtypes = list(_build._SIGNATURES["pir_gather_xor"])
        fn.restype = ctypes.c_int
        fns[name] = (fn, [int(r) for r in re.findall(r"Used (\d+) registers",
                                                     text)])
    return fns


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


def main() -> int:
    if not torch.cuda.is_available():
        print("gather_xor_fold_probe: no CUDA device available",
              file=sys.stderr)
        return 2
    fns = build(ROOT / "build" / "gather_xor_fold_probe")
    dev = torch.device("cuda")
    n, rb, theta, block_w = 10**6, 1536, 0.25, 128
    db = make_synthetic_store(n, rb, seed=0, device=dev).packed
    w = db.shape[1]
    m = ops.sparse_index_budget(n, theta)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(7)
    for q in (8, 32):
        mask = torch.from_numpy(
            (rng.random((q, n), dtype=np.float32) < theta).astype(np.uint8)
        ).to(dev)
        idx = indices_from_mask(mask, m)
        sched = gather_schedule(n, w, q, m, block_w, sms)
        out = torch.zeros((q, w), dtype=torch.int32, device=dev)
        scratch = torch.zeros(q * (sched["ranges"] + 2), dtype=torch.int32,
                              device=dev)
        line = {"q": q, "n": n, "W": w, "m": m, "block_w": block_w, **sched}
        for name, (fn, regs) in fns.items():
            def run():
                out.zero_()
                scratch.zero_()
                code = fn(db.data_ptr(), idx.data_ptr(), out.data_ptr(),
                          scratch.data_ptr(), n, w, q, m, block_w,
                          sched["rows"], sched["ranges"],
                          sched["walk_chunks"], sched["walk_per"], 1,
                          stream_ptr(dev))
                if code != 0:
                    raise RuntimeError(f"{name}: cudaError {code}")
            run()
            if name == "as_built" and not torch.equal(out,
                                                      xor_fold(db, mask)):
                raise AssertionError(f"as_built q={q} != xor_fold")
            line[f"{name}_ms"] = time_ms(run)
            line[f"{name}_registers"] = regs
        print(json.dumps(line), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
