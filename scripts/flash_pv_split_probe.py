#!/usr/bin/env python3
"""What splitting P into bf16 hi + lo halves buys in the tensor-core flash
kernel (``csrc/flash_attention_wgmma.cu``).

    python3 scripts/flash_pv_split_probe.py [--out PATH]

Builds that source twice into ``build/flash_pv_split_probe/``: as the
package builds it (O += hi·V + lo·V) and with the lo half dropped
(``-DFLASH_WGMMA_PV_LO=0``: P rounded once to bf16). Both are held against
``flash_attention_plain`` on the same operands: ``chip_smoke.py``'s bf16
operand sets (a), (b) and (d) and the card tests' sweep
(``tests/test_torch_cuda.py::test_wgmma_flash_kernel_matches_plain``). For
each variant it reports the largest error, the elements outside the bf16
tolerance (rtol 8e-3, atol 1e-3), the least atol that would hold at that
rtol, and the time of each operand set (CUDA events). Prints one JSON
object and writes it to ``--out``. Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels._common import stream_ptr  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402

RTOL, ATOL = 8e-3, 1e-3  # chip_smoke.py's FLASH_TOL for bf16
VARIANTS = {"hi_lo": [], "hi_only": ["-DFLASH_WGMMA_PV_LO=0"]}
# chip_smoke.py's operand sets: label -> (bh, s, causal, window, plain rows)
SETS = {"a_lm_prefill": (36, 4096, True, None, 36),
        "b_lm_prefill_window_1024": (36, 4096, True, 1024, 36),
        "d_lm_prefill_32k": (9, 32768, True, None, 1)}
SWEEP_LENGTHS = [(1, 70), (70, 1), (129, 129), (300, 500), (500, 300),
                 (70, 129), (500, 500)]
SWEEP_WINDOWS = [None, 1, 63, 64, 65, 127, 128, 129, 1024]


def build(name, flags):
    out = ROOT / "build" / "flash_pv_split_probe" / f"{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._find_nvcc(), *_build.NVCC_FLAGS, *flags, "-shared",
           str(_build.CSRC / "flash_attention_wgmma.cu"), "-o", str(out)]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def load(path):
    lib = ctypes.CDLL(str(path))
    fn = lib.pir_flash_attention_wgmma
    fn.argtypes = list(_build._SIGNATURES["pir_flash_attention_wgmma"])
    fn.restype = ctypes.c_int
    return fn


def run(fn, q, k, v, causal, window):
    out = torch.empty_like(q)
    bh, sq, d = q.shape
    win = -1 if window is None or window >= sq else window
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh,
              sq, k.shape[1], d, int(causal), win, 0, 0.0,
              stream_ptr(q.device))
    if code != 0:
        raise RuntimeError(f"pir_flash_attention_wgmma returned {code}")
    return out


def compare(got, want):
    """Largest error, elements outside (RTOL, ATOL), and the least atol that
    holds every element at RTOL."""
    diff = (got.float() - want.float()).abs()
    slack = diff - RTOL * want.float().abs()
    return {"max_abs_err": float(diff.max()),
            "outside_tol": int((slack > ATOL).sum()),
            "atol_needed": max(float(slack.max()), 0.0)}


def time_ms(fn, iters=10):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def operands(bh, sq, sk, d, seed, dev, on_host):
    """q, k, v as chip_smoke.py makes them (a generator on the card) or as
    the card tests do (on the host, then moved)."""
    g = torch.Generator(device="cpu" if on_host else dev).manual_seed(seed)
    return tuple(torch.randn((bh, s, d), generator=g, device=g.device)
                 .to(device=dev, dtype=torch.bfloat16) for s in (sq, sk, sk))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/flash_pv_split_probe/result.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_pv_split_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    builds = {n: build(n, f) for n, f in VARIANTS.items()}
    fns = {}
    for n, (path, proc) in builds.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {n}:\n{text}")
        fns[n] = load(path)
    result = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0],
        "tolerance": {"rtol": RTOL, "atol": ATOL}, "sets": {}, "sweep": {}}

    for label, (bh, s, causal, window, rows) in SETS.items():
        q, k, v = operands(bh, s, s, 64, s + 64, dev, False)
        want = flash_attention_plain(q[:rows], k[:rows], v[:rows],
                                     causal=causal, window=window)
        entry = {}
        for n, fn in fns.items():
            got = run(fn, q, k, v, causal, window)[:rows]
            entry[n] = {**compare(got, want), "ms": time_ms(
                lambda: run(fn, q, k, v, causal, window),
                iters=3 if s > 4096 else 10)}
        result["sets"][label] = entry
        del q, k, v, want
        torch.cuda.empty_cache()

    sweep = {n: {"cases": 0, "cases_outside_tol": 0, "outside_tol": 0,
                 "max_abs_err": 0.0, "atol_needed": 0.0} for n in fns}
    for d in (64, 128):
        for sq, sk in SWEEP_LENGTHS:
            for causal in (True, False):
                for window in SWEEP_WINDOWS:
                    bh = 36 if sq == sk == 129 else 3
                    q, k, v = operands(bh, sq, sk, d, sq + 7 * sk + d,
                                       dev, True)
                    want = flash_attention_plain(q, k, v, causal=causal,
                                                 window=window)
                    for n, fn in fns.items():
                        c = compare(run(fn, q, k, v, causal, window), want)
                        agg = sweep[n]
                        agg["cases"] += 1
                        agg["cases_outside_tol"] += int(c["outside_tol"] > 0)
                        agg["outside_tol"] += c["outside_tol"]
                        for key in ("max_abs_err", "atol_needed"):
                            agg[key] = max(agg[key], c[key])
    result["sweep"] = sweep
    text = json.dumps(result)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
