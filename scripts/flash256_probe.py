#!/usr/bin/env python3
"""gemma-2's bf16 attention at head dim 256 on its two routes, in turns on
one card: the f32 kernel's bf16 instance (``csrc/flash_attention.cu``,
3xTF32 on ``mma.sync``: where bf16 at d 256 went before the wgmma kernel
took that head dim) against the wgmma kernel's d-256 instance
(``csrc/flash_attention_wgmma.cu``).

    python3 scripts/flash256_probe.py [--iters N] [--out PATH]

The package's library (``_build.library()``, built from this tree) holds
both routes: ``pir_flash_attention_fwd`` with the bf16 type code, and
``pir_flash_attention_wgmma``. ptxas's registers and spills of the d-256
instances are reported when this process built the library.

At ``chip_smoke.py``'s (g) and (g') (2 x 8 heads, 8192 tokens, causal, cap
50; (g') with the 4096-token window; operands made as ``check_flash``
makes them) every route is held against ``flash_attention_plain``
(``chip_smoke.py``'s bf16 tolerance, rtol 8e-3 atol 1e-3) and timed with
CUDA events (2 warm-ups, the mean of ``--iters`` calls) in turns, the
order forward then backward, so each route has two times. Each time is
given beside the bound (4·d flops a unmasked pair at the bf16 peak, or
the bytes at the memory rate). Prints one JSON line a set and one of the
build, and writes all to ``--out``. Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels._common import stream_ptr  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_pairs, flash_attention_plain,
)

TOL = {"rtol": 8e-3, "atol": 1e-3}  # chip_smoke.py's FLASH_TOL for bf16
BF16_FLOPS_PER_S, HBM_BYTES_PER_S = 989e12, 3.35e12  # H100 SXM, dense
D, CAP = 256, 50.0
# chip_smoke.py's sets: label -> (bh, s, window)
SETS = {"g_gemma2_prefill": (16, 8192, None),
        "g2_gemma2_prefill_window_4096": (16, 8192, 4096)}
D256 = "flash_wgmma_kernelILi256E"  # the d-256 instances' mangled names


def entry(lib, name):
    fn = getattr(lib, name)
    fn.argtypes = list(_build._SIGNATURES[name])
    fn.restype = ctypes.c_int
    return fn


def route(fn, wgmma):
    """A call of one route: (q, k, v, out, window) -> out."""
    def call(q, k, v, out, window):
        bh, sq, d = q.shape
        win = -1 if window is None or window >= sq else window
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh,
                sq, k.shape[1], d, 1, win, 0, CAP]
        if not wgmma:
            args.append(1)  # flash_attention.cu's bf16 type code
        code = fn(*args, stream_ptr(q.device))
        if code != 0:
            raise RuntimeError(f"{fn.__name__} returned {code}")
        return out
    return call


def time_ms(fn, iters):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(bh, s, window):
    flops = 4.0 * bh * attention_pairs(s, s, True, window) * D
    nbytes = bh * 4 * s * D * 2
    return max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default="build/flash256_probe/result.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash256_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    lib = _build.library()
    report = _build.build_report()
    routes = {"parent_route_flash_attention_cu": route(
                  entry(lib, "pir_flash_attention_fwd"), False),
              "wgmma_d256": route(entry(lib, "pir_flash_attention_wgmma"),
                                  True)}
    build = [{k: e[k] for k in ("entry", "registers", "spill_store_bytes",
                                "spill_load_bytes")}
             for e in report["kernels"] if D256 in e["entry"]]
    result = {"card": card, "tolerance": TOL, "build": build, "sets": {}}
    print(json.dumps({"card": card, "build": build}), flush=True)

    for label, (bh, s, window) in SETS.items():
        g = torch.Generator(device=dev).manual_seed(s + D)
        q, k, v = (torch.randn((bh, s, D), generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        want = flash_attention_plain(q, k, v, causal=True, window=window,
                                     softcap=CAP).float()
        entry_ = {"shape": {"bh": bh, "sq": s, "sk": s, "d": D,
                            "causal": True, "window": window, "softcap": CAP},
                  "bound_ms": bound_ms(bh, s, window), "routes": {}}
        outs = {}
        for name, call in routes.items():
            out = call(q, k, v, torch.empty_like(q), window)
            torch.cuda.synchronize()
            diff = (out.float() - want).abs()
            entry_["routes"][name] = {
                "max_abs_err": float(diff.max()),
                "within_tolerance": bool(torch.allclose(out.float(), want,
                                                        **TOL)),
                "ms": []}
            outs[name] = out
        del want
        order = list(routes) + list(reversed(routes))
        for name in order:
            out = outs[name]
            entry_["routes"][name]["ms"].append(time_ms(
                lambda c=routes[name], o=out: c(q, k, v, o, window),
                args.iters))
        for r in entry_["routes"].values():
            r["ms_mean"] = float(np.mean(r["ms"]))
            r["share_of_bound"] = entry_["bound_ms"] / r["ms_mean"]
        result["sets"][label] = entry_
        print(json.dumps({"set": label, **entry_}), flush=True)
        del q, k, v, outs
        torch.cuda.empty_cache()
    bad = [(label, name) for label, e in result["sets"].items()
           for name, r in e["routes"].items() if not r["within_tolerance"]]
    result["outside_tolerance"] = bad
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result) + "\n")
    print(json.dumps({"flash256_probe": "done", "card": card,
                      "outside_tolerance": bad}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
