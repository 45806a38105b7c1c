#!/usr/bin/env python3
"""The f32 flash kernel (``csrc/flash_attention.cu``) of this tree against
another tree's, and against PyTorch's scaled_dot_product_attention, at
the f32 operand sets of ``chip_smoke.py``, at (c) with 8 times the heads
(``c_x8``: how the time grows with the work) and at bf16 with gemma-2's
head dim of 256 (``g_bf16_d256``, which wgmma does not take).

    python3 scripts/flash_f32_probe.py [--other LABEL=PATH ...]
        [--sets NAME,...] [--calls N] [--out PATH]

Builds this tree's ``flash_attention.cu`` and each ``--other`` source
(e.g. ``parent=_parent/src/repro_torch/kernels/csrc/flash_attention.cu``,
a ``git archive`` of the parent commit) alone into
``build/flash_f32_probe/`` with the package's ``nvcc`` flags, and calls
each library's ``pir_flash_attention_fwd`` (one C signature for all). At
each operand set it holds this tree's kernel against
``flash_attention_plain`` (``chip_smoke.py``'s tolerance: 1e-5 in f32;
the others' errors are reported) and times the kernels and SDPA in
turns, the order forward then backward (parent, this, sdpa, sdpa, this,
parent): the card's time of one call (torch.profiler, the sum of the
card's events over ``--calls`` calls; a tenth as many at 32 768 tokens)
and CUDA events over the same calls. Prints a JSON line a set and one of
the builds' registers and spills, and writes all to ``--out``. Needs a
CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels._common import stream_ptr  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_plain,
)

# chip_smoke.py's FLASH_TOL
TOL = {torch.float32: {"rtol": 1e-5, "atol": 1e-5},
       torch.bfloat16: {"rtol": 8e-3, "atol": 1e-3}}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
F32, BF16 = torch.float32, torch.bfloat16
# label -> (bh, s, d, causal, window, rows held against the plain version,
# operand type)
SETS = {
    "c_bert4rec": (64, 200, 32, False, None, 64, F32),
    "c_x8": (512, 200, 32, False, None, 64, F32),
    "e_lm_f32_check": (9, 256, 64, True, None, 9, F32),
    "f_lm_prefill_f32": (36, 4096, 64, True, None, 36, F32),
    "b_lm_prefill_window_1024_f32": (36, 4096, 64, True, 1024, 36, F32),
    "d_lm_prefill_32k_f32": (9, 32768, 64, True, None, 1, F32),
    # bf16 at a head dim wgmma does not take: gemma-2's 256
    "g_bf16_d256": (8, 2048, 256, True, None, 8, BF16),
}


def build(label, source):
    out = ROOT / "build" / "flash_f32_probe" / f"{label}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
           str(_build.CSRC), str(source), "-o", str(out)]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def load(path, source):
    """The library's entry point. A source from before the query offset and
    the softcap (no ``q_offset`` in it) takes two arguments fewer; either
    gets no offset and no cap."""
    fn = ctypes.CDLL(str(path)).pir_flash_attention_fwd
    argtypes = list(_build._SIGNATURES["pir_flash_attention_fwd"])
    new_abi = "q_offset" in Path(source).read_text()
    if not new_abi:
        del argtypes[10:12]
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    fn.extra = (0, 0.0) if new_abi else ()
    return fn


def caller(fn, q, k, v, causal, window):
    bh, sq, d = q.shape
    win = -1 if window is None or window >= sq else window
    out = torch.empty_like(q)

    def call():
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  bh, sq, k.shape[1], d, int(causal), win, *fn.extra,
                  DTYPE_CODES[q.dtype], stream_ptr(q.device))
        if code != 0:
            raise RuntimeError(f"pir_flash_attention_fwd returned {code}")
        return out
    return call


def turn(fn, calls):
    """(card ms, event ms) of one call, over ``calls`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / calls, start.elapsed_time(end) / calls


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", default=[],
                    help="LABEL=PATH of another flash_attention.cu")
    ap.add_argument("--sets", default=",".join(SETS))
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "flash_f32_probe.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_f32_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    sources = {}
    for item in args.other:
        label, path = item.split("=", 1)
        sources[label] = Path(path)
    sources["this"] = _build.CSRC / "flash_attention.cu"
    t0 = time.perf_counter()
    procs = {label: build(label, src) for label, src in sources.items()}
    fns, builds = {}, {}
    for label, (path, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{text}")
        builds[label] = _build._parse_ptxas(label, text)
        fns[label] = load(path, sources[label])
    report = {
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": time.perf_counter() - t0,
        "builds": {label: [{k: r[k] for k in ("entry", "registers",
                                                "smem_bytes",
                                                "spill_store_bytes")}
                           for r in recs]
                   for label, recs in builds.items()},
        "sets": {},
    }
    order = list(sources) + ["sdpa"]
    order += order[::-1]
    for name in args.sets.split(","):
        bh, s, d, causal, window, rows, dtype = SETS[name]
        g = torch.Generator(device=dev).manual_seed(s + d)
        q, k, v = (torch.randn((bh, s, d), generator=g, device=dev).to(dtype)
                   for _ in range(3))
        want = flash_attention_plain(q[:rows], k[:rows], v[:rows],
                                     causal=causal, window=window)
        runs = {label: caller(fn, q, k, v, causal, window)
                for label, fn in fns.items()}
        q4, k4, v4 = (t.unsqueeze(0) for t in (q, k, v))
        if window is None:
            runs["sdpa"] = lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal)
        else:
            pos = torch.arange(s, device=dev)
            band = ((pos[None, :] <= pos[:, None])
                    & (pos[None, :] > pos[:, None] - window))
            runs["sdpa"] = lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=band)
        line = {"shape": {"bh": bh, "s": s, "d": d, "causal": causal,
                          "window": window, "dtype": str(dtype)[6:]},
                "max_abs_err": {}}
        for label in fns:
            got = runs[label]()[:rows].float()
            torch.cuda.synchronize()
            err = float((got - want.float()).abs().max())
            line["max_abs_err"][label] = err
            if label == "this" and not torch.allclose(got, want.float(),
                                                      **TOL[dtype]):
                raise AssertionError(f"{label} at {name} differs from the "
                                     f"plain version: {line}")
        del want
        calls = max(2, args.calls // 10) if s > 4096 else args.calls
        line["calls"] = calls
        line["turns"] = [[label, *turn(runs[label], calls)] for label in order]
        for label in runs:
            got = [t for t in line["turns"] if t[0] == label]
            line[label] = {"device_ms": [t[1] for t in got],
                           "event_ms": [t[2] for t in got]}
        report["sets"][name] = line
        print(json.dumps({name: line}), flush=True)
        del q, k, v, q4, k4, v4, runs
        torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps({k: report[k] for k in ("card", "torch", "cuda",
                                             "build_s", "builds")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
