#!/usr/bin/env python3
"""Both flash kernels of this tree against another tree's, bit for bit,
at ``chip_smoke.py``'s capless operand sets (a)–(f) and (h): a change that
adds an option or an instance to a kernel must leave the outputs without
it as they were.
When both trees take the softcap and the query offset, its sets with
them, (g)–(o), are held and timed too.

    python3 scripts/flash_parent_bits.py --other _parent/src/repro_torch/kernels/csrc

Builds ``flash_attention.cu`` and ``flash_attention_wgmma.cu`` of this
tree and of the other ``csrc`` directory (e.g. a ``git archive`` of the
parent commit unpacked into the ignored ``_parent/``), four ``nvcc`` at
once into ``build/flash_parent_bits/``, with the package's flags. Each
operand set is made as ``chip_smoke.py``'s ``check_flash`` makes it (a
generator on the card seeded with ``sq + d``) and goes to the same
kernel in both trees: bf16 at d 64 and 128 to wgmma, f32 to
``flash_attention.cu``, the bf16 sets cast to f32 as well, and bf16 at d
256 ((g), (g')) to ``flash_attention.cu``'s bf16 instance, which both
trees have (the wrapper now sends it to wgmma's d-256 instance, which a
tree from before it lacks; ``scripts/flash256_probe.py`` times the two
routes). Both trees' kernels are timed
in turns (other, this, this, other, ``--rounds`` times over: CUDA events,
2 warm-ups, the mean of 10 calls a turn); ``--sets`` keeps the named
sets only. A source from before the query offset and the softcap
(no ``q_offset`` in it) takes two arguments fewer; this tree's get no
offset and no cap, and the sets (g)–(o) are left out. Prints one JSON line a set, the builds' registers and
spills, and a summary; exits 1 when any output differs. Needs a CUDA
device and ``nvcc``.
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

BF16, F32 = torch.bfloat16, torch.float32
# chip_smoke.py's flash operand sets (a)-(f): bh, s, d, dtype, causal, window
SETS = {
    "a_lm_prefill": (36, 4096, 64, BF16, True, None),
    "b_lm_prefill_window_1024": (36, 4096, 64, BF16, True, 1024),
    "c_bert4rec": (64, 200, 32, F32, False, None),
    "d_lm_prefill_32k": (9, 32768, 64, BF16, True, None),
    "e_lm_f32_check": (9, 256, 64, F32, True, None),
    "f_lm_prefill_f32": (36, 4096, 64, F32, True, None),
    "h_nemo_prefill": (128, 4096, 128, BF16, True, None),
}
# its sets with a cap or an offset, in their own type only: bh, sq, sk, d,
# dtype, causal, window, softcap, q_offset
CAPPED_SETS = {
    "g_gemma2_prefill": (16, 8192, 8192, 256, BF16, True, None, 50.0, 0),
    "g2_gemma2_prefill_window_4096": (16, 8192, 8192, 256, BF16, True, 4096,
                                      50.0, 0),
    "h2_lm_prefill_cap_50": (36, 4096, 4096, 64, BF16, True, None, 50.0, 0),
    **{f"o_offset_{str(dt)[6:]}_d{d}_window_{w}": (16, 256, 1280, d, dt,
                                                   True, w, 0.0, 1024)
       for dt, d in ((BF16, 64), (F32, 256)) for w in (None, 512)},
}
ENTRY = {"flash_attention.cu": "pir_flash_attention_fwd",
         "flash_attention_wgmma.cu": "pir_flash_attention_wgmma"}


def build(label, csrc, source):
    out = ROOT / "build" / "flash_parent_bits" / f"{label}_{source}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
           str(csrc), str(csrc / source), "-o", str(out)]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def load(path, csrc, source):
    fn = getattr(ctypes.CDLL(str(path)), ENTRY[source])
    argtypes = list(_build._SIGNATURES[ENTRY[source]])
    new_abi = "q_offset" in (csrc / source).read_text()
    if not new_abi:
        del argtypes[10:12]  # the offset and the cap
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    fn.new_abi = new_abi
    return fn


def time_ms(fn, iters=10):
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


def run(fn, source, q, k, v, causal, window, out=None, sync=True, cap=0.0,
        off=0):
    bh, sq, d = q.shape
    out = torch.empty_like(q) if out is None else out
    win = -1 if window is None or window >= off + sq else window
    extra = (off, cap) if fn.new_abi else ()
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, sq,
            k.shape[1], d, int(causal), win, *extra]
    if source == "flash_attention.cu":
        args.append(0 if q.dtype == F32 else 1)
    code = fn(*args, stream_ptr(q.device))
    if code != 0:
        raise RuntimeError(f"{source} returned {code}")
    if sync:
        torch.cuda.synchronize()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True,
                    help="the other tree's src/repro_torch/kernels/csrc")
    ap.add_argument("--sets", default="",
                    help="comma-separated set names (default: all)")
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds of turns (other, this, this, other)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_parent_bits: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    trees = {"this": _build.CSRC, "other": Path(args.other).resolve()}
    procs = {(label, src): (csrc, build(label, csrc, src))
             for label, csrc in trees.items() for src in ENTRY}
    fns, builds = {}, {}
    for key, (csrc, (path, proc)) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{text}")
        fns[key] = load(path, csrc, key[1])
        builds["/".join(key)] = [
            {k: e[k] for k in ("entry", "registers", "spill_store_bytes",
                               "spill_load_bytes")}
            for e in _build._parse_ptxas(key[1], text)]
    print(json.dumps({"builds": builds}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    differ = 0
    sets = {name: (bh, s, s, d, dtype, causal, window, 0.0, 0)
            for name, (bh, s, d, dtype, causal, window) in SETS.items()}
    if all(f.new_abi for f in fns.values()):
        sets.update(CAPPED_SETS)
    if args.sets:
        sets = {k: v for k, v in sets.items() if k in args.sets.split(",")}
    for name, (bh, s, sk, d, dtype, causal, window, cap, off) in sets.items():
        g = torch.Generator(device=dev).manual_seed(s + d)
        q, k, v = (torch.randn((bh, n, d), generator=g, device=dev).to(dtype)
                   for n in (s, sk, sk))
        operands = [(dtype, (q, k, v))]
        if dtype == BF16 and name in SETS:
            operands.append((F32, tuple(t.float() for t in (q, k, v))))
        kw = {"cap": cap, "off": off}
        for dt, qkv in operands:
            src = ("flash_attention_wgmma.cu" if dt == BF16 and d in (64, 128)
                   else "flash_attention.cu")
            outs = {label: run(fns[(label, src)], src, *qkv, causal, window,
                               **kw)
                    for label in trees}
            same = bool(torch.equal(outs["this"].view(torch.int16 if dt == BF16
                                                      else torch.int32),
                                    outs["other"].view(torch.int16 if dt == BF16
                                                       else torch.int32)))
            differ += not same
            diff = float((outs["this"].float() - outs["other"].float())
                         .abs().max())
            ms = {label: [] for label in trees}
            for label in ("other", "this", "this", "other") * args.rounds:
                out = outs[label]
                ms[label].append(time_ms(
                    lambda f=fns[(label, src)], o=out: run(
                        f, src, *qkv, causal, window, out=o, sync=False,
                        **kw)))
            print(json.dumps({"set": name, "dtype": str(dt)[6:],
                              "source": src, "bit_identical": same,
                              "max_abs_diff": diff, "ms_this": ms["this"],
                              "ms_other": ms["other"]}), flush=True)
            del outs
    print(json.dumps({"flash_parent_bits": "done", "card": card,
                      "sets_differing": differ}), flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
