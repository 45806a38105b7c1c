"""Run one cell of the port's benchmark once, on the card this machine holds.

    python3 pirbench/run.py --workload ct_sparse.online --seed 7 \\
        --seconds 30 --trace 0

The last line of standard output is the result, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device``, with ``--trace 1`` a ``breakdown`` of the traced window, and
last ``limits``: every number ``correct`` compared, beside its limit. The
same numbers end standard error. Exits non-zero with no result when no
CUDA card (or too few) is present, when the files of the program are not
beside the benchmark, or when JAX or the JAX package was loaded.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the JAX package and JAX may load nowhere in this process (compared by
# whole top-level module names: the port's own name begins with the JAX
# package's)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (a table of module
    names; this process's ``sys.modules`` by default)."""
    names = list(sys.modules if modules is None else modules)
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)


def finite(x):
    """JSON numbers only: a value that is not finite (a lookup that never
    came back, a gap against a charge of zero) becomes a string."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"the program is not beside the benchmark ({src})",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(src)]
    from pirbench import harness

    cell = harness.load_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2

    def log(line):
        print(line, file=sys.stderr, flush=True)

    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         started=STARTED, log=log)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process, and must not be: {bad}",
              file=sys.stderr)
        return 3
    if args.trace:
        limits = result.pop("limits")
        result["card"] = card_line()
        result["limits"] = limits
        log("card: " + result["card"])
    for name, c in result["limits"].items():
        log(f"{name}: {c['value']} (limit {c['rule']} {c['limit']})")
    sys.stdout.flush()
    print(json.dumps(finite(result)), flush=True)
    return 0


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi not read ({exc})"
    return out.stdout.strip().splitlines()[0]


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
