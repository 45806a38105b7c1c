"""Read the numbers behind a cell's ``correct`` on many seeds in one
process, for the program as the configuration states it or, with
``--control``, for the control the configuration names (its ``control``
entry: the program switched to a lower guarantee). The benchmark's own
runs never run the control.

    python3 pirbench/readings.py --workload ct_sparse.online \\
        --seeds 101,102,103 --seconds 5 [--control]

Prints one JSON line a seed: ``correct`` and every number compared with
its limit. The limits are set from these readings: above the largest
the program gives, below the smallest its control gives.
"""

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from pirbench import harness
    from pirbench.run import finite

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, ROOT)
    overrides = None
    if args.control:
        overrides = {k: v for k, v in cell.config["control"].items()
                     if k != "why"}
    out = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            res = harness.run(cell, seed, args.seconds, False,
                              overrides=overrides,
                              log=lambda s: print(s, file=sys.stderr))
            line = finite({"workload": args.workload, "seed": seed,
                           "control": overrides, "correct": res["correct"],
                           "attempted": res["attempted"],
                           "failed": res["failed"],
                           "metrics": res["metrics"],
                           "memory_peak_bytes":
                               res["device"]["memory_peak_bytes"],
                           "limits": res["limits"]})
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
            torch.cuda.reset_peak_memory_stats()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
