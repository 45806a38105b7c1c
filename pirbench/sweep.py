"""Find the highest rate an open-loop cell's front sustains: for each seed
one set-up, then a window at each offered rate in turn, on the card.

    python3 pirbench/sweep.py --workload ct_sparse.online \\
        --seeds 11,12,13 --seconds 20 --rates 40,45,50

Each window offers Poisson arrivals at the rate, drawn from the seed and
the rate's place in the list (each seed a different draw), with the mix's
population. For each seed and rate it prints one JSON line: lookups sent
and answered in the window, the backlog (sent but not back) at the
window's middle and at its close, the p50/p95 latency from the scheduled
arrival, and whether the window sustained the rate: at least 98 % of the
lookups sent in the window came back in it, and the backlog at the close
exceeds the backlog at the middle by no more than one bucket
(``bucket_cap``). A mix's rate is set from these lines and from full runs
of its cell at candidate rates; ``PERF.md`` gives both.
"""

import argparse
import gc
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def backlog(sent, t: float) -> int:
    """Lookups sent by ``t`` and not back by then (shed ones included)."""
    return sum(1 for r in sent if r.sent <= t and (r.shed or not r.done <= t))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from pirbench import harness
    from pirbench.traffic import generator

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, ROOT)
    if cell.mix["loop"] != "open":
        print(f"{args.workload} is not an open loop", file=sys.stderr)
        return 2
    n = int(cell.config["n_records"])
    cap = int(cell.mix["bucket_cap"])
    rates = [float(r) for r in args.rates.split(",")]
    dev = torch.device("cuda")
    out = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            _, _, fe, _ = harness.set_up(cell, seed, dev, False)
            try:
                for k, rate in enumerate(rates):
                    line = window(harness, generator, cell, fe, n, cap, seed,
                                  k, rate, args.seconds)
                    line["card"] = torch.cuda.get_device_name(0)
                    print(json.dumps(line), flush=True)
                    if out:
                        out.write(json.dumps(line) + "\n")
                        out.flush()
            finally:
                fe.close(drain=False)
                del fe
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


def window(harness, generator, cell, fe, n: int, cap: int, seed: int,
           k: int, rate: float, seconds: float) -> dict:
    """One window at ``rate`` on the started front ``fe``."""
    # the zipf draw takes base_seed + 1: two apart, no window shares a draw
    mix = dict(cell.mix, base_seed=seed * 1000 + 2 * k,
               arrivals={"process": "poisson", "rate_qps": rate})
    sched = generator.open_schedule(mix, n, seconds, seed)
    t0 = time.perf_counter()
    sent = harness.open_loop(fe, sched, t0)
    rest = t0 + seconds - time.perf_counter()
    if rest > 0:
        time.sleep(rest)
    t1 = time.perf_counter()
    fe.drain(timeout=120)
    lat = [(r.done - r.due) if r.answer() is not None else float("inf")
           for r in sent]
    back = sum(1 for r in sent if r.answer() is not None and r.done <= t1)
    middle, close = backlog(sent, t0 + seconds / 2), backlog(sent, t1)
    return {"workload": cell.name, "seed": seed, "rate_qps": rate,
            "sent": len(sent), "answered_in_window": back,
            "answered_per_s": back / seconds,
            "backlog_middle": middle, "backlog_close": close,
            "sustained": back >= 0.98 * len(sent) and close - middle <= cap,
            "p50_ms": 1e3 * harness.percentile(lat, 50),
            "p95_ms": 1e3 * harness.percentile(lat, 95),
            "failed": sum(1 for r in sent if r.answer() is None)}


if __name__ == "__main__":
    sys.exit(main())
