"""Fleet load-harness driver — open-loop traffic + live fault injection
against the serving pipeline (DESIGN.md §Fleet harness).

    # 500 qps Poisson for 2 s over a 4-replica Sparse-PIR deployment,
    # killing replica 3's heartbeats at t = 0.8 s:
    PYTHONPATH=src python -m repro_torch.launch.fleet --rate 500 \
        --duration 2 --d 4 --da 2 --kill-replica 3 --kill-at 0.8

    # bursty overload against a bounded queue (sheds at the door):
    PYTHONPATH=src python -m repro_torch.launch.fleet --arrivals bursty \
        --rate 400 --burst-qps 3000 --queue-limit 512

Runs on the CUDA card; ``--device cpu`` names the CPU explicitly. Prints
the scenario's SLO summary (p50/p95/p99 latency, goodput, refusal and
shed rates, max queue depth) and — when replicas were lost — the remesh
plus the *accounted* ε degradation next to the post-loss price.
"""

from __future__ import annotations

import argparse

from repro_torch._device import resolve_device
from repro_torch.core import SCHEMES, make_scheme
from repro_torch.db import make_synthetic_store
from repro_torch.fleet import (
    BurstyArrivals,
    ClientPopulation,
    DiurnalArrivals,
    FaultEvent,
    FleetScenario,
    PoissonArrivals,
    run_scenario,
)
from repro_torch.serve import (
    BatchScheduler,
    QueryCache,
    ServingPipeline,
    ShardedBackend,
)


def build_args() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scheme", default="sparse", choices=sorted(SCHEMES))
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--record-bytes", type=int, default=64)
    ap.add_argument("--d", type=int, default=4)
    ap.add_argument("--da", type=int, default=2)
    ap.add_argument("--theta", type=float, default=0.25)
    ap.add_argument("--p", type=int, default=16)
    ap.add_argument("--t", type=int, default=2)
    ap.add_argument("--u", type=int, default=1000)
    ap.add_argument("--arrivals", default="poisson",
                    choices=["poisson", "bursty", "diurnal"])
    ap.add_argument("--rate", type=float, default=500.0,
                    help="qps: Poisson rate / bursty base / diurnal mean")
    ap.add_argument("--burst-qps", type=float, default=0.0,
                    help="bursty peak rate (default 5x --rate)")
    ap.add_argument("--duration", type=float, default=2.0)
    ap.add_argument("--clients", type=int, default=1000)
    ap.add_argument("--budget-queries", type=int, nargs=2, default=None,
                    metavar=("LO", "HI"),
                    help="per-client allowance in queries at the healthy "
                         "price, drawn uniform [LO, HI]; omit = unlimited")
    ap.add_argument("--kill-replica", type=int, action="append", default=[],
                    help="replica id to silence (repeatable)")
    ap.add_argument("--kill-at", type=float, action="append", default=[],
                    help="when to silence it, seconds (pairs with "
                         "--kill-replica by position; default 0.4*duration)")
    ap.add_argument("--heartbeat-timeout", type=float, default=0.1)
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--max-wait-ms", type=float, default=10.0)
    ap.add_argument("--queue-limit", type=int, default=8192)
    ap.add_argument("--shed", choices=["reject", "block"], default="reject")
    ap.add_argument("--cache-entries", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card (an error "
                         "when there is none)")
    return ap


def make_arrivals(args):
    if args.arrivals == "bursty":
        return BurstyArrivals(
            base_qps=args.rate,
            burst_qps=args.burst_qps or 5.0 * args.rate,
            period_s=max(0.25, args.duration / 4.0),
        )
    if args.arrivals == "diurnal":
        return DiurnalArrivals(mean_qps=args.rate, period_s=args.duration)
    return PoissonArrivals(args.rate)


def main(argv=None) -> None:
    args = build_args().parse_args(argv)
    device = resolve_device(args.device)
    scheme = make_scheme(
        args.scheme, d=args.d, d_a=args.da, theta=args.theta,
        p=args.p - (args.p % args.d) or args.d, t=args.t, u=args.u,
    )
    store = make_synthetic_store(
        args.n, args.record_bytes, seed=0, device=device
    )
    pipe = ServingPipeline(
        store, scheme,
        backend=ShardedBackend(store, device=device),
        device=device,
        scheduler=BatchScheduler(
            max_batch=args.max_batch, max_wait_s=args.max_wait_ms / 1e3,
            target_latency_s=10.0,
        ),
        cache=(
            QueryCache(scheme, store.n, max_entries=args.cache_entries)
            if args.cache_entries > 0 else None
        ),
    )
    faults = tuple(
        FaultEvent(
            args.kill_at[i] if i < len(args.kill_at) else 0.4 * args.duration,
            replica,
        )
        for i, replica in enumerate(args.kill_replica)
    )
    scenario = FleetScenario(
        name=f"{args.arrivals}_{'loss' if faults else 'healthy'}",
        arrivals=make_arrivals(args),
        duration_s=args.duration,
        faults=faults,
        heartbeat_timeout_s=args.heartbeat_timeout,
        seed=args.seed,
    )
    population = ClientPopulation(
        n_clients=args.clients, n_records=store.n,
        budget_queries=tuple(args.budget_queries) if args.budget_queries else None,
        seed=args.seed,
    )
    eps0, delta0 = pipe.price
    print(f"scenario={scenario.name} scheme={args.scheme} d={args.d} "
          f"d_a={args.da} healthy price eps={eps0:.4g} delta={delta0:.4g}")
    report = run_scenario(
        scenario, pipe, population,
        queue_limit=args.queue_limit, shed_policy=args.shed, device=device,
    )
    print(f"\n{report.arrivals} arrivals over {report.wall_s:.2f}s wall")
    for k, v in sorted(report.slo.items()):
        print(f"  {k:16s} {v:10.3f}")
    if report.remeshes:
        print(f"\nremeshes={report.remeshes} "
              f"unserviceable={report.unserviceable}")
        print(f"  accounted degradation: {report.degraded}")
        print(f"  post-loss price: eps={report.price[0]:.4g} "
              f"delta={report.price[1]:.4g}")
    print(f"\nreport: {report.to_json()}")


if __name__ == "__main__":
    main()
