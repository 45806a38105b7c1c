"""PIR serving launcher — run the engine against a synthetic database.

    PYTHONPATH=src python -m repro_torch.launch.serve --scheme sparse \
        --theta 0.25 --n 8192 --record-bytes 256 --d 10 --da 5 --queries 256

    # serve a LIVE store, one append delta of 64 records every 32 queries:
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --ingest-every 32 --ingest-rows 64

Runs on the CUDA card; ``--device cpu`` names the CPU explicitly. Prints
per-batch latency (host clock, ending in a device synchronisation),
throughput, the (ε, δ) price per query, and the engine's cumulative cost
metrics (records touched vs the Table-1 model). Every served batch is
checked against the store it was served from. Only the synchronous
submit+flush front is ported (the async front and ``--compact-depth``
are not).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch._device import resolve_device, synchronize
from repro_torch.core import SCHEMES, make_scheme
from repro_torch.core.accounting import PrivacyBudget
from repro_torch.data.pipeline import pir_delta_batch
from repro_torch.db import VersionedStore, make_synthetic_store
from repro_torch.kernels import registered_backends
from repro_torch.serve import BatchScheduler, ServingPipeline, ShardedBackend


def build_args() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scheme", default="sparse", choices=sorted(SCHEMES))
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--record-bytes", type=int, default=256)
    ap.add_argument("--d", type=int, default=10)
    ap.add_argument("--da", type=int, default=5)
    ap.add_argument("--theta", type=float, default=0.25)
    ap.add_argument("--p", type=int, default=100)
    ap.add_argument("--t", type=int, default=4)
    ap.add_argument("--u", type=int, default=1000)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--max-wait-ms", type=float, default=0.0)
    ap.add_argument("--eps-budget", type=float, default=float("inf"))
    ap.add_argument("--frontend", choices=["sync"], default="sync",
                    help="sync: submit+flush loop (the async front is not "
                         "ported yet)")
    ap.add_argument("--ingest-every", type=int, default=0,
                    help="serve a live VersionedStore and append one delta "
                         "every N queries served; 0 = frozen store")
    ap.add_argument("--ingest-rows", type=int, default=64,
                    help="records appended per ingest delta")
    ap.add_argument("--backend", default="auto",
                    choices=sorted(registered_backends()),
                    help="execution backend (repro_torch.kernels.backend "
                         "registry)")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card (an error "
                         "when there is none)")
    return ap


def make_engine(args) -> ServingPipeline:
    # the whole flag union goes through; the registry drops what the
    # chosen scheme does not declare (DESIGN.md §Scheme protocol)
    device = resolve_device(args.device)
    scheme = make_scheme(
        args.scheme,
        d=args.d,
        d_a=args.da,
        theta=args.theta,
        p=args.p - (args.p % args.d) or args.d,
        t=args.t,
        u=args.u,
    )
    store = make_synthetic_store(
        args.n, args.record_bytes, seed=0, device=device
    )
    # a live store serves through its frozen head; the backend is handed
    # the base snapshot
    served = (
        VersionedStore(store, backend=args.backend)
        if args.ingest_every > 0 else store
    )
    return ServingPipeline(
        served, scheme,
        scheduler=BatchScheduler(
            max_batch=args.batch, max_wait_s=args.max_wait_ms / 1e3
        ),
        backend=ShardedBackend(store, backend=args.backend, device=device),
        default_budget=lambda: PrivacyBudget(
            epsilon_limit=args.eps_budget, delta_limit=1.0
        ),
        device=device,
    )


def _feed_delta(args, engine: ServingPipeline, step: int) -> None:
    """One append delta of write traffic against the live store
    (deterministic in step, like the query stream)."""
    for delta in pir_delta_batch(
        engine.store.n, args.record_bytes,
        appends=args.ingest_rows, seed=2, step=step,
    ):
        engine.ingest(delta)


def run_sync(args, engine: ServingPipeline) -> None:
    rng = np.random.default_rng(1)
    served = 0
    ingest_step = 0
    t_start = time.perf_counter()
    while served < args.queries:
        if args.ingest_every and served >= ingest_step * args.ingest_every:
            _feed_delta(args, engine, ingest_step)
            ingest_step += 1
        nq = min(args.batch, args.queries - served)
        idx = rng.integers(0, args.n, size=nq)
        asked = {}
        for i, q in enumerate(idx):
            if not engine.submit(f"client-{i}", int(q)):
                print("budget refused a query; stopping")
                served = args.queries
                break
            asked[f"client-{i}"] = int(q)
        t0 = time.perf_counter()
        out = engine.flush()
        synchronize(engine.device)
        dt = time.perf_counter() - t0
        for client, q in asked.items():
            if not (out[client] == engine.store.record_bytes(q)).all():
                raise RuntimeError(f"wrong record for {client} (index {q})")
        served += nq
        print(f"batch of {nq:4d} served in {dt*1e3:7.1f} ms "
              f"({nq/dt:8.0f} qps), verified exact")
    wall = time.perf_counter() - t_start
    if args.ingest_every:
        print(f"live store: v{engine.store_version}, n={engine.store.n} "
              f"({engine.metrics['records_ingested']} records ingested "
              f"mid-traffic); last swap: {engine.backend.last_swap}")
    print(f"\n{served} queries in {wall:.2f}s; engine metrics: {engine.metrics}")


def main(argv=None) -> None:
    args = build_args().parse_args(argv)
    engine = make_engine(args)
    scheme = engine.scheme

    eps, delta = scheme.privacy(args.n)
    print(f"scheme={args.scheme} n={args.n} d={args.d} d_a={args.da} "
          f"frontend={args.frontend} device={engine.device}")
    print(f"eps/query={eps:.4g} delta/query={delta:.4g} "
          f"costs={scheme.costs(args.n)}")
    run_sync(args, engine)
    print(f"scheduler target batch: {engine.scheduler.target_batch}; "
          f"backend={engine.backend.backend_name} "
          f"paths: {engine.backend.path_counts}")


if __name__ == "__main__":
    main()
