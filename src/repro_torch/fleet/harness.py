"""The fleet harness: one scenario = open-loop traffic + SLOs + faults
over the real serving path (DESIGN.md §Fleet harness).

:func:`run_scenario` is the one-call entry: wrap a
:class:`~repro_torch.serve.engine.ServingPipeline` in an
:class:`~repro_torch.serve.frontend.AsyncFrontend`, install the population's
per-client budgets, replay the scenario's arrival schedule in real time,
tick the fault injector between submits, drain, and report.

Latency is measured from each query's *scheduled arrival*, not from the
moment the driver got around to submitting it — the open-loop discipline
again: if the driver (or the frontend's admission) falls behind, that
lag is queueing delay the client would have seen and belongs in the
percentiles, not silently subtracted (coordinated omission).

Replica loss mid-run goes through the production signal path only: the
injector silences heartbeats → the :class:`~repro_torch.dist.fault.
HeartbeatMonitor` detects the edge → ``pipeline.degrade_replicas``
remeshes and re-prices ε. The report carries the accounted degradation
(``degraded``, ``price``) next to the SLOs, so a scenario's output is
simultaneously a performance row and a privacy claim, which
tests/test_torch_fleet.py and ``chip_smoke.py``'s fleet phase hold against
:func:`~repro_torch.dist.fault.pir_degraded_privacy`.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.dist.fault import HeartbeatMonitor
from repro_torch.fleet.clients import ClientPopulation
from repro_torch.fleet.injector import FaultEvent, FaultInjector
from repro_torch.fleet.metrics import SLOCollector
from repro_torch.serve import AsyncFrontend, BackpressureError, ServingPipeline

__all__ = ["FleetScenario", "FleetReport", "FleetHarness", "run_scenario"]


@dataclasses.dataclass(frozen=True)
class FleetScenario:
    """One named run: an arrival process, a duration, a fault script —
    and, for write-heavy scenarios (DESIGN.md §13), a deterministic
    delta schedule: every ``ingest_every_s`` the harness enqueues one
    :func:`~repro_torch.data.pipeline.pir_delta_batch` step (``ingest_appends``
    appends / ``ingest_updates`` updates / ``ingest_deletes``
    tombstones) through the frontend's idle-slot ingest path. Requires
    the pipeline to serve a live
    :class:`~repro_torch.db.live.VersionedStore`."""

    name: str
    arrivals: Any  # PoissonArrivals | BurstyArrivals | DiurnalArrivals
    duration_s: float = 2.0
    faults: Tuple[FaultEvent, ...] = ()
    heartbeat_timeout_s: float = 0.1
    sample_every: int = 32  # gauge-sampling cadence, in arrivals
    seed: int = 0
    ingest_every_s: float = 0.0  # 0 = read-only scenario
    ingest_appends: int = 0
    ingest_updates: int = 0
    ingest_deletes: int = 0
    #: idle-slot delta-log compaction threshold for the frontend
    #: (DESIGN.md §13); 0 = compaction off
    compact_log_depth: int = 0

    def __post_init__(self):
        if self.duration_s <= 0:
            raise ValueError(f"need duration_s > 0, got {self.duration_s}")
        if self.heartbeat_timeout_s <= 0:
            raise ValueError(
                f"need heartbeat_timeout_s > 0, got {self.heartbeat_timeout_s}"
            )
        if self.sample_every < 1:
            raise ValueError(f"need sample_every >= 1, got {self.sample_every}")
        if self.ingest_every_s < 0:
            raise ValueError(
                f"need ingest_every_s >= 0, got {self.ingest_every_s}"
            )
        if self.ingest_every_s > 0 and not (
            self.ingest_appends or self.ingest_updates or self.ingest_deletes
        ):
            raise ValueError(
                "write-heavy scenario needs at least one of ingest_appends/"
                "ingest_updates/ingest_deletes > 0"
            )
        if self.compact_log_depth < 0:
            raise ValueError(
                f"need compact_log_depth >= 0, got {self.compact_log_depth}"
            )


@dataclasses.dataclass
class FleetReport:
    """Everything one scenario run produced: SLOs + the privacy ledger."""

    scenario: str
    wall_s: float
    arrivals: int
    slo: Dict[str, float]
    price: Tuple[float, float]      # the pipeline's final (ε, δ) per query
    degraded: Optional[Dict[str, float]]  # pir_degraded_privacy dict, if any
    remeshes: int
    unserviceable: bool
    frontend_metrics: Dict[str, float]
    timeline: List[Dict[str, float]]

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d.pop("timeline")  # summary row; the timeline is a separate CSV
        return json.dumps(d, sort_keys=True, default=str)


class FleetHarness:
    """Drives one scenario against one started frontend."""

    def __init__(
        self,
        frontend: AsyncFrontend,
        population: ClientPopulation,
        scenario: FleetScenario,
        *,
        collector: Optional[SLOCollector] = None,
    ):
        self.frontend = frontend
        self.population = population
        self.scenario = scenario
        self.collector = collector or SLOCollector()
        pipe = frontend.pipeline
        if scenario.ingest_every_s > 0 and pipe.live is None:
            raise ValueError(
                f"scenario {scenario.name!r} schedules write traffic but "
                "the pipeline serves a frozen store; construct it over a "
                "VersionedStore"
            )
        self._next_ingest_s = scenario.ingest_every_s
        self._ingest_steps = 0
        self.injector: Optional[FaultInjector] = None
        if scenario.faults:
            monitor = HeartbeatMonitor(
                pipe.staged.d,
                heartbeat_timeout_s=scenario.heartbeat_timeout_s,
            )
            monitor.on_failure(
                lambda newly_dead, alive: pipe.degrade_replicas(newly_dead)
            )
            self.injector = FaultInjector(monitor, scenario.faults)

    def _tick(self, now_s: float) -> None:
        if self.injector is not None:
            self.injector.tick(now_s)
        self._maybe_ingest(now_s)

    def _maybe_ingest(self, now_s: float) -> None:
        """Enqueue the next scheduled delta batch once its time arrives.
        Deterministic in (seed, step) like the arrival schedule, so a
        replayed scenario applies the identical write stream."""
        sc = self.scenario
        if not sc.ingest_every_s or now_s < self._next_ingest_s:
            return
        from repro_torch.data.pipeline import pir_delta_batch

        live = self.frontend.pipeline.live
        for delta in pir_delta_batch(
            live.n,
            -(-live.record_bits // 8),
            appends=sc.ingest_appends,
            updates=sc.ingest_updates,
            deletes=sc.ingest_deletes,
            seed=sc.seed + 7,
            step=self._ingest_steps,
        ):
            self.frontend.ingest(delta)
        self._ingest_steps += 1
        self._next_ingest_s += sc.ingest_every_s

    def _done_callback(self, scheduled_abs: float, clock):
        col = self.collector

        def cb(fut) -> None:
            latency = clock() - scheduled_abs
            if fut.cancelled():
                col.observe("failed")
                return
            exc = fut.exception()
            if exc is None:
                col.observe("served", latency)
            elif isinstance(exc, PermissionError):
                col.observe("refused")
            else:
                col.observe("failed")

        return cb

    def run(self) -> FleetReport:
        sc, col = self.scenario, self.collector
        fe = self.frontend.start()
        pipe = fe.pipeline
        clock = time.perf_counter

        offsets = sc.arrivals.times(sc.duration_s, seed=sc.seed)
        draws = self.population.draw(len(offsets), seed=sc.seed + 1)
        self.population.install_budgets(pipe)

        # sleep in chunks small enough that fault events and heartbeats
        # stay on schedule even across long arrival gaps
        tick_s = (
            self.injector.beat_interval_s / 2.0 if self.injector else 0.05
        )
        start = clock()
        for k, (at, (client, index)) in enumerate(zip(offsets, draws)):
            while True:
                now = clock() - start
                self._tick(now)
                if now >= at:
                    break
                time.sleep(min(at - now, tick_s))
            try:
                fut = fe.submit(client, index)
            except BackpressureError:
                col.observe("shed")
            else:
                fut.add_done_callback(
                    self._done_callback(start + at, clock)
                )
            if k % sc.sample_every == 0:
                col.sample(
                    clock() - start,
                    queue_depth=len(pipe.scheduler),
                    eps_per_query=pipe.price[0],
                    d_effective=pipe.metrics["d_effective"],
                )
        # let fault events scripted after the last arrival still fire
        while True:
            now = clock() - start
            self._tick(now)
            if now >= sc.duration_s:
                break
            time.sleep(min(sc.duration_s - now, tick_s))
        fe.drain(timeout=30.0 + sc.duration_s)
        wall = clock() - start
        col.sample(
            wall,
            queue_depth=len(pipe.scheduler),
            eps_per_query=pipe.price[0],
            d_effective=pipe.metrics["d_effective"],
        )
        return FleetReport(
            scenario=sc.name,
            wall_s=wall,
            arrivals=len(offsets),
            slo=col.summary(wall),
            price=pipe.price,
            degraded=dict(pipe.degraded) if pipe.degraded else None,
            remeshes=int(pipe.metrics["remeshes"]),
            unserviceable=bool(pipe.metrics["unserviceable"]),
            frontend_metrics=dict(fe.metrics),
            timeline=list(col.timeline),
        )


def run_scenario(
    scenario: FleetScenario,
    pipeline: ServingPipeline,
    population: Optional[ClientPopulation] = None,
    *,
    ingest_workers: int = 2,
    queue_limit: int = 8192,
    shed_policy: str = "reject",
    device: DeviceLike = None,
) -> FleetReport:
    """Run one scenario over ``pipeline`` end to end and close the
    frontend afterwards. The default population is budget-unlimited with
    as many clients as the scenario plausibly needs (min(4·peak·duration,
    10k)); pass an explicit :class:`ClientPopulation` for budgeted runs.
    ``device`` is where the scenario must run (None: the CUDA card, an
    error without one); a pipeline that serves elsewhere is refused.
    """
    dev = resolve_device(device)
    if pipeline.device.type != dev.type:
        raise ValueError(
            f"pipeline serves on {pipeline.device}, scenario was asked "
            f"to run on {dev}"
        )
    if population is None:
        approx = int(
            4 * scenario.arrivals.peak_qps * scenario.duration_s
        )
        population = ClientPopulation(
            n_clients=max(1, min(approx, 10_000)),
            n_records=pipeline.store.n,
            seed=scenario.seed,
        )
    frontend = AsyncFrontend(
        pipeline,
        ingest_workers=ingest_workers,
        queue_limit=queue_limit,
        shed_policy=shed_policy,
        compact_log_depth=scenario.compact_log_depth or None,
    )
    with frontend:
        return FleetHarness(frontend, population, scenario).run()
