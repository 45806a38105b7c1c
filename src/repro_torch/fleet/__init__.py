"""repro_torch.fleet — fleet-scale load harness: open-loop traffic, per-client
budgets, SLO metrics, live fault injection (DESIGN.md §Fleet harness).

The paper's headline claim is a *fleet-scale* claim — weak ε-private
schemes become arbitrarily safe composed with large anonymity systems —
so the serving stack has to be measured the way a fleet actually runs:
open-loop arrival processes (Poisson / bursty / diurnal) driving the
real ``AsyncFrontend → scheduler → router → sharded backend`` path,
thousands of simulated clients each carrying their own (ε, δ) budget,
and replicas dying mid-traffic. This package supplies exactly that and
nothing else:

* :mod:`~repro_torch.fleet.arrivals` — deterministic open-loop arrival
  processes (submit on schedule, never wait for answers — overload must
  actually build queues).
* :mod:`~repro_torch.fleet.clients` — the simulated client population: ids,
  zipf-ish index popularity with per-client hot-record re-polls (the
  §2.2 correlated-query pattern), per-client budget installation.
* :mod:`~repro_torch.fleet.metrics` — the thread-safe SLO collector:
  p50/p95/p99 latency, goodput, refusal rate, queue-depth and ε time
  series.
* :mod:`~repro_torch.fleet.injector` — scripted replica kills driven through
  the :class:`~repro_torch.dist.fault.HeartbeatMonitor` while traffic flows.
* :mod:`~repro_torch.fleet.harness` — the driver tying them together into one
  :class:`FleetScenario` run producing a :class:`FleetReport`.

Layering: this package consumes the ``repro_torch.serve`` and
``repro_torch.dist`` surfaces only — never ``repro_torch.kernels`` (any
module) and never the per-scheme ``repro_torch.core`` wire internals. It
is the reference package's ``fleet`` carried over: the arrival times,
client draws and SLO summaries are the same numbers for the same seeds
(tests/test_torch_fleet.py holds them against the JAX package's).
"""

from repro_torch.fleet.arrivals import (
    BurstyArrivals,
    DiurnalArrivals,
    PoissonArrivals,
)
from repro_torch.fleet.clients import ClientPopulation
from repro_torch.fleet.harness import (
    FleetHarness,
    FleetReport,
    FleetScenario,
    run_scenario,
)
from repro_torch.fleet.injector import FaultEvent, FaultInjector
from repro_torch.fleet.metrics import SLOCollector

__all__ = [
    "BurstyArrivals",
    "ClientPopulation",
    "DiurnalArrivals",
    "FaultEvent",
    "FaultInjector",
    "FleetHarness",
    "FleetReport",
    "FleetScenario",
    "PoissonArrivals",
    "SLOCollector",
    "run_scenario",
]
