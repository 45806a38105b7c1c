"""SLO metrics for the fleet harness.

One :class:`SLOCollector` per scenario run. Outcomes land from future
done-callbacks — which run on whatever thread resolves the future (the
frontend's flush worker or its one-slot executor) — while the driver
thread samples gauges, so every mutation sits behind one lock (the same
lost-update argument as the query cache's counters; the SLO math reads
these numbers, so they must be exact).

Four outcomes partition every arrival:

* ``served``  — future resolved with record bytes (latency recorded);
* ``refused`` — admission refused (budget exhausted, or the pipeline
  went unserviceable) — :class:`PermissionError`; *policy*, not failure;
* ``shed``    — backpressure at the door (:class:`~repro_torch.serve.frontend.
  BackpressureError`) under the ``reject`` shed policy;
* ``failed``  — anything else (cancelled or errored future). A healthy
  run — including one with mid-traffic replica loss — has zero.

``summary()`` derives the SLO surface: p50/p95/p99 latency over served
queries, goodput (served / wall), refusal and shed rates over arrivals,
plus gauge extrema from the sampled timeline (queue depth, ε price).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np

__all__ = ["OUTCOMES", "SLOCollector"]

OUTCOMES = ("served", "refused", "shed", "failed")


class SLOCollector:
    """Thread-safe outcome/latency/gauge accumulator for one run."""

    def __init__(self):
        self._mu = threading.Lock()
        self._latencies: List[float] = []
        self.counts: Dict[str, int] = {o: 0 for o in OUTCOMES}
        self.timeline: List[Dict[str, float]] = []

    def observe(self, outcome: str, latency_s: Optional[float] = None) -> None:
        if outcome not in self.counts:
            raise ValueError(f"unknown outcome {outcome!r}; use {OUTCOMES}")
        with self._mu:
            self.counts[outcome] += 1
            if outcome == "served" and latency_s is not None:
                self._latencies.append(float(latency_s))

    def sample(self, t_s: float, **gauges: float) -> None:
        """Append one timeline point: ``{"t": t_s, **gauges}`` (queue
        depth, ε price, d' — whatever the harness watches)."""
        with self._mu:
            self.timeline.append(
                {"t": float(t_s), **{k: float(v) for k, v in gauges.items()}}
            )

    def percentile(self, q: float) -> float:
        """Latency percentile over served queries, seconds; NaN if none."""
        with self._mu:
            lat = list(self._latencies)
        return float(np.percentile(lat, q)) if lat else float("nan")

    def gauge_max(self, name: str) -> float:
        with self._mu:
            vals = [pt[name] for pt in self.timeline if name in pt]
        return max(vals) if vals else float("nan")

    def summary(self, wall_s: float) -> Dict[str, float]:
        with self._mu:
            counts = dict(self.counts)
            lat = np.asarray(self._latencies, np.float64)
        arrivals = sum(counts.values())
        p50, p95, p99 = (
            (np.percentile(lat, (50, 95, 99)) * 1e3).tolist()
            if lat.size else (float("nan"),) * 3
        )
        return {
            "arrivals": float(arrivals),
            **{k: float(v) for k, v in counts.items()},
            "p50_ms": p50,
            "p95_ms": p95,
            "p99_ms": p99,
            "goodput_qps": counts["served"] / wall_s if wall_s > 0 else 0.0,
            "refusal_rate": counts["refused"] / arrivals if arrivals else 0.0,
            "shed_rate": counts["shed"] / arrivals if arrivals else 0.0,
            "max_queue_depth": self.gauge_max("queue_depth"),
        }
