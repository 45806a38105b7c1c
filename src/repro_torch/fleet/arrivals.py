"""Open-loop arrival processes for the fleet harness.

Open-loop means the arrival times are drawn ahead of time from the
process and the harness submits on schedule *regardless of completions*
— it never waits for an answer before sending the next query. That is
the property that makes overload measurable: a closed-loop driver
self-throttles when the server slows down, hiding saturation and
understating tail latency (the coordinated-omission failure mode);
an open-loop one lets queues actually build.

Every process is deterministic given ``(seed, duration)``:
``times(duration_s, seed)`` returns the sorted arrival offsets in
``[0, duration_s)`` as a float64 array. The non-homogeneous processes
(bursty, diurnal) sample by *thinning* a homogeneous Poisson process at
the peak rate — draw candidates at ``peak_qps``, keep each with
probability ``rate(t) / peak_qps`` — which is exact for any bounded
rate function, so the bursts and the diurnal curve are real
rate-function properties, not binned approximations.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["PoissonArrivals", "BurstyArrivals", "DiurnalArrivals"]


def _homogeneous_times(
    rate_qps: float, duration_s: float, rng: np.random.Generator
) -> np.ndarray:
    """Arrival offsets of a homogeneous Poisson process: cumsum of
    exponential gaps, drawn in chunks until the horizon is covered."""
    if duration_s <= 0 or rate_qps <= 0:
        return np.empty(0, np.float64)
    expect = rate_qps * duration_s
    chunk = int(expect + 6.0 * math.sqrt(expect) + 16.0)
    times = np.cumsum(rng.exponential(1.0 / rate_qps, size=chunk))
    while times.size and times[-1] < duration_s:
        more = np.cumsum(rng.exponential(1.0 / rate_qps, size=chunk))
        times = np.concatenate([times, times[-1] + more])
    return times[times < duration_s]


def _thinned_times(process, duration_s: float, seed: int) -> np.ndarray:
    """Exact non-homogeneous sampling: homogeneous at ``peak_qps``,
    thinned by ``rate(t) / peak_qps``."""
    rng = np.random.default_rng(seed)
    peak = process.peak_qps
    cand = _homogeneous_times(peak, duration_s, rng)
    if not cand.size:
        return cand
    keep = rng.random(cand.size) * peak < process.rate(cand)
    return cand[keep]


@dataclasses.dataclass(frozen=True)
class PoissonArrivals:
    """Memoryless constant-rate traffic — the fleet's background hum."""

    rate_qps: float

    def __post_init__(self):
        if self.rate_qps <= 0:
            raise ValueError(f"need rate_qps > 0, got {self.rate_qps}")

    @property
    def peak_qps(self) -> float:
        return self.rate_qps

    def rate(self, t):
        """Instantaneous rate at time(s) ``t`` (scalar or array)."""
        return np.full_like(np.asarray(t, np.float64), self.rate_qps)

    def times(self, duration_s: float, seed: int = 0) -> np.ndarray:
        return _homogeneous_times(
            self.rate_qps, duration_s, np.random.default_rng(seed)
        )


@dataclasses.dataclass(frozen=True)
class BurstyArrivals:
    """On/off modulated Poisson: ``burst_qps`` for the first ``duty``
    fraction of every ``period_s``, ``base_qps`` otherwise — the
    thundering-herd shape (cache expiry storms, synchronized monitors)
    that stresses admission control and the shed policy."""

    base_qps: float
    burst_qps: float
    period_s: float = 1.0
    duty: float = 0.2

    def __post_init__(self):
        if self.base_qps <= 0 or self.burst_qps <= 0:
            raise ValueError("need base_qps > 0 and burst_qps > 0")
        if self.period_s <= 0:
            raise ValueError(f"need period_s > 0, got {self.period_s}")
        if not (0.0 < self.duty < 1.0):
            raise ValueError(f"need 0 < duty < 1, got {self.duty}")

    @property
    def peak_qps(self) -> float:
        return max(self.base_qps, self.burst_qps)

    def rate(self, t):
        t = np.asarray(t, np.float64)
        in_burst = (t % self.period_s) < self.duty * self.period_s
        return np.where(in_burst, self.burst_qps, self.base_qps)

    def times(self, duration_s: float, seed: int = 0) -> np.ndarray:
        return _thinned_times(self, duration_s, seed)


@dataclasses.dataclass(frozen=True)
class DiurnalArrivals:
    """Sinusoidal day curve compressed to ``period_s``: rate(t) =
    mean·(1 + amplitude·sin(2π·t/period + phase)) — the slow swing that
    exercises the scheduler's adaptive batch target across load levels."""

    mean_qps: float
    amplitude: float = 0.8
    period_s: float = 10.0
    phase: float = 0.0

    def __post_init__(self):
        if self.mean_qps <= 0:
            raise ValueError(f"need mean_qps > 0, got {self.mean_qps}")
        if not (0.0 <= self.amplitude <= 1.0):
            raise ValueError(
                f"need 0 <= amplitude <= 1, got {self.amplitude}"
            )
        if self.period_s <= 0:
            raise ValueError(f"need period_s > 0, got {self.period_s}")

    @property
    def peak_qps(self) -> float:
        return self.mean_qps * (1.0 + self.amplitude)

    def rate(self, t):
        t = np.asarray(t, np.float64)
        return self.mean_qps * (
            1.0
            + self.amplitude
            * np.sin(2.0 * np.pi * t / self.period_s + self.phase)
        )

    def times(self, duration_s: float, seed: int = 0) -> np.ndarray:
        return _thinned_times(self, duration_s, seed)
