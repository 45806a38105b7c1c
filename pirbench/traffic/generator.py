"""The one traffic generator: reads a mix file and draws its lookups.

A mix (``pirbench/traffic/<mix>.json``) is data only. Its ``loop`` is
``open`` (lookups arrive on a schedule whatever the server does: the
online relying parties) or ``closed`` (a fixed number of lookups kept
outstanding: a monitor sweeping the log). Every key a mix may hold:

- ``loop``: ``open`` | ``closed``;
- ``bucket_cap``: the largest bucket the scheduler may cut;
- ``arrivals`` (open): the arrival process by name and its parameters,
  ``{"process": "poisson", "rate_qps"}`` or ``{"process": "bursty",
  "base_qps", "burst_qps", "period_s", "duty"}`` (``PROCESSES``);
- ``population`` (open): ``{"clients", "zipf_a", "repoll_p"}``;
- ``base_seed`` (open): the seed of the arrival times and of the
  (client, index) draws. Every run is offered the same arrival times and
  the same multiset of lookups; the run's own seed orders the lookups, so
  two seeds offer the same work;
- ``outstanding``, ``preroll``, ``clients`` (closed): lookups kept in
  flight, lookups completed before the window opens, and how many
  monitors share them; the indices are consecutive from an offset the
  run's seed draws.

``poisson_times`` and ``bursty_times`` are frozen copies of
``repro_torch.fleet.arrivals.PoissonArrivals.times`` and
``BurstyArrivals.times``, and ``zipf_draw`` of
``repro_torch.fleet.clients.ClientPopulation.draw``, so that a change to
the program cannot move the traffic.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
from typing import Callable, Dict, List, Tuple

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent

LOOPS = ("open", "closed")


def load_mix(name: str, root: pathlib.Path = HERE) -> dict:
    """The mix file ``<root>/<name>.json``, checked."""
    mix = json.loads((root / f"{name}.json").read_text())
    loop = mix.get("loop")
    if loop not in LOOPS:
        raise ValueError(f"mix {name}: loop must be one of {LOOPS}, got {loop!r}")
    if int(mix.get("bucket_cap", 0)) < 1:
        raise ValueError(f"mix {name}: need bucket_cap >= 1")
    need = (("arrivals", "population", "base_seed") if loop == "open"
            else ("outstanding", "preroll", "clients"))
    missing = [k for k in need if k not in mix]
    if missing:
        raise ValueError(f"mix {name}: {loop} loop needs {missing}")
    if loop == "open":
        check_arrivals(mix["arrivals"], name)
    return mix


def check_arrivals(arrivals: dict, name: str = "") -> None:
    """Refuse an arrival process with no generator here, or without the
    parameters its generator takes."""
    process = arrivals.get("process")
    if process not in PROCESSES:
        raise ValueError(f"mix {name}: arrivals process must be one of "
                         f"{sorted(PROCESSES)}, got {process!r}")
    missing = [k for k in PROCESSES[process][1] if k not in arrivals]
    if missing:
        raise ValueError(f"mix {name}: {process} arrivals need {missing}")


# ---------------------------------------------------------------- frozen
def poisson_times(rate_qps: float, duration_s: float, seed: int) -> np.ndarray:
    """Arrival offsets of a homogeneous Poisson process in
    ``[0, duration_s)``: cumsum of exponential gaps, drawn in chunks until
    the horizon is covered (PoissonArrivals.times)."""
    return _homogeneous(rate_qps, duration_s, np.random.default_rng(seed))


def _homogeneous(rate_qps: float, duration_s: float,
                 rng: np.random.Generator) -> np.ndarray:
    if duration_s <= 0 or rate_qps <= 0:
        return np.empty(0, np.float64)
    expect = rate_qps * duration_s
    chunk = int(expect + 6.0 * math.sqrt(expect) + 16.0)
    times = np.cumsum(rng.exponential(1.0 / rate_qps, size=chunk))
    while times.size and times[-1] < duration_s:
        more = np.cumsum(rng.exponential(1.0 / rate_qps, size=chunk))
        times = np.concatenate([times, times[-1] + more])
    return times[times < duration_s]


def bursty_times(base_qps: float, burst_qps: float, period_s: float,
                 duty: float, duration_s: float, seed: int) -> np.ndarray:
    """On/off modulated Poisson arrivals: ``burst_qps`` for the first
    ``duty`` of every ``period_s``, ``base_qps`` otherwise; drawn at the
    peak rate and thinned by rate(t) / peak (BurstyArrivals.times)."""
    rng = np.random.default_rng(seed)
    peak = max(base_qps, burst_qps)
    cand = _homogeneous(peak, duration_s, rng)
    if not cand.size:
        return cand
    in_burst = (cand % period_s) < duty * period_s
    rate = np.where(in_burst, burst_qps, base_qps)
    return cand[rng.random(cand.size) * peak < rate]


# name -> (generator, the parameters it takes from the mix's ``arrivals``)
PROCESSES: Dict[str, Tuple[Callable[..., np.ndarray], Tuple[str, ...]]] = {
    "poisson": (poisson_times, ("rate_qps",)),
    "bursty": (bursty_times, ("base_qps", "burst_qps", "period_s", "duty")),
}


def arrival_times(arrivals: dict, duration_s: float, seed: int) -> np.ndarray:
    """The offsets in ``[0, duration_s)`` of the process ``arrivals``
    names, with its parameters."""
    check_arrivals(arrivals)
    fn, params = PROCESSES[arrivals["process"]]
    return fn(*(float(arrivals[k]) for k in params), duration_s, seed)


def zipf_draw(k: int, n_clients: int, n_records: int, zipf_a: float,
              repoll_p: float, seed: int) -> List[Tuple[str, int]]:
    """``k`` (client, index) pairs: zipf-popular records, except that each
    client re-polls its own hot record with probability ``repoll_p``
    (ClientPopulation.draw)."""
    rng = np.random.default_rng(seed)
    who = rng.integers(0, n_clients, size=k)
    popular = (rng.zipf(zipf_a, size=k) - 1) % n_records
    hot = (who * 131 + 17) % n_records
    repoll = rng.random(k) < repoll_p
    idx = np.where(repoll, hot, popular)
    return [(f"c{int(w) % n_clients:06d}", int(q)) for w, q in zip(who, idx)]


# -------------------------------------------------------------- schedules
@dataclasses.dataclass(frozen=True)
class OpenSchedule:
    """An open loop's lookups: ``times[i]`` seconds after the window
    opens, ``lookups[i]`` = (client, index)."""

    times: np.ndarray
    lookups: List[Tuple[str, int]]


def open_schedule(mix: dict, n_records: int, seconds: float, seed: int
                  ) -> OpenSchedule:
    """The mix's arrivals for a window of ``seconds``: the arrival times
    and the multiset of lookups of ``base_seed``, the lookups in an order
    drawn from ``seed``. Every seed is offered the same arrivals: how a
    Poisson draw clusters its arrivals moves a tail more than the run's
    own seed should."""
    base = int(mix["base_seed"])
    times = arrival_times(mix["arrivals"], seconds, base)
    pop = mix["population"]
    lookups = zipf_draw(times.size, int(pop["clients"]), n_records,
                        float(pop["zipf_a"]), float(pop["repoll_p"]), base + 1)
    rng = np.random.default_rng([seed & 0xFFFFFFFFFFFFFFFF, 1])
    order = rng.permutation(times.size)
    return OpenSchedule(times=times, lookups=[lookups[i] for i in order])


def closed_offset(mix: dict, n_records: int, seed: int) -> int:
    """Where a closed loop's consecutive indices start."""
    rng = np.random.default_rng([seed & 0xFFFFFFFFFFFFFFFF, 2])
    return int(rng.integers(0, n_records))
