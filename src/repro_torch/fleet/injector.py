"""Live fault injection: scripted replica kills under real traffic.

The :class:`FaultInjector` owns the heartbeat side of a scenario. Every
``tick(now)`` it (1) applies any :class:`FaultEvent` that has come due —
a ``kill`` stops the replica's heartbeats, a ``revive`` restarts them —
(2) heartbeats every currently-up replica on its beat interval, and (3)
polls the :class:`~repro_torch.dist.fault.HeartbeatMonitor`, whose death edges
fire the registered pipeline hooks (``ServingPipeline.degrade_replicas``
→ remesh + re-priced ε) *while the harness keeps submitting*.

Nothing here touches the pipeline directly: kills are expressed purely
as silence, detection purely as the monitor's timeout — the same signal
path production failures take, which is the point of injecting them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Set

from repro_torch.dist.fault import HeartbeatMonitor

__all__ = ["FaultEvent", "FaultInjector"]


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scripted change at ``at_s`` (scenario-relative seconds)."""

    at_s: float
    replica: int
    kind: str = "kill"  # kill | revive

    def __post_init__(self):
        if self.kind not in ("kill", "revive"):
            raise ValueError(f"kind must be kill|revive, got {self.kind!r}")
        if self.at_s < 0:
            raise ValueError(f"need at_s >= 0, got {self.at_s}")


class FaultInjector:
    """Drives heartbeats + scripted kills through a HeartbeatMonitor."""

    def __init__(
        self,
        monitor: HeartbeatMonitor,
        events: Sequence[FaultEvent] = (),
        *,
        beat_interval_s: float = 0.0,
    ):
        self.monitor = monitor
        self.events = tuple(sorted(events, key=lambda e: e.at_s))
        # default: beat 4× per timeout window, so a live replica can
        # never be late by accident — only scripted silence kills
        self.beat_interval_s = beat_interval_s or (
            monitor.state.heartbeat_timeout_s / 4.0
        )
        self._next_event = 0
        self._down: Set[int] = set()
        self._last_beat = -math.inf

    @property
    def down(self) -> Set[int]:
        """Replicas currently scripted down (not necessarily *detected*
        dead yet — detection lags by the heartbeat timeout)."""
        return set(self._down)

    def tick(self, now: float) -> List[int]:
        """Advance to ``now``; returns replicas newly detected dead."""
        while (
            self._next_event < len(self.events)
            and self.events[self._next_event].at_s <= now
        ):
            ev = self.events[self._next_event]
            self._next_event += 1
            if ev.kind == "kill":
                self._down.add(ev.replica)
            else:
                self._down.discard(ev.replica)
                self.monitor.heartbeat(ev.replica, now)
        if now - self._last_beat >= self.beat_interval_s:
            for r in range(self.monitor.state.n_pods):
                if r not in self._down:
                    self.monitor.heartbeat(r, now)
            self._last_beat = now
        return self.monitor.poll(now)
