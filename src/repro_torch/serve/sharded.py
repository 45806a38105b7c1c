"""Execution backend: where a routed batch actually touches records.

``ShardedBackend`` is the production *answer stage* of the staged scheme
protocol (DESIGN.md §Scheme protocol): it consumes the wire-level
:class:`~repro_torch.core.protocol.Queries` a scheme's ``query()`` emitted
and answers per-server payloads against the record store — dispatching on
the wire *kind* and θ, never on scheme names. The scheme's ``reconstruct``
then runs on the stacked responses (``SchemeRouter.finalize``).

Every implementation decision — which kernel, which backend impl, fused
vs streaming sparse, fold vs parity, block sizes, index budgets — flows
through the execution-backend layer (:mod:`repro_torch.kernels.backend`):
:meth:`ShardedBackend.prepare` asks the
:class:`~repro_torch.kernels.backend.KernelPlanner` for an
:class:`~repro_torch.kernels.backend.ExecutionPlan` and
:meth:`ShardedBackend.answer_batch` executes it. This module holds **no
kernel choice of its own** and imports no kernel module.

Only the single-device half of the reference package's backend is ported:
the whole store lies on one device and each logical replica's answer is
one kernel launch over it. Mesh residency, store swaps and the direct
family's index path are not ported yet (ROADMAP.md Queue A).

The backend also owns **straggler tracking**: a latency EMA per database
replica (the paper's d databases stay *logical* replicas). Every server
answered by :meth:`answer_batch` feeds its replica's EMA. Each sample is a
host-clock interval that ends in a device synchronisation, so it times the
answer and not its enqueue.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch._device import DeviceLike, resolve_device, synchronize
from repro_torch.core.protocol import Queries
from repro_torch.db.store import RecordStore
from repro_torch.kernels.backend import ExecutionPlan, KernelPlanner

__all__ = ["ServerStats", "ShardedBackend"]


@dataclasses.dataclass
class ServerStats:
    """Latency EMA per database replica (straggler tracking)."""

    ema_s: float = 0.0
    n: int = 0

    def observe(self, dt: float, alpha: float = 0.2) -> None:
        self.ema_s = dt if self.n == 0 else (1 - alpha) * self.ema_s + alpha * dt
        self.n += 1


class ShardedBackend:
    """Single-device batch executor with per-replica latency tracking.

    ``device=None`` expects the store on the CUDA card; a store that lies
    elsewhere than the resolved device is refused rather than moved.
    """

    def __init__(
        self,
        store: RecordStore,
        *,
        simulate_latency: Optional[Callable[[int], float]] = None,
        backend: str = "auto",
        parity_min_batch: Optional[int] = None,
        smem_budget_bytes: Optional[int] = None,
        device: DeviceLike = None,
    ):
        dev = resolve_device(device)
        if store.device.type != dev.type:
            raise ValueError(
                f"store lies on {store.device}, backend was asked for {dev}"
            )
        self.store = store
        self.device = store.device
        self.planner = KernelPlanner(
            store,
            backend=backend,
            parity_min_batch=parity_min_batch,
            smem_budget_bytes=smem_budget_bytes,
        )
        self.stats: Dict[int, ServerStats] = {}
        self._sim = simulate_latency
        self.path_counts = {"fold": 0, "parity": 0, "sparse": 0, "direct": 0}

    @property
    def backend_name(self) -> str:
        """The registered execution backend this instance plans with."""
        return self.planner.backend_name

    # ------------------------------------------------------------ stragglers
    def ensure_replicas(self, d: int) -> None:
        for i in range(d):
            self.stats.setdefault(i, ServerStats())

    def observe_latency(self, server: int, dt: float) -> None:
        self.stats.setdefault(server, ServerStats()).observe(dt)

    def fastest(self, t: int) -> List[int]:
        """Rank replicas by latency EMA; unobserved rank first (explore)."""
        order = sorted(
            self.stats,
            key=lambda i: (self.stats[i].n > 0, self.stats[i].ema_s),
        )
        return order[:t]

    # ------------------------------------------------------------- planning
    def prepare(
        self, routed: Queries, *, scheme: Optional[object] = None
    ) -> ExecutionPlan:
        """Resolve one batch's :class:`ExecutionPlan` (cached in the
        planner). Calling it is optional — :meth:`answer_batch` plans on
        demand when no plan is handed in."""
        bucket = int(routed.payload.shape[1])
        return self.planner.plan(routed, bucket, scheme=scheme)

    def _plan_matches(
        self, plan: Optional[ExecutionPlan], routed: Queries
    ) -> bool:
        """A handed-in plan is only reusable if it was planned for this
        batch's wire parameters — a sparse plan's index budget is sized
        from θ, so executing it against a different-θ batch would truncate
        indices and corrupt bits — and for this store's size."""
        if plan is None or plan.run is None:
            return False
        if plan.theta != getattr(routed, "theta", None):
            return False
        return plan.n == self.store.n

    # ------------------------------------------------------------ execution
    def _answer_mask_server(
        self,
        masks_s: torch.Tensor,
        routed: Queries,
        plan: Optional[ExecutionPlan],
        scheme: Optional[object],
    ) -> Tuple[torch.Tensor, ExecutionPlan]:
        """One server's [B, n] masks -> [B, W] packed partial answer."""
        if not self._plan_matches(plan, routed):
            plan = self.planner.plan(
                routed, int(masks_s.shape[0]), scheme=scheme
            )
        self.path_counts[plan.family] += 1
        return plan(masks_s), plan

    def answer_batch(
        self,
        routed: Queries,
        *,
        plan: Optional[ExecutionPlan] = None,
        scheme: Optional[object] = None,
    ) -> torch.Tensor:
        """Answer every contacted server, tracking per-replica latency.

        ``plan`` (from :meth:`prepare`) skips planning on the hot path.
        The latency EMA is fed for **every** scheme's servers; each sample
        ends in a device synchronisation (d of them per batch).

        Returns stacked responses [d_eff, B, W], ordered like
        ``routed.servers``.
        """
        if routed.kind != "mask":
            raise NotImplementedError(
                f"wire kind {routed.kind!r} (the direct family) is not "
                "ported yet; see ROADMAP.md Queue A"
            )
        responses = []
        for pos, sid in enumerate(routed.servers):
            t0 = time.perf_counter()
            r, plan = self._answer_mask_server(
                routed.payload[pos], routed, plan, scheme
            )
            synchronize(self.device)
            self.observe_latency(
                sid,
                (self._sim(sid) if self._sim else 0.0)
                + time.perf_counter() - t0,
            )
            responses.append(r)
        return torch.stack(responses)
