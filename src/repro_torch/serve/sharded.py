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
one kernel launch over it (the ``mask`` kind), or one ``index_select`` of
the requested rows (the ``index`` kind, the direct family: the reference
gathers with ``jnp.take`` outside any kernel too). Mesh residency is not
ported yet (ROADMAP.md Queue A).

``autotune=`` hands the planner an
:class:`~repro_torch.kernels.backend.AutotuneTable` (default: the process
table of the store's device); ``autotune_file=`` merges a dumped table at
construction (a missing file is a cold start; entries measured on another
device — the JAX package's included — or for another store shape are
dropped and counted in :attr:`ShardedBackend.autotune_dropped`), and
:meth:`ShardedBackend.save_autotune` writes it back. The search itself
runs in :meth:`ShardedBackend.autotune_step` / :meth:`tune_pending`.

A live store moves the backend with :meth:`ShardedBackend.swap_store`
(the planner keeps its plans on a same-shape swap), and a batch planned
against an older snapshot is answered against that snapshot
(``answer_batch(..., store=pinned)``), never against the newer head.

The backend also owns **straggler tracking**: a latency EMA per database
replica (the paper's d databases stay *logical* replicas). Every server
answered by :meth:`answer_batch` feeds its replica's EMA. Each sample is a
host-clock interval that ends in a synchronisation of the stream the answer
was issued on (not of the whole device), so it times the answer and not its
enqueue, and not work another thread queued on another stream meanwhile.
After replica loss, :meth:`ShardedBackend.relabel_replicas` renumbers the
survivors.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch._device import DeviceLike, resolve_device, synchronize
from repro_torch.core.protocol import MultiQueries, Queries
from repro_torch.db.store import RecordStore
from repro_torch.kernels.backend import (
    AutotuneTable,
    ExecutionPlan,
    KernelPlanner,
    dump_autotune,
)

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
        autotune: Optional[AutotuneTable] = None,
        autotune_file: Optional[str] = None,
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
            table=autotune,
            parity_min_batch=parity_min_batch,
            smem_budget_bytes=smem_budget_bytes,
        )
        self.autotune_file = autotune_file
        #: autotune entries refused at load: measured on another device, or
        #: for another store shape (AutotuneTable.update)
        self.autotune_dropped = 0
        if autotune_file is not None:
            try:
                self.autotune_dropped = self.planner.table.update(
                    AutotuneTable.load(autotune_file, device=self.device),
                    store_shape=(store.n, store.words),
                )
            except FileNotFoundError:
                pass  # cold start; save_autotune() creates it
        self.stats: Dict[int, ServerStats] = {}
        self._sim = simulate_latency
        # the hook as given, on physical ids, and the physical id behind
        # each logical replica since the last remesh (None: no loss yet,
        # logical and physical ids agree)
        self._sim_physical = simulate_latency
        self._physical: Optional[Tuple[int, ...]] = None
        # the live-store version the backend was last swapped to, and the
        # counters of the mesh refresh; the mesh is not ported, so they
        # stay zero (ROADMAP.md Queue A)
        self._live_version = 0
        self.mesh_metrics: Dict[str, int] = {
            "mesh_states_dropped": 0,
            "mesh_states_refreshed": 0,
            "mesh_shards_kept": 0,
            "mesh_shards_updated": 0,
        }
        #: the counter dict of the most recent swap_store call
        self.last_swap: Dict[str, int] = {}
        # (id(store), planes) memo for snapshot-pinned parity answers: a
        # batch that pinned a pre-ingest snapshot may still need that
        # version's bitplanes after the planner moved on
        self._pinned_planes: Optional[Tuple[int, torch.Tensor]] = None
        self.path_counts = {"fold": 0, "parity": 0, "sparse": 0, "direct": 0}

    @property
    def backend_name(self) -> str:
        """The registered execution backend this instance plans with."""
        return self.planner.backend_name

    def save_autotune(self, path: Optional[str] = None) -> str:
        """Dump the planner's autotune table as JSON (default: the
        ``autotune_file`` this backend was constructed with)."""
        path = path or self.autotune_file
        if path is None:
            raise ValueError("no autotune_file configured and no path given")
        dump_autotune(path, self.planner.table)
        return path

    # -------------------------------------------------------------- autotune
    def autotune_step(self, max_cells: int = 1) -> int:
        """Run the planner's autotune search for up to ``max_cells``
        pending cells (an idle-time job); returns cells tuned. Requests
        never call this — they plan from the table or the prior."""
        return self.planner.tune_step(max_cells)

    def tune_pending(self) -> int:
        """Drain the planner's pending-cell queue (benchmarks and shutdown
        dumps); returns cells tuned."""
        return self.planner.tune_pending()

    # ------------------------------------------------------------ stragglers
    def ensure_replicas(self, d: int) -> None:
        for i in range(d):
            self.stats.setdefault(i, ServerStats())

    def relabel_replicas(self, survivors: List[int]) -> None:
        """Compact the replica id space after loss: survivor ``s`` (a
        physical id, of the original deployment) becomes logical replica
        ``i`` (its rank in ``survivors``, as in
        :func:`~repro_torch.dist.fault.plan_elastic_remesh`'s sorted
        survivor tuple). Latency EMAs carry over under the new labels, so
        the straggler ranking stays warm across a remesh; dead replicas'
        stats retire. The simulated-latency hook keeps seeing *physical*
        ids — a simulated-slow machine stays slow whatever logical slot the
        remesh parks it in.

        ``stats`` is keyed by the current logical ids, so after a first
        remesh each survivor's stats are found through the labels that
        remesh gave it (the reference looks them up by physical id, which
        picks another replica's from the second loss on)."""
        order = tuple(int(s) for s in survivors)
        label = ({s: s for s in order} if self._physical is None
                 else {p: i for i, p in enumerate(self._physical)})
        self.stats = {
            i: self.stats.get(label.get(s), ServerStats())
            for i, s in enumerate(order)
        }
        self._physical = order
        if self._sim_physical is not None:
            phys = self._sim_physical
            self._sim = (
                lambda i: phys(order[i]) if 0 <= i < len(order) else phys(i)
            )

    def observe_latency(self, server: int, dt: float) -> None:
        self.stats.setdefault(server, ServerStats()).observe(dt)

    def fastest(self, t: int) -> List[int]:
        """Rank replicas by latency EMA; unobserved rank first (explore)."""
        order = sorted(
            self.stats,
            key=lambda i: (self.stats[i].n > 0, self.stats[i].ema_s),
        )
        return order[:t]

    # ---------------------------------------------------------- store swaps
    def swap_store(
        self,
        store: RecordStore,
        *,
        touched_rows: Optional[Any] = None,
        live: Optional[Any] = None,
    ) -> Dict[str, int]:
        """Move the backend onto a new store version.

        Rides on :meth:`KernelPlanner.rebind`: a same-shape swap with a
        known touched-row set keeps every cached :class:`ExecutionPlan`
        and refreshes only the touched bitplane rows; a shape change drops
        plans and planes. ``live`` (the
        :class:`~repro_torch.db.live.VersionedStore` the snapshot came
        from) is observability only: the counters gain
        ``store_shards_touched`` / ``store_shards_total`` from its
        shard-version vector since the last swap. The mesh counters stay
        zero (no mesh residency is ported). Returns the counters, also
        kept as :attr:`last_swap`."""
        if store.device != self.device:
            raise ValueError(
                f"store lies on {store.device}, backend serves {self.device}"
            )
        counters = self.planner.rebind(store, touched_rows=touched_rows)
        self.store = store
        counters.update({k: 0 for k in self.mesh_metrics})
        if live is not None:
            counters["store_shards_touched"] = len(
                live.shards_touched_since(self._live_version)
            )
            counters["store_shards_total"] = live.shards
            self._live_version = live.version
        for k in self.mesh_metrics:
            self.mesh_metrics[k] += counters[k]
        self.last_swap = dict(counters)
        return counters

    # ------------------------------------------------------------- planning
    def prepare(
        self, routed: Queries, *, scheme: Optional[object] = None
    ) -> ExecutionPlan:
        """Resolve one batch's :class:`ExecutionPlan` (cached in the
        planner). Calling it is optional — :meth:`answer_batch` plans on
        demand when no plan is handed in. A
        :class:`~repro_torch.core.protocol.MultiQueries` batch threads its
        padded per-request column count into the planner, so a sparse
        bucket can take the fused multi form."""
        bucket = int(routed.payload.shape[1])
        k_max = routed.k_max if isinstance(routed, MultiQueries) else None
        return self.planner.plan(routed, bucket, scheme=scheme, k_max=k_max)

    def _plan_matches(
        self,
        plan: Optional[ExecutionPlan],
        routed: Queries,
        n_host: Optional[int] = None,
    ) -> bool:
        """A handed-in plan is only reusable if it was planned for this
        batch's wire parameters — a sparse plan's index budget is sized
        from θ, so executing it against a different-θ batch would truncate
        indices and corrupt bits; a multi plan's ``k_max`` must divide the
        bucket — and for the size of the store the batch is answered
        against: ``n_host``, the pinned snapshot's n, else the current
        store's."""
        if plan is None or plan.run is None:
            return False
        if plan.theta != getattr(routed, "theta", None):
            return False
        k_plan = dict(plan.blocks).get("k_max")
        if k_plan and int(routed.payload.shape[1]) % int(k_plan):
            return False
        return plan.n == (n_host if n_host is not None else self.store.n)

    # ------------------------------------------------------------ execution
    def _pinned_operand(
        self, plan: ExecutionPlan, store: RecordStore
    ) -> torch.Tensor:
        """The kernel operand for a *pinned* snapshot: its packed words,
        or its bitplanes for the parity path (memoized per snapshot
        object)."""
        if plan.path != "parity":
            return store.packed
        hit = self._pinned_planes
        if hit is None or hit[0] != id(store):
            self._pinned_planes = (id(store), store.bitplanes())
        return self._pinned_planes[1]

    def _answer_mask_server(
        self,
        masks_s: torch.Tensor,
        routed: Queries,
        plan: Optional[ExecutionPlan],
        scheme: Optional[object],
        store: Optional[RecordStore] = None,
    ) -> Tuple[torch.Tensor, ExecutionPlan]:
        """One server's [B, n] masks -> [B, W] packed partial answer.

        ``store`` pins the snapshot the answer must be computed against
        (None: the backend's current store)."""
        n_host = store.n if store is not None else None
        if not self._plan_matches(plan, routed, n_host):
            plan = self.planner.plan(
                routed, int(masks_s.shape[0]), scheme=scheme,
                k_max=getattr(routed, "k_max", None),
            )
        self.path_counts[plan.family] += 1
        if store is not None and store is not self.planner.store:
            # a delta landed after this batch was planned: answer against
            # the pinned version's operand, not the planner's current one
            return plan(
                masks_s, operand=self._pinned_operand(plan, store)
            ), plan
        return plan(masks_s), plan

    def _answer_index_server(
        self, reqs_s: torch.Tensor, store: Optional[RecordStore] = None
    ) -> torch.Tensor:
        """One server's [B, k] index requests -> [B, k, W] records of the
        pinned snapshot (None: the backend's current store)."""
        self.path_counts["direct"] += 1
        pinned = store if store is not None else self.store
        return pinned.packed.index_select(0, reqs_s.reshape(-1).long()
                                          ).reshape(*reqs_s.shape, -1)

    def answer_batch(
        self,
        routed: Queries,
        *,
        plan: Optional[ExecutionPlan] = None,
        scheme: Optional[object] = None,
        store: Optional[RecordStore] = None,
    ) -> torch.Tensor:
        """Answer every contacted server, tracking per-replica latency.

        ``plan`` (from :meth:`prepare`) skips planning on the hot path.
        ``store`` pins the snapshot the batch must be answered against:
        when an ingest swapped the backend's store between this batch's
        plan and its execution, the answer still comes from the pinned
        snapshot, bit for bit. The latency EMA is fed for **every**
        scheme's servers (only Subset-PIR consumes the ranking); each
        sample ends in a synchronisation of the calling thread's current
        stream (d of them per batch), never of the whole device.

        Returns stacked responses: [d_eff, B, W] (mask) or [d_eff, B, k, W]
        (index), ordered like ``routed.servers``.
        """
        if routed.kind not in ("mask", "index"):
            raise ValueError(f"unknown wire kind {routed.kind!r}")
        responses = []
        for pos, sid in enumerate(routed.servers):
            t0 = time.perf_counter()
            if routed.kind == "mask":
                r, plan = self._answer_mask_server(
                    routed.payload[pos], routed, plan, scheme, store
                )
            else:
                r = self._answer_index_server(routed.payload[pos], store)
            synchronize(self.device)
            self.observe_latency(
                sid,
                (self._sim(sid) if self._sim else 0.0)
                + time.perf_counter() - t0,
            )
            responses.append(r)
        return torch.stack(responses)
