"""The serving pipeline: queue → router → execution backend.

This is the production face of the paper: clients submit (client_id,
index) requests, or jagged multi-index requests (``submit_many``); the
:class:`~repro_torch.serve.scheduler.BatchScheduler`
batches them and pads to power-of-two buckets; the
:class:`~repro_torch.serve.router.SchemeRouter` drives the configured
scheme's staged protocol (DESIGN.md §Scheme protocol) to turn each batch
into per-server payloads; the
:class:`~repro_torch.serve.sharded.ShardedBackend` answers them with the
GF(2) kernels over the bit-packed store on one device.

Privacy is enforced at admission: every accepted query spends its scheme's
(ε, δ) from the client's :class:`~repro_torch.core.accounting.PrivacyBudget`
(sequential composition, §2.2) and exhausted clients are refused.

A pipeline built over a live :class:`~repro_torch.db.live.VersionedStore`
serves its current frozen head and applies deltas with :meth:`ingest`;
every batch pins the snapshot it was planned against and is answered
against it, whatever lands in between.

Not ported yet (ROADMAP.md Queue A; passing them raises
``NotImplementedError``): the cross-batch ``QueryCache``, replica-loss
degradation and the async front.

:class:`PIRServingEngine` is the back-compat facade over the pipeline.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device, synchronize
from repro_torch.core.accounting import PrivacyBudget
from repro_torch.core.protocol import (
    Queries,
    SchemeProtocol,
    as_protocol,
    multi_bucket,
)
from repro_torch.db import packing
from repro_torch.db.live import Delta, VersionedStore
from repro_torch.db.store import RecordStore
from repro_torch.kernels.backend import ExecutionPlan
from repro_torch.serve.router import SchemeRouter
from repro_torch.serve.scheduler import BatchScheduler, Request
from repro_torch.serve.sharded import ServerStats, ShardedBackend

__all__ = ["ServerStats", "PlannedBatch", "ServingPipeline", "PIRServingEngine"]


@dataclasses.dataclass
class PlannedBatch:
    """One cut batch, planned but not yet executed: the requests routed
    into wire-level ``routed`` payloads (a ``MultiQueries`` for a jagged
    batch) with the batch's
    :class:`~repro_torch.kernels.backend.ExecutionPlan` pre-resolved.

    ``store`` and ``store_version`` pin the frozen snapshot the batch
    answers against: a write landing mid-batch makes a new head, and this
    batch keeps answering against the store it was planned on.
    ``lists`` holds the per-request index lists of a jagged batch (None
    on the single-index path)."""

    batch: List[Request]
    padded: int
    routed: Queries
    exec_plan: ExecutionPlan
    plan_s: float  # wall time the plan phase itself took
    store: RecordStore
    store_version: int = 0
    lists: Optional[List[List[int]]] = None


class ServingPipeline:
    """Batch-scheduled, scheme-routed PIR serving on one device.

    ``store`` is a frozen :class:`RecordStore` or a live
    :class:`~repro_torch.db.live.VersionedStore` (duck-typed: anything
    with ``snapshot()``/``ingest()``); ``self.store`` is always a frozen
    snapshot. ``device=None`` means the CUDA card (an error without one);
    the store must already lie there. ``seed`` seeds the pipeline's one
    ``torch.Generator``, from which every batch's query randomness is
    drawn in turn.
    """

    def __init__(
        self,
        store: RecordStore,
        scheme,
        *,
        scheduler: Optional[BatchScheduler] = None,
        backend: Optional[ShardedBackend] = None,
        cache=None,
        default_budget: Optional[Callable[[], PrivacyBudget]] = None,
        simulate_latency: Optional[Callable[[int], float]] = None,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        if cache is not None:
            raise NotImplementedError(
                "the cross-batch QueryCache is not ported yet; see "
                "ROADMAP.md Queue A"
            )
        self.live: Optional[VersionedStore] = None
        if hasattr(store, "snapshot") and hasattr(store, "ingest"):
            self.live = store
            store = store.snapshot()
        dev = resolve_device(device)
        if store.device.type != dev.type:
            raise ValueError(
                f"store lies on {store.device}, pipeline was asked for {dev}"
            )
        self.store = store
        self.store_version = self.live.version if self.live is not None else 0
        self._pending_deltas: List[Delta] = []
        self.device = store.device
        # `scheme` may be a staged SchemeProtocol instance or the
        # back-compat Scheme facade; `self.scheme` keeps whatever the
        # caller handed over, `self.staged` is the normalized protocol
        # object every stage below drives
        self.scheme = scheme
        self.staged: SchemeProtocol = as_protocol(scheme)
        # explicit None checks: an empty BatchScheduler is falsy (__len__)
        self.scheduler = scheduler if scheduler is not None else BatchScheduler()
        self.backend = backend if backend is not None else ShardedBackend(
            store, simulate_latency=simulate_latency, device=self.device
        )
        self.backend.ensure_replicas(self.staged.d)
        self.router = SchemeRouter(
            self.staged, pick_servers=self.backend.fastest
        )
        self._budgets: Dict[str, PrivacyBudget] = {}
        self._default_budget = default_budget or (
            lambda: PrivacyBudget(epsilon_limit=float("inf"), delta_limit=1.0)
        )
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        # guards metrics/scheduler-feedback mutations and the generator,
        # so a front may plan batch k+1 while batch k executes; the heavy
        # device work runs outside the lock
        self._phase_lock = threading.Lock()
        # the per-query (ε, δ) price is constant (fixed scheme, fixed n):
        # compute once so admission is O(1) float math
        self._eps_per_query, self._delta_per_query = self.staged.privacy(
            store.n
        )
        self.metrics = {
            "queries": 0, "batches": 0, "records_touched": 0.0,
            "blocks_sent": 0.0, "refused": 0, "padded": 0, "truncated": 0,
            "d_effective": float(self.staged.d),
            "epsilon_per_query": self._eps_per_query,
            "delta_per_query": self._delta_per_query,
            "ingests": 0, "records_ingested": 0,
        }

    # ------------------------------------------------------------ clients
    def budget(self, client: str) -> PrivacyBudget:
        if client not in self._budgets:
            self._budgets[client] = self._default_budget()
        return self._budgets[client]

    def set_budget(self, client: str, budget: PrivacyBudget) -> None:
        """Install a per-client budget ahead of traffic; clients never
        installed fall back to ``default_budget`` on first contact."""
        self._budgets[client] = budget

    @property
    def price(self) -> Tuple[float, float]:
        """The per-query (ε, δ) admission price."""
        return self._eps_per_query, self._delta_per_query

    def submit_request(self, client: str, index: int) -> Optional[Request]:
        """Queue one query; None if the client's privacy budget refuses.
        Spending happens here, at admission; a refusal spends nothing."""
        eps, delta = self._eps_per_query, self._delta_per_query
        if not self.budget(client).can_spend(eps, delta):
            self.metrics["refused"] += 1
            return None
        self.budget(client).spend(eps, delta)
        return self.scheduler.submit(client, index)

    def submit(self, client: str, index: int) -> bool:
        """Queue one query; False if the client's privacy budget refuses."""
        return self.submit_request(client, index) is not None

    def submit_request_many(
        self, client: str, indices
    ) -> Optional[Request]:
        """Queue one jagged multi-index request; None if refused.

        Admission charges the Composition-Lemma price up front: a k-index
        request is k sequential lookups, so it spends k·(ε, δ)."""
        k = len(indices)
        if k == 0:
            raise ValueError("submit_request_many needs at least one index")
        eps, delta = self._eps_per_query, self._delta_per_query
        if not self.budget(client).can_spend(k * eps, k * delta):
            self.metrics["refused"] += 1
            return None
        self.budget(client).spend(k * eps, k * delta)
        return self.scheduler.submit_many(client, indices)

    def submit_many(self, client: str, indices) -> bool:
        """Queue one multi-index request; False if the budget refuses."""
        return self.submit_request_many(client, indices) is not None

    # ------------------------------------------------------------ serving
    def fastest_servers(self, t: int) -> List[int]:
        return self.backend.fastest(t)

    @property
    def stats(self) -> Dict[int, ServerStats]:
        return self.backend.stats

    def plan_requests(self, batch: List[Request]) -> Optional[PlannedBatch]:
        """Plan one cut batch without executing it: route the requests
        into per-server wire payloads and pre-resolve the batch's
        :class:`~repro_torch.kernels.backend.ExecutionPlan`. Client and
        planning work only — the server compute happens in
        :meth:`execute_planned`."""
        if not batch:
            return None
        if any(r.indices for r in batch):
            return self._plan_requests_multi(batch)
        b = len(batch)
        padded = self.scheduler.padded_size(b)
        clock = self.scheduler.clock
        q_idx = torch.tensor(
            [r.index for r in batch] + [0] * (padded - b),
            dtype=torch.int32, device=self.device,
        )
        with self._phase_lock:
            # pin the batch's snapshot under the lock: routing (n),
            # execution and reconstruction all read the pinned store,
            # never a newer head
            store, ver = self.store, self.store_version
            self.metrics["queries"] += b
            # the plan timer starts only once the phase lock is held:
            # waiting for a concurrent execute's bookkeeping is queue
            # contention, not plan cost
            t0 = clock()
            # the generator is the pipeline's one stream of client
            # randomness: draws are serialised under the lock
            routed = self.router.plan(self._gen, store.n, q_idx)
        if self.live is not None:
            routed.store_version = ver
        exec_plan = self.backend.prepare(routed, scheme=self.staged)
        plan_s = clock() - t0
        return PlannedBatch(
            batch=list(batch), padded=padded, routed=routed,
            exec_plan=exec_plan, plan_s=plan_s, store=store,
            store_version=ver,
        )

    def _plan_requests_multi(self, batch: List[Request]) -> PlannedBatch:
        """The multi-index half of :meth:`plan_requests`: the batch's
        jagged index lists (a single-index request is a list of one)
        flatten into one padded
        :class:`~repro_torch.core.protocol.MultiQueries` wire batch via
        :meth:`~repro_torch.serve.router.SchemeRouter.plan_many`. The
        ``queries`` metric counts flattened indices: each is a priced
        lookup."""
        lists = [list(r.index_list) for r in batch]
        padded = multi_bucket(lists)
        clock = self.scheduler.clock
        with self._phase_lock:
            store, ver = self.store, self.store_version  # pin (see above)
            self.metrics["queries"] += sum(r.k for r in batch)
            t0 = clock()
            routed = self.router.plan_many(self._gen, store.n, lists)
        if self.live is not None:
            routed.queries.store_version = ver  # the flat wire carries it
        exec_plan = self.backend.prepare(routed, scheme=self.staged)
        plan_s = clock() - t0
        return PlannedBatch(
            batch=list(batch), padded=padded, routed=routed,
            exec_plan=exec_plan, plan_s=plan_s, store=store,
            store_version=ver, lists=lists,
        )

    @staticmethod
    def _assemble(r: Request, rows: np.ndarray) -> np.ndarray:
        """A request's answer from its per-index record bytes: [k, nbytes]
        for a multi-index request, flat [nbytes] for a single-index one."""
        if r.indices:
            return np.array(rows)
        return np.array(rows[0])

    def _execute_planned_multi(
        self, planned: PlannedBatch
    ) -> List[Tuple[Request, np.ndarray]]:
        """Execute a multi-index planned batch: one backend answer for the
        whole flattened wire batch, ONE flat reconstruction and one
        device-to-host copy; request r's i-th index is flat row
        r·k_max + i, so the per-request split is numpy slicing."""
        routed = planned.routed
        clock = self.scheduler.clock
        t1 = clock()
        responses = self.backend.answer_batch(
            routed, plan=planned.exec_plan, scheme=self.staged,
            store=planned.store,
        )
        flat_out = self.router.finalize(routed, responses)
        synchronize(self.device)
        dt = planned.plan_s + (clock() - t1)

        nbytes = -(-planned.store.record_bits // 8)
        raw_all = packing.unpack_bytes_np(
            packing.words_to_numpy(flat_out), nbytes
        )
        k_max = routed.k_max
        flat_total = sum(len(lst) for lst in planned.lists)
        with self._phase_lock:
            self.scheduler.observe_service(planned.padded, dt)
            self.metrics["batches"] += 1
            self.metrics["padded"] += planned.padded - flat_total
            costs = self.staged.costs(planned.store.n)
            self.metrics["records_touched"] += costs["C_p"] / 2.0 * flat_total
            self.metrics["blocks_sent"] += costs["C_m"] * flat_total
        return [
            (r, self._assemble(
                r, raw_all[j * k_max: j * k_max + len(planned.lists[j])]))
            for j, r in enumerate(planned.batch)
        ]

    def execute_planned(
        self, planned: Optional[PlannedBatch]
    ) -> List[Tuple[Request, np.ndarray]]:
        """Execute a planned batch on the backend and finalize:
        [(Request, record bytes)] in the planned batch's order. The device
        compute runs outside the pipeline's phase lock."""
        if planned is None:
            return []
        if planned.lists is not None:  # a jagged multi-index batch
            return self._execute_planned_multi(planned)
        batch = planned.batch
        b = len(batch)
        routed = planned.routed
        # service time = this batch's own plan + execute wall time, read
        # on the scheduler's clock so fake-clock tests can pin exactly
        # what the EMA is fed; the interval ends in a device
        # synchronisation so it times the work and not its enqueue
        clock = self.scheduler.clock
        t1 = clock()
        responses = self.backend.answer_batch(
            routed, plan=planned.exec_plan, scheme=self.staged,
            store=planned.store,
        )
        out = self.router.finalize(routed, responses)
        synchronize(self.device)
        dt = planned.plan_s + (clock() - t1)

        nbytes = -(-planned.store.record_bits // 8)
        raw = packing.unpack_bytes_np(packing.words_to_numpy(out[:b]), nbytes)
        with self._phase_lock:
            self.scheduler.observe_service(planned.padded, dt)
            self.metrics["batches"] += 1
            self.metrics["padded"] += planned.padded - b
            costs = self.staged.costs(planned.store.n)
            self.metrics["records_touched"] += costs["C_p"] / 2.0 * b
            self.metrics["blocks_sent"] += costs["C_m"] * b
        return [(r, np.array(raw[j])) for j, r in enumerate(batch)]

    def serve_requests(
        self, batch: List[Request]
    ) -> List[Tuple[Request, np.ndarray]]:
        """Serve one cut batch, per request: [(Request, record bytes)].
        ``serve_requests = execute_planned ∘ plan_requests``."""
        return self.execute_planned(self.plan_requests(batch))

    def take_batch(self) -> List[Request]:
        """Pop the next batch off the scheduler (≤ max_batch; truncation
        leaves the rest queued)."""
        if not len(self.scheduler):
            return []
        batch = self.scheduler.next_batch()
        if len(self.scheduler):
            self.metrics["truncated"] += 1
        return batch

    # ------------------------------------------------------------- ingest
    def _require_live(self) -> VersionedStore:
        if self.live is None:
            raise RuntimeError(
                "pipeline serves a frozen RecordStore; construct it over "
                "a VersionedStore to ingest deltas"
            )
        return self.live

    def ingest(self, delta: Delta) -> int:
        """Apply one delta to the live store and roll the serve path
        forward; returns the new store version.

        Under the phase lock, in order: (1) the
        :class:`~repro_torch.db.live.VersionedStore` applies the delta on
        its device and installs a new frozen head; (2) the execution
        backend swaps onto it — a same-shape delta keeps every cached
        plan and refreshes only the touched bitplane rows, an append
        re-plans; (3) admission re-prices (ε, δ) when ``n`` changed.
        Batches planned before this call still answer against their
        pinned snapshot."""
        live = self._require_live()
        with self._phase_lock:
            touched = live.touched_rows(delta, n_before=live.n)
            ver = live.ingest(delta)
            snap = live.snapshot()
            same_shape = (
                snap.n == self.store.n and snap.words == self.store.words
            )
            self.backend.swap_store(snap, touched_rows=touched, live=live)
            self.store = snap
            self.store_version = ver
            if not same_shape:
                # an append grew n: the admission price is a function of n
                self._eps_per_query, self._delta_per_query = (
                    self.staged.privacy(snap.n)
                )
                self.metrics["epsilon_per_query"] = self._eps_per_query
                self.metrics["delta_per_query"] = self._delta_per_query
            self.metrics["ingests"] += 1
            self.metrics["records_ingested"] += delta.count
            return ver

    def queue_delta(self, delta: Delta) -> None:
        """Enqueue a delta for a later :meth:`ingest_step`."""
        self._require_live()
        with self._phase_lock:
            self._pending_deltas.append(delta)

    @property
    def pending_deltas(self) -> int:
        """Deltas queued but not yet applied."""
        return len(self._pending_deltas)

    def ingest_step(self, max_deltas: int = 1) -> int:
        """Apply up to ``max_deltas`` queued deltas, oldest first. Returns
        how many were applied."""
        done = 0
        while done < max_deltas:
            with self._phase_lock:
                if not self._pending_deltas:
                    break
                delta = self._pending_deltas.pop(0)
            self.ingest(delta)
            done += 1
        return done

    def compact_step(self, *, min_log_depth: int = 1) -> int:
        """Rebase the live store's delta log onto its current head when
        the log is at least ``min_log_depth`` deep; the store's oracle
        check replays the log on the host and holds it bit for bit against
        the head first. Returns how many deltas were compacted away (0:
        frozen store, shallow log, or a write raced the check). No phase
        lock: compaction changes neither the head nor the version."""
        if self.live is None or self.live.log_depth < max(1, min_log_depth):
            return 0
        return self.live.compact()

    def step(self) -> Dict[str, np.ndarray]:
        """Serve at most one scheduled batch (≤ max_batch; the rest of the
        queue stays). Returns client → record bytes for the served batch."""
        return {r.client: a for r, a in self.serve_requests(self.take_batch())}

    def poll(self) -> Dict[str, np.ndarray]:
        """The async-style entry point: serve one batch only if the
        scheduler says it's time (adaptive target reached, or the oldest
        request hit the max_wait deadline); {} otherwise."""
        return self.step() if self.scheduler.ready() else {}

    def flush(self) -> Dict[str, np.ndarray]:
        """Drain the whole queue in max_batch-sized steps."""
        out: Dict[str, np.ndarray] = {}
        while len(self.scheduler):
            out.update(self.step())
        return out


class PIRServingEngine(ServingPipeline):
    """Back-compat facade: the pre-refactor engine's exact surface."""

    def __init__(
        self,
        store: RecordStore,
        scheme,
        *,
        max_batch: int = 1024,
        default_budget: Optional[Callable[[], PrivacyBudget]] = None,
        simulate_latency: Optional[Callable[[int], float]] = None,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        super().__init__(
            store,
            scheme,
            scheduler=BatchScheduler(max_batch=max_batch),
            default_budget=default_budget,
            simulate_latency=simulate_latency,
            seed=seed,
            device=device,
        )
        self.max_batch = max_batch

    def flush(self) -> Dict[str, np.ndarray]:
        """Old contract: serve ONE batch of at most max_batch; anything
        beyond max_batch stays queued for the next flush() call."""
        return self.step()
