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

Straggler mitigation = Subset-PIR (paper §5.1): the backend's per-replica
latency EMAs rank the databases and the router contacts only the fastest
``t`` — the paper's own optimisation *is* the straggler policy, with its
privacy price δ accounted per query.

With a :class:`~repro_torch.serve.cache.QueryCache` attached, the pipeline
memoizes per-(client, index) answers across flushes and consumes
pre-generated batch randomness banked by :meth:`ServingPipeline.
prefill_cache`. Admission spends the budget *before* the cache is ever
consulted, so a hit is priced exactly like a miss and exhausted clients
are refused even when their answer sits in cache (DESIGN.md §Cross-batch
cache). :meth:`ServingPipeline.autotune_step` runs the execution
planner's measured search for cells planned from the prior; a caller
invokes it (with :meth:`prefill_cache`) when the pipeline is idle.

A pipeline built over a live :class:`~repro_torch.db.live.VersionedStore`
serves its current frozen head and applies deltas with :meth:`ingest`;
every batch pins the snapshot it was planned against and is answered
against it, whatever lands in between.

Replica loss degrades rather than stops the service:
:meth:`ServingPipeline.degrade_replicas` re-fits the scheme to the
survivors and re-prices admission, and refuses everyone once the
survivors could all be corrupt. The pipeline itself stays single-threaded;
the thread-safe concurrent front over it is
:class:`~repro_torch.serve.frontend.AsyncFrontend`.

:class:`PIRServingEngine` is the back-compat facade over the pipeline.
"""

from __future__ import annotations

import dataclasses
import itertools
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
from repro_torch.dist.fault import (
    RemeshPlan,
    plan_elastic_remesh,
    scheme_degradation,
)
from repro_torch.kernels.backend import ExecutionPlan
from repro_torch.serve.cache import QueryCache, block_pre_ready, scheme_signature
from repro_torch.serve.router import SchemeRouter
from repro_torch.serve.scheduler import BatchScheduler, Request
from repro_torch.serve.sharded import ServerStats, ShardedBackend
from repro_torch.serve.spans import span

__all__ = ["ServerStats", "PlannedBatch", "ServingPipeline", "PIRServingEngine"]


@dataclasses.dataclass
class PlannedBatch:
    """One cut batch, planned but not yet executed: cache hits already
    resolved into ``results``, misses routed into wire-level ``routed``
    payloads (a ``MultiQueries`` for a jagged batch) with the batch's
    :class:`~repro_torch.kernels.backend.ExecutionPlan` pre-resolved.
    ``routed`` and ``exec_plan`` are None when every request hit.

    ``store`` and ``store_version`` pin the frozen snapshot the batch
    answers against: a write landing mid-batch makes a new head, and this
    batch keeps answering — and memoizing, under this version — against
    the store it was planned on. ``miss_lists`` holds the per-miss-request
    index lists that went to the wire and ``partial`` each miss request's
    per-index cached answers (None = fresh) on a jagged batch; both are
    None on the single-index path. ``seq`` is the batch's number, which
    its profiler ranges carry (``serve/spans.py``)."""

    batch: List[Request]
    results: List[Optional[Tuple[Request, np.ndarray]]]
    misses: List[Request]
    miss_pos: List[int]
    padded: int
    routed: Optional[Queries]
    exec_plan: Optional[ExecutionPlan]
    plan_s: float  # wall time the plan phase itself took
    store: RecordStore
    store_version: int = 0
    miss_lists: Optional[List[List[int]]] = None
    partial: Optional[List[List[Optional[np.ndarray]]]] = None
    seq: int = -1


class ServingPipeline:
    """Batch-scheduled, scheme-routed PIR serving on one device.

    ``store`` is a frozen :class:`RecordStore` or a live
    :class:`~repro_torch.db.live.VersionedStore` (duck-typed: anything
    with ``snapshot()``/``ingest()``); ``self.store`` is always a frozen
    snapshot. ``device=None`` means the CUDA card (an error without one);
    the store must already lie there. ``seed`` seeds the pipeline's one
    ``torch.Generator``, from which every batch's query randomness is
    drawn in turn. ``cache`` must be signed for this scheme and store
    size (:func:`~repro_torch.serve.cache.scheme_signature`).
    """

    def __init__(
        self,
        store: RecordStore,
        scheme,
        *,
        scheduler: Optional[BatchScheduler] = None,
        backend: Optional[ShardedBackend] = None,
        cache: Optional[QueryCache] = None,
        default_budget: Optional[Callable[[], PrivacyBudget]] = None,
        simulate_latency: Optional[Callable[[int], float]] = None,
        seed: int = 0,
        device: DeviceLike = None,
    ):
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
        # the straggler policy rides along unconditionally; only schemes
        # whose query() consumes pick_servers (Subset-PIR) ever look at it
        self.router = SchemeRouter(
            self.staged, pick_servers=self.backend.fastest
        )
        if cache is not None and cache.signature != scheme_signature(
            scheme, store.n
        ):
            raise ValueError(
                f"cache built for {cache.signature}, pipeline serves "
                f"{scheme_signature(scheme, store.n)}"
            )
        self.cache = cache
        self._budgets: Dict[str, PrivacyBudget] = {}
        self._default_budget = default_budget or (
            lambda: PrivacyBudget(epsilon_limit=float("inf"), delta_limit=1.0)
        )
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        # guards cache/metrics/scheduler-feedback mutations and the
        # generator, so a front may plan batch k+1 while batch k executes;
        # the heavy device work runs outside the lock
        self._phase_lock = threading.Lock()
        # the per-query (ε, δ) price is constant between remeshes (fixed
        # scheme, fixed n): compute once so admission is O(1) float math;
        # degrade_replicas re-prices it when survivors shrink the scheme
        self._eps_per_query, self._delta_per_query = self.staged.privacy(
            store.n
        )
        # replica-loss state: the healthy scheme is kept so cumulative
        # failures always degrade from the original d, not from an
        # already-degraded intermediate
        self._base_staged: SchemeProtocol = self.staged
        self._failed_replicas: set = set()
        self._serviceable = True
        self.last_remesh: Optional[RemeshPlan] = None
        self.degraded: Optional[Dict[str, float]] = None
        self.metrics = {
            "queries": 0, "batches": 0, "records_touched": 0.0,
            "blocks_sent": 0.0, "refused": 0, "padded": 0, "truncated": 0,
            "cache_hits": 0, "remeshes": 0,
            "d_effective": float(self.staged.d),
            "epsilon_per_query": self._eps_per_query,
            "delta_per_query": self._delta_per_query,
            "unserviceable": 0,
            "ingests": 0, "records_ingested": 0,
        }
        # counters of the serving stages beyond the reference's key set:
        # the seconds lookups waited from submit to their batch's cut, and
        # how many were cut (accumulated in take_batch, on the scheduler's
        # clock)
        self.stage_metrics = {"queue_wait_s": 0.0, "queue_waited": 0}
        # Request.seq -> when the front took it in, on the scheduler's
        # clock (a request without one waited from its admission)
        self._submitted: Dict[int, float] = {}
        self._batch_seq = itertools.count()

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
        """The per-query (ε, δ) admission price currently charged.
        Constant between remeshes; replica loss re-prices it through
        :meth:`degrade_replicas` ((∞, δ) once unserviceable)."""
        return self._eps_per_query, self._delta_per_query

    def _budget_token(self, client: str) -> tuple:
        """Hashable snapshot of the client's budget state. ``can_spend``
        is a pure function of this state and the pipeline's fixed price,
        so the cache's refusal memo keyed on it can never go stale."""
        b = self.budget(client)
        return (b.epsilon_limit, b.delta_limit, b.spent_epsilon, b.spent_delta)

    def submit_request(
        self, client: str, index: int, *, t_submit: Optional[float] = None
    ) -> Optional[Request]:
        """Queue one query; None if the client's privacy budget refuses.
        ``t_submit`` (the scheduler's clock) is when a front took the query
        in, ahead of admission: its queue wait is counted from there.

        Spending happens here, at admission — before the cache is ever
        consulted — so a cache hit is priced exactly like a miss. The
        cache's refusal memo short-circuits repeated over-budget polls: it
        is keyed on the exact budget state the refusal was computed from,
        so any budget change re-consults the accountant. A refusal spends
        nothing.

        An unserviceable pipeline (replica loss left d' ≤ d_a: privacy
        would rest entirely on corrupt servers) refuses everyone — an
        explicit flag, not an ∞ price, because the default budget's ∞
        limit would happily "afford" ∞."""
        if not self._serviceable:
            self.metrics["refused"] += 1
            return None
        if self.cache is not None and self.cache.refused(
            client, self._budget_token(client)
        ):
            self.metrics["refused"] += 1
            return None
        eps, delta = self._eps_per_query, self._delta_per_query
        if not self.budget(client).can_spend(eps, delta):
            if self.cache is not None:
                self.cache.note_refusal(client, self._budget_token(client))
            self.metrics["refused"] += 1
            return None
        self.budget(client).spend(eps, delta)
        return self._stamped(self.scheduler.submit(client, index), t_submit)

    def _stamped(self, req: Request, t_submit: Optional[float]) -> Request:
        if t_submit is not None:
            self._submitted[req.seq] = t_submit
        return req

    def submit(self, client: str, index: int) -> bool:
        """Queue one query; False if the client's privacy budget refuses."""
        return self.submit_request(client, index) is not None

    def submit_request_many(
        self, client: str, indices, *, t_submit: Optional[float] = None
    ) -> Optional[Request]:
        """Queue one jagged multi-index request; None if refused
        (``t_submit`` as for :meth:`submit_request`).

        Admission charges the Composition-Lemma price up front: a k-index
        request is k sequential lookups, so it spends k·(ε, δ) — before
        the cache is consulted, and hits on any of its indices never
        refund it. The refusal memo is keyed on the *fixed* per-query
        price, so a variable-k request consults the accountant directly."""
        k = len(indices)
        if k == 0:
            raise ValueError("submit_request_many needs at least one index")
        if not self._serviceable:
            self.metrics["refused"] += 1
            return None
        eps, delta = self._eps_per_query, self._delta_per_query
        if not self.budget(client).can_spend(k * eps, k * delta):
            self.metrics["refused"] += 1
            return None
        self.budget(client).spend(k * eps, k * delta)
        return self._stamped(self.scheduler.submit_many(client, indices),
                             t_submit)

    def submit_many(self, client: str, indices) -> bool:
        """Queue one multi-index request; False if the budget refuses."""
        return self.submit_request_many(client, indices) is not None

    # ------------------------------------------------------------ serving
    def fastest_servers(self, t: int) -> List[int]:
        return self.backend.fastest(t)

    @property
    def stats(self) -> Dict[int, ServerStats]:
        return self.backend.stats

    # ------------------------------------------------------- replica loss
    def degrade_replicas(self, failed: List[int]) -> Dict[str, float]:
        """Replica-loss hook: degrade, don't outage. Wired to
        :class:`~repro_torch.dist.fault.HeartbeatMonitor`'s failure edge by
        the fleet harness; callable directly by ops.

        ``failed`` are replica ids of the *original* d-server deployment
        (cumulative: ids union with prior losses; repeats are no-ops). The
        pipeline (1) accounts the degradation —
        :func:`~repro_torch.dist.fault.scheme_degradation` re-fits the
        scheme to the d' survivors and prices it with
        ``pir_degraded_privacy``; (2) swaps in the degraded scheme,
        re-pricing admission at the new (ε, δ); (3) relabels the backend's
        survivors and rebuilds the router; (4) invalidates and re-signs the
        cache (old-d randomness is unreplayable on the survivor wire); (5)
        records the :func:`~repro_torch.dist.fault.plan_elastic_remesh`
        plan (as data: nothing is remeshed on the device). Once d' ≤ d_a
        the pipeline flips unserviceable and refuses all admission.

        Batches planned before the swap still execute and resolve — their
        wire bits went out under the old scheme, which was honestly priced
        when their clients were admitted. Returns the degraded-privacy
        dict."""
        with self._phase_lock:
            fresh = {int(f) for f in failed} - self._failed_replicas
            if not fresh:
                if self.degraded is not None:
                    return dict(self.degraded)
                return {
                    "d_effective": float(self.staged.d), "serviceable": 1.0,
                    "epsilon": self._eps_per_query,
                    "delta": self._delta_per_query,
                }
            self._failed_replicas |= fresh
            d0 = self._base_staged.d
            survivors = [
                r for r in range(d0) if r not in self._failed_replicas
            ]
            degraded_scheme, info = scheme_degradation(
                self._base_staged, self.store.n, len(self._failed_replicas)
            )
            self.degraded = info
            self.metrics["remeshes"] += 1
            self.metrics["d_effective"] = info["d_effective"]
            self.last_remesh = (
                plan_elastic_remesh(survivors) if survivors else None
            )
            if degraded_scheme is None:
                self._serviceable = False
                self.metrics["unserviceable"] = 1
                self._eps_per_query = float("inf")
                self._delta_per_query = info["delta"]
                self.metrics["epsilon_per_query"] = float("inf")
                self.metrics["delta_per_query"] = info["delta"]
                return dict(info)
            self.scheme = self.staged = degraded_scheme
            self._eps_per_query = info["epsilon"]
            self._delta_per_query = info["delta"]
            self.metrics["epsilon_per_query"] = self._eps_per_query
            self.metrics["delta_per_query"] = self._delta_per_query
            self.backend.relabel_replicas(survivors)
            self.router = SchemeRouter(
                self.staged, pick_servers=self.backend.fastest
            )
            if self.cache is not None:
                # banked pres and memoized columns were drawn for the old
                # d; the refusal memo goes too (the price rose, so
                # re-consulting the accountant is the only safe direction)
                self.cache.invalidate()
                self.cache.signature = scheme_signature(
                    degraded_scheme, self.store.n
                )
            return dict(info)

    def plan_requests(self, batch: List[Request]) -> Optional[PlannedBatch]:
        """Plan one cut batch without executing it: resolve cache hits,
        route the misses into per-server wire payloads (consuming banked
        precomputed randomness for the bucket when there is some) and
        pre-resolve the batch's
        :class:`~repro_torch.kernels.backend.ExecutionPlan`. Client and
        planning work only — the server compute happens in
        :meth:`execute_planned`. The batch takes the next number, which
        its ranges carry (``plan#k`` here)."""
        if not batch:
            return None
        seq = next(self._batch_seq)
        with span("plan", seq):
            planned = (self._plan_requests_multi(batch)
                       if any(r.indices for r in batch)
                       else self._plan_requests_single(batch))
        planned.seq = seq
        return planned

    def _plan_requests_single(self, batch: List[Request]) -> PlannedBatch:
        """The single-index half of :meth:`plan_requests`."""
        results: List[Optional[Tuple[Request, np.ndarray]]] = [None] * len(batch)
        with self._phase_lock, span("plan.cache"):
            # pin the batch's snapshot under the lock: routing (n),
            # execution, reconstruction and cache stamps all read the
            # pinned store, never a newer head
            store, ver = self.store, self.store_version
            if self.cache is not None:
                misses, miss_pos = [], []
                for i, r in enumerate(batch):
                    entry = self.cache.lookup(r.client, r.index)
                    if entry is not None:
                        results[i] = (r, entry.answer)
                    else:
                        misses.append(r)
                        miss_pos.append(i)
            else:
                misses, miss_pos = list(batch), list(range(len(batch)))
            self.metrics["queries"] += len(batch)
            self.metrics["cache_hits"] += len(batch) - len(misses)

        routed = exec_plan = None
        padded = 0
        plan_s = 0.0
        clock = self.scheduler.clock
        if misses:
            b = len(misses)
            padded = self.scheduler.padded_size(b)
            q_idx = torch.tensor(
                [r.index for r in misses] + [0] * (padded - b),
                dtype=torch.int32, device=self.device,
            )
            with self._phase_lock:
                # the plan timer starts only once the phase lock is held:
                # waiting for a concurrent execute's bookkeeping is queue
                # contention, not plan cost
                t0 = clock()
                pre = (
                    self.cache.take_pre(padded)
                    if self.cache is not None else None
                )
                # the generator is the pipeline's one stream of client
                # randomness: draws are serialised under the lock
                with span("plan.route"):
                    routed = self.router.plan(self._gen, store.n, q_idx,
                                              pre=pre)
            if self.live is not None:
                routed.store_version = ver
            with span("plan.prepare"):
                exec_plan = self.backend.prepare(routed, scheme=self.staged)
            plan_s = clock() - t0
        return PlannedBatch(
            batch=list(batch), results=results, misses=misses,
            miss_pos=miss_pos, padded=padded, routed=routed,
            exec_plan=exec_plan, plan_s=plan_s, store=store,
            store_version=ver,
        )

    def _plan_requests_multi(self, batch: List[Request]) -> PlannedBatch:
        """The multi-index half of :meth:`plan_requests`: cache hits
        resolve *per (client, index)* — a request whose indices all hit
        never touches a wire, and partially-hit requests send only their
        missing indices — and the remaining jagged lists (a single-index
        request is a list of one) flatten into one padded
        :class:`~repro_torch.core.protocol.MultiQueries` wire batch via
        :meth:`~repro_torch.serve.router.SchemeRouter.plan_many`. The
        ``queries`` and ``cache_hits`` metrics count flattened indices:
        each is a priced lookup."""
        results: List[Optional[Tuple[Request, np.ndarray]]] = [None] * len(batch)
        misses: List[Request] = []
        miss_pos: List[int] = []
        miss_lists: List[List[int]] = []
        partial: List[List[Optional[np.ndarray]]] = []
        with self._phase_lock, span("plan.cache"):
            store, ver = self.store, self.store_version  # pin (see above)
            for i, r in enumerate(batch):
                idxs = list(r.index_list)
                rows: List[Optional[np.ndarray]] = [None] * len(idxs)
                if self.cache is not None:
                    for j, ix in enumerate(idxs):
                        entry = self.cache.lookup(r.client, ix)
                        if entry is not None:
                            rows[j] = entry.answer
                if all(a is not None for a in rows):
                    results[i] = (r, self._assemble(r, rows))
                else:
                    misses.append(r)
                    miss_pos.append(i)
                    miss_lists.append(
                        [ix for j, ix in enumerate(idxs) if rows[j] is None]
                    )
                    partial.append(rows)
            flat_total = sum(r.k for r in batch)
            self.metrics["queries"] += flat_total
            self.metrics["cache_hits"] += flat_total - sum(
                len(lst) for lst in miss_lists
            )

        routed = exec_plan = None
        padded = 0
        plan_s = 0.0
        clock = self.scheduler.clock
        if misses:
            padded = multi_bucket(miss_lists)
            with self._phase_lock:
                t0 = clock()
                pre = (
                    self.cache.take_pre(padded)
                    if self.cache is not None else None
                )
                with span("plan.route"):
                    routed = self.router.plan_many(
                        self._gen, store.n, miss_lists, pre=pre)
            if self.live is not None:
                routed.queries.store_version = ver  # the flat wire carries it
            with span("plan.prepare"):
                exec_plan = self.backend.prepare(routed, scheme=self.staged)
            plan_s = clock() - t0
        return PlannedBatch(
            batch=list(batch), results=results, misses=misses,
            miss_pos=miss_pos, padded=padded, routed=routed,
            exec_plan=exec_plan, plan_s=plan_s, store=store,
            store_version=ver, miss_lists=miss_lists, partial=partial,
        )

    @staticmethod
    def _assemble(r: Request, rows) -> np.ndarray:
        """A request's answer from its per-index record bytes: [k, nbytes]
        for a multi-index request, flat [nbytes] for a single-index one."""
        if r.indices:
            return np.stack([np.asarray(a) for a in rows])
        return np.array(rows[0])

    def _query_cols(self, routed: Queries, b: int) -> Optional[np.ndarray]:
        """The wire payload's first ``b`` columns on the host, for the
        cache's memo — one copy for the whole payload, skipped when a
        single column would pass the cache's byte cap (a Sparse-PIR column
        at the CT scale is d·n = 100 MB)."""
        if self.cache is None:
            return None
        payload = routed.payload
        col_bytes = payload.numel() * payload.element_size() // max(
            1, int(payload.shape[1]))
        if col_bytes > self.cache.max_query_vector_bytes:
            return None
        return payload[:, :b].cpu().numpy()

    def _execute_planned_multi(
        self, planned: PlannedBatch
    ) -> List[Tuple[Request, np.ndarray]]:
        """Execute a multi-index planned batch: one backend answer for the
        whole flattened wire batch, ONE flat reconstruction and one
        device-to-host copy; request r's i-th wire index is flat row
        r·k_max + i, so the per-request split is numpy slicing. Fresh rows
        merge back into each request's cached slots in index order, and
        every fresh (client, index) answer is memoized."""
        results = planned.results
        if planned.routed is not None:
            routed = planned.routed
            clock = self.scheduler.clock
            t1 = clock()
            responses = self.backend.answer_batch(
                routed, plan=planned.exec_plan, scheme=self.staged,
                store=planned.store, seq=planned.seq,
            )
            with span("finalize"):
                flat_out = self.router.finalize(routed, responses)
            with span("execute.sync"):
                synchronize(self.device)
            dt = planned.plan_s + (clock() - t1)

            with span("execute.host"):
                nbytes = -(-planned.store.record_bits // 8)
                raw_all = packing.unpack_bytes_np(
                    packing.words_to_numpy(flat_out), nbytes
                )
                k_max = routed.k_max
                flat_total = sum(len(lst) for lst in planned.miss_lists)
                cols = self._query_cols(routed, int(routed.payload.shape[1]))
                with self._phase_lock:
                    self.scheduler.observe_service(planned.padded, dt)
                    self.metrics["batches"] += 1
                    self.metrics["padded"] += planned.padded - flat_total
                    costs = self.staged.costs(planned.store.n)
                    self.metrics["records_touched"] += (
                        costs["C_p"] / 2.0 * flat_total)
                    self.metrics["blocks_sent"] += costs["C_m"] * flat_total
                    for j, r in enumerate(planned.misses):
                        lst = planned.miss_lists[j]
                        fresh = raw_all[j * k_max: j * k_max + len(lst)]
                        rows = list(planned.partial[j])
                        f = 0
                        for pos in range(len(rows)):
                            if rows[pos] is not None:
                                continue
                            answer = np.array(fresh[f])
                            rows[pos] = answer
                            if self.cache is not None:
                                # request j's f-th wire index sits at flat
                                # column j·k_max + f (the padded layout)
                                self.cache.insert(
                                    r.client, lst[f], answer=answer,
                                    query_cols=(
                                        None if cols is None
                                        else cols[:, j * k_max + f]
                                    ),
                                    version=planned.store_version,
                                )
                            f += 1
                        results[planned.miss_pos[j]] = (
                            r, self._assemble(r, rows))
        return results  # type: ignore[return-value]

    def execute_planned(
        self, planned: Optional[PlannedBatch]
    ) -> List[Tuple[Request, np.ndarray]]:
        """Execute a planned batch's misses on the backend and finalize:
        [(Request, record bytes)] in the planned batch's order, every
        fresh answer memoized. The device compute runs outside the
        pipeline's phase lock. Runs in the range ``execute#k`` of the
        batch's number."""
        if planned is None:
            return []
        with span("execute", planned.seq):
            if planned.miss_lists is not None:  # a jagged multi-index batch
                return self._execute_planned_multi(planned)
            return self._execute_planned_single(planned)

    def _execute_planned_single(
        self, planned: PlannedBatch
    ) -> List[Tuple[Request, np.ndarray]]:
        """The single-index half of :meth:`execute_planned`."""
        results = planned.results
        if planned.routed is not None:
            misses, miss_pos = planned.misses, planned.miss_pos
            b = len(misses)
            routed = planned.routed
            # service time = this batch's own plan + execute wall time,
            # read on the scheduler's clock so fake-clock tests can pin
            # exactly what the EMA is fed; the interval ends in a
            # synchronisation of the stream the work was issued on (the
            # async front's side stream, or the default one), so it times
            # the work and not its enqueue, nor a next batch's planning
            clock = self.scheduler.clock
            t1 = clock()
            responses = self.backend.answer_batch(
                routed, plan=planned.exec_plan, scheme=self.staged,
                store=planned.store, seq=planned.seq,
            )
            with span("finalize"):
                out = self.router.finalize(routed, responses)
            with span("execute.sync"):
                synchronize(self.device)
            dt = planned.plan_s + (clock() - t1)

            with span("execute.host"):
                nbytes = -(-planned.store.record_bits // 8)
                raw = packing.unpack_bytes_np(
                    packing.words_to_numpy(out[:b]), nbytes)
                cols = self._query_cols(routed, b)
                with self._phase_lock:
                    self.scheduler.observe_service(planned.padded, dt)
                    self.metrics["batches"] += 1
                    self.metrics["padded"] += planned.padded - b
                    costs = self.staged.costs(planned.store.n)
                    self.metrics["records_touched"] += costs["C_p"] / 2.0 * b
                    self.metrics["blocks_sent"] += costs["C_m"] * b
                    for j, r in enumerate(misses):
                        answer = np.array(raw[j])
                        results[miss_pos[j]] = (r, answer)
                        if self.cache is not None:
                            self.cache.insert(
                                r.client, r.index, answer=answer,
                                query_cols=(None if cols is None
                                            else cols[:, j]),
                                version=planned.store_version,
                            )
        return results  # type: ignore[return-value]

    def serve_requests(
        self, batch: List[Request]
    ) -> List[Tuple[Request, np.ndarray]]:
        """Serve one cut batch, per request: [(Request, record bytes)].

        Cache hits are answered from the per-client memo without touching
        any server (their budget was already spent at admission); misses
        are routed as one padded batch and memoized on the way out.
        ``serve_requests = execute_planned ∘ plan_requests``."""
        return self.execute_planned(self.plan_requests(batch))

    def take_batch(self) -> List[Request]:
        """Pop the next batch off the scheduler (≤ max_batch; truncation
        leaves the rest queued), and count each request's wait from its
        submit (else its admission) to this cut into ``stage_metrics``."""
        if not len(self.scheduler):
            return []
        batch = self.scheduler.next_batch()
        if len(self.scheduler):
            self.metrics["truncated"] += 1
        now = self.scheduler.clock()
        waited = 0.0
        for r in batch:
            waited += now - self._submitted.pop(r.seq, r.t_enqueue)
        self.stage_metrics["queue_wait_s"] += waited
        self.stage_metrics["queue_waited"] += len(batch)
        return batch

    def prefill_cache(self, bucket: Optional[int] = None) -> int:
        """Bank one batch of precomputed query randomness for ``bucket``
        (default: the adaptive target's bucket — the shape full cuts land
        on), drawn from the pipeline's generator on its device. Call it
        while idle: it moves query generation off the serve critical
        path. Returns 1 if banked, 0 without a cache, for a scheme with no
        query-independent half (the direct family), or with the pool at
        its cap."""
        if self.cache is None:
            return 0
        if bucket is None:
            bucket = self.scheduler.padded_size(self.scheduler.target_batch)
        if bucket <= 0:
            return 0
        if self.cache.pre_depth(bucket) >= self.cache.max_pre_batches:
            return 0
        with self._phase_lock:
            signature = self.cache.signature
            pre = self.router.precompute(self._gen, self.store.n, bucket)
        if pre is None:  # no query-independent half
            return 0
        # computed here, on the producer: banking queued randomness would
        # just move the wait into the next flush
        block_pre_ready(pre)
        with self._phase_lock:
            # a remesh (degrade_replicas, from another thread) or an append
            # may have re-signed the cache while the draw computed: a pre
            # drawn for the old d or n must never be banked for the new one
            # (a router takes a pre of another d without a word, and its
            # answers then XOR the wrong servers)
            if self.cache.signature != signature:
                return 0
            return int(self.cache.put_pre(bucket, pre))

    def autotune_step(self, max_cells: int = 1) -> int:
        """Run the execution planner's autotune search for up to
        ``max_cells`` pending cells (DESIGN.md §Execution backends): the
        idle-time job beside :meth:`prefill_cache`, so cold cells planned
        from the analytic prior get their measured winner during lulls,
        never on a request. Returns cells tuned."""
        return self.backend.autotune_step(max_cells)

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
        re-plans; (3) the cache advances its version — entries for touched
        indices evict, untouched indices keep theirs, and an append
        re-signs it (dropping the pre pool and the refusal memo); (4)
        admission re-prices (ε, δ) when ``n`` changed. Batches planned
        before this call still answer against their pinned snapshot."""
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
            if self.cache is not None:
                self.cache.advance_version(
                    ver, [int(i) for i in touched],
                    signature=scheme_signature(self.scheme, snap.n),
                )
            if not same_shape and self._serviceable:
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
