"""The serving pipeline: queue → router → execution backend.

This is the production face of the paper: clients submit (client_id,
index) requests; the :class:`~repro_torch.serve.scheduler.BatchScheduler`
batches them and pads to power-of-two buckets; the
:class:`~repro_torch.serve.router.SchemeRouter` drives the configured
scheme's staged protocol (DESIGN.md §Scheme protocol) to turn each batch
into per-server payloads; the
:class:`~repro_torch.serve.sharded.ShardedBackend` answers them with the
GF(2) kernels over the bit-packed store on one device.

Privacy is enforced at admission: every accepted query spends its scheme's
(ε, δ) from the client's :class:`~repro_torch.core.accounting.PrivacyBudget`
(sequential composition, §2.2) and exhausted clients are refused.

Not ported yet (ROADMAP.md Queue A; passing them raises
``NotImplementedError``): the cross-batch ``QueryCache``, live
``VersionedStore`` ingest, multi-index requests, replica-loss degradation
and the async front.

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
from repro_torch.core.protocol import Queries, SchemeProtocol, as_protocol
from repro_torch.db import packing
from repro_torch.db.store import RecordStore
from repro_torch.kernels.backend import ExecutionPlan
from repro_torch.serve.router import SchemeRouter
from repro_torch.serve.scheduler import BatchScheduler, Request
from repro_torch.serve.sharded import ServerStats, ShardedBackend

__all__ = ["ServerStats", "PlannedBatch", "ServingPipeline", "PIRServingEngine"]


@dataclasses.dataclass
class PlannedBatch:
    """One cut batch, planned but not yet executed: the requests routed
    into wire-level ``routed`` payloads with the batch's
    :class:`~repro_torch.kernels.backend.ExecutionPlan` pre-resolved."""

    batch: List[Request]
    padded: int
    routed: Queries
    exec_plan: ExecutionPlan
    plan_s: float  # wall time the plan phase itself took
    store: RecordStore


class ServingPipeline:
    """Batch-scheduled, scheme-routed PIR serving on one device.

    ``device=None`` means the CUDA card (an error without one); the store
    must already lie there. ``seed`` seeds the pipeline's one
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
        if hasattr(store, "snapshot") and hasattr(store, "ingest"):
            raise NotImplementedError(
                "live VersionedStore serving is not ported yet; see "
                "ROADMAP.md Queue A"
            )
        dev = resolve_device(device)
        if store.device.type != dev.type:
            raise ValueError(
                f"store lies on {store.device}, pipeline was asked for {dev}"
            )
        self.store = store
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

    def submit_many(self, client: str, indices) -> bool:
        raise NotImplementedError(
            "multi-index requests are not ported yet; see ROADMAP.md Queue A"
        )

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
        store = self.store
        b = len(batch)
        padded = self.scheduler.padded_size(b)
        clock = self.scheduler.clock
        q_idx = torch.tensor(
            [r.index for r in batch] + [0] * (padded - b),
            dtype=torch.int32, device=self.device,
        )
        with self._phase_lock:
            self.metrics["queries"] += b
            # the plan timer starts only once the phase lock is held:
            # waiting for a concurrent execute's bookkeeping is queue
            # contention, not plan cost
            t0 = clock()
            # the generator is the pipeline's one stream of client
            # randomness: draws are serialised under the lock
            routed = self.router.plan(self._gen, store.n, q_idx)
        exec_plan = self.backend.prepare(routed, scheme=self.staged)
        plan_s = clock() - t0
        return PlannedBatch(
            batch=list(batch), padded=padded, routed=routed,
            exec_plan=exec_plan, plan_s=plan_s, store=store,
        )

    def execute_planned(
        self, planned: Optional[PlannedBatch]
    ) -> List[Tuple[Request, np.ndarray]]:
        """Execute a planned batch on the backend and finalize:
        [(Request, record bytes)] in the planned batch's order. The device
        compute runs outside the pipeline's phase lock."""
        if planned is None:
            return []
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
            routed, plan=planned.exec_plan, scheme=self.staged
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
