"""Asynchronous ingest front: concurrent submits ahead of the scheduler.

The :class:`~repro_torch.serve.engine.ServingPipeline` is deliberately
single-threaded — admission (budget spend) and serving happen wherever the
caller stands. ``AsyncFrontend`` puts a thread-backed ingest stage in
front of it (DESIGN.md §Async front):

    callers ──submit()──► bounded ingest queue ──► ingest workers
                                                      │ admission under
                                                      │ the pipeline lock
                                                      ▼
                                                BatchScheduler
                                                      │
                     flush worker: deadline timers, ready() cuts,
                     idle-time cache prefill + autotune steps,
                     per-request futures

* **Concurrency contract**: any number of caller threads (or asyncio
  tasks via :meth:`asubmit`) may submit at once. ``ingest_workers``
  threads perform budget admission serially under one lock; exactly one
  flush worker owns the serve path (and therefore the pipeline's
  generator and cache), so the pipeline never needs internal locking.
* **Per-request futures**: ``submit`` returns a
  :class:`concurrent.futures.Future` resolving to the record bytes.
  A budget refusal resolves the future with :class:`PermissionError` —
  the same refusal the sync path signals by returning False.
* **Backpressure**: the ingest queue is bounded (``queue_limit``).
  ``shed_policy="reject"`` sheds at the door by raising
  :class:`BackpressureError`; ``"block"`` makes submit wait for room.
* **Deadline timers**: the flush worker sleeps exactly until the oldest
  queued request hits the scheduler's ``max_wait_s`` deadline, so partial
  batches cut on time without busy-polling.
* **Double-buffered flush** (default; ``double_buffer=False`` restores
  the single-threaded flush): the flush worker *plans* batch k+1 —
  cache lookups, query generation, the batch's
  :class:`~repro_torch.kernels.backend.ExecutionPlan` — while batch k's
  plan executes on a one-slot executor thread, then resolves batch k's
  futures before dispatching k+1 (DESIGN.md §Execution backends).
  Exactly one batch is ever in flight and one being planned, so the
  pipeline's phase lock is the only host synchronization the overlap
  needs; answers stay bit-identical to the sequential flush (the
  pipeline's generator is drawn in plan order, which the single flush
  worker serializes).
* **The execute stage on a side stream** (CUDA): both threads would
  otherwise launch on the default stream and the card would serialize
  them. The executor owns one ``torch.cuda.Stream``; before a batch's
  first launch it waits on an event recorded on the planning thread's
  stream right after that batch's plan, so it waits for that plan and not
  for the next one. The planned batch (masks, index matrices, a banked
  pre, the pinned snapshot ``planned.store``) stays referenced by the
  executor's call until the side stream has finished with it (the call
  ends in that stream's synchronisation), so the allocator never hands
  its memory to the planning stream early. Every latency sample on the
  execute stage ends in a synchronisation of the side stream alone
  (``repro_torch._device.synchronize``), never of the device. On the CPU
  there are no streams and the executor calls the pipeline directly. A
  failure on the executor fails that batch's futures; nothing is retried
  elsewhere. One deliberate
  tradeoff of the overlap: batch k+1 is planned before batch k's cache
  inserts land, so a (client, index) repeat in the *immediately*
  following batch can miss the memo and go out as a fresh (fully
  priced, fresh-randomness) query — answers and (ε, δ) accounting are
  unaffected, the hit just materializes one batch later.
* **Idle ingest + idle compaction + idle prefill + idle autotune**:
  between flushes the worker first applies one queued store delta
  (:meth:`~repro_torch.serve.engine.ServingPipeline.ingest_step` — writes
  submitted through :meth:`ingest` ride the same idle machinery as the
  other background jobs, and because idle jobs only run with no batch
  in flight, a delta can never land under a batch mid-execution), then
  — with ``compact_log_depth`` set — rebases the live store's delta
  log onto a new frozen base once it passes that depth
  (:meth:`~repro_torch.serve.engine.ServingPipeline.compact_step`,
  oracle-checked bit-identical to a from-scratch rebuild, never
  blocking a flush), then banks precomputed batch randomness into the
  cross-batch cache
  (:meth:`~repro_torch.serve.engine.ServingPipeline.prefill_cache`), moving
  query generation off the serve critical path — and runs one step of
  the execution backend's autotune search
  (:meth:`~repro_torch.serve.engine.ServingPipeline.autotune_step`) per lull,
  so plan cells served cold from the analytic prior acquire their
  measured winner without a request thread ever microbenchmarking.
  Ingest comes first in the idle sequence: freshness is client-visible,
  banked randomness is not. A delta is counted in ``metrics["ingested"]``
  under the same lock that :meth:`drain`'s idle test reads, and the front
  counts a delta as pending from before the pipeline pops it until it is
  counted, so :meth:`drain` never returns with a delta popped but not yet
  counted.
* **Graceful drain**: :meth:`drain` forces the backlog through (partial
  batches included) and blocks until every accepted future is resolved;
  ``close(drain=True)`` (also the context-manager exit) drains before
  stopping. ``close(drain=False)`` cancels whatever is still unserved;
  its wait for in-flight block-policy submitters to settle is bounded by
  ``drain_timeout_s`` on the *scheduler's* injected clock, so fake-clock
  tests control it like every other timeout in the stack.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.serve.engine import PlannedBatch, ServingPipeline
from repro_torch.serve.scheduler import Request

__all__ = ["BackpressureError", "AsyncFrontend"]

_SENTINEL = object()


class BackpressureError(RuntimeError):
    """The bounded ingest queue is full and the shed policy is 'reject'."""


class AsyncFrontend:
    """Thread-backed (and asyncio-compatible) ingest front over a
    :class:`~repro_torch.serve.engine.ServingPipeline`."""

    def __init__(
        self,
        pipeline: ServingPipeline,
        *,
        ingest_workers: int = 2,
        queue_limit: int = 4096,
        shed_policy: str = "reject",
        idle_tick_s: float = 0.005,
        drain_timeout_s: float = 1.0,
        prefill: bool = True,
        autotune: bool = True,
        double_buffer: bool = True,
        compact_log_depth: Optional[int] = None,
    ):
        if ingest_workers < 1:
            raise ValueError(f"need ingest_workers >= 1, got {ingest_workers}")
        if queue_limit < 1:
            raise ValueError(f"need queue_limit >= 1, got {queue_limit}")
        if shed_policy not in ("reject", "block"):
            raise ValueError(f"shed_policy must be reject|block, got {shed_policy!r}")
        if drain_timeout_s <= 0:
            raise ValueError(
                f"need drain_timeout_s > 0, got {drain_timeout_s}"
            )
        if compact_log_depth is not None and compact_log_depth < 1:
            raise ValueError(
                f"need compact_log_depth >= 1 (or None to disable), "
                f"got {compact_log_depth}"
            )
        self.pipeline = pipeline
        self.ingest_workers = ingest_workers
        self.shed_policy = shed_policy
        self.idle_tick_s = idle_tick_s
        self.drain_timeout_s = drain_timeout_s
        self.prefill = prefill
        self.autotune = autotune
        self.double_buffer = double_buffer
        self.compact_log_depth = compact_log_depth
        self._executor: Optional[ThreadPoolExecutor] = None
        # the execute stage's CUDA stream (None on the CPU)
        self._side: Optional["torch.cuda.Stream"] = None

        self._ingest: "queue.Queue" = queue.Queue(maxsize=queue_limit)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending: Dict[int, Future] = {}   # Request.seq -> future
        self._unadmitted = 0                    # queued but not yet admitted
        self._resolving = 0                     # popped but not yet resolved
        self._applying = 0                      # deltas being applied, uncounted
        self._draining = 0
        self._closed = False
        self._stop = False
        self._threads: List[threading.Thread] = []
        self._counters = {"accepted": 0, "shed": 0, "served": 0,
                          "failed": 0, "prefilled": 0, "autotuned": 0,
                          "ingested": 0, "compacted": 0}

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "AsyncFrontend":
        if self._threads:
            return self
        if self._closed:
            raise RuntimeError("frontend is closed")
        if self.double_buffer and self._executor is None:
            # the one-slot execute stage of the double-buffered flush:
            # exactly one batch in flight while the flush worker plans
            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="pir-exec"
            )
            dev = self.pipeline.device
            if dev.type == "cuda" and self._side is None:
                self._side = torch.cuda.Stream(dev)
        for i in range(self.ingest_workers):
            t = threading.Thread(
                target=self._ingest_loop, name=f"pir-ingest-{i}", daemon=True
            )
            t.start()
            self._threads.append(t)
        t = threading.Thread(
            target=self._flush_loop, name="pir-flush", daemon=True
        )
        t.start()
        self._threads.append(t)
        return self

    def __enter__(self) -> "AsyncFrontend":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close(drain=exc == (None, None, None))

    # -------------------------------------------------------------- ingest
    def submit(self, client: str, index: int) -> "Future[np.ndarray]":
        """Queue one query concurrently; resolves to the record bytes.

        Raises :class:`BackpressureError` when the bounded queue is full
        under the 'reject' shed policy; the future resolves with
        :class:`PermissionError` when the client's budget refuses.
        """
        return self._enqueue(client, int(index))

    def submit_many(self, client: str, indices) -> "Future[np.ndarray]":
        """Queue one jagged multi-index query; resolves to [k, nbytes]
        record-byte rows in index order (DESIGN.md §Multi-index wire
        format). Admission prices it at k·(ε, δ) — the Composition
        Lemma's k sequential lookups — in one budget decision; same
        backpressure and refusal contract as :meth:`submit`."""
        if not len(indices):
            raise ValueError("submit_many needs at least one index")
        return self._enqueue(client, tuple(int(i) for i in indices))

    def _enqueue(self, client: str, index) -> "Future[np.ndarray]":
        """Shared ingest path: ``index`` is an int (single query) or a
        tuple of ints (multi-index request)."""
        if self._closed:
            raise RuntimeError("frontend is closed to new submits")
        if not self._threads:
            self.start()
        fut: "Future[np.ndarray]" = Future()
        item = (client, index, fut)
        with self._cv:
            self._unadmitted += 1
            self._counters["accepted"] += 1
        try:
            if self.shed_policy == "block":
                # bounded waits so a submit blocked on a full queue notices
                # a concurrent close() instead of stranding its item in the
                # dead queue after close's leftover scan
                while True:
                    try:
                        self._ingest.put(item, timeout=0.05)
                        break
                    except queue.Full:
                        if self._closed:
                            self._unaccept(shed=False)
                            raise RuntimeError(
                                "frontend is closed to new submits"
                            ) from None
            else:
                self._ingest.put_nowait(item)
        except queue.Full:
            self._unaccept(shed=True)
            raise BackpressureError(
                f"ingest queue full ({self._ingest.maxsize}); query shed"
            ) from None
        return fut

    def _unaccept(self, *, shed: bool) -> None:
        with self._cv:
            self._unadmitted -= 1
            self._counters["accepted"] -= 1
            if shed:
                self._counters["shed"] += 1
            self._cv.notify_all()

    async def asubmit(self, client: str, index: int) -> np.ndarray:
        """Asyncio adapter: ``await frontend.asubmit(...)`` from any task."""
        import asyncio

        return await asyncio.wrap_future(self.submit(client, index))

    async def asubmit_many(self, client: str, indices) -> np.ndarray:
        """Asyncio adapter over :meth:`submit_many`."""
        import asyncio

        return await asyncio.wrap_future(self.submit_many(client, indices))

    def ingest(self, delta) -> None:
        """Queue one store :class:`~repro_torch.db.live.Delta` for the flush
        worker's idle slot (DESIGN.md §13). Thread-safe, like submit.

        The delta applies between batches — never under one — because the
        idle jobs only run with no batch in flight; queries already
        pinned to the pre-ingest snapshot keep answering against it.
        Requires the pipeline to serve a live
        :class:`~repro_torch.db.live.VersionedStore`."""
        if self._closed:
            raise RuntimeError("frontend is closed to new ingests")
        if not self._threads:
            self.start()
        self.pipeline.queue_delta(delta)
        with self._cv:
            self._cv.notify_all()

    # --------------------------------------------------------------- drain
    def drain(self, timeout: Optional[float] = None) -> bool:
        """Force the backlog through (partial batches included) and block
        until every accepted request has a resolved future. Returns False
        on timeout. The frontend keeps accepting afterwards."""
        with self._cv:
            self._draining += 1
            self._cv.notify_all()
        try:
            with self._cv:
                return self._cv.wait_for(self._is_idle, timeout)
        finally:
            with self._cv:
                self._draining -= 1

    def close(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Stop accepting; optionally drain, then join the workers.
        Without drain, unserved futures are cancelled."""
        with self._cv:
            self._closed = True
        if drain and self._threads:
            self.drain(timeout)
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for _ in self._threads:
            try:
                self._ingest.put_nowait(_SENTINEL)
            except queue.Full:
                break
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []
        if self._executor is not None:
            # the flush worker settles its in-flight batch before exiting,
            # so this never abandons work
            self._executor.shutdown(wait=True)
            self._executor = None
            self._side = None
        # cancel anything that never got served (drain=False path); rescan
        # until in-flight block-policy submitters have either enqueued
        # (each scan frees queue slots) or noticed the close and backed
        # out. The give-up deadline runs on the scheduler's injected
        # clock — the same clock every other timeout in the stack reads —
        # bounded by the configurable drain_timeout_s (a hardcoded
        # wall-clock deadline here made fake-clock tests real-time-bound)
        leftovers: List[Future] = []
        clock = self.pipeline.scheduler.clock
        deadline = clock() + self.drain_timeout_s
        while True:
            while True:
                try:
                    item = self._ingest.get_nowait()
                except queue.Empty:
                    break
                if item is not _SENTINEL:
                    leftovers.append(item[2])
                    with self._cv:
                        self._unadmitted -= 1
            with self._cv:
                settled = self._unadmitted <= 0
            if settled or clock() > deadline:
                break
            time.sleep(0.005)
        with self._cv:
            leftovers.extend(self._pending.values())
            self._pending.clear()
        for fut in leftovers:
            # admitted futures are RUNNING and refuse cancel(); fail them
            # explicitly so no waiter hangs
            if not fut.cancel() and not fut.done():
                from concurrent.futures import CancelledError

                fut.set_exception(CancelledError())

    # ------------------------------------------------------------- metrics
    @property
    def metrics(self) -> Dict[str, float]:
        """Frontend counters merged over the pipeline's (and cache's)."""
        out = dict(self.pipeline.metrics)
        with self._cv:
            out.update(self._counters)
        if self.pipeline.cache is not None:
            out.update(
                {f"cache_{k}": v
                 for k, v in self.pipeline.cache.metrics.items()}
            )
        return out

    # ------------------------------------------------------------- workers
    def _is_idle(self) -> bool:
        # callers hold self._cv
        return (
            self._unadmitted == 0
            and not len(self.pipeline.scheduler)
            and not self._pending
            and self._resolving == 0
            and self._applying == 0
            and self.pipeline.pending_deltas == 0
        )

    # items admitted per lock acquisition: big enough to keep lock/notify
    # traffic negligible next to serving, small enough that admission never
    # noticeably delays a cut (admission is ~µs per item)
    _ADMIT_CHUNK = 64

    def _ingest_loop(self) -> None:
        while True:
            try:
                item = self._ingest.get(timeout=0.05)
            except queue.Empty:
                if self._stop:
                    return
                continue
            if item is _SENTINEL:
                return
            # batched admission: drain a chunk per lock acquisition —
            # per-item locking serializes the whole front on the GIL
            items = [item]
            saw_sentinel = False
            while len(items) < self._ADMIT_CHUNK:
                try:
                    nxt = self._ingest.get_nowait()
                except queue.Empty:
                    break
                if nxt is _SENTINEL:
                    saw_sentinel = True
                    break
                items.append(nxt)
            refusals: List[Future] = []
            with self._cv:
                self._unadmitted -= len(items)
                for client, index, fut in items:
                    if fut.set_running_or_notify_cancel():
                        req = (
                            self.pipeline.submit_request_many(client, index)
                            if isinstance(index, tuple)
                            else self.pipeline.submit_request(client, index)
                        )
                        if req is None:
                            refusals.append(fut)
                        else:
                            self._pending[req.seq] = fut
                # refusal futures resolve outside the lock below; hold
                # _resolving so a concurrent drain() can't observe idle
                # before their PermissionError is set
                self._resolving += len(refusals)
                # wake the flush worker / drain waiters only on state
                # flips (queue was empty: arm the deadline timer; target
                # reached: cut; drain settled), not per admission
                sched = self.pipeline.scheduler
                if (
                    len(sched) <= len(items)
                    or sched.flat_len >= sched.target_batch
                    or (self._draining and self._unadmitted == 0)
                ):
                    self._cv.notify_all()
            if refusals:
                for fut in refusals:
                    fut.set_exception(PermissionError(
                        "privacy budget exhausted; query refused at admission"
                    ))
                with self._cv:
                    self._resolving -= len(refusals)
                    self._cv.notify_all()
            if saw_sentinel:
                return

    def _flush_wait_s(self) -> float:
        """How long the flush worker may sleep: until the oldest queued
        request hits the deadline, else one idle tick."""
        sched = self.pipeline.scheduler
        if len(sched) and sched.max_wait_s:
            # remaining <= 0 implies ready() was already True, so this is
            # only ever a positive deadline; keep a floor against clock skew
            return max(1e-4, sched.max_wait_s - sched.oldest_wait_s())
        return self.idle_tick_s

    def _should_cut(self) -> bool:
        # callers hold self._cv. A drain only forces partial batches once
        # every queued item has been admitted — cutting mid-ingest would
        # fragment the backlog into odd bucket shapes (fresh plan cells)
        # for no latency gain, since admission is orders faster than serve.
        sched = self.pipeline.scheduler
        return bool(len(sched)) and (
            sched.ready() or (self._draining > 0 and self._unadmitted == 0)
        )

    def _flush_loop(self) -> None:
        # double-buffer state: the one batch whose execute stage is in
        # flight on the executor thread, with its original requests
        inflight: Optional[Tuple[List[Request], Future]] = None
        while True:
            with self._cv:
                if self._stop:
                    break
                cut = self._should_cut()
                batch = self.pipeline.take_batch() if cut else []
                timeout = None if cut else self._flush_wait_s()
                idle = not len(self.pipeline.scheduler) and not self._unadmitted
            if batch:
                # local ref: a concurrent close() that gave up joining
                # this thread may shut down and clear self._executor —
                # the local keeps the dispatch race-free and the except
                # below turns a post-shutdown submit into a failed batch
                # instead of a dead flush worker with hung futures
                executor = self._executor
                if executor is None:
                    self._serve(batch)
                    continue
                # plan batch k+1 while batch k's ExecutionPlan runs
                try:
                    planned = self.pipeline.plan_requests(batch)
                except Exception as exc:
                    if inflight is not None:
                        self._finish(*inflight)
                        inflight = None
                    self._fail(batch, exc)
                    continue
                if inflight is not None:
                    self._finish(*inflight)
                    inflight = None
                ready = self._plan_ready()
                try:
                    inflight = (
                        batch,
                        executor.submit(self._execute, planned, ready),
                    )
                except RuntimeError as exc:  # executor already shut down
                    self._fail(batch, exc)
                continue
            # no fresh cut: settle the in-flight batch before anything else
            if inflight is not None:
                self._finish(*inflight)
                inflight = None
                continue
            # truly idle (nothing queued, nothing being admitted): apply
            # one queued store delta, then bank precomputed randomness,
            # then sleep until the deadline or the next submit
            # notification. With traffic in flight, a cut is imminent —
            # starting an idle job then would stall it behind a burst of
            # GIL-bound dispatches. Ingest runs first: freshness is
            # client-visible, banked randomness is not — and with no
            # batch in flight here, a delta can never land mid-batch.
            # The delta counts as in progress (``_applying``) from before
            # the pipeline pops it until it is counted, both under the
            # condition lock drain() reads: between the pop and the count
            # drain() sees pending_deltas == 0, and without this it could
            # return with the delta applied but not yet counted.
            if idle and self.pipeline.pending_deltas:
                with self._cv:
                    self._applying += 1
                applied = 0
                try:
                    applied = self.pipeline.ingest_step()
                finally:
                    with self._cv:
                        self._applying -= 1
                        self._counters["ingested"] += applied
                        # drain() also waits on the delta backlog
                        self._cv.notify_all()
                if applied:
                    continue
            # delta-log compaction rides the same idle machinery, right
            # after ingest (a just-applied burst is exactly when the log
            # is deepest) and before prefill: it rebases the live store
            # onto a new frozen base once the log passes the configured
            # depth, oracle-checked, never blocking a flush (DESIGN.md
            # §13). compact_log_depth=None (default) disables it.
            if idle and self.compact_log_depth is not None:
                if self.pipeline.compact_step(
                    min_log_depth=self.compact_log_depth
                ):
                    with self._cv:
                        self._counters["compacted"] += 1
                    continue
            if self.prefill and self.pipeline.cache is not None and idle:
                if self.pipeline.prefill_cache():
                    with self._cv:
                        self._counters["prefilled"] += 1
                    continue
            # second idle-slot job: one autotune search step per lull —
            # cold plan cells queued by request threads get their
            # measured winner here, never on the serving path (DESIGN.md
            # §Execution backends)
            if self.autotune and idle:
                if self.pipeline.autotune_step():
                    with self._cv:
                        self._counters["autotuned"] += 1
                    continue
            with self._cv:
                if self._stop:
                    break
                if not self._should_cut():
                    self._cv.wait(timeout)
        if inflight is not None:  # stop requested with a batch in flight
            self._finish(*inflight)

    def _plan_ready(self) -> Optional["torch.cuda.Event"]:
        """An event on the flush thread's current stream, recorded right
        after a batch's plan: the side stream waits on it before executing
        that batch (None on the CPU, or without a side stream)."""
        if self._side is None:
            return None
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.pipeline.device))
        return ready

    def _execute(
        self, planned: Optional[PlannedBatch],
        ready: Optional["torch.cuda.Event"],
    ) -> List[Tuple[Request, np.ndarray]]:
        """The execute stage, on the executor thread: on the side stream
        when there is one, after the batch's plan is done on the planning
        stream. Idle-slot jobs (ingest, compaction) that swap the live
        store's head run only with no batch in flight, so the pinned
        snapshot a batch answers against is never replaced under it."""
        side = self._side
        if side is None:
            return self.pipeline.execute_planned(planned)
        with torch.cuda.stream(side):
            side.wait_event(ready)
            try:
                return self.pipeline.execute_planned(planned)
            finally:
                # `planned` was allocated on the planning stream: it is
                # released when this call returns, so the side stream must
                # be done with it by then (a no-op after a normal execute,
                # which ends in this stream's synchronisation)
                side.synchronize()

    def _serve(self, batch: List[Request]) -> None:
        """Single-threaded flush: plan + execute + resolve inline."""
        try:
            results = self.pipeline.serve_requests(batch)
        except Exception as exc:  # fail the whole batch, keep serving
            self._fail(batch, exc)
            return
        self._resolve(results)

    def _finish(self, batch: List[Request], fut: Future) -> None:
        """Settle one double-buffered batch: wait for its execute stage
        and resolve (or fail) its futures."""
        try:
            results = fut.result()
        except Exception as exc:
            self._fail(batch, exc)
            return
        self._resolve(results)

    def _fail(self, batch: List[Request], exc: BaseException) -> None:
        with self._cv:
            futs = [self._pending.pop(r.seq, None) for r in batch]
            self._counters["failed"] += len(batch)
            self._resolving += len(batch)
        for fut in futs:
            if fut is not None and not fut.done():
                fut.set_exception(exc)
        with self._cv:
            self._resolving -= len(batch)
            self._cv.notify_all()

    def _resolve(
        self, results: List[Tuple[Request, np.ndarray]]
    ) -> None:
        with self._cv:
            paired: List[Tuple[Optional[Future], np.ndarray]] = [
                (self._pending.pop(r.seq, None), answer)
                for r, answer in results
            ]
            self._counters["served"] += len(results)
            self._resolving += len(paired)
        for fut, answer in paired:
            if fut is not None and not fut.done():
                fut.set_result(answer)
        with self._cv:
            self._resolving -= len(paired)
            self._cv.notify_all()
