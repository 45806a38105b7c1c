"""Port vs reference: the async front (``AsyncFrontend``) on the CPU.

Mirrors ``tests/test_serve_frontend.py`` case for case, and
``tests/test_db_live.py::test_frontend_applies_deltas_in_idle_slot``:
race-freedom under concurrent submitters (every future resolves to the
exact record), the double-buffered flush and its executor's lifecycle,
backpressure shedding at the bounded queue, budget refusal surfacing as
``PermissionError`` on the future, deadline-timer cuts, graceful drain and
close, the asyncio adapter, and the idle slot (ingest, compaction,
autotune). Threaded cases wait on events or futures with an explicit
timeout, never on a sleep alone.

Beyond the mirror: the same submissions through both packages' fronts give
the same records and the same counters, and a delta that is applied slowly
is counted before ``drain()`` returns (the reference's front counts it
after the pipeline has popped it, so its ``drain()`` can return one short;
``test_a_slow_delta_is_counted_before_drain_returns`` fails there)."""

import asyncio
import threading
import time
from concurrent.futures import CancelledError

import numpy as np
import pytest

from repro.core import make_scheme as ref_make_scheme
from repro.db import make_synthetic_store as ref_make_store
from repro.serve import AsyncFrontend as RefFrontend
from repro.serve import BatchScheduler as RefScheduler
from repro.serve import ServingPipeline as RefPipeline
from repro_torch.core import make_scheme
from repro_torch.core.accounting import PrivacyBudget
from repro_torch.db import Delta, VersionedStore, make_synthetic_store
from repro_torch.kernels.backend import AutotuneTable
from repro_torch.serve import (
    AsyncFrontend,
    BackpressureError,
    BatchScheduler,
    QueryCache,
    ServingPipeline,
    ShardedBackend,
)

WAIT = 30.0  # every wait in this file is bounded


def make_pipe(n=256, cached=False, max_batch=64, max_wait_s=0.0, **kw):
    store = make_synthetic_store(n, 16, seed=7, device="cpu")
    sch = make_scheme("chor", d=2, d_a=1)
    return ServingPipeline(
        store, sch,
        scheduler=BatchScheduler(
            max_batch=max_batch, max_wait_s=max_wait_s, target_latency_s=10.0
        ),
        cache=QueryCache(sch, store.n) if cached else None,
        device="cpu",
        **kw,
    )


def _wait_until(event: threading.Event, what: str) -> None:
    assert event.wait(WAIT), f"timed out waiting for {what}"


# --------------------------------------------------------- double buffering
@pytest.mark.parametrize("double_buffer", [True, False])
def test_double_buffered_flush_exact_over_many_batches(double_buffer):
    pipe = make_pipe(n=512, max_batch=16)
    queries = [(i * 13) % 512 for i in range(160)]
    with AsyncFrontend(
        pipe, ingest_workers=2, queue_limit=1024, shed_policy="block",
        double_buffer=double_buffer,
    ) as fe:
        futs = [fe.submit(f"c{i % 6}", q) for i, q in enumerate(queries)]
        assert fe.drain(timeout=60.0)
        for q, fut in zip(queries, futs):
            np.testing.assert_array_equal(
                fut.result(timeout=5.0), pipe.store.record_bytes(q)
            )
    assert fe.metrics["served"] == len(queries)
    assert fe.metrics["failed"] == 0
    # the engine really cut multiple batches (the overlap was exercised)
    assert pipe.metrics["batches"] >= len(queries) // 16


def test_double_buffer_executor_lifecycle():
    """The one-slot execute stage spins up on start and is torn down by
    close (drain included), with the in-flight batch settled. On the CPU
    there is no side stream."""
    pipe = make_pipe(n=128, max_batch=8)
    fe = AsyncFrontend(pipe, double_buffer=True).start()
    assert fe._executor is not None
    assert fe._side is None  # streams are the card's
    fut = fe.submit("a", 17)
    fe.close(drain=True)
    np.testing.assert_array_equal(
        fut.result(timeout=5.0), pipe.store.record_bytes(17)
    )
    assert fe._executor is None
    # single-threaded mode never creates the executor
    pipe2 = make_pipe(n=128, max_batch=8)
    fe2 = AsyncFrontend(pipe2, double_buffer=False).start()
    assert fe2._executor is None
    fe2.close()


def test_double_buffer_serve_error_fails_only_that_batch(monkeypatch):
    pipe = make_pipe(n=64, max_batch=4)
    boom = {"armed": True}
    real = pipe.execute_planned

    def flaky(planned):
        if boom.pop("armed", False):
            raise RuntimeError("kernel exploded")
        return real(planned)

    monkeypatch.setattr(pipe, "execute_planned", flaky)
    with AsyncFrontend(
        pipe, queue_limit=64, shed_policy="block", double_buffer=True
    ) as fe:
        first = [fe.submit(f"a{i}", i) for i in range(4)]
        assert fe.drain(timeout=WAIT)
        second = [fe.submit(f"b{i}", i) for i in range(4)]
        assert fe.drain(timeout=WAIT)
    failed = sum(1 for f in first if f.exception() is not None)
    assert failed == 4  # the armed batch failed as a unit
    for i, f in enumerate(second):
        np.testing.assert_array_equal(
            f.result(timeout=5.0), pipe.store.record_bytes(i)
        )
    assert fe.metrics["failed"] == 4


# ------------------------------------------------------------- concurrency
@pytest.mark.parametrize("cached", [False, True])
def test_concurrent_submitters_get_exact_records(cached):
    pipe = make_pipe(cached=cached)
    n_threads, per = 8, 24
    results = [[None] * per for _ in range(n_threads)]

    with AsyncFrontend(pipe, ingest_workers=3, queue_limit=1024,
                       shed_policy="block") as fe:
        def feed(s):
            futs = [fe.submit(f"s{s}-c{j % 4}",
                              (s * 37 + j * 11) % pipe.store.n)
                    for j in range(per)]
            for j, f in enumerate(futs):
                results[s][j] = f.result(timeout=WAIT)

        threads = [threading.Thread(target=feed, args=(s,))
                   for s in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads)

    for s in range(n_threads):
        for j in range(per):
            idx = (s * 37 + j * 11) % pipe.store.n
            np.testing.assert_array_equal(
                results[s][j], pipe.store.record_bytes(idx)
            )
    m = fe.metrics
    assert m["served"] == n_threads * per
    assert m["shed"] == 0 and m["failed"] == 0


def test_drain_forces_partial_batches_and_keeps_accepting():
    pipe = make_pipe()  # no deadline: only fullness or drain cuts
    with AsyncFrontend(pipe, ingest_workers=1) as fe:
        futs = [fe.submit("c", i) for i in range(5)]  # far below target
        assert fe.drain(timeout=WAIT)
        assert all(f.done() for f in futs)
        for i, f in enumerate(futs):
            np.testing.assert_array_equal(
                f.result(), pipe.store.record_bytes(i)
            )
        late = fe.submit("c", 9)
        assert fe.drain(timeout=WAIT)
        np.testing.assert_array_equal(
            late.result(), pipe.store.record_bytes(9)
        )


def test_deadline_timer_cuts_partial_batch_without_drain():
    pipe = make_pipe(max_wait_s=0.05)
    with AsyncFrontend(pipe, ingest_workers=1) as fe:
        fut = fe.submit("c", 3)
        np.testing.assert_array_equal(
            fut.result(timeout=WAIT), pipe.store.record_bytes(3)
        )


# ------------------------------------------------------------ backpressure
def _parked_frontend(monkeypatch, queue_limit, shed_policy):
    """Frontend whose workers are parked (start patched to a no-op), so
    the bounded ingest queue fills deterministically."""
    monkeypatch.setattr(AsyncFrontend, "start", lambda self: self)
    pipe = make_pipe()
    return AsyncFrontend(pipe, ingest_workers=1, queue_limit=queue_limit,
                         shed_policy=shed_policy)


def test_reject_policy_sheds_when_queue_full(monkeypatch):
    fe = _parked_frontend(monkeypatch, 2, "reject")
    queued = [fe.submit("c", i) for i in (0, 1)]  # fills the queue
    with pytest.raises(BackpressureError):
        fe.submit("c", 2)
    assert fe.metrics["shed"] == 1
    assert fe.metrics["accepted"] == 2  # the shed submit was never counted
    monkeypatch.undo()  # un-park: real workers drain the backlog
    fe.start()
    try:
        assert fe.drain(timeout=WAIT)
        for i, f in enumerate(queued):
            np.testing.assert_array_equal(
                f.result(), fe.pipeline.store.record_bytes(i)
            )
    finally:
        fe.close()


def test_block_policy_waits_for_room(monkeypatch):
    fe = _parked_frontend(monkeypatch, 1, "block")
    fe.submit("c", 0)  # queue now full
    blocked_done = threading.Event()

    def blocked_submit():
        fe.submit("c", 1)  # must wait for room, not raise
        blocked_done.set()

    t = threading.Thread(target=blocked_submit, daemon=True)
    t.start()
    # genuinely blocked on the queue: the event stays unset while parked
    assert not blocked_done.wait(0.05)
    monkeypatch.undo()  # un-park: the workers make room
    fe.start()
    try:
        _wait_until(blocked_done, "the blocked submit")
        t.join(timeout=10.0)
        assert not t.is_alive()
        assert fe.drain(timeout=WAIT)
        assert fe.metrics["shed"] == 0 and fe.metrics["served"] == 2
    finally:
        fe.close()


# ---------------------------------------------------------------- refusals
def test_budget_refusal_resolves_future_with_permission_error():
    # sparse, not chor: chor spends (0, 0) so its budget never exhausts
    store = make_synthetic_store(128, 16, seed=8, device="cpu")
    sch = make_scheme("sparse", d=4, d_a=2, theta=0.25)
    pipe = ServingPipeline(
        store, sch,
        scheduler=BatchScheduler(
            max_batch=16, max_wait_s=0.02, target_latency_s=10.0
        ),
        default_budget=lambda: PrivacyBudget(
            epsilon_limit=1.5 * sch.epsilon(store.n)
        ),
        device="cpu",
    )
    with AsyncFrontend(pipe, ingest_workers=1) as fe:
        ok, refused = fe.submit("c", 5), fe.submit("c", 6)
        assert fe.drain(timeout=WAIT)
        np.testing.assert_array_equal(ok.result(), store.record_bytes(5))
        with pytest.raises(PermissionError):
            refused.result()
        # an unrelated client is unaffected
        np.testing.assert_array_equal(
            fe.submit("d", 6).result(timeout=WAIT), store.record_bytes(6)
        )
    assert pipe.metrics["refused"] == 1


def test_serve_error_fails_batch_but_front_survives(monkeypatch):
    pipe = make_pipe(max_wait_s=0.02)
    boom = {"armed": True}
    orig = pipe.serve_requests

    def flaky(batch):
        if boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("replica fire")
        return orig(batch)

    monkeypatch.setattr(pipe, "serve_requests", flaky)
    with AsyncFrontend(pipe, ingest_workers=1, double_buffer=False) as fe:
        bad = fe.submit("c", 1)
        assert fe.drain(timeout=WAIT)
        with pytest.raises(RuntimeError, match="replica fire"):
            bad.result()
        good = fe.submit("c", 2)
        np.testing.assert_array_equal(
            good.result(timeout=WAIT), pipe.store.record_bytes(2)
        )
    assert fe.metrics["failed"] == 1 and fe.metrics["served"] == 1


# ------------------------------------------------------------------- close
def test_close_without_drain_cancels_unserved(monkeypatch):
    fe = _parked_frontend(monkeypatch, 8, "reject")
    stranded = [fe.submit("c", i) for i in (1, 2, 3)]
    monkeypatch.undo()
    fe.close(drain=False)
    for f in stranded:
        assert f.done()
        with pytest.raises(CancelledError):
            f.result()
    with pytest.raises(RuntimeError, match="closed"):
        fe.submit("c", 4)


def test_context_manager_drains_on_clean_exit():
    pipe = make_pipe()
    with AsyncFrontend(pipe, ingest_workers=2) as fe:
        futs = [fe.submit(f"c{i}", i) for i in range(7)]
    for i, f in enumerate(futs):
        np.testing.assert_array_equal(f.result(), pipe.store.record_bytes(i))


# ----------------------------------------------------------------- asyncio
def test_asubmit_from_event_loop():
    pipe = make_pipe(max_wait_s=0.02)

    async def drive(fe):
        single = await asyncio.gather(
            *(fe.asubmit(f"c{i % 3}", i * 5) for i in range(6))
        )
        many = await fe.asubmit_many("m", [3, 40, 3])
        return single, many

    with AsyncFrontend(pipe, ingest_workers=2) as fe:
        answers, many = asyncio.run(asyncio.wait_for(drive(fe), WAIT))
    for i, a in enumerate(answers):
        np.testing.assert_array_equal(a, pipe.store.record_bytes(i * 5))
    np.testing.assert_array_equal(
        many, np.stack([pipe.store.record_bytes(i) for i in (3, 40, 3)]))


# ----------------------------------------------------- close deadline clock
def test_close_deadline_runs_on_scheduler_clock(monkeypatch):
    ticks = {"n": 0}

    def fake_clock():
        ticks["n"] += 1
        return float(ticks["n"])  # each read advances a full second

    pipe = make_pipe()
    pipe.scheduler.clock = fake_clock
    monkeypatch.setattr(AsyncFrontend, "start", lambda self: self)
    fe = AsyncFrontend(pipe, ingest_workers=1, queue_limit=4,
                       shed_policy="block", drain_timeout_s=2.0)
    with fe._cv:
        fe._unadmitted += 1  # a submitter that will never settle
    t0 = time.monotonic()
    fe.close(drain=False)
    wall = time.monotonic() - t0
    assert wall < 0.5
    assert ticks["n"] >= 2  # the deadline really consulted the injected clock


def test_drain_timeout_must_be_positive():
    pipe = make_pipe()
    with pytest.raises(ValueError, match="drain_timeout_s"):
        AsyncFrontend(pipe, drain_timeout_s=0.0)


# ----------------------------------------------------- idle-slot autotune
def _fresh_autotune_pipe(n=256):
    store = make_synthetic_store(n, 16, seed=7, device="cpu")
    sch = make_scheme("chor", d=2, d_a=1)
    return ServingPipeline(
        store, sch,
        backend=ShardedBackend(store, autotune=AutotuneTable(device="cpu"),
                               device="cpu"),
        device="cpu",
    )


def _signal_on(monkeypatch, obj, name, event, when=lambda out: out):
    """Wrap ``obj.name`` so that ``event`` is set once a call's result
    satisfies ``when``."""
    real = getattr(obj, name)

    def wrapped(*args, **kw):
        out = real(*args, **kw)
        if when(out):
            event.set()
        return out

    monkeypatch.setattr(obj, name, wrapped)


def test_cold_cell_serve_never_microbenchmarks_on_request_path():
    pipe = _fresh_autotune_pipe()
    calls = []
    real = pipe.backend.planner._measure

    def counting(fn, *args, **kw):
        calls.append(kw.get("candidate"))
        return real(fn, *args, **kw)

    pipe.backend.planner._measure = counting
    with AsyncFrontend(pipe, autotune=False) as fe:
        fut = fe.submit("a", 5)
        assert fe.drain(timeout=WAIT)
        np.testing.assert_array_equal(
            fut.result(timeout=5.0), pipe.store.record_bytes(5)
        )
        assert calls == []  # the serve path consulted only the prior
    assert len(pipe.backend.planner.pending()) == 1  # queued for idle slot


def test_idle_slot_compacts_live_store_past_depth(monkeypatch):
    store = make_synthetic_store(128, 16, seed=9, device="cpu")
    live = VersionedStore(store, backend="ref")
    sch = make_scheme("chor", d=2, d_a=1)
    pipe = ServingPipeline(live, sch, device="cpu")
    compacted = threading.Event()
    _signal_on(monkeypatch, pipe, "compact_step", compacted)
    rng = np.random.default_rng(1)
    with AsyncFrontend(pipe, idle_tick_s=0.001, compact_log_depth=3) as fe:
        for _ in range(4):
            fe.ingest(Delta.append(
                rng.integers(0, 256, size=(8, 16), dtype=np.uint8)
            ))
        _wait_until(compacted, "an idle-slot compaction")
        assert fe.drain(timeout=WAIT)
        assert fe.metrics["compacted"] >= 1
        assert live.base_version >= 3 and live.log_depth < 3
        assert live.metrics["compacted_deltas"] >= 3
        # serving against the rebased store stays exact
        fut = fe.submit("a", 140)
        assert fe.drain(timeout=WAIT)
        np.testing.assert_array_equal(
            fut.result(timeout=5.0), live.snapshot().record_bytes(140)
        )


def test_compact_log_depth_validates_and_defaults_off(monkeypatch):
    pipe = make_pipe()
    with pytest.raises(ValueError, match="compact_log_depth"):
        AsyncFrontend(pipe, compact_log_depth=0)
    autotuned = threading.Event()
    # an idle lull reaches the last idle job, autotune, past compaction
    _signal_on(monkeypatch, pipe, "autotune_step", autotuned,
               when=lambda out: True)
    with AsyncFrontend(pipe, idle_tick_s=0.001) as fe:
        assert fe.compact_log_depth is None
        _wait_until(autotuned, "an idle lull")
        assert fe.metrics["compacted"] == 0  # frozen store: never fires


def test_idle_slot_runs_autotune_step_and_counts(monkeypatch):
    pipe = _fresh_autotune_pipe()
    tuned = threading.Event()
    _signal_on(monkeypatch, pipe, "autotune_step", tuned)
    with AsyncFrontend(pipe, idle_tick_s=0.001) as fe:
        fut = fe.submit("a", 5)
        assert fe.drain(timeout=WAIT)
        np.testing.assert_array_equal(
            fut.result(timeout=5.0), pipe.store.record_bytes(5)
        )
        _wait_until(tuned, "an idle-slot autotune step")
        assert fe.drain(timeout=WAIT)
        assert fe.metrics["autotuned"] >= 1
    assert not pipe.backend.planner.pending()
    assert any(
        entry["source"] == "measured"
        for _, entry in pipe.backend.planner.table.items()
    )


# ------------------------------------------------- idle-slot ingest (live)
def test_frontend_applies_deltas_in_idle_slot():
    """Writes ride the flush worker's idle slot: submits and ingests
    interleave through AsyncFrontend, drain() waits out the delta
    backlog, and every future resolves against SOME store version."""
    rng = np.random.default_rng(20260808)
    live = VersionedStore(make_synthetic_store(64, 8, seed=13, device="cpu"),
                          shards=8)
    pipe = ServingPipeline(live, make_scheme("sparse", d=4, d_a=2, theta=0.3),
                           device="cpu")
    futures = {}
    with AsyncFrontend(pipe) as fe:
        for step in range(3):
            fe.ingest(Delta.update(
                [step, 32 + step],
                rng.integers(0, 256, size=(2, 8), dtype=np.uint8)))
            for c in range(4):
                i = int(rng.integers(0, 64))
                futures[f"s{step}c{c}"] = (i, fe.submit(f"s{step}c{c}", i))
        assert fe.drain(WAIT)
        assert pipe.pending_deltas == 0
        assert fe.metrics["ingested"] == 3
    assert live.version == 3
    for name, (i, fut) in futures.items():
        got = np.asarray(fut.result(5.0))
        assert any(
            (live.snapshot(v).record_bytes(i) == got).all()
            for v in range(live.version + 1)
        ), (name, i)
    assert pipe.metrics["ingests"] == 3
    assert pipe.metrics["records_ingested"] == 6


def test_a_slow_delta_is_counted_before_drain_returns(monkeypatch):
    """A delta popped by the pipeline but still being applied keeps the
    front busy: drain() does not report idle until it is applied and
    counted. (The reference's front counts a delta only after the pipeline
    popped and applied it, and its drain() reads pending_deltas == 0 in
    between, so there drain() returns at once with ``ingested`` 0.)"""
    live = VersionedStore(make_synthetic_store(64, 8, seed=3, device="cpu"))
    pipe = ServingPipeline(live, make_scheme("chor", d=2, d_a=1),
                           device="cpu")
    started, release = threading.Event(), threading.Event()
    real = pipe.ingest

    def slow_ingest(delta):
        started.set()
        assert release.wait(WAIT)
        return real(delta)

    monkeypatch.setattr(pipe, "ingest", slow_ingest)
    with AsyncFrontend(pipe, prefill=False, autotune=False) as fe:
        fe.ingest(Delta.update([5], np.full((1, 8), 9, np.uint8)))
        _wait_until(started, "the idle slot to take the delta")
        assert pipe.pending_deltas == 0  # popped, not yet applied
        # mid-apply: the front is not idle, so a short drain times out
        assert not fe.drain(timeout=0.05)
        assert fe.metrics["ingested"] == 0
        release.set()
        assert fe.drain(timeout=WAIT)
        assert fe.metrics["ingested"] == 1
        assert pipe.metrics["ingests"] == 1
    assert (live.snapshot().record_bytes(5) == 9).all()


# -------------------------------------------- the same load through both
def test_both_fronts_serve_the_same_records_and_count_alike():
    n, rb = 256, 16
    rstore = ref_make_store(n, rb, seed=7)
    tstore = make_synthetic_store(n, rb, seed=7, device="cpu")
    rpipe = RefPipeline(rstore, ref_make_scheme("sparse", d=3, d_a=1,
                                                theta=0.3),
                        scheduler=RefScheduler(max_batch=8))
    tpipe = ServingPipeline(tstore, make_scheme("sparse", d=3, d_a=1,
                                                theta=0.3),
                            scheduler=BatchScheduler(max_batch=8),
                            device="cpu")
    queries = [(i * 29) % n for i in range(40)]
    out = []
    for front, pipe in ((RefFrontend, rpipe), (AsyncFrontend, tpipe)):
        with front(pipe, queue_limit=256, shed_policy="block") as fe:
            futs = [fe.submit(f"c{i % 5}", q) for i, q in enumerate(queries)]
            many = fe.submit_many("m", [1, 200, 1])
            assert fe.drain(timeout=60.0)
            out.append(([np.asarray(f.result(timeout=5.0)) for f in futs],
                        np.asarray(many.result(timeout=5.0)), fe.metrics))
    (r_single, r_many, r_m), (t_single, t_many, t_m) = out
    for q, a, b in zip(queries, r_single, t_single):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, tstore.record_bytes(q))
    np.testing.assert_array_equal(r_many, t_many)
    # the port's front adds the pipeline's stage counters (queue wait from
    # submit to cut) to the reference's keys, and nothing else
    assert set(t_m) == set(r_m) | set(tpipe.stage_metrics)
    assert t_m["queue_waited"] == len(queries) + 1
    assert t_m["queue_wait_s"] >= 0.0
    for key in ("accepted", "served", "shed", "failed", "queries", "refused",
                "ingested", "compacted", "epsilon_per_query"):
        assert t_m[key] == r_m[key], key


def test_the_latency_helper_waits_for_its_stream_not_the_device(monkeypatch):
    """``_device.synchronize`` — what every latency sample and the flush
    timing end in — waits for the calling thread's current stream of the
    device, never ``torch.cuda.synchronize`` (which would also wait for
    the next batch's planning on another stream); on the CPU it does
    nothing."""
    import torch

    from repro_torch import _device

    calls = []

    class Stream:
        def synchronize(self):
            calls.append("stream")

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: calls.append(device) or Stream())
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append("device"))
    dev = torch.device("cuda", 0)
    _device.synchronize(dev)
    assert calls == [dev, "stream"]
    _device.synchronize(torch.device("cpu"))
    assert calls == [dev, "stream"]
