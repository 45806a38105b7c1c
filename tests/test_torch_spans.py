"""The serving path's own profiler ranges and its queue-wait counters, on
the CPU (``repro_torch.serve.spans``).

A recorder stub stands in for the profiler: it notes each range's name,
the thread it opened and closed on, and the order, so the tests can
rebuild each thread's tree of ranges; one test runs the real recorder
under a CPU profile. What the profiler makes of the ranges on the card is
read from a profile taken there.
"""

import itertools
import threading
import time

import numpy as np
import pytest

from repro.core import make_scheme as ref_make_scheme
from repro.db import make_synthetic_store as ref_make_store
from repro.serve import BatchScheduler as RefScheduler
from repro.serve import ServingPipeline as RefPipeline
from repro_torch.configs import pir_ct
from repro_torch.core import make_scheme
from repro_torch.db import make_synthetic_store
from repro_torch.serve import BatchScheduler, ServingPipeline, spans

WAIT = 30.0  # every wait in this file is bounded


class Recorder:
    """A stand-in for the profiler's range: ``Recorder()(name)`` is a
    context manager that notes (event, name, thread) in order. Its lock is
    re-entrant: a garbage collection that starts inside ``_note`` opens its
    own range on the same thread."""

    def __init__(self):
        self.events = []
        self.calls = 0
        self._lock = threading.RLock()

    def _note(self, what, name):
        with self._lock:
            self.events.append((what, name, threading.get_ident()))

    def __call__(self, name):
        with self._lock:
            self.calls += 1
        rec = self

        class _Range:
            def __enter__(self):
                rec._note("open", name)

            def __exit__(self, *exc):
                rec._note("close", name)

        return _Range()

    def snapshot(self):
        with self._lock:
            return list(self.events)

    def wait_for(self, name):
        deadline = time.monotonic() + WAIT
        while time.monotonic() < deadline:
            if ("open", name) in [ev[:2] for ev in self.snapshot()]:
                return
            time.sleep(0.002)
        raise AssertionError(f"no range {name} opened")


@pytest.fixture
def recorder(monkeypatch):
    rec = Recorder()
    monkeypatch.setattr(spans, "_record", rec)
    try:
        yield rec
    finally:
        spans.enable(False)


def tree(events):
    """Each thread's ranges as nodes {name, tid, children}; every close must
    close the range last opened on its own thread. A garbage collection's
    range lands wherever the collector happened to run, and is left out."""
    stacks, roots = {}, []
    for what, name, tid in events:
        if name == "repro_torch.gc":
            continue
        stack = stacks.setdefault(tid, [])
        if what == "open":
            node = {"name": name, "tid": tid, "children": []}
            (stack[-1]["children"] if stack else roots).append(node)
            stack.append(node)
        else:
            assert stack and stack[-1]["name"] == name, (name, tid)
            stack.pop()
    assert not any(stacks.values()), "a range never closed"
    return roots


def names(nodes):
    return [n["name"] for n in nodes]


def _reduced_front():
    cfg = pir_ct.reduced()
    fe = pir_ct.make_async_frontend(cfg, device="cpu", seed=5)
    pipe = fe.pipeline
    pipe.scheduler.max_wait_s = 0.0  # only the target or a drain cuts
    now = [100.0]
    pipe.scheduler.clock = lambda: now[0]
    return cfg, fe, pipe, now


def _admitted(pipe, k):
    deadline = time.monotonic() + WAIT
    while len(pipe.scheduler) < k:
        assert time.monotonic() < deadline, "lookups never admitted"
        time.sleep(0.002)


# ------------------------------------------------------------------- off
def test_spans_off_record_nothing_and_never_call_the_recorder(recorder):
    assert not spans.enabled()
    assert spans.span("plan", 3) is spans.span("front.idle")
    cfg, fe, pipe, _ = _reduced_front()
    with fe:
        futs = [fe.submit(f"c{i}", i * 7) for i in range(5)]
        assert fe.drain(timeout=WAIT)
    for i, fut in enumerate(futs):
        np.testing.assert_array_equal(fut.result(timeout=5.0),
                                      pipe.store.record_bytes(i * 7))
    assert recorder.calls == 0 and recorder.events == []


# -------------------------------------------------------------------- on
def test_one_batch_through_the_front_opens_every_stage(recorder):
    cfg, fe, pipe, now = _reduced_front()
    spans.enable(True)
    with fe:
        futs = [fe.submit("a", 11), fe.submit("b", 12)]
        _admitted(pipe, 2)
        now[0] = 100.25
        futs.append(fe.submit("c", 13))
        _admitted(pipe, 3)
        now[0] = 101.0
        assert fe.drain(timeout=WAIT)
    spans.enable(False)
    for i, fut in zip((11, 12, 13), futs):
        np.testing.assert_array_equal(fut.result(timeout=5.0),
                                      pipe.store.record_bytes(i))
    # the waits the fake clock set, exactly: 1.0 + 1.0 + 0.75
    assert pipe.stage_metrics == {"queue_wait_s": 2.75, "queue_waited": 3}
    assert fe.metrics["queue_wait_s"] == 2.75

    roots = tree(recorder.snapshot())
    plans = [n for n in roots if n["name"].startswith("repro_torch.plan#")]
    assert len(plans) == 1, names(roots)
    k = plans[0]["name"].split("#")[1]
    assert names(plans[0]["children"]) == [
        "repro_torch.plan.cache", "repro_torch.plan.route",
        "repro_torch.plan.prepare"]
    flush = plans[0]["tid"]

    (execute,) = [n for n in roots if n["name"] == f"repro_torch.execute#{k}"]
    assert execute["tid"] != flush  # the double buffer's executor thread
    assert names(execute["children"]) == [
        f"repro_torch.answer#{k}", "repro_torch.finalize",
        "repro_torch.execute.sync", "repro_torch.execute.host"]
    servers = execute["children"][0]["children"]
    assert len(servers) == cfg.d
    # one range a server, named by the plan's kernel path (a sparse one)
    (server,) = set(names(servers))
    assert server.startswith("repro_torch.answer.sparse_")
    assert all(s["children"] == [] for s in servers)

    on_flush = [n["name"] for n in roots if n["tid"] == flush]
    # the loop: cut, plan, hand-off, ..., settle, resolve
    i = on_flush.index(plans[0]["name"])
    assert on_flush[i - 1] == "repro_torch.front.cut"
    assert on_flush[i + 1] == "repro_torch.front.dispatch"
    assert f"repro_torch.front.settle#{k}" in on_flush
    assert f"repro_torch.front.resolve#{k}" in on_flush
    assert on_flush.index(f"repro_torch.front.settle#{k}") < on_flush.index(
        f"repro_torch.front.resolve#{k}")
    admits = [n for n in roots if n["name"] == "repro_torch.front.admit"]
    assert admits and all(n["tid"] != flush for n in admits)
    me = threading.get_ident()
    assert [n["name"] for n in roots if n["tid"] == me] == [
        "repro_torch.front.submit"] * 3
    # the flush worker's ranges are top-level ones of its loop's stages
    assert {n["name"].split("#")[0] for n in roots if n["tid"] == flush} <= {
        "repro_torch.front.cut", "repro_torch.plan",
        "repro_torch.front.dispatch", "repro_torch.front.settle",
        "repro_torch.front.resolve", "repro_torch.front.hold",
        "repro_torch.front.idle", "repro_torch.idle.prefill",
        "repro_torch.idle.autotune"}


def test_front_hold_and_front_idle_are_told_apart(recorder):
    cfg, fe, pipe, now = _reduced_front()
    spans.enable(True)
    with fe:
        recorder.wait_for("repro_torch.front.idle")
        n0 = len(recorder.snapshot())
        fut = fe.submit("a", 3)
        _admitted(pipe, 1)
        recorder.wait_for("repro_torch.front.hold")
        time.sleep(0.05)  # several more waits, the lookup still queued
        waits = [name for what, name, _ in recorder.snapshot()[n0:]
                 if what == "open" and name in ("repro_torch.front.hold",
                                                "repro_torch.front.idle")]
        assert fe.drain(timeout=WAIT)
    spans.enable(False)
    np.testing.assert_array_equal(fut.result(timeout=5.0),
                                  pipe.store.record_bytes(3))
    # once the lookup was queued, every wait was a hold
    first = waits.index("repro_torch.front.hold")
    assert set(waits[first:]) == {"repro_torch.front.hold"}
    tree(recorder.snapshot())


# -------------------------------------------------------- the sync path
def test_the_sync_path_counts_from_admission_and_names_a_multi_batch(
        recorder):
    now = itertools.count()
    store = make_synthetic_store(128, 8, seed=9, device="cpu")
    pipe = ServingPipeline(store, make_scheme("chor", d=2, d_a=1),
                           scheduler=BatchScheduler(
                               max_batch=8, clock=lambda: float(next(now))),
                           device="cpu")
    spans.enable(True)
    assert pipe.submit("a", 3)                    # admitted at 0
    assert pipe.submit_many("b", [4, 5])          # admitted at 1
    batch = pipe.take_batch()                     # cut at 2
    assert pipe.stage_metrics == {"queue_wait_s": 3.0, "queue_waited": 2}
    results = pipe.execute_planned(pipe.plan_requests(batch))
    spans.enable(False)
    got = {r.client: a for r, a in results}
    np.testing.assert_array_equal(got["a"], store.record_bytes(3))
    np.testing.assert_array_equal(
        got["b"], np.stack([store.record_bytes(i) for i in (4, 5)]))
    roots = tree(recorder.snapshot())
    assert names(roots) == ["repro_torch.plan#0", "repro_torch.execute#0"]
    assert names(roots[0]["children"]) == [
        "repro_torch.plan.cache", "repro_torch.plan.route",
        "repro_torch.plan.prepare"]
    assert names(roots[1]["children"]) == [
        "repro_torch.answer#0", "repro_torch.finalize",
        "repro_torch.execute.sync", "repro_torch.execute.host"]
    servers = roots[1]["children"][0]["children"]
    assert len(servers) == 2
    assert all(s["children"] == [] for s in servers)
    # the next batch takes the next number
    assert pipe.submit("c", 6)
    assert pipe.plan_requests(pipe.take_batch()).seq == 1


def test_a_garbage_collection_runs_in_a_range_only_while_spans_are_on(
        recorder):
    import gc

    gc.collect()
    assert recorder.events == []
    spans.enable(True)
    try:
        gc.collect()
    finally:
        spans.enable(False)
    me = threading.get_ident()
    assert recorder.snapshot()[-2:] == [("open", "repro_torch.gc", me),
                                        ("close", "repro_torch.gc", me)]
    n = len(recorder.snapshot())
    gc.collect()
    assert len(recorder.snapshot()) == n
    assert not any(cb is spans._gc_range for cb in gc.callbacks)


def test_stage_counters_stay_out_of_the_reference_key_set():
    rstore = ref_make_store(64, 8, seed=3)
    tstore = make_synthetic_store(64, 8, seed=3, device="cpu")
    rpipe = RefPipeline(rstore, ref_make_scheme("chor", d=2, d_a=1),
                        scheduler=RefScheduler(max_batch=8))
    tpipe = ServingPipeline(tstore, make_scheme("chor", d=2, d_a=1),
                            scheduler=BatchScheduler(max_batch=8),
                            device="cpu")
    for pipe in (rpipe, tpipe):
        for i in range(3):
            assert pipe.submit(f"c{i}", i)
        pipe.serve_requests(pipe.take_batch())
    assert set(tpipe.metrics) == set(rpipe.metrics)
    assert not set(tpipe.stage_metrics) & set(tpipe.metrics)
    assert tpipe.stage_metrics["queue_waited"] == 3


@pytest.mark.parametrize("all_threads", [False, True])
def test_a_range_open_when_a_profiler_starts_is_left_out_of_its_trace(
        all_threads):
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    spans.enable(True)
    try:
        early = spans.span("front.idle")
        early.__enter__()
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=_ExperimentalConfig(
                         profile_all_threads=all_threads)) as prof:
            early.__exit__(None, None, None)  # closes under the profiler
            with spans.span("plan", 3):
                pass
    finally:
        spans.enable(False)
    names = {e.name for e in prof.events()}
    assert "repro_torch.plan#3" in names
    assert "repro_torch.front.idle" not in names
