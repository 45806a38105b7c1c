"""Port vs reference: the port as a whole — scheduler, router, execution
backend and serving pipeline (tolerance zero on bytes).

Wire payloads made by the reference's router are carried across through
numpy and answered by both packages; the same (client, index) submissions
go through both pipelines. The port runs on the CPU here because the tests
say ``device="cpu"``; its default device is the card."""

import dataclasses
import itertools
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import pir_ct as ref_pir_ct
from repro.core import make_scheme as ref_make_scheme
from repro.db import make_synthetic_store as ref_make_store
from repro.serve import BatchScheduler as RefScheduler
from repro.serve import SchemeRouter as RefRouter
from repro.serve import ShardedBackend as RefBackend
from repro.serve import bucket_size as ref_bucket_size
from repro_torch import convert
from repro_torch.configs import pir_ct
from repro_torch.core import make_scheme
from repro_torch.core.accounting import PrivacyBudget
from repro_torch.db import make_synthetic_store
from repro_torch.serve import (
    BatchScheduler, PIRServingEngine, SchemeRouter, ServingPipeline,
    ShardedBackend, bucket_size,
)

from _torch_parity import words_t2n

REPO = pathlib.Path(__file__).resolve().parent.parent


def _store(n, rb, seed=0):
    return make_synthetic_store(n, rb, seed=seed, device="cpu")


def _pipe(store, scheme, **kw):
    kw.setdefault("backend", ShardedBackend(store, device="cpu"))
    return ServingPipeline(store, scheme, device="cpu", **kw)


# ------------------------------------------------------- (a) routed payload
ROUTED_CASES = [
    ("chor", {}, 3, 1, 128, 12, None),
    ("chor", {}, 2, 1, 128, 8, 4),          # parity forced
    ("sparse", dict(theta=0.3), 3, 1, 128, 12, None),
    ("sparse", dict(theta=0.25), 4, 2, 2048, 64, None),   # fused form
    ("sparse", dict(theta=0.25), 4, 2, 300, 50, None),
    ("sparse", dict(theta=0.5), 3, 1, 100, 5, None),      # dense fold
]


@pytest.mark.parametrize("name,kw,d,d_a,n,rb,pmin", ROUTED_CASES)
@pytest.mark.parametrize("backend", ["auto", "cuda", "ref"])
def test_routed_payload_answered_identically(name, kw, d, d_a, n, rb, pmin,
                                             backend):
    rstore = ref_make_store(n, rb, seed=2)
    rsch = ref_make_scheme(name, d=d, d_a=d_a, **kw)
    rrouter = RefRouter(rsch)
    q_idx = np.array([0, n // 2, n - 1, 5], np.int32)
    routed = rrouter.plan(jax.random.key(3), n, jnp.asarray(q_idx))
    rresp = RefBackend(rstore, parity_min_batch=pmin).answer_batch(
        routed, scheme=rsch.staged)
    want = np.asarray(rrouter.finalize(routed, rresp))

    tstore = convert.store_from_numpy(
        np.asarray(rstore.packed), rstore.record_bits, device="cpu")
    tsch = make_scheme(name, d=d, d_a=d_a, **kw)
    trouter = SchemeRouter(tsch)
    tq = convert.queries_from_numpy(
        routed.kind, np.asarray(routed.payload), routed.servers, q_idx,
        routed.theta, device="cpu")
    tback = ShardedBackend(tstore, backend=backend, parity_min_batch=pmin,
                           device="cpu")
    tresp = tback.answer_batch(tq, scheme=tsch.staged)
    np.testing.assert_array_equal(words_t2n(tresp), np.asarray(rresp))
    np.testing.assert_array_equal(words_t2n(trouter.finalize(tq, tresp)), want)
    np.testing.assert_array_equal(want, np.asarray(rstore.packed)[q_idx])
    assert sum(tback.path_counts.values()) == d
    assert all(tback.stats[s].n == 1 for s in range(d))


def test_handed_in_plan_is_used_or_replanned():
    store = _store(512, 24)
    sch = make_scheme("sparse", d=3, d_a=1, theta=0.25)
    router = SchemeRouter(sch)
    gen = torch.Generator().manual_seed(0)
    q = torch.tensor([1, 2], dtype=torch.int32)
    routed = router.plan(gen, store.n, q)
    back = ShardedBackend(store, device="cpu")
    plan = back.prepare(routed, scheme=sch.staged)
    assert plan.family == "sparse" and plan.bucket == 2
    out = router.finalize(routed, back.answer_batch(routed, plan=plan))
    assert torch.equal(out, store.packed[q.long()])
    assert back.planner.metrics["plans_built"] == 1
    # a plan for another θ must not be executed against this batch
    other = dataclasses.replace(plan, theta=0.4)
    out = router.finalize(routed, back.answer_batch(
        routed, plan=other, scheme=sch.staged))
    assert torch.equal(out, store.packed[q.long()])


def test_router_precompute_split_and_checks():
    sch = make_scheme("chor", d=3, d_a=1)
    router = SchemeRouter(sch)
    gen = torch.Generator().manual_seed(1)
    pre = router.precompute(gen, 64, 2)
    routed = router.plan(gen, 64, torch.tensor([3, 9], dtype=torch.int32), pre=pre)
    assert routed.payload.shape == (3, 2, 64) and routed.servers == (0, 1, 2)
    with pytest.raises(ValueError, match="n="):
        router.plan(gen, 65, torch.tensor([3, 9], dtype=torch.int32), pre=pre)


# --------------------------------------------------------- (b) both pipelines
@pytest.mark.parametrize("scheme", ["sparse", "chor"])
def test_same_submissions_through_both_pipelines(scheme):
    rcfg = dataclasses.replace(ref_pir_ct.reduced(), scheme=scheme,
                               cache_entries=0)
    tcfg = dataclasses.replace(pir_ct.reduced(), scheme=scheme)
    rpipe = ref_pir_ct.make_serving_pipeline(rcfg, seed=1)
    tpipe = pir_ct.make_serving_pipeline(tcfg, device="cpu", seed=1)
    rng = np.random.default_rng(0)
    asked = {f"client-{c}": int(i)
             for c, i in enumerate(rng.integers(0, tcfg.n_records, size=21))}
    for client, i in asked.items():
        assert rpipe.submit(client, i) and tpipe.submit(client, i)
    rout, tout = rpipe.flush(), tpipe.flush()
    assert set(rout) == set(tout) == set(asked)
    for client, i in asked.items():
        np.testing.assert_array_equal(tout[client], rout[client])
        np.testing.assert_array_equal(tout[client], tpipe.store.record_bytes(i))
    for key in ("queries", "batches", "padded", "truncated", "refused",
                "records_touched", "blocks_sent", "d_effective",
                "epsilon_per_query", "delta_per_query"):
        assert tpipe.metrics[key] == pytest.approx(rpipe.metrics[key], rel=1e-12)
    assert tpipe.backend.path_counts == rpipe.backend.path_counts


def test_pir_ct_config_equals_reference_and_builds_pipeline():
    rcfg, tcfg = ref_pir_ct.CONFIG, pir_ct.CONFIG
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(rcfg)
    assert dataclasses.asdict(pir_ct.reduced()) == dataclasses.asdict(
        ref_pir_ct.reduced())
    assert [(s.name, s.kind, s.params) for s in pir_ct.SHAPES] == [
        (s.name, s.kind, s.params) for s in ref_pir_ct.SHAPES]
    cfg = pir_ct.reduced()
    pipe = pir_ct.make_serving_pipeline(cfg, device="cpu", seed=1)
    assert pipe.scheme.name == cfg.scheme and pipe.scheme.d == cfg.d
    assert pipe.scheduler.max_batch == cfg.query_batch
    assert pipe.scheduler.max_wait_s == pytest.approx(cfg.max_wait_ms / 1e3)
    assert pipe.submit("c", 5)
    assert (pipe.flush()["c"] == pipe.store.record_bytes(5)).all()
    # reduced(): the slab fits a block's shared memory -> the fused form
    plan = next(iter(pipe.backend.planner._plans.values()))
    assert plan.path == "sparse_ref"  # CPU store: auto resolves to ref
    gpu_like = ShardedBackend(pipe.store, backend="cuda", device="cpu")
    assert gpu_like.prepare(
        pipe.router.plan(torch.Generator().manual_seed(0), pipe.store.n,
                         torch.zeros(8, dtype=torch.int32)),
        scheme=pipe.staged).path == "sparse_fused"


def test_cache_entries_are_ignored_with_one_logged_line(caplog):
    """The name predates the port of the cache: ``cache_entries`` now
    attaches a QueryCache of that size, as the reference's config does,
    and nothing is logged about it."""
    cfg = pir_ct.reduced()
    assert cfg.cache_entries > 0
    with caplog.at_level("INFO", logger="repro_torch.configs.pir_ct"):
        pipe = pir_ct.make_serving_pipeline(cfg, device="cpu")
    assert not [r for r in caplog.records
                if "cache_entries" in r.getMessage()]
    rpipe = ref_pir_ct.make_serving_pipeline(cfg_ref := ref_pir_ct.reduced())
    assert pipe.cache.max_entries == rpipe.cache.max_entries == (
        cfg_ref.cache_entries)
    assert pipe.cache.signature == rpipe.cache.signature
    assert pir_ct.make_serving_pipeline(
        dataclasses.replace(cfg, cache_entries=0), device="cpu").cache is None


# ------------------------------------------------------------- (c) scheduler
@pytest.mark.parametrize("b,cap", [(0, 64), (1, 1024), (2, 1024), (3, 1024),
                                   (5, 1024), (8, 1024), (9, 1024), (1000, 64),
                                   (64, 64), (65, 64)])
def test_bucket_size_equals_reference(b, cap):
    assert bucket_size(b, cap) == ref_bucket_size(b, cap)
    assert BatchScheduler(max_batch=cap).padded_size(b) == RefScheduler(
        max_batch=cap).padded_size(b)


def test_scheduler_equals_reference_under_the_same_fake_clock():
    def run(cls):
        now = itertools.count()
        s = cls(max_batch=8, max_wait_s=5.0, target_latency_s=0.1,
                clock=lambda: next(now))
        trace = [s.target_batch]
        for bs, dt in [(128, 1.28), (8, 0.2), (8, 0.0128), (4, 4.0), (8, 0.01),
                       (0, 1.0), (8, 0.0)]:
            s.observe_service(bs, dt)
            trace.append(s.target_batch)
        for i in range(11):
            s.submit(f"c{i}", i)
        trace.append(s.ready())
        sizes = []
        while len(s):
            sizes.append([(r.client, r.index, r.seq, r.t_enqueue)
                          for r in s.next_batch()])
        trace.append(sizes)
        s.observe_service(8, 2.0)  # target above 1: a lone request waits
        s.submit("late", 1)
        polls = 0
        while not s.ready():
            polls += 1
        trace.append((polls, s.oldest_wait_s()))
        return trace

    assert run(BatchScheduler) == run(RefScheduler)


def test_scheduler_adaptive_target_tracks_service_rate():
    s = BatchScheduler(max_batch=1024, target_latency_s=0.1)
    assert s.target_batch == 1024  # optimistic until observations arrive
    s.observe_service(batch_size=128, dt_s=1.28)  # 10 ms/query -> target 10
    assert s.target_batch == 16  # bucketed up from 10
    for _ in range(20):
        s.observe_service(batch_size=128, dt_s=0.0128)
    assert s.target_batch == 1024
    for _ in range(20):
        s.observe_service(batch_size=16, dt_s=16.0)
    assert s.target_batch == 1


def test_scheduler_rejects_bad_bounds():
    with pytest.raises(ValueError):
        BatchScheduler(max_batch=0)
    with pytest.raises(ValueError):
        BatchScheduler(max_batch=4, min_batch=8)


# -------------------------------------------------------------- (d) pipeline
def test_pipeline_pads_and_truncates():
    store = _store(64, 8)
    pipe = _pipe(store, make_scheme("chor", d=2, d_a=1),
                 scheduler=BatchScheduler(max_batch=4))
    for i in range(6):
        assert pipe.submit(f"c{i}", i * 9 % 64)
    out = pipe.step()  # serves 4 of 6, truncation leaves 2 queued
    assert len(out) == 4 and len(pipe.scheduler) == 2
    assert pipe.metrics["truncated"] == 1
    out.update(pipe.flush())
    assert len(out) == 6
    pipe2 = _pipe(store, make_scheme("chor", d=2, d_a=1),
                  scheduler=BatchScheduler(max_batch=8))
    for i in range(3):
        pipe2.submit(f"c{i}", i)
    out2 = pipe2.flush()
    assert pipe2.metrics["padded"] == 1  # 3 -> bucket 4
    for i in range(3):
        assert (out2[f"c{i}"] == store.record_bytes(i)).all()


def test_pipeline_budget_exhaustion_refusal():
    store = _store(128, 16)
    sch = make_scheme("sparse", d=4, d_a=2, theta=0.25)
    eps = sch.epsilon(store.n)
    pipe = _pipe(store, sch,
                 default_budget=lambda: PrivacyBudget(epsilon_limit=2.5 * eps))
    assert pipe.price == (eps, 0.0)
    assert pipe.submit("c", 1) and pipe.submit("c", 2)
    assert not pipe.submit("c", 3)  # third exceeds 2.5x eps
    assert pipe.metrics["refused"] == 1
    assert pipe.submit("other", 3)  # budgets are per client
    pipe.set_budget("vip", PrivacyBudget(epsilon_limit=100 * eps))
    assert all(pipe.submit("vip", i) for i in range(10))


@pytest.mark.parametrize("name,kw,path", [
    ("chor", {}, "fold"), ("sparse", dict(theta=0.3), "sparse")])
def test_pipeline_schemes_correct_and_paths_used(name, kw, path):
    store = _store(512, 24, seed=2)
    pipe = _pipe(store, make_scheme(name, d=5, d_a=2, **kw))
    pipe.submit("x", 99)
    pipe.submit("y", 500)
    out = pipe.flush()
    assert (out["x"] == store.record_bytes(99)).all()
    assert (out["y"] == store.record_bytes(500)).all()
    assert pipe.backend.path_counts[path] == 5
    assert pipe.metrics["queries"] == 2 and pipe.metrics["batches"] == 1


def test_pipeline_parity_path_above_forced_crossover():
    store = _store(128, 8, seed=4)
    pipe = _pipe(
        store, make_scheme("chor", d=2, d_a=1),
        scheduler=BatchScheduler(max_batch=16),
        backend=ShardedBackend(store, parity_min_batch=8, device="cpu"),
    )
    for i in range(16):
        pipe.submit(f"c{i}", i * 7 % 128)
    out = pipe.flush()
    assert pipe.backend.path_counts["parity"] == 2  # both servers
    for i in range(16):
        assert (out[f"c{i}"] == store.record_bytes(i * 7 % 128)).all()


def test_latency_ema_observed_for_every_replica():
    store = _store(128, 16, seed=9)
    lat = {i: (0.5 if i == 1 else 0.001) for i in range(4)}
    pipe = ServingPipeline(store, make_scheme("chor", d=4, d_a=2),
                           simulate_latency=lambda s: lat[s], device="cpu")
    for _ in range(3):
        pipe.submit("c", 7)
        out = pipe.flush()
    assert (out["c"] == store.record_bytes(7)).all()
    assert all(pipe.stats[i].n == 3 for i in range(4))
    assert pipe.stats[1].ema_s > pipe.stats[0].ema_s
    assert 1 not in pipe.fastest_servers(3)


def test_pipeline_poll_serves_on_target_or_deadline():
    store = _store(64, 8, seed=3)
    now = itertools.count()
    sched = BatchScheduler(max_batch=8, max_wait_s=3.0, clock=lambda: next(now))
    sched.observe_service(8, 4 * sched.target_latency_s)  # pin target to 2
    assert sched.target_batch == 2
    pipe = _pipe(store, make_scheme("chor", d=2, d_a=1), scheduler=sched)
    pipe.submit("a", 5)
    assert pipe.poll() == {}
    pipe.submit("b", 6)
    assert set(pipe.poll()) == {"a", "b"}
    pipe.submit("c", 7)
    polls = 0
    while not (out := pipe.poll()):
        polls += 1
        assert polls < 10, "deadline never tripped"
    assert set(out) == {"c"} and (out["c"] == store.record_bytes(7)).all()


def test_engine_facade_back_compat():
    store = _store(128, 16, seed=5)
    eng = PIRServingEngine(
        store, make_scheme("sparse", d=4, d_a=2, theta=0.25), max_batch=64,
        simulate_latency=lambda s: 0.001, seed=3, device="cpu",
    )
    assert isinstance(eng, ServingPipeline) and eng.max_batch == 64
    assert eng.submit("alice", 17)
    out = eng.flush()
    assert (out["alice"] == store.record_bytes(17)).all()
    assert eng.metrics["queries"] == 1 and eng.metrics["batches"] == 1
    assert set(eng.stats) == set(range(4))
    assert len(eng.fastest_servers(2)) == 2
    assert eng.budget("alice").spent_epsilon > 0


def test_engine_facade_flush_serves_one_batch():
    store = _store(64, 8, seed=6)
    eng = PIRServingEngine(store, make_scheme("chor", d=2, d_a=1),
                           max_batch=4, device="cpu")
    for i in range(6):
        eng.submit(f"c{i}", i)
    assert len(eng.flush()) == 4 and len(eng.scheduler) == 2
    assert len(eng.flush()) == 2 and eng.flush() == {}


def test_plan_timer_excludes_phase_lock_contention():
    now = itertools.count()
    clock = lambda: next(now)
    store = _store(128, 8, seed=9)
    pipe = _pipe(store, make_scheme("chor", d=2, d_a=1),
                 scheduler=BatchScheduler(max_batch=8, clock=clock))

    class ContendedLock:
        def __init__(self, inner):
            self.inner = inner

        def __enter__(self):
            for _ in range(100):
                clock()
            return self.inner.__enter__()

        def __exit__(self, *exc):
            return self.inner.__exit__(*exc)

    pipe._phase_lock = ContendedLock(pipe._phase_lock)
    assert pipe.submit("alice", 3)
    planned = pipe.plan_requests(pipe.take_batch())
    assert planned.plan_s == 1  # exactly the two timer reads of the plan
    results = pipe.execute_planned(planned)
    assert (dict((r.client, a) for r, a in results)["alice"]
            == store.record_bytes(3)).all()


def test_same_seed_same_wire_bits():
    """One generator per pipeline, seeded from ``seed``."""
    store = _store(64, 8)
    payloads = []
    for _ in range(2):
        pipe = _pipe(store, make_scheme("sparse", d=3, d_a=1, theta=0.3), seed=7)
        pipe.submit("a", 3)
        payloads.append(pipe.plan_requests(pipe.take_batch()).routed.payload)
    assert torch.equal(payloads[0], payloads[1])
    other = _pipe(store, make_scheme("sparse", d=3, d_a=1, theta=0.3), seed=8)
    other.submit("a", 3)
    assert not torch.equal(
        other.plan_requests(other.take_batch()).routed.payload, payloads[0])


# ------------------------------------------------------ (e) deferred features
def test_deferred_features_raise():
    """The name predates the port of the cache and the ``index`` kind:
    the pipeline now takes a cache (refusing one signed for another
    scheme, as the reference does), and the backend answers the
    reference's own direct payload with the reference's records."""
    from repro_torch.serve import QueryCache

    store = _store(64, 8)
    sch = make_scheme("chor", d=2, d_a=1)
    with pytest.raises(ValueError, match="cache built for"):
        ServingPipeline(store, sch, device="cpu",
                        cache=QueryCache(make_scheme("chor", d=3, d_a=1), 64))
    assert _pipe(store, sch, cache=QueryCache(sch, 64)).cache is not None
    rstore = ref_make_store(64, 8, seed=0)
    rsch = ref_make_scheme("direct", d=2, d_a=1, p=8).staged
    rq = RefRouter(rsch).plan(jax.random.key(0), 64, jnp.asarray([5, 63]))
    want = np.asarray(RefBackend(rstore).answer_batch(rq, scheme=rsch))
    dsch = make_scheme("direct", d=2, d_a=1, p=8)
    pipe = _pipe(store, dsch)
    routed = convert.queries_from_numpy(
        rq.kind, np.asarray(rq.payload), rq.servers, np.asarray(rq.q_idx),
        device="cpu")
    got = pipe.backend.answer_batch(routed, scheme=pipe.staged)
    assert got.shape == (2, 2, 4, store.words)
    np.testing.assert_array_equal(words_t2n(got), want)
    assert pipe.backend.path_counts["direct"] == 2
    np.testing.assert_array_equal(
        words_t2n(pipe.router.finalize(routed, got)),
        np.asarray(rstore.packed)[[5, 63]])


def test_device_rule_no_card_no_cpu_carry_on():
    """Entry points default to the card and raise without one; a store on
    the CPU is refused by a backend asked for the card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    store = _store(16, 4)
    sch = make_scheme("chor", d=2, d_a=1)
    for make in (lambda: ShardedBackend(store),
                 lambda: ServingPipeline(store, sch),
                 lambda: pir_ct.make_serving_pipeline(pir_ct.reduced()),
                 lambda: convert.store_from_numpy(
                     np.zeros((2, 1), np.uint32), 32)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    from repro_torch._device import device_fingerprint

    with pytest.raises(RuntimeError, match="CUDA"):
        device_fingerprint()


def test_launch_serve_runs_on_the_named_device(capsys):
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--n", "256", "--record-bytes", "16",
                "--queries", "12", "--batch", "8", "--d", "3", "--da", "1"])
    text = capsys.readouterr().out
    assert "verified exact" in text and "'sparse': 6" in text
    # the direct family, once a "not ported" refusal, serves exactly
    serve.main(["--device", "cpu", "--scheme", "direct", "--n", "256",
                "--record-bytes", "16", "--queries", "12", "--batch", "8",
                "--d", "3", "--da", "1", "--p", "6"])
    text = capsys.readouterr().out
    assert text.count("verified exact") == 2 and "'direct': 6" in text


# ------------------------------------------------------------ import hygiene
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax|from\s+jax|import\s+repro(\s|\.|,|$)|from\s+repro(\.|\s+import))",
    re.MULTILINE,
)


def _port_sources():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    return files


def test_port_imports_neither_jax_nor_the_reference_package():
    files = _port_sources()
    assert len(files) > 20
    for path in files:
        hit = FORBIDDEN.search(path.read_text(encoding="utf-8"))
        assert hit is None, f"{path.relative_to(REPO)}: {hit.group(0)!r}"


def test_port_never_probes_for_a_card_to_pick_the_cpu():
    pattern = re.compile(r"if\s+torch\.cuda\.is_available\(\)\s+else")
    for path in _port_sources():
        assert not pattern.search(path.read_text(encoding="utf-8")), path
