"""Port vs reference: the fleet harness and replica loss in the pipeline.

The first half mirrors ``tests/test_fleet.py`` case for case on the port
(``repro_torch.fleet``, ``ServingPipeline.degrade_replicas``,
``ShardedBackend.relabel_replicas``), on the CPU: arrival processes are
deterministic and rate-correct, client populations draw reproducible
budgeted traffic, the SLO collector's counts stay exact, the injector →
monitor → ``degrade_replicas`` signal path remeshes and re-prices ε, and a
mini scenario finishes a mid-traffic replica kill with zero failed
futures.

The second half holds the port against the JAX package at tolerance
zero: arrival times array for array per seed, population draws and
installed budgets, SLO summaries on the same observations, and two
pipelines — one of each package, on the same store — degraded alike:
equal price, ``degraded`` dict, remesh plan, relabelled latency stats and
metrics. Their random streams differ by nature, so the degraded answer
stage is compared on a wire payload the reference made, carried across."""

import dataclasses
import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import fleet as ref_fleet
from repro.core import make_scheme as ref_make_scheme
from repro.db import make_synthetic_store as ref_make_store
from repro.serve import BatchScheduler as RefScheduler
from repro.serve import QueryCache as RefCache
from repro.serve import ServingPipeline as RefPipeline
from repro_torch import convert
from repro_torch.core import make_scheme
from repro_torch.db import make_synthetic_store
from repro_torch.dist.fault import HeartbeatMonitor, pir_degraded_privacy
from repro_torch.fleet import (
    BurstyArrivals,
    ClientPopulation,
    DiurnalArrivals,
    FaultEvent,
    FaultInjector,
    FleetScenario,
    PoissonArrivals,
    SLOCollector,
    run_scenario,
)
from repro_torch.serve import (
    BatchScheduler,
    QueryCache,
    ServingPipeline,
    scheme_signature,
)

from _torch_parity import words_t2n


# ----------------------------------------------------------------- arrivals
def test_poisson_times_deterministic_sorted_and_rate_correct():
    a = PoissonArrivals(rate_qps=500.0)
    t1 = a.times(4.0, seed=3)
    t2 = a.times(4.0, seed=3)
    np.testing.assert_array_equal(t1, t2)  # same seed, same schedule
    assert len(a.times(4.0, seed=4)) != 0 and not np.array_equal(
        t1, a.times(4.0, seed=4)
    )
    assert np.all(np.diff(t1) >= 0) and t1[0] >= 0 and t1[-1] < 4.0
    # λT = 2000; a Poisson count is within 5σ of its mean essentially always
    assert abs(len(t1) - 2000) < 5 * math.sqrt(2000)


def test_bursty_and_diurnal_rates_and_thinning():
    b = BurstyArrivals(base_qps=50.0, burst_qps=500.0, period_s=1.0, duty=0.2)
    assert b.peak_qps == 500.0
    assert float(b.rate(np.array([0.1]))[0]) == 500.0   # inside the burst
    assert float(b.rate(np.array([0.5]))[0]) == 50.0    # off-duty
    t = b.times(10.0, seed=0)
    # mean rate = 0.2*500 + 0.8*50 = 140 qps over 10 s
    assert abs(len(t) - 1400) < 5 * math.sqrt(1400)
    dr = DiurnalArrivals(mean_qps=100.0, amplitude=0.8, period_s=2.0)
    assert dr.peak_qps == pytest.approx(180.0)
    r = dr.rate(np.linspace(0, 2.0, 101))
    assert float(r.min()) >= 100.0 * 0.2 - 1e-9  # never negative
    t = dr.times(20.0, seed=1)
    assert abs(len(t) - 2000) < 5 * math.sqrt(2000)


def test_arrival_validation():
    with pytest.raises(ValueError):
        PoissonArrivals(rate_qps=0.0)
    with pytest.raises(ValueError):
        BurstyArrivals(base_qps=10.0, burst_qps=50.0, duty=1.5)
    with pytest.raises(ValueError):
        DiurnalArrivals(mean_qps=10.0, amplitude=1.5)


# ------------------------------------------------------------------ clients
def test_population_draw_deterministic_and_in_range():
    pop = ClientPopulation(n_clients=50, n_records=128, seed=5)
    d1 = pop.draw(500, seed=9)
    assert d1 == pop.draw(500, seed=9)
    clients = {c for c, _ in d1}
    assert clients <= {pop.client(i) for i in range(50)}
    assert all(0 <= q < 128 for _, q in d1)
    # the re-poll mix actually lands clients on their own hot record
    hot_hits = sum(1 for c, q in d1 if q == pop.hot_index(int(c[1:])))
    assert hot_hits > 0


def test_population_installs_budgets_at_pipeline_price():
    store = make_synthetic_store(64, 8, seed=0, device="cpu")
    sch = make_scheme("sparse", d=4, d_a=2, theta=0.25)
    pipe = ServingPipeline(store, sch, device="cpu")
    eps_q = pipe.price[0]
    pop = ClientPopulation(
        n_clients=10, n_records=64, budget_queries=(2, 2), seed=1
    )
    assert pop.install_budgets(pipe) == 10
    b = pipe.budget(pop.client(0))
    assert b.epsilon_limit == 2 * eps_q
    # exactly 2 queries affordable, the 3rd refused
    assert pipe.submit(pop.client(0), 1) and pipe.submit(pop.client(0), 2)
    assert not pipe.submit(pop.client(0), 3)
    # unbudgeted population is a no-op
    assert ClientPopulation(n_clients=3, n_records=64).install_budgets(pipe) == 0


# ---------------------------------------------------------------- collector
def test_slo_collector_summary_and_threaded_exactness():
    col = SLOCollector()
    with pytest.raises(ValueError):
        col.observe("lost")
    T, I = 8, 250

    def hammer():
        for _ in range(I):
            col.observe("served", 0.010)
            col.observe("refused")
            col.observe("shed")

    threads = [threading.Thread(target=hammer) for _ in range(T)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    assert not any(t.is_alive() for t in threads)
    col.sample(0.5, queue_depth=7)
    col.sample(1.0, queue_depth=3)
    s = col.summary(wall_s=2.0)
    assert s["served"] == s["refused"] == s["shed"] == T * I  # exact
    assert s["failed"] == 0 and s["arrivals"] == 3 * T * I
    assert s["p50_ms"] == pytest.approx(10.0)
    assert s["goodput_qps"] == T * I / 2.0
    assert s["refusal_rate"] == pytest.approx(1 / 3)
    assert s["max_queue_depth"] == 7.0


# ----------------------------------------------------- injector -> monitor
def test_injector_kill_is_detected_after_timeout_and_revive_rearms():
    mon = HeartbeatMonitor(3, heartbeat_timeout_s=1.0)
    edges = []
    mon.on_failure(lambda newly, alive: edges.append((newly, alive)))
    inj = FaultInjector(
        mon,
        [FaultEvent(2.0, 1), FaultEvent(6.0, 1, kind="revive"),
         FaultEvent(8.0, 1)],
        beat_interval_s=0.25,
    )
    assert inj.tick(0.0) == []          # booting fleet: no edges
    assert inj.tick(1.9) == []          # steady heartbeats keep all alive
    assert inj.tick(2.1) == []          # killed, but within the timeout
    assert inj.down == {1}
    newly = inj.tick(3.5)               # past timeout: edge fires once
    assert newly == [1]
    assert edges == [([1], [0, 2])]
    assert inj.tick(4.0) == []          # edge-triggered: no repeat
    inj.tick(6.2)                       # revived: beating again
    assert inj.down == set()
    assert inj.tick(7.9) == []          # alive again through steady beats
    inj.tick(8.1)                       # second kill lands
    assert inj.tick(9.5) == [1]         # the second death is its own edge
    assert len(edges) == 2


def test_fault_event_validation_and_ordering():
    with pytest.raises(ValueError):
        FaultEvent(1.0, 0, kind="maim")
    with pytest.raises(ValueError):
        FaultEvent(-1.0, 0)
    mon = HeartbeatMonitor(2, heartbeat_timeout_s=1.0)
    inj = FaultInjector(mon, [FaultEvent(5.0, 1), FaultEvent(1.0, 0)])
    inj.tick(2.0)
    assert inj.down == {0}  # events applied in time order, not list order


# ------------------------------------------------- pipeline degraded mode
def _sparse_pipe(n=128, d=4, d_a=2, theta=0.25, cached=True):
    store = make_synthetic_store(n, 16, seed=2, device="cpu")
    sch = make_scheme("sparse", d=d, d_a=d_a, theta=theta)
    return ServingPipeline(
        store, sch,
        scheduler=BatchScheduler(max_batch=16, target_latency_s=10.0),
        cache=QueryCache(sch, store.n) if cached else None,
        device="cpu",
    )


def test_degrade_replicas_reprices_and_still_serves_exact():
    pipe = _sparse_pipe()
    n = pipe.store.n
    eps0 = pipe.price[0]
    info = pipe.degrade_replicas([3])
    bound = pir_degraded_privacy(
        d=4, d_a=2, failed=1, scheme="sparse", n=n, theta=0.25
    )
    assert info == bound and pipe.degraded == bound
    assert pipe.price[0] == bound["epsilon"] > eps0
    assert pipe.metrics["remeshes"] == 1
    assert pipe.metrics["d_effective"] == 3.0
    assert pipe.last_remesh is not None
    assert pipe.last_remesh.survivors == (0, 1, 2)
    assert pipe.staged.d == 3
    # admission now charges the degraded price
    pipe.submit("c", 7)
    out = pipe.flush()
    np.testing.assert_array_equal(out["c"], pipe.store.record_bytes(7))
    assert pipe.budget("c").spent_epsilon == bound["epsilon"]
    # repeat of an already-failed replica is a no-op
    assert pipe.degrade_replicas([3]) == bound
    assert pipe.metrics["remeshes"] == 1


def test_degrade_invalidates_and_resigns_cache():
    pipe = _sparse_pipe()
    pipe.submit("c", 5)
    pipe.flush()
    assert pipe.cache.lookup("c", 5) is not None
    sig0 = pipe.cache.signature
    pipe.degrade_replicas([0])
    # old-d randomness is unreplayable on the survivor wire: memo gone,
    # and the cache now signs as the degraded scheme
    assert pipe.cache.lookup("c", 5) is None
    assert pipe.cache.signature != sig0
    assert pipe.cache.signature == scheme_signature(pipe.staged, pipe.store.n)


def test_degrade_to_unserviceable_refuses_everyone():
    pipe = _sparse_pipe()
    info = pipe.degrade_replicas([0, 1])  # d'=2 == d_a: privacy gone
    assert info["serviceable"] == 0.0 and math.isinf(info["epsilon"])
    assert math.isinf(pipe.price[0])
    assert pipe.metrics["unserviceable"] == 1
    # refused unconditionally — even the default unlimited budget, which
    # would happily "afford" an infinite price
    assert not pipe.submit("anyone", 1)
    assert not pipe.submit_many("anyone", [1, 2])
    assert pipe.metrics["refused"] == 2


def test_degrade_relabels_backend_stats():
    pipe = _sparse_pipe(cached=False)
    # give old replica 2 a distinctive EMA, then kill replica 1
    pipe.backend.stats[2].observe(0.123)
    pipe.degrade_replicas([1])
    # survivor order [0, 2, 3]: old 2 is now logical rank 1
    assert pipe.backend.stats[1].ema_s == 0.123
    assert set(pipe.backend.stats) == {0, 1, 2}


def test_a_remesh_while_a_pre_computes_banks_nothing_stale(monkeypatch):
    """``prefill_cache`` draws a pre, then waits for it outside the phase
    lock; a replica loss landing in that window re-signs the cache for the
    survivors, so the pre (drawn for the old d) must not be banked: a
    router takes it without a word and its answers would XOR the wrong
    servers. (The reference banks it.)"""
    import repro_torch.serve.engine as engine

    pipe = _sparse_pipe(n=128, d=5, d_a=2)
    real = engine.block_pre_ready

    def remesh_meanwhile(pre):
        pipe.degrade_replicas([4])
        return real(pre)

    monkeypatch.setattr(engine, "block_pre_ready", remesh_meanwhile)
    assert pipe.prefill_cache(8) == 0
    assert pipe.cache.pre_depth(8) == 0
    monkeypatch.undo()
    assert pipe.prefill_cache(8) == 1  # drawn for the survivors: banked
    for i in range(8):
        assert pipe.submit(f"c{i}", 9 * i)
    out = pipe.flush()
    assert pipe.cache.metrics["pre_used"] == 1
    for i in range(8):
        np.testing.assert_array_equal(out[f"c{i}"],
                                      pipe.store.record_bytes(9 * i))


def test_relabel_keeps_the_simulated_latency_on_physical_ids():
    store = make_synthetic_store(64, 8, seed=1, device="cpu")
    pipe = ServingPipeline(
        store, make_scheme("subset", d=5, d_a=1, t=2),
        simulate_latency=lambda sid: 0.5 if sid == 4 else 0.0, device="cpu",
    )
    pipe.degrade_replicas([1])
    # physical replica 4 is logical 3 now, and stays the slow one
    sim = pipe.backend._sim
    assert [sim(i) for i in range(4)] == [0.0, 0.0, 0.0, 0.5]
    for i in range(3):
        pipe.submit(f"c{i}", 5 + i)
        np.testing.assert_array_equal(pipe.flush()[f"c{i}"],
                                      store.record_bytes(5 + i))
    assert 3 not in pipe.fastest_servers(2)


# ------------------------------------------------------------- end to end
def test_scenario_with_midtraffic_kill_zero_dropped_futures():
    pipe = _sparse_pipe(n=256)
    n = pipe.store.n
    for i in range(8):
        pipe.submit("warm", (i * 3) % n)
    pipe.flush()
    scenario = FleetScenario(
        name="mini_1loss",
        arrivals=PoissonArrivals(120.0),
        duration_s=0.8,
        faults=(FaultEvent(0.3, 3),),
        heartbeat_timeout_s=0.05,
        seed=2,
    )
    pop = ClientPopulation(n_clients=32, n_records=n, seed=2)
    rep = run_scenario(scenario, pipe, pop, queue_limit=4096, device="cpu")
    assert rep.arrivals > 0
    assert rep.slo["failed"] == 0          # zero dropped in-flight futures
    assert rep.slo["served"] > 0
    assert rep.remeshes == 1 and not rep.unserviceable
    bound = pir_degraded_privacy(
        d=4, d_a=2, failed=1, scheme="sparse", n=n, theta=0.25
    )
    assert rep.price[0] == bound["epsilon"]
    assert rep.degraded == bound
    # the timeline watched the price rise through the kill
    eps_track = [pt["eps_per_query"] for pt in rep.timeline
                 if "eps_per_query" in pt]
    assert eps_track and eps_track[-1] == bound["epsilon"]
    # report serializes without the bulky timeline
    assert "timeline" not in rep.to_json()


def test_scenario_budget_exhaustion_surfaces_as_refusals_not_failures():
    pipe = _sparse_pipe(n=128)
    for i in range(4):
        pipe.submit("warm", i)
    pipe.flush()
    scenario = FleetScenario(
        name="tight_budgets", arrivals=PoissonArrivals(150.0),
        duration_s=0.5, seed=4,
    )
    pop = ClientPopulation(
        n_clients=4, n_records=128, budget_queries=(1, 2), seed=4
    )
    rep = run_scenario(scenario, pipe, pop, device="cpu")
    assert rep.slo["failed"] == 0
    assert rep.slo["refused"] > 0          # exhaustion is policy, not error
    assert rep.slo["served"] > 0
    total = sum(rep.slo[k] for k in ("served", "refused", "shed", "failed"))
    assert total == rep.arrivals == rep.slo["arrivals"]


def test_scenario_validation():
    with pytest.raises(ValueError):
        FleetScenario(name="x", arrivals=PoissonArrivals(1.0), duration_s=0.0)
    with pytest.raises(ValueError):
        FleetScenario(
            name="x", arrivals=PoissonArrivals(1.0), heartbeat_timeout_s=0.0
        )


def test_run_scenario_refuses_a_pipeline_on_another_device():
    pipe = _sparse_pipe()
    scenario = FleetScenario(name="x", arrivals=PoissonArrivals(10.0),
                             duration_s=0.1)
    with pytest.raises(ValueError, match="asked"):
        run_scenario(scenario, pipe, device="meta")


# ------------------------------------------- port vs the JAX package's fleet
ARRIVALS = [
    ("PoissonArrivals", dict(rate_qps=500.0)),
    ("PoissonArrivals", dict(rate_qps=3.5)),
    ("BurstyArrivals", dict(base_qps=50.0, burst_qps=500.0, period_s=1.0,
                            duty=0.2)),
    ("BurstyArrivals", dict(base_qps=30.0, burst_qps=9000.0, period_s=0.5,
                            duty=0.01)),
    ("DiurnalArrivals", dict(mean_qps=100.0, amplitude=0.8, period_s=2.0)),
    ("DiurnalArrivals", dict(mean_qps=40.0, amplitude=0.0, period_s=3.0,
                             phase=1.0)),
]


@pytest.mark.parametrize("kind,kw", ARRIVALS)
def test_arrival_times_equal_the_reference_per_seed(kind, kw):
    ours = {"PoissonArrivals": PoissonArrivals,
            "BurstyArrivals": BurstyArrivals,
            "DiurnalArrivals": DiurnalArrivals}[kind](**kw)
    theirs = getattr(ref_fleet, kind)(**kw)
    assert ours.peak_qps == theirs.peak_qps
    grid = np.linspace(0.0, 4.0, 257)
    np.testing.assert_array_equal(ours.rate(grid), theirs.rate(grid))
    for seed in (0, 1, 7, 123):
        for duration in (0.5, 4.0):
            a = ours.times(duration, seed=seed)
            b = theirs.times(duration, seed=seed)
            assert a.dtype == b.dtype == np.float64
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(n_clients=50, n_records=128, seed=5),
    dict(n_clients=1000, n_records=1_000_000, zipf_a=1.1, repoll_p=0.5,
         seed=3),
    dict(n_clients=7, n_records=3, zipf_a=2.0, repoll_p=0.0, seed=0),
])
def test_population_draws_equal_the_reference(kw):
    ours = ClientPopulation(**kw)
    theirs = ref_fleet.ClientPopulation(**kw)
    for seed in (None, 0, 9):
        assert ours.draw(777, seed=seed) == theirs.draw(777, seed=seed)
    assert [ours.hot_index(i) for i in range(40)] == [
        theirs.hot_index(i) for i in range(40)]


def test_installed_budgets_equal_the_reference():
    rstore = ref_make_store(64, 8, seed=0)
    tstore = make_synthetic_store(64, 8, seed=0, device="cpu")
    rpipe = RefPipeline(rstore, ref_make_scheme("subset", d=5, d_a=2, t=3))
    tpipe = ServingPipeline(tstore, make_scheme("subset", d=5, d_a=2, t=3),
                            device="cpu")
    assert tpipe.price == rpipe.price
    kw = dict(n_clients=20, n_records=64, budget_queries=(1, 9), seed=4)
    assert (ClientPopulation(**kw).install_budgets(tpipe)
            == ref_fleet.ClientPopulation(**kw).install_budgets(rpipe) == 20)
    for i in range(20):
        c = f"c{i:06d}"
        rb, tb = rpipe.budget(c), tpipe.budget(c)
        assert (tb.epsilon_limit, tb.delta_limit) == (rb.epsilon_limit,
                                                      rb.delta_limit)


def test_slo_summaries_equal_the_reference():
    rng = np.random.default_rng(11)
    cols = [SLOCollector(), ref_fleet.SLOCollector()]
    outcomes = rng.choice(["served", "refused", "shed", "failed"], 500,
                          p=[0.7, 0.1, 0.15, 0.05])
    lat = rng.exponential(0.02, 500)
    for k, (o, dt) in enumerate(zip(outcomes, lat)):
        for col in cols:
            col.observe(str(o), float(dt) if o == "served" else None)
            if k % 37 == 0:
                col.sample(k / 100.0, queue_depth=k % 13, eps_per_query=0.5)
    for wall in (2.5, 0.0):
        assert cols[0].summary(wall) == cols[1].summary(wall)
    for q in (50, 90, 99.9):
        assert cols[0].percentile(q) == cols[1].percentile(q)
    assert cols[0].timeline == cols[1].timeline
    empty = [SLOCollector().summary(1.0), ref_fleet.SLOCollector().summary(1.0)]
    assert {k: v for k, v in empty[0].items() if v == v} == {
        k: v for k, v in empty[1].items() if v == v}


def _both_pipes(name="sparse", kw=None, d=5, d_a=2, n=256, cached=True):
    kw = dict(theta=0.25) if kw is None else kw
    rstore = ref_make_store(n, 16, seed=2)
    tstore = convert.store_from_numpy(
        np.asarray(rstore.packed), rstore.record_bits, device="cpu")
    rsch = ref_make_scheme(name, d=d, d_a=d_a, **kw)
    tsch = make_scheme(name, d=d, d_a=d_a, **kw)
    rpipe = RefPipeline(
        rstore, rsch, scheduler=RefScheduler(max_batch=16),
        cache=RefCache(rsch, n) if cached else None, seed=1)
    tpipe = ServingPipeline(
        tstore, tsch, scheduler=BatchScheduler(max_batch=16),
        cache=QueryCache(tsch, n) if cached else None, seed=1, device="cpu")
    return rpipe, tpipe


DEGRADE = [
    ("sparse", dict(theta=0.25)),
    ("chor", {}),
    ("direct", dict(p=10)),
    ("subset", dict(t=4)),
    ("as-sparse", dict(theta=0.25, u=16)),
    ("as-direct", dict(p=10, u=16)),
]
METRIC_KEYS = ("remeshes", "d_effective", "epsilon_per_query",
               "delta_per_query", "unserviceable", "refused")


@pytest.mark.parametrize("name,kw", DEGRADE)
def test_degrade_replicas_equals_the_reference(name, kw):
    rpipe, tpipe = _both_pipes(name, kw)
    for s in range(5):  # distinct EMAs, carried across the relabel
        rpipe.backend.stats[s].observe(0.01 * (s + 1))
        tpipe.backend.stats[s].observe(0.01 * (s + 1))
    for failed in ([4], [4], [1], [0, 3]):
        rinfo = rpipe.degrade_replicas(failed)
        tinfo = tpipe.degrade_replicas(failed)
        assert tinfo == rinfo
        assert tpipe.price == rpipe.price
        assert tpipe.degraded == rpipe.degraded
        assert set(tpipe.metrics) == set(rpipe.metrics)
        for key in METRIC_KEYS:
            assert tpipe.metrics[key] == rpipe.metrics[key], key
        assert (tpipe.last_remesh is None) == (rpipe.last_remesh is None)
        if tpipe.last_remesh is not None:
            assert (dataclasses.asdict(tpipe.last_remesh)
                    == dataclasses.asdict(rpipe.last_remesh))
        assert tpipe.staged.signature == rpipe.staged.signature
        assert {i: (s.ema_s, s.n) for i, s in tpipe.backend.stats.items()} \
            == {i: (s.ema_s, s.n) for i, s in rpipe.backend.stats.items()}
        assert tpipe.cache.signature == rpipe.cache.signature
        assert tpipe.cache.signature == scheme_signature(tpipe.staged,
                                                         tpipe.store.n)
        if tpipe.metrics["unserviceable"]:
            break
    assert tpipe.metrics["unserviceable"] == 1  # d' = 1 < d_a at the end
    assert not tpipe.submit("c", 1) and not rpipe.submit("c", 1)
    assert tpipe.metrics["refused"] == rpipe.metrics["refused"] == 1


@pytest.mark.parametrize("losses", [([1], [0, 4]), ([3], [6], [0, 2])])
def test_successive_losses_keep_each_replicas_stats_and_latency(losses):
    """Losses whose survivors are not a prefix: after every remesh each
    logical replica carries its own physical replica's EMA, and the
    simulated latency still follows the physical machine. The reference
    looks a later remesh's survivors (physical ids) up among the logical
    labels of the one before, so from the second loss on it hands a
    replica another's EMA; the port keeps the labels (ROADMAP.md Queue
    C)."""
    slow = {5: 0.5, 2: 0.25}
    store = make_synthetic_store(256, 16, seed=1, device="cpu")
    pipe = ServingPipeline(
        store, make_scheme("sparse", d=7, d_a=2, theta=0.25),
        simulate_latency=lambda sid: slow.get(sid, 0.0), seed=1,
        device="cpu",
    )
    rpipe, _ = _both_pipes("sparse", d=7, d_a=2, cached=False)
    for s in range(7):
        pipe.backend.stats[s].observe(0.01 * (s + 1))
        rpipe.backend.stats[s].observe(0.01 * (s + 1))
    dead = set()
    for failed in losses:
        pipe.degrade_replicas(failed)
        rpipe.degrade_replicas(failed)
        dead |= set(failed)
        survivors = tuple(r for r in range(7) if r not in dead)
        assert pipe.last_remesh.survivors == survivors
        assert {i: (s.ema_s, s.n) for i, s in pipe.backend.stats.items()} \
            == {i: (0.01 * (p + 1), 1) for i, p in enumerate(survivors)}
        sim = pipe.backend._sim
        assert [sim(i) for i in range(len(survivors))] == [
            slow.get(p, 0.0) for p in survivors]
    # the reference's labels after the last loss: some replica carries
    # another's EMA (the difference the port repairs)
    assert {i: s.ema_s for i, s in rpipe.backend.stats.items()} != {
        i: s.ema_s for i, s in pipe.backend.stats.items()}
    for i, q in enumerate((0, 17, 255)):
        assert pipe.submit(f"c{i}", q)
    out = pipe.flush()
    for i, q in enumerate((0, 17, 255)):
        np.testing.assert_array_equal(out[f"c{i}"], store.record_bytes(q))


@pytest.mark.parametrize("name,kw", DEGRADE)
def test_degraded_answers_on_the_reference_payload(name, kw):
    """After two replicas die, the degraded pipelines answer the
    reference's own wire payload alike, bit for bit, and both serve
    exact records through their own draws."""
    rpipe, tpipe = _both_pipes(name, kw, cached=False)
    rpipe.degrade_replicas([1, 4])
    tpipe.degrade_replicas([1, 4])
    assert tpipe.staged.d == rpipe.staged.d == 3
    n = tpipe.store.n
    q_idx = np.array([0, 17, 255, 40], np.int32)
    routed = rpipe.router.plan(jax.random.key(5), n, jnp.asarray(q_idx))
    ranswers = rpipe.backend.answer_batch(routed, scheme=rpipe.staged)
    tq = convert.queries_from_numpy(
        routed.kind, np.asarray(routed.payload), routed.servers, q_idx,
        routed.theta, device="cpu")
    tanswers = tpipe.backend.answer_batch(tq, scheme=tpipe.staged)
    np.testing.assert_array_equal(words_t2n(tanswers), np.asarray(ranswers))
    np.testing.assert_array_equal(
        words_t2n(tpipe.router.finalize(tq, tanswers)),
        np.asarray(rpipe.router.finalize(routed, ranswers)))
    # both pipelines' own traffic: exact records at the degraded price
    for i, q in enumerate(q_idx):
        assert rpipe.submit(f"c{i}", int(q)) and tpipe.submit(f"c{i}", int(q))
    rout, tout = rpipe.flush(), tpipe.flush()
    for i, q in enumerate(q_idx):
        np.testing.assert_array_equal(tout[f"c{i}"], rout[f"c{i}"])
        np.testing.assert_array_equal(tout[f"c{i}"],
                                      tpipe.store.record_bytes(int(q)))
        assert (tpipe.budget(f"c{i}").spent_epsilon
                == rpipe.budget(f"c{i}").spent_epsilon)
