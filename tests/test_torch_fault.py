"""Port vs reference: fault tolerance — heartbeat bookkeeping, the elastic
remesh plan, and the privacy consequences of replica loss (d shrinks, the
adversary does not).

The first half mirrors ``tests/test_fault.py`` case for case on the port's
``repro_torch.dist.fault``. The second half holds the port against the JAX
package's module on the same inputs, at tolerance zero: every failure
count 0…d of every scheme of the registry (bare and ``as-*``) at several
deployments gives equal ``pir_degraded_privacy`` dicts (∞ included) and
equal ``scheme_degradation`` dicts and re-fitted parameters; the remesh
plans are equal; and one heartbeat script fires the same death edges in
both monitors."""

import dataclasses
import math

import pytest

from repro.core import build_scheme as ref_build_scheme
from repro.dist import fault as ref_fault
from repro_torch.core import accounting
from repro_torch.core.protocol import Anonymized, build_scheme
from repro_torch.core.schemes import make_scheme
from repro_torch.dist import fault
from repro_torch.dist.fault import (
    FleetState,
    HeartbeatMonitor,
    pir_degraded_privacy,
    plan_elastic_remesh,
    scheme_degradation,
)


# ------------------------------------------ mirrors of tests/test_fault.py
def test_fleet_heartbeats():
    f = FleetState(n_pods=4, heartbeat_timeout_s=10.0)
    for p in range(4):
        f.heartbeat(p, now=100.0)
    f.heartbeat(2, now=150.0)  # only pod 2 stays alive
    assert f.dead_pods(now=155.0) == [0, 1, 3]
    assert f.alive_pods(now=155.0) == [2]


def test_remesh_two_pods_to_one():
    plan = plan_elastic_remesh([1])
    assert plan.mesh_shape == (16, 16)
    assert plan.mesh_axes == ("data", "model")
    assert plan.global_batch_scale == 1.0
    assert plan.restore_from_checkpoint


def test_remesh_scales_batch_with_pods():
    plan = plan_elastic_remesh([0, 1, 2])
    assert plan.mesh_shape == (3, 16, 16)
    assert plan.mesh_axes == ("pod", "data", "model")
    assert plan.global_batch_scale == 3.0


def test_remesh_no_survivors():
    with pytest.raises(RuntimeError):
        plan_elastic_remesh([])


def test_pir_degradation_raises_epsilon():
    base = accounting.epsilon_sparse(0.25, 10, 5)
    out = pir_degraded_privacy(
        d=10, d_a=5, failed=2, scheme="sparse", n=1000, theta=0.25
    )
    assert out["serviceable"] == 1.0
    assert out["epsilon"] > base  # fewer honest servers => worse privacy
    assert out["epsilon"] == accounting.epsilon_sparse(0.25, 8, 5)


def test_pir_degradation_unserviceable_below_da():
    out = pir_degraded_privacy(
        d=10, d_a=5, failed=5, scheme="sparse", n=1000, theta=0.25
    )
    assert out["serviceable"] == 0.0 and math.isinf(out["epsilon"])


def test_pir_degradation_chor_stays_perfect_until_da():
    out = pir_degraded_privacy(d=10, d_a=5, failed=4, scheme="chor", n=1000)
    assert out["epsilon"] == 0.0 and out["serviceable"] == 1.0


def test_degraded_epsilon_matches_accounting_for_every_failure_count():
    """dist.fault reports exactly what core.accounting computes at
    d' = d − failed, for every scheme — ops and accounting can't drift."""
    d, d_a, n, theta, p, u = 10, 3, 1000, 0.25, 40, 64
    for failed in range(0, d - d_a):
        d_eff = d - failed
        sp = pir_degraded_privacy(
            d=d, d_a=d_a, failed=failed, scheme="sparse", n=n, theta=theta
        )
        assert sp["epsilon"] == accounting.epsilon_sparse(theta, d_eff, d_a)
        assert sp["d_effective"] == d_eff and sp["serviceable"] == 1.0
        di = pir_degraded_privacy(
            d=d, d_a=d_a, failed=failed, scheme="direct", n=n, p=p
        )
        assert di["epsilon"] == accounting.epsilon_direct(n, d_eff, d_a, p)
        ass = pir_degraded_privacy(
            d=d, d_a=d_a, failed=failed, scheme="as-sparse", n=n,
            theta=theta, u=u,
        )
        assert ass["epsilon"] == accounting.compose_with_anonymity(
            accounting.epsilon_sparse(theta, d_eff, d_a), u
        )
        sub = pir_degraded_privacy(
            d=d, d_a=d_a, failed=failed, scheme="subset", n=n, t=3
        )
        assert sub["epsilon"] == 0.0
        assert sub["delta"] == accounting.delta_subset(d_eff, d_a,
                                                       min(3, d_eff))


def test_degraded_epsilon_monotone_in_failures():
    """Each lost replica strictly degrades ε until service cuts off."""
    eps = [
        pir_degraded_privacy(
            d=10, d_a=3, failed=f, scheme="sparse", n=1000, theta=0.25
        )["epsilon"]
        for f in range(0, 7)
    ]
    assert all(a < b for a, b in zip(eps, eps[1:]))
    out = pir_degraded_privacy(
        d=10, d_a=3, failed=7, scheme="sparse", n=1000, theta=0.25
    )
    assert out["serviceable"] == 0.0 and math.isinf(out["epsilon"])


def test_fleet_drives_remesh_plan():
    """End to end: heartbeats -> survivor set -> remesh plan."""
    f = FleetState(n_pods=3, heartbeat_timeout_s=5.0)
    f.heartbeat(0, now=10.0)
    f.heartbeat(2, now=12.0)
    # pod 1 never checked in; pod 0 expires by t=16
    plan = plan_elastic_remesh(f.alive_pods(now=16.0))
    assert plan.survivors == (2,)
    assert plan.mesh_shape == (16, 16)
    plan2 = plan_elastic_remesh(f.alive_pods(now=13.0))
    assert plan2.survivors == (0, 2)
    assert plan2.mesh_shape == (2, 16, 16)
    assert plan2.global_batch_scale == 2.0


def test_alive_window_is_half_open():
    """Liveness is ``now - last < timeout``: dead at *exactly* the
    timeout boundary."""
    f = FleetState(n_pods=1, heartbeat_timeout_s=10.0)
    f.heartbeat(0, now=100.0)
    assert f.alive_pods(now=109.9) == [0]
    assert f.dead_pods(now=110.0) == [0]  # boundary: already dead
    assert f.dead_pods(now=110.1) == [0]


def test_monitor_never_beaten_pods_fire_no_edge():
    mon = HeartbeatMonitor(3, heartbeat_timeout_s=1.0)
    edges = []
    mon.on_failure(lambda newly, alive: edges.append((newly, alive)))
    mon.heartbeat(0, now=0.0)
    # pods 1 and 2 never proved liveness: dead per FleetState, no edge
    assert mon.state.dead_pods(now=5.0) == [0, 1, 2]
    assert mon.poll(now=0.5) == []
    assert edges == []


def test_monitor_one_edge_per_death_and_revival_rearms():
    mon = HeartbeatMonitor(2, heartbeat_timeout_s=1.0)
    edges = []
    mon.on_failure(lambda newly, alive: edges.append((newly, alive)))
    mon.heartbeat(0, now=0.0)
    mon.heartbeat(1, now=0.0)
    assert mon.poll(now=0.5) == []
    assert mon.poll(now=1.5) == [0, 1]   # both silent past the window
    assert mon.poll(now=2.0) == []       # edge-triggered: no repeat
    assert edges == [([0, 1], [])]
    mon.heartbeat(1, now=3.0)            # revival re-arms pod 1's edge
    assert mon.poll(now=3.1) == []
    assert mon.poll(now=4.5) == [1]      # second death is its own edge
    assert edges[-1] == ([1], [])


def test_scheme_degradation_matches_own_privacy():
    """The degraded scheme a pipeline swaps in prices exactly what the
    info dict accounts — per scheme, including re-fitted params."""
    n = 1000
    cases = [
        make_scheme("sparse", d=6, d_a=2, theta=0.25),
        make_scheme("direct", d=6, d_a=2, p=12),
        make_scheme("subset", d=6, d_a=2, t=5),
        make_scheme("as-sparse", d=6, d_a=2, theta=0.25, u=64),
        make_scheme("chor", d=6, d_a=2),
    ]
    for sch in cases:
        degraded, info = scheme_degradation(sch, n, failed=2)
        assert degraded is not None and info["serviceable"] == 1.0
        assert info["d_effective"] == 4.0
        eps, delta = degraded.privacy(n)
        assert eps == info["epsilon"]
        assert delta == info["delta"]


def test_scheme_degradation_refits_t_and_p():
    sub = make_scheme("subset", d=8, d_a=2, t=7)
    degraded, info = scheme_degradation(sub, 1000, failed=4)
    # t clamps to the 4 survivors; delta re-priced for the smaller pool
    assert degraded.t == 4
    assert info["delta"] == accounting.delta_subset(4, 2, 4)
    di = make_scheme("direct", d=8, d_a=2, p=16)
    degraded, info = scheme_degradation(di, 1000, failed=3)
    # p=16 rounds down to a positive multiple of d'=5
    assert degraded.p == 15
    assert info["epsilon"] == accounting.epsilon_direct(1000, 5, 2, 15)


def test_scheme_degradation_unserviceable_returns_none():
    sch = make_scheme("sparse", d=4, d_a=2, theta=0.25)
    degraded, info = scheme_degradation(sch, 1000, failed=2)  # d' == d_a
    assert degraded is None
    assert info["serviceable"] == 0.0 and math.isinf(info["epsilon"])
    sub = make_scheme("subset", d=4, d_a=1, t=3)
    degraded, info = scheme_degradation(sub, 1000, failed=3)  # 1 survivor
    assert degraded is None and info["serviceable"] == 0.0


# ------------------------------------------- port vs the JAX package's module
# (d, d_a, n, theta, p, t, u): small, the paper's CT deployment, and one
# with d_a = d - 1 (the paper's pessimistic corner)
DEPLOYMENTS = [
    (5, 2, 256, 0.3, 10, 3, 16),
    (10, 3, 1000, 0.25, 40, 7, 64),
    (100, 50, 1_000_000, 0.25, 100, 51, 1000),
    (6, 5, 4096, 0.1, 12, 6, 4),
]
SCHEMES = ["chor", "sparse", "direct", "subset", "as-sparse", "as-direct"]


def _params(name, theta, p, t, u):
    base = name[3:] if name.startswith("as-") else name
    kw = {"sparse": dict(theta=theta), "direct": dict(p=p),
          "subset": dict(t=t), "chor": {}}[base]
    if name.startswith("as-"):
        kw["u"] = u
    return kw


def _same(a, b):
    """Equal floats, ∞ included (== already is; NaN never occurs)."""
    assert set(a) == set(b)
    for k in a:
        assert a[k] == b[k], (k, a[k], b[k])
        assert type(a[k]) is type(b[k]), k


@pytest.mark.parametrize("dep", DEPLOYMENTS, ids=lambda d: f"d{d[0]}da{d[1]}")
@pytest.mark.parametrize("name", SCHEMES)
def test_degraded_privacy_equals_the_reference_at_every_failure_count(
        name, dep):
    d, d_a, n, theta, p, t, u = dep
    for failed in range(d + 1):
        kw = dict(d=d, d_a=d_a, failed=failed, scheme=name, n=n,
                  theta=theta, p=p, t=t, u=u)
        _same(pir_degraded_privacy(**kw), ref_fault.pir_degraded_privacy(**kw))


def _scheme_params(sch):
    """A scheme's identity and parameters, bare or wrapped."""
    if sch is None:
        return None
    out = {"name": sch.name, "d": sch.d, "d_a": sch.d_a}
    if hasattr(sch, "u") and hasattr(sch, "base"):
        out["u"] = sch.u
        sch = sch.base
    out.update({f.name: getattr(sch, f.name)
                for f in dataclasses.fields(sch)})
    return out


@pytest.mark.parametrize("dep", DEPLOYMENTS, ids=lambda d: f"d{d[0]}da{d[1]}")
@pytest.mark.parametrize("name", SCHEMES)
def test_scheme_degradation_equals_the_reference_at_every_failure_count(
        name, dep):
    d, d_a, n, theta, p, t, u = dep
    kw = _params(name, theta, p, t, u)
    ours = build_scheme(name, d, d_a, **dict(kw))
    theirs = ref_build_scheme(name, d, d_a, **dict(kw))
    assert isinstance(ours, Anonymized) == name.startswith("as-")
    # every failure count of a small deployment; the CT one at the edges
    counts = (range(d + 1) if d <= 10
              else sorted({0, 1, 2, 49, 50, 51, 98, 99, 100}))
    for failed in counts:
        got, info = scheme_degradation(ours, n, failed)
        want, ref_info = ref_fault.scheme_degradation(theirs, n, failed)
        _same(info, ref_info)
        assert _scheme_params(got) == _scheme_params(want), failed
        if got is not None:
            assert got.privacy(n) == want.privacy(n)


@pytest.mark.parametrize("alive", [
    [0], [3], [0, 1], [2, 0, 1], list(range(7)), [9, 4, 7, 1],
])
def test_remesh_plan_equals_the_reference(alive):
    ours = plan_elastic_remesh(alive)
    theirs = ref_fault.plan_elastic_remesh(alive)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert fault.POD_MESH_SHAPE == ref_fault.POD_MESH_SHAPE
    assert fault.POD_MESH_AXES == ref_fault.POD_MESH_AXES


def test_remesh_with_no_survivors_raises_like_the_reference():
    for plan in (plan_elastic_remesh, ref_fault.plan_elastic_remesh):
        with pytest.raises(RuntimeError):
            plan([])


def _heartbeat_script(seed, pods=5, steps=200):
    """A deterministic script of heartbeats and polls: each step either
    beats one pod at ``now`` or polls; some pods fall silent for a while,
    then come back (revivals re-arm their edges)."""
    import random

    rnd = random.Random(seed)
    now, script = 0.0, []
    silent = set()
    for _ in range(steps):
        now += rnd.choice([0.05, 0.1, 0.25, 0.5, 1.0])
        r = rnd.random()
        if r < 0.1:
            silent.add(rnd.randrange(pods))
        elif r < 0.15 and silent:
            silent.discard(sorted(silent)[0])
        for pod in range(pods):
            if pod not in silent and rnd.random() < 0.7:
                script.append(("beat", pod, now))
        script.append(("poll", None, now))
    return script


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_monitor_fires_the_same_edges_as_the_reference(seed):
    monitors = [HeartbeatMonitor(5, heartbeat_timeout_s=1.0),
                ref_fault.HeartbeatMonitor(5, heartbeat_timeout_s=1.0)]
    edges = [[], []]
    polls = [[], []]
    for m, e in zip(monitors, edges):
        m.on_failure(lambda newly, alive, e=e: e.append((newly, alive)))
    for op, pod, now in _heartbeat_script(seed):
        for m, pl in zip(monitors, polls):
            if op == "beat":
                m.heartbeat(pod, now)
            else:
                pl.append(m.poll(now))
    assert edges[0] == edges[1]
    assert polls[0] == polls[1]
    assert len(edges[0]) > 0  # the script does kill and revive pods


def test_fleet_state_rejects_a_pod_out_of_range_like_the_reference():
    for state in (FleetState(3), ref_fault.FleetState(3)):
        with pytest.raises(ValueError):
            state.heartbeat(3, now=0.0)
    for fn in (pir_degraded_privacy, ref_fault.pir_degraded_privacy):
        with pytest.raises(ValueError):
            fn(d=4, d_a=1, failed=5, scheme="chor", n=10)
        with pytest.raises(ValueError):
            fn(d=4, d_a=1, failed=1, scheme="nope", n=10)


def test_every_scheme_of_the_registry_is_covered():
    from repro_torch.core import SCHEMES as PORT_SCHEMES

    assert set(SCHEMES) == set(PORT_SCHEMES)
    assert all(p % d == 0 for d, _, _, _, p, _, _ in DEPLOYMENTS)
