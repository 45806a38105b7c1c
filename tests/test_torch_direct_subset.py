"""Port vs reference: the direct, subset and anonymized schemes — the rest
of the paper's schemes — and the ``index`` wire kind (tolerance zero on
words and bytes; accounting floats equal).

Every registered scheme runs bare and wrapped in ``Anonymized``. The two
packages' random streams differ by nature, so answers are compared on
wire payloads the reference made and carried across through numpy
(``repro_torch.convert``), including the direct family's ``[d, B, p/d]``
index payloads; the port's own draws are held to the laws: the direct
dummies are distinct, never the queried index, uniform, and split evenly
over the d servers; Subset-PIR's servers are a uniform t-subset by
default and the fastest t by the latency EMA under ``pick_servers``."""

import dataclasses
import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_scheme as ref_build_scheme
from repro.core import make_scheme as ref_make_scheme
from repro.core import registered_schemes as ref_registered_schemes
from repro.core.protocol import Anonymized as RefAnonymized
from repro.db import make_synthetic_store as ref_make_store
from repro.serve import ServingPipeline as RefPipeline
from repro_torch import convert
from repro_torch.core import (
    Anonymized, SCHEMES, SchemeProtocol, as_protocol, build_scheme,
    make_scheme, registered_schemes, scheme_param_names, staged_retrieve,
    staged_retrieve_many,
)
from repro_torch.core import accounting as acc
from repro_torch.core import adversary as adv
from repro_torch.core import anonymity, direct, subset
from repro_torch.core.protocol import Queries, multi_privacy
from repro_torch.db import make_synthetic_store
from repro_torch.serve import (
    SchemeRouter, ServingPipeline, ShardedBackend, scheme_signature,
)

from _torch_parity import words_t2n

D, D_A = 4, 2
PARAMS = {
    "chor": {},
    "sparse": dict(theta=0.3),
    "direct": dict(p=8),
    "subset": dict(t=3),
}
NAMES = sorted(PARAMS)
ANON = [False, True]


def _gen(seed):
    return torch.Generator(device="cpu").manual_seed(seed)


def _both(name, anon, d=D, d_a=D_A, u=64, params=None):
    params = PARAMS[name] if params is None else params[name]
    r = ref_build_scheme(name, d=d, d_a=d_a, **params)
    t = build_scheme(name, d=d, d_a=d_a, **params)
    if anon:
        r, t = RefAnonymized(r, u=u), Anonymized(t, u=u)
    return r, t


def _stores(n=96, rb=20, seed=13):
    rstore = ref_make_store(n, rb, seed=seed)
    tstore = convert.store_from_numpy(
        np.asarray(rstore.packed), rstore.record_bits, device="cpu")
    return rstore, tstore


def test_suite_covers_the_whole_registry():
    assert set(PARAMS) == set(registered_schemes()) == set(
        ref_registered_schemes())
    assert set(SCHEMES) == {"chor", "sparse", "direct", "subset",
                            "as-sparse", "as-direct"}


# ------------------------------------------------ answers on carried payloads
@pytest.mark.parametrize("anon", ANON)
@pytest.mark.parametrize("name", NAMES)
def test_answers_and_records_on_the_reference_payload(name, anon):
    """The reference's wire payload through the port's answer and
    reconstruct stages gives the reference's per-server answers and
    records, bit for bit (the direct family's index payload included)."""
    rstore, tstore = _stores()
    rs, ts = _both(name, anon)
    q_idx = np.array([0, 17, 95, 40], np.int32)
    rq = rs.query(rs.precompute(jax.random.key(3), rstore.n, 4),
                  jnp.asarray(q_idx))
    ra = rs.answer(rstore, rq)
    tq = convert.queries_from_numpy(
        rq.kind, np.asarray(rq.payload), rq.servers, q_idx, rq.theta,
        device="cpu")
    assert tq.kind == ("index" if name == "direct" else "mask")
    ta = ts.answer(tstore, tq)
    np.testing.assert_array_equal(words_t2n(ta.responses),
                                  np.asarray(ra.responses))
    want = np.asarray(rs.reconstruct(ra))
    np.testing.assert_array_equal(words_t2n(ts.reconstruct(ta)), want)
    np.testing.assert_array_equal(want, np.asarray(rstore.packed)[q_idx])
    # and through the serving backend's answer stage
    backend = ShardedBackend(tstore, device="cpu")
    got = backend.answer_batch(tq, scheme=ts)
    np.testing.assert_array_equal(words_t2n(got), np.asarray(ra.responses))
    assert sum(backend.path_counts.values()) == len(rq.servers)


@pytest.mark.parametrize("anon", ANON)
@pytest.mark.parametrize("name", NAMES)
def test_privacy_and_costs_equal_the_reference(name, anon):
    # the CT deployment's d and d_a, its p = d and u, t = d_a + 1
    rs, ts = _both(name, anon, d=100, d_a=50, u=1000, params={
        "chor": {}, "sparse": dict(theta=0.25), "direct": dict(p=100),
        "subset": dict(t=51)})
    for n in (256, 10**4, 10**6):
        assert ts.privacy(n) == rs.privacy(n)
        assert ts.costs(n) == rs.costs(n)
    assert ts.signature == rs.signature
    assert ts.name == rs.name and ts.has_precompute == rs.has_precompute


@pytest.mark.parametrize("anon", ANON)
@pytest.mark.parametrize("name", NAMES)
def test_own_staged_retrieve_returns_the_records(name, anon):
    """The port's own draws, through the four stages, the facade and the
    per-module reference paths, recover exactly the asked records."""
    store = make_synthetic_store(96, 20, seed=13, device="cpu")
    _, sch = _both(name, anon)
    q = torch.tensor([0, 17, 95, 40], dtype=torch.int32)
    want = store.packed[q.long()]
    plan = sch.precompute(_gen(3), store.n, 4)
    assert plan.n == store.n and plan.batch == 4
    queries = sch.query(plan, q)
    assert isinstance(queries, Queries)
    assert torch.equal(sch.reconstruct(sch.answer(store, queries)), want)
    assert torch.equal(staged_retrieve(sch, _gen(4), store, q), want)
    fac = make_scheme(("as-" if anon else "") + name, d=D, d_a=D_A,
                      u=64, **PARAMS[name])
    assert as_protocol(fac) == sch
    assert torch.equal(fac.retrieve(_gen(5), store, q), want)


@pytest.mark.parametrize("module", ["direct", "subset"])
def test_module_level_retrieve_returns_the_records(module):
    store = make_synthetic_store(333, 36, seed=3, device="cpu")
    q = torch.tensor([0, 332, 166], dtype=torch.int32)
    if module == "direct":
        out = direct.retrieve(_gen(2), store, 3, 9, q)
    else:
        out = subset.retrieve(_gen(2), store, 5, 3, q)
    assert torch.equal(out, store.packed[q.long()])


@pytest.mark.parametrize("name", NAMES)
def test_router_plan_matches_staged_query(name):
    """The router is a thin caller: the same generator state gives the
    same wire bits as driving the stages by hand."""
    sch = build_scheme(name, d=D, d_a=D_A, **PARAMS[name])
    q = torch.tensor([1, 50], dtype=torch.int32)
    routed = SchemeRouter(sch).plan(_gen(8), 96, q)
    by_hand = sch.query(sch.precompute(_gen(8), 96, 2), q)
    assert torch.equal(routed.payload, by_hand.payload)
    assert routed.servers == by_hand.servers and routed.kind == by_hand.kind


@pytest.mark.parametrize("name", NAMES)
def test_anonymized_changes_privacy_not_wire_bits(name):
    store = make_synthetic_store(96, 20, seed=13, device="cpu")
    base = build_scheme(name, d=D, d_a=D_A, **PARAMS[name])
    anon = Anonymized(base, u=64)
    q = torch.tensor([5, 60], dtype=torch.int32)
    qb = base.query(base.precompute(_gen(9), store.n, 2), q)
    qa = anon.query(anon.precompute(_gen(9), store.n, 2), q)
    assert torch.equal(qb.payload, qa.payload)
    assert qb.servers == qa.servers and qb.kind == qa.kind
    eps_b, delta_b = base.privacy(store.n)
    eps_a, delta_a = anon.privacy(store.n)
    assert delta_a == delta_b
    if eps_b > 0:
        assert 0 < eps_a < eps_b
    else:
        assert eps_a == 0.0
    assert anon.costs(store.n) == base.costs(store.n)
    out = anon.reconstruct(anon.answer(store, qa))
    assert torch.equal(out, store.packed[q.long()])


def test_anonymized_matches_paper_closed_forms():
    n, u = 96, 64
    eps_s = Anonymized(build_scheme("sparse", d=D, d_a=D_A, theta=0.3),
                       u).privacy(n)[0]
    assert eps_s == pytest.approx(acc.epsilon_as_sparse(0.3, D, D_A, u),
                                  rel=1e-12)
    eps_d = Anonymized(build_scheme("direct", d=D, d_a=D_A, p=8),
                       u).privacy(n)[0]
    assert eps_d == pytest.approx(acc.epsilon_as_direct(n, D, D_A, 8, u),
                                  rel=1e-12)


def test_facade_as_names_build_the_combinator():
    fac = make_scheme("as-sparse", d=D, d_a=D_A, theta=0.3, u=16)
    staged = fac.staged
    assert isinstance(staged, Anonymized) and staged.u == 16
    assert staged.base == build_scheme("sparse", d=D, d_a=D_A, theta=0.3)
    assert staged.name == "as-sparse" and staged.d == D and staged.d_a == D_A
    # facade and combinator sign identically, and as the reference signs
    assert scheme_signature(fac, 96) == scheme_signature(staged, 96)
    from repro.serve import scheme_signature as ref_signature

    assert scheme_signature(fac, 96) == ref_signature(
        ref_make_scheme("as-sparse", d=D, d_a=D_A, theta=0.3, u=16), 96)
    # any registered base composes, including ones SCHEMES does not list
    assert make_scheme("as-subset", d=D, d_a=D_A, t=3, u=4).staged.name == (
        "as-subset")


def test_anonymized_wrapper_serves_through_the_pipeline():
    store = make_synthetic_store(96, 20, seed=13, device="cpu")
    sch = Anonymized(build_scheme("sparse", d=D, d_a=D_A, theta=0.3), u=64)
    pipe = ServingPipeline(store, sch, device="cpu")
    assert pipe.submit("c", 7) and pipe.submit("c", 60)
    out = pipe.flush()
    assert (out["c"] == store.record_bytes(60)).all()
    assert pipe.budget("c").spent_epsilon == pytest.approx(
        2 * sch.privacy(store.n)[0])


def test_anonymized_is_composable_and_validated():
    base = build_scheme("sparse", d=D, d_a=D_A, theta=0.3)
    nested = Anonymized(Anonymized(base, u=4), u=4)
    assert nested.name == "as-as-sparse"
    assert nested.privacy(96)[0] < Anonymized(base, u=4).privacy(96)[0] * 2
    rnested = RefAnonymized(RefAnonymized(
        ref_build_scheme("sparse", d=D, d_a=D_A, theta=0.3), u=4), u=4)
    assert nested.privacy(96) == rnested.privacy(96)
    with pytest.raises(ValueError, match="u >= 1"):
        Anonymized(base, u=0)
    with pytest.raises(TypeError, match="staged scheme"):
        Anonymized("sparse", u=4)


# ------------------------------------------------------------ multi-index
JAGGED = [[17, 3, 3], [], [95], [0, 1, 2, 40, 7]]


@pytest.mark.parametrize("anon", ANON)
@pytest.mark.parametrize("name", NAMES)
def test_multi_index_returns_the_records(name, anon):
    store = make_synthetic_store(96, 20, seed=13, device="cpu")
    _, sch = _both(name, anon)
    many = staged_retrieve_many(sch, _gen(21), store, JAGGED)
    assert len(many) == len(JAGGED)
    for lst, got in zip(JAGGED, many):
        assert got.shape[0] == len(lst)
        if lst:
            assert torch.equal(got, store.packed[torch.tensor(lst)])


@pytest.mark.parametrize("name", NAMES)
def test_multi_privacy_is_exactly_k_times_single(name):
    sch = build_scheme(name, d=D, d_a=D_A, **PARAMS[name])
    for s in (sch, Anonymized(sch, u=32)):
        e1, d1 = s.privacy(96)
        for k in (0, 1, 3, 8):
            assert multi_privacy(s, 96, k) == (k * e1, k * d1)


# ------------------------------------------------------- registry behaviour
def test_registry_lookup_params_and_validation():
    assert scheme_param_names("direct") == ("p",)
    assert scheme_param_names("subset") == ("t",)
    for name in NAMES:
        assert isinstance(build_scheme(name, d=D, d_a=D_A, **PARAMS[name]),
                          SchemeProtocol)
    with pytest.raises(ValueError, match="multiple of d"):
        build_scheme("direct", d=4, d_a=2, p=10)
    with pytest.raises(ValueError, match="2 <= t <= d"):
        build_scheme("subset", d=4, d_a=2, t=9)
    with pytest.raises(ValueError, match="u >= 1"):
        build_scheme("as-sparse", d=4, d_a=2, theta=0.3)  # missing u
    with pytest.raises(ValueError, match="unknown scheme"):
        build_scheme("as-nope", d=4, d_a=2, u=3)
    with pytest.raises(ValueError, match="1 < p <= n"):
        direct.gen_queries(_gen(0), 8, 4, 12, torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="2 <= t <= d"):
        subset.choose_servers(_gen(0), 4, 1)


def test_direct_family_has_no_query_independent_half():
    sch = build_scheme("direct", d=4, d_a=2, p=8)
    assert not sch.has_precompute
    plan = sch.precompute(_gen(0), 64, 4)
    assert plan.n == 64 and plan.batch == 4  # the plan is the generator
    router = SchemeRouter(sch)
    assert router.precompute(_gen(0), 64, 4) is None
    with pytest.raises(ValueError, match="no precompute"):
        router.plan(_gen(0), 64, torch.tensor([1]), pre=object())


def test_scheme_classes_are_frozen_and_hashable():
    for name in NAMES:
        sch = build_scheme(name, d=D, d_a=D_A, **PARAMS[name])
        assert dataclasses.is_dataclass(sch)
        hash(sch)
        with pytest.raises(dataclasses.FrozenInstanceError):
            sch.d = 99


def test_anonymity_channel_mixes_and_routes_back():
    items = torch.arange(40).reshape(10, 4)
    out, perm = anonymity.mix(_gen(1), items)
    assert torch.equal(out, items[perm]) and not torch.equal(out, items)
    assert torch.equal(anonymity.unmix(out, perm), items)
    ch = anonymity.AnonymityChannel(_gen(2))
    assert torch.equal(ch.backward(ch.forward(items)), items)
    with pytest.raises(RuntimeError, match="forward"):
        anonymity.AnonymityChannel(_gen(2)).backward(items)


# ----------------------------------------------------- the laws of the draws
def test_direct_requests_follow_the_law():
    """p distinct indices a query, the real one among them exactly once at
    a uniform slot, the p−1 dummies uniform over the other n−1 records,
    p/d to each server."""
    n, d, p, b = 13, 4, 8, 20_000
    q = torch.tensor([3, 12] * (b // 2), dtype=torch.int32)
    reqs = direct.gen_queries(_gen(7), n, d, p, q)
    assert reqs.shape == (d, b, p // d) and reqs.dtype == torch.int32
    flat = reqs.permute(1, 0, 2).reshape(b, p).long()  # slot order
    srt = flat.sort(1).values
    assert bool((srt[:, 1:] != srt[:, :-1]).all())  # distinct
    assert bool(((flat >= 0) & (flat < n)).all())
    hit = flat == q.long()[:, None]
    assert bool((hit.sum(1) == 1).all())  # the real one exactly once
    # its slot is uniform over the p slots (so each server gets it d_a/d...)
    slot = hit.float().argmax(1)
    counts = torch.bincount(slot, minlength=p).double()
    sigma = math.sqrt(b * (1 / p) * (1 - 1 / p))
    assert float((counts - b / p).abs().max()) < 6 * sigma
    # each other record appears with probability (p−1)/(n−1)
    for qq in (3, 12):
        rows = flat[q == qq]
        freq = torch.stack([(rows == v).any(1).double().mean()
                            for v in range(n) if v != qq])
        want = (p - 1) / (n - 1)
        sig = math.sqrt(want * (1 - want) / rows.shape[0])
        assert float((freq - want).abs().max()) < 6 * sig


def test_subset_server_choice_is_uniform_over_t_subsets():
    d, t, trials = 5, 2, 6000
    sch = build_scheme("subset", d=d, d_a=2, t=t)
    gen = _gen(4)
    counts = {}
    for _ in range(trials):
        servers = sch.query(sch.precompute(gen, 8, 1),
                            torch.zeros(1, dtype=torch.int32)).servers
        assert len(set(servers)) == t
        key = tuple(sorted(servers))
        counts[key] = counts.get(key, 0) + 1
    assert set(counts) == set(itertools.combinations(range(d), t))
    want = trials / math.comb(d, t)
    sigma = math.sqrt(want * (1 - 1 / math.comb(d, t)))
    assert max(abs(c - want) for c in counts.values()) < 6 * sigma


def test_subset_catastrophe_frequency_matches_delta():
    """Security Thm 5: δ = Pr[every contacted server is corrupt], measured
    over the port's own server draws against Π (d_a−i)/(d−i)."""
    d, d_a, t, trials = 8, 5, 3, 6000
    gen = _gen(20160701)
    hits = sum(
        set(subset.choose_servers(gen, d, t).tolist()) <= set(range(d_a))
        for _ in range(trials))
    delta = acc.delta_subset(d, d_a, t)  # = C(5,3)/C(8,3) = 10/56
    assert hits / trials == pytest.approx(delta, rel=0.15)


def test_subset_under_pick_servers_contacts_the_fastest_t():
    """In the pipeline, Subset-PIR's servers are the backend's fastest t
    by latency EMA (unobserved replicas first), as in the reference."""
    store = make_synthetic_store(64, 8, seed=1, device="cpu")
    sch = make_scheme("subset", d=5, d_a=2, t=3)
    pipe = ServingPipeline(store, sch, device="cpu")
    for sid, ema in enumerate((0.5, 0.1, 0.4, 0.2, 0.3)):
        pipe.backend.observe_latency(sid, ema)
    assert pipe.fastest_servers(3) == [1, 3, 4]
    pipe.submit("c", 9)
    planned = pipe.plan_requests(pipe.take_batch())
    assert planned.routed.servers == (1, 3, 4)
    out = {r.client: a for r, a in pipe.execute_planned(planned)}
    assert (out["c"] == store.record_bytes(9)).all()


# ------------------------------------------------- both pipelines, same load
@pytest.mark.parametrize("name,kw", [
    ("direct", dict(p=8)), ("subset", dict(t=3)),
    ("as-sparse", dict(theta=0.25, u=16)), ("as-direct", dict(p=8, u=16)),
])
def test_same_submissions_through_both_pipelines(name, kw):
    n, rb = 256, 16
    rstore, tstore = _stores(n, rb, seed=2)
    rsch = ref_make_scheme(name, d=D, d_a=D_A, **kw)
    tsch = make_scheme(name, d=D, d_a=D_A, **kw)
    rpipe = RefPipeline(rstore, rsch, seed=1)
    tpipe = ServingPipeline(tstore, tsch, seed=1, device="cpu")
    rng = np.random.default_rng(0)
    asked = {f"c{c}": int(i) for c, i in enumerate(rng.integers(0, n, 11))}
    for client, i in asked.items():
        assert rpipe.submit(client, i) and tpipe.submit(client, i)
    rout, tout = rpipe.flush(), tpipe.flush()
    for client, i in asked.items():
        np.testing.assert_array_equal(tout[client], rout[client])
        np.testing.assert_array_equal(tout[client], tstore.record_bytes(i))
    for key in ("queries", "batches", "padded", "records_touched",
                "blocks_sent", "epsilon_per_query", "delta_per_query"):
        assert tpipe.metrics[key] == pytest.approx(rpipe.metrics[key],
                                                   rel=1e-12)
    assert tpipe.backend.path_counts == rpipe.backend.path_counts


def test_direct_on_a_live_store_answers_its_pinned_snapshot():
    """The index path answers against a batch's pinned snapshot even
    after a later write, as the mask path does."""
    from repro_torch.db import Delta, VersionedStore

    base = make_synthetic_store(64, 8, seed=4, device="cpu")
    live = VersionedStore(base)
    pipe = ServingPipeline(live, make_scheme("direct", d=2, d_a=1, p=4),
                           backend=ShardedBackend(base, device="cpu"),
                           device="cpu")
    pipe.submit("c", 9)
    planned = pipe.plan_requests(pipe.take_batch())
    before = base.record_bytes(9)
    pipe.ingest(Delta.update([9], np.full((1, 8), 7, np.uint8)))
    out = {r.client: a for r, a in pipe.execute_planned(planned)}
    np.testing.assert_array_equal(out["c"], before)
    pipe.submit("c", 9)
    assert (pipe.flush()["c"] == 7).all()


# --------------------------------------------- empirical ε of routed bits
def _empirical_epsilon(fn, trials=20_000):
    res = adv.run_game(fn, 20260730, trials=trials, device="cpu")
    lr = max(res.max_lr(min_count=50),
             adv.GameResult(res.counts_j, res.counts_i, res.trials).max_lr(50))
    return math.log(lr) if lr > 0 else 0.0


def _observe_routed_direct(n, d, d_a, p, q_i, q_j):
    router = SchemeRouter(make_scheme("direct", d=d, d_a=d_a, p=p))

    def fn(gen, rounds, hyp):
        q = torch.full((rounds,), q_i if hyp == 0 else q_j, dtype=torch.int32)
        obs = router.plan(gen, n, q).payload[:d_a].permute(1, 0, 2).reshape(
            rounds, -1)
        return (2 * (obs == q_i).any(1).long() + (obs == q_j).any(1).long())

    return fn


@pytest.mark.parametrize("n,d,d_a,p", [(32, 4, 2, 8), (32, 4, 3, 16)])
def test_direct_empirical_eps_meets_bound(n, d, d_a, p):
    bound = make_scheme("direct", d=d, d_a=d_a, p=p).epsilon(n)
    emp = _empirical_epsilon(_observe_routed_direct(n, d, d_a, p, 2, 20))
    assert emp <= bound + 0.35, (emp, bound)
    assert emp >= 0.35 * bound, (emp, bound)
