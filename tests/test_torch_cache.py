"""Port vs reference: the cross-batch cache (``QueryCache``) and the
cached halves of the serving pipeline.

The precompute/assemble split is bit-identical to inline planning; the
per-(client, index) memo enforces its structural privacy rule (no reuse
across distinct client queries); a cache hit spends (ε, δ) exactly like a
miss, so exhausted clients are refused even when their answer is cached;
the refusal memo never spends and never goes stale; the pre pool is
single-use and bounded (by depth, and by bytes where asked); a live
store's ingest evicts exactly the touched indices. Each case mirrors one
of the reference's (``tests/test_serve_cache.py`` and the cached cases of
``tests/test_statistical_privacy.py``); where both packages can run the
same traffic they do, and their answers and counters are compared."""

import threading

import jax
import numpy as np
import pytest
import torch

from repro.core import make_scheme as ref_make_scheme
from repro.db import make_synthetic_store as ref_make_store
from repro.serve import QueryCache as RefCache
from repro.serve import ServingPipeline as RefPipeline
from repro.serve import scheme_signature as ref_signature
from repro_torch.core import make_scheme
from repro_torch.core.accounting import PrivacyBudget
from repro_torch.db import Delta, VersionedStore, make_synthetic_store
from repro_torch.serve import (
    BatchScheduler,
    QueryCache,
    SchemeRouter,
    ServingPipeline,
    ShardedBackend,
    scheme_signature,
)
from repro_torch.serve.cache import block_pre_ready, pre_nbytes


def _store(n, rb, seed=0):
    return make_synthetic_store(n, rb, seed=seed, device="cpu")


def _pipe(store, sch, **kw):
    if "backend" not in kw:
        kw["backend"] = ShardedBackend(store, device="cpu")
    return ServingPipeline(store, sch, device="cpu", **kw)


def _gen(seed):
    return torch.Generator(device="cpu").manual_seed(seed)


# ------------------------------------------------ precompute/assemble split
@pytest.mark.parametrize("name,kw", [
    ("chor", {}),
    ("sparse", dict(theta=0.3)),
    ("as-sparse", dict(theta=0.3, u=16)),
    ("subset", dict(t=3)),
])
def test_plan_from_pre_bit_identical(name, kw):
    router = SchemeRouter(make_scheme(name, d=4, d_a=2, **kw))
    q = torch.tensor([3, 9, 1, 7], dtype=torch.int32)
    inline = router.plan(_gen(11), 64, q)
    gen = _gen(11)
    from_pre = router.plan(gen, 64, q, pre=router.precompute(gen, 64, 4))
    assert torch.equal(inline.payload, from_pre.payload)
    assert inline.servers == from_pre.servers


def test_direct_has_no_precompute_half():
    router = SchemeRouter(make_scheme("direct", d=4, d_a=2, p=8))
    assert router.precompute(_gen(0), 64, 4) is None
    with pytest.raises(ValueError, match="no precompute"):
        router.plan(_gen(0), 64, torch.tensor([1]), pre=object())


def test_pre_wrong_store_size_rejected():
    router = SchemeRouter(make_scheme("chor", d=3, d_a=1))
    pre = router.precompute(_gen(1), 64, 2)
    with pytest.raises(ValueError, match="pre built for n=64"):
        router.plan(_gen(1), 128, torch.tensor([1, 2]), pre=pre)


# ---------------------------------------------------------- the memo (L1)
def test_memo_key_is_client_and_index():
    sch = make_scheme("sparse", d=4, d_a=2, theta=0.25)
    cache = QueryCache(sch, 128)
    cols = np.ones((4, 128), np.uint8)
    cache.insert("alice", 7, answer=np.arange(4, dtype=np.uint8),
                 query_cols=cols)
    hit = cache.lookup("alice", 7)
    assert hit is not None and hit.query_cols is cols  # bit-identical replay
    assert cache.lookup("bob", 7) is None
    assert cache.lookup("alice", 8) is None
    assert cache.metrics == {**cache.metrics, "hits": 1, "misses": 2}
    # the counter set is the reference's
    assert set(cache.metrics) == set(RefCache(
        ref_make_scheme("sparse", d=4, d_a=2, theta=0.25), 128).metrics)


def test_memo_lru_eviction_and_query_vector_cap():
    sch = make_scheme("chor", d=2, d_a=1)
    cache = QueryCache(sch, 64, max_entries=2, max_query_vector_bytes=8)
    big = np.zeros((2, 64), np.uint8)  # 128 B > cap -> dropped
    cache.insert("a", 1, answer=np.zeros(4, np.uint8), query_cols=big)
    assert cache.lookup("a", 1).query_cols is None
    cache.insert("b", 2, answer=np.zeros(4, np.uint8))
    cache.lookup("a", 1)  # touch: "a" is now most recent
    cache.insert("c", 3, answer=np.zeros(4, np.uint8))  # evicts "b"
    assert cache.lookup("b", 2) is None
    assert cache.lookup("a", 1) is not None
    assert cache.metrics["evictions"] == 1
    assert len(cache) == 2
    with pytest.raises(ValueError, match="max_entries"):
        QueryCache(sch, 64, max_entries=-1)
    none = QueryCache(sch, 64, max_entries=0)
    none.insert("a", 1, answer=np.zeros(4, np.uint8))
    assert len(none) == 0


def test_pre_pool_is_single_use_and_bounded():
    sch = make_scheme("chor", d=2, d_a=1)
    cache = QueryCache(sch, 64, max_pre_batches=2)
    assert cache.take_pre(8) is None
    assert cache.put_pre(8, "pre0") and cache.put_pre(8, "pre1")
    assert not cache.put_pre(8, "pre2")
    assert cache.pre_depth(8) == 2
    assert cache.take_pre(8) == "pre0"
    assert cache.take_pre(8) == "pre1"
    assert cache.take_pre(8) is None
    assert cache.metrics["pre_dropped"] == 1
    cache.put_pre(8, "pre3")
    cache.invalidate()
    assert cache.pre_depth(8) == 0 and len(cache) == 0


def test_pre_pool_reports_the_plans_bytes_under_its_depth_bound():
    """The pooled plans hold device memory (a Sparse-PIR plan is
    B·n + B + 16 bytes): the pool is bounded by ``max_pre_batches`` per
    bucket, as in the reference, and ``pre_bytes`` reports what the
    banked plans hold; a popped plan gives its bytes back."""
    sch = make_scheme("sparse", d=4, d_a=2, theta=0.25)
    router = SchemeRouter(sch)
    pre = router.precompute(_gen(0), 64, 8)
    nbytes = pre_nbytes(pre)
    assert nbytes == 8 * 64 + 8 + 16  # even weights, w_q, the Philox key
    small = router.precompute(_gen(1), 64, 4)
    assert pre_nbytes(small) == 4 * 64 + 4 + 16
    cache = QueryCache(sch, 64, max_pre_batches=1)
    assert block_pre_ready(pre) is pre
    assert cache.put_pre(8, pre) and cache.pre_bytes == nbytes
    assert not cache.put_pre(8, pre)  # over the depth: dropped
    assert cache.metrics["pre_dropped"] == 1 and cache.pre_bytes == nbytes
    assert cache.put_pre(4, small)  # another bucket has its own depth
    assert cache.pre_bytes == nbytes + pre_nbytes(small)
    assert cache.take_pre(8) is pre
    assert cache.pre_bytes == pre_nbytes(small)
    assert cache.take_pre(4) is small and cache.pre_bytes == 0
    with pytest.raises(ValueError, match="banked under bucket"):
        cache.put_pre(4, pre)
    cache.put_pre(8, pre)
    cache.invalidate()
    assert cache.pre_bytes == 0


def test_pipeline_rejects_mismatched_cache():
    store = _store(64, 8)
    sch = make_scheme("chor", d=2, d_a=1)
    other = QueryCache(make_scheme("chor", d=3, d_a=1), store.n)
    with pytest.raises(ValueError, match="cache built for"):
        ServingPipeline(store, sch, cache=other, device="cpu")
    assert scheme_signature(sch, store.n) != other.signature
    assert scheme_signature(sch, store.n) == ref_signature(
        ref_make_scheme("chor", d=2, d_a=1), store.n)


# --------------------------------------------- budget-aware serving (ε, δ)
def test_cache_hit_spends_budget_identically_to_miss():
    """Admission charges before the cache is consulted: two identical
    queries cost 2ε though the second touches no server, and the third is
    refused although its answer sits in the cache — as in the reference,
    run beside it on the same traffic."""
    store = _store(128, 16, seed=1)
    rstore = ref_make_store(128, 16, seed=1)
    sch = make_scheme("sparse", d=4, d_a=2, theta=0.25)
    rsch = ref_make_scheme("sparse", d=4, d_a=2, theta=0.25)
    eps = sch.epsilon(store.n)
    assert eps == rsch.epsilon(store.n)
    pipe = _pipe(store, sch, cache=QueryCache(sch, store.n),
                 default_budget=lambda: PrivacyBudget(epsilon_limit=2.5 * eps))
    rpipe = RefPipeline(rstore, rsch, cache=RefCache(rsch, rstore.n),
                        default_budget=lambda: PrivacyBudget(
                            epsilon_limit=2.5 * eps))
    for p in (pipe, rpipe):
        assert p.submit("c", 7)
    out1 = pipe.flush()
    rpipe.flush()
    assert pipe.budget("c").spent_epsilon == pytest.approx(eps)
    for p in (pipe, rpipe):
        assert p.submit("c", 7)
    out2, rout2 = pipe.flush(), rpipe.flush()
    assert pipe.budget("c").spent_epsilon == pytest.approx(2 * eps)
    assert pipe.metrics["cache_hits"] == rpipe.metrics["cache_hits"] == 1
    np.testing.assert_array_equal(out1["c"], out2["c"])
    np.testing.assert_array_equal(out2["c"], store.record_bytes(7))
    np.testing.assert_array_equal(out2["c"], rout2["c"])
    # exhausted: refused although the answer is cached
    assert not pipe.submit("c", 7) and not rpipe.submit("c", 7)
    assert pipe.metrics["refused"] == rpipe.metrics["refused"] == 1
    assert pipe.submit("other", 7)
    assert pipe.cache.metrics["hits"] == rpipe.cache.metrics["hits"]


def test_cache_hit_touches_no_server():
    store = _store(128, 16, seed=2)
    sch = make_scheme("sparse", d=4, d_a=2, theta=0.3)
    pipe = _pipe(store, sch, cache=QueryCache(sch, store.n))
    pipe.submit("c", 42)
    pipe.flush()
    batches = pipe.metrics["batches"]
    touched = pipe.metrics["records_touched"]
    paths = dict(pipe.backend.path_counts)
    pipe.submit("c", 42)
    out = pipe.flush()  # a pure hit: no routing, no backend, no padding
    np.testing.assert_array_equal(out["c"], store.record_bytes(42))
    assert pipe.metrics["batches"] == batches
    assert pipe.metrics["records_touched"] == touched
    assert pipe.backend.path_counts == paths
    assert pipe.metrics["cache_hits"] == 1


@pytest.mark.parametrize("name,kw,shape", [
    ("chor", {}, (3, 64)),
    ("direct", dict(p=6), (3, 2)),
])
def test_memoized_query_cols_match_wire_payload(name, kw, shape):
    """The memo stores the exact per-server columns that went on the wire:
    a Chor column's masks XOR to one-hot(index); a direct column holds the
    index once among p distinct requests."""
    store = _store(64, 8, seed=3)
    sch = make_scheme(name, d=3, d_a=1, **kw)
    cache = QueryCache(sch, store.n)
    pipe = _pipe(store, sch, cache=cache, seed=9)
    pipe.submit("u", 13)
    pipe.flush()
    entry = cache.lookup("u", 13)
    assert entry is not None and entry.query_cols is not None
    cols = entry.query_cols
    assert cols.shape == shape
    if name == "chor":
        folded = np.bitwise_xor.reduce(cols % 2, axis=0)
        expect = np.zeros(store.n, np.uint8)
        expect[13] = 1
        np.testing.assert_array_equal(folded, expect)
    else:
        assert (cols == 13).sum() == 1 and len(np.unique(cols)) == cols.size


def test_prefill_then_serve_consumes_pre_and_is_exact():
    store = _store(256, 16, seed=4)
    sch = make_scheme("sparse", d=4, d_a=2, theta=0.25)
    cache = QueryCache(sch, store.n)
    pipe = _pipe(store, sch, cache=cache,
                 scheduler=BatchScheduler(max_batch=8))
    assert pipe.prefill_cache(4) == 1
    assert cache.pre_depth(4) == 1
    for i, q in enumerate((3, 99, 200)):
        pipe.submit(f"c{i}", q)
    out = pipe.flush()  # 3 misses pad to bucket 4 -> consumes the pre
    assert cache.metrics["pre_used"] == 1 and cache.pre_depth(4) == 0
    for i, q in enumerate((3, 99, 200)):
        np.testing.assert_array_equal(out[f"c{i}"], store.record_bytes(q))
    # the default bucket is the adaptive target's
    assert pipe.prefill_cache() == 1
    assert cache.pre_depth(pipe.scheduler.padded_size(
        pipe.scheduler.target_batch)) == 1


def test_prefilled_pre_gives_the_inline_wire_bits():
    """Banked randomness is the same draw inline planning would make from
    the same generator state: two pipelines of one seed, one prefilled,
    send the same bits."""
    store = _store(128, 16, seed=5)
    sch = make_scheme("sparse", d=4, d_a=2, theta=0.25)
    a = _pipe(store, sch, cache=QueryCache(sch, store.n), seed=4)
    b = _pipe(store, sch, cache=QueryCache(sch, store.n), seed=4)
    assert a.prefill_cache(2) == 1
    payloads = []
    for pipe in (a, b):
        pipe.submit("x", 5)
        pipe.submit("y", 77)
        payloads.append(pipe.plan_requests(pipe.take_batch()).routed.payload)
    assert torch.equal(payloads[0], payloads[1])


# ------------------------------------------- refusal memo (negative L1)
def _counting_budget(budget):
    calls = {"n": 0}
    orig = budget.can_spend

    def counted(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    budget.can_spend = counted
    return calls


def test_refusal_memo_skips_accountant_and_never_spends():
    store = _store(64, 8, seed=7)
    sch = make_scheme("sparse", d=4, d_a=2, theta=0.25)
    eps = sch.epsilon(store.n)
    pipe = _pipe(store, sch, cache=QueryCache(sch, store.n),
                 default_budget=lambda: PrivacyBudget(epsilon_limit=1.5 * eps))
    assert pipe.submit("c", 1)
    calls = _counting_budget(pipe.budget("c"))
    assert not pipe.submit("c", 2)  # consults the accountant, memoizes
    assert calls["n"] == 1
    for i in range(5):
        assert not pipe.submit("c", 3 + i)  # the memo: accountant untouched
    assert calls["n"] == 1
    assert pipe.metrics["refused"] == 6
    assert pipe.cache.metrics["refusal_hits"] == 5
    assert pipe.cache.metrics["refusals_noted"] == 1
    assert pipe.budget("c").spent_epsilon == pytest.approx(eps)
    assert pipe.submit("other", 1)
    pipe.cache.invalidate()
    assert not pipe.submit("c", 9)
    assert calls["n"] == 2
    assert pipe.budget("c").spent_epsilon == pytest.approx(eps)


def test_refusals_without_cache_recheck_every_time():
    store = _store(64, 8, seed=8)
    sch = make_scheme("chor", d=2, d_a=1)
    pipe = _pipe(store, sch, default_budget=lambda: PrivacyBudget(
        epsilon_limit=0.0, delta_limit=0.0))
    pipe.budget("c").spent_epsilon = 1.0
    pipe._eps_per_query = 0.5
    calls = _counting_budget(pipe.budget("c"))
    for _ in range(3):
        assert not pipe.submit("c", 1)
    assert calls["n"] == 3
    assert pipe.metrics["refused"] == 3


def test_refusal_memo_bounded():
    cache = QueryCache(make_scheme("chor", d=2, d_a=1), 64,
                       max_refusal_entries=2)
    tok = (1.0, 0.0, 1.0, 0.0)
    for c in ("a", "b", "c"):
        cache.note_refusal(c, tok)
    assert not cache.refused("a", tok)
    assert cache.refused("b", tok) and cache.refused("c", tok)
    assert not cache.refused("b", (2.0, 0.0, 1.0, 0.0))


def test_refusal_memo_never_stale_on_topup_or_cache_reuse():
    store = _store(64, 8, seed=9)
    sch = make_scheme("sparse", d=4, d_a=2, theta=0.25)
    eps = sch.epsilon(store.n)
    cache = QueryCache(sch, store.n)
    pipe = _pipe(store, sch, cache=cache,
                 default_budget=lambda: PrivacyBudget(epsilon_limit=0.5 * eps))
    assert not pipe.submit("c", 1)
    assert not pipe.submit("c", 1)
    assert cache.metrics["refusal_hits"] == 1
    pipe.budget("c").epsilon_limit = 1.5 * eps
    assert pipe.submit("c", 1)
    assert pipe.budget("c").spent_epsilon == pytest.approx(eps)
    pipe2 = _pipe(store, sch, cache=cache)  # infinite default budgets
    assert not pipe.submit("c", 2)
    assert pipe2.submit("c", 2)


def test_refusal_memo_eviction_order_is_lru():
    cache = QueryCache(make_scheme("chor", d=2, d_a=1), 64,
                       max_refusal_entries=3)
    tok = (1.0, 0.0, 1.0, 0.0)
    for c in ("a", "b", "c"):
        cache.note_refusal(c, tok)
    assert cache.refused("a", tok)
    cache.note_refusal("d", tok)  # evicts b (LRU), not a (FIFO)
    assert not cache.refused("b", tok)
    assert cache.refused("a", tok) and cache.refused("c", tok)
    assert cache.refused("d", tok)
    cache.note_refusal("e", tok)
    assert not cache.refused("a", tok)
    assert all(cache.refused(c, tok) for c in ("c", "d", "e"))


def test_invalidate_clears_refusal_memo_under_churn():
    cache = QueryCache(make_scheme("chor", d=2, d_a=1), 64, max_entries=8,
                       max_refusal_entries=8)
    tok = (1.0, 0.0, 1.0, 0.0)
    clients = [f"c{i}" for i in range(40)]
    for i, c in enumerate(clients):
        cache.note_refusal(c, tok)
        cache.insert(c, i % 64, answer=np.zeros(4, np.uint8))
    assert sum(cache.refused(c, tok) for c in clients) == 8
    cache.invalidate()
    assert len(cache) == 0
    assert not any(cache.refused(c, tok) for c in clients)
    cache.note_refusal("fresh", tok)
    assert cache.refused("fresh", tok)


def test_prefill_respects_pool_cap_and_direct_fallback():
    store = _store(64, 8, seed=5)
    sch = make_scheme("chor", d=2, d_a=1)
    pipe = _pipe(store, sch, cache=QueryCache(sch, store.n,
                                              max_pre_batches=1))
    assert pipe.prefill_cache(4) == 1
    assert pipe.prefill_cache(4) == 0
    assert _pipe(store, sch).prefill_cache(4) == 0  # no cache
    sch_d = make_scheme("direct", d=2, d_a=1, p=8)
    pipe_d = _pipe(store, sch_d, cache=QueryCache(sch_d, store.n))
    assert pipe_d.prefill_cache(4) == 0
    pipe_d.submit("c", 5)
    np.testing.assert_array_equal(pipe_d.flush()["c"], store.record_bytes(5))


def test_metrics_exact_under_threaded_hammer():
    cache = QueryCache(make_scheme("chor", d=2, d_a=1), 64,
                       max_entries=100_000, max_refusal_entries=100_000)
    T, I = 8, 300
    start = threading.Barrier(T)

    def hammer(t):
        start.wait()
        for i in range(I):
            client = f"t{t}-{i}"
            cache.insert(client, 0, answer=np.zeros(4, np.uint8))
            assert cache.lookup(client, 0) is not None
            assert cache.lookup(client, 1) is None
            tok = (1.0, 0.0, 1.0, 0.0)
            cache.note_refusal(client, tok)
            assert cache.refused(client, tok)

    threads = [threading.Thread(target=hammer, args=(t,)) for t in range(T)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60.0)
    assert not any(th.is_alive() for th in threads)
    m = cache.metrics
    for key in ("hits", "misses", "insertions", "refusals_noted",
                "refusal_hits"):
        assert m[key] == T * I
    assert m["evictions"] == 0


# -------------------------------------------------- versions (live stores)
def test_ingest_evicts_exactly_the_touched_indices():
    """An update evicts the entries of the indices it wrote and keeps the
    rest (bit-exact hits across the ingest, still priced); an entry an
    in-flight batch inserts for a written index after the ingest is
    refused; an append re-signs the cache and drops its pool and memo —
    the reference's rules, on the same traffic in both packages."""
    from repro.db import Delta as RefDelta
    from repro.db import VersionedStore as RefVersioned

    def run(pkg):
        if pkg == "torch":
            live = VersionedStore(_store(64, 8, seed=6))
            sch = make_scheme("chor", d=2, d_a=1)
            pipe = _pipe(live, sch, cache=QueryCache(sch, 64),
                         backend=ShardedBackend(live.snapshot(), device="cpu"))
            delta = Delta
        else:
            live = RefVersioned(ref_make_store(64, 8, seed=6))
            sch = ref_make_scheme("chor", d=2, d_a=1)
            pipe = RefPipeline(live, sch, cache=RefCache(sch, 64))
            delta = RefDelta
        for i in (3, 5, 9):
            pipe.submit("c", i)
            pipe.flush()
        pipe.submit("c", 5)
        planned = pipe.plan_requests(pipe.take_batch())
        pipe.submit("c", 3)
        inflight = pipe.plan_requests(pipe.take_batch())
        pipe.execute_planned(planned)
        evicted = pipe.cache.metrics["stale_evictions"]
        pipe.ingest(delta.update([3, 9], np.full((2, 8), 1, np.uint8)))
        after_update = dict(pipe.cache.metrics), len(pipe.cache)
        pipe.execute_planned(inflight)  # a miss planned before the ingest
        assert pipe.cache.lookup("c", 3) is None  # stale: refused
        out = {}
        for i in (3, 5, 9):
            pipe.submit("c", i)
            out[i] = pipe.flush()["c"]
        randomness = _gen(0) if pkg == "torch" else jax.random.key(0)
        pipe.cache.put_pre(4, pipe.router.precompute(randomness, 64, 4))
        pipe.cache.note_refusal("z", (1.0,))
        pipe.ingest(delta.append(np.zeros((4, 8), np.uint8)))
        return (evicted, after_update, out, pipe.cache.pre_depth(4),
                pipe.cache.refused("z", (1.0,)), pipe.cache.signature,
                dict(pipe.cache.metrics), pipe.metrics["cache_hits"])

    mine, theirs = run("torch"), run("jax")
    assert mine[0] == theirs[0] == 0
    assert mine[1] == theirs[1]
    assert mine[1][0]["stale_evictions"] == 2 and mine[1][1] == 1
    for i in (3, 5, 9):
        np.testing.assert_array_equal(mine[2][i], theirs[2][i])
    assert (mine[2][3] == 1).all() and (mine[2][9] == 1).all()
    assert mine[3] == theirs[3] == 0 and mine[4] is theirs[4] is False
    assert mine[5] == theirs[5] and mine[5][-1] == 68
    assert mine[6] == theirs[6] and mine[7] == theirs[7]


# ------------------------------------------------ what the adversary sees
def test_cache_replay_leaks_nothing_beyond_first_query():
    """k repeats of one (client, index) through a cached pipeline emit no
    wire bits (checked on the backend the servers run), so the adversary's
    whole view is the first query's, yet all k+1 are priced."""
    n, k_replays = 64, 3
    store = _store(n, 16, seed=6)
    sch = make_scheme("sparse", d=4, d_a=2, theta=0.3)
    pipe = _pipe(store, sch, cache=QueryCache(sch, store.n),
                 scheduler=BatchScheduler(max_batch=8))
    wire = []
    orig = pipe.backend.answer_batch
    pipe.backend.answer_batch = lambda routed, **kw: (
        wire.append(routed.payload), orig(routed, **kw))[1]
    for _ in range(1 + k_replays):
        assert pipe.submit("monitor", 11)
        pipe.flush()
    assert len(wire) == 1
    assert pipe.metrics["cache_hits"] == k_replays
    assert pipe.budget("monitor").spent_epsilon == pytest.approx(
        (1 + k_replays) * sch.epsilon(n))


def test_multi_cache_replay_leaks_nothing_beyond_first_request():
    """The multi-index form: replays of one (client, [i1..ik]) request
    resolve from the memo per index, emit no wire bits, and are charged
    k·ε each; a partly cached request sends only its missing indices."""
    store = _store(64, 16, seed=7)
    sch = make_scheme("sparse", d=4, d_a=2, theta=0.3)
    pipe = _pipe(store, sch, cache=QueryCache(sch, store.n),
                 scheduler=BatchScheduler(max_batch=8))
    wire = []
    orig = pipe.backend.answer_batch
    pipe.backend.answer_batch = lambda routed, **kw: (
        wire.append(routed), orig(routed, **kw))[1]
    ids, replays = [3, 17, 40], 2
    for _ in range(1 + replays):
        assert pipe.submit_many("m", ids)
        out = pipe.flush()["m"]
        np.testing.assert_array_equal(
            out, np.stack([store.record_bytes(i) for i in ids]))
    assert len(wire) == 1
    assert pipe.metrics["cache_hits"] == replays * len(ids)
    assert pipe.budget("m").spent_epsilon == pytest.approx(
        (1 + replays) * len(ids) * sch.epsilon(store.n))
    assert pipe.submit_many("m", [17, 50])
    out = pipe.flush()["m"]
    np.testing.assert_array_equal(
        out, np.stack([store.record_bytes(17), store.record_bytes(50)]))
    assert len(wire) == 2 and wire[-1].total == 1


def test_cache_entries_default_attaches_the_cache_on_the_config_path():
    """``make_serving_pipeline`` attaches ``QueryCache(scheme, n,
    max_entries=cfg.cache_entries)``, so a repeat poll of the CT config's
    pipeline is a hit — every scheme of the registry."""
    import dataclasses

    from repro_torch.configs import pir_ct

    for name in ("sparse", "chor", "direct", "subset", "as-sparse",
                 "as-direct"):
        cfg = dataclasses.replace(pir_ct.reduced(), scheme=name, t=3)
        pipe = pir_ct.make_serving_pipeline(cfg, device="cpu")
        assert pipe.cache.max_entries == cfg.cache_entries
        for _ in range(2):
            assert pipe.submit("c", 33)
            assert (pipe.flush()["c"] == pipe.store.record_bytes(33)).all()
        assert pipe.metrics["cache_hits"] == 1, name
        assert pipe.budget("c").spent_epsilon == pytest.approx(
            2 * pipe.price[0])
