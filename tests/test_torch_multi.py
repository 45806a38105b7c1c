"""Port vs reference: jagged multi-index requests — the wire layout
(``multi_*``, ``MultiQueries``), the ``fused_multi_gather_fold`` kernel's
plain version against the reference's TPU kernel in interpret mode, the
planner's multi decisions, and ``submit_many`` through the pipeline
(tolerance zero on words and bytes).

Wire payloads made by the reference's router are carried across through
``convert`` and answered by both packages. The port runs on the CPU here
because the tests say ``device="cpu"``."""

import dataclasses
import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_scheme as ref_make_scheme
from repro.core import protocol as ref_protocol
from repro.db import make_synthetic_store as ref_make_store
from repro.kernels import AutotuneTable as RefTable
from repro.kernels import KernelPlanner as RefPlanner
from repro.kernels import backend as ref_backend
from repro.kernels import fused_multi_gather_fold as ref_fused_multi
from repro.kernels import jagged_row_mask as ref_jagged_row_mask
from repro.kernels import ref as ref_oracles
from repro.serve import BatchScheduler as RefScheduler
from repro.serve import SchemeRouter as RefRouter
from repro.serve import ShardedBackend as RefBackend
from repro.serve import ServingPipeline as RefPipeline
from repro_torch import convert
from repro_torch.core import make_scheme, protocol
from repro_torch.core.accounting import PrivacyBudget
from repro_torch.db import make_synthetic_store
from repro_torch.kernels import KernelPlanner
from repro_torch.kernels.backend import _path_answer_fn
from repro_torch.kernels.fused import (
    fused_gather_fold,
    fused_multi_gather_fold,
    fused_multi_gather_fold_plain,
    jagged_row_mask,
)
from repro_torch.kernels.gather_xor import gather_xor, indices_from_mask
from repro_torch.serve import (
    BatchScheduler,
    SchemeRouter,
    ServingPipeline,
    ShardedBackend,
)

from _torch_parity import seeded_mask, words_t2n

D, D_A = 4, 2
JAGGED = [[3, 77, 5], [12], [], [90, 1, 0, 44, 63]]


def _both_stores(n, rb, seed):
    rstore = ref_make_store(n, rb, seed=seed)
    tstore = convert.store_from_numpy(
        np.asarray(rstore.packed), rstore.record_bits, device="cpu")
    return rstore, tstore


# --------------------------------------------------------------------------
# The wire layout
# --------------------------------------------------------------------------
LAYOUT_SWEEP = [
    [[1]], [[1, 2, 3]], [[]], [[], [], []], [[4], [5], [6]],
    [[1, 2], [3, 4]], JAGGED, [[7] * 9, [1]], [list(range(16))] * 3,
    [[i] * (i % 5) for i in range(11)],
]


@pytest.mark.parametrize("lists", LAYOUT_SWEEP)
def test_multi_layout_equals_the_reference(lists):
    np.testing.assert_array_equal(protocol.jagged_offsets(lists),
                                  ref_protocol.jagged_offsets(lists))
    assert protocol.multi_bucket(lists) == ref_protocol.multi_bucket(lists)
    q, off, k_max, req = protocol.multi_pad(lists, device="cpu")
    rq, roff, rk, rreq = ref_protocol.multi_pad(lists)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(off, roff)
    assert (k_max, req) == (rk, rreq)
    assert q.dtype == torch.int32 and off.dtype == np.int32


@pytest.mark.parametrize("name,kw", [("chor", {}), ("sparse", dict(theta=0.3))])
def test_multi_privacy_equals_the_reference(name, kw):
    sch = make_scheme(name, d=D, d_a=D_A, **kw).staged
    rsch = ref_make_scheme(name, d=D, d_a=D_A, **kw).staged
    for n, k in itertools.product((64, 1000), (0, 1, 3, 8)):
        assert protocol.multi_privacy(sch, n, k) == pytest.approx(
            ref_protocol.multi_privacy(rsch, n, k), rel=0, abs=0)
    with pytest.raises(ValueError, match="k >= 0"):
        protocol.multi_privacy(sch, 64, -1)


def test_multi_query_stage_validates_and_delegates():
    sch = make_scheme("sparse", d=D, d_a=D_A, theta=0.3).staged
    gen = torch.Generator().manual_seed(4)
    bucket = protocol.multi_bucket(JAGGED)
    assert bucket == 4 * 8
    mq = protocol.multi_query(sch, sch.precompute(gen, 128, bucket), JAGGED,
                              device="cpu")
    assert isinstance(mq, protocol.MultiQueries)
    assert mq.requests == 4 and mq.k_max == 8 and mq.total == 9
    assert mq.kind == "mask" and mq.servers == mq.queries.servers
    assert mq.theta == 0.3 and mq.store_version is None
    assert int(mq.payload.shape[1]) == bucket
    with pytest.raises(ValueError, match="flat multi bucket"):
        protocol.multi_query(sch, sch.precompute(gen, 128, 4), JAGGED,
                             device="cpu")
    with pytest.raises(TypeError, match="MultiQueries"):
        protocol.multi_reconstruct(sch, protocol.Answers(
            queries=mq.queries, responses=torch.zeros((4, bucket, 2))))


@pytest.mark.parametrize("name,kw", [("chor", {}), ("sparse", dict(theta=0.3))])
def test_staged_retrieve_many_equals_a_per_index_loop(name, kw):
    store = make_synthetic_store(128, 20, seed=5, device="cpu")
    sch = make_scheme(name, d=D, d_a=D_A, **kw).staged
    many = protocol.staged_retrieve_many(
        sch, torch.Generator().manual_seed(21), store, JAGGED)
    assert len(many) == len(JAGGED)
    loop_gen = torch.Generator().manual_seed(22)
    for lst, got in zip(JAGGED, many):
        assert tuple(got.shape) == (len(lst), store.words)
        for i, q in enumerate(lst):
            one = protocol.staged_retrieve(
                sch, loop_gen, store, torch.tensor([q], dtype=torch.int32))
            assert torch.equal(got[i], one[0])
            assert torch.equal(got[i], store.packed[q])
    assert protocol.staged_retrieve_many(sch, loop_gen, store, []) == []


# --------------------------------------------------------------------------
# fused_multi_gather_fold: the plain version against the TPU kernel
# --------------------------------------------------------------------------
JAGGED_CASES = [
    # (counts per request, k_max)
    ((5,), 8),
    ((1, 1, 1, 1, 1, 1, 1, 1), 1),
    ((3, 0, 8, 1), 8),
    ((2, 2), 2),
    ((0, 4, 1), 4),
    ((2, 0, 1, 2), 2),
]


def _jagged_case(n, rb, counts, k_max, seed=0, garbage=False):
    """The reference's own sweep input: random per-index sparse rows on
    the padded multi grid; dead rows hold -1, or, with ``garbage``,
    live-looking indices the jagged mask must suppress."""
    rstore, tstore = _both_stores(n, rb, seed)
    rng = np.random.default_rng(seed + 7)
    m = min(n, 24)
    idx = np.full((len(counts) * k_max, m), -1, np.int32)
    for r, c in enumerate(counts):
        for i in range(k_max if garbage else c):
            w = int(rng.integers(1, m + 1))
            idx[r * k_max + i, :w] = rng.choice(n, size=w, replace=False)
    offsets = np.cumsum([0] + list(counts)).astype(np.int32)
    return rstore, tstore, idx, offsets


def _port_multi(tstore, idx, off, k_max, **kw):
    return words_t2n(fused_multi_gather_fold(
        tstore.packed, torch.from_numpy(idx), torch.from_numpy(off),
        k_max=k_max, **kw))


@pytest.mark.parametrize("counts,k_max", JAGGED_CASES)
@pytest.mark.parametrize("grid_order", ["rw", "wr"])
@pytest.mark.parametrize("garbage", [False, True])
def test_fused_multi_equals_the_reference_kernel(counts, k_max, grid_order,
                                                 garbage):
    rstore, tstore, idx, off = _jagged_case(100, 12, counts, k_max,
                                            seed=k_max, garbage=garbage)
    want = np.asarray(ref_fused_multi(
        rstore.packed, jnp.asarray(idx), jnp.asarray(off), k_max=k_max,
        grid_order=grid_order, interpret=True))
    got = _port_multi(tstore, idx, off, k_max, grid_order=grid_order)
    np.testing.assert_array_equal(got, want)
    live = np.asarray(ref_jagged_row_mask(jnp.asarray(off), k_max,
                                          idx.shape[0]))
    np.testing.assert_array_equal(
        jagged_row_mask(torch.from_numpy(off), k_max, idx.shape[0]).numpy(),
        live)
    np.testing.assert_array_equal(got[~live], 0)
    masked = np.where(live[:, None], idx, -1)
    np.testing.assert_array_equal(
        got, np.asarray(ref_oracles.gather_xor_ref(rstore.packed,
                                                   jnp.asarray(masked))))


@pytest.mark.parametrize("block_w", [1, 8, 32, 128])
@pytest.mark.parametrize("n,rb", [(91, 21), (37, 129), (1, 8)])
def test_fused_multi_block_sweep_nonpow2_w(block_w, n, rb):
    rstore, tstore, idx, off = _jagged_case(n, rb, (4, 0, 7), 8, seed=3)
    want = np.asarray(ref_fused_multi(
        rstore.packed, jnp.asarray(idx), jnp.asarray(off), k_max=8,
        block_w=block_w, interpret=True))
    np.testing.assert_array_equal(
        _port_multi(tstore, idx, off, 8, block_w=block_w), want)


def test_fused_multi_all_live_equals_the_flat_forms():
    rstore, tstore = _both_stores(128, 16, seed=6)
    mask = seeded_mask(8, 128, seed=6, p=0.3)
    idx = indices_from_mask(torch.from_numpy(mask), 64)
    off = torch.arange(idx.shape[0] // 4 + 1, dtype=torch.int32) * 4
    want = fused_gather_fold(tstore.packed, idx)
    assert torch.equal(want, gather_xor(tstore.packed, idx))
    for go in ("rw", "wr"):
        got = fused_multi_gather_fold(tstore.packed, idx, off, k_max=4,
                                      grid_order=go)
        assert torch.equal(got, want)
    np.testing.assert_array_equal(words_t2n(want), np.asarray(
        ref_oracles.gather_xor_ref(rstore.packed, jnp.asarray(idx.numpy()))))


def test_fused_multi_validates_layout_like_the_reference():
    _, tstore, idx, off = _jagged_case(64, 8, (2, 2), 2, seed=1)
    t_idx, t_off = torch.from_numpy(idx), torch.from_numpy(off)
    with pytest.raises(ValueError, match="grid_order"):
        fused_multi_gather_fold(tstore.packed, t_idx, t_off, k_max=2,
                                grid_order="zz")
    with pytest.raises(ValueError, match="multiple of k_max"):
        fused_multi_gather_fold(tstore.packed, t_idx, t_off, k_max=3)
    with pytest.raises(ValueError, match=r"offsets must be \[R\+1\]"):
        fused_multi_gather_fold(tstore.packed, t_idx, t_off[:-1], k_max=2)
    # numpy offsets are taken as well
    assert torch.equal(
        fused_multi_gather_fold(tstore.packed, t_idx, off, k_max=2),
        fused_multi_gather_fold_plain(tstore.packed, t_idx, t_off, 2))


# --------------------------------------------------------------------------
# The planner's multi decisions
# --------------------------------------------------------------------------
def _wire(theta):
    return types.SimpleNamespace(kind="mask", theta=theta)


@pytest.mark.parametrize("n,rb,bucket,k_max,budget", [
    (256, 16, 8, 4, None),       # slab fits: the fused multi form
    (256, 16, 8, 4, 1),          # gate shut: the streaming pair
    (2048, 64, 32, 4, None),
    (2048, 64, 32, 8, 70_000),   # narrower block
    (64, 8, 8, 2, None),         # θ·n ≈ n: dense forms, k_max ignored
])
def test_multi_plan_decisions_equal_the_reference(n, rb, bucket, k_max, budget):
    rstore, tstore = _both_stores(n, rb, seed=2)
    theta = 0.25 if n > 64 else 0.45
    rsch = ref_make_scheme("sparse", d=D, d_a=D_A, theta=theta).staged
    tsch = make_scheme("sparse", d=D, d_a=D_A, theta=theta).staged
    rplan = RefPlanner(
        rstore, backend="pallas", table=RefTable(),
        vmem_budget_bytes=budget if budget is not None else 232_448,
    ).plan(_wire(theta), bucket, None, scheme=rsch, k_max=k_max)
    planner = KernelPlanner(tstore, backend="cuda", smem_budget_bytes=budget)
    tplan = planner.plan(_wire(theta), bucket, scheme=tsch, k_max=k_max)
    assert (tplan.path, tplan.source, tplan.m_budget, tplan.blocks) == (
        rplan.path, rplan.source, rplan.m_budget, rplan.blocks)
    # k_max is part of the cell: the flat bucket plans on its own
    flat = planner.plan(_wire(theta), bucket, scheme=tsch)
    assert flat is not tplan
    assert planner.plan(_wire(theta), bucket, scheme=tsch, k_max=k_max) is tplan
    with pytest.raises(ValueError, match="multiple of k_max"):
        planner.plan(_wire(theta), bucket, scheme=tsch, k_max=3)
    planner.invalidate()
    assert planner.metrics["plans_dropped"] == 2
    assert planner.plan(_wire(theta), bucket, scheme=tsch,
                        k_max=k_max) is not tplan


def test_all_live_offsets_are_made_once_per_shape_and_device():
    """The multi executor's offsets: every row live, one tensor per
    (requests, k_max, device), handed out again rather than rebuilt."""
    from repro_torch.kernels.backend import _all_live_offsets

    off = _all_live_offsets(8, 4, torch.device("cpu"))
    assert off.dtype == torch.int32 and off.tolist() == list(range(0, 36, 4))
    assert _all_live_offsets(8, 4, torch.device("cpu")) is off
    assert _all_live_offsets(8, 2, torch.device("cpu")).tolist() == list(
        range(0, 18, 2))
    assert jagged_row_mask(off, 4, 32).all()


def test_multi_gate_falls_back_to_pair():
    store = make_synthetic_store(256, 16, seed=2, device="cpu")
    sch = make_scheme("sparse", d=D, d_a=D_A, theta=0.25).staged
    shut = KernelPlanner(store, backend="cuda", smem_budget_bytes=1).plan(
        _wire(0.25), 8, scheme=sch, k_max=4)
    assert shut.path == "sparse_pair"
    open_ = KernelPlanner(store, backend="cuda").plan(
        _wire(0.25), 8, scheme=sch, k_max=4)
    assert open_.path == "sparse_multi_fused"
    assert dict(open_.blocks)["k_max"] == 4
    mask = torch.from_numpy(seeded_mask(8, 256, seed=3, p=0.25))
    assert torch.equal(shut(mask), open_(mask))


@pytest.mark.parametrize("blocks", [
    {"block_w": 8, "grid_order": "rw", "k_max": 2},
    {"block_w": 4, "grid_order": "wr", "k_max": 4},
    {"block_w": 8, "k_max": 1},
])
@pytest.mark.parametrize("m_budget", [96, 20])
def test_multi_branch_of_the_dispatch_equals_the_reference(blocks, m_budget):
    n, rb, q = 211, 21, 8
    rstore, tstore = _both_stores(n, rb, seed=4)
    mask = seeded_mask(q, n, seed=8, p=0.3)
    rfn = ref_backend._path_answer_fn("sparse_multi_fused", "pallas", m_budget,
                                      True, dict(blocks))
    tfn = _path_answer_fn("sparse_multi_fused", "cuda", m_budget, dict(blocks))
    np.testing.assert_array_equal(
        words_t2n(tfn(tstore.packed, torch.from_numpy(mask))),
        np.asarray(rfn(rstore.packed, jnp.asarray(mask))))


# --------------------------------------------------------------------------
# The reference's jagged wire, answered by both packages
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name,kw,n,rb,budget", [
    ("sparse", dict(theta=0.25), 2048, 64, None),   # fused multi form
    ("sparse", dict(theta=0.25), 512, 24, 1),       # gate shut: the pair
    ("sparse", dict(theta=0.45), 64, 8, None),      # dense fold
    ("chor", {}, 300, 50, None),
])
@pytest.mark.parametrize("backend", ["auto", "cuda", "ref"])
def test_reference_multi_wire_answered_identically(name, kw, n, rb, budget,
                                                   backend):
    rstore, tstore = _both_stores(n, rb, seed=2)
    rsch = ref_make_scheme(name, d=D, d_a=D_A, **kw)
    rrouter = RefRouter(rsch)
    lists = [[i % n for i in lst] for lst in JAGGED]
    mq = rrouter.plan_many(jax.random.key(3), n, lists)
    rresp = RefBackend(rstore).answer_batch(mq, scheme=rsch.staged)
    want = rrouter.finalize_many(mq, rresp)

    fields = dict(
        kind=mq.kind, payload=np.asarray(mq.payload), servers=mq.servers,
        q_idx=np.asarray(mq.q_idx), offsets=np.asarray(mq.offsets),
        k_max=mq.k_max, requests=mq.requests, theta=mq.theta)
    tmq = convert.multi_queries_from_numpy(device="cpu", **fields)
    again = convert.multi_queries_to_numpy(tmq)
    for key, value in fields.items():
        np.testing.assert_array_equal(np.asarray(again[key]), np.asarray(value))

    tsch = make_scheme(name, d=D, d_a=D_A, **kw)
    tback = ShardedBackend(tstore, backend=backend, smem_budget_bytes=budget,
                           device="cpu")
    plan = tback.prepare(tmq, scheme=tsch.staged)
    tresp = tback.answer_batch(tmq, plan=plan, scheme=tsch.staged)
    np.testing.assert_array_equal(words_t2n(tresp), np.asarray(rresp))
    got = SchemeRouter(tsch).finalize_many(tmq, tresp)
    assert len(got) == len(want) == len(lists)
    packed = np.asarray(rstore.packed)
    for lst, g, w in zip(lists, got, want):
        np.testing.assert_array_equal(words_t2n(g), np.asarray(w))
        np.testing.assert_array_equal(words_t2n(g).reshape(-1, tstore.words),
                                      packed[lst].reshape(-1, tstore.words))
    if backend == "cuda" and name == "sparse" and n == 2048:
        assert plan.path == "sparse_multi_fused"
    assert tback.path_counts[plan.family] == D


def test_handed_in_multi_plan_is_replanned_when_k_max_does_not_divide():
    store = make_synthetic_store(2048, 64, seed=1, device="cpu")
    sch = make_scheme("sparse", d=D, d_a=D_A, theta=0.25)
    router = SchemeRouter(sch)
    back = ShardedBackend(store, backend="cuda", device="cpu")
    mq = router.plan_many(torch.Generator().manual_seed(0), store.n,
                          [[1, 2, 3, 4], [5]])
    plan = back.prepare(mq, scheme=sch.staged)
    assert plan.path == "sparse_multi_fused" and plan.bucket == 8
    assert back._plan_matches(plan, mq)
    wide = dataclasses.replace(
        plan, blocks=tuple(sorted({**dict(plan.blocks), "k_max": 16}.items())))
    assert not back._plan_matches(wide, mq)  # 8 % 16 != 0
    assert not back._plan_matches(plan, mq, n_host=store.n + 1)
    built = back.planner.metrics["plans_built"]
    rows = router.finalize_many(mq, back.answer_batch(mq, plan=wide,
                                                      scheme=sch.staged))
    assert back.planner.metrics["plans_built"] == built  # replanned from cache
    assert torch.equal(rows[0], store.packed[1:5])
    assert torch.equal(rows[1], store.packed[5:6])


def test_router_plan_many_with_pre_and_checks():
    sch = make_scheme("chor", d=3, d_a=1)
    router = SchemeRouter(sch)
    gen = torch.Generator().manual_seed(1)
    lists = [[3, 9, 1], [2]]
    pre = router.precompute(gen, 64, protocol.multi_bucket(lists))
    mq = router.plan_many(gen, 64, lists, pre=pre)
    assert mq.payload.shape == (3, 8, 64) and mq.k_max == 4
    with pytest.raises(ValueError, match="n="):
        router.plan_many(gen, 65, lists, pre=pre)


# --------------------------------------------------------------------------
# submit_many through the pipeline
# --------------------------------------------------------------------------
def test_scheduler_flattened_accounting_equals_the_reference():
    def run(cls):
        now = itertools.count()
        s = cls(max_batch=8, clock=lambda: next(now))
        s.observe_service(8, 4 * s.target_latency_s)
        trace = [s.target_batch]
        s.submit("a", 1)
        s.submit_many("b", [1, 2, 3])
        trace.append((len(s), s.flat_len, s.ready()))
        s.submit_many("c", list(range(6)))
        s.submit_many("d", list(range(11)))  # alone above max_batch
        s.submit("e", 4)
        trace.append((len(s), s.flat_len, s.ready()))
        while len(s):
            trace.append([(r.client, r.index, r.indices, r.k, r.index_list)
                          for r in s.next_batch()])
            trace.append(s.flat_len)
        with pytest.raises(ValueError, match="at least one index"):
            s.submit_many("z", [])
        return trace

    assert run(BatchScheduler) == run(RefScheduler)


def test_submit_many_through_both_pipelines():
    rstore, tstore = _both_stores(2048, 64, seed=0)
    rsch = ref_make_scheme("sparse", d=D, d_a=D_A, theta=0.25)
    tsch = make_scheme("sparse", d=D, d_a=D_A, theta=0.25)
    rpipe = RefPipeline(rstore, rsch, scheduler=RefScheduler(max_batch=32))
    tpipe = ServingPipeline(
        tstore, tsch, scheduler=BatchScheduler(max_batch=32),
        backend=ShardedBackend(tstore, backend="cuda", device="cpu"),
        device="cpu")
    rng = np.random.default_rng(0)
    asked = {}
    for c in range(8):
        k = int(rng.integers(1, 5))
        asked[f"c{c}"] = [int(i) for i in rng.integers(0, 2048, size=k)]
    asked["single"] = [17]
    for client, lst in asked.items():
        if client == "single":
            assert rpipe.submit(client, lst[0]) and tpipe.submit(client, lst[0])
        else:
            assert rpipe.submit_many(client, lst)
            assert tpipe.submit_many(client, lst)
    planned = tpipe.plan_requests(tpipe.take_batch())
    assert planned.exec_plan.path == "sparse_multi_fused"
    assert planned.padded == 16 * 4 and planned.routed.k_max == 4
    tout = {r.client: a for r, a in tpipe.execute_planned(planned)}
    rout = rpipe.flush()
    assert set(tout) == set(rout) == set(asked)
    for client, lst in asked.items():
        np.testing.assert_array_equal(tout[client], rout[client])
        want = np.stack([tstore.record_bytes(i) for i in lst])
        if client == "single":
            want = want[0]
        np.testing.assert_array_equal(tout[client], want)
    for key in ("queries", "batches", "padded", "records_touched",
                "blocks_sent", "refused"):
        assert tpipe.metrics[key] == pytest.approx(rpipe.metrics[key],
                                                   rel=1e-12), key
    assert tpipe.backend.path_counts == rpipe.backend.path_counts


def test_submit_many_is_priced_k_times_and_refused_whole():
    store = make_synthetic_store(128, 16, device="cpu")
    sch = make_scheme("sparse", d=D, d_a=D_A, theta=0.25)
    eps = sch.epsilon(store.n)
    pipe = ServingPipeline(
        store, sch, default_budget=lambda: PrivacyBudget(epsilon_limit=4.5 * eps),
        device="cpu")
    assert pipe.submit_many("c", [1, 2, 3])
    assert pipe.budget("c").spent_epsilon == pytest.approx(3 * eps)
    assert not pipe.submit_many("c", [4, 5])  # 5 ε > 4.5 ε: nothing spent
    assert pipe.budget("c").spent_epsilon == pytest.approx(3 * eps)
    assert pipe.metrics["refused"] == 1
    assert pipe.submit("c", 6)
    with pytest.raises(ValueError, match="at least one index"):
        pipe.submit_many("c", [])
    out = pipe.flush()
    assert out["c"].shape == (16,)  # the later single request of "c" wins


def test_submit_many_on_a_live_store_answers_the_pinned_snapshot():
    from repro_torch.db import Delta, VersionedStore

    live = VersionedStore(make_synthetic_store(2048, 64, seed=4, device="cpu"))
    pipe = ServingPipeline(
        live, make_scheme("sparse", d=D, d_a=D_A, theta=0.25),
        backend=ShardedBackend(live.snapshot(), backend="cuda", device="cpu"),
        device="cpu")
    assert pipe.submit_many("c", [5, 2047, 9])
    planned = pipe.plan_requests(pipe.take_batch())
    before = np.stack([live.snapshot().record_bytes(i) for i in (5, 2047, 9)])
    rng = np.random.default_rng(1)
    pipe.ingest(Delta.update([5, 9], rng.integers(0, 256, (2, 64), np.uint8)))
    pipe.ingest(Delta.append(rng.integers(0, 256, (3, 64), np.uint8)))
    out = dict((r.client, a) for r, a in pipe.execute_planned(planned))
    np.testing.assert_array_equal(out["c"], before)
    assert planned.routed.store_version == 0
    assert pipe.submit_many("c", [5, 2049])
    now = pipe.flush()["c"]
    np.testing.assert_array_equal(
        now, np.stack([live.snapshot().record_bytes(i) for i in (5, 2049)]))
