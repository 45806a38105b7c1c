"""Port vs reference: PIR serving on a mesh — the record-sharded
``ShardedBackend`` (Chor, Sparse-PIR, Direct Requests, forced parity), the
planner's mesh plans, and touched-shard ingest (tolerance zero on words
and bytes).

The mesh is (2, 4) ("data", "model") with every position on the CPU, so
each position's shard is its own CPU tensor. The reference's router draws
the wire payloads; they are carried across through numpy, so both
packages answer the same bits, and every record must equal the
reference's ``Scheme.retrieve`` on the same key and store (the reference's
own multidevice checks prove its mesh path equal to that). The port runs
on the CPU because the tests say ``device="cpu"``; backend ``cuda`` takes
the kernel wrappers' plain versions there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_scheme as ref_make_scheme
from repro.db import Delta as RefDelta
from repro.db import make_synthetic_store as ref_make_store
from repro.db import rebuild as ref_rebuild
from repro.dist.sharding import touched_record_blocks as ref_touched_blocks
from repro.serve import SchemeRouter as RefRouter
from repro_torch import convert
from repro_torch.core import make_scheme
from repro_torch.db import Delta, VersionedStore, rebuild
from repro_torch.dist import DEFAULT_RULES, make_mesh, mesh_rules
from repro_torch.dist.sharding import touched_record_blocks
from repro_torch.serve import (
    BatchScheduler,
    SchemeRouter,
    ServingPipeline,
    ShardedBackend,
)

from _torch_parity import words_t2n

CPU = torch.device("cpu")
MESH = make_mesh((2, 4), ("data", "model"), [CPU])
XORBFLY = dict(DEFAULT_RULES, records=("data", "model"), queries=None)
RULES = {"xorbfly": XORBFLY, "default": dict(DEFAULT_RULES)}
PARAMS = {"chor": {}, "sparse": dict(theta=0.25), "direct": dict(p=16)}
FAMILY = {"chor": "fold", "sparse": "sparse", "direct": "direct"}


def _stores(n, rb, seed):
    rstore = ref_make_store(n=n, record_bytes=rb, seed=seed)
    return rstore, convert.store_from_numpy(
        np.asarray(rstore.packed), rstore.record_bits, device="cpu")


def _carry(routed):
    return convert.queries_from_numpy(
        routed.kind, np.asarray(routed.payload), routed.servers,
        np.asarray(routed.q_idx), routed.theta, device="cpu")


def _answer(backend, tsch, routed, rules, scheme=None):
    """The reference router's payload through the port's backend on the
    mesh, reconstructed by the port's router."""
    tq = _carry(routed)
    with mesh_rules(MESH, rules):
        got = backend.answer_batch(tq, scheme=scheme)
    return words_t2n(SchemeRouter(tsch).finalize(tq, got))


# --------------------------------------------------------------------------
# The backend on the mesh
# --------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["cuda", "auto"])
@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("name", sorted(PARAMS))
def test_backend_on_the_mesh_gives_the_reference_records(name, rules, backend):
    rstore, tstore = _stores(300, 20, 11)  # pads to 304
    key = jax.random.key(4)
    q = jnp.asarray([0, 13, 299, 128, 7, 42, 77, 200], jnp.int32)
    rsch = ref_make_scheme(name, d=4, d_a=2, **PARAMS[name])
    tsch = make_scheme(name, d=4, d_a=2, **PARAMS[name])
    want = np.asarray(rsch.retrieve(key, rstore, q))
    routed = RefRouter(rsch).plan(key, rstore.n, q)
    tb = ShardedBackend(tstore, backend=backend, device="cpu")
    got = _answer(tb, tsch, routed, RULES[rules], scheme=tsch.staged)
    np.testing.assert_array_equal(got, want)
    assert tb.path_counts[FAMILY[name]] == 4
    state = tb._mesh_db[id(MESH)]
    rshards, n_pad = (8, 304) if rules == "xorbfly" else (4, 300)
    assert (state["n_pad"], state["rshards"]) == (n_pad, rshards)
    # every position holds its block in a storage of its own
    ptrs = {sh.data.data_ptr() for sh in state["db"].shards}
    assert len(ptrs) == rshards and len(state["db"].shards) == 8
    if name != "direct":
        with mesh_rules(MESH, RULES[rules]):
            plan = tb.prepare(_carry(routed), scheme=tsch.staged)
        assert plan.run is None and plan.n == n_pad // rshards
        assert tb.planner.pending() == ()  # mesh cells are never queued


def test_the_pipeline_on_and_off_the_mesh_gives_the_same_records():
    """The batch-scheduled pipeline with records over all 8 positions ==
    the single-device pipeline for the same seed, with the parity path
    forced on both; every record is the stored one."""
    rstore, tstore = _stores(300, 20, 11)
    q = [0, 13, 299, 128, 7, 42, 77, 200]

    def serve(on_mesh):
        pipe = ServingPipeline(
            tstore, make_scheme("chor", d=3, d_a=1),
            scheduler=BatchScheduler(max_batch=16), seed=5, device="cpu",
            backend=ShardedBackend(tstore, parity_min_batch=8, device="cpu"),
        )
        for i in range(8):
            assert pipe.submit(f"c{i}", q[i])
        if not on_mesh:
            return pipe.flush(), pipe
        with mesh_rules(MESH, XORBFLY):
            return pipe.flush(), pipe

    single, _ = serve(False)
    sharded, pipe = serve(True)
    assert pipe.backend.path_counts["parity"] == 3
    for i in range(8):
        np.testing.assert_array_equal(sharded[f"c{i}"], single[f"c{i}"])
        np.testing.assert_array_equal(sharded[f"c{i}"],
                                      rstore.record_bytes(q[i]))
    # the planes' blocks are bit-major, each its own [B, n_loc] storage
    planes = pipe.backend._mesh_db[id(MESH)]["planes"]
    for sh in planes.shards:
        assert sh.data.shape == (38, 160) and sh.data.stride() == (1, 38)
        assert sh.data.t().is_contiguous()


def test_a_mesh_switch_evicts_the_residency_and_its_plans():
    _, tstore = _stores(64, 8, 3)
    tb = ShardedBackend(tstore, device="cpu")
    sch = make_scheme("chor", d=2, d_a=1)
    tq = SchemeRouter(sch).plan(torch.Generator().manual_seed(0), 64,
                                torch.tensor([1, 2]))
    with mesh_rules(MESH, XORBFLY):
        tb.answer_batch(tq)
    assert set(tb._mesh_db) == {id(MESH)}
    dropped = tb.planner.metrics["plans_dropped"]
    other = make_mesh((4, 2), ("data", "model"), ["cpu"])
    with mesh_rules(other, XORBFLY):
        out = tb.answer_batch(tq)
    assert set(tb._mesh_db) == {id(other)}
    assert tb.planner.metrics["plans_dropped"] == dropped + 1
    np.testing.assert_array_equal(
        words_t2n(SchemeRouter(sch).finalize(tq, out)),
        words_t2n(tstore.packed[[1, 2]]))


def test_a_mesh_of_another_device_type_is_refused():
    _, tstore = _stores(64, 8, 3)
    tb = ShardedBackend(tstore, device="cpu")
    tq = SchemeRouter(make_scheme("chor", d=2, d_a=1)).plan(
        torch.Generator().manual_seed(0), 64, torch.tensor([1]))
    cards = make_mesh((2, 4), ("data", "model"), ["cuda:0"])
    with mesh_rules(cards, XORBFLY), pytest.raises(ValueError,
                                                    match="device type"):
        tb.answer_batch(tq)


def test_an_index_request_clamps_to_the_real_record_range():
    """On the mesh an out-of-range id reads the last real record, as off
    it, never a zero pad record."""
    rstore, tstore = _stores(300, 20, 11)
    tb = ShardedBackend(tstore, device="cpu")
    reqs = torch.tensor([[299, 303, 10_000, -5]], dtype=torch.int32)
    with mesh_rules(MESH, XORBFLY):
        got = tb._answer_index_server(reqs)
    want = np.asarray(rstore.packed)[[299, 299, 299, 0]]
    np.testing.assert_array_equal(words_t2n(got[0]), want)


# --------------------------------------------------------------------------
# Touched-shard ingest
# --------------------------------------------------------------------------
def _ptrs(arr, block):
    return {sh.index // block: sh.data.data_ptr() for sh in arr.shards}


@pytest.mark.parametrize("rules", sorted(RULES))
def test_touched_shard_ingest(rules):
    """After each delta, ``swap_store(snap, touched_rows=..., live=...)``
    rewrites only the blocks the delta touched: the counters equal
    ``touched_record_blocks``, untouched blocks of the db and of the
    bitplanes keep their storage, same-shape deltas keep every plan, and
    the answers equal a full re-shard, the replay oracle and the
    reference's on the carried payloads, for append, update and delete."""
    rules_ = RULES[rules]
    rshards = 8 if rules == "xorbfly" else 4
    rbase, tbase = _stores(250, 16, 21)  # pads to 256 (8 blocks), 252 (4)
    rng = np.random.default_rng(33)
    rsch, tsch = (f("chor", d=3, d_a=1)
                  for f in (ref_make_scheme, make_scheme))
    rrouter = RefRouter(rsch)
    live = VersionedStore(tbase, shards=16)
    # the parity path at this batch size, so the mesh planes exist and
    # their per-block refresh is proven
    backend = ShardedBackend(live.snapshot(), parity_min_batch=4,
                             device="cpu")
    key0 = jax.random.key(40)
    q0 = jnp.asarray([0, 17, 249, 128], jnp.int32)
    got = _answer(backend, tsch, rrouter.plan(key0, live.n, q0), rules_)
    np.testing.assert_array_equal(
        got, np.asarray(rsch.retrieve(key0, rbase, q0)))
    assert backend._mesh_db[id(MESH)]["planes"] is not None

    a_raw = rng.integers(0, 256, size=(2, 16), dtype=np.uint8)
    u_rows = [0, 1, 2, 33, 34]
    u_raw = rng.integers(0, 256, size=(5, 16), dtype=np.uint8)
    deltas = [
        # an append that fits the residency's pad: the tail block only
        ("append", Delta.append(a_raw), RefDelta.append(a_raw)),
        # an update burst confined to the first blocks
        ("update", Delta.update(u_rows, u_raw), RefDelta.update(u_rows, u_raw)),
        # tombstones in two blocks
        ("delete", Delta.delete([3, 200]), RefDelta.delete([3, 200])),
    ]
    log, rlog = [], []
    for kind, delta, rdelta in deltas:
        n_before = live.n
        touched = live.touched_rows(delta, n_before=n_before)
        live.ingest(delta)
        log.append(delta)
        rlog.append(rdelta)
        snap = live.snapshot()
        same_shape = snap.n == n_before

        state = backend._mesh_db[id(MESH)]
        block = state["n_pad"] // state["rshards"]
        want_touched = set(touched_record_blocks(
            np.asarray(touched), state["n_pad"], state["rshards"]))
        assert want_touched == set(ref_touched_blocks(
            np.asarray(touched), state["n_pad"], state["rshards"]))
        ptrs = _ptrs(state["db"], block)
        plane_ptrs = _ptrs(state["planes"], block)

        counters = backend.swap_store(snap, touched_rows=touched, live=live)
        assert counters["mesh_states_refreshed"] == 1, (kind, counters)
        assert counters["mesh_states_dropped"] == 0, (kind, counters)
        assert counters["mesh_shards_updated"] == len(want_touched)
        assert counters["mesh_shards_kept"] == rshards - len(want_touched)
        assert 0 < counters["store_shards_touched"] < counters[
            "store_shards_total"]
        assert backend.last_swap == counters
        if same_shape:  # update/delete: every banked plan survives
            assert counters["plans_dropped"] == 0, (kind, counters)
            assert counters["plans_kept"] > 0, (kind, counters)

        state = backend._mesh_db[id(MESH)]
        for arr, before in ((state["db"], ptrs), (state["planes"], plane_ptrs)):
            now = _ptrs(arr, block)
            for b in range(rshards):
                assert (now[b] == before[b]) == (b not in want_touched), (
                    kind, b)

        # incremental refresh == full re-shard == replay oracle == reference
        key_v = jax.random.key(100 + live.version)
        q = jnp.asarray([0, 3, 200, snap.n - 1], jnp.int32)
        routed = rrouter.plan(key_v, snap.n, q)
        got_inc = _answer(backend, tsch, routed, rules_)
        full = ShardedBackend(snap, parity_min_batch=4, device="cpu")
        np.testing.assert_array_equal(got_inc,
                                      _answer(full, tsch, routed, rules_))
        oracle = rebuild(tbase, log)
        np.testing.assert_array_equal(
            got_inc, words_t2n(oracle.packed)[np.asarray(q)])
        np.testing.assert_array_equal(
            got_inc,
            np.asarray(rsch.retrieve(key_v, ref_rebuild(rbase, rlog), q)))


def test_an_append_past_the_pad_drops_the_residency_and_full_reshards():
    _, tbase = _stores(256, 16, 5)  # no pad: any append outgrows it
    live = VersionedStore(tbase, shards=8)
    backend = ShardedBackend(live.snapshot(), device="cpu")
    sch = make_scheme("chor", d=2, d_a=1)
    router = SchemeRouter(sch)
    gen = torch.Generator().manual_seed(1)

    def answer(q):
        tq = router.plan(gen, live.n, torch.tensor(q))
        with mesh_rules(MESH, XORBFLY):
            return words_t2n(router.finalize(tq, backend.answer_batch(tq)))

    answer([0, 255])
    raw = np.full((3, 16), 7, np.uint8)
    delta = Delta.append(raw)
    touched = live.touched_rows(delta, n_before=live.n)
    live.ingest(delta)
    c = backend.swap_store(live.snapshot(), touched_rows=touched, live=live)
    assert (c["mesh_states_dropped"], c["mesh_states_refreshed"]) == (1, 0)
    assert backend._mesh_db == {}
    got = answer([0, 255, 257])
    np.testing.assert_array_equal(got, words_t2n(live.snapshot().packed)[
        [0, 255, 257]])
    assert backend._mesh_db[id(MESH)]["n_pad"] == 264
    # an explicit full re-shard drops it too; a bogus mode is refused
    c = backend.swap_store(live.snapshot(), touched_rows=[0], reshard="full")
    assert c["mesh_states_dropped"] == 1 and backend.mesh_metrics[
        "mesh_states_dropped"] == 2
    with pytest.raises(ValueError, match="reshard"):
        backend.swap_store(live.snapshot(), reshard="bogus")


def test_the_engine_ingest_refreshes_the_touched_blocks_on_the_mesh():
    """The pipeline's own ``ingest`` hands the backend the touched rows and
    the live store, which is all the mesh refresh needs."""
    _, tbase = _stores(256, 16, 9)
    live = VersionedStore(tbase, shards=8)
    pipe = ServingPipeline(live, make_scheme("sparse", d=3, d_a=1, theta=0.3),
                           seed=2, device="cpu",
                           backend=ShardedBackend(live.snapshot(),
                                                  device="cpu"))

    def flush(picks):
        for c, i in enumerate(picks):
            assert pipe.submit(f"c{c}", i)
        with mesh_rules(MESH, XORBFLY):
            out = pipe.flush()
        snap = live.snapshot()
        for c, i in enumerate(picks):
            np.testing.assert_array_equal(out[f"c{c}"], snap.record_bytes(i))

    flush([1, 100, 255])
    raw = np.full((2, 16), 9, np.uint8)
    pipe.ingest(Delta.update([1, 2], raw))
    assert pipe.backend.last_swap["mesh_shards_updated"] == 1
    assert pipe.backend.last_swap["mesh_shards_kept"] == 7
    flush([1, 2, 200])
