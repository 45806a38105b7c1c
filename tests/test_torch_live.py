"""Port vs reference: the live store — ``Delta``, the ``VersionedStore``
MVCC contract, the ``scatter_rows`` write kernel's plain version, the
scatter ingest, incremental invalidation and snapshot-pinned serving
(tolerance zero on words and bytes).

The same store (``convert.store_from_numpy``) and the same deltas (each
package's ``pir_delta_batch``, one numpy stream) go through both
packages; heads are compared bit for bit after every delta. The port runs
on the CPU here because the tests say ``device="cpu"``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_scheme as ref_make_scheme
from repro.data.pipeline import pir_delta_batch as ref_pir_delta_batch
from repro.db import Delta as RefDelta
from repro.db import VersionedStore as RefVersionedStore
from repro.db import make_synthetic_store as ref_make_store
from repro.db import rebuild as ref_rebuild
from repro.db.live import apply_delta_np as ref_apply_delta_np
from repro.kernels import ref as ref_oracles
from repro.kernels.scatter import scatter_rows as ref_scatter_rows
from repro.serve import ServingPipeline as RefPipeline
from repro_torch import convert
from repro_torch.core import make_scheme
from repro_torch.data.pipeline import pir_delta_batch
from repro_torch.db import Delta, VersionedStore, make_synthetic_store, rebuild
from repro_torch.db.live import apply_delta_np
from repro_torch.kernels import ref, registered_backends, scatter_update
from repro_torch.kernels.scatter import scatter_rows, scatter_rows_plain
from repro_torch.serve import ServingPipeline, ShardedBackend

from _torch_parity import words_n2t, words_t2n

D, D_A = 4, 2
RNG = np.random.default_rng(20261016)


def _raw(m, nbytes):
    return RNG.integers(0, 256, size=(m, nbytes), dtype=np.uint8)


def _both_stores(n, rb, seed):
    rstore = ref_make_store(n, rb, seed=seed)
    tstore = convert.store_from_numpy(
        np.asarray(rstore.packed), rstore.record_bits, device="cpu")
    return rstore, tstore


def _pair(kind, *args):
    """The same delta in both packages."""
    return getattr(RefDelta, kind)(*args), getattr(Delta, kind)(*args)


def _same_head(rlive, tlive, v=None):
    np.testing.assert_array_equal(
        words_t2n(tlive.snapshot(v).packed),
        np.asarray(rlive.snapshot(v).packed))


def _pipe(live, **kw):
    sch = make_scheme("sparse", d=D, d_a=D_A, theta=0.3)
    snap = live.snapshot()
    kw.setdefault("backend", ShardedBackend(snap, device="cpu"))
    return ServingPipeline(live, sch, device="cpu", **kw)


# --------------------------------------------------------------------------
# Delta semantics
# --------------------------------------------------------------------------
def test_delta_constructors_validate_like_the_reference():
    for cls in (Delta, RefDelta):
        with pytest.raises(ValueError, match="unknown delta kind"):
            cls(kind="upsert")
        with pytest.raises(ValueError, match="payload"):
            cls(kind="append")
        with pytest.raises(ValueError, match="target indices"):
            cls(kind="update", raw=_raw(1, 8))
        with pytest.raises(ValueError, match="rows != index count"):
            cls.update([1, 2, 3], _raw(2, 8))


@pytest.mark.parametrize("targets", [
    [5, 9, 5, 9], [3], [7, 7, 7], [0, 1, 2, 3], [9, 2, 9, 4, 2, 2], []])
def test_delta_update_and_delete_dedup_equal_the_reference(targets):
    raw = _raw(len(targets), 8)
    rd, td = _pair("update", targets, raw)
    np.testing.assert_array_equal(td.indices, rd.indices)
    np.testing.assert_array_equal(td.raw, rd.raw)
    assert td.count == rd.count
    rd, td = _pair("delete", targets)
    np.testing.assert_array_equal(td.indices, rd.indices)
    assert td.count == rd.count


def test_delta_update_keeps_the_last_write():
    raw = _raw(4, 8)
    d = Delta.update([5, 9, 5, 9], raw)
    np.testing.assert_array_equal(d.indices, [5, 9])
    np.testing.assert_array_equal(d.raw, raw[[2, 3]])
    assert Delta.append(_raw(6, 4)).count == 6


@pytest.mark.parametrize("step", [0, 1, 7])
def test_pir_delta_batch_equals_the_reference(step):
    kw = dict(appends=3, updates=50, deletes=4, seed=2, step=step)
    got = pir_delta_batch(40, 12, **kw)
    want = ref_pir_delta_batch(40, 12, **kw)
    assert [d.kind for d in got] == [d.kind for d in want] == [
        "append", "update", "delete"]
    for g, w in zip(got, want):
        for f in ("indices", "raw"):
            a, b = getattr(g, f), getattr(w, f)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        pir_delta_batch(0, 12, updates=1)


def test_apply_delta_np_equals_the_reference():
    rstore, _ = _both_stores(10, 8, seed=1)
    packed = np.asarray(rstore.packed)
    for kind, args in (("update", ([3], _raw(1, 8))),
                       ("append", (_raw(2, 8),)),
                       ("delete", ([0, 9],))):
        rd, td = _pair(kind, *args)
        np.testing.assert_array_equal(
            apply_delta_np(packed, 64, td), ref_apply_delta_np(packed, 64, rd))
    de = apply_delta_np(packed, 64, Delta.delete([0, 9]))
    assert (de[0] == 0).all() and (de[1:9] == packed[1:9]).all()
    with pytest.raises(IndexError, match="out of range"):
        apply_delta_np(packed, 64, Delta.delete([10]))
    with pytest.raises(ValueError, match="bytes/record"):
        apply_delta_np(packed, 64, Delta.append(_raw(1, 7)))


# --------------------------------------------------------------------------
# The scatter kernel's plain version against the reference kernel
# --------------------------------------------------------------------------
def _scatter_case(n, w, rows, dtype, seed):
    rng = np.random.default_rng(seed)
    hi = 256 if dtype == np.uint8 else 2**32
    db = rng.integers(0, hi, size=(n, w), dtype=np.uint64).astype(dtype)
    vals = rng.integers(0, hi, size=(len(rows), w), dtype=np.uint64).astype(dtype)
    return db, np.asarray(rows, np.int32), vals


def _to_t(a):
    if a.dtype == np.uint32:
        return words_n2t(a)
    return torch.from_numpy(np.ascontiguousarray(a))


def _from_t(t, dtype):
    return words_t2n(t) if dtype == np.uint32 else t.numpy()


SCATTER_CASES = [
    # (n, W, rows)
    (16, 4, [3, 0, 15]),
    (64, 12, list(range(0, 64, 5))),
    (33, 7, [32, 1, 2, 30]),
    (1, 3, [0]),
    (512, 48, list(RNG.choice(512, 100, replace=False))),
]


@pytest.mark.parametrize("n,w,rows", SCATTER_CASES)
@pytest.mark.parametrize("dtype", [np.uint32, np.uint8])
def test_scatter_plain_equals_reference_on_unique_rows(n, w, rows, dtype):
    db, r, vals = _scatter_case(n, w, rows, dtype, seed=n + w)
    want = np.asarray(ref_scatter_rows(
        jnp.asarray(db), jnp.asarray(r), jnp.asarray(vals), interpret=True))
    np.testing.assert_array_equal(want, np.asarray(ref_oracles.scatter_rows_ref(
        jnp.asarray(db), jnp.asarray(r), jnp.asarray(vals))))
    tdb = _to_t(db)
    before = tdb.clone()
    for fn in (scatter_rows, scatter_rows_plain, ref.scatter_rows_ref):
        got = fn(tdb, torch.from_numpy(r), _to_t(vals))
        np.testing.assert_array_equal(_from_t(got, dtype), want)
        assert got.data_ptr() != tdb.data_ptr()
    assert torch.equal(tdb, before)  # functional: the input is never written


@pytest.mark.parametrize("rows", [
    [4, 4], [1, 5, 1, 5, 1], [7, 2, 7, 2, 7, 3, 3], [0] * 9])
@pytest.mark.parametrize("dtype", [np.uint32, np.uint8])
def test_scatter_duplicate_rows_last_write_wins(rows, dtype):
    """The reference's TPU kernel folds updates in index order; so does the
    port's plain version. (The reference's jnp oracle leaves duplicate
    order to XLA and is not held here.)"""
    db, r, vals = _scatter_case(12, 5, rows, dtype, seed=len(rows))
    want = np.asarray(ref_scatter_rows(
        jnp.asarray(db), jnp.asarray(r), jnp.asarray(vals), interpret=True))
    oracle = db.copy()
    for i, row in enumerate(rows):
        oracle[row] = vals[i]
    np.testing.assert_array_equal(want, oracle)
    got = scatter_rows(_to_t(db), torch.from_numpy(r), _to_t(vals))
    np.testing.assert_array_equal(_from_t(got, dtype), oracle)


def test_scatter_with_no_rows_returns_db_itself():
    db = words_n2t(np.arange(24, dtype=np.uint32).reshape(6, 4))
    empty = torch.zeros((0,), dtype=torch.int32)
    for fn in (scatter_rows, scatter_rows_plain):
        assert fn(db, empty, db[:0]) is db
    assert scatter_update(db, np.zeros(0, np.int64), db[:0]) is db


def test_scatter_drops_rows_out_of_range_and_casts_vals():
    db = torch.zeros((4, 2), dtype=torch.int32)
    rows = torch.tensor([-1, 4, 2], dtype=torch.int32)
    vals = torch.tensor([[1, 1], [2, 2], [3, 3]], dtype=torch.int64)
    out = scatter_rows(db, rows, vals)
    assert out.dtype == torch.int32
    assert out.tolist() == [[0, 0], [0, 0], [3, 3], [0, 0]]
    with pytest.raises(ValueError, match="vals must be"):
        scatter_rows(db, rows, vals[:2])
    f32 = torch.zeros((3, 2), dtype=torch.float32)
    got = scatter_rows(f32, torch.tensor([1]), torch.ones((1, 2)))
    assert got.tolist() == [[0, 0], [1, 1], [0, 0]]


# --------------------------------------------------------------------------
# VersionedStore: the MVCC contract, held against the reference
# --------------------------------------------------------------------------
def test_heads_equal_the_reference_after_the_same_deltas():
    rstore, tstore = _both_stores(96, 20, seed=3)
    rlive = RefVersionedStore(rstore, shards=8, retain=2, backend="ref")
    tlive = VersionedStore(tstore, shards=8, retain=2, backend="cuda")
    n = 96
    for step in range(4):
        rds = ref_pir_delta_batch(n, 20, appends=3, updates=12, deletes=2,
                                  seed=5, step=step)
        tds = pir_delta_batch(n, 20, appends=3, updates=12, deletes=2,
                              seed=5, step=step)
        for rd, td in zip(rds, tds):
            assert rlive.ingest(rd) == tlive.ingest(td)
            _same_head(rlive, tlive)
            assert tlive.shard_versions == rlive.shard_versions
        n = tlive.n
    assert tlive.n == rlive.n == 96 + 4 * 3
    for v in range(tlive.version + 1):
        _same_head(rlive, tlive, v)
    for key in ("ingests", "rows_appended", "rows_updated", "rows_deleted",
                "snapshot_rebuilds", "deltas_replayed"):
        assert tlive.metrics[key] == rlive.metrics[key], key


def test_snapshot_bit_identical_to_rebuild_at_every_version():
    rstore, tstore = _both_stores(64, 16, seed=3)
    live = VersionedStore(tstore, shards=8, retain=2, backend="ref")
    args = [("append", (_raw(8, 16),)),
            ("update", ([5, 60, 5], _raw(3, 16))),
            ("delete", ([0, 71],)),
            ("append", (_raw(4, 16),)),
            ("update", ([70], _raw(1, 16)))]
    pairs = [_pair(kind, *a) for kind, a in args]
    for _, td in pairs:
        live.ingest(td)
    assert live.version == len(pairs) and live.n == 76
    for v in range(live.version + 1):
        got = live.snapshot(v)
        want = ref_rebuild(rstore, [rd for rd, _ in pairs[:v]])
        np.testing.assert_array_equal(words_t2n(got.packed),
                                      np.asarray(want.packed))
        np.testing.assert_array_equal(
            words_t2n(rebuild(tstore, [td for _, td in pairs[:v]]).packed),
            np.asarray(want.packed))
        assert got.record_bits == want.record_bits
        assert got.device == tstore.device
    assert live.metrics["snapshot_rebuilds"] >= 1
    with pytest.raises(ValueError, match="out of range"):
        live.snapshot(live.version + 1)


def test_snapshots_are_frozen_values():
    """Pinning a snapshot is holding the object: no ingest writes into a
    buffer an earlier head holds."""
    live = VersionedStore(make_synthetic_store(32, 8, seed=4, device="cpu"),
                          backend="cuda")
    pins = [live.snapshot()]
    copies = [pins[0].packed.clone()]
    for delta in (Delta.update(np.arange(32), _raw(32, 8)),
                  Delta.delete([3, 4]), Delta.append(_raw(16, 8)),
                  Delta.update([40, 1], _raw(2, 8))):
        live.ingest(delta)
        pins.append(live.snapshot())
        copies.append(pins[-1].packed.clone())
    for pin, before in zip(pins, copies):
        assert torch.equal(pin.packed, before)
    assert pins[0].n == 32 and live.n == 48
    ptrs = {p.packed.data_ptr() for p in pins}
    assert len(ptrs) == len(pins)


def test_shard_touch_tracking_equals_the_reference():
    rstore, tstore = _both_stores(64, 8, seed=5)
    rlive = RefVersionedStore(rstore, shards=8, backend="ref")
    tlive = VersionedStore(tstore, shards=8, backend="ref")
    for kind, args in (("update", ([2, 10], _raw(2, 8))),
                       ("delete", ([5],)),
                       ("append", (_raw(3, 8),))):
        rd, td = _pair(kind, *args)
        rlive.ingest(rd)
        tlive.ingest(td)
        for v in range(tlive.version + 1):
            assert tlive.shards_touched_since(v) == rlive.shards_touched_since(v)
    assert tlive.shards_touched_since(0) == (0, 1, 2, 5)
    assert tlive.shard_of(66) == 2
    np.testing.assert_array_equal(
        tlive.touched_rows(Delta.append(_raw(2, 8)), n_before=67), [67, 68])


def test_snapshot_replays_from_nearest_retained_head():
    rstore, tstore = _both_stores(32, 8, seed=7)
    live = VersionedStore(tstore, shards=4, retain=2, backend="ref")
    pairs = [_pair("update", [i], _raw(1, 8)) for i in range(8)]
    for _, td in pairs[:5]:
        live.ingest(td)
    got = live.snapshot(3)
    np.testing.assert_array_equal(
        words_t2n(got.packed),
        np.asarray(ref_rebuild(rstore, [rd for rd, _ in pairs[:3]]).packed))
    assert live.metrics["deltas_replayed"] == 3
    assert live.compact() == 5
    assert live.base_version == 5 and live.log_depth == 0
    for _, td in pairs[5:]:
        live.ingest(td)
    got = live.snapshot(6)
    np.testing.assert_array_equal(
        words_t2n(got.packed),
        np.asarray(ref_rebuild(rstore, [rd for rd, _ in pairs[:6]]).packed))
    assert live.metrics["deltas_replayed"] == 3 + 1
    assert live.metrics["snapshot_rebuilds"] == 2


def test_compaction_rebases_log_and_preserves_mvcc_contract():
    rstore, tstore = _both_stores(48, 8, seed=8)
    live = VersionedStore(tstore, shards=8, backend="cuda")
    pairs = [_pair("append", _raw(4, 8)),
             _pair("update", [5, 50], _raw(2, 8)),
             _pair("delete", [0])]
    for _, td in pairs:
        live.ingest(td)
    touched_pre = set(live.shards_touched_since(0))
    pin = live.snapshot(2)
    pin_bytes = pin.packed.clone()

    assert live.compact() == 3
    assert live.metrics["compactions"] == 1
    assert live.metrics["compacted_deltas"] == 3
    assert live.version == 3 and live.base_version == 3 and live.log_depth == 0
    np.testing.assert_array_equal(
        words_t2n(live.snapshot().packed),
        np.asarray(ref_rebuild(rstore, [rd for rd, _ in pairs]).packed))
    assert set(live.shards_touched_since(0)) == touched_pre
    with pytest.raises(ValueError, match="predates the compaction base"):
        live.snapshot(2)
    assert torch.equal(pin.packed, pin_bytes)
    live.ingest(Delta.update([1], _raw(1, 8)))
    assert live.version == 4 and live.log_depth == 1
    assert live.compact() == 1
    assert live.compact() == 0  # empty log: no-op


def test_compaction_refuses_a_head_that_differs_from_the_replay():
    live = VersionedStore(make_synthetic_store(16, 8, seed=2, device="cpu"),
                          backend="ref")
    live.ingest(Delta.update([3], _raw(1, 8)))
    live._head = live.base  # a head the log does not produce
    with pytest.raises(RuntimeError, match="oracle mismatch"):
        live.compact()
    assert live.log_depth == 1


@pytest.mark.parametrize("backend", sorted(registered_backends()))
def test_scatter_ingest_matches_host_oracle(backend):
    """Every registered write backend gives the reference's words, for
    update and delete, through chunks of the scatter as well."""
    rstore, tstore = _both_stores(48, 12, seed=6)
    bits = rstore.record_bits
    for kind, args in (("update", ([0, 17, 47], _raw(3, 12))),
                       ("delete", ([1, 46],)),
                       ("update", (RNG.integers(0, 48, 40), _raw(40, 12)))):
        rd, td = _pair(kind, *args)
        live = VersionedStore(tstore, backend=backend)
        live.ingest(td)
        np.testing.assert_array_equal(
            words_t2n(live.snapshot().packed),
            ref_apply_delta_np(np.asarray(rstore.packed), bits, rd))


def test_scatter_ingest_chunks_large_deltas(monkeypatch):
    """Deltas apply in chunks of _SCATTER_CHUNK rows, each a functional
    scatter of the previous chunk's buffer."""
    from repro_torch.db import live as live_mod

    monkeypatch.setattr(live_mod, "_SCATTER_CHUNK", 4)
    before = scatter_rows.launches
    calls = []
    real = scatter_update

    def counting(db, rows, vals, **kw):
        calls.append(int(rows.shape[0]))
        return real(db, rows, vals, **kw)

    monkeypatch.setattr("repro_torch.kernels.backend.scatter_update", counting)
    rstore, tstore = _both_stores(40, 8, seed=11)
    rd, td = _pair("update", np.arange(0, 40, 4), _raw(10, 8))
    live = VersionedStore(tstore, backend="cuda")
    live.ingest(td)
    assert calls == [4, 4, 2]
    assert scatter_rows.launches == before  # CPU tensors: the plain version
    np.testing.assert_array_equal(
        words_t2n(live.snapshot().packed),
        ref_apply_delta_np(np.asarray(rstore.packed), 64, rd))


# --------------------------------------------------------------------------
# Serving a live store
# --------------------------------------------------------------------------
def test_update_keeps_plans_append_drops_them_like_the_reference():
    n = 256
    rstore, tstore = _both_stores(n, 16, seed=8)
    rlive = RefVersionedStore(rstore, shards=8, backend="ref")
    tlive = VersionedStore(tstore, shards=8)
    rpipe = RefPipeline(rlive, ref_make_scheme("sparse", d=D, d_a=D_A, theta=0.3))
    tpipe = _pipe(tlive)
    for p in (rpipe, tpipe):
        for c in range(4):
            assert p.submit(f"c{c}", 7 * c)
        p.flush()
    tm0 = dict(tpipe.backend.planner.metrics)
    assert tm0["plans_built"] >= 1

    touched = np.arange(0, n, 64)  # >= 1% of n
    raw = _raw(len(touched), 16)
    rpipe.ingest(RefDelta.update(touched, raw))
    tpipe.ingest(Delta.update(touched, raw))
    tm1 = dict(tpipe.backend.planner.metrics)
    assert tm1["rebinds"] == tm0["rebinds"] + 1
    assert tm1["plans_kept"] > tm0["plans_kept"]
    assert tm1["plans_dropped"] == tm0["plans_dropped"]
    assert tm1["precompute_full_builds"] == tm0["precompute_full_builds"]
    assert tpipe.backend.last_swap["store_shards_touched"] == 1
    assert tpipe.backend.last_swap == {
        k: rpipe.backend.last_swap[k] for k in tpipe.backend.last_swap}
    for p in (rpipe, tpipe):
        assert p.submit("r", int(touched[1]))
    np.testing.assert_array_equal(tpipe.flush()["r"], rpipe.flush()["r"])
    _same_head(rlive, tlive)

    raw = _raw(8, 16)
    rpipe.ingest(RefDelta.append(raw))
    tpipe.ingest(Delta.append(raw))
    assert tpipe.backend.planner.metrics["plans_dropped"] > tm1["plans_dropped"]
    assert tpipe.price == pytest.approx(rpipe.price)
    for p in (rpipe, tpipe):
        assert p.submit("t", n + 7)
    got = tpipe.flush()["t"]
    np.testing.assert_array_equal(got, rpipe.flush()["t"])
    np.testing.assert_array_equal(got, tlive.snapshot().record_bytes(n + 7))
    assert tpipe.metrics["ingests"] == rpipe.metrics["ingests"] == 2
    assert tpipe.metrics["records_ingested"] == rpipe.metrics["records_ingested"]


def test_rebind_refreshes_only_touched_planes_out_of_place():
    store = make_synthetic_store(64, 8, seed=3, device="cpu")
    live = VersionedStore(store)
    back = ShardedBackend(store, backend="cuda", parity_min_batch=2,
                          device="cpu")
    old_planes = back.planner.planes()
    kept = old_planes.clone()
    live.ingest(Delta.update([1, 40], _raw(2, 8)))
    counters = back.swap_store(live.snapshot(),
                               touched_rows=np.array([1, 40]), live=live)
    assert counters["precompute_rows_refreshed"] == 2
    assert counters["plans_dropped"] == 0
    assert torch.equal(old_planes, kept)  # the old planes are untouched
    assert torch.equal(back.planner.planes(), live.snapshot().bitplanes())
    assert back.planner.metrics["precompute_full_builds"] == 1
    # an unknown touch set drops plans and planes
    counters = back.swap_store(live.snapshot(), touched_rows=None)
    assert back.planner._planes is None
    assert back.mesh_metrics == dict.fromkeys(back.mesh_metrics, 0)


def test_in_flight_batch_answers_from_its_pinned_snapshot():
    live = VersionedStore(make_synthetic_store(64, 8, seed=10, device="cpu"))
    pipe = _pipe(live)
    idx = 5
    pinned_bytes = np.array(live.snapshot().record_bytes(idx), copy=True)
    assert pipe.submit("c", idx)
    planned = pipe.plan_requests(pipe.take_batch())
    assert planned.store_version == 0 and planned.routed.store_version == 0

    pipe.ingest(Delta.update([idx], _raw(1, 8)))  # lands mid-flight
    new_bytes = live.snapshot().record_bytes(idx)
    assert (np.asarray(new_bytes) != pinned_bytes).any()

    out = {r.client: a for r, a in pipe.execute_planned(planned)}
    np.testing.assert_array_equal(out["c"], pinned_bytes)
    assert pipe.submit("c2", idx)
    np.testing.assert_array_equal(pipe.flush()["c2"], new_bytes)
    assert pipe.store_version == 1


def test_in_flight_batch_across_an_append_keeps_its_plan():
    """A plan made before an append is for the pinned store's n: it is
    executed, not replanned against the grown head."""
    live = VersionedStore(make_synthetic_store(64, 8, seed=12, device="cpu"))
    pipe = _pipe(live)
    assert pipe.submit("c", 9)
    planned = pipe.plan_requests(pipe.take_batch())
    built = pipe.backend.planner.metrics["plans_built"]
    pipe.ingest(Delta.append(_raw(4, 8)))
    out = {r.client: a for r, a in pipe.execute_planned(planned)}
    np.testing.assert_array_equal(out["c"], planned.store.record_bytes(9))
    assert pipe.backend.planner.metrics["plans_built"] == built


def test_ingest_requires_a_live_store():
    pipe = ServingPipeline(make_synthetic_store(32, 8, seed=12, device="cpu"),
                           make_scheme("chor", d=2, d_a=1), device="cpu")
    assert pipe.live is None
    for call in (pipe.ingest, pipe.queue_delta):
        with pytest.raises(RuntimeError, match="frozen"):
            call(Delta.append(_raw(1, 8)))
    assert pipe.compact_step() == 0


def test_queued_deltas_apply_in_order_and_compact():
    live = VersionedStore(make_synthetic_store(32, 8, seed=13, device="cpu"))
    pipe = _pipe(live)
    pipe.queue_delta(Delta.update([1], _raw(1, 8)))
    pipe.queue_delta(Delta.append(_raw(2, 8)))
    assert pipe.pending_deltas == 2
    assert pipe.ingest_step(max_deltas=1) == 1 and pipe.store.n == 32
    assert pipe.ingest_step(max_deltas=5) == 1 and pipe.store.n == 34
    assert pipe.pending_deltas == 0 and pipe.store_version == 2
    assert pipe.compact_step(min_log_depth=3) == 0
    assert pipe.compact_step() == 2 and live.log_depth == 0


def test_live_pipeline_from_the_config_and_the_launcher(capsys):
    from repro_torch.configs import pir_ct
    from repro_torch.launch import serve

    cfg = pir_ct.reduced()
    live = VersionedStore(make_synthetic_store(
        cfg.n_records, cfg.record_bytes, seed=0, device="cpu"))
    pipe = pir_ct.make_serving_pipeline(cfg, store=live, device="cpu")
    assert pipe.live is live
    pipe.ingest(Delta.update([3], _raw(1, cfg.record_bytes)))
    assert pipe.submit("c", 3)
    np.testing.assert_array_equal(pipe.flush()["c"],
                                  live.snapshot().record_bytes(3))

    serve.main(["--device", "cpu", "--n", "128", "--record-bytes", "16",
                "--queries", "20", "--batch", "8", "--d", "3", "--da", "1",
                "--ingest-every", "8", "--ingest-rows", "4"])
    text = capsys.readouterr().out
    assert "verified exact" in text
    assert "live store: v3, n=140 (12 records ingested" in text
