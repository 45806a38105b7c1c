"""Port vs reference: the measured half of the execution planner — the
autotune table, its JSON file and device/shape filters, the search
(``tune_step``) over kernel candidates only, and the write path, which
does not race (tolerance zero on answers).

Every case mirrors one of the reference's own (``tests/test_exec_backend.py``)
on the port, with a table local to the CPU (``AutotuneTable(device="cpu")``:
the default is the card). Injected timers stand in for the clock where the
reference's do; the cases with the real timer run on the CPU, where the
``cuda`` impl's wrappers take their plain versions. A table file moves
between the two packages in both directions and is dropped by the other
each time (the fingerprints differ)."""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_scheme as ref_make_scheme
from repro.db import make_synthetic_store as ref_make_store
from repro.kernels import AutotuneTable as RefTable
from repro.kernels import KernelPlanner as RefPlanner
from repro.kernels import backend as ref_backend
from repro.serve import SchemeRouter as RefRouter
from repro_torch._device import device_fingerprint
from repro_torch.core import make_scheme
from repro_torch.db import make_synthetic_store
from repro_torch.kernels import ops, ref, scatter_update, shard_answer_fn
from repro_torch.kernels import backend as backend_mod
from repro_torch.kernels.backend import (
    AutotuneTable,
    KernelPlanner,
    PlanCandidate,
    TuneCell,
    _bench_mask,
    _measure_us,
    autotune_table,
    dump_autotune,
    load_autotune,
)
from repro_torch.serve import ServingPipeline, ShardedBackend

from _torch_parity import seeded_mask, words_t2n

CPU_FP = device_fingerprint("cpu")


def _table():
    return AutotuneTable(device="cpu")


def _store(n, rb, seed=0):
    return make_synthetic_store(n, rb, seed=seed, device="cpu")


def _wire(theta=None):
    return types.SimpleNamespace(kind="mask", theta=theta)


def _counting_measure(calls=None):
    """An injected timer that never reads the clock: records each measured
    candidate and returns a deterministic figure (later candidates slower,
    so the first candidate always wins)."""
    calls = calls if calls is not None else []

    def measure(fn, *args, candidate=None):
        calls.append(candidate)
        return float(100 + len(calls))

    return measure, calls


class _StubAuto:
    """``auto`` as it resolves on the card, for a store on the CPU: the
    search then races the kernel side (whose wrappers take their plain
    versions on the CPU)."""

    name = "auto"

    def resolve(self, device):
        return "cuda"


# ----------------------------------------------------------- autotune table
def test_autotune_table_json_roundtrip(tmp_path):
    table = _table()
    table.put(("chor", 64, "ref", 512, 6, "mask"), "parity", impl="ref",
              source="measured", us={"fold/ref": 10.5, "parity/ref": 3.25})
    table.put(("sparse", 8, "cuda", 512, 6, "sparse@0.25"),
              "sparse_fused", impl="cuda",
              blocks={"block_w": 64, "grid_order": "wq"}, source="measured")
    path = tmp_path / "autotune.json"
    table.dump(str(path))
    blob = json.loads(path.read_text())
    assert blob["version"] == AutotuneTable.VERSION == RefTable.VERSION
    assert {e["scheme"] for e in blob["entries"]} == {"chor", "sparse"}
    # every dumped entry carries the measuring device's fingerprint
    assert all(e["device"] == CPU_FP for e in blob["entries"])
    back = AutotuneTable.load(str(path), device="cpu")
    assert len(back) == 2
    hit = back.get(("chor", 64, "ref", 512, 6, "mask"))
    assert hit["path"] == "parity" and hit["us"]["parity/ref"] == 3.25
    sp = back.get(("sparse", 8, "cuda", 512, 6, "sparse@0.25"))
    assert sp["impl"] == "cuda"
    assert sp["blocks"] == {"block_w": 64, "grid_order": "wq"}
    # the file format is the reference's: its parser reads it verbatim
    rback = RefTable.from_json(path.read_text())
    assert rback.get(("chor", 64, "ref", 512, 6, "mask")) == hit


def test_autotune_table_version_guard():
    with pytest.raises(ValueError, match="version"):
        AutotuneTable.from_json('{"version": 99, "entries": []}',
                                device="cpu")


def test_autotune_merge_drops_and_counts_foreign_devices():
    local = _table()
    k_here = ("chor", 64, "ref", 512, 6, "mask")
    k_there = ("chor", 128, "ref", 512, 6, "mask")
    incoming = _table()
    incoming.put(k_here, "fold", impl="ref", source="measured")
    incoming.put(
        k_there, "parity", impl="cuda", source="measured",
        device={"platform": "cuda", "device_kind": "NVIDIA H9000"},
    )
    dropped = local.update(incoming)
    assert dropped == 1 and local.dropped == 1
    assert local.get(k_here) is not None and local.get(k_there) is None
    # the roundtrip keeps foreign entries verbatim; only the merge filters
    back = AutotuneTable.from_json(incoming.to_json(), device="cpu")
    assert back.get(k_there)["device"]["device_kind"] == "NVIDIA H9000"
    assert back.update(_table()) == 0  # the filter is one-directional


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_a_table_written_by_the_other_package_is_dropped(tmp_path, direction):
    """Each package fingerprints its own device: a table the JAX package
    measured on this very host is dropped and counted by the port, and
    the port's by the JAX package — never merged."""
    path = str(tmp_path / "other.json")
    key = ("chor", 64, "ref", 128, 2, "mask")
    if direction == "jax_to_torch":
        rtable = RefTable()
        rtable.put(key, "fold", impl="ref", source="measured",
                   us={"fold/ref": 1.0, "parity/ref": 2.0},
                   store_shape=(128, 2))
        ref_backend.dump_autotune(path, rtable)
        assert json.loads(open(path).read())["entries"][0]["device"] != CPU_FP
        backend = ShardedBackend(_store(128, 8, seed=1), autotune=_table(),
                                 autotune_file=path, device="cpu")
        assert backend.autotune_dropped == 1
        assert len(backend.planner.table) == 0
        merged = load_autotune(path, _table())
        assert merged.dropped == 1 and len(merged) == 0
    else:
        table = _table()
        table.put(key, "fold", impl="ref", source="measured",
                  store_shape=(128, 2))
        dump_autotune(path, table)
        rtable = ref_backend.load_autotune(path, RefTable())
        assert rtable.dropped == 1 and len(rtable) == 0


def test_sharded_backend_autotune_file_cold_start_and_save(tmp_path):
    store = _store(128, 8, seed=1)
    path = str(tmp_path / "at.json")
    backend = ShardedBackend(store, autotune=_table(), autotune_file=path,
                             device="cpu")  # missing: a cold start
    assert backend.autotune_dropped == 0
    backend.planner.table.put(
        ("chor", 64, "ref", 128, 2, "mask"), "fold", impl="ref",
        source="measured", us={"fold/ref": 1.0, "parity/ref": 2.0},
    )
    assert backend.save_autotune() == path
    # a second backend warm-starts from the dumped decisions
    warm = ShardedBackend(store, autotune=_table(), autotune_file=path,
                          device="cpu")
    assert warm.planner.table.get(
        ("chor", 64, "ref", 128, 2, "mask"))["path"] == "fold"
    with pytest.raises(ValueError, match="no autotune_file"):
        ShardedBackend(store, autotune=_table(), device="cpu").save_autotune()


def test_sharded_backend_autotune_file_foreign_entries_dropped(tmp_path):
    store = _store(128, 8, seed=1)
    path = str(tmp_path / "foreign.json")
    foreign = _table()
    foreign.put(
        ("chor", 64, "ref", 128, 2, "mask"), "parity", impl="cuda",
        source="measured",
        device={"platform": "cuda", "device_kind": "NVIDIA H9000"},
    )
    foreign.dump(path)
    backend = ShardedBackend(store, autotune=_table(), autotune_file=path,
                             device="cpu")
    assert backend.autotune_dropped == 1
    assert len(backend.planner.table) == 0


def test_autotune_merge_drops_and_counts_foreign_shapes():
    incoming = _table()
    k_same = ("chor", 64, "ref", 128, 2, "mask")
    k_resized = ("chor", 64, "ref", 256, 2, "mask")
    k_legacy = ("chor", 32, "ref", 128, 2, "mask")
    incoming.put(k_same, "fold", impl="ref", source="measured",
                 store_shape=(128, 2))
    incoming.put(k_resized, "parity", impl="ref", source="measured",
                 store_shape=(256, 2))
    incoming.put(k_legacy, "fold", impl="ref", source="measured")
    local = _table()
    dropped = local.update(incoming, store_shape=(128, 2))
    assert dropped == 1 and local.dropped == 1
    assert local.get(k_same) is not None
    assert local.get(k_legacy) is not None  # unstamped: passes
    assert local.get(k_resized) is None
    back = AutotuneTable.from_json(incoming.to_json(), device="cpu")
    assert back.get(k_same)["store_shape"] == [128, 2]
    assert _table().update(incoming) == 0  # no wanted shape: device only


def test_sharded_backend_autotune_file_survives_same_shape_restart(tmp_path):
    store = _store(128, 8, seed=1)
    path = str(tmp_path / "stamped.json")
    backend = ShardedBackend(store, autotune=_table(), autotune_file=path,
                             device="cpu")
    key = ("chor", 64, "ref", store.n, store.words, "mask")
    backend.planner.table.put(
        key, "fold", impl="ref", source="measured",
        store_shape=(store.n, store.words),
    )
    backend.save_autotune()
    same = ShardedBackend(store, autotune=_table(), autotune_file=path,
                          device="cpu")
    assert same.autotune_dropped == 0
    assert same.planner.table.get(key)["path"] == "fold"
    resized = ShardedBackend(_store(256, 8, seed=1), autotune=_table(),
                             autotune_file=path, device="cpu")
    assert resized.autotune_dropped == 1
    assert len(resized.planner.table) == 0


def test_tables_are_local_to_a_device_and_the_default_is_the_card():
    """``device=None`` means the card: without one a table cannot be made
    (the device rule); the process table is one per device."""
    assert autotune_table("cpu") is autotune_table(torch.device("cpu"))
    assert autotune_table("cpu").fingerprint == CPU_FP
    assert CPU_FP["platform"] == "cpu"
    assert CPU_FP != ref_backend.device_fingerprint()
    assert KernelPlanner(_store(16, 4)).table is autotune_table("cpu")
    if not torch.cuda.is_available():
        for make in (AutotuneTable, autotune_table,
                     lambda: device_fingerprint()):
            with pytest.raises(RuntimeError, match="CUDA"):
                make()


# ------------------------------------------------------------ plan decisions
def test_autotune_families_never_collide():
    """A sparse decision cached in the table is never handed back as a
    dense one for the same (scheme, bucket, n, words): θ 0.25 gathers on
    this store, θ 0.49's budget crosses the dense cutoff, through one
    table."""
    store = _store(128, 8, seed=11)
    planner = KernelPlanner(store, backend="cuda", table=_table())
    gathery = make_scheme("sparse", d=4, d_a=2, theta=0.25).staged
    plan_a = planner.plan(_wire(0.25), 2, scheme=gathery)
    assert plan_a.family == "sparse"
    densy = make_scheme("sparse", d=4, d_a=2, theta=0.49).staged
    plan_b = planner.plan(_wire(0.49), 2, scheme=densy)
    assert plan_b.path in ("fold", "parity") and plan_b.m_budget is None
    keys = set(planner.pending())
    assert {k[5] for k in keys} == {"sparse@0.25", "mask"}
    planner.tune_pending()
    mask = torch.from_numpy(seeded_mask(2, store.n, 2))
    for sch, wire in ((gathery, _wire(0.25)), (densy, _wire(0.49))):
        plan = planner.plan(wire, 2, scheme=sch)
        assert plan.source == "measured"
        assert torch.equal(plan(mask), ref.xor_fold_ref(store.packed, mask))


def test_plan_never_measures_on_request_path():
    store = _store(200, 8, seed=4)
    sch = make_scheme("chor", d=2, d_a=1).staged
    measure, calls = _counting_measure()
    planner = KernelPlanner(store, table=_table(), measure=measure)
    cold = planner.plan(_wire(), 64, scheme=sch)
    assert cold.source == "model"
    assert calls == []  # nothing was timed inline
    key = planner._table_key("chor", 64, "ref")
    assert planner.pending() == (key,)
    assert planner.table.get(key) is None  # priors are not table entries
    # the key is the reference's, field for field
    rplanner = RefPlanner(ref_make_store(200, 8, seed=4), table=RefTable())
    assert rplanner._table_key("chor", 64, "ref") == key


def test_tune_step_measures_all_candidates_and_replan_uses_winner():
    store = _store(200, 8, seed=4)
    sch = make_scheme("chor", d=2, d_a=1).staged
    measure, calls = _counting_measure()
    planner = KernelPlanner(store, table=_table(), measure=measure)
    planner.plan(_wire(), 64, scheme=sch)
    assert planner.tune_step() == 1
    assert planner.pending() == ()
    key = planner._table_key("chor", 64, "ref")
    entry = planner.table.get(key)
    assert entry["source"] == "measured"
    assert entry["device"] == CPU_FP
    assert entry["store_shape"] == [store.n, store.words]
    assert set(entry["us"]) == {"fold/ref", "parity/ref"}
    assert {c.path for c in calls} == {"fold", "parity"}
    assert entry["path"] == calls[0].path
    warm = planner.plan(_wire(), 64, scheme=sch)
    assert warm.source == "measured" and warm.path == entry["path"]
    assert len(calls) == 2 and planner.pending() == ()


def test_autotune_search_deterministic_under_fixed_seed():
    """Same planner seed, same cells, same timer ⇒ identical bench
    payloads, candidate order, labels and recorded winner; another seed
    draws another payload."""
    store = _store(256, 16, seed=2)
    sch = make_scheme("sparse", d=2, d_a=1, theta=0.25).staged
    runs = []
    for seed in (7, 7, 8):
        seen = []

        def measure(fn, payload, candidate=None, seen=seen):
            seen.append((candidate.label, int(payload.sum()),
                         tuple(payload.shape), payload.dtype))
            return float(len(seen))

        planner = KernelPlanner(store, backend="cuda", table=_table(),
                                seed=seed, measure=measure)
        planner.plan(_wire(0.25), 8, scheme=sch)
        planner.tune_pending()
        entry = planner.table.get(
            planner._table_key("sparse", 8, "cuda", 0.25))
        runs.append((seen, entry["path"], entry["blocks"], entry["us"]))
    assert runs[0] == runs[1]
    assert [s[0] for s in runs[2][0]] == [s[0] for s in runs[0][0]]
    assert runs[2][0][0][1] != runs[0][0][0][1]
    assert runs[0][0][0][2:] == ((8, store.n), torch.uint8)


def test_auto_on_the_card_races_kernels_only_and_never_regresses():
    """Under ``auto`` resolving to the kernels the search races kernel
    candidates only — the plain gather is the oracle, not a contestant
    (a deliberate difference from the reference, whose ``auto`` adds it).
    Slowing the prior's own choice makes the recorded winner, and the
    re-planned executor, another kernel form, bit-identically: a measured
    plan never loses to the prior's."""
    store = _store(256, 16, seed=2)
    sch = make_scheme("sparse", d=2, d_a=1, theta=0.25).staged
    planner = KernelPlanner(store, backend="auto", table=_table())
    planner.backend = _StubAuto()
    cold = planner.plan(_wire(0.25), 8, scheme=sch)
    assert cold.impl == "cuda" and cold.source == "model"
    prior = PlanCandidate(cold.path, cold.impl, cold.blocks).label

    def slow_prior(fn, *args, candidate=None):
        return 10_000.0 if candidate.label == prior else 1.0

    planner._measure = slow_prior
    planner.tune_pending()
    entry = planner.table.get(planner._table_key("sparse", 8, "cuda", 0.25))
    assert entry["impl"] == "cuda" and entry["path"] != "sparse_ref"
    assert all(lbl.split("+")[0].endswith("/cuda") for lbl in entry["us"])
    assert prior in entry["us"] and entry["us"][prior] == 10_000.0
    winner = PlanCandidate(entry["path"], entry["impl"],
                           tuple(sorted(entry["blocks"].items()))).label
    assert winner != prior and entry["us"][winner] == min(
        entry["us"].values())
    warm = planner.plan(_wire(0.25), 8, scheme=sch)
    assert (warm.impl, warm.source) == ("cuda", "measured")
    mask = torch.from_numpy(seeded_mask(8, store.n, 5, p=0.25))
    assert torch.equal(warm(mask), ref.xor_fold_ref(store.packed, mask))
    # a plain winner recorded under the kernel key (an older table, or
    # the reference's race) is not trusted: the cell re-plans from the
    # prior and queues a search
    key = planner._table_key("sparse", 8, "cuda", 0.25)
    planner.table.put(key, "sparse_ref", impl="ref", source="measured",
                      device=CPU_FP, store_shape=(store.n, store.words))
    planner.invalidate()
    again = planner.plan(_wire(0.25), 8, scheme=sch)
    assert (again.impl, again.source) == ("cuda", "model")
    assert planner.pending() == (key,)


def test_sparse_search_space_covers_blocks_and_grid_orders():
    """The sparse search space is (fused vs pair) × block_w × grid_order;
    a winner timed on the real clock stays bit-identical to the plain
    fold whatever point it lands on."""
    store = _store(256, 16, seed=2)
    sch = make_scheme("sparse", d=2, d_a=1, theta=0.25).staged
    planner = KernelPlanner(store, backend="cuda", table=_table())
    planner.plan(_wire(0.25), 4, scheme=sch)
    assert planner.tune_pending() == 1
    entry = planner.table.get(planner._table_key("sparse", 4, "cuda", 0.25))
    fused = [l for l in entry["us"] if l.startswith("sparse_fused")]
    pair = [l for l in entry["us"] if l.startswith("sparse_pair")]
    assert fused and pair
    assert any("grid_order=qw" in l for l in fused)
    assert any("grid_order=wq" in l for l in fused)
    assert any("grid_order=qwm" in l for l in pair)
    assert any("grid_order=wqm" in l for l in pair)
    assert all(v > 0 for v in entry["us"].values())
    warm = planner.plan(_wire(0.25), 4, scheme=sch)
    assert warm.source == "measured"
    mask = torch.from_numpy(seeded_mask(4, store.n, 3, p=0.25))
    assert torch.equal(warm(mask), ref.xor_fold_ref(store.packed, mask))


# port label -> reference label: the kernel impl is named for its device
def _ref_label(label):
    return label.replace("/cuda", "/pallas")


@pytest.mark.parametrize("n_eff,rb,budget,k_max,backend", [
    (256, 16, None, None, "cuda"),     # fused at full and half width
    (256, 16, None, 4, "cuda"),        # + the fused multi form
    (2048, 64, 70_000, None, "auto"),  # a narrower slab, kernels only
    (2048, 64, 1, None, "cuda"),       # the gate shut: pair alone
    (7264, 1536, None, None, "cuda"),  # the widest slab at the CT record
    (10_000, 1536, None, None, "auto"),  # the CT record: no fused form
    (10**6, 1536, None, 4, "auto"),    # the CT scale, a multi bucket
    (128, 8, None, None, "ref"),       # the plain gather alone
])
def test_candidate_set_equals_the_reference(n_eff, rb, budget, k_max,
                                            backend):
    """The port's search space is the reference's, label for label, under
    the same on-chip budget. That budget differs by design: the gate that
    admits the fused forms is the card's shared memory (232 448 B a
    block), not the reference's VMEM. At the CT record (384 words) it
    admits a slab of n ≤ 7264 records, so a sparse cell at the CT record
    and n = 10 000 — or at the CT scale, n = 10⁶ — races the streaming
    pair and the plain gather only, where the reference's own budget
    races the fused forms at n = 10 000 too."""
    port_impl, ref_impl = {"cuda": ("cuda", "pallas"),
                           "auto": ("cuda", "pallas"),
                           "ref": ("ref", "ref")}[backend]
    kw = dict(n_eff=n_eff, m_budget=ops.sparse_index_budget(n_eff, 0.25),
              k_max=k_max)
    planner = KernelPlanner(_store(64, rb), backend=backend, table=_table(),
                            smem_budget_bytes=budget)
    if backend == "auto":
        planner.backend = _StubAuto()
    got = [c.label for c in planner._candidates(TuneCell(
        "sparse", 8, port_impl, 0.25, **kw))]
    ref_name = "pallas" if backend == "cuda" else backend

    def ref_labels(vmem):
        rplanner = RefPlanner(ref_make_store(64, rb), backend=ref_name,
                              table=RefTable(), vmem_budget_bytes=vmem)
        if backend == "auto":
            rplanner.backend = types.SimpleNamespace(
                name="auto", resolve=lambda: "pallas")
        return [c.label for c in rplanner._candidates(ref_backend.TuneCell(
            "sparse", 8, ref_impl, 0.25, **kw))]

    want = ref_labels(budget if budget is not None else 232_448)
    if backend == "auto":
        # the deliberate difference: the port's ``auto`` never races the
        # plain gather on the card
        assert want[-1] == "sparse_ref/ref"
        want = want[:-1]
    assert [_ref_label(l) for l in got] == want
    fused = [l for l in got if "fused" in l]
    if rb == 1536:
        assert bool(fused) == (n_eff <= 7264)
    if rb == 1536 and n_eff > 7264:
        assert [l for l in got if "multi" not in l] == [
            "sparse_pair/cuda+block_w=128+grid_order=qwm",
            "sparse_pair/cuda+block_w=128+grid_order=wqm",
            "sparse_pair/cuda+block_w=32+grid_order=qwm",
            "sparse_pair/cuda+block_w=32+grid_order=wqm",
        ]
        if n_eff == 10_000:  # the reference's own budget differs here
            assert any("fused" in l for l in ref_labels(None))
    dense = [c.label for c in planner._candidates(TuneCell(
        "chor", 8, port_impl, None, n_eff, None))]
    assert dense == [f"fold/{port_impl}", f"parity/{port_impl}"]


def test_bench_payload_is_a_uint8_mask_of_the_cells_density():
    store = _store(4096, 8)
    planner = KernelPlanner(store, table=_table(), seed=3)
    dense = TuneCell("chor", 16, "ref", None, store.n, None)
    sparse_cell = TuneCell("sparse", 16, "ref", 0.1, store.n,
                           ops.sparse_index_budget(store.n, 0.1))
    for cell, want in ((dense, 0.5), (sparse_cell, 0.12)):
        key = planner._table_key(cell.scheme, 16, "ref", cell.theta)
        m = planner._bench_payload(key, cell)
        assert m.dtype == torch.uint8 and m.shape == (16, store.n)
        assert set(torch.unique(m).tolist()) <= {0, 1}
        assert abs(m.float().mean().item() - want) < 0.02
        assert torch.equal(m, planner._bench_payload(key, cell))
    gen = torch.Generator().manual_seed(0)
    assert int(_bench_mask(gen, 4, 100, 0.0).sum()) > 0  # at least 1/256


def test_measure_us_warms_up_then_takes_the_best_of_three():
    calls = []
    us = _measure_us(lambda x: calls.append(x) or x, torch.zeros(3),
                     candidate=PlanCandidate("fold", "ref"))
    assert len(calls) == 4 and 0 <= us < 1e6


def test_pipeline_autotune_step_runs_in_idle_time():
    """``ServingPipeline.autotune_step`` is the idle-time hook: requests
    plan from the prior, the hook measures, the next batch plans from the
    table — with the same records."""
    store = _store(256, 16, seed=9)
    sch = make_scheme("chor", d=2, d_a=1)
    measure, calls = _counting_measure()
    backend = ShardedBackend(store, autotune=_table(), device="cpu")
    backend.planner._measure = measure
    pipe = ServingPipeline(store, sch, backend=backend, device="cpu")
    pipe.submit("a", 7)
    assert (pipe.flush()["a"] == store.record_bytes(7)).all()
    assert calls == [] and len(backend.planner.pending()) == 1
    assert pipe.autotune_step() == 1 and pipe.autotune_step() == 0
    assert backend.tune_pending() == 0
    pipe.submit("a", 9)
    assert (pipe.flush()["a"] == store.record_bytes(9)).all()
    plan = next(iter(backend.planner._plans.values()))
    assert plan.source == "measured"


def test_shard_answer_fn_answers_a_shard_of_the_store():
    """The plan's answer function takes any operand: two shards' partial
    answers XOR to the whole store's, as the reference's mesh combines
    them."""
    store = _store(512, 24, seed=3)
    sch = make_scheme("sparse", d=4, d_a=2, theta=0.25).staged
    plan = KernelPlanner(store, backend="cuda", table=_table()).plan(
        _wire(0.25), 8, scheme=sch)
    fn = shard_answer_fn(plan)
    mask = torch.from_numpy(seeded_mask(8, store.n, 1, p=0.25))
    half = store.n // 2
    got = fn(store.packed[:half], mask[:, :half]) ^ fn(
        store.packed[half:], mask[:, half:])
    assert torch.equal(got, plan(mask))
    with pytest.raises(ValueError, match="direct"):
        shard_answer_fn(KernelPlanner(store, table=_table()).plan(
            types.SimpleNamespace(kind="index", theta=None), 8))


# ------------------------------------------------------------- write path
@pytest.mark.parametrize("backend", ["auto", "cuda", "ref"])
def test_scatter_update_never_races_its_plain_version(monkeypatch, backend):
    """The write path has one candidate per backend: ``auto`` and ``cuda``
    resolving to the kernel call the scatter kernel's wrapper on every
    update, ``ref`` the plain version; nothing is measured and nothing
    lands in the autotune table (the reference's ``_ingest`` race is not
    ported)."""
    monkeypatch.setitem(backend_mod._BACKENDS, "auto", _StubAuto())
    db = _store(64, 8, seed=2).packed
    rows = torch.tensor([3, 9, 40, 9], dtype=torch.int32)
    vals = torch.arange(4 * db.shape[1], dtype=torch.int32).reshape(4, -1)
    want = ref.scatter_rows_ref(db, rows, vals)
    calls = []
    real = backend_mod.scatter_rows

    def counting(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(backend_mod, "scatter_rows", counting)
    before = len(autotune_table(db.device))
    for m in (4, 1):
        assert torch.equal(scatter_update(db, rows[:m], vals[:m],
                                          backend=backend),
                           ref.scatter_rows_ref(db, rows[:m], vals[:m]))
    assert len(calls) == (0 if backend == "ref" else 2)
    assert torch.equal(scatter_update(db, rows, vals, backend=backend), want)
    assert len(autotune_table(db.device)) == before


def test_a_measured_plan_answers_the_reference_payload_bit_for_bit():
    """Whatever the search recorded, the measured plan answers the
    reference's own routed Sparse-PIR payload exactly as the reference's
    planner does."""
    n, rb = 2048, 64
    rstore = ref_make_store(n, rb, seed=4)
    tstore = _store(n, rb, seed=4)
    rsch = ref_make_scheme("sparse", d=4, d_a=2, theta=0.25).staged
    rq = RefRouter(rsch).plan(jax.random.key(2), n, jnp.arange(8) * 7)
    rplan = RefPlanner(rstore, backend="ref", table=RefTable()).plan(
        rq, 8, None, scheme=rsch)
    planner = KernelPlanner(tstore, backend="cuda", table=_table())
    sch = make_scheme("sparse", d=4, d_a=2, theta=0.25).staged
    planner.plan(_wire(0.25), 8, scheme=sch)
    planner.tune_pending()
    plan = planner.plan(_wire(0.25), 8, scheme=sch)
    assert plan.source == "measured"
    for pos in range(4):
        mask = np.array(rq.payload[pos])
        np.testing.assert_array_equal(
            words_t2n(plan(torch.from_numpy(mask))),
            np.asarray(rplan(rq.payload[pos])))


@pytest.mark.parametrize("scheme,extra", [
    ("subset", ["--t", "3"]), ("as-direct", ["--p", "5", "--u", "100"]),
])
def test_launcher_keeps_its_autotune_file_and_caches(tmp_path, capsys,
                                                     scheme, extra):
    """``launch/serve.py --autotune-file`` tunes what is pending at exit and
    writes the table; a second run loads it and has nothing left to tune.
    ``--cache-entries`` attaches the cache and reports its counters."""
    from repro_torch.launch import serve

    path = str(tmp_path / "at.json")
    argv = ["--device", "cpu", "--scheme", scheme, "--n", "256",
            "--record-bytes", "16", "--d", "5", "--da", "2", "--queries",
            "24", "--batch", "8", "--cache-entries", "64",
            "--autotune-file", path] + extra
    import re

    tuned = re.compile(r"\((\d+) entries, (\d+) tuned at exit\)")
    serve.main(argv)
    first = capsys.readouterr().out
    assert first.count("verified exact") == 3
    assert re.search(r"^cache: \d+ hits, \{'hits'", first, re.M)
    entries = json.loads(open(path).read())["entries"]
    assert all(e["device"] == CPU_FP for e in entries)
    # the dense cells of this scheme were tuned at exit; the direct
    # family's index kind has none (the table is the process's)
    mine = [e for e in entries if e["scheme"] == scheme]
    assert len(mine) == (0 if scheme == "as-direct" else 1)
    assert tuned.search(first).groups() == (str(len(entries)),
                                            str(len(mine)))
    serve.main(argv)
    assert tuned.search(capsys.readouterr().out).group(2) == "0"
