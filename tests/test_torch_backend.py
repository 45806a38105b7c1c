"""Port vs reference: the execution planner's decisions and every branch of
the path→kernel dispatch (tolerance zero).

The reference planner is given ``backend="pallas"`` (its kernel impl) and
the same on-chip budget override; the port's kernel impl is ``cuda``. The
one decision the two may differ on is the *unforced* fold/parity choice:
the reference's crossover is a model of another chip, the port's is
measured on the card — so the grid compares that choice forced, or below
both crossovers."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_scheme as ref_make_scheme
from repro.db import make_synthetic_store as ref_make_store
from repro.kernels import AutotuneTable as RefTable
from repro.kernels import KernelPlanner as RefPlanner
from repro.kernels import backend as ref_backend
from repro_torch.core import make_scheme
from repro_torch.db import make_synthetic_store
from repro_torch.kernels import KernelPlanner, get_backend, ops, registered_backends
from repro_torch.kernels import backend as backend_mod
from repro_torch.kernels.backend import AutotuneTable, ExecutionPlan, _path_answer_fn

from _torch_parity import seeded_mask, words_t2n

IMPL = {"pallas": "cuda", "ref": "ref"}

PLAN_GRID = [
    # (scheme, kw, bucket, n, rb, parity_min_batch, budget override)
    ("sparse", dict(theta=0.25), 8, 2048, 64, None, None),
    ("sparse", dict(theta=0.25), 8, 2048, 64, None, 1),         # gate shut
    ("sparse", dict(theta=0.25), 8, 2048, 64, None, 70_000),    # narrower bw
    ("sparse", dict(theta=0.25), 64, 2048, 64, 8, None),        # forcing n/a
    ("sparse", dict(theta=0.25), 1, 512, 24, None, None),
    ("sparse", dict(theta=0.25), 16, 300, 50, None, 232_448),
    ("sparse", dict(theta=0.5), 8, 512, 24, None, None),        # θ=.5: dense
    ("sparse", dict(theta=0.45), 8, 64, 8, None, None),         # slack > n
    ("sparse", dict(theta=0.05), 4, 10_000, 16, None, 232_448),
    ("chor", {}, 8, 2048, 64, None, None),
    ("chor", {}, 64, 2048, 64, None, None),
    ("chor", {}, 128, 2048, 64, 128, None),
    ("chor", {}, 64, 2048, 64, 128, None),
    ("chor", {}, 16, 128, 8, 8, None),
    ("chor", {}, 4, 128, 8, 8, None),
]


def _wire(kw):
    return types.SimpleNamespace(kind="mask", theta=kw.get("theta"))


def _plans(name, kw, bucket, n, rb, pmin, budget, ref_backend_name="pallas"):
    rstore = ref_make_store(n, rb, seed=0)
    tstore = make_synthetic_store(n, rb, seed=0, device="cpu")
    rplan = RefPlanner(
        rstore, backend=ref_backend_name, table=RefTable(),
        parity_min_batch=pmin,
        # the reference derives its default budget from its own host; give
        # both the port's default so the gate sees one number
        vmem_budget_bytes=budget if budget is not None else 232_448,
    ).plan(_wire(kw), bucket, None,
           scheme=ref_make_scheme(name, d=4, d_a=2, **kw).staged)
    tplan = KernelPlanner(
        tstore, backend=IMPL[ref_backend_name], parity_min_batch=pmin,
        smem_budget_bytes=budget,
    ).plan(_wire(kw), bucket, scheme=make_scheme(name, d=4, d_a=2, **kw).staged)
    return rplan, tplan


@pytest.mark.parametrize("name,kw,bucket,n,rb,pmin,budget", PLAN_GRID)
def test_plan_decisions_equal_reference(name, kw, bucket, n, rb, pmin, budget):
    rplan, tplan = _plans(name, kw, bucket, n, rb, pmin, budget)
    assert (tplan.path, tplan.source, tplan.m_budget, tplan.blocks) == (
        rplan.path, rplan.source, rplan.m_budget, rplan.blocks)
    assert tplan.impl == IMPL[rplan.impl]
    assert (tplan.bucket, tplan.n, tplan.theta, tplan.family) == (
        rplan.bucket, rplan.n, rplan.theta, rplan.family)


@pytest.mark.parametrize("name,kw,bucket,n,rb,pmin,budget", PLAN_GRID[:3] + PLAN_GRID[9:12])
def test_ref_backend_decisions_equal_reference(name, kw, bucket, n, rb, pmin,
                                               budget):
    rplan, tplan = _plans(name, kw, bucket, n, rb, pmin, budget, "ref")
    assert (tplan.path, tplan.impl, tplan.source, tplan.m_budget) == (
        rplan.path, rplan.impl, rplan.source, rplan.m_budget)


def test_auto_resolves_by_the_stores_device():
    auto = get_backend("auto")
    assert auto.resolve(torch.device("cpu")) == "ref"
    assert auto.resolve(torch.device("cuda")) == "cuda"
    assert get_backend("cuda").resolve(torch.device("cpu")) == "cuda"
    assert get_backend("REF").resolve(torch.device("cuda")) == "ref"
    assert registered_backends() == ("auto", "cuda", "ref")


def test_unknown_backend_raises():
    store = make_synthetic_store(16, 4, device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        KernelPlanner(store, backend="pallas")
    with pytest.raises(ValueError, match="already registered"):
        backend_mod.register_backend("ref")(type("X", (), {}))


def test_unforced_fold_parity_choice_follows_the_measured_crossover():
    store = make_synthetic_store(256, 8, device="cpu")
    sch = make_scheme("chor", d=2, d_a=1).staged
    qstar = ops.parity_crossover_batch(store.n, store.record_bits)
    planner = KernelPlanner(store, backend="cuda")
    for bucket in (1, 8, 128, 1024):
        plan = planner.plan(_wire({}), bucket, scheme=sch)
        assert plan.path == ("parity" if bucket >= qstar else "fold")
        assert plan.source == "model"


@pytest.mark.parametrize("bucket,port_path", [(32, "fold"), (64, "fold"),
                                              (128, "fold")])
def test_unforced_chor_at_ct_scale_departs_from_the_reference(bucket,
                                                              port_path):
    """At n = 10^6 the fold beats parity at every bucket on the card (the
    port's measured crossover is "never"), the reference's modelled one is
    128 (ROADMAP Queue C): an unforced chor bucket of 128 plans fold in the
    port and parity in the reference; 32 and 64 plan alike. The answers
    are the same bits either way."""
    rplan, tplan = _plans("chor", {}, bucket, 10**6, 4, None, None)
    assert ops.parity_crossover_batch(10**6, 32) == ops.PARITY_NEVER_WINS
    assert tplan.path == port_path and tplan.source == "model"
    assert rplan.path == ("parity" if bucket >= 128 else "fold")


def test_plans_are_cached_per_cell():
    store = make_synthetic_store(512, 24, device="cpu")
    sch = make_scheme("sparse", d=4, d_a=2, theta=0.25).staged
    planner = KernelPlanner(store, backend="cuda")
    wire = _wire(dict(theta=0.25))
    a = planner.plan(wire, 8, scheme=sch)
    assert planner.plan(wire, 8, scheme=sch) is a
    assert planner.metrics["plans_built"] == 1
    b = planner.plan(wire, 16, scheme=sch)
    assert b is not a and planner.metrics["plans_built"] == 2
    assert isinstance(a, ExecutionPlan) and "sparse" in a.describe()


def test_planes_are_built_lazily_and_once():
    store = make_synthetic_store(128, 8, device="cpu")
    sch = make_scheme("chor", d=2, d_a=1).staged
    planner = KernelPlanner(store, backend="cuda", parity_min_batch=4)
    plan = planner.plan(_wire({}), 8, scheme=sch)
    assert plan.path == "parity"
    assert planner.metrics["precompute_full_builds"] == 0  # planning is free
    mask = torch.from_numpy(seeded_mask(8, 128, 0))
    out = plan(mask)
    plan(mask)
    assert planner.metrics["precompute_full_builds"] == 1
    assert planner.planes().dtype == torch.uint8
    assert torch.equal(out, ops.server_answer_fold(store.packed, mask))


def test_direct_family_is_not_ported_yet():
    """The name predates the port of the direct family; the ``index`` wire
    kind now plans the reference's decision-only ``direct`` path."""
    store = make_synthetic_store(16, 4, device="cpu")
    wire = types.SimpleNamespace(kind="index", theta=None)
    sch = make_scheme("direct", d=2, d_a=1, p=4).staged
    plan = KernelPlanner(store, table=AutotuneTable(device="cpu")).plan(
        wire, 4, scheme=sch)
    rplan = RefPlanner(ref_make_store(16, 4, seed=0), table=RefTable()).plan(
        wire, 4, None, scheme=ref_make_scheme("direct", d=2, d_a=1, p=4).staged)
    assert (plan.path, plan.source, plan.m_budget, plan.blocks) == (
        rplan.path, rplan.source, rplan.m_budget, rplan.blocks) == (
        "direct", "only", None, ())
    assert plan.run is None and plan.family == "direct"
    with pytest.raises(RuntimeError, match="decision only"):
        plan(torch.zeros((4, 2), dtype=torch.int32))


BRANCHES = [
    ("fold", "ref", None, {}),
    ("fold", "kernel", None, {}),
    ("parity", "ref", None, {}),
    ("parity", "kernel", None, {}),
    ("sparse_ref", "ref", 96, {}),
    ("sparse_pair", "kernel", 96, {}),
    ("sparse_pair", "kernel", 96, {"block_w": 8, "grid_order": "wqm"}),
    ("sparse_pair", "kernel", 20, {}),          # budget below the row weight
    ("sparse_fused", "kernel", 96, {"block_w": 8, "grid_order": "qw"}),
    ("sparse_fused", "kernel", 96, {"block_w": 4, "grid_order": "wq"}),
    ("sparse_fused", "kernel", 20, {"block_w": 8}),
]


@pytest.mark.parametrize("path,impl,m_budget,blocks", BRANCHES)
def test_path_answer_fn_branch_equals_reference(path, impl, m_budget, blocks):
    n, rb, q = 211, 21, 6
    rstore = ref_make_store(n, rb, seed=4)
    tstore = make_synthetic_store(n, rb, seed=4, device="cpu")
    mask = seeded_mask(q, n, seed=8, p=0.3)
    rimpl, timpl = ("ref", "ref") if impl == "ref" else ("pallas", "cuda")
    rfn = ref_backend._path_answer_fn(path, rimpl, m_budget, True, dict(blocks))
    tfn = _path_answer_fn(path, timpl, m_budget, dict(blocks))
    if path == "parity":
        want = rfn(rstore.bitplanes(), jnp.asarray(mask))
        got = tfn(tstore.bitplanes(), torch.from_numpy(mask))
    else:
        want = rfn(rstore.packed, jnp.asarray(mask))
        got = tfn(tstore.packed, torch.from_numpy(mask))
    np.testing.assert_array_equal(words_t2n(got), np.asarray(want))


def test_path_answer_fn_rejects_unknown_paths():
    for path in ("nope", "sparse_multi", "direct"):
        with pytest.raises(ValueError, match="no kernel form"):
            _path_answer_fn(path, "cuda", None, {})


def test_plan_operand_is_an_argument_not_a_closure():
    """run() reads the planner's current store per call and kernel() takes
    the operand explicitly, so a plan outlives a store swap."""
    a = make_synthetic_store(64, 8, seed=1, device="cpu")
    b = make_synthetic_store(64, 8, seed=2, device="cpu")
    planner = KernelPlanner(a, backend="cuda")
    plan = planner.plan(_wire({}), 4, scheme=make_scheme("chor", d=2, d_a=1).staged)
    mask = torch.from_numpy(seeded_mask(4, 64, 3))
    on_a = plan(mask)
    assert torch.equal(plan(mask, operand=b.packed),
                       ops.server_answer_fold(b.packed, mask))
    planner.store = b
    assert torch.equal(plan(mask), ops.server_answer_fold(b.packed, mask))
    assert not torch.equal(on_a, plan(mask))
