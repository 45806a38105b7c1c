"""Port vs reference: the chor and sparse schemes (tolerance zero on bits;
accounting floats at rel_tol 1e-12).

The two packages' random streams differ by nature, so the comparison runs
on *wire payloads carried across* (the reference's ``Queries`` moved
through numpy by ``repro_torch.convert``), and the port's own draws are
held to the schemes' structural laws."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import accounting as ref_acc
from repro.core import make_scheme as ref_make_scheme
from repro.db import make_synthetic_store as ref_make_store
from repro_torch import convert
from repro_torch.core import accounting as acc
from repro_torch.core import (
    SCHEMES, build_scheme, chor, make_scheme, registered_schemes,
    scheme_param_names, sparse, staged_retrieve,
)
from repro_torch.core.protocol import Answers, ChorScheme, SparseScheme, as_protocol
from repro_torch.db import make_synthetic_store

from _torch_parity import CPU, words_t2n

SCHEME_CASES = [
    ("chor", {}, 4, 2),
    ("chor", {}, 2, 1),
    ("sparse", dict(theta=0.25), 4, 2),
    ("sparse", dict(theta=0.3), 3, 1),
    ("sparse", dict(theta=0.5), 5, 2),
]
STORE_CASES = [(128, 12), (100, 5), (333, 36)]


def _gen(seed):
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("name,kw,d,d_a", SCHEME_CASES)
@pytest.mark.parametrize("n,rb", STORE_CASES)
def test_answer_and_reconstruct_on_reference_payload(name, kw, d, d_a, n, rb):
    """(a) the reference's wire payload through the port's answer +
    reconstruct equals the reference's own, per server and in the end."""
    rstore = ref_make_store(n, rb, seed=1)
    rs = ref_make_scheme(name, d=d, d_a=d_a, **kw).staged
    q_idx = np.array([0, n // 2, n - 1, 7 % n], np.int32)
    rq = rs.query(rs.precompute(jax.random.key(3), n, 4), jnp.asarray(q_idx))
    ra = rs.answer(rstore, rq)
    want = np.asarray(rs.reconstruct(ra))

    tstore = convert.store_from_numpy(
        np.asarray(rstore.packed), rstore.record_bits, device="cpu")
    ts = build_scheme(name, d=d, d_a=d_a, **kw)
    tq = convert.queries_from_numpy(
        rq.kind, np.asarray(rq.payload), rq.servers, q_idx, rq.theta,
        device="cpu")
    ta = ts.answer(tstore, tq)
    np.testing.assert_array_equal(
        words_t2n(ta.responses), np.asarray(ra.responses))
    got = ts.reconstruct(ta)
    np.testing.assert_array_equal(words_t2n(got), want)
    np.testing.assert_array_equal(want, np.asarray(rstore.packed)[q_idx])


@pytest.mark.parametrize("name,kw,d,d_a", SCHEME_CASES)
@pytest.mark.parametrize("n,rb", STORE_CASES)
def test_own_staged_retrieve_returns_requested_records(name, kw, d, d_a, n, rb):
    """(b) the port's own four stages recover exactly the asked records."""
    store = make_synthetic_store(n, rb, seed=2, device="cpu")
    q_idx = torch.tensor([n - 1, 0, 3 % n, n // 3, n // 2], dtype=torch.int32)
    sch = make_scheme(name, d=d, d_a=d_a, **kw)
    out = sch.retrieve(_gen(5), store, q_idx)
    assert torch.equal(out, store.packed[q_idx.long()])
    out2 = staged_retrieve(as_protocol(sch), _gen(6), store, q_idx)
    assert torch.equal(out2, out)


@pytest.mark.parametrize("name,kw,d,d_a", SCHEME_CASES)
@pytest.mark.parametrize("n", [33, 64, 1000])
def test_query_matrix_xors_to_one_hot(name, kw, d, d_a, n):
    """(c) XOR over servers of the port's own request vectors is exactly
    one-hot(q_idx) — for sparse: column parity even/odd exactly."""
    ts = build_scheme(name, d=d, d_a=d_a, **kw)
    q_idx = torch.tensor([0, n - 1, n // 2, 31 % n, 32 % n], dtype=torch.int32)
    q = ts.query(ts.precompute(_gen(n), n, 5), q_idx)
    assert q.kind == "mask" and q.servers == tuple(range(d))
    assert q.payload.shape == (d, 5, n) and q.payload.dtype == torch.uint8
    assert int(q.payload.max()) <= 1
    parity = q.payload.sum(0) % 2  # XOR of {0,1} rows
    want = torch.zeros(5, n, dtype=parity.dtype)
    want[torch.arange(5), q_idx.long()] = 1
    assert torch.equal(parity, want)
    assert q.theta == kw.get("theta")


@pytest.mark.parametrize("theta,d", [(0.25, 4), (0.1, 6), (0.4, 3),
                                     (0.25, 40), (0.3, 24)])
def test_sparse_row_weight_law(theta, d):
    """(c) each server's row weight follows the parity-conditioned law:
    the mean over rows lies within 6σ of n·P[bit = 1 | even column], and
    that marginal is θ itself once (1−2θ)^(d−1) is negligible — the mean
    row weight is then within 6σ of θ·n."""
    n, b = 20_000, 4
    m = sparse.gen_query_matrix(
        _gen(11), n, d, theta, torch.zeros(b, dtype=torch.int32))
    weights = m.to(torch.float64).sum(-1)  # [d, B]
    x = (1 - 2 * theta) ** d
    p_even = theta * (1 - x / (1 - 2 * theta)) / (1 + x)  # P[bit=1 | even]
    sigma_mean = math.sqrt(n * p_even * (1 - p_even) / (d * b))
    assert abs(float(weights.mean()) - p_even * n) < 6 * sigma_mean
    if x / (1 - 2 * theta) < 1e-6:
        sigma_theta = math.sqrt(n * theta * (1 - theta) / (d * b))
        assert abs(float(weights.mean()) - theta * n) < 6 * sigma_theta


@pytest.mark.parametrize("n,rb", STORE_CASES)
@pytest.mark.parametrize("module,d,theta", [("chor", 3, None),
                                            ("sparse", 4, 0.25)])
def test_module_level_retrieve_returns_requested_records(module, d, theta, n, rb):
    """The per-scheme modules' own end-to-end reference paths."""
    store = make_synthetic_store(n, rb, seed=3, device="cpu")
    q_idx = torch.tensor([0, n - 1, n // 2], dtype=torch.int32)
    if module == "chor":
        out = chor.retrieve(_gen(2), store, d, q_idx)
    else:
        out = sparse.retrieve(_gen(2), store, d, theta, q_idx)
    assert torch.equal(out, store.packed[q_idx.long()])


@pytest.mark.parametrize("n,theta", [(10**6, 0.25), (2048, 0.1), (7, 0.5)])
def test_expected_row_weight_equals_reference(n, theta):
    from repro.core import sparse as ref_sparse

    assert sparse.expected_row_weight(n, theta) == ref_sparse.expected_row_weight(
        n, theta)


def test_sparse_weight_logits_equal_reference():
    from repro.core import sparse as ref_sparse

    for d, theta in [(4, 0.25), (100, 0.25), (7, 0.5), (3, 0.01)]:
        np.testing.assert_array_equal(
            sparse.parity_weight_logits(d, theta),
            ref_sparse.parity_weight_logits(d, theta))


def test_sparse_parity_never_violated_at_wide_d():
    """-inf logits must get probability exactly 0 (d = 100: float32
    underflow territory)."""
    pre = sparse.precompute_query_randomness(_gen(1), 4000, 100, 0.25, 2)
    assert int((pre.w_even % 2).sum()) == 0
    assert int((pre.w_q % 2).min()) == 1
    assert pre.ranks.dtype == torch.uint8
    assert torch.equal(
        pre.ranks.long().sort(-1).values,
        torch.arange(100).expand(2, 4000, 100))


def test_chor_wire_format_round_trip():
    n, d = 100, 3
    q_idx = torch.tensor([0, 31, 32, 99], dtype=torch.int32)
    packed = chor.gen_queries(_gen(2), n, d, q_idx)
    assert packed.shape == (3, 4, 4) and packed.dtype == torch.int32
    masks = chor.query_masks(packed, n)
    assert masks.shape == (3, 4, n)
    folded = chor.reconstruct(packed)  # XOR over servers, still packed
    from repro_torch.db import packing

    onehot = packing.unpack_bits(folded, n)
    assert onehot.sum().item() == 4
    assert torch.equal(onehot.argmax(-1), q_idx.long())


def test_plans_are_checked_against_the_batch():
    ts = build_scheme("chor", d=2, d_a=1)
    plan = ts.precompute(_gen(0), 64, 4)
    with pytest.raises(ValueError, match="batch"):
        ts.query(plan, torch.zeros(3, dtype=torch.int32))
    sp = build_scheme("sparse", d=2, d_a=1, theta=0.25)
    with pytest.raises(ValueError, match="batch"):
        sp.query(sp.precompute(_gen(0), 64, 4), torch.zeros(5, dtype=torch.int32))


# ------------------------------------------------------------- accounting
ACC_GRID = [(10**6, 100, 99), (10**6, 100, 50), (1000, 10, 9), (1000, 10, 5),
            (2048, 4, 2), (64, 2, 1)]


@pytest.mark.parametrize("n,d,d_a", ACC_GRID)
@pytest.mark.parametrize("theta", [0.25, 0.1, 0.5])
def test_privacy_and_costs_equal_reference(n, d, d_a, theta):
    """(d) privacy(n)/costs(n) of both schemes equal the reference's."""
    for name, kw in (("chor", {}), ("sparse", dict(theta=theta))):
        rs = ref_make_scheme(name, d=d, d_a=d_a, **kw)
        ts = make_scheme(name, d=d, d_a=d_a, **kw)
        for got, want in zip(ts.privacy(n), rs.privacy(n)):
            assert math.isclose(got, want, rel_tol=1e-12, abs_tol=0.0)
        assert ts.epsilon(n) == ts.privacy(n)[0]
        assert ts.delta(n) == ts.privacy(n)[1]
        rc, tc = rs.costs(n), ts.costs(n)
        assert rc.keys() == tc.keys()
        for k in rc:
            assert math.isclose(tc[k], rc[k], rel_tol=1e-12)


@pytest.mark.parametrize("fn,args", [
    ("epsilon_direct", (10**6, 100, 99, 1000)),
    ("epsilon_direct", (1000, 10, 5, 10)),
    ("epsilon_as_direct", (10**6, 100, 50, 1000, 1000)),
    ("epsilon_sparse", (0.25, 100, 99)),
    ("epsilon_sparse", (0.25, 10, 5)),
    ("epsilon_as_sparse", (0.25, 100, 99, 1000)),
    ("delta_subset", (100, 50, 10)),
    ("delta_subset", (10, 5, 6)),
    ("compose_with_anonymity", (2.0, 1000)),
    ("compose_with_anonymity", (300.0, 1)),
    ("theta_for_epsilon", (0.5, 100, 50)),
    ("p_for_epsilon", (1.0, 10**6, 100, 99)),
    ("users_for_target", (2.0, 0.1)),
])
def test_accounting_closed_forms_equal_reference(fn, args):
    got, want = getattr(acc, fn)(*args), getattr(ref_acc, fn)(*args)
    assert math.isclose(got, want, rel_tol=1e-12, abs_tol=0.0)


def test_accounting_dict_forms_equal_reference():
    assert acc.naive_composition_deltas(1000, 10, 50) == \
        ref_acc.naive_composition_deltas(1000, 10, 50)
    for name, kw in [("chor", {}), ("direct", dict(p=100)),
                     ("sparse", dict(theta=0.25)), ("subset", dict(t=5))]:
        assert acc.scheme_costs(name, n=10**6, d=100, **kw) == \
            ref_acc.scheme_costs(name, n=10**6, d=100, **kw)


def test_privacy_budget_arithmetic_equals_reference():
    eps = acc.epsilon_sparse(0.25, 4, 2)
    for cls in (acc.PrivacyBudget, ref_acc.PrivacyBudget):
        b = cls(epsilon_limit=2.5 * eps, delta_limit=0.1)
        assert b.can_spend(eps) and not b.can_spend(eps, 0.2)
        b.spend(eps)
        b.spend(eps, 0.05)
        assert not b.can_spend(eps)
        with pytest.raises(PermissionError):
            b.spend(eps)
        assert math.isclose(b.remaining_epsilon, 0.5 * eps, rel_tol=1e-12)
        assert math.isclose(b.spent_delta, 0.05, rel_tol=1e-12)


# --------------------------------------------------------------- registry
def test_registry_surface():
    assert registered_schemes() == ("chor", "direct", "sparse", "subset")
    assert scheme_param_names("sparse") == ("theta",)
    assert scheme_param_names("chor") == ()
    assert scheme_param_names("direct") == ("p",)
    assert scheme_param_names("subset") == ("t",)
    assert isinstance(build_scheme("chor", d=3, d_a=1, theta=0.2), ChorScheme)
    assert isinstance(
        as_protocol(make_scheme("sparse", d=3, d_a=1, theta=0.2)), SparseScheme)
    assert SparseScheme(d=3, d_a=1, theta=0.2).signature == (
        "sparse", 3, 1, ("theta", 0.2))
    assert set(SCHEMES) >= {"chor", "sparse"}


@pytest.mark.parametrize("bad", [
    dict(name="sparse", d=4, d_a=2),               # theta missing
    dict(name="sparse", d=4, d_a=2, theta=0.7),
    dict(name="chor", d=1, d_a=0),
    dict(name="chor", d=4, d_a=4),
    dict(name="nope", d=4, d_a=2),
])
def test_scheme_validation_raises_value_error(bad):
    with pytest.raises(ValueError):
        make_scheme(**bad)


@pytest.mark.parametrize("name,kw", [
    ("direct", dict(p=8)), ("subset", dict(t=3)),
    ("as-sparse", dict(theta=0.25, u=16)), ("as-direct", dict(p=8, u=16)),
])
def test_schemes_not_ported_yet_raise(name, kw):
    """The name predates the port of these schemes: each now builds
    through the facade and retrieves its records exactly, with the
    reference's (ε, δ)."""
    sch = make_scheme(name, d=4, d_a=2, **kw)
    store = make_synthetic_store(96, 20, seed=5, device="cpu")
    q = torch.tensor([0, 17, 95, 40], dtype=torch.int32)
    out = staged_retrieve(sch.staged, _gen(11), store, q)
    assert torch.equal(out, store.packed[q.long()])
    rsch = ref_make_scheme(name, d=4, d_a=2, **kw)
    assert sch.privacy(store.n) == rsch.privacy(store.n)
    assert sch.costs(store.n) == rsch.costs(store.n)


def test_convert_round_trips():
    store = make_synthetic_store(20, 9, seed=3, device="cpu")
    packed, bits = convert.store_to_numpy(store)
    assert packed.dtype == np.uint32 and bits == 72
    again = convert.store_from_numpy(packed, bits, device="cpu")
    assert torch.equal(again.packed, store.packed)
    ts = build_scheme("sparse", d=3, d_a=1, theta=0.3)
    q = ts.query(ts.precompute(_gen(0), 20, 2), torch.tensor([1, 2], dtype=torch.int32))
    fields = convert.queries_to_numpy(q)
    q2 = convert.queries_from_numpy(device="cpu", **fields)
    assert torch.equal(q2.payload, q.payload) and q2.theta == q.theta
    assert q2.servers == q.servers and torch.equal(q2.q_idx, q.q_idx)
    with pytest.raises(ValueError):
        convert.store_from_numpy(packed, 8, device="cpu")
    # the index wire kind (the direct family) round-trips too
    td = build_scheme("direct", d=2, d_a=1, p=4)
    qd = td.query(td.precompute(_gen(1), 20, 2),
                  torch.tensor([3, 19], dtype=torch.int32))
    back = convert.queries_from_numpy(device="cpu",
                                      **convert.queries_to_numpy(qd))
    assert back.kind == "index" and back.payload.dtype == torch.int32
    assert torch.equal(back.payload, qd.payload) and back.servers == (0, 1)
    with pytest.raises(ValueError, match="wire kind"):
        convert.queries_from_numpy("nope", fields["payload"], (0,), [0],
                                   device="cpu")
