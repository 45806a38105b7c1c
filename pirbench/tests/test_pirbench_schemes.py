"""Every scheme the port serves, judged by its laws
(``pirbench/schemes/<scheme>.py``): the laws' privacy against values
worked out by hand, a tiny run of each scheme, the control each law
makes fail, and faults of the timed path that only these laws catch."""

import dataclasses
import math

import pytest

from pirbench import schemes

from _tiny import run_cell, scheme_cell

TINY = {"n_records": 4096, "d": 4, "d_a": 2}
CT = {"n_records": 10**6, "d": 100, "d_a": 50}


def failed(res) -> set:
    out = set()
    for name, c in res["limits"].items():
        ok = (c["value"] <= c["limit"] if c["rule"] == "<="
              else c["value"] >= c["limit"])
        if not ok:
            out.add(name)
    return out


# ---------------------------------------------------------- known answers
@pytest.mark.parametrize("scheme, config, eps, delta", [
    ("chor", CT, 0.0, 0.0),
    # x = (1 − 2θ)^(d − d_a) = 1/4; 4·artanh(1/4) = 2·ln(5/3)
    ("sparse", dict(TINY, theta=0.25), 2 * math.log(5 / 3), 0.0),
    # x = 2^−50; artanh(x) = x to the last bit
    ("sparse", dict(CT, theta=0.25), 4 * 2.0 ** -50, 0.0),
    # Thm 5: (2/4)(1/3); (50/100)(49/99); a zero factor from i = d_a on
    ("subset", dict(TINY, t=2), 0.0, 1 / 6),
    ("subset", dict(TINY, t=3), 0.0, 0.0),
    ("subset", dict(CT, t=2), 0.0, 49 / 198),
    ("subset", dict(CT, t=51), 0.0, 0.0),
    # Thm 1: (4·4095/7 − 2)/2 = 8183/7; (100·999999/99 − 50)/50 = 20201
    ("direct", dict(TINY, p=8), math.log(8183 / 7), 0.0),
    ("direct", dict(CT, p=100), math.log(20201), 0.0),
    # p = n: the whole store, nothing learned
    ("direct", dict(TINY, p=4096), 0.0, 0.0),
    # Thm 4: ln((5/3)^4 + 999) − ln 1000
    ("as-sparse", dict(TINY, theta=0.25, u=1000),
     math.log(625 / 81 + 999) - math.log(1000), 0.0),
    # one user: twice Thm 3's ε
    ("as-sparse", dict(TINY, theta=0.25, u=1), 4 * math.log(5 / 3), 0.0),
    # Thm 2: ln((8183/7)^2 + 999) − ln 1000
    ("as-direct", dict(TINY, p=8, u=1000),
     math.log((8183 / 7) ** 2 + 999) - math.log(1000), 0.0),
    ("as-direct", dict(TINY, p=4096, u=1000), 0.0, 0.0),
])
def test_each_laws_privacy_is_worked_out_by_hand(scheme, config, eps, delta):
    got_eps, got_delta = schemes.laws(scheme).privacy(config)
    assert got_eps == pytest.approx(eps, rel=1e-12, abs=0.0)
    assert got_delta == pytest.approx(delta, rel=1e-12, abs=0.0)


def test_a_small_epsilon_survives_the_composition():
    # ln(e^{2ε} + u − 1) − ln u ≈ 2ε/u for ε ≪ 1: 7.1e-18 at the CT store
    got, _ = schemes.laws("as-sparse").privacy(dict(CT, theta=0.25, u=1000))
    assert got == pytest.approx(8 * 2.0 ** -50 / 1000, rel=1e-12)


@pytest.mark.parametrize("scheme, kind, servers, extra", [
    ("chor", "mask", 100, {"density": 0.5}),
    ("sparse", "mask", 100, {"density": 0.25}),
    ("subset", "mask", 51, {"density": 0.5}),
    ("as-sparse", "mask", 100, {"density": 0.25}),
    ("direct", "index", 100, {"requests": 100, "per_server": 1}),
    ("as-direct", "index", 100, {"requests": 100, "per_server": 1}),
])
def test_each_law_states_its_wire(scheme, kind, servers, extra):
    config = dict(CT, theta=0.25, t=51, p=100, u=1000)
    laws = schemes.laws(scheme)
    assert laws.kind == kind and laws.servers(config) == servers
    for name, want in extra.items():
        assert getattr(laws, name)(config) == want


def test_a_law_refuses_what_its_theorem_does_not_cover():
    with pytest.raises(ValueError, match="no laws"):
        schemes.laws("as-subset")
    with pytest.raises(ValueError, match="multiple of d"):
        schemes.laws("direct").privacy(dict(TINY, p=6))
    with pytest.raises(ValueError, match="2 <= t"):
        schemes.laws("subset").privacy(dict(TINY, t=5))
    with pytest.raises(KeyError):
        schemes.laws("as-sparse").privacy(dict(TINY, theta=0.25))


# ------------------------------------------------------------- tiny runs
LAWS = {
    "subset_t3": ("subset", {"t": 3}),
    "subset_t2": ("subset", {"t": 2}),
    "direct_p8": ("direct", {"p": 8}),
    "as_sparse_u1000": ("as-sparse", {"u": 1000}),
    "as_direct_u1000": ("as-direct", {"p": 8, "u": 1000}),
}


@pytest.mark.parametrize("name", sorted(LAWS))
def test_a_tiny_run_of_each_law_is_correct(name):
    scheme, params = LAWS[name]
    res = run_cell(scheme_cell(scheme, **params))
    assert res["correct"], res["limits"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert res["limits"]["answers_checked"]["value"] >= 1
    assert res["limits"]["server_errors"]["value"] == 0
    kind = schemes.laws(scheme).kind
    own = ({"parity_errors", "density_z"} if kind == "mask"
           else {"request_errors", "dummies_z"})
    assert own <= set(res["limits"])


def test_subset_charges_its_delta():
    res = run_cell(scheme_cell("subset", t=2))
    assert res["correct"], res["limits"]
    # δ = 1/6 a lookup, charged to every client: the gap is rounding
    assert res["limits"]["delta_gap"]["value"] < 1e-12


# -------------------------------------------------------------- controls
CONTROLS = {
    # the program at t = 2 where t = 3 is stated: δ 1/6 against 0
    "subset": ("subset", {"t": 3}, {"t": 2}, "delta_gap"),
    # p = 4 where 8 is stated: a larger ε is charged
    "direct": ("direct", {"p": 8}, {"p": 4}, "eps_gap"),
    # an anonymity set of 10 where 1000 is stated
    "as-sparse": ("as-sparse", {"u": 1000}, {"u": 10}, "eps_gap"),
    "as-direct": ("as-direct", {"p": 8, "u": 1000}, {"u": 10}, "eps_gap"),
}


@pytest.mark.parametrize("name", sorted(CONTROLS))
def test_each_laws_control_is_not_correct(name):
    scheme, stated, program, number = CONTROLS[name]
    res = run_cell(scheme_cell(scheme, **stated), overrides=program)
    assert not res["correct"]
    assert number in failed(res), res["limits"]


# ---------------------------------------------------------------- faults
def test_a_flipped_row_of_an_index_answer_is_not_correct(monkeypatch):
    from repro_torch.serve.sharded import ShardedBackend

    answer = ShardedBackend.answer_batch

    def broken(self, routed, **kw):
        out = answer(self, routed, **kw)
        if routed.kind == "index":
            out = out.clone()
            out[0, :, 0, 0] ^= 1  # the first row server 0 returns, each lookup
        return out

    monkeypatch.setattr(ShardedBackend, "answer_batch", broken)
    res = run_cell(scheme_cell("direct", p=8))
    assert not res["correct"]
    assert "answer_errors" in failed(res), res["limits"]
    assert res["limits"]["request_errors"]["value"] == 0


def test_a_request_list_without_its_index_is_not_correct(monkeypatch):
    from repro_torch.core import direct

    gen_queries = direct.gen_queries

    def broken(gen, n, d, p, q_idx):
        reqs = gen_queries(gen, n, d, p, q_idx)
        q = q_idx.to(reqs.device).to(reqs.dtype)[None, :, None]
        return (reqs + (reqs == q).to(reqs.dtype)) % n

    monkeypatch.setattr(direct, "gen_queries", broken)
    res = run_cell(scheme_cell("direct", p=8))
    assert not res["correct"]
    assert "request_errors" in failed(res), res["limits"]


def test_dummies_from_half_the_store_are_not_correct(monkeypatch):
    from repro_torch.core import direct

    draw = direct._distinct_dummies

    def lower_half(gen, n, k, b):
        return draw(gen, n // 2, k, b)

    monkeypatch.setattr(direct, "_distinct_dummies", lower_half)
    # 63 dummies a lookup, so the kept lookups' 504 or so put the lower
    # half's mean (n/4 against n/2) some 19 standard deviations off
    res = run_cell(scheme_cell("direct", p=64))
    assert not res["correct"]
    assert failed(res) == {"dummies_z"}, res["limits"]


def test_a_subset_batch_naming_a_server_twice_is_not_correct(monkeypatch):
    from repro_torch.core.protocol import SubsetScheme

    query = SubsetScheme.query

    def broken(self, plan, q_idx, *, pick_servers=None):
        out = query(self, plan, q_idx, pick_servers=pick_servers)
        servers = list(out.servers)
        servers[1] = servers[0]
        return dataclasses.replace(out, servers=tuple(servers))

    monkeypatch.setattr(SubsetScheme, "query", broken)
    res = run_cell(scheme_cell("subset", t=3))
    assert not res["correct"]
    assert failed(res) == {"server_errors"}, res["limits"]
