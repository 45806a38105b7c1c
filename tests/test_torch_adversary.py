"""Port vs reference: the distinguishability game (paper §2.2), run for
real on the port's own draws.

(a) Vulnerability Thms 1–2: the naive schemes admit certainty-exclusion
    observations (an unbounded likelihood ratio).
(b) Security Thms 1 and 3: the exact observation laws equal the
    reference's to 1e-12 and meet the ε bound — the Sparse-PIR bound is
    *tight* (Appendix A.3).
(c) Monte-Carlo: empirical likelihood ratios of the port's own query
    vectors — the modules' and the serving router's — stay within the
    bound, with the reference's own stated slack.
"""

import math

import pytest
import torch

from repro.core import accounting as ref_acc
from repro.core import adversary as ref_adv
from repro_torch.core import accounting as acc
from repro_torch.core import adversary as adv
from repro_torch.core import make_scheme
from repro_torch.serve import SchemeRouter

SEED = 20160701
TRIALS = 20000


def _game(fn, trials=TRIALS):
    return adv.run_game(fn, SEED, trials=trials, device="cpu")


# ------------------------------------------------------------- negative
def test_naive_dummy_not_private():
    res = _game(adv.observe_naive_dummy_code(n=64, p=8, q_i=3, q_j=40),
                trials=3000)
    assert res.certainty_exclusion()
    assert res.max_lr() == float("inf")


@pytest.mark.parametrize("u", [2, 32, 1024])
def test_naive_anon_not_private_any_u(u):
    """Security does not improve with u (Vulnerability Thm 2)."""
    fn = adv.observe_naive_anon_code(n=64, u=u, q_i=3, q_j=40, q_0=7)
    res = _game(fn, trials=256)
    assert res.certainty_exclusion(min_count=1)
    ref_fn = ref_adv.observe_naive_anon_code(n=64, u=u, q_i=3, q_j=40, q_0=7)
    import jax

    keys = jax.random.split(jax.random.key(0), 4)
    for hyp in (0, 1):
        assert fn(torch.Generator().manual_seed(0), 4, hyp).tolist() == [
            int(c) for c in ref_fn(keys, hyp)]


# ------------------------------------------------------- exact tightness
@pytest.mark.parametrize("theta,d,d_a", [(0.1, 3, 1), (0.25, 5, 2),
                                         (0.4, 8, 7), (0.25, 100, 50)])
def test_sparse_bound_exact_and_tight(theta, d, d_a):
    pi = adv.sparse_exact_observation_probs(theta, d, d_a, "i")
    pj = adv.sparse_exact_observation_probs(theta, d, d_a, "j")
    for mine, theirs in ((pi, ref_adv.sparse_exact_observation_probs(
            theta, d, d_a, "i")), (pj, ref_adv.sparse_exact_observation_probs(
            theta, d, d_a, "j"))):
        assert mine.keys() == theirs.keys()
        assert all(abs(mine[k] - theirs[k]) <= 1e-12 for k in mine)
    lr = adv.max_lr_from_probs(pi, pj)
    assert abs(lr - ref_adv.max_lr_from_probs(
        ref_adv.sparse_exact_observation_probs(theta, d, d_a, "i"),
        ref_adv.sparse_exact_observation_probs(theta, d, d_a, "j"))) <= 1e-12
    assert lr == pytest.approx(math.exp(acc.epsilon_sparse(theta, d, d_a)),
                               rel=1e-9)


@pytest.mark.parametrize("n,d,d_a,p", [(64, 4, 2, 8), (128, 8, 7, 16),
                                       (10**6, 100, 50, 100)])
def test_direct_bound_exact(n, d, d_a, p):
    pi = adv.direct_exact_observation_probs(n, d, d_a, p, "i")
    pj = adv.direct_exact_observation_probs(n, d, d_a, p, "j")
    rpi = ref_adv.direct_exact_observation_probs(n, d, d_a, p, "i")
    assert all(abs(pi[k] - rpi[k]) <= 1e-12 for k in pi)
    lr = adv.max_lr_from_probs(pi, pj)
    assert abs(lr - ref_adv.max_lr_from_probs(
        rpi, ref_adv.direct_exact_observation_probs(n, d, d_a, p, "j"))
    ) <= 1e-12 * max(1.0, lr)
    bound = math.exp(acc.epsilon_direct(n, d, d_a, p))
    assert bound == math.exp(ref_acc.epsilon_direct(n, d, d_a, p))
    assert lr <= bound * (1 + 1e-9)
    # Thm 1's bound is attained by the (seen_i, not seen_j) observation
    assert lr == pytest.approx(bound, rel=1e-9)


def test_max_lr_from_probs_edges():
    assert adv.max_lr_from_probs({0: 0.5}, {0: 0.0}) == float("inf")
    assert adv.max_lr_from_probs({0: 0.0, 1: 1.0}, {1: 0.5}) == 2.0
    assert adv.max_lr_from_probs({0: 0.1}, {0: 1.0}, eps_floor=0.2) == 0.0


# -------------------------------------------------------- Monte-Carlo
def _assert_mc_within(res, eps, slack=1.25):
    lr = res.max_lr(min_count=50)
    assert lr <= math.exp(eps) * slack, (lr, math.exp(eps))


def test_sparse_game_monte_carlo():
    theta, d, d_a = 0.3, 4, 2
    res = _game(adv.observe_sparse_code(n=16, d=d, d_a=d_a, theta=theta,
                                        q_i=2, q_j=9))
    _assert_mc_within(res, acc.epsilon_sparse(theta, d, d_a))
    assert not res.certainty_exclusion()


def test_direct_game_monte_carlo():
    n, d, d_a, p = 32, 4, 2, 8
    res = _game(adv.observe_direct_code(n=n, d=d, d_a=d_a, p=p, q_i=2,
                                        q_j=20))
    _assert_mc_within(res, acc.epsilon_direct(n, d, d_a, p))
    assert not res.certainty_exclusion()


def test_as_bundled_game_monte_carlo():
    n, d, d_a, p, u = 32, 2, 1, 8, 6
    res = _game(adv.observe_as_bundled_code(
        n=n, d=d, d_a=d_a, p=p, u=u, q_i=2, q_j=20, q_0=5))
    _assert_mc_within(res, acc.epsilon_as_direct(n, d, d_a, p, u))


def test_as_sparse_game_monte_carlo():
    """The Composition Lemma is an average-case bound: (a) no observation
    passes the worst-case cap e^{2ε₁}, (b) the mass of observations whose
    ratio passes e^{ε₂} is small, (c) the likeliest observation sits
    below e^{ε₂} — the reference's own three assertions and slacks."""
    n, d, d_a, theta, u = 16, 3, 1, 0.35, 6
    res = _game(adv.observe_as_sparse_code(
        n=n, d=d, d_a=d_a, theta=theta, u=u, q_i=2, q_j=9, q_0=5))
    eps1 = acc.epsilon_sparse(theta, d, d_a)
    eps2 = acc.epsilon_as_sparse(theta, d, d_a, u)
    _assert_mc_within(res, 2 * eps1)
    bad_mass = sum(
        ci for obs, ci in res.counts_i.items()
        if res.counts_j.get(obs, 0) > 0
        and ci / res.counts_j[obs] > math.exp(eps2) * 1.25 and ci >= 50
    ) / res.trials
    assert bad_mass < 0.15, bad_mass
    top_obs, top_ci = max(res.counts_i.items(), key=lambda kv: kv[1])
    assert top_ci / max(res.counts_j.get(top_obs, 0), 1) <= (
        math.exp(eps2) * 1.1)


def test_anonymity_improves_direct():
    n, d, d_a, p = 10**4, 10, 5, 100
    assert acc.epsilon_as_direct(n, d, d_a, p, u=10**6) < (
        acc.epsilon_direct(n, d, d_a, p) / 2)


def test_game_is_seeded_and_counts_every_round():
    fn = adv.observe_sparse_code(n=16, d=4, d_a=2, theta=0.3, q_i=2, q_j=9)
    a = adv.run_game(fn, 5, trials=5000, batch=1024, device="cpu")
    b = adv.run_game(fn, 5, trials=5000, batch=1024, device="cpu")
    assert a == b
    assert sum(a.counts_i.values()) == sum(a.counts_j.values()) == 5000
    assert set(a.counts_i) <= {0, 1, 2, 3}


# ------------------------------------ empirical ε of the routed query bits
def _empirical_epsilon(fn):
    res = _game(fn)
    lr = max(res.max_lr(min_count=50),
             adv.GameResult(res.counts_j, res.counts_i, res.trials).max_lr(50))
    return math.log(lr) if lr > 0 else 0.0


def _observe_routed_mask(name, n, d, d_a, q_i, q_j, use_pre=False, **kw):
    """The serving router's own vectors reduced to the corrupted rows'
    parities of columns q_i and q_j; ``use_pre`` plans from banked
    precomputed randomness, as the cache's prefill path does."""
    router = SchemeRouter(make_scheme(name, d=d, d_a=d_a, **kw))

    def fn(gen, rounds, hyp):
        q = torch.full((rounds,), q_i if hyp == 0 else q_j,
                       dtype=torch.int32)
        pre = router.precompute(gen, n, rounds) if use_pre else None
        obs = router.plan(gen, n, q, pre=pre).payload[:d_a].long()
        return 2 * (obs[:, :, q_i].sum(0) % 2) + obs[:, :, q_j].sum(0) % 2

    return fn


@pytest.mark.parametrize("theta,d,d_a", [(0.3, 4, 2), (0.2, 5, 3)])
def test_sparse_empirical_eps_meets_bound(theta, d, d_a):
    bound = acc.epsilon_sparse(theta, d, d_a)
    emp = _empirical_epsilon(_observe_routed_mask(
        "sparse", 16, d, d_a, 2, 9, theta=theta))
    assert emp <= bound + 0.25, (emp, bound)
    assert emp >= 0.5 * bound, (emp, bound)


def test_sparse_empirical_eps_decreases_with_honest_servers():
    eps = {d_a: _empirical_epsilon(_observe_routed_mask(
        "sparse", 16, 5, d_a, 2, 9, theta=0.25)) for d_a in (4, 2)}
    assert eps[2] < eps[4], eps
    for d_a, e in eps.items():
        assert e <= acc.epsilon_sparse(0.25, 5, d_a) + 0.25, (d_a, e)


def test_chor_routed_vectors_leak_nothing():
    emp = _empirical_epsilon(_observe_routed_mask("chor", 16, 3, 2, 2, 9))
    assert emp <= 0.15, emp
