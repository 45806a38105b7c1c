"""The (ε, δ)-privacy distinguishability game (paper §2.2), executable.

The adversary hands the target two queries Q_i, Q_j and every other user a
known query Q_0; the target flips one of Q_i/Q_j; the adversary observes
the trace at its d_a corrupted servers and must bound Pr(O|Q_i)/Pr(O|Q_j).

This module makes the game *runnable*: per scheme it exposes the
adversary's sufficient statistic as a small integer code, draws many
Monte-Carlo rounds under each hypothesis — a whole batch of rounds at once,
on the device of the game's generator — and estimates the per-observation
likelihood ratios. Tests use it to (a) confirm every Security Theorem's
bound empirically, (b) confirm the Sparse-PIR bound is *tight* (Appendix
A.3 says it is), and (c) exhibit the certainty-exclusion events of
Vulnerability Thms 1–2.

Exact observation distributions are given for Sparse-PIR and Direct
Requests so tightness can be asserted without Monte-Carlo noise.

An observation function has the signature ``fn(gen, rounds, hyp) ->
[rounds] int codes``: ``hyp`` 0 is the target querying Q_i, 1 querying
Q_j, and every draw comes from ``gen``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import direct, sparse

__all__ = [
    "GameResult",
    "run_game",
    "observe_sparse_code",
    "observe_direct_code",
    "observe_naive_dummy_code",
    "observe_naive_anon_code",
    "observe_as_bundled_code",
    "observe_as_sparse_code",
    "sparse_exact_observation_probs",
    "direct_exact_observation_probs",
    "max_lr_from_probs",
]

ObserveFn = Callable[[torch.Generator, int, int], torch.Tensor]


# --------------------------------------------------------------------------
# Generic Monte-Carlo game harness
# --------------------------------------------------------------------------
@dataclasses.dataclass
class GameResult:
    counts_i: Dict[int, int]
    counts_j: Dict[int, int]
    trials: int

    def max_lr(self, min_count: int = 25) -> float:
        """Max empirical Pr(O|Q_i)/Pr(O|Q_j) over observations seen at least
        ``min_count`` times under H_i (the other direction is this result
        with the counts swapped)."""
        worst = 0.0
        for obs, ci in self.counts_i.items():
            if ci < min_count:
                continue
            cj = self.counts_j.get(obs, 0)
            if cj == 0:
                return float("inf")
            worst = max(worst, ci / cj)
        return worst

    def certainty_exclusion(self, min_count: int = 25) -> bool:
        """True iff some observation occurs under H_i but never under H_j —
        the catastrophic event of Vulnerability Thms 1–2."""
        return any(
            ci >= min_count and obs not in self.counts_j
            for obs, ci in self.counts_i.items()
        )


def run_game(
    observe_fn: ObserveFn,
    seed: int,
    trials: int,
    batch: int = 4096,
    *,
    device: DeviceLike = None,
) -> GameResult:
    """Play ``trials`` rounds under each hypothesis, ``batch`` rounds a
    draw, on ``device`` (``None``: the CUDA card, an error without one)
    with one ``torch.Generator`` seeded by ``seed``."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(seed))
    counts: Tuple[Dict[int, int], Dict[int, int]] = ({}, {})
    done = 0
    while done < trials:
        b = min(batch, trials - done)
        for hyp in (0, 1):
            codes = observe_fn(gen, b, hyp).cpu().numpy()
            vals, cnt = np.unique(codes, return_counts=True)
            for v, c in zip(vals.tolist(), cnt.tolist()):
                counts[hyp][v] = counts[hyp].get(v, 0) + c
        done += b
    return GameResult(counts_i=counts[0], counts_j=counts[1], trials=trials)


# --------------------------------------------------------------------------
# Per-scheme sufficient statistics
# --------------------------------------------------------------------------
def _targets(gen: torch.Generator, rounds: int, q: int) -> torch.Tensor:
    return torch.full((rounds,), q, dtype=torch.int32, device=gen.device)


def _column_parities(masks: torch.Tensor, d_a: int, q_i: int, q_j: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[d, R, n] query matrices -> the corrupted rows' parities of columns
    q_i and q_j, [R] each."""
    obs = masks[:d_a].to(torch.int32)
    return obs[:, :, q_i].sum(0) % 2, obs[:, :, q_j].sum(0) % 2


def _seen(reqs: torch.Tensor, d_a: int, q_i: int, q_j: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[d, R, k] direct requests -> whether the corrupted servers saw q_i
    and q_j, [R] int each."""
    obs = reqs[:d_a].permute(1, 0, 2).reshape(reqs.shape[1], -1)
    return ((obs == q_i).any(1).to(torch.int64),
            (obs == q_j).any(1).to(torch.int64))


def observe_sparse_code(
    n: int, d: int, d_a: int, theta: float, q_i: int, q_j: int
) -> ObserveFn:
    """Sparse-PIR: the adversary sees d_a rows; the sufficient statistic is
    the observed parity of columns q_i and q_j → 4 observations."""

    def fn(gen: torch.Generator, rounds: int, hyp: int) -> torch.Tensor:
        q = _targets(gen, rounds, q_i if hyp == 0 else q_j)
        pi, pj = _column_parities(
            sparse.gen_query_matrix(gen, n, d, theta, q), d_a, q_i, q_j)
        return 2 * pi + pj

    return fn


def observe_direct_code(
    n: int, d: int, d_a: int, p: int, q_i: int, q_j: int
) -> ObserveFn:
    """Direct Requests: sufficient statistic = (q_i seen, q_j seen) at the
    corrupted servers."""

    def fn(gen: torch.Generator, rounds: int, hyp: int) -> torch.Tensor:
        q = _targets(gen, rounds, q_i if hyp == 0 else q_j)
        si, sj = _seen(direct.gen_queries(gen, n, d, p, q), d_a, q_i, q_j)
        return 2 * si + sj

    return fn


def observe_naive_dummy_code(n: int, p: int, q_i: int, q_j: int
                             ) -> ObserveFn:
    """§3.1: a single corrupt database sees the whole request set."""
    return observe_direct_code(n, d=1, d_a=1, p=p, q_i=q_i, q_j=q_j)


def observe_naive_anon_code(n: int, u: int, q_i: int, q_j: int, q_0: int
                            ) -> ObserveFn:
    """§3.2: u users send bare queries through the AS; the corrupt database
    sees the multiset. Sufficient statistic: (#q_i, #q_j) among the u
    requests — deterministically ((hyp==i), (hyp==j)) plus Q_0 noise, so
    certainty exclusion is immediate for any u (Vulnerability Thm 2)."""

    def fn(gen: torch.Generator, rounds: int, hyp: int) -> torch.Tensor:
        # the mechanism has no randomness the adversary could not undo
        q = q_i if hyp == 0 else q_j
        ci = int(q == q_i) + (u - 1) * int(q_0 == q_i)
        cj = int(q == q_j) + (u - 1) * int(q_0 == q_j)
        return torch.full((rounds,), ci * (u + 1) + cj, dtype=torch.int64,
                          device=gen.device)

    return fn


def _users(gen: torch.Generator, rounds: int, u: int, qt: int, q_0: int
           ) -> torch.Tensor:
    """[rounds·u] queries: per round the target's ``qt`` then u−1 others'
    ``q_0`` (the mix makes the order moot)."""
    qs = torch.full((rounds, u), q_0, dtype=torch.int32, device=gen.device)
    qs[:, 0] = qt
    return qs.reshape(-1)


def observe_as_bundled_code(
    n: int, d: int, d_a: int, p: int, u: int, q_i: int, q_j: int, q_0: int
) -> ObserveFn:
    """§4.2 bundled AS-Direct: bundles are unlinkable to users, so the
    sufficient statistic is the multiset over bundles of (has_i, has_j) —
    coded as (#bundles showing q_i, #bundles showing q_j)."""

    def fn(gen: torch.Generator, rounds: int, hyp: int) -> torch.Tensor:
        qs = _users(gen, rounds, u, q_i if hyp == 0 else q_j, q_0)
        si, sj = _seen(direct.gen_queries(gen, n, d, p, qs), d_a, q_i, q_j)
        return (si.reshape(rounds, u).sum(1) * (u + 1)
                + sj.reshape(rounds, u).sum(1))

    return fn


def observe_as_sparse_code(
    n: int, d: int, d_a: int, theta: float, u: int,
    q_i: int, q_j: int, q_0: int,
) -> ObserveFn:
    """§4.4 AS-Sparse-PIR: per-user observed column parities, unordered.
    Code = (#users with odd q_i-parity, #users with odd q_j-parity)."""

    def fn(gen: torch.Generator, rounds: int, hyp: int) -> torch.Tensor:
        qs = _users(gen, rounds, u, q_i if hyp == 0 else q_j, q_0)
        pi, pj = _column_parities(
            sparse.gen_query_matrix(gen, n, d, theta, qs), d_a, q_i, q_j)
        return (pi.reshape(rounds, u).sum(1).to(torch.int64) * (u + 1)
                + pj.reshape(rounds, u).sum(1))

    return fn


# --------------------------------------------------------------------------
# Exact observation distributions (tightness checks)
# --------------------------------------------------------------------------
def sparse_exact_observation_probs(
    theta: float, d: int, d_a: int, queried: str
) -> Dict[int, float]:
    """Exact law of (parity_i, parity_j) codes for Sparse-PIR.

    ``queried`` in {"i", "j"}. Derivation (Appendix A.3): the observed
    parity of the queried column is odd iff its (d−d_a)-row hidden part is
    even; an even (h, θ)-binomial has probability E_h = 1/2 + 1/2(1−2θ)^h.
    """
    h = d - d_a
    e_h = 0.5 + 0.5 * (1.0 - 2.0 * theta) ** h
    # queried column: obs odd with prob e_h; other column: odd with 1 - e_h
    p_odd_q, p_odd_o = e_h, 1.0 - e_h
    probs = {}
    for pi in (0, 1):
        for pj in (0, 1):
            if queried == "i":
                pr = (p_odd_q if pi else 1 - p_odd_q) * (
                    p_odd_o if pj else 1 - p_odd_o
                )
            else:
                pr = (p_odd_o if pi else 1 - p_odd_o) * (
                    p_odd_q if pj else 1 - p_odd_q
                )
            probs[2 * pi + pj] = pr
    return probs


def direct_exact_observation_probs(
    n: int, d: int, d_a: int, p: int, queried: str
) -> Dict[int, float]:
    """Exact law of (seen_i, seen_j) codes for Direct Requests.

    With the real query placed uniformly among p slots split evenly over d
    servers: Pr[real query observed] = d_a/d; a *specific* dummy value is
    in the request set with prob (p−1)/(n−1) and, if present, observed
    with prob d_a/d (its slot is uniform). (Appendix A.2 algebra.)
    """
    a = d_a / d                      # real query lands on a corrupt server
    q_dummy = (p - 1) / (n - 1) * a  # specific other value observed
    probs: Dict[int, float] = {}
    for si in (0, 1):
        for sj in (0, 1):
            if queried == "i":
                pr = (a if si else 1 - a) * (q_dummy if sj else 1 - q_dummy)
            else:
                pr = (q_dummy if si else 1 - q_dummy) * (a if sj else 1 - a)
            probs[2 * si + sj] = pr
    return probs


def max_lr_from_probs(
    probs_i: Dict[int, float], probs_j: Dict[int, float],
    eps_floor: float = 0.0,
) -> float:
    """max_O Pr(O|Q_i)/Pr(O|Q_j) over the discrete observation space."""
    worst = 0.0
    for obs, pi in probs_i.items():
        if pi <= eps_floor:
            continue
        pj = probs_j.get(obs, 0.0)
        if pj <= 0.0:
            return float("inf")
        worst = max(worst, pi / pj)
    return worst
