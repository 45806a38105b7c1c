"""Privacy accounting: every closed form in the paper, plus inverse solvers.

All formulas are from Toledo, Danezis & Goldberg, "Lower-Cost ε-Private
Information Retrieval" (PETS 2016):

  * Security Thm 1 (Direct Requests)      : :func:`epsilon_direct`
  * Security Thm 2 (Bundled AS-Direct)    : :func:`epsilon_as_direct`
  * Security Thm 3 (Sparse-PIR)           : :func:`epsilon_sparse`
  * Security Thm 4 (AS-Sparse-PIR)        : :func:`epsilon_as_sparse`
  * Security Thm 5 (Subset-PIR)           : :func:`delta_subset`
  * Composition Lemma                     : :func:`compose_with_anonymity`
  * §3.3 naive composition delta bounds   : :func:`naive_composition_deltas`

Costs (Table 1) are in :func:`scheme_costs`. Inverse solvers answer "what
parameter do I need for a target ε" — they drive the cost-privacy frontier
benchmarks (Fig. 6) and config validation.

Everything is plain float math (numpy-compatible): accounting runs on the
host at config/build time, never on the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np

__all__ = [
    "epsilon_direct",
    "epsilon_as_direct",
    "epsilon_sparse",
    "epsilon_as_sparse",
    "delta_subset",
    "compose_with_anonymity",
    "naive_composition_deltas",
    "theta_for_epsilon",
    "p_for_epsilon",
    "users_for_target",
    "scheme_costs",
    "PrivacyBudget",
]


# --------------------------------------------------------------------------
# Forward formulas
# --------------------------------------------------------------------------
def _check_servers(d: int, d_a: int) -> None:
    if not (0 <= d_a < d):
        raise ValueError(f"need 0 <= d_a < d, got d={d}, d_a={d_a}")


def epsilon_direct(n: int, d: int, d_a: int, p: int) -> float:
    """Security Thm 1: ε = ln( (d·(n−1)/(p−1) − d_a) / (d − d_a) ).

    ``p`` is the *total* number of requests (the real query + p−1 dummies),
    partitioned evenly over the d databases. ε = 0 iff p = n (full download).
    """
    _check_servers(d, d_a)
    if not (1 < p <= n):
        raise ValueError(f"need 1 < p <= n, got p={p}, n={n}")
    ratio = (d * (n - 1) / (p - 1) - d_a) / (d - d_a)
    # p == n => ratio == 1 => eps == 0 (full download); guard fp jitter.
    return math.log(max(ratio, 1.0))


def epsilon_as_direct(n: int, d: int, d_a: int, p: int, u: int) -> float:
    """Security Thm 2 (bundled anonymous direct requests).

    ε = ln( ((d/(d−d_a))·(n−1)/(p−1) − d_a/(d−d_a))² + u − 1 ) − ln u.
    Also an upper bound for the separated variant (paper §4.2).
    """
    _check_servers(d, d_a)
    if u < 1:
        raise ValueError(f"need u >= 1, got {u}")
    inner = d / (d - d_a) * (n - 1) / (p - 1) - d_a / (d - d_a)
    return math.log(max(inner, 1.0) ** 2 + u - 1) - math.log(u)


def epsilon_sparse(theta: float, d: int, d_a: int) -> float:
    """Security Thm 3: ε = 4·arctanh((1−2θ)^(d−d_a)); tight (Appendix A.3)."""
    _check_servers(d, d_a)
    if not (0.0 < theta <= 0.5):
        raise ValueError(f"need 0 < theta <= 1/2, got {theta}")
    x = (1.0 - 2.0 * theta) ** (d - d_a)
    if x >= 1.0:  # theta -> 0 degenerate: no privacy
        return math.inf
    return 4.0 * math.atanh(x)


def epsilon_as_sparse(theta: float, d: int, d_a: int, u: int) -> float:
    """Security Thm 4 = Composition Lemma applied to Sparse-PIR.

    ε = ln( ((1+x)/(1−x))⁴ + u − 1 ) − ln u  with x = (1−2θ)^(d−d_a).
    """
    return compose_with_anonymity(epsilon_sparse(theta, d, d_a), u)


def delta_subset(d: int, d_a: int, t: int) -> float:
    """Security Thm 5: δ = Π_{i=0}^{t−1} (d_a−i)/(d−i); ε = 0.

    δ is the probability every one of the t contacted servers is corrupt.
    For t > d_a the product hits a zero factor → unconditional privacy.
    """
    _check_servers(d, d_a)
    if not (1 <= t <= d):
        raise ValueError(f"need 1 <= t <= d, got t={t}")
    delta = 1.0
    for i in range(t):
        delta *= max(d_a - i, 0) / (d - i)
    return delta


def compose_with_anonymity(eps1: float, u: int) -> float:
    """Composition Lemma: ε₂ = ln(e^{2ε₁} + u − 1) − ln u.

    Average-case bound (Appendix A.4). u→∞ ⇒ ε₂→0 for any finite ε₁;
    u = 1 ⇒ ε₂ = 2ε₁ (bound not tight at u=1, as the paper notes).
    """
    if u < 1:
        raise ValueError(f"need u >= 1, got {u}")
    if math.isinf(eps1):
        return math.inf
    # log-sum-exp for numerical stability at large eps1
    a = 2.0 * eps1
    b = math.log(u - 1) if u > 1 else -math.inf
    m = max(a, b)
    return m + math.log(math.exp(a - m) + math.exp(b - m)) - math.log(u)


def naive_composition_deltas(n: int, p: int, u: int) -> Dict[str, float]:
    """§3.3: naive dummies through an AS is (ε, δ)-private with

    δ_u ≤ ((p−1)/(n−1))^(u−1)   (all users hit Q_i)
    δ_0 ≤ ((n−p)/(n−1))^(u−1)   (nobody hits Q_i)
    """
    if not (1 < p <= n):
        raise ValueError(f"need 1 < p <= n, got p={p}, n={n}")
    return {
        "delta_all": ((p - 1) / (n - 1)) ** (u - 1),
        "delta_none": ((n - p) / (n - 1)) ** (u - 1),
    }


# --------------------------------------------------------------------------
# Inverse solvers (drive Fig. 6-style frontiers and config validation)
# --------------------------------------------------------------------------
def theta_for_epsilon(eps: float, d: int, d_a: int) -> float:
    """Smallest θ achieving ε for Sparse-PIR: invert Thm 3 exactly."""
    _check_servers(d, d_a)
    if eps <= 0:
        return 0.5
    x = math.tanh(eps / 4.0)  # (1-2θ)^(d-d_a) = x
    return 0.5 * (1.0 - x ** (1.0 / (d - d_a)))


def p_for_epsilon(eps: float, n: int, d: int, d_a: int) -> int:
    """Smallest total request count p achieving ε for Direct Requests."""
    _check_servers(d, d_a)
    target = math.exp(eps) * (d - d_a) + d_a  # = d (n-1)/(p-1)
    p = 1 + d * (n - 1) / target
    return min(n, max(2, math.ceil(p)))


def users_for_target(eps1: float, eps2: float) -> int:
    """Smallest anonymity-set size u such that compose(ε₁, u) ≤ ε₂."""
    if eps2 <= 0:
        raise ValueError("target epsilon must be positive (ε₂→0 needs u→∞)")
    # ln(e^{2e1}+u-1) - ln u <= e2  <=>  u >= (e^{2e1} - 1)/(e^{e2} - 1)
    u = (math.exp(2.0 * eps1) - 1.0) / (math.exp(eps2) - 1.0)
    return max(1, math.ceil(u))


# --------------------------------------------------------------------------
# Cost model (Table 1)
# --------------------------------------------------------------------------
def scheme_costs(
    scheme: str,
    *,
    n: int,
    d: int,
    p: int | None = None,
    theta: float | None = None,
    t: int | None = None,
    c_acc: float = 1.0,
    c_prc: float = 1.0,
) -> Dict[str, float]:
    """Server-side costs per query, Table 1.

    Returns ``{"C_m": blocks_sent, "C_p": access+processing_cost}``.
    """
    scheme = scheme.lower()
    if scheme in ("chor", "it-pir"):
        return {"C_m": d, "C_p": 0.5 * d * n * (c_acc + c_prc)}
    if scheme in ("direct", "as-direct"):
        if p is None:
            raise ValueError("direct requests need p")
        return {"C_m": float(p), "C_p": p * c_acc}
    if scheme in ("sparse", "as-sparse"):
        if theta is None:
            raise ValueError("sparse-pir needs theta")
        return {"C_m": d, "C_p": theta * d * n * (c_acc + c_prc)}
    if scheme == "subset":
        if t is None:
            raise ValueError("subset-pir needs t")
        return {"C_m": float(t), "C_p": 0.5 * t * n * (c_acc + c_prc)}
    raise ValueError(f"unknown scheme {scheme!r}")


# --------------------------------------------------------------------------
# Budget tracking (rate-limiting correlated queries, §2.2 discussion)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class PrivacyBudget:
    """Sequential-composition budget for repeated queries.

    The paper (§2.2) notes that for ε > 0, information leaks at a
    non-negligible rate and users should rate-limit recurring or correlated
    queries "as for other differentially private mechanisms". Standard DP
    sequential composition applies: k queries at ε each spend k·ε (and δ
    accumulates additively). The serving engine consults this object before
    admitting a query from a client session.
    """

    epsilon_limit: float
    delta_limit: float = 0.0
    spent_epsilon: float = 0.0
    spent_delta: float = 0.0

    def can_spend(self, eps: float, delta: float = 0.0) -> bool:
        return (
            self.spent_epsilon + eps <= self.epsilon_limit + 1e-12
            and self.spent_delta + delta <= self.delta_limit + 1e-12
        )

    def spend(self, eps: float, delta: float = 0.0) -> None:
        if not self.can_spend(eps, delta):
            raise PermissionError(
                f"privacy budget exhausted: spent ({self.spent_epsilon:.3g}, "
                f"{self.spent_delta:.3g}) + ({eps:.3g}, {delta:.3g}) exceeds "
                f"({self.epsilon_limit:.3g}, {self.delta_limit:.3g})"
            )
        self.spent_epsilon += eps
        self.spent_delta += delta

    @property
    def remaining_epsilon(self) -> float:
        return max(0.0, self.epsilon_limit - self.spent_epsilon)
