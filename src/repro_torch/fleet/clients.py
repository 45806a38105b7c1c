"""Simulated client populations: who queries what, on whose budget.

A fleet is not one hot loop — it is thousands of distinct client
sessions, each with its own query distribution and its own privacy
allowance. :class:`ClientPopulation` models both halves:

* **Index model** — a zipf-ish popularity distribution over records
  (fleets hit heads hard), mixed with a per-client *hot record* the
  client re-polls with probability ``repoll_p`` — the paper's §2.2
  correlated-query pattern (a CT monitor watching its own certificate),
  which is exactly what the serving cache's per-(client, index) memo
  and the budget's sequential composition are built for.
* **Budget model** — ``install_budgets`` gives every client a
  :class:`~repro_torch.core.accounting.PrivacyBudget` sized as a number of
  queries at the pipeline's *current* (ε, δ) price. Clients with tight
  allowances exhaust mid-run and surface as refusal traffic (the SLO
  collector's ``refused`` outcome) — never as errors. When the price
  rises under a mid-traffic remesh, budgets sized at the healthy price
  exhaust sooner: degradation showing up in the refusal rate is the
  accounting working, not a bug.

Everything is deterministic given the population's ``seed``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.accounting import PrivacyBudget

__all__ = ["ClientPopulation"]


@dataclasses.dataclass(frozen=True)
class ClientPopulation:
    """``n_clients`` simulated sessions over an ``n_records`` store.

    ``budget_queries=(lo, hi)`` draws each client's allowance uniformly
    in [lo, hi] queries at the pipeline's per-query price; ``None``
    leaves every client on the pipeline's default (unlimited) budget.
    """

    n_clients: int
    n_records: int
    zipf_a: float = 1.3
    repoll_p: float = 0.2
    budget_queries: Optional[Tuple[int, int]] = None
    seed: int = 0

    def __post_init__(self):
        if self.n_clients < 1:
            raise ValueError(f"need n_clients >= 1, got {self.n_clients}")
        if self.n_records < 1:
            raise ValueError(f"need n_records >= 1, got {self.n_records}")
        if self.zipf_a <= 1.0:
            raise ValueError(f"need zipf_a > 1, got {self.zipf_a}")
        if not (0.0 <= self.repoll_p <= 1.0):
            raise ValueError(f"need 0 <= repoll_p <= 1, got {self.repoll_p}")
        if self.budget_queries is not None:
            lo, hi = self.budget_queries
            if not (1 <= lo <= hi):
                raise ValueError(
                    f"need 1 <= lo <= hi, got budget_queries={self.budget_queries}"
                )

    def client(self, i: int) -> str:
        return f"c{i % self.n_clients:06d}"

    def hot_index(self, i: int) -> int:
        """The record client ``i`` keeps re-polling (its own certificate)."""
        return (i * 131 + 17) % self.n_records

    def draw(self, k: int, seed: Optional[int] = None) -> List[Tuple[str, int]]:
        """``k`` (client, index) pairs: zipf-popular records, except each
        client re-polls its own hot record with probability ``repoll_p``.
        Vectorized — the harness draws whole scenarios at once."""
        rng = np.random.default_rng(self.seed if seed is None else seed)
        who = rng.integers(0, self.n_clients, size=k)
        popular = (rng.zipf(self.zipf_a, size=k) - 1) % self.n_records
        hot = (who * 131 + 17) % self.n_records
        repoll = rng.random(k) < self.repoll_p
        idx = np.where(repoll, hot, popular)
        return [(self.client(int(w)), int(q)) for w, q in zip(who, idx)]

    def install_budgets(self, pipeline) -> int:
        """Install every client's own budget on ``pipeline`` (via
        ``set_budget``), sized in queries at the pipeline's current
        per-query price; returns how many were installed (0 when
        ``budget_queries`` is None). A zero price component (chor's
        ε = 0, a δ-free scheme) maps to an unlimited limit on that axis
        — the allowance is carried by whichever axis the scheme spends.
        """
        if self.budget_queries is None:
            return 0
        lo, hi = self.budget_queries
        eps_q, delta_q = pipeline.price
        rng = np.random.default_rng(self.seed + 1)
        for i in range(self.n_clients):
            q = int(rng.integers(lo, hi + 1))
            pipeline.set_budget(
                self.client(i),
                PrivacyBudget(
                    epsilon_limit=q * eps_q if eps_q > 0 else math.inf,
                    delta_limit=q * delta_q if delta_q > 0 else 1.0,
                ),
            )
        return self.n_clients
