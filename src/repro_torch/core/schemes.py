"""Back-compat scheme facade over the staged registry.

A :class:`Scheme` is one frozen dataclass carrying a name string plus the
union of all scheme parameters, so a config can switch ``chor ↔ sparse ↔
direct ↔ subset ↔ as-*`` with one string. It is a thin facade over :mod:`repro_torch.core.protocol`:
``make_scheme`` validates through the registry classes and
``Scheme.retrieve`` delegates to the staged ``precompute → query → answer
→ reconstruct`` path (DESIGN.md §Scheme protocol). No method here
dispatches on the name string — the registry does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import protocol
from repro_torch.db.store import RecordStore

__all__ = ["Scheme", "make_scheme", "SCHEMES"]

# the config-name surface; any ``as-<registered base>`` builds too
SCHEMES = ("chor", "sparse", "direct", "subset", "as-sparse", "as-direct")


@dataclasses.dataclass(frozen=True)
class Scheme:
    """A fully-parameterised ε-private PIR scheme (back-compat facade).

    d    : number of databases (replica groups)
    d_a  : assumed number of adversarial databases (accounting only)
    theta: Bernoulli sparsity (sparse, as-sparse)
    p    : requests per query, a multiple of d (direct, as-direct)
    t    : servers contacted (subset)
    u    : anonymity-set size (as-*)
    """

    name: str
    d: int
    d_a: int
    theta: Optional[float] = None
    p: Optional[int] = None
    t: Optional[int] = None
    u: Optional[int] = None

    @property
    def staged(self) -> protocol.SchemeProtocol:
        """The staged protocol object. Rebuilt on demand — construction is
        host-side parameter plumbing, no device work."""
        return protocol.as_protocol(self)

    # ------------------------------------------------------------ privacy
    def privacy(self, n: int) -> Tuple[float, float]:
        return self.staged.privacy(n)

    def epsilon(self, n: int) -> float:
        return self.privacy(n)[0]

    def delta(self, n: int) -> float:
        return self.privacy(n)[1]

    def costs(self, n: int) -> dict:
        return self.staged.costs(n)

    # ------------------------------------------------------------ retrieval
    def retrieve(
        self, gen: torch.Generator, store: RecordStore, q_idx: torch.Tensor
    ) -> torch.Tensor:
        """[B] indices -> [B, W] packed records (reference path)."""
        return protocol.staged_retrieve(self.staged, gen, store, q_idx)


def make_scheme(name: str, d: int, d_a: int, **kw) -> Scheme:
    name = name.lower()
    if name not in SCHEMES and not name.startswith("as-"):
        raise ValueError(f"unknown scheme {name!r}; choose from {SCHEMES}")
    sch = Scheme(name=name, d=d, d_a=d_a, **kw)
    # build the staged object eagerly: the registry classes own validation,
    # so configs fail fast
    sch.staged
    return sch
