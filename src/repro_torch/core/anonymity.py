"""Ideal anonymity system (paper §1.1, §2.1).

The paper abstracts the AS as "a perfectly secret bi-directional
permutation between input and output messages". This is exactly that: a
uniformly random permutation of the batch axis, with the inverse kept so
replies can be routed back. From the adversary's viewpoint messages exit
in permuted order, i.e. only the *multiset* of messages is observable —
which is what the adversary game (:mod:`repro_torch.core.adversary`)
conditions on, and what the Composition Lemma's 1/u! matching-uniformity
argument requires.

Real mixes are imperfect (§1.1); the deployment story is a cascade mix,
and ``u`` in the accounting is the size of the anonymity set actually
achieved.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["mix", "unmix", "AnonymityChannel"]


def mix(gen: torch.Generator, items: torch.Tensor
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Permute axis 0. Returns (permuted_items, perm) with
    ``permuted[i] = items[perm[i]]``."""
    perm = torch.randperm(items.shape[0], generator=gen, device=gen.device)
    return items.index_select(0, perm.to(items.device)), perm


def unmix(items: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Route replies back: inverse of :func:`mix` on axis 0."""
    inv = torch.argsort(perm.to(items.device))
    return items.index_select(0, inv)


@dataclasses.dataclass
class AnonymityChannel:
    """Bi-directional ideal mix for one round of u user messages.

    ``bundled=True`` sends each user's whole request bundle as one message
    (Algorithm 4.2); ``bundled=False`` permutes every request independently
    (Algorithm 4.3, separated — the AS carries u·p messages).
    """

    gen: torch.Generator
    bundled: bool = True
    _perm: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False)

    def forward(self, messages: torch.Tensor) -> torch.Tensor:
        """messages: [u, ...] (bundled) or [u*p, ...] (separated)."""
        out, self._perm = mix(self.gen, messages)
        return out

    def backward(self, replies: torch.Tensor) -> torch.Tensor:
        if self._perm is None:
            raise RuntimeError("backward() before forward()")
        return unmix(replies, self._perm)
