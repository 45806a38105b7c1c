"""Scheme router: one batch of indices in, per-server work out.

The router is the seam between the scheduler (which hands over a padded
[B] index batch) and the execution backend (which answers per-server
payloads). It is a thin caller of the staged
:class:`~repro_torch.core.protocol.SchemeProtocol` (DESIGN.md §Scheme
protocol): it holds **no per-scheme branching** — which replicas to
contact, what each receives, and how responses reconstruct are all the
scheme object's stages, dispatched through the registry. The straggler
policy (``pick_servers(t) -> Sequence[int]``) is forwarded to ``query()``:
Subset-PIR takes its replica choice from it (the serving pipeline passes
its fastest-t-by-latency-EMA ranking); the default there is the paper's
uniform random subset, and schemes that contact all d replicas ignore it.

The router also exposes the protocol's planning split:
:meth:`SchemeRouter.precompute` generates the query-independent randomness
of a whole batch ahead of time, and ``plan(..., pre=...)`` finishes it for
the actual indices — the wire boundary. :meth:`SchemeRouter.plan_many`
and :meth:`SchemeRouter.finalize_many` do the same for a jagged
multi-index batch, flattened onto the single-index wire.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import torch

from repro_torch.core.protocol import (
    Answers,
    MultiQueries,
    Queries,
    SchemeProtocol,
    as_protocol,
    multi_bucket,
    multi_query,
    multi_reconstruct,
)

__all__ = ["RoutedBatch", "SchemeRouter"]

# back-compat alias: the pre-protocol name for the wire-boundary type
RoutedBatch = Queries


class SchemeRouter:
    """Drives any registered scheme's staged plan/answer/reconstruct.

    Accepts a staged :class:`~repro_torch.core.protocol.SchemeProtocol`
    instance or a back-compat :class:`~repro_torch.core.schemes.Scheme`
    facade, which is normalized through the registry.
    """

    def __init__(
        self,
        scheme: Any,
        *,
        pick_servers: Optional[Callable[[int], Sequence[int]]] = None,
    ):
        self.scheme: SchemeProtocol = as_protocol(scheme)
        self._pick_servers = pick_servers

    # ------------------------------------------------------------ planning
    def precompute(self, gen: torch.Generator, n: int, b: int) -> Optional[Any]:
        """Pre-generate the query-independent randomness of a [b]-batch.

        Returns the scheme's Plan for ``plan(..., pre=...)``, or None
        where planning has no query-independent half (the direct family's
        dummy draws depend on the queried index — ``has_precompute`` is
        False). The result is **single-use**: feed it to exactly one
        plan() call.
        """
        if not self.scheme.has_precompute:
            return None
        return self.scheme.precompute(gen, n, b)

    def plan(
        self,
        gen: torch.Generator,
        n: int,
        q_idx: torch.Tensor,
        *,
        pre: Optional[Any] = None,
    ) -> Queries:
        """[B] indices -> per-server payloads for one batch.

        ``pre`` (from :meth:`precompute`) supplies pre-generated batch
        randomness; without it the randomness is drawn from ``gen`` here.
        """
        if pre is not None:
            if not self.scheme.has_precompute:
                raise ValueError(
                    f"{self.scheme.name} has no precompute half"
                )
            if pre.n != n:
                raise ValueError(f"pre built for n={pre.n}, store has n={n}")
            plan = pre
        else:
            plan = self.scheme.precompute(gen, n, int(q_idx.shape[0]))
        return self.scheme.query(plan, q_idx, pick_servers=self._pick_servers)

    def plan_many(
        self,
        gen: torch.Generator,
        n: int,
        index_lists: Sequence[Sequence[int]],
        *,
        pre: Optional[Any] = None,
    ) -> MultiQueries:
        """Jagged per-request index lists -> one flattened multi-index
        wire batch on the generator's device. ``pre`` must have been
        precomputed for ``multi_bucket(index_lists)``."""
        if pre is not None:
            if not self.scheme.has_precompute:
                raise ValueError(
                    f"{self.scheme.name} has no precompute half"
                )
            if pre.n != n:
                raise ValueError(f"pre built for n={pre.n}, store has n={n}")
            plan = pre
        else:
            plan = self.scheme.precompute(gen, n, multi_bucket(index_lists))
        return multi_query(
            self.scheme, plan, index_lists, pick_servers=self._pick_servers,
            device=gen.device,
        )

    # -------------------------------------------------------- reconstruction
    def finalize(self, routed: Queries, responses: torch.Tensor) -> torch.Tensor:
        """Per-server responses [d_eff, B, W] -> [B, W] packed records."""
        return self.scheme.reconstruct(
            Answers(queries=routed, responses=responses)
        )

    def finalize_many(
        self, routed: MultiQueries, responses: torch.Tensor
    ) -> List[torch.Tensor]:
        """Per-server responses for a multi-index batch -> per-request
        [k_r, W] packed rows in request order (padding dropped)."""
        return multi_reconstruct(
            self.scheme, Answers(queries=routed, responses=responses)
        )
