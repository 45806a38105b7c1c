"""PrivateEmbedding — the paper's technique as a model feature.

Any embedding lookup ``table[idx]`` is an index→record retrieval against
an operator-held database: exactly the PIR setting. This module wraps a
float32 table as a :class:`RecordStore` of its rows' bits and executes
lookups through a configured ε-private scheme. Reconstruction is
bit-exact (XOR transports raw bits; rows are bitcast f32↔32-bit words),
so a PIR-backed model is *numerically identical* to the plain-gather
model, while the privacy accountant charges the (ε, δ) spent per lookup.

On the card the servers' answers run the ``xor_fold`` kernel (the staged
``answer`` stage, :func:`repro_torch.core.chor.server_answer`). Query
randomness comes from a ``torch.Generator`` where the reference takes a
JAX key.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.accounting import PrivacyBudget
from repro_torch.core.protocol import (
    as_protocol,
    multi_privacy,
    staged_retrieve,
    staged_retrieve_many,
)
from repro_torch.core.schemes import make_scheme
from repro_torch.db import packing
from repro_torch.db.store import RecordStore
from repro_torch.models.recsys import embedding_bag

__all__ = ["PrivateEmbedding"]


@dataclasses.dataclass
class PrivateEmbedding:
    """A [vocab, dim] float32 table with ε-private lookups.

    No scheme (``create(..., scheme="plain")``) bypasses PIR (the
    baseline); ``scheme`` may be a staged protocol instance or the
    ``Scheme`` facade — lookups run the staged ``precompute → query →
    answer → reconstruct`` path either way. The store lives on the
    table's device and shares its memory.
    """

    table: torch.Tensor
    scheme: Optional[Any] = None
    budget: Optional[PrivacyBudget] = None

    def __post_init__(self):
        if self.table.dim() != 2 or self.table.dtype != torch.float32:
            raise ValueError("PrivateEmbedding expects a [vocab, dim] f32 table")
        self._store = RecordStore.from_float_table(self.table.detach())
        self._staged = None if self.scheme is None else as_protocol(self.scheme)

    # ------------------------------------------------------------ factory
    @classmethod
    def create(
        cls,
        table: torch.Tensor,
        scheme: Any = "plain",
        d: int = 2,
        d_a: int = 1,
        budget: Optional[PrivacyBudget] = None,
        **scheme_kw,
    ) -> "PrivateEmbedding":
        if isinstance(scheme, str):
            sch = None if scheme == "plain" else make_scheme(
                scheme, d, d_a, **scheme_kw
            )
        else:  # an already-built scheme object (facade or protocol)
            sch = scheme
        return cls(table=table, scheme=sch, budget=budget)

    # ------------------------------------------------------------- lookup
    @property
    def vocab(self) -> int:
        return int(self.table.shape[0])

    @property
    def dim(self) -> int:
        return int(self.table.shape[1])

    @property
    def device(self) -> torch.device:
        return self.table.device

    def epsilon_per_lookup(self) -> float:
        return 0.0 if self._staged is None else self._staged.privacy(self.vocab)[0]

    def delta_per_lookup(self) -> float:
        return 0.0 if self._staged is None else self._staged.privacy(self.vocab)[1]

    def _ids(self, idx) -> torch.Tensor:
        return torch.as_tensor(idx, device=self.device).to(torch.long)

    def lookup(self, gen: torch.Generator, idx) -> torch.Tensor:
        """[...] int indices -> [..., dim] float32 rows (bit-exact). The
        budget is charged for every index before any query is made;
        ``gen`` draws the query randomness and lives on the table's
        device."""
        idx = self._ids(idx)
        if self._staged is None:
            return self.table[idx]
        if self.budget is not None:
            b = int(idx.numel())
            eps, delta = self._staged.privacy(self.vocab)
            self.budget.spend(b * eps, b * delta)
        packed = staged_retrieve(
            self._staged, gen, self._store, idx.reshape(-1).to(torch.int32)
        )
        rows = packing.bitcast_u32_to_f32(packed)
        return rows.reshape(*idx.shape, self.dim)

    def lookup_many(self, gen: torch.Generator, index_lists) -> list:
        """Jagged multi-index lookup: per-request index lists ->
        per-request [k_r, dim] float32 rows (bit-exact).

        One precompute at the flattened pow2 bucket, one wire round trip;
        privacy is priced by the Composition Lemma as ``sum(k_r)``
        sequential lookups (the padded dummy columns are free)."""
        if self._staged is None:
            return [self.table[self._ids(ix)] for ix in index_lists]
        total = sum(len(ix) for ix in index_lists)
        if self.budget is not None:
            eps, delta = multi_privacy(self._staged, self.vocab, total)
            self.budget.spend(eps, delta)
        packed = staged_retrieve_many(
            self._staged, gen, self._store,
            [[int(i) for i in ix] for ix in index_lists],
        )
        return [
            packing.bitcast_u32_to_f32(rows).reshape(-1, self.dim)
            for rows in packed
        ]

    def bag_lookup(
        self,
        gen: torch.Generator,
        flat_idx,
        segment_ids,
        num_bags: int,
        combiner: str = "sum",
    ) -> torch.Tensor:
        """EmbeddingBag over PIR: gather each index privately, then
        segment-reduce into bags (:func:`repro_torch.models.recsys.
        embedding_bag`, whose segment sum gives the same bits on every
        call, so a private bag equals the plain bag bit for bit).
        flat_idx/segment_ids: [nnz]."""
        if combiner not in ("sum", "mean"):
            raise ValueError(f"unknown combiner {combiner!r}")
        return embedding_bag(
            self.table, flat_idx, segment_ids, num_bags, combiner,
            lookup_fn=lambda table, ids: self.lookup(gen, ids))

    # --------------------------------------------------------------- cost
    def server_cost(self) -> dict:
        if self._staged is None:
            return {"C_m": 1.0, "C_p": 1.0}
        return self._staged.costs(self.vocab)
