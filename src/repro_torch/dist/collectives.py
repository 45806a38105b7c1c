"""Embedding-table lookups, single-device forms.

The reference's :func:`sharded_vocab_lookup` (LM token embeddings) and
:func:`sharded_table_lookup` (RecSys tables) row-shard the table over a
mesh and psum the partial rows; off a mesh both are a row gather. The port
has no mesh yet (ROADMAP.md Queue A item 11), so these are that gather.
Out-of-range ids clamp to ``[0, V)`` as in every path of the reference,
so a lookup never depends on where the table lives.
"""

from __future__ import annotations

import torch

__all__ = ["sharded_vocab_lookup", "sharded_table_lookup"]


def _lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    ids = ids.to(device=table.device, dtype=torch.long).clamp(0, table.shape[0] - 1)
    return table[ids]


def sharded_vocab_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """LM token-embedding gather. table: [V, D]; ids: int [...] -> [..., D]."""
    return _lookup(table, ids)


def sharded_table_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """RecSys embedding-table gather. table: [V, D]; ids: int [...] ->
    [..., D]."""
    return _lookup(table, ids)
