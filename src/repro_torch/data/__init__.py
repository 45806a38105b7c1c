"""Deterministic synthetic data, stateless in (seed, step)."""

from repro_torch.data.pipeline import (
    NeighborSampler,
    bert4rec_batch,
    gnn_full_graph,
    lm_batch,
    molecule_batch,
    pir_delta_batch,
    recsys_batch,
)

__all__ = [
    "NeighborSampler",
    "bert4rec_batch",
    "gnn_full_graph",
    "lm_batch",
    "molecule_batch",
    "pir_delta_batch",
    "recsys_batch",
]
