"""Subset-PIR (paper §5.1): IT-PIR on a random subset of t ≤ d servers.

All server-side costs scale by t/d; privacy degrades from ε = 0 to
(0, δ)-privacy with δ = Π_{i<t} (d_a−i)/(d−i) — the probability that every
contacted server is corrupt (Security Thm 5).

Operationally this is also the framework's *straggler mitigation*: the
serving pipeline ranks servers by observed latency and contacts the
fastest t, paying exactly the δ the accountant reports (see
:mod:`repro_torch.serve.engine`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import chor
from repro_torch.db.store import RecordStore

__all__ = ["choose_servers", "gen_queries", "retrieve"]


def choose_servers(gen: torch.Generator, d: int, t: int) -> torch.Tensor:
    """Uniformly random size-t subset of the d servers, in random order
    (Algorithm 5.1): the first t of a uniform permutation."""
    if not (2 <= t <= d):
        raise ValueError(f"need 2 <= t <= d, got t={t}, d={d}")
    return torch.randperm(d, generator=gen, device=gen.device)[:t]


def gen_queries(
    gen: torch.Generator, n: int, d: int, t: int, q_idx: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (servers [t], packed queries [t, B, Wn]) — Chor among t."""
    servers = choose_servers(gen, d, t)
    queries = chor.gen_queries(gen, n, t, q_idx)
    return servers, queries


def retrieve(
    gen: torch.Generator, store: RecordStore, d: int, t: int,
    q_idx: torch.Tensor,
) -> torch.Tensor:
    """End-to-end Subset-PIR retrieval (reference path): [B] -> [B, W]."""
    _, q = gen_queries(gen, store.n, d, t, q_idx)
    masks = chor.query_masks(q, store.n)
    responses = torch.stack([chor.server_answer(store.packed, m)
                             for m in masks])
    return chor.reconstruct(responses)
