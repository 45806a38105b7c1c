"""Deterministic synthetic write traffic for a live PIR store.

A stateless function of (seed, step), generated on the host with numpy:
replaying the same steps gives the same deltas, in this package and in
the reference alike (both draw from the same numpy stream), so a replayed
ingest stream is bit-identical and can be held against an independently
rebuilt store.
"""

from __future__ import annotations

import numpy as np

from repro_torch.db.live import Delta

__all__ = ["pir_delta_batch"]


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def pir_delta_batch(
    current_n: int,
    record_bytes: int,
    *,
    appends: int = 0,
    updates: int = 0,
    deletes: int = 0,
    seed: int = 0,
    step: int = 0,
):
    """One step of synthetic write traffic against a versioned PIR store:
    a list of :class:`~repro_torch.db.live.Delta`\\ s (append, then update,
    then delete — only the non-empty kinds). Update/delete targets are
    drawn from [0, current_n) — pass the store's n *at this step* (appends
    grow it)."""
    if current_n < 1:
        raise ValueError("pir_delta_batch needs current_n >= 1")
    rng = _rng(seed, step ^ 0x5EED)
    out = []
    if appends:
        out.append(Delta.append(
            rng.integers(0, 256, size=(appends, record_bytes), dtype=np.uint8)
        ))
    if updates:
        idx = rng.integers(0, current_n, size=updates)
        out.append(Delta.update(
            idx,
            rng.integers(0, 256, size=(updates, record_bytes), dtype=np.uint8),
        ))
    if deletes:
        out.append(Delta.delete(rng.integers(0, current_n, size=deletes)))
    return out
