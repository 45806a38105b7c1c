"""Deterministic synthetic data: write traffic for a live PIR store, LM
token streams and BERT4Rec item sequences.

Every pipeline is a stateless function of (seed, step), generated on the
host with numpy: replaying the same steps gives the same batch, in this
package and in the reference alike (both draw from the same numpy
stream), so a replayed ingest stream is bit-identical and can be held
against an independently rebuilt store, and both packages see the same
tokens and item histories. Batches stay numpy; the caller moves them to
its device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.configs.base import LMConfig, RecSysConfig
from repro_torch.db.live import Delta

__all__ = ["pir_delta_batch", "lm_batch", "bert4rec_batch"]


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


def lm_batch(cfg: LMConfig, batch: int, seq_len: int, seed: int, step: int) -> Dict:
    """Zipfian token stream (vocab-skewed like natural text)."""
    rng = _rng(seed, step)
    z = rng.zipf(1.3, size=(batch, seq_len)).astype(np.int64)
    return {"tokens": (z % cfg.vocab).astype(np.int32)}


def bert4rec_batch(cfg: RecSysConfig, batch: int, seed: int, step: int) -> Dict:
    """Cloze-masked item sequences (15% positions masked)."""
    rng = _rng(seed, step)
    mask_tok = cfg.n_items + 1
    items = rng.integers(1, cfg.n_items, size=(batch, cfg.seq_len), dtype=np.int32)
    mask = rng.random((batch, cfg.seq_len)) < 0.15
    mask[:, 0] |= ~mask.any(axis=1)  # ≥1 masked position per row
    seq = np.where(mask, mask_tok, items).astype(np.int32)
    return {
        "seq": seq,
        "labels": items,
        "mask": mask.astype(np.int32),
    }
