"""Deterministic synthetic data: write traffic for a live PIR store, LM
token streams, recommender batches (FM, DLRM, DIEN, BERT4Rec), random
graphs for the GCN (full-batch, batched molecules) and the GraphSAGE-style
:class:`NeighborSampler`, whose fixed-shape padded subgraphs the
minibatch GCN consumes.

Every pipeline is a stateless function of (seed, step), generated on the
host with numpy: replaying the same steps gives the same batch, in this
package and in the reference alike (both draw from the same numpy
stream), so a replayed ingest stream is bit-identical and can be held
against an independently rebuilt store, and both packages see the same
tokens, ids, item histories and graphs. Batches stay numpy; the caller moves them to
its device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.configs.base import LMConfig, RecSysConfig
from repro_torch.db.live import Delta

__all__ = [
    "pir_delta_batch",
    "lm_batch",
    "recsys_batch",
    "bert4rec_batch",
    "gnn_full_graph",
    "molecule_batch",
    "NeighborSampler",
]


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


def recsys_batch(cfg: RecSysConfig, batch: int, seed: int, step: int) -> Dict:
    """One batch of an FM, DLRM or DIEN: binary ``label`` [B] f32, and
    per-field ``ids`` [B, n_sparse] (FM, DLRM; each field's own id in
    [0, vocab_per_field)), ``dense`` [B, n_dense] f32 (DLRM), or an item
    history ``hist`` [B, seq_len] and ``target`` [B] (DIEN)."""
    rng = _rng(seed, step)
    out: Dict[str, np.ndarray] = {
        "label": rng.integers(0, 2, size=(batch,)).astype(np.float32)
    }
    if cfg.model == "fm":
        out["ids"] = rng.integers(
            0, cfg.vocab_per_field, size=(batch, cfg.n_sparse), dtype=np.int32
        )
    elif cfg.model == "dlrm":
        out["ids"] = rng.integers(
            0, cfg.vocab_per_field, size=(batch, cfg.n_sparse), dtype=np.int32
        )
        out["dense"] = rng.normal(size=(batch, cfg.n_dense)).astype(np.float32)
    elif cfg.model == "dien":
        out["hist"] = rng.integers(
            0, cfg.vocab_per_field, size=(batch, cfg.seq_len), dtype=np.int32
        )
        out["target"] = rng.integers(
            0, cfg.vocab_per_field, size=(batch,), dtype=np.int32
        )
    else:
        raise ValueError(cfg.model)
    return out


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


# ----------------------------------------------------------------- gnn
def gnn_full_graph(
    n_nodes: int, n_edges: int, d_feat: int, n_classes: int, seed: int,
    pad_to: int = 1,
) -> Dict:
    """Power-law-ish random graph with symmetric-norm weights precomputed.
    Arrays padded so node/edge counts divide ``pad_to`` (mesh shards):
    padding edges are 0 -> 0 with weight 0, padding nodes are unlabelled
    (``label_mask`` 0) with ``mean_deg`` 1."""
    rng = _rng(seed, 0)
    n_pad = -(-n_nodes // pad_to) * pad_to
    e_pad = -(-n_edges // pad_to) * pad_to

    # preferential-attachment-flavoured endpoints (power-law degrees)
    w = 1.0 / np.arange(1, n_nodes + 1) ** 0.5
    w /= w.sum()
    src = rng.choice(n_nodes, size=n_edges, p=None).astype(np.int32)
    dst = (rng.choice(n_nodes, size=n_edges, p=w)).astype(np.int32)

    deg = np.bincount(src, minlength=n_nodes) + np.bincount(dst, minlength=n_nodes)
    deg = np.maximum(deg, 1).astype(np.float32) * 0.5
    ew = 1.0 / np.sqrt(deg[src] * deg[dst])

    feats = rng.normal(size=(n_pad, d_feat)).astype(np.float32)
    labels = rng.integers(0, n_classes, size=(n_pad,)).astype(np.int32)
    label_mask = np.zeros((n_pad,), np.float32)
    label_mask[:n_nodes] = 1.0
    mean_deg = np.ones((n_pad,), np.float32)
    mean_deg[:n_nodes] = np.maximum(
        np.bincount(dst, minlength=n_nodes), 1
    ).astype(np.float32)

    return {
        "feats": feats,
        "src": np.pad(src, (0, e_pad - n_edges)),
        "dst": np.pad(dst, (0, e_pad - n_edges)),
        "edge_w": np.pad(ew.astype(np.float32), (0, e_pad - n_edges)),
        "labels": labels,
        "label_mask": label_mask,
        "mean_deg": mean_deg,
    }


def molecule_batch(
    batch: int, n_nodes: int, n_edges: int, d_feat: int, n_classes: int,
    seed: int, step: int,
) -> Dict:
    """``batch`` small random graphs of ``n_nodes`` nodes and ``n_edges``
    unit-weight edges each (ids local to the graph), one label a graph."""
    rng = _rng(seed, step)
    return {
        "feats": rng.normal(size=(batch, n_nodes, d_feat)).astype(np.float32),
        "src": rng.integers(0, n_nodes, size=(batch, n_edges), dtype=np.int32),
        "dst": rng.integers(0, n_nodes, size=(batch, n_edges), dtype=np.int32),
        "edge_w": np.ones((batch, n_edges), np.float32),
        "labels": rng.integers(0, n_classes, size=(batch,), dtype=np.int32),
    }


# ------------------------------------------------------- neighbor sampler
@dataclasses.dataclass
class NeighborSampler:
    """GraphSAGE fanout sampler over a CSR adjacency (host-side).

    ``sample(seeds)`` returns a fixed-shape padded subgraph:
      nodes   [n_sub]      global node ids (padded with 0)
      feats   [n_sub, F]   gathered features
      src/dst [e_sub]      LOCAL ids into ``nodes`` (padding: self-loop 0→0
                           with weight 0)
      edge_w  [e_sub]      1/fanout weights, 0 on padding
      seed_mask [n_sub]    1.0 on seed rows (loss mask)
    with n_sub = B·(1 + f1 + f1·f2), e_sub = B·(f1 + f1·f2).
    """

    indptr: np.ndarray
    indices: np.ndarray
    feats: np.ndarray
    labels: np.ndarray
    fanouts: tuple[int, ...]
    seed: int = 0

    @classmethod
    def random_graph(
        cls, n_nodes: int, avg_degree: int, d_feat: int, n_classes: int,
        fanouts=(15, 10), seed: int = 0,
    ) -> "NeighborSampler":
        rng = np.random.default_rng(seed)
        deg = np.maximum(
            rng.poisson(avg_degree, size=n_nodes), 1
        ).astype(np.int64)
        indptr = np.concatenate([[0], np.cumsum(deg)])
        indices = rng.integers(0, n_nodes, size=int(indptr[-1]), dtype=np.int32)
        feats = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
        labels = rng.integers(0, n_classes, size=(n_nodes,), dtype=np.int32)
        return cls(indptr, indices, feats, labels, tuple(fanouts), seed)

    def _neighbors(self, rng, node: int, k: int) -> np.ndarray:
        lo, hi = self.indptr[node], self.indptr[node + 1]
        if hi == lo:
            return np.full((k,), node, np.int32)  # isolated: self-loops
        return self.indices[rng.integers(lo, hi, size=k)]

    def sample(self, seeds: np.ndarray, step: int = 0) -> Dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, 77])
        )
        b = len(seeds)
        f1, f2 = self.fanouts
        hop1 = np.stack(
            [self._neighbors(rng, s, f1) for s in seeds]
        )  # [B, f1]
        hop2 = np.stack(
            [
                np.stack([self._neighbors(rng, n, f2) for n in row])
                for row in hop1
            ]
        )  # [B, f1, f2]

        nodes = np.concatenate(
            [seeds, hop1.reshape(-1), hop2.reshape(-1)]
        ).astype(np.int32)
        n_sub = b * (1 + f1 + f1 * f2)
        if nodes.shape[0] != n_sub:
            raise AssertionError(f"{nodes.shape[0]} sub-nodes, not {n_sub}")

        # local edge list: hop1->seed, hop2->hop1 (message flows to dst)
        seed_local = np.arange(b)
        hop1_local = b + np.arange(b * f1)
        hop2_local = b + b * f1 + np.arange(b * f1 * f2)
        src = np.concatenate([hop1_local, hop2_local]).astype(np.int32)
        dst = np.concatenate(
            [
                np.repeat(seed_local, f1),
                np.repeat(hop1_local, f2),
            ]
        ).astype(np.int32)
        edge_w = np.concatenate(
            [np.full(b * f1, 1.0 / f1), np.full(b * f1 * f2, 1.0 / f2)]
        ).astype(np.float32)

        seed_mask = np.zeros((n_sub,), np.float32)
        seed_mask[:b] = 1.0
        return {
            "nodes": nodes,
            "feats": self.feats[nodes],
            "src": src,
            "dst": dst,
            "edge_w": edge_w,
            "labels": self.labels[nodes],
            "seed_mask": seed_mask,
        }

    @staticmethod
    def subgraph_shapes(batch: int, f1: int, f2: int, d_feat: int):
        n_sub = batch * (1 + f1 + f1 * f2)
        e_sub = batch * (f1 + f1 * f2)
        return n_sub, e_sub
