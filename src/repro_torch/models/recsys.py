"""RecSys models of the port: BERT4Rec (arXiv:1904.06690), a bidirectional
transformer over a user's item history, served at the last position.

The item-embedding lookup is a plain row gather by default; every entry
point takes a ``lookup_fn(table, ids)`` so the paper's PIR schemes can
replace it (:class:`repro_torch.core.private_embedding.PrivateEmbedding`,
bit-exact). The encoder's attention goes through
:func:`repro_torch.models.layers.gqa_attention` (non-causal): on the card,
one flash-kernel launch per block.

Not ported yet (ROADMAP.md Queue A item 13): FM, DLRM, DIEN,
``embedding_bag``, the masked-item loss and the retrieval tower.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import RecSysConfig
from repro_torch.dist.collectives import sharded_table_lookup
from repro_torch.models import layers as L

__all__ = [
    "BERT4Rec",
    "bert4rec_vocab",
    "bert4rec_init",
    "bert4rec_hidden",
    "bert4rec_logits",
]

LookupFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _default_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return sharded_table_lookup(table, ids)


class BERT4Rec(L.ParamTree):
    """BERT4Rec's parameters in the reference's layout (``embed``, ``pos``,
    ``blocks`` (a list), ``final_ln``), with its config."""

    def __init__(self, tree: Dict, cfg: RecSysConfig):
        super().__init__(tree)
        self.cfg = cfg


def bert4rec_vocab(cfg: RecSysConfig) -> int:
    """items + pad + mask, padded to a shardable multiple of 64."""
    return -(-(cfg.n_items + 2) // 64) * 64


def bert4rec_init(gen: torch.Generator, cfg: RecSysConfig,
                  device: DeviceLike = None) -> BERT4Rec:
    """Random float32 weights from ``gen`` on ``device`` (``None``: the
    card)."""
    dev = resolve_device(device)
    d = cfg.embed_dim
    vocab = bert4rec_vocab(cfg)
    embed = (L._normal(gen, (vocab, d)) * 0.02).to(dev)
    pos = (L._normal(gen, (cfg.seq_len, d)) * 0.02).to(dev)

    def block_init():
        return {
            "ln1": L.layernorm_init(d, device=dev),
            "ln2": L.layernorm_init(d, device=dev),
            "wq": L.dense_init(gen, d, d, device=dev),
            "wk": L.dense_init(gen, d, d, device=dev),
            "wv": L.dense_init(gen, d, d, device=dev),
            "wo": L.dense_init(gen, d, d, device=dev),
            "mlp": L.gelu_mlp_init(gen, (d, 4 * d, d), device=dev),
        }

    return BERT4Rec(
        {"embed": embed, "pos": pos,
         "blocks": [block_init() for _ in range(cfg.n_blocks)],
         "final_ln": L.layernorm_init(d, device=dev)},
        cfg,
    )


@torch.no_grad()
def bert4rec_hidden(
    params, cfg: RecSysConfig, seq: torch.Tensor,
    lookup_fn: LookupFn = _default_lookup,
) -> torch.Tensor:
    """seq: [B, S] item ids -> hidden [B, S, D] (bidirectional encoder)."""
    tree = L.as_tree(params)
    seq = torch.as_tensor(seq, device=tree["embed"].device)
    b, s = seq.shape
    d, h = cfg.embed_dim, cfg.n_heads
    x = lookup_fn(tree["embed"], seq) + tree["pos"][None, :s]
    for blk in tree["blocks"]:
        y = L.layernorm(blk["ln1"], x)
        q = L.dense(blk["wq"], y).reshape(b, s, h, d // h)
        k = L.dense(blk["wk"], y).reshape(b, s, h, d // h)
        v = L.dense(blk["wv"], y).reshape(b, s, h, d // h)
        a = L.gqa_attention(q, k, v, causal=False)
        x = x + L.dense(blk["wo"], a.reshape(b, s, d))
        x = x + L.gelu_mlp(blk["mlp"], L.layernorm(blk["ln2"], x))
    return L.layernorm(tree["final_ln"], x)


@torch.no_grad()
def bert4rec_logits(
    params, cfg: RecSysConfig, seq: torch.Tensor,
    lookup_fn: LookupFn = _default_lookup,
) -> torch.Tensor:
    """[B, S] -> LAST-position next-item logits [B, vocab] (tied head)."""
    tree = L.as_tree(params)
    x = bert4rec_hidden(tree, cfg, seq, lookup_fn)
    return torch.einsum("bd,vd->bv", x[:, -1], tree["embed"])
