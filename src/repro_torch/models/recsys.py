"""RecSys models of the port: FM, DLRM (RM2), DIEN (GRU + AUGRU) and
BERT4Rec, with the EmbeddingBag, the losses and the retrieval tower.

The embedding lookup is a plain row gather by default
(:func:`repro_torch.dist.collectives.sharded_table_lookup`, vocab-sharded
on a mesh); every entry point takes a ``lookup_fn(table, ids)`` so the
paper's PIR schemes can replace it
(:class:`repro_torch.core.private_embedding.PrivateEmbedding`, bit-exact).
Bags are summed by :func:`repro_torch.models.layers.segment_sum`, which
gives the same bits on every call. BERT4Rec's attention goes through
:func:`repro_torch.models.layers.gqa_attention` (non-causal): on the card,
one flash-kernel launch per block.

Uniform API per model M ∈ {fm, dlrm, dien, bert4rec}:
    M_init(gen, cfg, device)         -> params (a ParamTree)
    M_score(params, cfg, batch)      -> logits (bert4rec: bert4rec_logits)
    user_vector(params, cfg, batch)  -> [B, embed_dim]   (retrieval tower)
    retrieval_scores(user_vec, cand) -> [B, n_candidates]

The weights carry no gradient and nothing here turns autograd off: with
weights that require it, the scores and losses differentiate as they are
(``repro_torch.train.recsys_loss_fn``). On the card BERT4Rec's attention
runs forward on the flash kernel and takes its gradient from the
reference's plain attention, recomputed in the backward
(:class:`repro_torch.models.layers._FlashAttention`).
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import RecSysConfig
from repro_torch.dist.collectives import sharded_table_lookup
from repro_torch.models import layers as L

__all__ = [
    "FM",
    "DLRM",
    "DIEN",
    "BERT4Rec",
    "embedding_bag",
    "bce_loss",
    "fm_spec", "fm_init", "fm_score",
    "dlrm_spec", "dlrm_init", "dlrm_score",
    "dien_spec", "dien_init", "dien_score",
    "bert4rec_vocab", "bert4rec_init", "bert4rec_hidden", "bert4rec_logits",
    "bert4rec_masked_xent",
    "user_vector",
    "retrieval_scores",
]

LookupFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _default_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return sharded_table_lookup(table, ids)


def _on(x, device: torch.device, dtype=None) -> torch.Tensor:
    """A batch entry (numpy or torch) as a tensor on ``device``."""
    return torch.as_tensor(x, device=device, dtype=dtype)


class _Model(L.ParamTree):
    """A recommender's parameters in the reference's layout, with its
    config."""

    def __init__(self, tree: Dict, cfg: RecSysConfig):
        super().__init__(tree)
        self.cfg = cfg


class FM(_Model):
    """FM: ``embed`` [V, K], ``linear`` [V, 1], ``bias`` []."""


class DLRM(_Model):
    """DLRM: ``embed`` [V, D], the ``bot`` and ``top`` MLPs."""


class DIEN(_Model):
    """DIEN: ``embed`` [items, D], ``gru1``, ``augru``, ``att_w``,
    ``mlp``."""


class BERT4Rec(_Model):
    """BERT4Rec: ``embed``, ``pos``, ``blocks`` (a list), ``final_ln``."""


# --------------------------------------------------------------------------
# EmbeddingBag (gather + segment sum) and the click loss
# --------------------------------------------------------------------------
def embedding_bag(
    table: torch.Tensor,
    flat_ids,                   # [nnz]
    segment_ids,                # [nnz] -> bag id
    num_bags: int,
    combiner: str = "sum",
    lookup_fn: LookupFn = _default_lookup,
) -> torch.Tensor:
    """[num_bags, dim]: each bag's rows summed (``"sum"``) or averaged
    (``"mean"``; an empty bag is 0)."""
    if combiner not in ("sum", "mean"):
        raise ValueError(f"unknown combiner {combiner!r}")
    rows = lookup_fn(table, _on(flat_ids, table.device))
    seg = _on(segment_ids, rows.device)
    out = L.segment_sum(rows, seg, num_bags)
    if combiner == "mean":
        cnt = L.segment_sum(
            torch.ones(seg.shape, dtype=torch.float32, device=rows.device),
            seg, num_bags)
        out = out / torch.clamp(cnt, min=1.0)[:, None]
    return out


def bce_loss(logits: torch.Tensor, labels) -> torch.Tensor:
    """Mean binary cross-entropy on logits (the stable form)."""
    z = logits.float()
    y = _on(labels, z.device, torch.float32)
    return torch.mean(torch.clamp(z, min=0) - z * y
                      + torch.log1p(torch.exp(-torch.abs(z))))


def _field_offsets(cfg: RecSysConfig, device) -> torch.Tensor:
    """Each field's first row in the one table of all fields."""
    return torch.arange(cfg.n_sparse, device=device) * cfg.vocab_per_field


def _field_ids(cfg: RecSysConfig, ids, device) -> torch.Tensor:
    return _on(ids, device).long() + _field_offsets(cfg, device)[None, :]


def _model_init(cls, spec, gen: torch.Generator, cfg: RecSysConfig,
                device: DeviceLike):
    """Every leaf of ``spec`` allocated once on ``device`` (``None``: the
    card) and drawn from ``gen`` a block at a time, in f32."""
    return cls(L.init_leaves(spec, gen, torch.float32, resolve_device(device)),
               cfg)


# --------------------------------------------------------------------------
# FM — Rendle ICDM'10: pairwise ⟨v_i, v_j⟩x_i x_j via the O(nk) trick
# --------------------------------------------------------------------------
def fm_spec(cfg: RecSysConfig) -> Dict:
    v = cfg.n_sparse * cfg.vocab_per_field
    return {"embed": L.Leaf((v, cfg.embed_dim), 0.01),
            "linear": L.Leaf((v, 1), 0.01),
            "bias": L.Leaf((), None)}


def fm_init(gen: torch.Generator, cfg: RecSysConfig,
            device: DeviceLike = None) -> FM:
    return _model_init(FM, fm_spec(cfg), gen, cfg, device)


def fm_score(params, cfg: RecSysConfig, batch: Dict,
             lookup_fn: LookupFn = _default_lookup) -> torch.Tensor:
    """batch["ids"]: [B, n_sparse] per-field ids -> logits [B]."""
    tree = L.as_tree(params)
    ids = _field_ids(cfg, batch["ids"], tree["embed"].device)
    emb = lookup_fn(tree["embed"], ids)                  # [B, F, K]
    lin = lookup_fn(tree["linear"], ids)[..., 0]         # [B, F]
    s = torch.sum(emb, dim=1)                            # Σ v_i x_i
    s2 = torch.sum(emb * emb, dim=1)                     # Σ (v_i x_i)²
    pair = 0.5 * torch.sum(s * s - s2, dim=-1)           # sum-square trick
    return tree["bias"] + torch.sum(lin, dim=1) + pair


# --------------------------------------------------------------------------
# DLRM (arXiv:1906.00091), RM2 flavour: bot MLP + dot interaction + top MLP
# --------------------------------------------------------------------------
def dlrm_spec(cfg: RecSysConfig) -> Dict:
    v = cfg.n_sparse * cfg.vocab_per_field
    n_feat = cfg.n_sparse + 1
    n_pairs = n_feat * (n_feat - 1) // 2
    return {"embed": L.Leaf((v, cfg.embed_dim), 0.01),
            "bot": L.gelu_mlp_spec((cfg.n_dense,) + cfg.bot_mlp),
            "top": L.gelu_mlp_spec((cfg.bot_mlp[-1] + n_pairs,)
                                   + cfg.top_mlp)}


def dlrm_init(gen: torch.Generator, cfg: RecSysConfig,
              device: DeviceLike = None) -> DLRM:
    return _model_init(DLRM, dlrm_spec(cfg), gen, cfg, device)


def dlrm_score(params, cfg: RecSysConfig, batch: Dict,
               lookup_fn: LookupFn = _default_lookup) -> torch.Tensor:
    """batch: dense [B, n_dense] f32, ids [B, n_sparse] -> logits [B]."""
    tree = L.as_tree(params)
    dev = tree["embed"].device
    x_bot = L.gelu_mlp(tree["bot"], _on(batch["dense"], dev, torch.float32),
                       final_act=True)                           # [B, D]
    emb = lookup_fn(tree["embed"], _field_ids(cfg, batch["ids"], dev))
    z = torch.cat([x_bot[:, None, :], emb], dim=1)               # [B, F+1, D]
    inter = torch.bmm(z, z.transpose(1, 2))                      # dot interaction
    f = z.shape[1]
    iu, ju = torch.triu_indices(f, f, offset=1, device=dev)      # row-major
    pairs = inter[:, iu, ju]                                     # [B, F(F+1)/2]
    top_in = torch.cat([x_bot, pairs], dim=1)
    return L.gelu_mlp(tree["top"], top_in)[:, 0]


# --------------------------------------------------------------------------
# DIEN (arXiv:1809.03672): GRU interest extractor + AUGRU interest evolution
# --------------------------------------------------------------------------
def _gru_spec(d_in: int, d_h: int) -> Dict:
    s = 1.0 / math.sqrt(d_in + d_h)
    return {k: L.Leaf((d_in + d_h, d_h), s) for k in ("wz", "wr", "wh")}


def _gru_cell(p, h, x, att=None):
    """Standard GRU; AUGRU scales the update gate by the attention score."""
    hx = torch.cat([x, h], dim=-1)
    z = torch.sigmoid(hx @ p["wz"])
    r = torch.sigmoid(hx @ p["wr"])
    hh = torch.tanh(torch.cat([x, r * h], dim=-1) @ p["wh"])
    if att is not None:
        z = z * att[:, None]       # attentional update gate (AUGRU)
    return (1.0 - z) * h + z * hh


def dien_spec(cfg: RecSysConfig) -> Dict:
    d, g = cfg.embed_dim, cfg.gru_dim
    return {"embed": L.Leaf((cfg.vocab_per_field, d), 0.01),
            "gru1": _gru_spec(d, g),
            "augru": _gru_spec(g, g),
            "att_w": L.dense_spec(g, d),
            "mlp": L.gelu_mlp_spec((g + 2 * d,) + cfg.mlp_dims + (1,))}


def dien_init(gen: torch.Generator, cfg: RecSysConfig,
              device: DeviceLike = None) -> DIEN:
    return _model_init(DIEN, dien_spec(cfg), gen, cfg, device)


def dien_score(params, cfg: RecSysConfig, batch: Dict,
               lookup_fn: LookupFn = _default_lookup) -> torch.Tensor:
    """batch: hist [B, S] item ids, target [B] item id -> logits [B]. The
    one table is the item vocabulary: ids take no field offset."""
    tree = L.as_tree(params)
    dev = tree["embed"].device
    hist = lookup_fn(tree["embed"], _on(batch["hist"], dev))     # [B, S, D]
    tgt = lookup_fn(tree["embed"], _on(batch["target"], dev))    # [B, D]
    b, s, d = hist.shape
    g = cfg.gru_dim

    # interest extraction: GRU over the behaviour sequence
    h = hist.new_zeros((b, g))
    states = []
    for t in range(s):
        h = _gru_cell(tree["gru1"], h, hist[:, t])
        states.append(h)
    states = torch.stack(states)                                 # [S, B, G]

    # attention of each interest state vs the target item, a softmax over
    # the sequence axis
    att = torch.einsum("sbd,bd->sb", states @ tree["att_w"]["w"], tgt)
    att = torch.softmax(att / math.sqrt(d), dim=0)

    # interest evolution: AUGRU weighted by attention
    h = hist.new_zeros((b, g))
    for t in range(s):
        h = _gru_cell(tree["augru"], h, states[t], att=att[t])

    # the reference also computes an attention pool of the states and
    # discards it; the logits do not depend on it, so it is left out
    feats = torch.cat([h, tgt, torch.sum(hist, dim=1) / s], dim=-1)
    return L.gelu_mlp(tree["mlp"], feats)[:, 0]


# --------------------------------------------------------------------------
# BERT4Rec (arXiv:1904.06690): bidirectional transformer over item sequence
# --------------------------------------------------------------------------
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
    embed = L.init_leaves({"t": L.Leaf((vocab, d), 0.02)}, gen,
                          torch.float32, dev)["t"]
    pos = L.init_leaves({"t": L.Leaf((cfg.seq_len, d), 0.02)}, gen,
                        torch.float32, dev)["t"]

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


def bert4rec_hidden(
    params, cfg: RecSysConfig, seq,
    lookup_fn: LookupFn = _default_lookup,
) -> torch.Tensor:
    """seq: [B, S] item ids -> hidden [B, S, D] (bidirectional encoder)."""
    tree = L.as_tree(params)
    seq = _on(seq, tree["embed"].device)
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


def bert4rec_logits(
    params, cfg: RecSysConfig, seq,
    lookup_fn: LookupFn = _default_lookup,
) -> torch.Tensor:
    """[B, S] -> LAST-position next-item logits [B, vocab] (tied head)."""
    tree = L.as_tree(params)
    x = bert4rec_hidden(tree, cfg, seq, lookup_fn)
    return torch.einsum("bd,vd->bv", x[:, -1], tree["embed"])


def bert4rec_masked_xent(params, cfg: RecSysConfig, batch: Dict,
                         lookup_fn: LookupFn = _default_lookup
                         ) -> torch.Tensor:
    """batch: seq (with [MASK] ids), labels, mask [B, S] -> the mean
    cross-entropy of the masked positions over the item vocabulary. The
    [B, S, V] logits are made in 8 sequence chunks (when S divides by 8),
    one chunk at a time. (The reference recomputes each chunk in the
    backward pass, which changes gradients' memory, not values.)"""
    tree = L.as_tree(params)
    x = bert4rec_hidden(tree, cfg, batch["seq"], lookup_fn)     # [B, S, D]
    b, s, _ = x.shape
    n_chunks = 8 if s % 8 == 0 else 1
    chunk = s // n_chunks
    labels = _on(batch["labels"], x.device).long()
    mask = _on(batch["mask"], x.device).float()
    nll, cnt = [], []
    for c in range(n_chunks):
        cut = slice(c * chunk, (c + 1) * chunk)
        logits = torch.einsum("bcd,vd->bcv", x[:, cut], tree["embed"]).float()
        m = torch.amax(logits, dim=-1, keepdim=True).detach()
        lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
        tgt = torch.gather(logits, -1, labels[:, cut, None])[..., 0]
        w = mask[:, cut]
        nll.append(torch.sum((lse - tgt) * w))
        cnt.append(torch.sum(w))
    return torch.stack(nll).sum() / torch.clamp(torch.stack(cnt).sum(),
                                                min=1.0)


# --------------------------------------------------------------------------
# Retrieval tower (retrieval_cand shape: score 1M candidates, no loop)
# --------------------------------------------------------------------------
def user_vector(params, cfg: RecSysConfig, batch: Dict,
                lookup_fn: LookupFn = _default_lookup) -> torch.Tensor:
    """[B, embed_dim] query-side vector per model family."""
    tree = L.as_tree(params)
    dev = tree["embed"].device
    if cfg.model == "fm":
        ids = _field_ids(cfg, batch["ids"], dev)
        return torch.sum(lookup_fn(tree["embed"], ids), dim=1)
    if cfg.model == "dlrm":
        return L.gelu_mlp(tree["bot"], _on(batch["dense"], dev, torch.float32),
                          final_act=True)
    if cfg.model == "dien":
        return torch.mean(lookup_fn(tree["embed"], _on(batch["hist"], dev)),
                          dim=1)
    if cfg.model == "bert4rec":
        return bert4rec_hidden(tree, cfg, batch["seq"], lookup_fn)[:, -1]
    raise ValueError(cfg.model)


def retrieval_scores(user_vec: torch.Tensor, cand: torch.Tensor
                     ) -> torch.Tensor:
    """user_vec: [B, D]; cand: [n_cand, D] -> [B, n_cand], one batched
    product (no per-candidate loop)."""
    return torch.einsum("bd,nd->bn", user_vec, cand)
