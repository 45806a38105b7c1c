"""Decoder-only transformer LM of the port: the training loss and the
serving half (prefill and decode), dense and MoE (:mod:`.moe`), GQA/RoPE/RMSNorm/SwiGLU, gemma-2's
local/global alternation and logit softcaps, tied embeddings. One code
path covers the five LM archs of the reference.

Parameters are held by a :class:`TransformerLM` (an ``nn.Module``) in the
reference's stacked layout: ``embed`` [V, D], ``layers`` with every leaf
[L, ...], ``final_norm``. The layer loop is a Python loop over that stack
(the reference's ``lax.scan``). Prefill attention goes through
:func:`repro_torch.models.layers.gqa_attention`, so on the card every layer
launches the flash kernel once (with gemma-2's window and softcap); decode
attends over the cache with the plain masked softmax, as the reference's
single-device branch does.

Training (:func:`train_loss`) runs the same blocks with the gradient
on: ``cfg.remat`` recomputes each block in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``; the
"dots" policy keeps the matmul outputs), and the loss is taken a
``loss_chunk`` of positions at a time, each chunk's logits recomputed in
the backward. On the card the forward attention is the flash kernel and
its gradient the plain path's (:class:`repro_torch.models.layers.
_FlashAttention`); with remat the kernel runs twice a layer a step.

API (the reference's; ``params`` is a :class:`TransformerLM` or its
nested dict):
    init_lm(gen, cfg, device=None)              -> TransformerLM
    train_loss(params, cfg, tokens)             -> (loss, {"nll", "aux"})
    prefill(params, cfg, tokens, max_len)       -> (last_logits, cache)
    decode_step(params, cfg, cache, tok, pos)   -> (logits, cache)
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import LMConfig
from repro_torch.dist.collectives import sharded_vocab_lookup
from repro_torch.dist.sharding import mesh_axis_names
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib

__all__ = ["KVCache", "TransformerLM", "init_lm", "train_loss", "prefill",
           "decode_step"]

_BIG_WINDOW = 1 << 30


class KVCache(NamedTuple):
    k: torch.Tensor  # [L, B, Smax, Hkv, Dh]
    v: torch.Tensor


class TransformerLM(L.ParamTree):
    """The LM's parameters in the reference's stacked layout, with its
    config. ``tree()`` is the reference's parameter pytree."""

    def __init__(self, tree: Dict, cfg: LMConfig):
        super().__init__(tree)
        self.cfg = cfg


def _dtype(cfg: LMConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _layer_windows(cfg: LMConfig) -> torch.Tensor:
    """Per-layer attention window (big = global). Gemma-2: odd layers local."""
    if not cfg.local_global:
        return torch.full((cfg.n_layers,), _BIG_WINDOW, dtype=torch.int32)
    idx = torch.arange(cfg.n_layers)
    return torch.where(idx % 2 == 0, cfg.window, _BIG_WINDOW).to(torch.int32)


def _layer(stacked, i: int):
    """Layer ``i``'s parameters out of the stacked [L, ...] tree (views)."""
    if isinstance(stacked, torch.Tensor):
        return stacked[i]
    return {k: _layer(v, i) for k, v in stacked.items()}


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
def _layer_spec(cfg: LMConfig):
    """One layer's parameters (the reference's ``layer_init``), in the
    order they are drawn."""
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    spec = {
        "ln1": L.rmsnorm_spec(d),
        "ln2": L.rmsnorm_spec(d),
        "wq": L.dense_spec(d, hq * dh),
        "wk": L.dense_spec(d, hkv * dh),
        "wv": L.dense_spec(d, hkv * dh),
        "wo": L.dense_spec(hq * dh, d),
    }
    if cfg.moe:
        spec["moe"] = moe_lib.moe_spec(d, cfg.d_ff, cfg.n_experts)
    else:
        spec["mlp"] = L.swiglu_spec(d, cfg.d_ff)
    return spec


def init_lm(gen: torch.Generator, cfg: LMConfig,
            device: DeviceLike = None) -> TransformerLM:
    """Random weights from ``gen`` on ``device`` (``None``: the card).

    Each stacked ``[L, ...]`` leaf is allocated once and filled layer by
    layer, the draws made a block at a time on the generator's device (a
    generator on the card keeps them there), so the weights never exist
    twice nor whole in f32: Moonlight's 55.4 GB in bf16 need 55.4 GB."""
    dev = resolve_device(device)
    dt = _dtype(cfg)
    embed = L.embedding_init(gen, cfg.vocab, cfg.d_model, dt, dev)["table"]
    spec = _layer_spec(cfg)
    stacked = L.alloc_leaves(spec, dt, dev, lead=(cfg.n_layers,))
    for i in range(cfg.n_layers):
        L.fill_leaves_(stacked, spec, gen, index=i)
    return TransformerLM(
        {"embed": embed, "layers": stacked,
         "final_norm": L.rmsnorm_init(cfg.d_model, dt, dev)},
        cfg,
    )


def _ffn(p, cfg: LMConfig, y):
    """The layer's feed-forward half: SwiGLU, or the MoE block (its aux
    loss is a training quantity and is dropped here, as the reference's
    serving path drops it)."""
    if cfg.moe:
        m, _ = moe_lib.moe_apply(
            p["moe"], y, n_experts=cfg.n_experts, top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor,
        )
        return m
    return L.swiglu(p["mlp"], y)


# --------------------------------------------------------------------------
# shared attention sub-block
# --------------------------------------------------------------------------
def _qkv(p, cfg: LMConfig, x):
    b, s, _ = x.shape
    q = L.dense(p["wq"], x).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = L.dense(p["wk"], x).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = L.dense(p["wv"], x).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def _attn_full(p, cfg: LMConfig, x, window, positions):
    """Prefill attention over the full (causal) sequence."""
    q, k, v = _qkv(p, cfg, x)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    out = L.gqa_attention(
        q, k, v, causal=True, window=window, attn_softcap=cfg.attn_softcap,
    )
    b, s, _, _ = out.shape
    return L.dense(p["wo"], out.reshape(b, s, -1)), k, v


def _tokens(tokens, device: torch.device) -> torch.Tensor:
    if isinstance(tokens, np.ndarray):
        tokens = torch.from_numpy(np.ascontiguousarray(tokens))
    return torch.as_tensor(tokens).to(device)


def _embed_tokens(embed: torch.Tensor, cfg: LMConfig, tokens: torch.Tensor):
    x = sharded_vocab_lookup(embed, tokens)
    # gemma-style scale, rounded to the activations' dtype first
    return x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype, device=x.device)


# --------------------------------------------------------------------------
# training backbone
# --------------------------------------------------------------------------
def _block_train(p, x, cfg: LMConfig, window: int):
    """One block with the gradient on: (x, the MoE aux loss, 0 if dense)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    y = L.rmsnorm(p["ln1"], x)
    h, _, _ = _attn_full(p, cfg, y, window, positions)
    x = x + h
    y2 = L.rmsnorm(p["ln2"], x)
    if cfg.moe:
        m, aux = moe_lib.moe_apply(
            p["moe"], y2, n_experts=cfg.n_experts, top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor,
        )
    else:
        m = L.swiglu(p["mlp"], y2)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + m, aux


# the matmuls the "dots" policy keeps (the reference's
# dots_with_no_batch_dims_saveable): everything else is recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: LMConfig, fn, *args):
    """``fn(*args)`` recomputed in the backward when ``cfg.remat``."""
    if not cfg.remat:
        return fn(*args)
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return checkpoint(fn, *args, use_reentrant=False, **kw)


def _unstack(stacked):
    """The stacked [L, ...] tree -> L per-layer trees (one ``unbind`` a
    leaf: its backward stacks the L gradients at once)."""
    if isinstance(stacked, torch.Tensor):
        return stacked.unbind(0)
    per_key = {k: _unstack(v) for k, v in stacked.items()}
    n = len(next(iter(per_key.values())))
    return [{k: v[i] for k, v in per_key.items()} for i in range(n)]


def _backbone(params, cfg: LMConfig, tokens):
    """tokens [B, S] -> (final-normed x [B, S, D], summed MoE aux)."""
    tree = L.as_tree(params)
    x = _embed_tokens(tree["embed"], cfg, tokens)
    windows = _layer_windows(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, p in enumerate(_unstack(tree["layers"])):
        x, a = _remat(cfg, functools.partial(_block_train, cfg=cfg,
                                             window=int(windows[i])),
                      p, x)
        aux = aux + a
    return L.rmsnorm(tree["final_norm"], x), aux


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------
def _xent_chunk(x, embed, targets, mask, final_softcap):
    """x: [B, C, D]; returns (summed nll, count)."""
    logits = torch.einsum("bcd,vd->bcv", x, embed.to(x.dtype))
    logits = L.softcap(logits, final_softcap).float()
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
    tgt = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = (lse - tgt) * mask
    return torch.sum(nll), torch.sum(mask)


def train_loss(params, cfg: LMConfig, tokens):
    """Next-token LM loss. tokens: [B, S] ints (numpy is moved to the
    parameters' device). Returns (loss, {"nll": loss, "aux": aux}); a MoE
    model's loss adds ``0.01 · aux / n_layers``."""
    tree = L.as_tree(params)
    embed = tree["embed"]
    tokens = _tokens(tokens, embed.device)
    x, aux = _backbone(tree, cfg, tokens)
    targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                        dim=1)
    mask = torch.cat([torch.ones_like(tokens[:, 1:], dtype=torch.float32),
                      torch.zeros_like(tokens[:, :1], dtype=torch.float32)],
                     dim=1)

    b, s, d = x.shape
    chunk = cfg.loss_chunk if cfg.loss_chunk > 0 else s
    n_chunks = max(1, s // chunk)

    def per_chunk(xc, tc, mc):
        return _xent_chunk(xc, embed, tc, mc, cfg.final_softcap)

    xcs = x.reshape(b, n_chunks, chunk, d)
    tcs = targets.reshape(b, n_chunks, chunk)
    mcs = mask.reshape(b, n_chunks, chunk)
    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(n_chunks):
        # recompute the chunk's logits in the backward: never stored
        n_, c_ = checkpoint(per_chunk, xcs[:, c], tcs[:, c], mcs[:, c],
                            use_reentrant=False)
        nll, cnt = nll + n_, cnt + c_
    loss = nll / torch.clamp(cnt, min=1.0)
    if cfg.moe:
        loss = loss + 0.01 * aux / cfg.n_layers
    return loss, {"nll": loss, "aux": aux}


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------
@torch.no_grad()
def prefill(params, cfg: LMConfig, tokens, max_len: int):
    """tokens: [B, S] ints on the parameters' device (numpy is moved
    there); returns (last-position logits [B, V], KVCache with
    ``max_len`` positions, the first S filled)."""
    tree = L.as_tree(params)
    embed = tree["embed"]
    dev = embed.device
    tokens = _tokens(tokens, dev)
    b, s = tokens.shape
    if max_len < s:
        raise ValueError(f"max_len {max_len} < prompt length {s}")
    dt = _dtype(cfg)
    x = _embed_tokens(embed, cfg, tokens)
    windows = _layer_windows(cfg)
    positions = torch.arange(s, device=dev).expand(b, s)
    shape = (cfg.n_layers, b, max_len, cfg.n_kv_heads, cfg.head_dim)
    kc = torch.zeros(shape, dtype=dt, device=dev)
    vc = torch.zeros(shape, dtype=dt, device=dev)
    for i in range(cfg.n_layers):
        p = _layer(tree["layers"], i)
        y = L.rmsnorm(p["ln1"], x)
        h, k, v = _attn_full(p, cfg, y, int(windows[i]), positions)
        x = x + h
        y = L.rmsnorm(p["ln2"], x)
        x = x + _ffn(p, cfg, y)
        kc[i, :, :s] = k.to(dt)
        vc[i, :, :s] = v.to(dt)
    x = L.rmsnorm(tree["final_norm"], x)
    last = x[:, -1]
    logits = last @ embed.T.to(last.dtype)
    logits = L.softcap(logits, cfg.final_softcap)
    return logits, KVCache(k=kc, v=vc)


@torch.no_grad()
def decode_step(params, cfg: LMConfig, cache: KVCache, token, pos):
    """token: [B, 1]; pos: int, the tokens already in the cache. Returns
    (logits [B, V], cache).

    The new position's K/V are written into ``cache`` **in place** (the
    serving idiom: no copy of the whole cache per token) and the same
    cache is returned; its values equal the reference's functional
    update. The cache's sequence is split over mesh axes by flash-decode
    when ``rules["kv_seq"]`` maps to axes of the active mesh."""
    tree = L.as_tree(params)
    embed = tree["embed"]
    dev = embed.device
    token = _tokens(token, dev)
    b = token.shape[0]
    pos = int(pos)
    if not 0 <= pos < cache.k.shape[2]:
        raise ValueError(f"pos {pos} outside a cache of {cache.k.shape[2]}")
    x = _embed_tokens(embed, cfg, token)
    windows = _layer_windows(cfg)
    kv_axes = mesh_axis_names("kv_seq")
    positions = torch.full((b, 1), pos, device=dev)
    for i in range(cfg.n_layers):
        p = _layer(tree["layers"], i)
        y = L.rmsnorm(p["ln1"], x)
        q, k, v = _qkv(p, cfg, y)
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
        kc, vc = cache.k[i], cache.v[i]
        kc[:, pos] = k[:, 0].to(kc.dtype)
        vc[:, pos] = v[:, 0].to(vc.dtype)
        out = L.decode_attention(
            q, kc, vc, pos + 1, window=int(windows[i]),
            attn_softcap=cfg.attn_softcap, kv_seq_axes=kv_axes,
        )
        x = x + L.dense(p["wo"], out.reshape(b, 1, -1))
        y2 = L.rmsnorm(p["ln2"], x)
        x = x + _ffn(p, cfg, y2)
    x = L.rmsnorm(tree["final_norm"], x)
    logits = x[:, 0] @ embed.T.to(x.dtype)
    logits = L.softcap(logits, cfg.final_softcap)
    return logits, cache
