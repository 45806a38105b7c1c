"""Shared neural-net layers of the port (functional, on explicit devices).

Parameters are nested dicts of tensors in the reference package's layout
(``{"w": [d_in, d_out]}``, ``{"scale": [d]}``, ...), so the same weights,
carried across as numpy by :mod:`repro_torch.convert`, go through both
packages. A model holds them in a :class:`ParamTree` (an ``nn.Module``);
every layer is an ``*_init(gen, ..., device) -> params`` plus an
``apply(params, x, ...)`` pair. Initialisation draws from a
``torch.Generator`` (its own numbers, not the reference's).

Attention on a CUDA tensor goes through the hand-written flash kernel
(:func:`repro_torch.kernels.flash_attention.flash_attention_fwd`), its
gradient through the reference's plain ``_attn_core``
(:class:`_FlashAttention`); on a CPU tensor it is the plain path both
ways.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.kernels.flash_attention import flash_attention_fwd

__all__ = [
    "ParamTree",
    "as_tree",
    "Leaf",
    "fill_normal_",
    "alloc_leaves",
    "fill_leaves_",
    "init_leaves",
    "dense_spec",
    "dense_init",
    "dense",
    "rmsnorm_spec",
    "rmsnorm_init",
    "rmsnorm",
    "layernorm_init",
    "layernorm",
    "embedding_init",
    "rope",
    "softcap",
    "gqa_attention",
    "decode_attention",
    "swiglu_spec",
    "swiglu_init",
    "swiglu",
    "gelu_mlp_spec",
    "gelu_mlp_init",
    "gelu_mlp",
    "segment_sum",
    "ATTN_CHUNK_Q",
]

Tree = Union[Dict[str, "Tree"], list, torch.Tensor]


# ----------------------------------------------------------- parameters
class ParamTree(nn.Module):
    """An ``nn.Module`` holding a nested dict (or list) of tensors as
    parameters (no gradient: training differentiates detached copies of
    the tensors, ``repro_torch.train.make_train_step``), under the same
    names.
    :meth:`tree` hands back the nested structure of the same tensors."""

    def __init__(self, tree: Tree):
        super().__init__()
        self._kind = "list" if isinstance(tree, (list, tuple)) else "dict"
        items = enumerate(tree) if self._kind == "list" else tree.items()
        self._keys = []
        for key, val in items:
            name = f"i{key}" if self._kind == "list" else key
            self._keys.append(name)
            if isinstance(val, torch.Tensor):
                self.register_parameter(
                    name, nn.Parameter(val.detach(), requires_grad=False)
                )
            else:
                self.add_module(name, ParamTree(val))

    def tree(self) -> Tree:
        vals = []
        for name in self._keys:
            child = getattr(self, name)
            vals.append(child.tree() if isinstance(child, ParamTree) else child)
        if self._kind == "list":
            return vals
        return dict(zip(self._keys, vals))


def as_tree(params) -> Tree:
    """A :class:`ParamTree` (or a model built on one) -> its nested dict;
    a nested dict passes through."""
    return params.tree() if isinstance(params, ParamTree) else params


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32)


# a block of draws in f32: 256 MB
_DRAW_ELEMS = 1 << 26


def fill_normal_(out: torch.Tensor, gen: torch.Generator,
                 scale: float) -> torch.Tensor:
    """``out`` <- N(0, 1)·``scale`` from ``gen``, drawn in f32 on the
    generator's device a block of leading rows at a time (at most
    ``_DRAW_ELEMS`` values) and cast into ``out``'s dtype and device: a
    leaf never exists whole in f32 (a Kimi-K2 expert leaf, [384, 7168,
    2048], would be 22.5 GB). A ``meta`` tensor holds no values: nothing
    is drawn for it (a dry run builds a model's shapes only)."""
    if out.device.type == "meta":
        return out
    if out.dim() == 0 or out.numel() <= _DRAW_ELEMS:
        return out.copy_(_normal(gen, out.shape) * scale)
    per_row = out[0].numel()
    if per_row > _DRAW_ELEMS:
        for row in out:
            fill_normal_(row, gen, scale)
        return out
    step = _DRAW_ELEMS // per_row
    for r in range(0, out.shape[0], step):
        block = out[r:r + step]
        block.copy_(_normal(gen, block.shape) * scale)
    return out


class Leaf(NamedTuple):
    """How one parameter is initialised: its shape, N(0, 1)·``scale``
    (``None``: zeros) and its dtype (``None``: the model's)."""

    shape: Tuple[int, ...]
    scale: Optional[float]
    dtype: Optional[torch.dtype] = None


def alloc_leaves(spec, dtype: torch.dtype, device: torch.device,
                 lead: Tuple[int, ...] = ()):
    """A nested dict of :class:`Leaf` -> the same dict of uninitialised
    tensors, each ``lead + leaf.shape``, allocated once."""
    if isinstance(spec, Leaf):
        return torch.empty(tuple(lead) + tuple(spec.shape),
                           dtype=spec.dtype or dtype, device=device)
    return {k: alloc_leaves(v, dtype, device, lead) for k, v in spec.items()}


def fill_leaves_(tree, spec, gen: torch.Generator, index=None):
    """Fills ``tree`` (or its entry ``index`` along the lead dim, a layer
    of a stacked tree) as ``spec`` says, leaf by leaf in the spec's
    order, in place."""
    if isinstance(spec, Leaf):
        out = tree if index is None else tree[index]
        if spec.scale is None:
            out.zero_()
        else:
            fill_normal_(out, gen, spec.scale)
        return tree
    for k, v in spec.items():
        fill_leaves_(tree[k], v, gen, index)
    return tree


def init_leaves(spec, gen: torch.Generator, dtype: torch.dtype,
                device: DeviceLike = None):
    """A nested dict of :class:`Leaf` -> its tensors, drawn from ``gen``
    on ``device`` (``None``: the card)."""
    return fill_leaves_(alloc_leaves(spec, dtype, resolve_device(device)),
                        spec, gen)


# ----------------------------------------------------------------- dense
def dense_spec(d_in: int, d_out: int) -> Dict[str, Leaf]:
    return {"w": Leaf((d_in, d_out), 1.0 / math.sqrt(d_in))}


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, device: DeviceLike = None):
    return init_leaves(dense_spec(d_in, d_out), gen, dtype, device)


def dense(params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"].to(x.dtype)


# ------------------------------------------------------------------ norm
def rmsnorm_spec(d: int) -> Dict[str, Leaf]:
    return {"scale": Leaf((d,), None)}


def rmsnorm_init(d: int, dtype=torch.float32, device: DeviceLike = None):
    # gemma-style (1 + scale)
    return {"scale": torch.zeros((d,), dtype=dtype, device=resolve_device(device))}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].float())).to(x.dtype)


def layernorm_init(d: int, dtype=torch.float32, device: DeviceLike = None):
    dev = resolve_device(device)
    return {"scale": torch.ones((d,), dtype=dtype, device=dev),
            "bias": torch.zeros((d,), dtype=dtype, device=dev)}


def layernorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


# ------------------------------------------------------------- embedding
def embedding_init(gen: torch.Generator, vocab: int, d: int,
                   dtype=torch.float32, device: DeviceLike = None):
    return init_leaves({"table": Leaf((vocab, d), 0.02)}, gen, dtype,
                       device)


# ------------------------------------------------------------------ rope
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] (or [S]) int."""
    d = x.shape[-1]
    half = d // 2
    expo = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device),
                     expo)
    ang = positions.to(x.device)[..., None].float() * freq  # [B, S, half]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0.0:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


# ------------------------------------------------------------- attention
def _repeat_kv(kv: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, S, Hkv, D] -> [B, S, Hkv*groups, D] (GQA broadcast)."""
    b, s, h, d = kv.shape
    kv = kv[:, :, :, None, :].expand(b, s, h, groups, d)
    return kv.reshape(b, s, h * groups, d)


def _attn_core(q, k, v, qpos, kpos, causal, window, attn_softcap, dh):
    """Masked softmax attention over pre-broadcast K/V. q: [B,Sq,Hq,D].

    The reference's plain path: the [Sq, Sk] scores, the mask constant and
    the softmax stay in the input dtype."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.tensor(
        math.sqrt(dh), dtype=q.dtype, device=q.device
    )
    scores = softcap(scores, attn_softcap)
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    neg = -1e30 if q.dtype == torch.float32 else -3e38
    scores = scores.masked_fill(~mask[None, None], neg)
    probs = torch.softmax(scores, dim=-1)  # stays in q.dtype end to end
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


ATTN_CHUNK_Q = 2048  # query blocking threshold/size of the plain path


def _flash(q, k, v, causal, window, softcap, q_offset) -> torch.Tensor:
    """[B, Sq, H, D] (K/V already broadcast) through the flash kernel's
    [B·H, S, D] layout and back."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qf = q.permute(0, 2, 1, 3).reshape(b * h, sq, d).contiguous()
    kf = k.permute(0, 2, 1, 3).reshape(b * h, sk, d).contiguous()
    vf = v.permute(0, 2, 1, 3).reshape(b * h, sk, d).contiguous()
    out = flash_attention_fwd(qf, kf, vf, causal=causal, window=window,
                              softcap=softcap, q_offset=q_offset)
    return out.reshape(b, h, sq, d).permute(0, 2, 1, 3)


def _query_blocks(sq: int):
    """(lo, hi) of each query block of the plain path: queries longer than
    ``ATTN_CHUNK_Q`` (and a multiple of it) in blocks of it, else one."""
    chunk = ATTN_CHUNK_Q if sq > ATTN_CHUNK_Q and sq % ATTN_CHUNK_Q == 0 else sq
    return [(lo, lo + chunk) for lo in range(0, sq, chunk)]


def _plain_attention(q, k, v, causal, window, attn_softcap, q_offset):
    """The reference's plain path over pre-broadcast K/V, a block of
    queries at a time (:func:`_query_blocks`), so the [Sq, Skv] scores of
    a long prefill never materialise whole."""
    dh = q.shape[3]
    kpos = torch.arange(k.shape[1], device=q.device)
    qpos = torch.arange(q.shape[1], device=q.device) + q_offset
    outs = [_attn_core(q[:, lo:hi], k, v, qpos[lo:hi], kpos, causal, window,
                       attn_softcap, dh)
            for lo, hi in _query_blocks(q.shape[1])]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


class _FlashAttention(torch.autograd.Function):
    """The flash kernel's forward with the reference's gradient.

    Forward: :func:`_flash`, the kernel launch, on K/V already broadcast
    over the query groups (autograd sums their gradient over the groups,
    as it does through :func:`_repeat_kv` on the CPU). q, k and v are
    saved for the backward and nothing else; autograd drops them when it
    records no node (grad mode off, or no input requires grad).

    Backward: the plain ``_attn_core`` recomputed under
    ``torch.enable_grad()`` on detached inputs, a block of queries at a
    time (:func:`_query_blocks`, the reference's remat'd
    ``lax.map``), differentiated by ``torch.autograd.grad``. That is the
    function ``jax.grad`` differentiates in the reference, which has no
    backward kernel either (no ``custom_vjp``): no kernel exists here for
    this code to stand in for, and the forward runs only on the kernel.
    It runs under the profiler range ``attention_backward``, so that a
    trace can tell its time apart."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, softcap, q_offset)
        return _flash(q, k, v, causal, window, softcap, q_offset)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        causal, window, softcap, q_offset = ctx.args
        dh = q.shape[3]
        kpos = torch.arange(k.shape[1], device=q.device)
        dq, dk, dv = [], None, None
        with torch.profiler.record_function("attention_backward"):
            kd, vd = k.detach().requires_grad_(), v.detach().requires_grad_()
            for lo, hi in _query_blocks(q.shape[1]):
                qc = q[:, lo:hi].detach().requires_grad_()
                qpos = torch.arange(lo, hi, device=q.device) + q_offset
                with torch.enable_grad():
                    out = _attn_core(qc, kd, vd, qpos, kpos, causal, window,
                                     softcap, dh)
                    g = torch.autograd.grad(out, (qc, kd, vd),
                                            grad_out[:, lo:hi])
                dq.append(g[0])
                dk = g[1] if dk is None else dk + g[1]
                dv = g[2] if dv is None else dv + g[2]
        return torch.cat(dq, dim=1), dk, dv, None, None, None, None


def gqa_attention(
    q: torch.Tensor,              # [B, Sq, Hq, D]
    k: torch.Tensor,              # [B, Skv, Hkv, D]
    v: torch.Tensor,              # [B, Skv, Hkv, D]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    attn_softcap: float = 0.0,
    q_offset: Union[int, torch.Tensor] = 0,
) -> torch.Tensor:
    """GQA attention with an optional local window. Returns [B, Sq, Hq, D].

    ``q_offset`` shifts query positions (prefill = 0); ``attn_softcap``
    caps the scaled scores (gemma-2) before the mask.

    On a CUDA tensor: K/V broadcast over the query groups, then the flash
    kernel, which takes the softcap and the offset (f32 scores, cap and
    softmax inside, the result in q's dtype); there is no fallback to the
    plain path. The launch goes through :class:`_FlashAttention`, whose
    backward differentiates the reference's plain path (the reference
    trains through it; there is no backward kernel). Under
    ``torch.no_grad()`` (serving), or when no input requires grad,
    autograd records no node and keeps nothing that the Function saved.

    On a CPU tensor: the reference's plain path, a block of queries at a
    time (:func:`_query_blocks`)."""
    hq, hkv = q.shape[2], k.shape[2]
    k = _repeat_kv(k, hq // hkv)
    v = _repeat_kv(v, hq // hkv)
    window = None if window is None else int(window)
    if q.device.type != "cpu":
        return _FlashAttention.apply(q, k, v, causal, window,
                                     float(attn_softcap), int(q_offset))
    return _plain_attention(q, k, v, causal, window, attn_softcap, q_offset)


def decode_attention(
    q: torch.Tensor,              # [B, 1, Hq, D]
    k_cache: torch.Tensor,        # [B, Smax, Hkv, D]
    v_cache: torch.Tensor,
    length,                       # number of valid cache entries
    *,
    window: Optional[int] = None,
    attn_softcap: float = 0.0,
    kv_seq_axes: tuple = (),
) -> torch.Tensor:
    """One-token decode against a (possibly sequence-sharded) KV cache.

    When ``kv_seq_axes`` names mesh axes, runs the flash-decode combine
    (:func:`repro_torch.dist.flash_decode.flash_decode`: each cache chunk's
    (max, sum-of-exp, weighted-V) triple, summed across the chunks; it
    comes back here when no mesh shards the cache). Otherwise a plain
    masked softmax over the whole cache, on either device (the reference
    has no Pallas kernel for it)."""
    if kv_seq_axes:
        from repro_torch.dist.flash_decode import flash_decode  # no cycle

        return flash_decode(
            q, k_cache, v_cache, length,
            axis_names=kv_seq_axes, window=window, attn_softcap=attn_softcap,
        )
    b, _, hq, dh = q.shape
    hkv = k_cache.shape[2]
    k = _repeat_kv(k_cache, hq // hkv)
    v = _repeat_kv(v_cache, hq // hkv)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
    scores = softcap(scores, attn_softcap)
    kpos = torch.arange(k.shape[1], device=q.device)[None, None, None, :]
    mask = kpos < length
    if window is not None:
        mask &= kpos > length - 1 - int(window)  # only the last `window` tokens
    scores = torch.where(mask, scores.float(), -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# ------------------------------------------------------------------- mlp
def swiglu_spec(d: int, d_ff: int) -> Dict[str, Dict[str, Leaf]]:
    return {"wi": dense_spec(d, d_ff), "wg": dense_spec(d, d_ff),
            "wo": dense_spec(d_ff, d)}


def swiglu_init(gen: torch.Generator, d: int, d_ff: int, dtype=torch.float32,
                device: DeviceLike = None):
    return init_leaves(swiglu_spec(d, d_ff), gen, dtype, device)


def swiglu(params, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(dense(params["wg"], x)) * dense(params["wi"], x)
    return dense(params["wo"], h)


def gelu_mlp_spec(dims) -> Dict[str, Dict[str, Leaf]]:
    return {f"l{i}": dense_spec(dims[i], dims[i + 1])
            for i in range(len(dims) - 1)}


def gelu_mlp_init(gen: torch.Generator, dims, dtype=torch.float32,
                  device: DeviceLike = None):
    return init_leaves(gelu_mlp_spec(dims), gen, dtype, device)


def gelu_mlp(params, x: torch.Tensor, final_act: bool = False) -> torch.Tensor:
    n = len(params)
    for i in range(n):
        x = dense(params[f"l{i}"], x)
        if i < n - 1 or final_act:
            x = F.gelu(x, approximate="tanh")  # jax.nn.gelu's default
    return x


# ----------------------------------------------------------- segment sum
def segment_sum(data: torch.Tensor, segment_ids,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: ``out[s] = Σ data[i]`` over the ``i`` with
    ``segment_ids[i] == s``, for s in [0, num_segments); ids outside that
    range are dropped. [nnz, ...] -> [num_segments, ...].

    The same inputs give the same bits on every call, on the card too: the
    rows are put in segment order by a stable sort and each segment is
    summed in that order by one thread of ``torch.segment_reduce``. ``index_add_`` on a CUDA tensor
    adds with atomics, in whatever order the threads arrive, so two runs,
    or a private and a plain lookup of the same rows, could differ in
    their last bits."""
    seg = torch.as_tensor(segment_ids, device=data.device).reshape(-1).long()
    if seg.shape[0] != data.shape[0]:
        raise ValueError(f"{seg.shape[0]} segment ids for {data.shape[0]} rows")
    # segment s is summed as s + 1; dropped ids go to one extra segment
    # before (negative) or after (too large) them, cut off below
    seg = torch.clamp(seg + 1, 0, num_segments + 1)
    order = torch.argsort(seg, stable=True)
    seg, data = seg[order], data[order]
    bounds = torch.searchsorted(
        seg, torch.arange(num_segments + 3, device=seg.device))
    out = torch.segment_reduce(data, "sum", lengths=bounds.diff(),
                               unsafe=True, initial=0)
    return out[1:num_segments + 1]
