"""Mixture-of-Experts block of the port (top-k routing, capacity dispatch),
the reference's ``models/moe.py`` point for point.

Routing: the router runs in the token dtype and only the [T, E] logits are
upcast to f32 for the softmax; the top k are taken in descending order
with ties to the lower expert id (``jax.lax.top_k``'s order), renormalised
and cast to the token dtype. Capacity positions are sort-based: a stable
sort of the flat expert ids and a ``searchsorted`` give each assignment
its arrival rank within its expert; assignments at rank ``capacity`` or
beyond are dropped, so which ones drop is fixed by that order. Dispatch
and combine run slot by slot with the reference's clipping, so the peak
temporary is [T, D]; the expert FFN (SwiGLU) is three batched products
over the local experts.

The reference has no Pallas kernel here: its expert FFN is three
``einsum``s and its dispatch XLA scatter/gather, so the port's are plain
torch (``bmm``, ``index_put_(accumulate=True)``, gathers) on either device.

Expert parallelism (the reference's ``shard_map`` branch) follows the
port's one-controller mesh: under rules that map "experts" to mesh axes,
each position takes its batch block of tokens and **views** of its expert
block of the global ``[E, D, F]`` weights (moved to its device only when
that is another device: on one card every position is ``cuda:0`` and no
expert weight is copied), routes with its own capacity from its local
token count, and the partial outputs are summed over the expert axes;
``aux`` is summed over them, divided by the expert shards and averaged over
the batch blocks.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch._device import DeviceLike
from repro_torch.dist.collectives import _psum
from repro_torch.dist.sharding import current_mesh, mesh_axis_names
from repro_torch.models.layers import Leaf, init_leaves

__all__ = [
    "moe_spec",
    "moe_init",
    "moe_capacity",
    "moe_route",
    "moe_apply",
    "expert_blocks",
]


def moe_spec(d_model: int, d_ff: int, n_experts: int) -> Dict[str, Leaf]:
    """The block's parameters: the router always f32 (numerics), the
    experts in the model's dtype."""
    s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    return {
        "router": Leaf((d_model, n_experts), s_in, torch.float32),
        "w_gate": Leaf((n_experts, d_model, d_ff), s_in),
        "w_in": Leaf((n_experts, d_model, d_ff), s_in),
        "w_out": Leaf((n_experts, d_ff, d_model), s_out),
    }


def moe_init(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             dtype=torch.float32, device: DeviceLike = None):
    """Random weights from ``gen`` (drawn a block of experts at a time, so
    no leaf exists whole in f32) on ``device`` (``None``: the card)."""
    return init_leaves(moe_spec(d_model, d_ff, n_experts), gen, dtype,
                       device)


def moe_capacity(tokens_local: int, n_experts: int, top_k: int,
                 factor: float) -> int:
    c = math.ceil(top_k * tokens_local * factor / n_experts)
    return max(8, -(-c // 8) * 8)


def _positions_within_expert(e_flat: torch.Tensor) -> torch.Tensor:
    """[N] expert ids -> [N] int32 arrival rank within each expert (a
    stable sort, then the first index of each run by searchsorted)."""
    n = e_flat.shape[0]
    sorted_e, order = torch.sort(e_flat, stable=True)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank_sorted = torch.arange(n, device=e_flat.device) - first
    pos = torch.zeros((n,), dtype=torch.int32, device=e_flat.device)
    pos[order] = rank_sorted.to(torch.int32)
    return pos


class Routing(NamedTuple):
    probs: torch.Tensor   # [T, E] f32 softmax of the router logits
    top_p: torch.Tensor   # [T, k] renormalised, in the token dtype
    top_e: torch.Tensor   # [T, k] expert ids, descending probability
    pos: torch.Tensor     # [T, k] int32 arrival rank within the expert
    keep: torch.Tensor    # [T, k] pos < capacity


def moe_route(x: torch.Tensor, router_w: torch.Tensor, *, top_k: int,
              capacity: int) -> Routing:
    """The router's decisions for tokens ``x`` [T, D]."""
    logits = (x @ router_w.to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort: equal probabilities keep the lower id
    # first, as jax.lax.top_k orders them (torch.topk does not promise it)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :top_k], top_e[:, :top_k]
    top_p = (top_p / top_p.sum(dim=-1, keepdim=True)).to(x.dtype)
    pos = _positions_within_expert(top_e.reshape(-1)).reshape(top_e.shape)
    return Routing(probs, top_p, top_e, pos, pos < capacity)


def _moe_local(x, router_w, w_gate, w_in, w_out, *, e0: int, n_experts: int,
               top_k: int, capacity: int):
    """x [T, D] local tokens; router_w [D, E]; w_gate, w_in [E_loc, D, F];
    w_out [E_loc, F, D] (experts e0 .. e0 + E_loc - 1). Returns (y [T, D]
    with only the local experts' share, aux)."""
    d = x.shape[1]
    e_loc = w_gate.shape[0]
    r = moe_route(x, router_w, top_k=top_k, capacity=capacity)
    e_rel = r.top_e - e0
    ok = r.keep & (e_rel >= 0) & (e_rel < e_loc)
    e_idx = e_rel.clamp(0, e_loc - 1)
    p_idx = r.pos.long().clamp(0, capacity - 1)

    # dispatch: scatter tokens into [E_loc, C, D], one slot at a time
    buf = torch.zeros((e_loc, capacity, d), dtype=x.dtype, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    for slot in range(top_k):
        upd = torch.where(ok[:, slot, None], x, zero)
        buf.index_put_((e_idx[:, slot], p_idx[:, slot]), upd,
                       accumulate=True)

    # expert FFN (SwiGLU), batched over the local experts
    h = F.silu(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_in)
    del buf
    out_buf = torch.bmm(h, w_out)                             # [E_loc, C, D]
    del h

    # combine: gather each slot's expert output back to its token
    out = torch.zeros_like(x)
    for slot in range(top_k):
        rows = out_buf[e_idx[:, slot], p_idx[:, slot]]
        out = out + torch.where(ok[:, slot, None],
                                rows * r.top_p[:, slot, None], zero)

    # Switch-style load-balance aux loss (local share)
    me = r.probs.mean(dim=0)                                  # [E]
    ce = F.one_hot(r.top_e[:, 0], n_experts).float().mean(dim=0)
    aux = n_experts * torch.sum(me * ce)
    return out, aux


def expert_blocks(params: Dict, mesh, exp_axes, e_loc: int):
    """Each mesh position's (w_gate, w_in, w_out): views of its block of
    ``e_loc`` experts of the global leaves, on its device (a copy only for
    a position on another device than the weights), in position order."""
    out = []
    for pos in mesh.positions():
        lin = mesh.block_of(pos, exp_axes)
        dev = mesh.device_at(pos)
        out.append(tuple(params[k][lin * e_loc:(lin + 1) * e_loc].to(dev)
                         for k in ("w_gate", "w_in", "w_out")))
    return out


def moe_apply(params: Dict, x: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25):
    """x [B, S, D] or [T, D] -> (y like x, aux f32 scalar). Shards over the
    "experts" rule's mesh axes when a mesh is active."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    t = x2.shape[0]

    mesh = current_mesh()
    exp_axes = mesh_axis_names("experts")
    batch_axes = mesh_axis_names("batch")

    if mesh is None or not exp_axes:
        cap = moe_capacity(t, n_experts, top_k, capacity_factor)
        y, aux = _moe_local(
            x2, params["router"], params["w_gate"], params["w_in"],
            params["w_out"], e0=0, n_experts=n_experts, top_k=top_k,
            capacity=cap,
        )
        return y.reshape(shape), aux

    b_sh = math.prod(mesh.shape[a] for a in batch_axes)
    e_sh = math.prod(mesh.shape[a] for a in exp_axes)
    if t % b_sh or n_experts % e_sh:
        raise ValueError(f"{t} tokens over {b_sh} batch blocks or "
                         f"{n_experts} experts over {e_sh} expert blocks do "
                         "not divide")
    t_loc, e_loc = t // b_sh, n_experts // e_sh
    cap = moe_capacity(t_loc, n_experts, top_k, capacity_factor)

    ys, auxes = [], []
    for pos, (wg, wi, wo) in zip(mesh.positions(),
                                 expert_blocks(params, mesh, exp_axes,
                                               e_loc)):
        dev = mesh.device_at(pos)
        b = mesh.block_of(pos, batch_axes)
        y, aux = _moe_local(
            x2[b * t_loc:(b + 1) * t_loc].to(dev), params["router"].to(dev),
            wg, wi, wo, e0=mesh.block_of(pos, exp_axes) * e_loc,
            n_experts=n_experts, top_k=top_k, capacity=cap,
        )
        ys.append(y)
        auxes.append(aux)
    ys = _psum(ys, mesh, exp_axes)
    auxes = [a / e_sh for a in _psum(auxes, mesh, exp_axes)]
    if batch_axes:
        auxes = [a / b_sh for a in _psum(auxes, mesh, batch_axes)]
    # one position per batch block (every expert position holds the sum)
    first = {}
    for i, pos in enumerate(mesh.positions()):
        first.setdefault(mesh.block_of(pos, batch_axes), i)
    y = torch.cat([ys[first[b]].to(x.device) for b in range(b_sh)])
    return y.reshape(shape), auxes[0].to(x.device)
