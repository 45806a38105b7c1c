"""Flash-decode: one-token attention against a sequence-sharded KV cache.

At long-context decode the KV cache is the whole memory budget, so it is
laid over mesh axes along the *sequence* dim (rule "kv_seq"). Each mesh
position computes a partial softmax over its cache chunk as the flash
triple (running max m, sum-of-exp l, exp-weighted values o) in float32, on
the device that holds the chunk; the triples combine exactly across the
chunks with one max and two sums:

    m* = max(m)        l* = Σ e^{m−m*}·l        o* = Σ e^{m−m*}·o
    out = o* / l*

which is algebraically the softmax over the whole cache.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.dist.collectives import _pmax, _psum
from repro_torch.dist.sharding import current_mesh, mesh_axis_names

__all__ = ["flash_decode"]

_NEG = -1e30  # mask value; large-negative (not -inf) keeps exp() NaN-free


def _repeat_kv(kv: torch.Tensor, groups: int) -> torch.Tensor:
    b, s, h, d = kv.shape
    return kv[:, :, :, None, :].expand(b, s, h, groups, d).reshape(
        b, s, h * groups, d)


def _partial_softmax(q, k, v, length: int, offset: int,
                     window: Optional[int], attn_softcap: float):
    """The flash triple of one cache chunk, in float32.

    q: [B, 1, Hq, D]; k/v: [B, S_loc, Hkv, D]; offset: the first global
    position of the chunk. Returns (m [B,Hq], l [B,Hq], o [B,Hq,D])."""
    hq, dh = q.shape[2], q.shape[3]
    hkv = k.shape[2]
    k = _repeat_kv(k, hq // hkv)
    v = _repeat_kv(v, hq // hkv)

    s = torch.einsum(
        "bqhd,bkhd->bhqk", q.float(), k.float()
    )[:, :, 0, :] / math.sqrt(dh)                      # [B, Hq, S_loc]
    if attn_softcap > 0.0:
        s = attn_softcap * torch.tanh(s / attn_softcap)

    kpos = offset + torch.arange(k.shape[1], device=k.device)
    valid = kpos < length
    if window is not None:
        valid &= kpos > length - 1 - window
    s = torch.where(valid[None, None, :], s, _NEG)

    m = s.amax(dim=-1)                                 # [B, Hq]
    p = torch.where(valid[None, None, :], torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhk,bkhd->bhd", p, v.float())
    return m, l, o


def _dense_decode(q, k_cache, v_cache, length, window, attn_softcap):
    """The single-device path: the model layer's own masked softmax."""
    from repro_torch.models.layers import decode_attention  # no cycle

    return decode_attention(q, k_cache, v_cache, length, window=window,
                            attn_softcap=attn_softcap)


def flash_decode(
    q: torch.Tensor,          # [B, 1, Hq, D]
    k_cache: torch.Tensor,    # [B, Smax, Hkv, D]
    v_cache: torch.Tensor,
    length,                   # number of valid cache entries
    *,
    axis_names,               # mesh axes the cache sequence is sharded over
    window: Optional[int] = None,
    attn_softcap: float = 0.0,
) -> torch.Tensor:
    """Sequence-parallel decode attention. Returns [B, 1, Hq, D] in
    ``q``'s dtype on ``q``'s device.

    Mesh position (b, s) takes batch block b (over the "batch" axes the
    cache's sequence axes leave free, when the batch divides) and cache
    chunk s. Falls back to the dense path when no mesh is active, the
    named axes are absent, or Smax doesn't divide over them.
    """
    mesh = current_mesh()
    axes = tuple(a for a in axis_names if mesh is not None and a in mesh.shape)
    s_max = k_cache.shape[1]
    n_sh = math.prod(mesh.shape[a] for a in axes) if axes else 1
    length = int(length)
    window = None if window is None else int(window)
    if not axes or n_sh <= 1 or s_max % n_sh != 0:
        return _dense_decode(q, k_cache, v_cache, length, window,
                             attn_softcap)
    s_loc = s_max // n_sh

    baxes = tuple(a for a in mesh_axis_names("batch") if a not in axes)
    bshards = math.prod(mesh.shape[a] for a in baxes) if baxes else 1
    if baxes and q.shape[0] % bshards != 0:
        baxes, bshards = (), 1
    b_loc = q.shape[0] // bshards

    ms, ls, os_ = [], [], []
    first = {}
    for i, pos in enumerate(mesh.positions()):
        dev = mesh.device_at(pos)
        b = mesh.block_of(pos, baxes) if baxes else 0
        s = mesh.block_of(pos, axes)
        first.setdefault(b, i)
        rows = slice(b * b_loc, (b + 1) * b_loc)
        chunk = slice(s * s_loc, (s + 1) * s_loc)
        m, l, o = _partial_softmax(
            q[rows].to(dev), k_cache[rows, chunk].to(dev),
            v_cache[rows, chunk].to(dev), length, s * s_loc, window,
            attn_softcap)
        ms.append(m)
        ls.append(l)
        os_.append(o)
    m_g = _pmax(ms, mesh, axes)
    alpha = [torch.exp(m - g) for m, g in zip(ms, m_g)]  # 0: a masked chunk
    l_g = _psum([a * l for a, l in zip(alpha, ls)], mesh, axes)
    o_g = _psum([a[..., None] * o for a, o in zip(alpha, os_)], mesh, axes)
    outs = []
    for b in range(bshards):
        i = first[b]
        out = o_g[i] / torch.clamp_min(l_g[i], 1e-30)[..., None]
        outs.append(out[:, None].to(device=q.device, dtype=q.dtype))
    return torch.cat(outs)
