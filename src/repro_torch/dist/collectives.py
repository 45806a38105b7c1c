"""Hand-written collectives for the sharded hot paths.

The port's collectives are single-controller: the caller holds one tensor
per mesh position (a list in row-major position order, as
:class:`~repro_torch.dist.sharding.ShardedArray` holds them), and a
collective returns the list each position would hold after the
reference's ``shard_map`` collective. A partner's tensor is copied to this
position's device before it is combined (a no-op where both lie on one
device). Three families:

* **Vocab-sharded lookups** (:func:`sharded_vocab_lookup` for LM embedding
  tables, :func:`sharded_table_lookup` for RecSys tables): each shard owns
  a contiguous row range, answers only the ids that land in its range, and
  the partial rows are summed — exactly one shard contributes each row
  (the rest add 0.0), so the result is bit-exact against a row gather.

* **Compressed all-reduce** (:func:`compressed_psum` +
  :func:`quantize_int8` / :func:`dequantize_int8`): an int8 payload on a
  shared max-reduced scale, summed in int32.

* **GF(2) collectives for the PIR serve path** (:func:`xor_psum`,
  :func:`sharded_record_lookup`): XOR is the reduction the PIR algebra
  wants — partial folds from record shards combine exactly. The record
  lookup is the Direct-Requests gather with rows sharded over the
  "records" logical axis.

The lookups take global tensors and fall back to their single-device form
when no mesh is active, the logical axis is unmapped, or shapes don't
divide — identical values either way.

Under an active count (:mod:`repro_torch._cost`) each collective reports
its bytes at one mesh position, as the reference's cost parser counts
them per device, under the reference's op kinds: ``all_gather`` as
``all-gather`` (the gathered result), ``psum_scatter`` as
``reduce-scatter`` (the operand: the result times the group), the sum and
max all-reduces (and with them :func:`compressed_psum`'s int8 payload and
shared scale, and the lookups' partial sums) as ``all-reduce``, and each
round of :func:`xor_psum`'s butterfly as ``collective-permute``, which is
what the reference's ``ppermute`` butterfly lowers to.
"""

from __future__ import annotations

import collections
import math
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch import _cost
from repro_torch.dist.sharding import (
    Mesh,
    ShardedArray,
    current_mesh,
    mesh_axis_names,
)

__all__ = [
    "sharded_vocab_lookup",
    "sharded_table_lookup",
    "compressed_psum",
    "quantize_int8",
    "dequantize_int8",
    "xor_psum",
    "sharded_record_lookup",
    "all_gather",
    "psum_scatter",
]

Shards = List[torch.Tensor]


def _axes(axis_names) -> Tuple[str, ...]:
    return (axis_names,) if isinstance(axis_names, str) else tuple(axis_names)


def _resolve_mesh(mesh: Optional[Mesh], what: str) -> Mesh:
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise ValueError(f"{what} needs a mesh (or an active mesh_rules "
                         "context)")
    return mesh


def _check_shards(shards: Sequence[torch.Tensor], mesh: Mesh) -> None:
    if len(shards) != mesh.size:
        raise ValueError(
            f"{len(shards)} shards for a mesh of {mesh.size} positions"
        )


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _all_reduce(shards: Sequence[torch.Tensor], mesh: Mesh, axes,
                op: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
                ) -> Shards:
    """Each position gets ``op`` folded over its group along ``axes`` (the
    gather-then-fold all-reduce), in block order; the fold runs on the
    position's own device. The members of a group on one device fold the
    same tensors in the same order, so the fold runs once for them and
    they share its result (read-only, as every caller uses it)."""
    if _cost.active():
        _cost.record_collective("all-reduce", _nbytes(shards[0]))
    out, done = [], {}
    for i, pos in enumerate(mesh.positions()):
        dev = shards[i].device
        group = tuple(mesh.group_of(pos, axes))
        if (group, dev) not in done:
            acc = None
            for g in group:
                x = shards[mesh.block_of(g, mesh.axis_names)].to(dev)
                acc = x if acc is None else op(acc, x)
            done[group, dev] = acc
        out.append(done[group, dev])
    return out


def _psum(shards, mesh, axes) -> Shards:
    return _all_reduce(shards, mesh, axes, torch.add)


def _pmax(shards, mesh, axes) -> Shards:
    return _all_reduce(shards, mesh, axes, torch.maximum)


def _group(shards, mesh: Mesh, pos, axes) -> Shards:
    """The tensors of ``pos``'s group over ``axes``, in block order, each
    copied to ``pos``'s device."""
    dev = mesh.device_at(pos)
    return [shards[mesh.block_of(g, mesh.axis_names)].to(dev)
            for g in mesh.group_of(pos, axes)]


def all_gather(shards: Sequence[torch.Tensor], mesh: Optional[Mesh],
               axis_names) -> Shards:
    """Tiled all-gather over dim 0 (``jax.lax.all_gather(..., tiled=True)``
    in ``shard_map``): each position gets its group's tensors over
    ``axis_names`` concatenated in block order, on its own device (the
    members of a group on one device share one concatenation).
    ``mesh=None`` takes the active mesh."""
    mesh = _resolve_mesh(mesh, "all_gather")
    _check_shards(shards, mesh)
    axes = _axes(axis_names)
    if _cost.active():
        _cost.record_collective("all-gather", _nbytes(shards[0]) * math.prod(
            mesh.shape[a] for a in axes))
    out, done = [], {}
    for pos in mesh.positions():
        key = (tuple(mesh.group_of(pos, axes)), mesh.device_at(pos))
        if key not in done:
            done[key] = torch.cat(_group(shards, mesh, pos, axes))
        out.append(done[key])
    return out


def psum_scatter(shards: Sequence[torch.Tensor], mesh: Optional[Mesh],
                 axis_names) -> Shards:
    """Tiled reduce-scatter over dim 0 (``jax.lax.psum_scatter(...,
    scatter_dimension=0, tiled=True)``): the group over ``axis_names``
    sums its tensors, and each position keeps the rows of its block,
    ``dim0 / group size`` of them, summed in block order on its own
    device. Where a whole group lies on one device, it sums the whole
    tensors once, in that order (the same bits as a block at a time: the
    sum is elementwise), and each member keeps a view of its rows.
    ``mesh=None`` takes the active mesh."""
    mesh = _resolve_mesh(mesh, "psum_scatter")
    _check_shards(shards, mesh)
    axes = _axes(axis_names)
    size = math.prod(mesh.shape[a] for a in axes)
    rows = shards[0].shape[0]
    if rows % size:
        raise ValueError(f"dim 0 of {rows} does not split into {size} blocks")
    step = rows // size
    if _cost.active():
        _cost.record_collective("reduce-scatter", _nbytes(shards[0]))
    positions = list(mesh.positions())
    keys = [(tuple(mesh.group_of(pos, axes)), mesh.device_at(pos))
            for pos in positions]
    whole = {k for k, c in collections.Counter(keys).items() if c == size}
    out, done = [], {}
    for pos, key in zip(positions, keys):
        b = mesh.block_of(pos, axes)
        block = slice(b * step, (b + 1) * step)
        if key in whole and key not in done:
            done[key] = _sum_in_order(_group(shards, mesh, pos, axes))
        out.append(done[key][block] if key in whole else _sum_in_order(
            _group([s[block] for s in shards], mesh, pos, axes)))
    return out


def _sum_in_order(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    acc = None
    for x in xs:
        acc = x.clone() if acc is None else acc.add_(x)
    return acc


# --------------------------------------------------------------------------
# GF(2) collectives (PIR serve path)
# --------------------------------------------------------------------------
def xor_psum(shards: Sequence[torch.Tensor], mesh: Optional[Mesh],
             axis_names) -> Shards:
    """XOR all-reduce of one integer tensor per mesh position over
    ``axis_names``; ``mesh=None`` takes the active mesh and raises when
    there is none.

    Power-of-two axes use the reference's log2-round butterfly: in round
    k each position XORs in its partner ``i ^ k``'s tensor, copied to its
    own device. Other sizes gather and fold. XOR is associative and
    commutative, so the result is bit-exact regardless of schedule.
    """
    mesh = _resolve_mesh(mesh, "xor_psum")
    _check_shards(shards, mesh)
    x = list(shards)
    for ax in _axes(axis_names):
        size = mesh.shape[ax]
        dim = mesh.axis_names.index(ax)
        if size & (size - 1) == 0:
            k = 1
            while k < size:
                if _cost.active():
                    _cost.record_collective("collective-permute",
                                            _nbytes(x[0]))
                nxt = []
                for i, pos in enumerate(mesh.positions()):
                    partner = list(pos)
                    partner[dim] ^= k
                    j = mesh.block_of(tuple(partner), mesh.axis_names)
                    nxt.append(x[i] ^ x[j].to(x[i].device))
                x = nxt
                k *= 2
        else:
            x = _all_reduce(x, mesh, (ax,), torch.bitwise_xor)
    return x


def _row_blocks(x: Union[torch.Tensor, ShardedArray], mesh: Mesh,
                axes: Tuple[str, ...], rows: int) -> Shards:
    """Each position's block of ``x``'s rows over ``axes``: a
    :class:`ShardedArray`'s own shards, or row views of a tensor, each on
    its position's device."""
    if isinstance(x, ShardedArray):
        return [sh.data for sh in x.shards]
    blocks = []
    for pos in mesh.positions():
        b = mesh.block_of(pos, axes)
        blocks.append(x[b * rows:(b + 1) * rows].to(mesh.device_at(pos)))
    return blocks


def _owned_rows(blocks: Shards, ids_by_pos: Shards, mesh: Mesh,
                axes: Tuple[str, ...], rows: int) -> Shards:
    """Each position's partial gather: the rows its block owns, zero
    elsewhere."""
    out = []
    for i, pos in enumerate(mesh.positions()):
        block = blocks[i]
        rel = ids_by_pos[i].to(block.device) - mesh.block_of(pos, axes) * rows
        ok = (rel >= 0) & (rel < rows)
        got = block[rel.clamp(0, rows - 1)]
        out.append(torch.where(ok[..., None], got, torch.zeros_like(got)))
    return out


def sharded_record_lookup(packed: Union[torch.Tensor, ShardedArray],
                          ids: torch.Tensor) -> torch.Tensor:
    """Record gather with rows sharded over the "records" logical axis.

    packed: [n, W] words — a tensor, or its :class:`ShardedArray` over the
    active mesh with rows sharded over the "records" axes; ids: int [...].
    Returns [..., W] on ``ids``' device, bit-exact against a row gather
    for in-range ids (out-of-range ids clamp to ``[0, n)``, identically on
    and off the mesh). Each shard answers only the rows it owns (the rest
    contribute 0) and the partials XOR-combine.
    """
    n = int(packed.shape[0])
    ids = ids.long().clamp(0, n - 1)

    mesh = current_mesh()
    raxes = mesh_axis_names("records")
    rshards = math.prod(mesh.shape[a] for a in raxes) if raxes else 1
    if mesh is None or rshards <= 1 or n % rshards:
        if isinstance(packed, ShardedArray):
            raise ValueError("a sharded store needs its mesh's records rule")
        return packed[ids.to(packed.device)]
    n_loc = n // rshards
    blocks = _row_blocks(packed, mesh, raxes, n_loc)
    parts = _owned_rows(blocks, [ids] * mesh.size, mesh, raxes, n_loc)
    return xor_psum(parts, mesh, raxes)[0].to(ids.device)


# --------------------------------------------------------------------------
# Vocab-sharded lookups
# --------------------------------------------------------------------------
def _sharded_lookup(table: torch.Tensor, ids: torch.Tensor,
                    vocab_logical: str) -> torch.Tensor:
    # clamp ids in every path: out-of-range ids would otherwise behave
    # differently on the mesh (no shard owns them: a sum of zeros) and off
    # it — a lookup must not depend on where the table lives
    ids = ids.to(device=table.device, dtype=torch.long).clamp(
        0, table.shape[0] - 1)

    mesh = current_mesh()
    vaxes = mesh_axis_names(vocab_logical)
    if mesh is None or not vaxes:
        return table[ids]
    v = table.shape[0]
    vshards = math.prod(mesh.shape[a] for a in vaxes)
    if vshards <= 1 or v % vshards != 0:
        # can't row-shard evenly (e.g. dien's 18-dim table on 16-way TP)
        return table[ids]
    v_loc = v // vshards

    baxes = tuple(a for a in mesh_axis_names("batch") if a not in vaxes)
    bshards = math.prod(mesh.shape[a] for a in baxes) if baxes else 1
    if baxes and ids.shape[0] % bshards != 0:
        baxes, bshards = (), 1
    b_loc = ids.shape[0] // bshards

    def batch_block(pos):
        b = mesh.block_of(pos, baxes) if baxes else 0
        return ids[b * b_loc:(b + 1) * b_loc]

    blocks = _row_blocks(table, mesh, vaxes, v_loc)
    parts = _owned_rows(blocks, [batch_block(p) for p in mesh.positions()],
                        mesh, vaxes, v_loc)
    summed = _psum(parts, mesh, vaxes)
    # one position per batch block (every vocab position holds the sum)
    first = {}
    for i, pos in enumerate(mesh.positions()):
        first.setdefault(mesh.block_of(pos, baxes) if baxes else 0, i)
    return torch.cat([summed[first[b]].to(table.device)
                      for b in range(bshards)])


def sharded_vocab_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """LM token-embedding gather. table: [V, D] (rows sharded over the
    "vocab" rule); ids: int [...] (lead dim sharded over "batch").
    Returns [..., D], bit-exact against ``table[ids]`` for in-range ids;
    out-of-range ids clamp (identically on and off the mesh)."""
    return _sharded_lookup(table, ids, "vocab")


def sharded_table_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """RecSys embedding-table gather, rows sharded over "table_vocab"."""
    return _sharded_lookup(table, ids, "table_vocab")


# --------------------------------------------------------------------------
# int8 compression + compressed all-reduce
# --------------------------------------------------------------------------
def _int8_scale(xf: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(xf.abs().max(), 1e-30) / 127.0


def quantize_int8(
    x: torch.Tensor, scale: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: returns (q int8, scale f32 scalar) with
    x ≈ q·scale, |error| ≤ scale/2 elementwise. Pass ``scale`` to quantize
    onto a shared grid (compressed_psum max-shares it across shards)."""
    xf = x.to(torch.float32)
    if scale is None:
        scale = _int8_scale(xf)
    q = torch.clamp(torch.round(xf / scale), -127.0, 127.0).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(shards: Sequence[torch.Tensor], mesh: Optional[Mesh],
                    axis_names) -> Shards:
    """int8-compressed sum all-reduce of one tensor per mesh position over
    ``axis_names`` (``mesh=None``: the active mesh).

    The scale is max-shared first so every shard quantizes onto the same
    grid; the int8 payloads then sum losslessly in int32 (what crosses the
    wire is the 1-byte tensor + one scalar). The error is bounded by
    ``n_shards · scale/2`` elementwise."""
    mesh = _resolve_mesh(mesh, "compressed_psum")
    _check_shards(shards, mesh)
    axes = _axes(axis_names)
    xfs = [s.to(torch.float32) for s in shards]
    scales = _pmax([_int8_scale(xf) for xf in xfs], mesh, axes)
    qs = [quantize_int8(xf, sc)[0].to(torch.int32)
          for xf, sc in zip(xfs, scales)]
    acc = _psum(qs, mesh, axes)
    return [(a.to(torch.float32) * sc).to(s.dtype)
            for a, sc, s in zip(acc, scales, shards)]
