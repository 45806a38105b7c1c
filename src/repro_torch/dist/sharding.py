"""Logical-axis sharding: the naming layer between models and meshes.

Model code never mentions mesh axes. It names *logical* axes ("batch",
"vocab", "records", ...), and a rule table maps each logical name to zero
or more *mesh* axes. The same code then runs

  * on one device (no mesh context: every rule resolves to "replicated"),
  * on a mesh whose positions all lie on one device (the CPU tests, or one
    card),
  * on a mesh of one position per card, where only the mesh changes.

Rule values are ``None`` (replicate), a mesh-axis name, or a tuple of
mesh-axis names (the logical axis is sharded over their product, major to
minor). The tables are the reference package's, key for key.

The port keeps the reference's single-controller model without JAX's
``shard_map``: a :class:`Mesh` is an ndarray of ``torch.device``s with axis
names; a :class:`ShardedArray` (built by :func:`device_put`) is one tensor
per mesh position, each its own storage on its position's device; and a
collective (:mod:`repro_torch.dist.collectives`) takes the per-position list
and returns one. There is no compiler to partition model tensors, so
:func:`constrain` checks its arguments and returns the tensor unchanged
(the reference's changes layout, never values).

The context is thread-local, as in the reference: a thread that did not
enter :func:`mesh_rules` itself runs off the mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "DEFAULT_RULES",
    "MULTIPOD_RULES",
    "Mesh",
    "P",
    "Shard",
    "ShardedArray",
    "axis_size",
    "constrain",
    "current_mesh",
    "current_rules",
    "device_put",
    "logical_to_spec",
    "make_mesh",
    "mesh_axis_names",
    "mesh_rules",
    "touched_record_blocks",
]


# --------------------------------------------------------------------------
# Rule tables (the reference package's, key for key)
# --------------------------------------------------------------------------
# Single-pod baseline: Megatron TP over "model" × FSDP/DP over "data", with
# sequence-parallel residual streams.
DEFAULT_RULES: Dict[str, object] = {
    # LM / generic batched compute
    "batch": "data",          # per-example axes (tokens, queries, users)
    "fsdp": "data",           # parameter shard axis (ZeRO-style)
    "seq": None,              # full sequence inside attention blocks
    "seq_res": "model",       # sequence-parallel residual stream
    "embed": None,            # d_model stays unsharded (SP shards seq)
    "heads": "model",         # Megatron TP: attention heads
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",            # Megatron TP: MLP hidden
    "vocab": "model",         # tied embedding + logits stay vocab-sharded
    "kv_seq": "model",        # decode KV-cache sequence parallelism
    "experts": "model",       # MoE expert parallelism (TP over experts)
    # GNN full-batch: nodes and edges over every axis, flattened
    "nodes": ("data", "model"),
    "edges": ("data", "model"),
    # RecSys
    "table_vocab": "model",   # vocab-sharded embedding tables
    "candidates": ("data", "model"),
    # PIR serve (baseline; the xorbfly variant overrides records per cell)
    "queries": "data",
    "records": "model",
}

# Multi-pod (2×16×16): the "pod" axis is data-parallel across pods; batch-
# like axes extend over it, TP axes never cross pods.
MULTIPOD_RULES: Dict[str, object] = dict(
    DEFAULT_RULES,
    batch=("pod", "data"),
    fsdp=("pod", "data"),
    nodes=("pod", "data", "model"),
    edges=("pod", "data", "model"),
    candidates=("pod", "data", "model"),
    queries=("pod", "data"),
)


# --------------------------------------------------------------------------
# Mesh and partition specs
# --------------------------------------------------------------------------
class P(tuple):
    """A partition spec: one entry per leading dim, each ``None``
    (replicated), a mesh-axis name, or a tuple of names. The counterpart
    of JAX's ``PartitionSpec``; ``tuple(spec)`` is comparable across the
    two packages."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class Mesh:
    """An ndarray of ``torch.device``s with one name per axis.

    ``shape`` maps each axis name to its size (the reference's
    ``Mesh.shape``). Positions are enumerated row-major; several positions
    may name the same device (every position of the port's one-card mesh
    is ``cuda:0``)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        given = np.asarray(devices, dtype=object)
        arr = np.empty(given.shape, dtype=object)
        for pos in np.ndindex(arr.shape):
            arr[pos] = torch.device(given[pos])
        names = tuple(axis_names)
        if arr.ndim != len(names) or len(set(names)) != len(names):
            raise ValueError(
                f"mesh of shape {arr.shape} needs {arr.ndim} distinct axis "
                f"names, got {names}"
            )
        self.devices = arr
        self.axis_names = names
        self.shape: Dict[str, int] = dict(zip(names, arr.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def positions(self) -> Iterator[Tuple[int, ...]]:
        """Every mesh position, row-major."""
        return np.ndindex(self.devices.shape)

    def device_at(self, pos: Tuple[int, ...]) -> torch.device:
        return self.devices[pos]

    def distinct_devices(self) -> List[torch.device]:
        """The devices of the mesh, each once, in position order."""
        seen: List[torch.device] = []
        for d in self.devices.flat:
            if d not in seen:
                seen.append(d)
        return seen

    def block_of(self, pos: Tuple[int, ...], axes: Sequence[str]) -> int:
        """The linear block index of ``pos`` over ``axes`` (major to minor),
        the shard_map ``axis_index`` product of the reference."""
        lin = 0
        for a in axes:
            lin = lin * self.shape[a] + pos[self.axis_names.index(a)]
        return lin

    def group_of(self, pos: Tuple[int, ...], axes: Sequence[str]
                 ) -> List[Tuple[int, ...]]:
        """The positions that differ from ``pos`` only along ``axes`` (the
        members of one all-reduce over ``axes``), in block order."""
        dims = [self.axis_names.index(a) for a in axes]
        out = []
        for coords in itertools.product(*(range(self.shape[a]) for a in axes)):
            p = list(pos)
            for dim, c in zip(dims, coords):
                p[dim] = c
            out.append(tuple(p))
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.distinct_devices()})"


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              devices: Sequence) -> Mesh:
    """A mesh of ``shape`` whose positions take ``devices`` round-robin in
    row-major order: one device gives a mesh of one device's positions;
    ``prod(shape)`` devices give one position per device."""
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    size = math.prod(shape)
    arr = np.empty(size, dtype=object)
    for i in range(size):
        arr[i] = devs[i % len(devs)]
    return Mesh(arr.reshape(tuple(shape)), axis_names)


# --------------------------------------------------------------------------
# Context
# --------------------------------------------------------------------------
_STATE = threading.local()


def _stack():
    if not hasattr(_STATE, "stack"):
        _STATE.stack = []
    return _STATE.stack


@contextlib.contextmanager
def mesh_rules(mesh: Mesh, rules: Dict[str, object]):
    """Activate ``mesh`` + logical ``rules`` in the calling thread."""
    _stack().append((mesh, dict(rules)))
    try:
        yield mesh
    finally:
        _stack().pop()


def current_mesh() -> Optional[Mesh]:
    s = _stack()
    return s[-1][0] if s else None


def current_rules() -> Dict[str, object]:
    s = _stack()
    return s[-1][1] if s else {}


# --------------------------------------------------------------------------
# Resolution
# --------------------------------------------------------------------------
def _as_axes(value) -> Tuple[str, ...]:
    if value is None:
        return ()
    if isinstance(value, str):
        return (value,)
    return tuple(value)


def mesh_axis_names(logical: str) -> Tuple[str, ...]:
    """Mesh axes a logical axis maps to under the current rules.

    () when no mesh is active, the rule is None/absent, or none of the
    mapped axes exist on the active mesh — callers treat () as
    "replicated" and take their single-device path.
    """
    mesh = current_mesh()
    if mesh is None:
        return ()
    axes = _as_axes(current_rules().get(logical))
    return tuple(a for a in axes if a in mesh.shape)


def axis_size(logical: str) -> int:
    """Product of mesh-axis sizes behind a logical axis (1 if unmapped)."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    return math.prod(mesh.shape[a] for a in mesh_axis_names(logical)) or 1


def logical_to_spec(*logical) -> P:
    """Resolve per-dim logical names (or None) into a :class:`P`.

    A mesh axis may appear at most once in a spec; if two dims resolve to
    overlapping mesh axes the later dim drops the duplicates — rule-table
    overrides (not call sites) decide who wins an axis.
    """
    mesh = current_mesh()
    parts, used = [], set()
    for name in logical:
        axes = () if name is None else _as_axes(current_rules().get(name))
        if mesh is not None:
            axes = tuple(a for a in axes if a in mesh.shape)
        axes = tuple(a for a in axes if a not in used)
        used.update(axes)
        if not axes:
            parts.append(None)
        elif len(axes) == 1:
            parts.append(axes[0])
        else:
            parts.append(axes)
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


def constrain(x: torch.Tensor, *logical) -> torch.Tensor:
    """The reference's layout annotation by logical names, as a checked
    identity: the port has no compiler to re-lay the tensor out, and the
    reference's constraint never changes values. Raises for more names
    than ``x`` has dims, or a name that is neither a string nor None."""
    if len(logical) > x.dim():
        raise ValueError(
            f"{len(logical)} logical names for a {x.dim()}-d tensor"
        )
    for name in logical:
        if name is not None and not isinstance(name, str):
            raise TypeError(f"a logical axis name is a str or None: {name!r}")
    return x


# --------------------------------------------------------------------------
# Sharded arrays: one tensor per mesh position
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Shard:
    """One mesh position's block: ``slices`` of the global array (one per
    dim), held as ``data`` on ``device``. ``index`` is its start row."""

    position: Tuple[int, ...]
    slices: Tuple[slice, ...]
    data: torch.Tensor

    @property
    def index(self) -> int:
        return self.slices[0].start

    @property
    def device(self) -> torch.device:
        return self.data.device


@dataclasses.dataclass(frozen=True)
class ShardedArray:
    """A global array of ``shape`` laid over ``mesh`` by ``spec``: one
    :class:`Shard` per mesh position, row-major. Replicas of one block
    on one device share one tensor; every other shard is its own storage
    (never a view of another's), so a block can be replaced alone."""

    shape: Tuple[int, ...]
    mesh: Mesh
    spec: P
    shards: Tuple[Shard, ...]

    def replace(self, shards: Sequence[Shard]) -> "ShardedArray":
        return dataclasses.replace(self, shards=tuple(shards))


def _block_slices(shape, mesh: Mesh, spec: P, pos) -> Tuple[slice, ...]:
    out = []
    for dim, size in enumerate(shape):
        part = spec[dim] if dim < len(spec) else None
        axes = _as_axes(part)
        nb = math.prod(mesh.shape[a] for a in axes) if axes else 1
        if size % nb:
            raise ValueError(
                f"dim {dim} of size {size} does not split into {nb} blocks"
            )
        b = mesh.block_of(pos, axes) if axes else 0
        step = size // nb
        out.append(slice(b * step, (b + 1) * step))
    return tuple(out)


def _own_copy(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A copy of ``t`` in a storage of its own on ``device``, with the
    dims in the order of ``t``'s strides (a block of a bit-major ``[n, B]``
    view stays bit-major)."""
    order = sorted(range(t.dim()), key=lambda d: -t.stride(d))
    inv = [order.index(d) for d in range(t.dim())]
    dense = t.permute(order).clone(memory_format=torch.contiguous_format)
    return dense.to(device).permute(inv)


def device_put(x: torch.Tensor, mesh: Mesh, spec: P) -> ShardedArray:
    """Lay ``x`` over ``mesh`` by ``spec`` (the reference's
    ``jax.device_put(x, NamedSharding(mesh, spec))``): each position gets
    its block in a storage of its own on its device. Every sharded dim
    must divide by its axes' product."""
    spec = P(*spec)
    for part in spec:
        for a in _as_axes(part):
            if a not in mesh.shape:
                raise ValueError(f"spec {spec} names {a!r}, not on {mesh}")
    shards, memo = [], {}
    for pos in mesh.positions():
        sl = _block_slices(x.shape, mesh, spec, pos)
        dev = mesh.device_at(pos)
        key = (tuple((s.start, s.stop) for s in sl), dev)
        if key not in memo:
            memo[key] = _own_copy(x[sl], dev)
        shards.append(Shard(position=tuple(pos), slices=sl, data=memo[key]))
    return ShardedArray(shape=tuple(x.shape), mesh=mesh, spec=spec,
                        shards=tuple(shards))


# --------------------------------------------------------------------------
# Device-shard geometry (touched-shard invalidation)
# --------------------------------------------------------------------------
def touched_record_blocks(
    rows, n_pad: int, rshards: int
) -> Tuple[int, ...]:
    """Which contiguous device blocks a touched-row set lands in.

    A records-sharded mesh array splits its padded row dim into
    ``rshards`` equal contiguous blocks of ``n_pad // rshards`` rows.
    Given the record indices a delta touched, return the sorted block ids
    whose device buffers must be rewritten — every other block's buffer
    can be reused by identity. Pure host math.
    """
    if rshards < 1 or n_pad % rshards:
        raise ValueError(
            f"n_pad={n_pad} not divisible into rshards={rshards} blocks"
        )
    block = n_pad // rshards
    seen = {int(r) // block for r in rows}
    bad = [b for b in seen if b < 0 or b >= rshards]
    if bad:
        raise IndexError(
            f"touched rows fall outside the padded store "
            f"(blocks {sorted(bad)} of {rshards})"
        )
    return tuple(sorted(seen))
