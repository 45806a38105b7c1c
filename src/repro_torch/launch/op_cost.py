"""Cost of a run, counted over the aten ops it dispatches.

This module plays the role of the reference's ``launch/hlo_cost.py``,
which has no counterpart in the port: the port has no compiler and so no
optimized HLO to parse. The reference walks the HLO because XLA's own
``cost_analysis()`` counts a ``while`` body once; here every op of an
eager run is dispatched once per execution, so a loop of layers is
counted layer by layer by construction. :func:`count_cost` runs a
function under a ``TorchDispatchMode`` and gives, for the whole run:

    flops       2·m·n·k per product, from the formulas that
                ``torch.utils.flop_counter`` registers (mm, bmm, addmm,
                baddbmm, convolutions, attention ops); elementwise ops are
                ignored, as in the reference. A hand-written kernel is
                counted by its own formula, which its wrapper reports
                (:mod:`repro_torch._cost`): it is a ctypes launch, or on a
                ``meta`` tensor no launch at all, and no aten op shows it.
    bytes       operand bytes plus result bytes of every aten op that is
                not a view, an alias, an allocation or a metadata op (the
                reference's "non-trivial instruction" rule), plus each
                hand-written kernel's own bytes.
    collectives the bytes and count of each collective of
                :mod:`repro_torch.dist.collectives`, per mesh position,
                under the reference's five op kinds.
    peak_bytes  the peak of the bytes held by storages that the run
                allocated (each storage counted once, from its allocation
                until it is freed): the run's peak less its arguments.

It works alike on ``meta``, ``cpu`` and ``cuda`` tensors. On ``meta``
nothing is allocated, so a full-size cell is counted on any host.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict, Set

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import _cost
from repro_torch._cost import COLLECTIVE_OPS

__all__ = ["COLLECTIVE_OPS", "OpCost", "count_cost"]

_aten = torch.ops.aten
# ops that move no data: allocations without a fill, aliases and metadata
# (views are recognised by their schema, ``OpOverload.is_view``)
_TRIVIAL = {
    _aten.empty, _aten.empty_strided, _aten.empty_like, _aten.new_empty,
    _aten.new_empty_strided, _aten.detach, _aten.alias, _aten.lift_fresh,
    _aten._unsafe_view, _aten._local_scalar_dense, _aten.set_,
    _aten.resize_, _aten.is_same_size,
}


@dataclasses.dataclass
class OpCost:
    """The reference's ``HloCost`` (``hlo_cost.py:78``), field for field,
    with ``peak_bytes`` and the hand-written ``kernels`` launched (by the
    name their wrappers report) besides."""

    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {op: 0.0 for op in COLLECTIVE_OPS}
    )
    coll_counts: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {op: 0.0 for op in COLLECTIVE_OPS}
    )
    peak_bytes: float = 0.0
    kernels: Dict[str, int] = dataclasses.field(default_factory=dict)

    def add(self, other: "OpCost", mult: float = 1.0) -> None:
        """``other`` run ``mult`` times after this one: totals add, the
        peak is the larger of the two."""
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        for op in COLLECTIVE_OPS:
            self.coll_bytes[op] += other.coll_bytes[op] * mult
            self.coll_counts[op] += other.coll_counts[op] * mult
        self.peak_bytes = max(self.peak_bytes, other.peak_bytes)
        for name, n in other.kernels.items():
            self.kernels[name] = self.kernels.get(name, 0) + n * mult

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.coll_bytes.values())

    def to_dict(self) -> Dict:
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "collective_bytes": dict(self.coll_bytes),
            "collective_counts": dict(self.coll_counts),
            "total_collective_bytes": self.total_collective_bytes,
            "peak_bytes": self.peak_bytes,
            "kernels": dict(self.kernels),
        }


def _tensors(tree: Any):
    """The tensors of a nested structure of dicts, lists, tuples (named
    ones too) and modules (their parameters and buffers)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _flat(xs):
    """The tensors among an op's arguments or results (an aten op nests
    them at most in lists and tuples)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from _flat(x)


class _CostMode(TorchDispatchMode):
    """Adds each dispatched op's flops and bytes to ``cost``, and follows
    the storages the run allocates for its peak."""

    def __init__(self, cost: OpCost, given: Set[int]):
        super().__init__()
        self.cost = cost
        self.given = given            # storages of the arguments
        self.held: Dict[int, int] = {}  # storages the run allocated: bytes
        self.live = 0
        self.peak = 0

    def _free(self, key: int) -> None:
        self.live -= self.held.pop(key, 0)

    def _follow(self, outs) -> None:
        for t in outs:
            try:
                st = t.untyped_storage()
            except (RuntimeError, NotImplementedError):
                continue
            key = st._cdata
            if key in self.given or key in self.held:
                continue
            self.held[key] = st.nbytes()
            self.live += self.held[key]
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = list(_flat(out if isinstance(out, (list, tuple)) else (out,)))
        self._follow(outs)
        packet = func._overloadpacket
        if func.is_view or packet in _TRIVIAL:
            return out
        if packet in flop_registry:
            self.cost.flops += float(
                flop_registry[packet](*args, **kwargs, out_val=out))
        ins = list(_flat(args)) + list(_flat(kwargs.values()))
        self.cost.bytes += float(sum(_nbytes(t) for t in ins + outs))
        return out


def count_cost(fn: Callable, *args, **kw) -> OpCost:
    """Run ``fn(*args, **kw)`` once and count its cost (the module's
    docstring says what each field holds). The result of ``fn`` is
    dropped."""
    cost = OpCost()
    given = set()
    for t in _tensors((args, kw)):
        given.add(t.untyped_storage()._cdata)
    mode = _CostMode(cost, given)
    with _cost.counting(cost), mode:
        fn(*args, **kw)
    cost.peak_bytes = float(mode.peak)
    return cost
