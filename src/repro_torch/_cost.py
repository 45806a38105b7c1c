"""The cost counter that the kernel wrappers and the collectives report to.

A count (:func:`repro_torch.launch.op_cost.count_cost`) sees every aten op
that a run dispatches, but not what the port does outside aten: a
hand-written kernel is a ctypes launch, and on a ``meta`` tensor it is not
launched at all. So each kernel wrapper reports its kernel's own cost here
(:func:`record_kernel`), and each collective of :mod:`repro_torch.dist.
collectives` its bytes (:func:`record_collective`), whenever a count is
active. With no count active both do nothing.

The counter is any object with the fields of
:class:`repro_torch.launch.op_cost.OpCost` (``flops``, ``bytes``,
``coll_bytes``, ``coll_counts`` and ``kernels``). The stack is
process-wide, not per thread: on the card the autograd engine runs a
backward on a thread of its own, and its work belongs to the count that
started it.
"""

from __future__ import annotations

import contextlib
from typing import List

__all__ = ["COLLECTIVE_OPS", "active", "counting", "record_kernel",
           "record_collective"]

# the reference's five collective kinds (launch/hlo_cost.py)
COLLECTIVE_OPS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

_STACK: List[object] = []


def active() -> bool:
    """Whether a count is running."""
    return bool(_STACK)


@contextlib.contextmanager
def counting(tally):
    """Make ``tally`` the active counter for the block."""
    _STACK.append(tally)
    try:
        yield tally
    finally:
        _STACK.pop()


def record_kernel(name: str, flops: float, nbytes: float) -> None:
    """A hand-written kernel's launch: its operations (``flops``) and the
    bytes it must move (each input read once, each output written once)."""
    for tally in _STACK:
        tally.flops += float(flops)
        tally.bytes += float(nbytes)
        tally.kernels[name] = tally.kernels.get(name, 0) + 1


def record_collective(kind: str, nbytes: float) -> None:
    """One collective of ``kind`` (one of :data:`COLLECTIVE_OPS`) whose
    result (the operand for a reduce-scatter) is ``nbytes`` at one mesh
    position, as the reference counts a collective per device. Its memory
    traffic is not added here: the copies and reductions that carry it
    out are aten ops, and the count sees them."""
    if kind not in COLLECTIVE_OPS:
        raise ValueError(f"unknown collective kind {kind!r}")
    for tally in _STACK:
        tally.coll_bytes[kind] += float(nbytes)
        tally.coll_counts[kind] += 1
