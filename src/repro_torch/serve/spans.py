"""Profiler ranges inside the serving path, off unless a tracer turns them on.

``span(name, seq)`` opens a ``torch.profiler`` range named
``repro_torch.<name>``, or ``repro_torch.<name>#<seq>`` for a range of the
batch numbered ``seq`` (one batch's plan, execute, answer, settle and
resolve carry the same number, so they can be joined), on the calling
thread. Every range opens and closes on one thread. Being profiler ranges,
they share the device trace's clock; nothing else is recorded, exported or
written.

Off (the default), ``span`` returns one shared no-op context: a flag test,
with no string built, nothing allocated and no torch call, so a run that
does not trace pays nothing for the ranges. :func:`enable` is the one
switch; a tracer turns it on for the window it profiles and off after.
On, a range is recorded only if a profiler records when it opens, so
turning the ranges on before a profiler starts is safe.

The ranges, by thread (``serve/frontend.py``, ``serve/engine.py``,
``serve/sharded.py``):

* flush worker: ``front.cut`` (its lock and the scheduler's cut),
  ``plan#k`` (children ``plan.cache``, ``plan.route``, ``plan.prepare``),
  ``front.dispatch`` (the hand-off to the executor),
  ``front.settle#k``, ``front.resolve#k``, the idle
  slot's ``idle.ingest``, ``idle.compact``, ``idle.prefill``,
  ``idle.autotune``, and its wait: ``front.idle`` (nothing queued, being
  admitted or in flight) or ``front.hold`` (lookups queued, not yet due);
* executor: ``execute#k`` (children ``answer#k``, ``finalize``,
  ``execute.sync``, ``execute.host``); inside ``answer#k`` one
  ``answer.<path>`` a server, around its launches and its one sync (so
  their number in ``answer#k`` is the batch's sync count);
* ingest workers: ``front.admit`` around each admission;
* callers: ``front.submit`` around each submit;
* whichever thread runs it: ``gc`` around each collection of Python's
  garbage collector, which every thread of the process waits for.
"""

from __future__ import annotations

import contextlib
import gc
from typing import List, Optional

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

__all__ = ["PREFIX", "enable", "enabled", "span"]

PREFIX = "repro_torch."

_NOOP = contextlib.nullcontext()
_on = False


class _Range:
    """A ``_RecordFunctionFast`` range that opens only if a profiler
    records when it opens. A fast range opened before a profiler starts
    fails on its exit once one records, so a range that straddles a
    profiler's start is left out of its trace instead. The test is torch's
    process-wide flag: ``torch._C._autograd._profiler_enabled`` reads the
    calling thread's state, which a profile of every thread leaves unset."""

    __slots__ = ("_fast",)

    def __init__(self, name: str):
        self._fast = (_RecordFunctionFast(name)
                      if _profiler._is_profiler_enabled else None)

    def __enter__(self):
        if self._fast is not None:
            self._fast.__enter__()

    def __exit__(self, *exc):
        if self._fast is not None:
            self._fast.__exit__(*exc)


# the recorder: a name -> context manager that opens a profiler range. The
# collector's callback calls it too, from inside whatever code allocated,
# so it must take no lock that such code may hold.
_record = _Range


def enable(on: bool) -> None:
    """Turn the ranges on or off for every thread of the process."""
    global _on
    _on = bool(on)
    if _on and _gc_range not in gc.callbacks:
        gc.callbacks.append(_gc_range)
    elif not _on and _gc_range in gc.callbacks:
        gc.callbacks.remove(_gc_range)


def enabled() -> bool:
    return _on


# the collection in progress (one at a time: the collector holds the
# interpreter lock from its start to its stop, on one thread)
_gc_open: List[object] = []


def _gc_range(phase: str, info: dict) -> None:
    if phase == "start":
        r = _record(PREFIX + "gc")
        r.__enter__()
        _gc_open.append(r)
    elif _gc_open:
        _gc_open.pop().__exit__(None, None, None)


def span(name: str, seq: Optional[int] = None):
    """A context manager around one stage of the serving path: a profiler
    range while the ranges are on, else a shared no-op."""
    if not _on:
        return _NOOP
    return _record(PREFIX + name if seq is None else f"{PREFIX}{name}#{seq}")
