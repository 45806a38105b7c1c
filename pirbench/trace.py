"""From a torch.profiler trace of the window to what the per-layer readers
read: the device operations, each tied to the benchmark's range it was
launched from, and the ranges themselves.

The benchmark opens its ranges (``torch.profiler.record_function``) from
its own wrappers around the program's layers, named ``pirbench.<layer>#<k>``
for the k-th call. A device operation belongs to the range that was open
on the launching thread when it was launched: the launch is the CUDA
runtime call with the operation's correlation id, and a host event's
thread is its ``device_resource_id`` (the system's thread id: the
profiler's own thread number is 1 for the launches the kernel library's
own CUDA runtime makes, on whatever thread they happen).
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

from pirbench import yardstick

PREFIX = "pirbench."
WINDOW = PREFIX + "window"


@dataclasses.dataclass(frozen=True)
class Range:
    layer: str       # "plan", "answer", ... (the name between prefix and #)
    seq: int         # the call's number, -1 without one
    start: float     # seconds, the trace's clock
    end: float
    tid: int


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    name: str
    start: float
    end: float
    stream: int
    owner: Optional[Range]   # the benchmark's range it was launched in


@dataclasses.dataclass
class Trace:
    window: Tuple[float, float]
    ops: List[DeviceOp]
    ranges: List[Range]
    unlinked: int            # device operations with no launch found

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> List[List[float]]:
        lo, hi = self.window
        return yardstick.union(
            yardstick.clip([(o.start, o.end) for o in self.ops], lo, hi))

    @property
    def busy_s(self) -> float:
        return yardstick.measure(self.busy_intervals())

    def complete(self, layer: str) -> List[Range]:
        """The ranges of ``layer`` that opened and closed in the window."""
        lo, hi = self.window
        return [r for r in self.ranges
                if r.layer == layer and r.start >= lo and r.end <= hi]

    def device_s(self, layer: str) -> Dict[int, float]:
        """Device seconds of the operations launched in each complete
        range of ``layer``, by the range's call number."""
        out = {r.seq: 0.0 for r in self.complete(layer)}
        for o in self.ops:
            if o.owner is not None and o.owner.layer == layer \
                    and o.owner.seq in out:
                out[o.owner.seq] += o.end - o.start
        return out

    def top_ops(self, k: int = 10) -> List[List]:
        """The ``k`` device operations that took the most time in all."""
        total: Dict[str, float] = {}
        lo, hi = self.window
        for o in self.ops:
            for s, e in yardstick.clip([(o.start, o.end)], lo, hi):
                total[o.name] = total.get(o.name, 0.0) + (e - s)
        return [[n, s] for n, s in
                sorted(total.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The ``k`` longest stretches with nothing on the device, each
        named by the innermost benchmark range open on the host at its
        middle (``host idle`` where none was)."""
        lo, hi = self.window
        busy = self.busy_intervals()
        gaps, t = [], lo
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        out = []
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:k]:
            mid = 0.5 * (s + e)
            open_ = [r for r in self.ranges
                     if r.start <= mid < r.end and r.layer != "window"]
            inner = max(open_, key=lambda r: r.start, default=None)
            out.append([f"host in {inner.layer}" if inner else "host idle",
                        e - s])
        return out


def _parse(name: str) -> Optional[Tuple[str, int]]:
    if not name.startswith(PREFIX):
        return None
    body = name[len(PREFIX):]
    layer, _, seq = body.partition("#")
    return layer, int(seq) if seq else -1


def _open_range(by_tid, starts, tid: int, t: float) -> Optional[Range]:
    """The innermost range open on thread ``tid`` at ``t``: the latest
    started one that has not closed (a thread's ranges nest or follow one
    another)."""
    rs = by_tid.get(tid)
    if not rs:
        return None
    i = bisect.bisect_right(starts[tid], t) - 1
    while i >= 0:
        if t < rs[i].end:
            return rs[i]
        i -= 1
        if i >= 0 and rs[i].end <= rs[i + 1].start:
            # ranges that ended before a later one began cannot hold t
            break
    return None


def reduce_profile(prof) -> Trace:
    """Reduce a finished ``torch.profiler.profile`` of the window."""
    from torch.autograd import DeviceType

    ranges: List[Range] = []
    launches: Dict[int, Tuple[int, float]] = {}
    device = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation() and not name.startswith(PREFIX):
                device.append(e)
            continue
        parsed = _parse(name)
        if parsed is not None:
            start = e.start_ns() / 1e9
            ranges.append(Range(parsed[0], parsed[1], start,
                                start + e.duration_ns() / 1e9,
                                e.device_resource_id()))
        elif name.startswith("cu") and e.correlation_id():
            launches[e.correlation_id()] = (e.device_resource_id(),
                                            e.start_ns() / 1e9)
    by_tid: Dict[int, List[Range]] = {}
    for r in ranges:
        if r.layer != "window":
            by_tid.setdefault(r.tid, []).append(r)
    starts = {}
    for tid, rs in by_tid.items():
        rs.sort(key=lambda r: r.start)
        starts[tid] = [r.start for r in rs]
    ops: List[DeviceOp] = []
    unlinked = 0
    for e in device:
        owner = None
        launch = launches.get(e.correlation_id())
        if launch is None:
            unlinked += 1
        else:
            owner = _open_range(by_tid, starts, *launch)
        start = e.start_ns() / 1e9
        ops.append(DeviceOp(e.name(), start, start + e.duration_ns() / 1e9,
                            int(e.device_resource_id()), owner))
    windows = [r for r in ranges if r.layer == "window"]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} window ranges")
    w = windows[0]
    return Trace(window=(w.start, w.end), ops=ops, ranges=ranges,
                 unlinked=unlinked)
