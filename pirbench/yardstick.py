"""The benchmark's fixed arithmetic: the card's published memory bandwidth,
the union of a trace's intervals, and the least time a batch of server
answers needs (``answer_s`` for masks, ``gather_s`` for record ids).

Frozen here so that a change to the program cannot move it. ``union`` and
``measure`` are copies of ``chip_smoke.py``'s ``_union`` and ``_measure``;
the least times follow its ``fold_bound`` and ``check_gather``'s
distinct-row bytes. They count bytes alone: the records the queries
select, read once, the queries in their smaller form (packed mask bits or
record ids) and the answers written. Every kernel the planner can pick
moves at least that much (the dense ones read the whole store, a gather
the distinct rows), so the count is a floor whichever one it picks.
The XORs are not counted: a fold over a table of precombined rows does
fewer than one XOR a selected record word, so no XOR count is a floor.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

# published HBM3 bandwidth of one H100 SXM (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12


def union(intervals: Iterable[Sequence[float]]) -> List[List[float]]:
    """Sorted, merged [start, end) intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def measure(intervals: Iterable[Sequence[float]]) -> float:
    return sum(e - s for s, e in intervals)


def clip(intervals: Iterable[Sequence[float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The parts of ``intervals`` inside [lo, hi)."""
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def answer_s(n: int, words: int, bucket: int, p: float) -> float:
    """One server's least time for a bucket of masks whose bits are each
    set with probability ``p`` (θ for Sparse-PIR, 1/2 for Chor),
    independently across the bucket's queries: the distinct records the
    bucket selects, read once; the queries as packed mask bits or as
    32-bit ids of the selected records, whichever is smaller; and the
    answers written."""
    selected = bucket * n * p
    distinct = n * (1.0 - (1.0 - p) ** bucket)
    queries = min(bucket * -(-n // 8), selected * 4)
    moved = distinct * words * 4 + queries + bucket * words * 4
    return moved / HBM_BYTES_PER_S


def gather_s(rows: int, words: int, distinct: int | None = None) -> float:
    """One server's least time for ``rows`` record ids (an index batch:
    each id a row to return): the ``distinct`` rows among them (all, by
    default) read once, the 32-bit ids read, and the rows written."""
    distinct = rows if distinct is None else distinct
    moved = distinct * words * 4 + rows * 4 + rows * words * 4
    return moved / HBM_BYTES_PER_S
