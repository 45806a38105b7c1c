"""Versioned record stores: MVCC deltas over the packed PIR substrate.

Every scheme answers against a frozen :class:`RecordStore`; production
databases churn. A :class:`VersionedStore` layers append/update/delete
:class:`Delta`\\ s over a base store, hands out **frozen snapshots** —
``snapshot(v)`` is bit-identical to a store rebuilt from scratch at
version ``v`` — and tells the serving stack which records each delta
touched, so invalidation stays incremental.

Consistency model (MVCC, single writer):

* Every :meth:`VersionedStore.ingest` produces a new head
  ``RecordStore``; version numbers are the delta-log length. Snapshots are
  values: a reader holding one can never observe a later write, so batch
  pinning in the serve layer is "hold the snapshot object".
* Torch tensors are mutable where JAX buffers are not, so the value
  semantics rest on one rule: **no head, snapshot or
  ``RecordStore.packed`` is ever written in place.** Appends build a new
  buffer with ``torch.cat``; updates and deletes go through the functional
  :func:`repro_torch.kernels.backend.scatter_update`, which returns a
  fresh buffer (or the old one, untouched, for an empty delta).
* ``update`` rewrites records (same ``n``); ``delete`` is a tombstone (the
  record zeroes, ``n`` stays) — record indices are the address space
  clients query by; ``append`` grows ``n`` at the tail.
* Records partition into ``shards`` interleaved groups
  (``shard_of(i) = i % shards``, stable under append); ``shard_versions``
  records the last version that touched each shard.

The write path runs on the store's device. The host-numpy replay in
:func:`rebuild` is the independent oracle it is held to; it hands its
result back on the device of the store it started from, named
explicitly.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.db import packing
from repro_torch.db.store import RecordStore

__all__ = ["Delta", "VersionedStore", "apply_delta_np", "rebuild"]

# update/delete deltas larger than this apply in chunks of scatter launches
_SCATTER_CHUNK = 4096


@dataclasses.dataclass(frozen=True)
class Delta:
    """One batch of writes against a specific store version.

    ``kind`` ∈ {"append", "update", "delete"}; ``indices`` are the target
    records for update/delete (**deduplicated, last write wins** — the
    constructors enforce it so every backend impl agrees on the result);
    ``raw`` is the [m, nbytes] uint8 payload for append/update.
    Construct via :meth:`append` / :meth:`update` / :meth:`delete`.
    """

    kind: str
    indices: Optional[np.ndarray] = None
    raw: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.kind not in ("append", "update", "delete"):
            raise ValueError(f"unknown delta kind {self.kind!r}")
        if self.kind != "delete" and (
            self.raw is None or self.raw.ndim != 2
        ):
            raise ValueError(f"{self.kind} delta needs a [m, nbytes] payload")
        if self.kind != "append" and self.indices is None:
            raise ValueError(f"{self.kind} delta needs target indices")

    @property
    def count(self) -> int:
        """How many records this delta writes."""
        if self.kind == "delete":
            return int(self.indices.shape[0])
        return int(self.raw.shape[0])

    # ------------------------------------------------------- constructors
    @classmethod
    def append(cls, raw: np.ndarray) -> "Delta":
        """New records at the tail: raw [m, nbytes] uint8."""
        return cls(kind="append", raw=np.ascontiguousarray(raw, np.uint8))

    @classmethod
    def update(cls, indices, raw) -> "Delta":
        """Rewrite existing records; duplicate targets keep the last
        payload (numpy assignment semantics)."""
        idx = np.asarray(indices, np.int64).ravel()
        raw = np.ascontiguousarray(raw, np.uint8)
        if raw.shape[0] != idx.shape[0]:
            raise ValueError("update payload rows != index count")
        if idx.shape[0]:
            # last occurrence wins: unique over the reversed view finds
            # each target's final write
            _, first_rev = np.unique(idx[::-1], return_index=True)
            keep = np.sort(idx.shape[0] - 1 - first_rev)
            idx, raw = idx[keep], raw[keep]
        return cls(kind="update", indices=idx, raw=raw)

    @classmethod
    def delete(cls, indices) -> "Delta":
        """Tombstone records (zeroed, ``n`` unchanged)."""
        idx = np.unique(np.asarray(indices, np.int64).ravel())
        return cls(kind="delete", indices=idx)


def _packed_rows(delta: Delta, record_bits: int, words: int) -> np.ndarray:
    """The delta's payload packed to the store's [m, W] uint32 word layout
    (zeros for a tombstone)."""
    nbytes = -(-record_bits // 8)
    if delta.kind == "delete":
        return np.zeros((delta.count, words), dtype=np.uint32)
    if delta.raw.shape[1] != nbytes:
        raise ValueError(
            f"delta payload is {delta.raw.shape[1]} bytes/record; "
            f"store records are {nbytes}"
        )
    return packing.pack_bytes_np(delta.raw)


def _check_targets(delta: Delta, n: int) -> None:
    if delta.kind == "append" or delta.count == 0:
        return
    lo, hi = int(delta.indices.min()), int(delta.indices.max())
    if lo < 0 or hi >= n:
        raise IndexError(
            f"{delta.kind} targets [{lo}, {hi}] out of range for n={n}"
        )


def apply_delta_np(
    packed: np.ndarray, record_bits: int, delta: Delta
) -> np.ndarray:
    """Host-numpy replay of one delta on [n, W] uint32 words — the
    independent oracle the on-device ingest path is held to."""
    _check_targets(delta, packed.shape[0])
    rows = _packed_rows(delta, record_bits, packed.shape[1])
    if delta.kind == "append":
        return np.concatenate([packed, rows], axis=0)
    out = np.array(packed, copy=True)
    out[delta.indices] = rows
    return out


def _replay_np(base: RecordStore, deltas: Sequence[Delta]) -> np.ndarray:
    packed = packing.words_to_numpy(base.packed)
    for d in deltas:
        packed = apply_delta_np(packed, base.record_bits, d)
    return packed


def rebuild(base: RecordStore, deltas: Sequence[Delta]) -> RecordStore:
    """A store built from scratch: base + the delta log, replayed on the
    host and handed back on ``base``'s device.
    ``VersionedStore.snapshot(v)`` must be bit-identical to
    ``rebuild(base, log[:v])`` — the MVCC contract."""
    return RecordStore(
        packed=packing.words_from_numpy(_replay_np(base, deltas), base.device),
        record_bits=base.record_bits,
    )


class VersionedStore:
    """Append/update/delete deltas over a frozen base store, with
    versioned snapshots and shard-level touch tracking.

    ``shards`` controls the granularity the serving stack invalidates at;
    ``retain`` how many recent heads stay materialized (older snapshots
    rebuild from the delta log via the host oracle; in-flight serve
    batches pin their snapshot by holding the object, so retention only
    affects by-number access). ``backend`` picks the write-kernel registry
    entry (cuda / ref / auto) for delta application. Every head lies on
    the base store's device.

    **Compaction** (:meth:`compact`) rebases the store onto the current
    head: the head becomes the new frozen base, the delta log empties, and
    replay cost on :meth:`snapshot` resets to zero. Versions older than the
    new base become unreachable by number; readers that pinned a snapshot
    object are unaffected. ``shard_versions`` are absolute version numbers
    and survive the rebase.
    """

    def __init__(
        self,
        base: RecordStore,
        *,
        shards: int = 8,
        retain: int = 4,
        backend: str = "auto",
    ):
        if shards < 1:
            raise ValueError("shards must be >= 1")
        self.base = base
        self.shards = int(shards)
        self.backend = backend
        self._retain = max(1, int(retain))
        self._log: List[Delta] = []
        self._version = 0
        # compaction rebases `base` onto a later head; log entry i then
        # corresponds to version `_base_version + i + 1`
        self._base_version = 0
        self._heads: Dict[int, RecordStore] = {0: base}
        self._head = base
        #: per-shard last-touched version (the invalidation key)
        self.shard_versions: List[int] = [0] * self.shards
        self._lock = threading.Lock()
        self.metrics: Dict[str, int] = {
            "ingests": 0,
            "rows_appended": 0,
            "rows_updated": 0,
            "rows_deleted": 0,
            "snapshot_rebuilds": 0,
            "deltas_replayed": 0,
            "compactions": 0,
            "compacted_deltas": 0,
        }

    # ---------------------------------------------------------- accessors
    @property
    def version(self) -> int:
        return self._version

    @property
    def base_version(self) -> int:
        """The version the frozen base sits at (0 until a compaction)."""
        return self._base_version

    @property
    def log_depth(self) -> int:
        """Deltas currently in the log — the replay cost an evicted
        ``snapshot(v)`` can pay, and what :meth:`compact` resets."""
        return len(self._log)

    @property
    def n(self) -> int:
        return self._head.n

    @property
    def words(self) -> int:
        return self._head.words

    @property
    def record_bits(self) -> int:
        return self._head.record_bits

    def shard_of(self, index: int) -> int:
        """Stable shard mapping (interleaved groups: survives append)."""
        return int(index) % self.shards

    def shards_touched_since(self, version: int) -> Tuple[int, ...]:
        """Shards some delta after ``version`` touched — what must
        re-run precompute/re-plan; everything else keeps its state."""
        return tuple(
            s for s in range(self.shards) if self.shard_versions[s] > version
        )

    def touched_rows(self, delta: Delta, *, n_before: int) -> np.ndarray:
        """The record indices a delta writes (appends: the new tail)."""
        if delta.kind == "append":
            return np.arange(n_before, n_before + delta.count, dtype=np.int64)
        return np.asarray(delta.indices, np.int64)

    # ------------------------------------------------------------- writes
    def ingest(self, delta: Delta) -> int:
        """Apply one delta on the store's device; returns the new version
        number. Single writer: concurrent ingests serialize on the store
        lock. The new head is a fresh ``RecordStore`` over a fresh buffer
        (or, for an empty update or delete, the old buffer untouched);
        earlier snapshots are untouched values."""
        with self._lock:
            head = self._head
            dev = head.device
            _check_targets(delta, head.n)
            rows = packing.words_from_numpy(
                _packed_rows(delta, head.record_bits, head.words), dev
            )
            if delta.kind == "append":
                packed = torch.cat([head.packed, rows], dim=0)
                self.metrics["rows_appended"] += delta.count
            else:
                # lazy: the kernels import repro_torch.db at import time
                from repro_torch.kernels.backend import scatter_update

                packed = head.packed
                idx = torch.from_numpy(
                    np.asarray(delta.indices, np.int64).astype(np.int32)
                ).to(dev)
                for lo in range(0, int(idx.shape[0]), _SCATTER_CHUNK):
                    hi = lo + _SCATTER_CHUNK
                    packed = scatter_update(
                        packed, idx[lo:hi], rows[lo:hi], backend=self.backend
                    )
                key = (
                    "rows_updated" if delta.kind == "update"
                    else "rows_deleted"
                )
                self.metrics[key] += delta.count
            touched = self.touched_rows(delta, n_before=head.n)
            self._head = RecordStore(
                packed=packed, record_bits=head.record_bits
            )
            self._version += 1
            self._log.append(delta)
            self._heads[self._version] = self._head
            for s in np.unique(touched % self.shards):
                self.shard_versions[int(s)] = self._version
            self.metrics["ingests"] += 1
            # retention: keep the base and the last `retain` heads
            for v in [
                v for v in self._heads
                if v != self._base_version
                and v <= self._version - self._retain
            ]:
                del self._heads[v]
            return self._version

    # ------------------------------------------------------------ readers
    def snapshot(self, version: Optional[int] = None) -> RecordStore:
        """The immutable store at ``version`` (default: head).

        Bit-identical to :func:`rebuild`\\ (base, log[:version]) — from a
        retained head for recent versions, by host replay for evicted ones
        (counted in ``metrics["snapshot_rebuilds"]``; replay seeds from
        the *nearest* retained head below ``version`` and
        ``metrics["deltas_replayed"]`` counts the deltas it applied). The
        replayed store lies on the live store's device. Versions older
        than the compaction base are unreachable by number."""
        with self._lock:
            if version is None or version == self._version:
                return self._head
            if version < 0 or version > self._version:
                raise ValueError(
                    f"version {version} out of range [0, {self._version}]"
                )
            if version < self._base_version:
                raise ValueError(
                    f"version {version} predates the compaction base "
                    f"{self._base_version} (log rebased away)"
                )
            hit = self._heads.get(version)
            if hit is not None:
                return hit
            # seed from the nearest retained head below `version` (the
            # base-version head is always retained, so max() is safe)
            seed_v = max(v for v in self._heads if v < version)
            seed = self._heads[seed_v]
            log = list(
                self._log[seed_v - self._base_version:
                          version - self._base_version]
            )
        self.metrics["snapshot_rebuilds"] += 1
        self.metrics["deltas_replayed"] += len(log)
        return rebuild(seed, log)

    # --------------------------------------------------------- compaction
    def compact(self, *, check: bool = True) -> int:
        """Rebase onto the current head: head becomes the new frozen base,
        the delta log empties. Returns how many deltas were compacted away
        (0 when the log is already empty or a concurrent ingest raced the
        oracle check — callers retry on the next idle tick).

        ``check=True`` replays the log through the host oracle and holds
        the result bit for bit against the head before installing it, so a
        compaction can never silently corrupt the base. The replay runs
        outside the store lock, so writes never block on it.
        """
        with self._lock:
            if not self._log:
                return 0
            base, log = self.base, list(self._log)
            head, ver = self._head, self._version
        if check:
            oracle = _replay_np(base, log)
            if not np.array_equal(oracle, packing.words_to_numpy(head.packed)):
                raise RuntimeError(
                    "compaction oracle mismatch: rebuild(base, log) is "
                    "not bit-identical to the head — refusing to rebase"
                )
        with self._lock:
            if self._version != ver:
                return 0  # a write landed mid-check; retry next idle slot
            self.base = head
            self._base_version = ver
            self._log = []
            self._heads = {
                v: h for v, h in self._heads.items() if v >= ver
            }
            self._heads[ver] = head
            self.metrics["compactions"] += 1
            self.metrics["compacted_deltas"] += len(log)
            return len(log)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"VersionedStore(v={self._version}, n={self.n}, "
            f"shards={self.shards})"
        )
