"""Request queue + adaptive batch scheduling for the serving pipeline.

Clients enqueue (client, index) requests — or jagged multi-index
requests, (client, [indices]) — asynchronously; the scheduler
decides *when* to cut a batch and *how big* it should be. Two forces pull
against each other: bigger batches amortise dispatch and reuse each
streamed db tile across more queries, but queueing for them adds latency.
The policy here:

  * **Adaptive target**: an EMA of per-query service time sets the target
    batch so a batch costs roughly ``target_latency_s`` to serve —
    fast hardware ⇒ bigger batches, slow hardware ⇒ smaller ones.
  * **Deadline flush**: a batch is cut early once the oldest queued
    request has waited ``max_wait_s`` (0 disables the deadline: only
    fullness or an explicit drain cuts batches).
  * **Bucket padding**: batches are padded up to power-of-two buckets
    (capped at ``max_batch``) so the server paths see O(log max_batch)
    distinct shapes (and plan cells) instead of one per batch size.
  * **Truncation**: a cut batch never exceeds ``max_batch`` flattened
    indices; the rest of the queue stays for the next cut.

A k-index request costs k lookups to serve, so fullness and truncation
count **flattened** indices (:attr:`BatchScheduler.flat_len`), not
requests.

The scheduler is deliberately synchronous and deterministic — ``clock``
is injectable so behavior tests need no real sleeps — and knows nothing
about schemes or privacy; admission control stays in the pipeline.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, List, Optional, Sequence, Tuple

__all__ = ["Request", "BatchScheduler", "bucket_size"]


@dataclasses.dataclass(frozen=True)
class Request:
    """One queued query — a single index, or a jagged multi-index list.

    ``indices`` is empty for single-index requests (``index`` is the
    query); a multi-index request carries its whole list there, with
    ``index`` mirroring the first entry. The scheduler prices a request by
    :attr:`k`, its flattened index count.
    """

    client: str
    index: int
    seq: int
    t_enqueue: float
    indices: Tuple[int, ...] = ()

    @property
    def k(self) -> int:
        """Flattened index count (what batching and budgets price)."""
        return len(self.indices) if self.indices else 1

    @property
    def index_list(self) -> Tuple[int, ...]:
        """The request's indices as a tuple, single-index included."""
        return self.indices if self.indices else (self.index,)


def bucket_size(b: int, max_batch: int) -> int:
    """Smallest power of two ≥ b, capped at ``max_batch``."""
    if b <= 0:
        return 0
    p = 1
    while p < b:
        p *= 2
    return min(p, max_batch)


class BatchScheduler:
    """Async-style request queue with adaptive batch sizing."""

    def __init__(
        self,
        *,
        max_batch: int = 1024,
        min_batch: int = 1,
        max_wait_s: float = 0.0,
        target_latency_s: float = 0.05,
        ema_alpha: float = 0.3,
        clock: Callable[[], float] = time.monotonic,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if not (1 <= min_batch <= max_batch):
            raise ValueError(
                f"need 1 <= min_batch <= max_batch, got {min_batch}/{max_batch}"
            )
        self.max_batch = max_batch
        self.min_batch = min_batch
        self.max_wait_s = max_wait_s
        self.target_latency_s = target_latency_s
        self.ema_alpha = ema_alpha
        self.clock = clock
        self._queue: Deque[Request] = deque()
        self._seq = 0
        self._flat = 0  # total flattened indices queued (Σ r.k)
        self._service_s_per_query: Optional[float] = None
        self._target = max_batch  # optimistic until service times arrive

    # ---------------------------------------------------------------- queue
    def __len__(self) -> int:
        return len(self._queue)

    @property
    def flat_len(self) -> int:
        """Total flattened indices queued — what ready() and next_batch
        cut on."""
        return self._flat

    def submit(self, client: str, index: int) -> Request:
        req = Request(client=client, index=int(index), seq=self._seq,
                      t_enqueue=self.clock())
        self._seq += 1
        self._queue.append(req)
        self._flat += req.k
        return req

    def submit_many(self, client: str, indices: Sequence[int]) -> Request:
        """Queue one jagged multi-index request (k = len(indices) ≥ 1)."""
        if not len(indices):
            raise ValueError("submit_many needs at least one index")
        req = Request(
            client=client, index=int(indices[0]), seq=self._seq,
            t_enqueue=self.clock(),
            indices=tuple(int(i) for i in indices),
        )
        self._seq += 1
        self._queue.append(req)
        self._flat += req.k
        return req

    @property
    def target_batch(self) -> int:
        """Current adaptive batch-size target (∈ [min_batch, max_batch])."""
        return self._target

    def oldest_wait_s(self) -> float:
        return self.clock() - self._queue[0].t_enqueue if self._queue else 0.0

    def ready(self) -> bool:
        """True when a batch should be cut: target reached or deadline
        hit. The target compares against flattened indices."""
        if not self._queue:
            return False
        if self._flat >= self._target:
            return True
        return bool(self.max_wait_s) and self.oldest_wait_s() >= self.max_wait_s

    def next_batch(self) -> List[Request]:
        """Pop the next batch, bounded by ``max_batch`` flattened indices
        (truncation leaves the rest; one oversized multi-index request is
        still taken alone rather than stranded)."""
        batch: List[Request] = []
        flat = 0
        while self._queue:
            nxt = self._queue[0]
            if batch and flat + nxt.k > self.max_batch:
                break
            batch.append(self._queue.popleft())
            flat += nxt.k
        self._flat -= flat
        return batch

    def padded_size(self, b: int) -> int:
        """Shape the batch is padded to before hitting the server paths."""
        return bucket_size(b, self.max_batch)

    # ------------------------------------------------------------- feedback
    def observe_service(self, batch_size: int, dt_s: float) -> None:
        """Feed back a served batch's wall time; adapts the target so one
        batch costs ≈ target_latency_s."""
        if batch_size <= 0 or dt_s <= 0.0:
            return
        per_q = dt_s / batch_size
        if self._service_s_per_query is None:
            self._service_s_per_query = per_q
        else:
            a = self.ema_alpha
            self._service_s_per_query = (
                (1 - a) * self._service_s_per_query + a * per_q
            )
        want = int(self.target_latency_s / self._service_s_per_query)
        self._target = max(
            self.min_batch,
            min(self.max_batch, bucket_size(max(want, 1), self.max_batch)),
        )
