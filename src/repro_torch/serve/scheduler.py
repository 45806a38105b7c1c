"""Request queue + adaptive batch scheduling for the serving pipeline.

Clients enqueue (client, index) requests asynchronously; the scheduler
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
  * **Truncation**: a cut batch never exceeds ``max_batch``; the rest of
    the queue stays for the next cut.

The scheduler is deliberately synchronous and deterministic — ``clock``
is injectable so behavior tests need no real sleeps — and knows nothing
about schemes or privacy; admission control stays in the pipeline.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, List, Optional

__all__ = ["Request", "BatchScheduler", "bucket_size"]


@dataclasses.dataclass(frozen=True)
class Request:
    """One queued single-index query."""

    client: str
    index: int
    seq: int
    t_enqueue: float


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
        self._service_s_per_query: Optional[float] = None
        self._target = max_batch  # optimistic until service times arrive

    # ---------------------------------------------------------------- queue
    def __len__(self) -> int:
        return len(self._queue)

    def submit(self, client: str, index: int) -> Request:
        req = Request(client=client, index=int(index), seq=self._seq,
                      t_enqueue=self.clock())
        self._seq += 1
        self._queue.append(req)
        return req

    @property
    def target_batch(self) -> int:
        """Current adaptive batch-size target (∈ [min_batch, max_batch])."""
        return self._target

    def oldest_wait_s(self) -> float:
        return self.clock() - self._queue[0].t_enqueue if self._queue else 0.0

    def ready(self) -> bool:
        """True when a batch should be cut: target reached or deadline
        hit."""
        if not self._queue:
            return False
        if len(self._queue) >= self._target:
            return True
        return bool(self.max_wait_s) and self.oldest_wait_s() >= self.max_wait_s

    def next_batch(self) -> List[Request]:
        """Pop the next batch, at most ``max_batch`` requests (truncation
        leaves the rest)."""
        batch: List[Request] = []
        while self._queue and len(batch) < self.max_batch:
            batch.append(self._queue.popleft())
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
