"""Cross-batch query cache: budget-aware memoization for the serving path.

Caching is exactly where ε-PIR diverges from exact PIR. An exact-PIR
response is worthless to replay (fresh randomness per query is free and
perfect), but an ε-private scheme *prices* every query — so a cache that
reuses work across batches changes what the adversary sees and must be
reasoned about in the paper's (ε, δ) terms (§2.2; see DESIGN.md
§Cross-batch cache, which this port follows). Two surfaces, two different
privacy arguments:

**L1 — per-client query memo.** ``lookup``/``insert`` memoize, per
(client, index), the exact per-server query columns the client sent and
the reconstructed answer. A repeat of the *same* query by the *same*
client is served from the memo: the servers see nothing new (the entry is
either absorbed locally or a bit-identical replay), so the adversary's
likelihood ratio is unchanged from the first occurrence — replayed
randomness leaks nothing beyond the one query it already priced
(tests/test_torch_cache.py measures this). The privacy rule is
structural: the cache key *is* (client, index), so cached randomness can
never be reused across distinct client queries — a different index or a
different client is a different key and always gets fresh randomness.
Conservatively, **every hit still spends (ε, δ)**: admission control in
the pipeline charges the budget before the cache is ever consulted, so a
hit and a miss are indistinguishable to the accountant and exhausted
clients are refused even when the answer sits in cache.

**L2 — single-use precompute pool.** ``put_pre``/``take_pre`` hold
pre-generated *query-independent* randomness for upcoming batches: the
scheme-protocol ``Plan`` objects (DESIGN.md §Scheme protocol) that
``SchemeRouter.precompute`` emits, keyed (scheme, params, bucket) with
the bucket cross-checked against the plan's own batch size.
``ServingPipeline.prefill_cache`` fills the pool in idle time. Entries are
popped exactly once — a pre batch is fresh randomness that has never
touched a wire, and using it for one batch is distributionally identical
to generating it inline (bit-identical by construction: every scheme's
inline planning *is* ``query ∘ precompute``). Reuse across batches is
forbidden for the same reason L1 keys are structural: two batches
sharing randomness would hand the adversary correlated views.
``take_pre`` removes the entry; there is no peek.

**Refusal memo.** ``note_refusal``/``refused`` memoize per client that
the budget refused, so repeated over-budget polls skip the accountant
re-check — cheap today, measurable if budgets move to a remote store.
The memo is pure-function memoization, keyed on a hashable snapshot of
the budget state (limits + spend): ``can_spend`` is a pure function of
that state and the per-query price, and the price is pinned by the
cache's (scheme, n) signature, so a hit can never be stale — any budget
mutation (a top-up, spend through a shared budget object, a fresh
budget in a new pipeline reusing this cache) changes the token and
misses. It can only ever short-circuit a check that would refuse
anyway; it never touches the budget (refusals spend nothing —
tests/test_torch_cache.py asserts), and ``invalidate`` clears it along
with everything else.

Memory: L1 is an LRU bounded by ``max_entries``; query columns larger
than ``max_query_vector_bytes`` are dropped (the answer memo alone still
short-circuits the server round-trip). L2 is bounded by
``max_pre_batches`` per bucket — a SparsePre for bucket B costs ≈ B·n·d
bytes, so the pool depth, not the entry count, is the knob.

Thread safety: one internal lock guards every structure mutation AND
every ``metrics`` counter bump. The refusal memo may be consulted by
concurrent admission threads while flush threads drive lookup/insert/pre
— without the lock, the plain ``dict`` read-modify-write increments lose
updates under load ("close enough" counts are wrong counts;
tests/test_torch_cache.py hammers for exactness). Reading ``metrics`` without the lock stays safe: ints are
replaced, never mutated in place.

**Device memory.** An L1 entry lives on the host (numpy answer bytes and
query columns). An L2 pre lives where it was drawn — on the card for a
pipeline on the card: a Sparse-PIR plan at the CT scale is B·n·(d+1)
bytes (808 MB at B = 8, n = 10⁶, d = 100), so the pool holds at most
``max_pre_batches`` of them per bucket; :attr:`QueryCache.pre_bytes`
reports what it holds.

**Store versions.** The backing store may be a
:class:`~repro_torch.db.live.VersionedStore` absorbing deltas under traffic
(DESIGN.md §13). Every L1 entry is stamped with the store version its
answer was reconstructed against, the cache tracks the serving version
plus a per-index last-written map, and a hit whose entry predates the
last write to that index is *structurally* impossible: the pipeline's
``advance_version`` evicts touched entries at ingest time, and ``lookup``
independently refuses any entry older than the index's last write — so
even an entry inserted by an in-flight batch that pinned the pre-ingest
snapshot (double-buffering makes that ordering real) can never serve
stale bytes. Untouched indices keep their entries across ingests: a
delta that never wrote index ``i`` cannot change ``i``'s answer, so
those hits stay bit-exact and still spend (ε, δ) at admission like
every hit (tests/test_torch_cache.py checks across an ingest boundary). A *shape* change (append grew ``n``) re-signs the cache and
drops the L2 pre pool and refusal memo — pre randomness is built for
[B, n] and the per-query price moves with ``n``.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict, deque
from typing import Any, Deque, Dict, Optional, Tuple

import numpy as np

import torch

from repro_torch.core.protocol import as_protocol

__all__ = [
    "scheme_signature", "block_pre_ready", "pre_nbytes", "CacheEntry",
    "QueryCache",
]


def _pre_tensors(pre: Any):
    """Every tensor inside a precompute object (dataclasses nest)."""
    for field in dataclasses.fields(pre):
        value = getattr(pre, field.name)
        if dataclasses.is_dataclass(value):
            yield from _pre_tensors(value)
        elif isinstance(value, torch.Tensor):
            yield value


def block_pre_ready(pre: Any) -> Any:
    """Block until every tensor inside a precompute object is computed:
    synchronise each CUDA device its tensors lie on.

    Banking a pre whose randomness is still queued would just move the
    wait into the next flush — the producer (an idle worker) must absorb
    the compute, not the serve path."""
    devices = {t.device for t in _pre_tensors(pre) if t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return pre


def pre_nbytes(pre: Any) -> int:
    """Bytes of the tensors a precompute object holds (0 for an opaque
    object that is not a dataclass)."""
    if not dataclasses.is_dataclass(pre):
        return 0
    return sum(t.numel() * t.element_size() for t in _pre_tensors(pre))


def scheme_signature(scheme: Any, n: int) -> Tuple:
    """Hashable identity of (scheme, params, store size) — the cache is
    only valid for exactly this configuration. Accepts a staged
    :class:`~repro_torch.core.protocol.SchemeProtocol` instance or the
    back-compat facade; both normalize through the registry, so a facade
    ``make_scheme("as-sparse", ...)`` and the ``Anonymized(sparse, u)``
    it fronts sign identically."""
    return tuple(as_protocol(scheme).signature) + (int(n),)


@dataclasses.dataclass
class CacheEntry:
    """One memoized (client, index) query.

    ``query_cols`` are the exact per-server wire columns ([d_eff, n] mask
    bits or [d_eff, p/d] request indices) this client sent for this index
    — kept so a replay is provably bit-identical, dropped (None) when
    larger than the cache's ``max_query_vector_bytes``. ``answer`` is the
    reconstructed record bytes."""

    query_cols: Optional[np.ndarray]
    answer: np.ndarray
    hits: int = 0
    #: store version the answer was reconstructed against; ``lookup``
    #: refuses the entry once the index has a later write
    version: int = 0


class QueryCache:
    """Budget-aware cross-batch cache for one (scheme, params, store).

    See the module docstring for the privacy contract. The cache never
    touches :class:`~repro_torch.core.accounting.PrivacyBudget` itself —
    by design it *cannot* waive spending: the pipeline charges at
    admission, before lookup. The cache holds no store: answers are host
    bytes, and the pipeline's one backend keeps the store on the card.
    """

    def __init__(
        self,
        scheme: Any,
        n: int,
        *,
        max_entries: int = 4096,
        max_pre_batches: int = 2,
        max_query_vector_bytes: int = 1 << 20,
        max_refusal_entries: int = 4096,
    ):
        if max_entries < 0:
            raise ValueError(f"max_entries must be >= 0, got {max_entries}")
        self.signature = scheme_signature(scheme, n)
        self.max_entries = max_entries
        self.max_pre_batches = max_pre_batches
        self.max_query_vector_bytes = max_query_vector_bytes
        self.max_refusal_entries = max_refusal_entries
        self._entries: "OrderedDict[Tuple[str, int], CacheEntry]" = OrderedDict()
        #: serving store version (0 for frozen stores) and the
        #: per-index last-written version — the structural staleness guard
        self.version = 0
        self._written: Dict[int, int] = {}
        self._pre: Dict[int, Deque[Any]] = {}
        # client -> the budget-state token its refusal was computed from
        self._refused: "OrderedDict[str, Tuple]" = OrderedDict()
        # guards every structure mutation and metrics bump: admission
        # threads (refusal memo) race the flush/executor threads (L1/L2)
        self._mu = threading.Lock()
        self.metrics = {
            "hits": 0, "misses": 0, "insertions": 0, "evictions": 0,
            "pre_filled": 0, "pre_used": 0, "pre_dropped": 0,
            "invalidations": 0, "refusals_noted": 0, "refusal_hits": 0,
            "version_advances": 0, "stale_evictions": 0,
        }

    def __len__(self) -> int:
        with self._mu:
            return len(self._entries)

    # ------------------------------------------------- L1: per-client memo
    def lookup(self, client: str, index: int) -> Optional[CacheEntry]:
        """Memo for exactly (client, index); None on miss. The key is the
        privacy rule: no cross-client, no cross-index reuse, ever."""
        key = (client, int(index))
        with self._mu:
            entry = self._entries.get(key)
            if entry is None:
                self.metrics["misses"] += 1
                return None
            if self._written.get(int(index), -1) > entry.version:
                # the index was written after this answer was computed:
                # structurally refuse the stale entry (advance_version
                # normally evicted it already; this guard also catches
                # entries inserted by in-flight batches that pinned the
                # pre-ingest snapshot)
                del self._entries[key]
                self.metrics["stale_evictions"] += 1
                self.metrics["misses"] += 1
                return None
            self._entries.move_to_end(key)  # LRU touch
            entry.hits += 1
            self.metrics["hits"] += 1
            return entry

    def insert(
        self,
        client: str,
        index: int,
        *,
        answer: np.ndarray,
        query_cols: Optional[np.ndarray] = None,
        version: Optional[int] = None,
    ) -> None:
        """``version`` stamps the store version the answer was computed
        against (the executing batch's *pinned* snapshot version — which
        may lag the serving version mid-ingest); default: the cache's
        current version."""
        if self.max_entries == 0:
            return
        if (
            query_cols is not None
            and query_cols.nbytes > self.max_query_vector_bytes
        ):
            query_cols = None
        key = (client, int(index))
        with self._mu:
            self._entries[key] = CacheEntry(
                query_cols=query_cols, answer=np.asarray(answer),
                version=self.version if version is None else int(version),
            )
            self._entries.move_to_end(key)
            self.metrics["insertions"] += 1
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.metrics["evictions"] += 1

    # ----------------------------------------------- negative-result memo
    def note_refusal(self, client: str, token: Tuple) -> None:
        """Record that ``client``'s budget refused this cache's fixed
        (ε, δ) price, where ``token`` is the hashable budget-state
        snapshot the decision was computed from (see
        ``ServingPipeline._budget_token``). The refusal outcome is a
        pure function of (token, price), so memoizing on the token is
        exact: any budget mutation changes the token and the memo
        misses. Advisory only: the memo never touches the budget."""
        with self._mu:
            self._refused[client] = token
            self._refused.move_to_end(client)
            self.metrics["refusals_noted"] += 1
            while len(self._refused) > self.max_refusal_entries:
                self._refused.popitem(last=False)

    def refused(self, client: str, token: Tuple) -> bool:
        """True iff ``client`` is memoized as budget-exhausted for
        exactly this budget state (a changed token — top-up, shared-
        budget spend, fresh budget — is a miss, never a stale hit)."""
        with self._mu:
            if self._refused.get(client) != token:
                return False
            self._refused.move_to_end(client)  # LRU touch
            self.metrics["refusal_hits"] += 1
            return True

    # --------------------------------------------- L2: single-use pre pool
    def put_pre(self, bucket: int, pre: Any) -> bool:
        """Bank precomputed batch randomness for ``bucket``; False when the
        pool is full (the pre is dropped — never queued beyond the cap).
        A protocol Plan's own batch size must match the bucket it is
        banked under (opaque test doubles without a ``batch`` attribute
        are accepted as-is)."""
        batch = getattr(pre, "batch", None)
        if batch is not None and int(batch) != int(bucket):
            raise ValueError(
                f"pre built for batch {batch}, banked under bucket {bucket}"
            )
        with self._mu:
            q = self._pre.setdefault(int(bucket), deque())
            if len(q) >= self.max_pre_batches:
                self.metrics["pre_dropped"] += 1
                return False
            q.append(pre)
            self.metrics["pre_filled"] += 1
            return True

    def take_pre(self, bucket: int) -> Optional[Any]:
        """Pop (consume) one precomputed batch for ``bucket``. Single-use:
        a popped pre can never be handed out again."""
        with self._mu:
            q = self._pre.get(int(bucket))
            if not q:
                return None
            self.metrics["pre_used"] += 1
            return q.popleft()

    def pre_depth(self, bucket: int) -> int:
        with self._mu:
            return len(self._pre.get(int(bucket), ()))

    @property
    def pre_bytes(self) -> int:
        """Bytes of the banked pres' tensors, all buckets together."""
        with self._mu:
            return sum(pre_nbytes(p) for q in self._pre.values() for p in q)

    # ------------------------------------------------------------- control
    def advance_version(
        self,
        version: int,
        touched_indices=(),
        *,
        signature: Optional[Tuple] = None,
    ) -> int:
        """Move the cache to store ``version`` after an ingest
        (DESIGN.md §13): record the touched indices as written at this
        version and evict their L1 entries — everything else survives,
        because a delta that never wrote an index cannot change its
        answer. ``signature`` (the new ``scheme_signature``) re-signs the
        cache when the store *shape* changed (append grew ``n``): the L2
        pre pool and refusal memo drop too, since pre randomness is
        shaped [B, n] and the per-query price moves with ``n``. Returns
        how many entries were evicted."""
        with self._mu:
            self.version = int(version)
            touched = {int(i) for i in np.asarray(touched_indices).ravel()}
            for i in touched:
                self._written[i] = int(version)
            stale = [k for k in self._entries if k[1] in touched]
            for k in stale:
                del self._entries[k]
            self.metrics["stale_evictions"] += len(stale)
            self.metrics["version_advances"] += 1
            if signature is not None and signature != self.signature:
                self.signature = signature
                self._pre.clear()
                self._refused.clear()
            return len(stale)

    def invalidate(self) -> None:
        """Drop everything (backing store changed, budgets were reset, the
        scheme degraded under replica loss, or privacy review asked)."""
        with self._mu:
            self._entries.clear()
            self._pre.clear()
            self._refused.clear()
            self._written.clear()
            self.metrics["invalidations"] += 1
