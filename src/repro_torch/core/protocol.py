"""Staged scheme protocol: one client/server-split template for every scheme.

The paper's schemes differ only in how queries are *sampled and accounted*
— the serving shape is one template (DESIGN.md §Scheme protocol):

    client                          wire                    servers
    ──────                          ────                    ───────
    precompute(gen, n, b) ─► Plan
    query(plan, q_idx) ──────────► Queries ──────────────► answer(store, queries)
                                                                │
    reconstruct(answers) ◄───────  Answers  ◄───────────────────┘
    privacy(n) -> (ε, δ)   costs(n) -> Table-1 columns      (accounting, host-side)

:class:`Queries`/:class:`Answers` are the explicit wire boundary: a
``Queries``' ``kind``/``payload``/``servers`` are exactly the bits the
servers — and therefore the adversary — see (its ``q_idx`` field is
client-side reconstruction state that rides along and must never cross the
wire). ``gen`` is the ``torch.Generator`` all of a batch's client-private
randomness is drawn from.

Each scheme is a frozen dataclass registered under its config name via
:func:`register_scheme` (``chor``, ``sparse``, ``direct``, ``subset``). The
``as-*`` names are the :class:`Anonymized` combinator instead: it wraps
*any* registered scheme and rewrites only the accounting — the anonymity
system changes who the adversary can attribute messages to, not the bits
on the wire (paper §4.2/§4.4).

Jagged multi-index batches (:class:`MultiQueries`, ``multi_*``) flatten
per-request index lists onto the single-index wire, so every scheme's
stages serve them unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import (
    Any,
    Callable,
    Dict,
    List,
    Optional,
    Protocol,
    Sequence,
    Tuple,
    runtime_checkable,
)

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import accounting, chor, direct, sparse, subset
from repro_torch.db.store import RecordStore

__all__ = [
    "Queries",
    "MultiQueries",
    "Answers",
    "Plan",
    "SchemeProtocol",
    "register_scheme",
    "get_scheme",
    "registered_schemes",
    "scheme_param_names",
    "build_scheme",
    "as_protocol",
    "staged_retrieve",
    "jagged_offsets",
    "multi_bucket",
    "multi_pad",
    "multi_query",
    "multi_reconstruct",
    "multi_privacy",
    "staged_retrieve_many",
    "ChorScheme",
    "SparseScheme",
    "DirectPlan",
    "DirectScheme",
    "SubsetPlan",
    "SubsetScheme",
    "Anonymized",
]


# --------------------------------------------------------------------------
# Wire-boundary types
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Queries:
    """One batch's per-server wire payload — everything the servers see.

    kind "mask": payload [d_eff, B, n] {0,1} uint8 request masks.
    kind "index": payload [d, B, p/d] int32 record indices (the direct
    family). ``servers`` are the replica ids contacted (len d_eff ≤ scheme.d);
    ``theta`` is set for the sparse family so the execution backend can
    pick the gather path. ``q_idx`` never crosses the wire — it stays on
    the client for :meth:`SchemeProtocol.reconstruct`.

    ``store_version`` stamps which snapshot of a live
    :class:`~repro_torch.db.live.VersionedStore` the batch was planned
    against — None when serving a frozen store. Bookkeeping, not a wire
    secret: versions say *when* the database changed, never what was
    asked.
    """

    kind: str
    payload: torch.Tensor
    servers: Tuple[int, ...]
    q_idx: torch.Tensor
    theta: Optional[float] = None
    store_version: Optional[int] = None


@dataclasses.dataclass
class MultiQueries:
    """A jagged multi-index batch flattened onto the single-index wire.

    Request r's i-th index occupies flat column ``r·k_max + i`` of
    ``queries`` (each request padded to ``k_max`` columns, the request
    axis padded to a pow2 count, so the flat bucket ``B = R_pad·k_max`` is
    itself a pow2). Padding columns carry *real* queries for index 0 — on
    the wire they are indistinguishable from live columns — and their
    answers are dropped at reconstruction.

    ``offsets`` is the jagged descriptor (``offsets[r+1] − offsets[r]`` =
    request r's true index count); like ``q_idx`` it is client-side
    reconstruction state. Privacy is priced by the Composition Lemma as
    ``offsets[-1]`` sequential lookups (:func:`multi_privacy`). Delegating
    properties make a ``MultiQueries`` quack like its flat ``queries``, so
    every scheme's ``answer``/``reconstruct`` stage accepts it unchanged.
    """

    queries: Queries
    offsets: np.ndarray
    k_max: int
    requests: int

    # ------------------------------------------------ flat-wire delegation
    @property
    def kind(self) -> str:
        return self.queries.kind

    @property
    def payload(self) -> torch.Tensor:
        return self.queries.payload

    @property
    def servers(self) -> Tuple[int, ...]:
        return self.queries.servers

    @property
    def q_idx(self) -> torch.Tensor:
        return self.queries.q_idx

    @property
    def theta(self) -> Optional[float]:
        return self.queries.theta

    @property
    def store_version(self) -> Optional[int]:
        return self.queries.store_version

    @property
    def total(self) -> int:
        """True (unpadded) number of flattened indices."""
        return int(self.offsets[-1])


@dataclasses.dataclass
class Answers:
    """Per-server responses paired with the queries that produced them.

    mask kind: responses [d_eff, B, W] packed partial XOR folds.
    index kind: responses [d, B, p/d, W] packed records.
    """

    queries: Queries
    responses: torch.Tensor


class Plan(Protocol):
    """What :meth:`SchemeProtocol.precompute` returns: the
    query-independent half of a batch plan. Only the common fields are
    specified — ``n`` (store size the plan was built for) and ``batch``
    (batch size). Plans are **single-use** by contract: feeding one plan
    to two ``query()`` calls would correlate the adversary's views across
    those batches."""

    n: int
    batch: int


@runtime_checkable
class SchemeProtocol(Protocol):
    """The staged scheme interface (DESIGN.md §Scheme protocol).

    ``precompute → query`` runs on the client (generator in, wire bits
    out), ``answer`` on each server (the production path is
    :class:`repro_torch.serve.sharded.ShardedBackend`), ``reconstruct``
    back on the client. ``privacy`` and ``costs`` are host-side
    accounting.
    """

    d: int
    d_a: int
    has_precompute: bool

    def precompute(self, gen: torch.Generator, n: int, b: int) -> Plan: ...

    def query(
        self,
        plan: Plan,
        q_idx: torch.Tensor,
        *,
        pick_servers: Optional[Callable[[int], Sequence[int]]] = None,
    ) -> Queries: ...

    def answer(self, store: RecordStore, queries: Queries) -> Answers: ...

    def reconstruct(self, answers: Answers) -> torch.Tensor: ...

    def privacy(self, n: int) -> Tuple[float, float]: ...

    def costs(self, n: int) -> Dict[str, float]: ...


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------
_REGISTRY: Dict[str, type] = {}


def register_scheme(name: str) -> Callable[[type], type]:
    """Class decorator: register a staged scheme under its config name.
    The name becomes the class's ``name`` attribute (and the string that
    config parsing maps to the class — the only place scheme strings are
    interpreted)."""

    def deco(cls: type) -> type:
        key = name.lower()
        if key in _REGISTRY:
            raise ValueError(f"scheme {key!r} already registered")
        cls.name = key
        _REGISTRY[key] = cls
        return cls

    return deco


def get_scheme(name: str) -> type:
    """Look up a registered scheme class by name."""
    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown scheme {name!r}; registered: {registered_schemes()}"
        ) from None


def registered_schemes() -> Tuple[str, ...]:
    """Names of every registered base scheme (no ``as-`` variants — those
    are the :class:`Anonymized` combinator, not registry entries)."""
    return tuple(sorted(_REGISTRY))


def scheme_param_names(name: str) -> Tuple[str, ...]:
    """The scheme-specific parameter fields of a registered scheme (its
    dataclass fields beyond the universal ``d``/``d_a``) — what config
    parsing needs to forward, discovered instead of hard-coded."""
    return tuple(
        f.name
        for f in dataclasses.fields(get_scheme(name))
        if f.name not in ("d", "d_a")
    )


def build_scheme(name: str, d: int, d_a: int, **params: Any) -> "SchemeProtocol":
    """Instantiate a staged scheme from its config name.

    ``as-<base>`` names build the base scheme and wrap it in
    :class:`Anonymized` (requires ``u``). Parameters the scheme class does
    not declare are ignored (the back-compat facade carries all of
    theta/p/t/u regardless of scheme); missing required parameters raise
    ``ValueError`` from the class's own validation."""
    name = name.lower()
    if name.startswith("as-"):
        u = params.pop("u", None)
        if not (u and u >= 1):
            raise ValueError(f"{name} needs anonymity-set size u >= 1")
        return Anonymized(build_scheme(name[3:], d, d_a, **params), u=int(u))
    cls = get_scheme(name)
    allowed = {f.name for f in dataclasses.fields(cls)}
    kw = {k: v for k, v in params.items() if k in allowed and v is not None}
    return cls(d=d, d_a=d_a, **kw)


def as_protocol(scheme: Any) -> "SchemeProtocol":
    """Normalize to a staged scheme: protocol instances pass through,
    back-compat :class:`repro_torch.core.schemes.Scheme` facades are
    rebuilt from the registry (same name, same params ⇒ same wire
    bits)."""
    if isinstance(scheme, SchemeProtocol):
        return scheme
    name = getattr(scheme, "name", None)
    if name is None:
        raise TypeError(f"not a scheme: {scheme!r}")
    params = {
        k: getattr(scheme, k, None) for k in ("theta", "p", "t", "u")
    }
    return build_scheme(
        name,
        d=scheme.d,
        d_a=scheme.d_a,
        **{k: v for k, v in params.items() if v is not None},
    )


def staged_retrieve(
    scheme: "SchemeProtocol",
    gen: torch.Generator,
    store: RecordStore,
    q_idx: torch.Tensor,
) -> torch.Tensor:
    """Reference end-to-end path: run all four stages against one store.
    [B] indices -> [B, W] packed records."""
    plan = scheme.precompute(gen, store.n, int(q_idx.shape[0]))
    queries = scheme.query(plan, q_idx)
    answers = scheme.answer(store, queries)
    return scheme.reconstruct(answers)


# --------------------------------------------------------------------------
# Jagged multi-index batches
# --------------------------------------------------------------------------
def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length() if x > 1 else 1


def jagged_offsets(index_lists: Sequence[Sequence[int]]) -> np.ndarray:
    """[R+1] int32 prefix sums of the per-request index counts — the
    jagged descriptor every multi-index stage shares. Empty rows are
    legal."""
    counts = [len(ix) for ix in index_lists]
    return np.cumsum([0] + counts, dtype=np.int32)


def multi_bucket(index_lists: Sequence[Sequence[int]]) -> int:
    """Flat wire bucket for a jagged batch: requests padded to a pow2
    count, each to ``k_max`` (pow2) columns — ``B = R_pad·k_max`` is the
    batch size ``precompute`` must be built for."""
    r_pad = _next_pow2(max(1, len(index_lists)))
    k_max = _next_pow2(max([1] + [len(ix) for ix in index_lists]))
    return r_pad * k_max


def multi_pad(
    index_lists: Sequence[Sequence[int]], *, device: DeviceLike = None,
) -> Tuple[torch.Tensor, np.ndarray, int, int]:
    """Flatten a jagged batch onto the padded flat layout.

    Returns ``(q_idx, offsets, k_max, requests)``: ``q_idx`` is the [B]
    int32 flat index vector on ``device`` (``None``: the CUDA card) with
    request r's i-th index at ``r·k_max + i`` and index 0 in every padding
    slot; ``offsets`` the [R+1] jagged descriptor; ``requests`` the true
    request count.
    """
    offsets = jagged_offsets(index_lists)
    r_pad = _next_pow2(max(1, len(index_lists)))
    k_max = _next_pow2(max([1] + [len(ix) for ix in index_lists]))
    flat = np.zeros(r_pad * k_max, dtype=np.int32)
    for r, ix in enumerate(index_lists):
        flat[r * k_max : r * k_max + len(ix)] = np.asarray(ix, dtype=np.int32)
    q_idx = torch.from_numpy(flat).to(resolve_device(device))
    return q_idx, offsets, k_max, len(index_lists)


def multi_query(
    scheme: "SchemeProtocol",
    plan: Plan,
    index_lists: Sequence[Sequence[int]],
    *,
    pick_servers: Optional[Callable[[int], Sequence[int]]] = None,
    device: DeviceLike = None,
) -> MultiQueries:
    """Multi-index query stage: flatten+pad the jagged batch and drive the
    scheme's single-index ``query`` at the flat bucket. The plan must have
    been precomputed for :func:`multi_bucket` of the same batch;
    ``device`` is where the flat index vector goes (``None``: the card)."""
    q_idx, offsets, k_max, requests = multi_pad(index_lists, device=device)
    bucket = int(q_idx.shape[0])
    if plan.batch != bucket:
        raise ValueError(
            f"plan batch {plan.batch} != flat multi bucket {bucket} "
            f"(precompute with multi_bucket(index_lists))"
        )
    queries = scheme.query(plan, q_idx, pick_servers=pick_servers)
    return MultiQueries(
        queries=queries, offsets=offsets, k_max=k_max, requests=requests
    )


def multi_reconstruct(
    scheme: "SchemeProtocol", answers: Answers
) -> List[torch.Tensor]:
    """Multi-index reconstruct stage: run the scheme's flat
    ``reconstruct`` and split the [B, W] rows back into per-request
    [k_r, W] tensors in request order, dropping padding rows."""
    mq = answers.queries
    if not isinstance(mq, MultiQueries):
        raise TypeError(
            f"expected MultiQueries answers, got {type(mq).__name__}"
        )
    rows = scheme.reconstruct(answers)
    counts = np.diff(mq.offsets)
    return [
        rows[r * mq.k_max : r * mq.k_max + int(counts[r])]
        for r in range(mq.requests)
    ]


def multi_privacy(
    scheme: "SchemeProtocol", n: int, k: int
) -> Tuple[float, float]:
    """Composition Lemma pricing for a k-index lookup: k sequential
    single-index lookups spend exactly (k·ε, k·δ). Padding columns are
    free — their answers are dropped."""
    if k < 0:
        raise ValueError(f"need k >= 0 lookups, got {k}")
    eps, delta = scheme.privacy(n)
    return k * eps, k * delta


def staged_retrieve_many(
    scheme: "SchemeProtocol",
    gen: torch.Generator,
    store: RecordStore,
    index_lists: Sequence[Sequence[int]],
) -> List[torch.Tensor]:
    """Reference multi-index end-to-end path: one precompute at the flat
    bucket, one wire round trip, per-request [k_r, W] rows out — the same
    records a per-index loop of :func:`staged_retrieve` returns."""
    if not len(index_lists):
        return []
    plan = scheme.precompute(gen, store.n, multi_bucket(index_lists))
    mq = multi_query(scheme, plan, index_lists, device=store.device)
    answers = scheme.answer(store, mq)
    return multi_reconstruct(scheme, answers)


# --------------------------------------------------------------------------
# Shared pieces
# --------------------------------------------------------------------------
def _validate_servers(d: int, d_a: int) -> None:
    if d < 2:
        raise ValueError(f"need d >= 2 databases, got d={d}")
    if not (0 <= d_a < d):
        raise ValueError(f"need 0 <= d_a < d, got d={d}, d_a={d_a}")


def _signature(scheme: Any) -> Tuple:
    params = tuple(
        (f.name, getattr(scheme, f.name))
        for f in dataclasses.fields(scheme)
        if f.name not in ("d", "d_a")
    )
    return (scheme.name, scheme.d, scheme.d_a) + params


class _MaskFamily:
    """Shared server algebra of the XOR mask family (chor/sparse/subset): servers
    XOR-fold the records their mask selects; the client XORs the
    per-server folds. The reference ``answer`` here is the plain
    single-store path; the production path is
    ``repro_torch.serve.sharded``."""

    def answer(self, store: RecordStore, queries: Queries) -> Answers:
        responses = torch.stack(
            [chor.server_answer(store.packed, m) for m in queries.payload]
        )
        return Answers(queries=queries, responses=responses)

    def reconstruct(self, answers: Answers) -> torch.Tensor:
        return chor.reconstruct(answers.responses)

    @property
    def signature(self) -> Tuple:
        return _signature(self)


# --------------------------------------------------------------------------
# The paper's schemes as registry entries
# --------------------------------------------------------------------------
@register_scheme("chor")
@dataclasses.dataclass(frozen=True)
class ChorScheme(_MaskFamily):
    """Chor et al. (1995) IT-PIR — the perfectly-private baseline.
    privacy is (0, 0): the d request vectors are iid uniform to any
    d_a < d colluding servers."""

    d: int
    d_a: int

    has_precompute = True

    def __post_init__(self):
        _validate_servers(self.d, self.d_a)

    def privacy(self, n: int) -> Tuple[float, float]:
        return 0.0, 0.0

    def costs(self, n: int) -> Dict[str, float]:
        return accounting.scheme_costs("chor", n=n, d=self.d)

    def precompute(self, gen: torch.Generator, n: int, b: int) -> chor.ChorPre:
        return chor.precompute_queries(gen, n, self.d, b)

    def query(self, plan, q_idx, *, pick_servers=None) -> Queries:
        packed = chor.assemble_queries(plan, q_idx)
        return Queries(
            "mask", chor.query_masks(packed, plan.n), tuple(range(self.d)), q_idx
        )


@register_scheme("sparse")
@dataclasses.dataclass(frozen=True)
class SparseScheme(_MaskFamily):
    """Sparse-PIR (paper §4.3): Bernoulli(θ)-sparse Chor vectors.
    ε = 4·arctanh((1−2θ)^(d−d_a)) (Security Thm 3, tight)."""

    d: int
    d_a: int
    theta: Optional[float] = None

    has_precompute = True

    def __post_init__(self):
        _validate_servers(self.d, self.d_a)
        if not (self.theta and 0 < self.theta <= 0.5):
            raise ValueError(
                f"sparse needs 0 < theta <= 0.5, got {self.theta}"
            )

    def privacy(self, n: int) -> Tuple[float, float]:
        return accounting.epsilon_sparse(self.theta, self.d, self.d_a), 0.0

    def costs(self, n: int) -> Dict[str, float]:
        return accounting.scheme_costs(
            "sparse", n=n, d=self.d, theta=self.theta
        )

    def precompute(
        self, gen: torch.Generator, n: int, b: int
    ) -> sparse.SparsePre:
        return sparse.precompute_query_randomness(gen, n, self.d, self.theta, b)

    def query(self, plan, q_idx, *, pick_servers=None) -> Queries:
        masks = sparse.assemble_query_matrix(plan, q_idx)
        return Queries(
            "mask", masks, tuple(range(self.d)), q_idx, theta=self.theta
        )


@dataclasses.dataclass(frozen=True)
class DirectPlan:
    """The direct family's plan is just the generator: the p−1 dummy draws
    depend on the queried index (they must avoid it), so there is no
    query-independent half to bank — ``has_precompute`` is False and the
    cross-batch cache never pools these. ``query`` draws from ``gen``."""

    gen: torch.Generator
    n: int
    batch: int


@register_scheme("direct")
@dataclasses.dataclass(frozen=True)
class DirectScheme:
    """Direct Requests (paper §4.1): the real query hidden among p−1
    distinct dummies, split evenly over the d databases.
    ε = ln((d·(n−1)/(p−1) − d_a)/(d − d_a)) (Security Thm 1)."""

    d: int
    d_a: int
    p: Optional[int] = None

    has_precompute = False

    def __post_init__(self):
        _validate_servers(self.d, self.d_a)
        if not self.p or self.p % self.d:
            raise ValueError("direct needs p as a positive multiple of d")

    def privacy(self, n: int) -> Tuple[float, float]:
        return accounting.epsilon_direct(n, self.d, self.d_a, self.p), 0.0

    def costs(self, n: int) -> Dict[str, float]:
        return accounting.scheme_costs("direct", n=n, d=self.d, p=self.p)

    def precompute(self, gen: torch.Generator, n: int, b: int) -> DirectPlan:
        return DirectPlan(gen=gen, n=n, batch=b)

    def query(self, plan, q_idx, *, pick_servers=None) -> Queries:
        reqs = direct.gen_queries(plan.gen, plan.n, self.d, self.p, q_idx)
        return Queries("index", reqs, tuple(range(self.d)), q_idx)

    def answer(self, store: RecordStore, queries: Queries) -> Answers:
        responses = torch.stack(
            [direct.server_answer(store.packed, i) for i in queries.payload]
        )
        return Answers(queries=queries, responses=responses)

    def reconstruct(self, answers: Answers) -> torch.Tensor:
        return direct.select_response(
            answers.queries.payload, answers.responses, answers.queries.q_idx
        )

    @property
    def signature(self) -> Tuple:
        return _signature(self)


@dataclasses.dataclass(frozen=True)
class SubsetPlan:
    """Subset-PIR plan half: the uniform replica choice (``servers``, t
    ids, drawn with the plan) plus the Chor randomness for the t
    contacted servers."""

    servers: torch.Tensor
    chor_pre: chor.ChorPre

    @property
    def n(self) -> int:
        return self.chor_pre.n

    @property
    def batch(self) -> int:
        return self.chor_pre.batch


@register_scheme("subset")
@dataclasses.dataclass(frozen=True)
class SubsetScheme(_MaskFamily):
    """Subset-PIR (paper §5.1): Chor among a random t of the d servers.

    ``query`` takes the straggler policy through ``pick_servers`` — the
    serving pipeline passes its fastest-t-by-latency-EMA ranking; the
    default is the paper's uniform random subset (Algorithm 5.1), drawn
    with the plan.
    """

    d: int
    d_a: int
    t: Optional[int] = None

    has_precompute = True

    def __post_init__(self):
        _validate_servers(self.d, self.d_a)
        if not (self.t and 2 <= self.t <= self.d):
            raise ValueError("subset needs 2 <= t <= d")

    def privacy(self, n: int) -> Tuple[float, float]:
        """(0, δ) with δ = Π_{i<t} (d_a−i)/(d−i) (Security Thm 5): the
        probability every contacted server is corrupt. t ≤ d_a is legal by
        design — priced by δ > 0 rather than rejected; for t > d_a the
        product hits a zero factor and privacy is unconditional."""
        return 0.0, accounting.delta_subset(self.d, self.d_a, self.t)

    def costs(self, n: int) -> Dict[str, float]:
        return accounting.scheme_costs("subset", n=n, d=self.d, t=self.t)

    def precompute(self, gen: torch.Generator, n: int, b: int) -> SubsetPlan:
        servers = subset.choose_servers(gen, self.d, self.t)
        return SubsetPlan(
            servers=servers,
            chor_pre=chor.precompute_queries(gen, n, self.t, b),
        )

    def query(self, plan, q_idx, *, pick_servers=None) -> Queries:
        if pick_servers is not None:
            servers = tuple(int(s) for s in pick_servers(self.t))
        else:
            servers = tuple(int(s) for s in plan.servers.tolist())
        if len(servers) != self.t:
            raise ValueError(f"subset needs t={self.t} servers, got {servers}")
        packed = chor.assemble_queries(plan.chor_pre, q_idx)
        return Queries("mask", chor.query_masks(packed, plan.n), servers, q_idx)


# --------------------------------------------------------------------------
# The anonymity-system combinator
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Anonymized:
    """Route any scheme through an anonymity set of u users (paper
    §4.2/§4.4) — the combinator behind the ``as-*`` names.

    The AS is a perfectly secret permutation over user messages
    (:mod:`repro_torch.core.anonymity`): it changes *attribution*, not bits
    on the wire, so every wire stage delegates to the base scheme verbatim
    and only the accounting is rewritten — ε composes via the Composition
    Lemma, ε₂ = ln(e^{2ε₁} + u − 1) − ln u (Security Thms 2 and 4 are this
    lemma applied to Direct Requests and Sparse-PIR), and δ is untouched.
    Any registered scheme — or another wrapper — is a legal base.
    """

    base: Any
    u: int

    def __post_init__(self):
        if not isinstance(self.base, SchemeProtocol):
            raise TypeError(
                f"Anonymized needs a staged scheme, got {type(self.base).__name__}"
            )
        if self.u < 1:
            raise ValueError(f"{self.name} needs anonymity-set size u >= 1")

    # ------------------------------------------------------------- identity
    @property
    def name(self) -> str:
        return f"as-{self.base.name}"

    @property
    def d(self) -> int:
        return self.base.d

    @property
    def d_a(self) -> int:
        return self.base.d_a

    @property
    def has_precompute(self) -> bool:
        return self.base.has_precompute

    @property
    def signature(self) -> Tuple:
        return ("as", self.u) + tuple(self.base.signature)

    # ---------------------------------------------------- accounting (only)
    def privacy(self, n: int) -> Tuple[float, float]:
        eps, delta = self.base.privacy(n)
        return accounting.compose_with_anonymity(eps, self.u), delta

    def costs(self, n: int) -> Dict[str, float]:
        return self.base.costs(n)

    # ------------------------------------------- wire stages: pure delegation
    def precompute(self, gen: torch.Generator, n: int, b: int) -> Plan:
        return self.base.precompute(gen, n, b)

    def query(self, plan, q_idx, *, pick_servers=None) -> Queries:
        return self.base.query(plan, q_idx, pick_servers=pick_servers)

    def answer(self, store: RecordStore, queries: Queries) -> Answers:
        return self.base.answer(store, queries)

    def reconstruct(self, answers: Answers) -> torch.Tensor:
        return self.base.reconstruct(answers)
