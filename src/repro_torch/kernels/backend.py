"""The execution-backend layer: every kernel decision, in one place.

The serve layer asks this module to **plan** and then executes the
returned :class:`ExecutionPlan` — it never names a kernel (DESIGN.md
§Execution backends has the plan lifecycle of the reference package,
which this module follows).

* **Backend registry** (:func:`register_backend`): ``cuda`` (the CUDA
  kernels of this package), ``ref`` (their plain PyTorch versions —
  bit-identical, explicitly chosen), and ``auto`` (``cuda`` for a store on
  the card, ``ref`` for a store on the CPU). A backend resolves to a
  concrete *impl* and the planner builds executors from it. On the card,
  ``cuda`` and ``auto`` never route to a plain version.
* **Planner** (:class:`KernelPlanner`): ``plan(scheme_plan, bucket)`` maps
  one batch's wire plan (the scheme's
  :class:`~repro_torch.core.protocol.Queries` — its ``kind`` and θ are the
  only scheme-side facts execution needs) to an :class:`ExecutionPlan`
  carrying the chosen path, impl, block sizes, sparse index budget and a
  ready executor.

``plan()`` **never measures**: a cell is answered from the analytic prior
(``SchemeProtocol.costs(n)`` → the C_p crossover; the shared-memory gate
for the fused sparse forms; the measured fold/parity crossover of
:func:`repro_torch.kernels.ops.parity_crossover_batch`). The measured
autotune table of the reference package is not ported yet; every cell is
a cold cell here. A jagged multi-index bucket (``k_max``) priors to the
fused multi form when the slab fits, to the streaming pair when not.

The planner follows a live store: :meth:`KernelPlanner.rebind` keeps
every cached plan on a same-shape swap (executors read their operand per
call) and drops them when the shape changed. The write path is
:func:`scatter_update`, the delta-ingest primitive of
:mod:`repro_torch.db.live`.

The serve layer's ``parity_min_batch`` knob survives as a *forced*
decision (``ExecutionPlan.source == "forced"``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.db import packing
from repro_torch.db.store import RecordStore
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fused import (
    fused_block_w,
    fused_gather_fold,
    fused_multi_gather_fold,
)
from repro_torch.kernels.gather_xor import gather_xor, indices_from_mask
from repro_torch.kernels.parity_matmul import parity_matmul_packed
from repro_torch.kernels.scatter import scatter_rows
from repro_torch.kernels.xor_fold import xor_fold

__all__ = [
    "ExecutionPlan",
    "ExecutionBackend",
    "register_backend",
    "get_backend",
    "registered_backends",
    "KernelPlanner",
    "scatter_update",
]

Kernel = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


# --------------------------------------------------------------------------
# The plan
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """One batch's resolved execution decision.

    ``path`` is the physical kernel form (``fold`` / ``parity`` /
    ``sparse_fused`` / ``sparse_multi_fused`` / ``sparse_pair`` /
    ``sparse_ref``), ``impl`` the impl
    the executor is built from (never "auto"). ``blocks`` carries the
    chosen kernel block shape (``block_w``, ``grid_order``, and ``k_max``
    for the multi form), ``m_budget``
    the sparse index budget (None off the sparse family), and ``source``
    where the decision came from: ``model`` (analytic prior), ``forced``
    (caller override) or ``only`` (single candidate). ``run`` is the
    executor (payload -> [B, W]) that resolves the operand from the
    planner's *current* store at call time; ``kernel`` the raw executor
    ``(operand, payload) -> [B, W]`` behind it, so a caller can answer
    against an operand of its own.
    """

    path: str
    impl: str
    bucket: int
    n: int
    blocks: Tuple[Tuple[str, Any], ...] = ()
    m_budget: Optional[int] = None
    theta: Optional[float] = None
    source: str = "only"
    run: Optional[Callable[[torch.Tensor], torch.Tensor]] = dataclasses.field(
        default=None, compare=False, repr=False
    )
    kernel: Optional[Kernel] = dataclasses.field(
        default=None, compare=False, repr=False
    )

    @property
    def family(self) -> str:
        """The coarse path family (the serve layer's path_counts key)."""
        if self.path.startswith("sparse"):
            return "sparse"
        return self.path

    def __call__(
        self, payload: torch.Tensor, operand: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        if self.run is None:
            raise RuntimeError("this ExecutionPlan carries the decision only")
        if operand is not None:
            return self.kernel(operand, payload)
        return self.run(payload)

    def describe(self) -> str:
        return (
            f"{self.path}/{self.impl} b={self.bucket} n={self.n} "
            f"source={self.source}"
        )


# --------------------------------------------------------------------------
# Backend registry
# --------------------------------------------------------------------------
_BACKENDS: Dict[str, "ExecutionBackend"] = {}


def register_backend(name: str) -> Callable[[type], type]:
    """Class decorator: register an execution backend under its config
    name (the string ``backend=`` flags and configs carry)."""

    def deco(cls: type) -> type:
        key = name.lower()
        if key in _BACKENDS:
            raise ValueError(f"backend {key!r} already registered")
        cls.name = key
        _BACKENDS[key] = cls()
        return cls

    return deco


def get_backend(name: str) -> "ExecutionBackend":
    try:
        return _BACKENDS[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; registered: {registered_backends()}"
        ) from None


def registered_backends() -> Tuple[str, ...]:
    return tuple(sorted(_BACKENDS))


class ExecutionBackend:
    """One registered execution backend; ``resolve(device)`` returns the
    concrete impl ("cuda" or "ref") the planner builds executors for."""

    name = "?"

    def resolve(self, device: torch.device) -> str:
        return self.name


@register_backend("cuda")
class CudaBackend(ExecutionBackend):
    """The CUDA kernels. For a store on the CPU the kernel wrappers take
    their plain versions (the only place they ever do)."""


@register_backend("ref")
class RefBackend(ExecutionBackend):
    """The plain PyTorch versions, on either device."""


@register_backend("auto")
class AutoBackend(ExecutionBackend):
    """Kernels for a store on the card, plain versions for a store on the
    CPU — decided by where the store lies, never by probing for a card."""

    def resolve(self, device: torch.device) -> str:
        return "cuda" if device.type == "cuda" else "ref"


# --------------------------------------------------------------------------
# Planner
# --------------------------------------------------------------------------
class KernelPlanner:
    """Maps (wire plan, bucket) -> :class:`ExecutionPlan`.

    Owns the decisions the serve layer must not hardcode: which backend
    impl runs (registry), fold vs parity, fused vs streaming sparse, block
    shape and grid order, and the sparse index budget. ``plan()`` is
    measurement-free. ``smem_budget_bytes`` overrides the device-derived
    shared-memory gate of the fused form
    (``PIRConfig.fused_vmem_budget_bytes`` threads through here).
    """

    # the sparse gather forms only pay while the index budget stays
    # meaningfully below the record count; at θ·n ≈ n streaming the whole
    # store (fold/parity) beats chasing nearly-all of it record by record
    GATHER_DENSE_CUTOFF = 0.75

    def __init__(
        self,
        store: RecordStore,
        *,
        backend: str = "auto",
        parity_min_batch: Optional[int] = None,
        smem_budget_bytes: Optional[int] = None,
    ):
        self.backend = get_backend(backend)
        self.store = store
        self._parity_min_batch = parity_min_batch
        self._smem_budget = smem_budget_bytes
        self._planes: Optional[torch.Tensor] = None
        self._plans: Dict[Tuple, ExecutionPlan] = {}
        #: the incremental-invalidation contract: how many cached plans a
        #: store swap kept vs dropped, and how much precompute (bitplane)
        #: work re-ran
        self.metrics: Dict[str, int] = {
            "rebinds": 0,
            "plans_built": 0,
            "plans_kept": 0,
            "plans_dropped": 0,
            "precompute_full_builds": 0,
            "precompute_rows_refreshed": 0,
        }

    # ------------------------------------------------------------- helpers
    @property
    def backend_name(self) -> str:
        return self.backend.name

    def planes(self) -> torch.Tensor:
        """The store's uint8 bitplanes, built the first time a parity plan
        actually executes (at a million 1.5 kB records they are 12 GB),
        held bit column by bit column ([B, n] storage, this its [n, B]
        view: :func:`packing.bitplanes_from_packed`)."""
        if self._planes is None:
            self._planes = self.store.bitplanes()
            self.metrics["precompute_full_builds"] += 1
        return self._planes

    def _model_crossover(self) -> int:
        return ops.parity_crossover_batch(self.store.n, self.store.record_bits)

    def _fused_bw(self, n_eff: int) -> int:
        return fused_block_w(
            n_eff, self.store.words, budget_bytes=self._smem_budget,
            device=self.store.device,
        )

    # ------------------------------------------------------------ executors
    def _operand(self, path: str) -> torch.Tensor:
        """The kernel operand for a path, from the *current* store — read
        per call, never captured, so a plan outlives a store swap."""
        return self.planes() if path == "parity" else self.store.packed

    def _build_run(
        self, path: str, kernel: Kernel
    ) -> Callable[[torch.Tensor], torch.Tensor]:
        return lambda payload: kernel(self._operand(path), payload)

    def _prior(
        self, bucket: int, impl: str, sparse: bool,
        k_max: Optional[int] = None,
    ) -> Tuple[str, str, Dict[str, Any]]:
        """The analytic prior: (path, impl, blocks) for a cell of the
        dense-mask family (``sparse`` false) or the sparse family
        (``k_max`` set for a jagged multi-index bucket)."""
        if not sparse:
            qstar = self._model_crossover()
            path = "parity" if bucket >= qstar else "fold"
            return path, impl, {}
        if impl == "ref":
            return "sparse_ref", "ref", {}
        bw = self._fused_bw(self.store.n)
        if bw:
            # C_p says the work is m·BW either way; residency is the
            # model's tiebreak — fit shared memory, walk queries outer. A
            # jagged bucket stages the slab once per request for its
            # whole index list, so the multi form is its prior
            if k_max:
                return "sparse_multi_fused", impl, {
                    "block_w": bw, "grid_order": "rw", "k_max": k_max,
                }
            return "sparse_fused", impl, {"block_w": bw, "grid_order": "qw"}
        return "sparse_pair", impl, {}

    # ---------------------------------------------------------------- plan
    def plan(
        self,
        scheme_plan: Any,
        bucket: int,
        *,
        scheme: Any = None,
        k_max: Optional[int] = None,
    ) -> ExecutionPlan:
        """One batch's wire plan -> its execution decision.

        ``scheme_plan`` is the scheme's wire-level
        :class:`~repro_torch.core.protocol.Queries`; ``bucket`` the padded
        batch size. ``scheme`` (a staged SchemeProtocol) names the cell
        and supplies ``costs(n)`` as the analytic prior; without it the
        plan keys on the wire kind alone. ``k_max`` marks a jagged
        multi-index bucket (the padded per-request column count,
        ``bucket % k_max == 0``): a sparse cell then priors to the fused
        multi form. Plans are cached per cell, ``k_max`` included.
        """
        kind = scheme_plan.kind
        if kind != "mask":
            raise NotImplementedError(
                f"wire kind {kind!r} (the direct family) is not ported yet; "
                "see ROADMAP.md Queue A"
            )
        theta = getattr(scheme_plan, "theta", None)
        scheme_name = getattr(scheme, "name", None) or f"kind:{kind}"
        costs = scheme.costs(self.store.n) if scheme is not None else None
        impl = self.backend.resolve(self.store.device)
        if k_max is not None and (k_max < 1 or bucket % k_max):
            raise ValueError(
                f"multi bucket {bucket} not a multiple of k_max={k_max}"
            )

        cache_key = (scheme_name, kind, theta, int(bucket), impl, k_max)
        cached = self._plans.get(cache_key)
        if cached is not None:
            return cached

        n_eff = self.store.n
        blocks: Dict[str, Any] = {}
        m_budget = None
        sparse = (
            theta is not None and theta < 0.5
            and self._gather_pays(theta, costs, scheme)
        )
        if sparse:
            m_budget = ops.sparse_index_budget(n_eff, theta)
        if not sparse and self._parity_min_batch is not None:
            path = "parity" if bucket >= self._parity_min_batch else "fold"
            chosen_impl, source = impl, "forced"
        else:
            # the dense forms answer the whole flat bucket in one launch:
            # only the sparse gather forms have a multi variant
            path, chosen_impl, blocks = self._prior(
                int(bucket), impl, sparse, k_max if sparse else None
            )
            source = "only" if sparse and impl == "ref" else "model"

        kernel = _path_answer_fn(path, chosen_impl, m_budget, blocks)
        self.metrics["plans_built"] += 1
        plan = ExecutionPlan(
            path=path,
            impl=chosen_impl,
            bucket=int(bucket),
            n=n_eff,
            blocks=tuple(sorted(blocks.items())),
            m_budget=m_budget,
            theta=theta,
            source=source,
            run=self._build_run(path, kernel),
            kernel=kernel,
        )
        self._plans[cache_key] = plan
        return plan

    def _gather_pays(
        self, theta: float, costs: Optional[Dict[str, float]], scheme: Any
    ) -> bool:
        """Whether the sparse gather forms beat the dense mask forms at
        all — the scheme's own cost model decides. ``costs(n)`` prices
        C_p = θ·d·n·(c_acc + c_prc) (Table 1), so C_p/(2d) is the records
        a query touches per server; the static gather budget adds the 6σ
        Chernoff slack on top. Once that budget stops being meaningfully
        below the record count (θ·n ≈ n, or tiny stores where the slack
        dominates), streaming the whole store wins and the dense
        fold/parity decision takes over — only the physical form changes,
        bit-identically."""
        n = self.store.n
        d = getattr(scheme, "d", 0)
        touched = (
            costs["C_p"] / (2.0 * d)
            if costs is not None and d and "C_p" in costs
            else theta * n
        )
        budget = ops.sparse_index_budget(n, min(max(touched / n, 1e-9), 0.5))
        return budget < self.GATHER_DENSE_CUTOFF * n

    # ------------------------------------------------------------ swaps
    def invalidate(self) -> None:
        """Drop every cached plan."""
        self.metrics["plans_dropped"] += len(self._plans)
        self._plans.clear()

    def rebind(
        self,
        store: RecordStore,
        *,
        touched_rows: Optional[Any] = None,
    ) -> Dict[str, int]:
        """Swap the planner onto a new store version.

        A same-shape swap with a known touched-row set keeps every cached
        :class:`ExecutionPlan` (executors read their operand from
        ``self.store`` per call, so the new buffer flows in with zero
        replans) and refreshes only the touched rows of the bitplanes, if
        they were built. The refresh is functional — a new planes tensor,
        never a write into the old one, which a batch pinned to the old
        snapshot may still read. A shape change (an append) or an unknown
        touch set drops plans and planes. Returns the per-call counter
        deltas (also accumulated in :attr:`metrics`)."""
        self.metrics["rebinds"] += 1
        same_shape = (
            store.n == self.store.n
            and store.words == self.store.words
            and store.record_bits == self.store.record_bits
        )
        if same_shape and touched_rows is not None:
            self.store = store
            rows = torch.as_tensor(
                np.asarray(touched_rows, np.int64), device=store.device
            )
            refreshed = 0
            if self._planes is not None and rows.numel():
                fresh = packing.bitplanes_from_packed(
                    store.packed.index_select(0, rows),
                    dtype=self._planes.dtype,
                )
                # a new [B, n] storage, the touched records' columns
                # replaced; the old one stays as it was
                self._planes = self._planes.t().index_copy(
                    1, rows, fresh.t()).t()
                refreshed = int(rows.numel())
            kept = len(self._plans)
            self.metrics["plans_kept"] += kept
            self.metrics["precompute_rows_refreshed"] += refreshed
            return {
                "plans_kept": kept, "plans_dropped": 0,
                "precompute_rows_refreshed": refreshed,
            }
        self.store = store
        self._planes = None
        dropped = len(self._plans)
        self._plans.clear()
        self.metrics["plans_dropped"] += dropped
        return {
            "plans_kept": 0, "plans_dropped": dropped,
            "precompute_rows_refreshed": 0,
        }


@functools.lru_cache(maxsize=64)
def _all_live_offsets(requests: int, k_max: int,
                      device: torch.device) -> torch.Tensor:
    """[requests + 1] offsets with every row live (``r·k_max``), made once
    per (requests, k_max, device). Read-only: the kernel never writes it."""
    return torch.arange(requests + 1, dtype=torch.int32,
                        device=device) * k_max


def _path_answer_fn(
    path: str, impl: str, m_budget: Optional[int], blocks: Dict[str, Any],
) -> Kernel:
    """THE path→kernel dispatch: ``(operand, payload) -> [B, W]`` where
    ``operand`` is the packed db ([n, W] words) — or the bitplanes for the
    parity path. The ``ref`` impl routes to the plain versions on either
    device; the ``cuda`` impl to the kernel wrappers. ``blocks`` carries
    the block shape (``block_w``, ``grid_order``, ``k_max``) for the
    sparse forms."""
    if path == "fold":
        if impl == "ref":
            return ref.xor_fold_ref
        return xor_fold
    if path == "parity":
        if impl == "ref":
            return lambda planes, m: packing.pack_bits(
                ref.parity_matmul_ref(m, planes)
            )
        return lambda planes, m: parity_matmul_packed(m, planes)
    if path == "sparse_ref":
        return lambda db, m: ref.gather_xor_ref(
            db, indices_from_mask(m, m_budget)
        )
    if path == "sparse_pair":
        bw = blocks.get("block_w", 128)
        go = blocks.get("grid_order", "qwm")
        return lambda db, m: gather_xor(
            db, indices_from_mask(m, m_budget), block_w=bw, grid_order=go,
        )
    if path == "sparse_fused":
        bw = blocks["block_w"]
        go = blocks.get("grid_order", "qw")
        return lambda db, m: fused_gather_fold(
            db, indices_from_mask(m, m_budget), block_w=bw, grid_order=go,
        )
    if path == "sparse_multi_fused":
        bw = blocks["block_w"]
        go = blocks.get("grid_order", "rw")
        k_max = int(blocks["k_max"])

        def _multi(db: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
            idx = indices_from_mask(m, m_budget)
            # the serving layout keeps every flat column live (padding
            # columns are real dummy queries whose answers the client
            # drops), so the all-live offsets make this bit-identical to
            # the flat forms on the same payload
            off = _all_live_offsets(idx.shape[0] // k_max, k_max, idx.device)
            return fused_multi_gather_fold(
                db, idx, off, k_max=k_max, block_w=bw, grid_order=go,
            )

        return _multi
    raise ValueError(f"no kernel form for path {path!r}")


# --------------------------------------------------------------------------
# The write path: batched delta application (repro_torch.db.live's ingest)
# --------------------------------------------------------------------------
def scatter_update(
    db: torch.Tensor,
    rows: Any,
    vals: torch.Tensor,
    *,
    backend: str = "auto",
) -> torch.Tensor:
    """Apply a batch of packed-row updates on the store's device: the
    delta-ingest write primitive behind
    :meth:`repro_torch.db.live.VersionedStore.ingest`.

    db: [n, W]; rows: [m] int (tensor or array); vals: [m, W] (cast to
    ``db.dtype``) -> a new [n, W] buffer with ``out[rows[i]] = vals[i]``,
    last write winning on a duplicate row; ``db`` itself when ``m == 0``.

    The backend resolves by the store's device, as :meth:`KernelPlanner.plan`
    does: ``ref`` runs the plain version; ``cuda`` and ``auto`` launch the
    scatter kernel for a store on the card (and take the plain version for
    a store on the CPU). The reference's race of the kernel against its
    oracle through the autotune table is not ported; neither is its
    padding of the update count to a power of two, which only bounded jit
    retraces there."""
    if not isinstance(rows, torch.Tensor):
        rows = torch.as_tensor(np.asarray(rows, np.int64))
    rows = rows.to(device=db.device, dtype=torch.int32)
    if int(rows.shape[0]) == 0:
        return db
    impl = get_backend(backend).resolve(db.device)
    fn = ref.scatter_rows_ref if impl == "ref" else scatter_rows
    return fn(db, rows, vals.to(device=db.device))
