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
  ``cuda`` and ``auto`` never run a plain version: unlike the
  reference's ``auto``, the search never races the plain versions, which
  stay the oracle the kernels are held against.
* **Autotune table** (:class:`AutotuneTable`): a memo of *measured*
  search results, keyed ``(scheme, bucket, backend, n, words, family)``,
  each entry holding the winning candidate (path + impl + block shape),
  the microseconds of **every** candidate it beat (which keeps the
  decision auditable) and the fingerprint of the device it was measured on
  (:func:`repro_torch._device.device_fingerprint`). Merges drop entries
  fingerprinted for another device — a table the JAX package measured
  included — and count them. The JSON format is the reference
  package's (:func:`dump_autotune` / :func:`load_autotune`).
* **Planner** (:class:`KernelPlanner`): ``plan(scheme_plan, bucket)`` maps
  one batch's wire plan (the scheme's
  :class:`~repro_torch.core.protocol.Queries` — its ``kind`` and θ are the
  only scheme-side facts execution needs) to an :class:`ExecutionPlan`
  carrying the chosen path, impl, block sizes, sparse index budget and a
  ready executor (none for the ``index`` kind: the direct family's row
  gather belongs to the serve layer's index path).

``plan()`` **never measures**: a cell is answered from the table when a
measured entry exists, and otherwise from the analytic prior
(``SchemeProtocol.costs(n)`` → the C_p crossover; the shared-memory gate
for the fused sparse forms; the measured fold/parity crossover of
:func:`repro_torch.kernels.ops.parity_crossover_batch`), and the cold cell
is queued as *pending*. :meth:`KernelPlanner.tune_step` runs the search
off the request path: it enumerates every candidate of the cell — fold
against parity for the dense-mask family; the fused forms (where the gate
admits them), the streaming pair × ``block_w`` × ``grid_order`` and the
plain gather for the sparse family — times each at the cell's true shape
(:func:`_measure_us`: one warm-up call, which pays any kernel build, then
the best of three, each ending in a device synchronisation) and records
the winner. The prior's choice is one of the candidates, so a measured
plan never loses to the prior. The fold's form and the fused
kernels' cluster shape and staging path are the kernels' own choices, not
autotune axes; whether gathering pays at all is a formula decided before
any search (:meth:`KernelPlanner._gather_pays`).

The planner follows a live store: :meth:`KernelPlanner.rebind` keeps
every cached plan on a same-shape swap (executors read their operand per
call) and drops them when the shape changed; the table survives either
way. The write path is :func:`scatter_update`, the delta-ingest primitive
of :mod:`repro_torch.db.live`, which always launches the scatter kernel
for a store on the card.

The serve layer's ``parity_min_batch`` knob survives as a *forced*
decision (``ExecutionPlan.source == "forced"``).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import (
    DeviceLike,
    device_fingerprint,
    resolve_device,
    synchronize,
)
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
    "AutotuneTable",
    "autotune_table",
    "device_fingerprint",
    "load_autotune",
    "dump_autotune",
    "PlanCandidate",
    "TuneCell",
    "KernelPlanner",
    "shard_answer_fn",
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
    ``sparse_ref`` / ``direct``), ``impl`` the impl the executor is built
    from (never "auto"; always the impl the backend resolved to).
    ``blocks`` carries the chosen kernel block shape (``block_w``,
    ``grid_order``, and ``k_max`` for the multi form), ``m_budget`` the
    sparse index budget (None off the sparse family), and ``source`` where
    the decision came from: ``measured`` (autotune search winner),
    ``model`` (analytic prior — the cold-cell answer while the search is
    pending), ``forced`` (caller override) or ``only`` (single
    candidate). ``run`` is the executor (payload -> [B, W]) that resolves
    the operand from the planner's *current* store at call time;
    ``kernel`` the raw executor ``(operand, payload) -> [B, W]`` behind
    it, so a caller can answer against an operand of its own. Both are
    None for the direct family, whose gather the serve layer's index path
    owns, and for a mesh plan, whose shards the serve layer answers: such
    a plan carries the decision only.
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
            raise RuntimeError(
                "this ExecutionPlan carries the decision only (the direct "
                "family, or a mesh plan); the serve layer executes it"
            )
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
# Autotune table
# --------------------------------------------------------------------------
# (scheme, bucket, backend-impl, n, words, family): n/words qualify the
# conceptual (scheme, bucket, backend) key so two stores of different shape
# never share a measurement, and family ("mask" or "sparse@<theta>", with a
# "+multi@<k_max>" suffix for jagged multi-index buckets) keeps decisions
# with disjoint candidate sets from ever colliding under one key
Key = Tuple[str, int, str, int, int, str]


def _family(theta: Optional[float], k_max: Optional[int] = None) -> str:
    base = "mask" if theta is None else f"sparse@{float(theta):g}"
    return base if not k_max else f"{base}+multi@{int(k_max)}"


class AutotuneTable:
    """Memo of measured autotune-search results (the reference package's
    table, version 2, in the same JSON format).

    Entry: ``(scheme, bucket, backend, n, words, family) -> {"path",
    "impl", "blocks", "source", "us", "device", "store_shape"}``: the
    winning candidate, every measured candidate's microseconds by label,
    the fingerprint of the device that measured it, and the ``[n, words]``
    of the store it was measured against (None for hand-built entries).

    ``device`` is the device this table is *local* to (``None``: the
    card, an error without one): :meth:`put` stamps its fingerprint on an
    entry given none, and :meth:`update` (and so :func:`load_autotune`)
    merges only entries stamped with it — and, given ``store_shape``, no
    entry stamped for another shape — counting the rest in
    :attr:`dropped`. A table measured by the JAX package carries that
    package's fingerprint and is always dropped here.
    """

    VERSION = 2

    def __init__(self, device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        #: the fingerprint entries measured here are stamped with
        self.fingerprint = device_fingerprint(self.device)
        self._entries: Dict[Key, Dict[str, Any]] = {}
        #: cumulative count of entries refused by :meth:`update` (another
        #: device's, or another store shape's)
        self.dropped = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: Key) -> Optional[Dict[str, Any]]:
        return self._entries.get(key)

    def put(
        self,
        key: Key,
        path: str,
        *,
        impl: str,
        source: str,
        blocks: Optional[Dict[str, Any]] = None,
        us: Optional[Dict[str, float]] = None,
        device: Optional[Dict[str, str]] = None,
        store_shape: Optional[Sequence[int]] = None,
    ) -> None:
        """Record a decision. ``device`` is a fingerprint; None stamps
        this table's own (fresh measurements), deserialization passes the
        dumped one through."""
        self._entries[key] = {
            "path": path,
            "impl": impl,
            "blocks": dict(blocks or {}),
            "source": source,
            "us": dict(us or {}),
            "device": dict(device) if device is not None
            else dict(self.fingerprint),
            "store_shape": (
                [int(x) for x in store_shape]
                if store_shape is not None else None
            ),
        }

    def items(self):
        return self._entries.items()

    def clear(self) -> None:
        self._entries.clear()

    # ------------------------------------------------------------ JSON io
    def to_json(self) -> str:
        entries = [
            {
                "scheme": k[0], "bucket": k[1], "backend": k[2],
                "n": k[3], "words": k[4], "family": k[5], **v,
            }
            for k, v in sorted(self._entries.items())
        ]
        return json.dumps(
            {"version": self.VERSION, "entries": entries}, indent=2
        )

    @classmethod
    def from_json(cls, text: str, *, device: DeviceLike = None
                  ) -> "AutotuneTable":
        """Entries verbatim, whatever fingerprint they carry; the table
        is local to ``device``."""
        blob = json.loads(text)
        if blob.get("version") != cls.VERSION:
            raise ValueError(
                f"autotune table version {blob.get('version')!r} != "
                f"{cls.VERSION}"
            )
        table = cls(device)
        for e in blob["entries"]:
            table.put(
                (
                    str(e["scheme"]), int(e["bucket"]), str(e["backend"]),
                    int(e["n"]), int(e["words"]), str(e["family"]),
                ),
                str(e["path"]),
                impl=str(e["impl"]),
                source=str(e["source"]),
                blocks=dict(e.get("blocks", {})),
                us={k: float(v) for k, v in e.get("us", {}).items()},
                device={
                    k: str(v) for k, v in (e.get("device") or {}).items()
                },
                store_shape=e.get("store_shape"),
            )
        return table

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str, *, device: DeviceLike = None) -> "AutotuneTable":
        """Read a dumped table verbatim; merging it into a live table
        (:meth:`update`) is where the device filter applies."""
        with open(path) as f:
            return cls.from_json(f.read(), device=device)

    def update(
        self,
        other: "AutotuneTable",
        *,
        store_shape: Optional[Sequence[int]] = None,
    ) -> int:
        """Merge ``other``'s entries measured on *this* table's device;
        drop the rest. With ``store_shape=(n, words)``, entries stamped
        for a different shape are dropped too (unstamped entries pass on
        the device check alone). Returns the number dropped by this call
        (also accumulated in :attr:`dropped`)."""
        want = (
            [int(x) for x in store_shape]
            if store_shape is not None else None
        )
        dropped = 0
        for key, entry in other._entries.items():
            stamp = entry.get("store_shape")
            if entry.get("device") != self.fingerprint or (
                want is not None and stamp is not None and stamp != want
            ):
                dropped += 1
                continue
            self._entries[key] = entry
        self.dropped += dropped
        return dropped


_PROCESS_TABLES: Dict[str, AutotuneTable] = {}
_PROCESS_LOCK = threading.Lock()


def autotune_table(device: DeviceLike = None) -> AutotuneTable:
    """The process-local autotune table of ``device`` (``None``: the
    card), which every default planner on that device shares."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _PROCESS_LOCK:
        table = _PROCESS_TABLES.get(str(dev))
        if table is None:
            table = _PROCESS_TABLES[str(dev)] = AutotuneTable(dev)
        return table


def load_autotune(
    path: str,
    table: Optional[AutotuneTable] = None,
    *,
    store_shape: Optional[Sequence[int]] = None,
    device: DeviceLike = None,
) -> AutotuneTable:
    """Merge a dumped JSON table into ``table`` (default: the process
    table of ``device``); returns the merged table. Entries fingerprinted
    for another device — or, given ``store_shape``, stamped for another
    store shape — are dropped and counted (``table.dropped``)."""
    table = table if table is not None else autotune_table(device)
    table.update(AutotuneTable.load(path, device=table.device),
                 store_shape=store_shape)
    return table


def dump_autotune(path: str, table: Optional[AutotuneTable] = None, *,
                  device: DeviceLike = None) -> None:
    (table if table is not None else autotune_table(device)).dump(path)


# --------------------------------------------------------------------------
# The search space
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PlanCandidate:
    """One point in the autotune search space: a kernel path, the impl it
    runs on, and its block shape. ``label`` is the stable string the
    table's ``us`` timing map keys on."""

    path: str
    impl: str
    blocks: Tuple[Tuple[str, Any], ...] = ()

    @property
    def label(self) -> str:
        tail = "".join(f"+{k}={v}" for k, v in sorted(self.blocks))
        return f"{self.path}/{self.impl}{tail}"


@dataclasses.dataclass(frozen=True)
class TuneCell:
    """One pending autotune cell: everything :meth:`KernelPlanner.tune_step`
    needs to rebuild the candidate set and a representative payload off
    the request path."""

    scheme: str
    bucket: int
    impl: str  # the backend-resolved impl (candidate sets key off it)
    theta: Optional[float]
    n_eff: int
    m_budget: Optional[int]
    # jagged multi-index buckets: padded per-request column count (None
    # for single-index batches) — widens the sparse candidate set with the
    # fused multi form
    k_max: Optional[int] = None

    @property
    def family(self) -> str:
        return _family(self.theta, self.k_max)


def _bench_mask(gen: torch.Generator, bucket: int, n: int, p: float
                ) -> torch.Tensor:
    """[bucket, n] {0,1} uint8 mask of density ≈ p on the generator's
    device for the microbenchmark. Built from uint8 draws so the transient
    stays a few bucket·n bytes — a float32 uniform would be 4× that,
    mid-serving, at CT scale (128 MB a mask at bucket 128)."""
    draws = torch.randint(0, 256, (bucket, n), dtype=torch.uint8,
                          generator=gen, device=gen.device)
    return (draws < max(1, round(p * 256))).to(torch.uint8)


def _first_device(args: Sequence[Any]) -> Optional[torch.device]:
    return next((a.device for a in args if isinstance(a, torch.Tensor)),
                None)


def _measure_us(
    fn: Callable, *args, reps: int = 3,
    candidate: Optional[PlanCandidate] = None,
) -> float:
    """One candidate's microbenchmark: one warm-up call (which pays a
    first call's kernel build, so a build is never timed), then the best
    of ``reps`` host-clock samples, each ending in a synchronisation of
    the arguments' device, so a sample times the work and not its
    enqueue. The minimum is the statistic for an ordering decision (a
    stall inflates a sample; nothing deflates one). ``candidate`` names
    what is timed; this timer ignores it, injected ones key on it. A
    candidate that fails to build or launch raises here."""
    dev = _first_device(args)

    def sync():
        if dev is not None:
            synchronize(dev)

    fn(*args)
    sync()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        sync()
        best = min(best, time.perf_counter() - t0)
    return best * 1e6


# --------------------------------------------------------------------------
# Planner
# --------------------------------------------------------------------------
class KernelPlanner:
    """Maps (wire plan, bucket) -> :class:`ExecutionPlan`.

    Owns the decisions the serve layer must not hardcode: which backend
    impl runs (registry), fold vs parity, fused vs streaming sparse, block
    shape and grid order, and the sparse index budget. ``plan()`` is
    measurement-free: it answers from the autotune table or the analytic
    prior and queues cold cells; the search runs in :meth:`tune_step` /
    :meth:`tune_pending`, off the request path.

    ``table`` defaults to the process table of the store's device;
    ``seed`` fixes the bench payloads so a search over the same cells is
    reproducible; ``smem_budget_bytes`` overrides the device-derived
    shared-memory gate of the fused form
    (``PIRConfig.fused_vmem_budget_bytes`` threads through here);
    ``measure`` swaps the microbenchmark (tests inject deterministic
    timers).
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
        table: Optional[AutotuneTable] = None,
        parity_min_batch: Optional[int] = None,
        seed: int = 0,
        smem_budget_bytes: Optional[int] = None,
        measure: Optional[Callable[..., float]] = None,
    ):
        self.backend = get_backend(backend)
        self.store = store
        self.table = table if table is not None else autotune_table(
            store.device)
        self._fingerprint = device_fingerprint(store.device)
        self._parity_min_batch = parity_min_batch
        self._seed = int(seed)
        self._smem_budget = smem_budget_bytes
        self._measure = measure if measure is not None else _measure_us
        self._planes: Optional[torch.Tensor] = None
        self._plans: Dict[Tuple, ExecutionPlan] = {}
        self._pending: Dict[Key, TuneCell] = {}
        self._lock = threading.Lock()
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

    def _table_key(
        self, scheme_name: str, bucket: int, impl: str,
        theta: Optional[float] = None, k_max: Optional[int] = None,
    ) -> Key:
        return (
            scheme_name, int(bucket), impl, self.store.n, self.store.words,
            _family(theta, k_max),
        )

    def _table_hit(self, key: Key) -> Optional[Dict[str, Any]]:
        """A table entry is only trusted when its fingerprint is this
        store's device's (a hand-built table may carry foreign entries;
        :meth:`AutotuneTable.update` filters, ``table=`` does not) and its
        winner runs in the key's own impl."""
        hit = self.table.get(key)
        if hit is None:
            return None
        dev = hit.get("device")
        if dev is not None and dev != self._fingerprint:
            return None
        if hit.get("impl", key[2]) != key[2]:
            # a winner in another impl (a plain version recorded under a
            # kernel key) would take the card's path off its kernels
            return None
        return hit

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

    # ------------------------------------------------------- the search space
    def _candidates(self, cell: TuneCell) -> List[PlanCandidate]:
        """Enumerate the cell's search space: path × block shape × grid
        order, all in the cell's own impl. Unlike the reference, ``auto``
        does not add the plain versions to the race: on the card every
        candidate is a kernel, and the plain versions stay the oracle the
        kernels are held against. The fused forms join only where the
        shared-memory gate admits the slab: at the CT record (384 words)
        that is n ≤ 7264, so a CT-scale sparse cell races the streaming
        pair alone."""
        impl = cell.impl
        if cell.theta is None:  # dense-mask family: fold vs parity
            return [PlanCandidate("fold", impl), PlanCandidate("parity", impl)]
        if impl == "ref":
            return [PlanCandidate("sparse_ref", "ref")]
        out: List[PlanCandidate] = []
        w = self.store.words
        bw_max = self._fused_bw(cell.n_eff)
        fused_bws = [bw_max] if bw_max else []
        if bw_max // 2 >= 8:  # a narrower tile, if one is distinct
            fused_bws.append(bw_max // 2)
        for bw in fused_bws:
            for go in ("qw", "wq"):
                out.append(PlanCandidate(
                    "sparse_fused", impl,
                    (("block_w", bw), ("grid_order", go)),
                ))
            # a jagged multi-index bucket races the fused multi form too;
            # the streaming pair stays in the set as its bit-identical
            # alternative
            if cell.k_max:
                for go in ("rw", "wr"):
                    out.append(PlanCandidate(
                        "sparse_multi_fused", impl,
                        (("block_w", bw), ("grid_order", go),
                         ("k_max", cell.k_max)),
                    ))
        for bw in sorted({min(128, w), min(32, w)}, reverse=True):
            for go in ("qwm", "wqm"):
                out.append(PlanCandidate(
                    "sparse_pair", impl,
                    (("block_w", bw), ("grid_order", go)),
                ))
        return out

    def _prior(self, cell: TuneCell) -> Tuple[str, str, Dict[str, Any]]:
        """The analytic prior: the measurement-free answer a request
        thread gets for a cold cell. Returns (path, impl, blocks)."""
        if cell.theta is None:
            qstar = self._model_crossover()
            path = "parity" if cell.bucket >= qstar else "fold"
            return path, cell.impl, {}
        if cell.impl == "ref":
            return "sparse_ref", "ref", {}
        bw = self._fused_bw(cell.n_eff)
        if bw:
            # C_p says the work is m·BW either way; residency is the
            # model's tiebreak — fit shared memory, walk queries outer. A
            # jagged bucket stages the slab once per request for its
            # whole index list, so the multi form is its prior
            if cell.k_max:
                return "sparse_multi_fused", cell.impl, {
                    "block_w": bw, "grid_order": "rw", "k_max": cell.k_max,
                }
            return "sparse_fused", cell.impl, {
                "block_w": bw, "grid_order": "qw",
            }
        return "sparse_pair", cell.impl, {}

    # ------------------------------------------------------------ the search
    def pending(self) -> Tuple[Key, ...]:
        """Cells planned from the prior and still awaiting their search."""
        with self._lock:
            return tuple(self._pending)

    def _note_pending(self, key: Key, cell: TuneCell) -> None:
        with self._lock:
            if key not in self._pending and self._table_hit(key) is None:
                self._pending[key] = cell

    def tune_step(self, max_cells: int = 1) -> int:
        """Run the autotune search for up to ``max_cells`` pending cells
        (FIFO). Returns how many were tuned. This is the idle-slot entry
        point (``ServingPipeline.autotune_step``): the table fills during
        lulls instead of stalling requests."""
        tuned = 0
        while tuned < max_cells:
            with self._lock:
                if not self._pending:
                    break
                key = next(iter(self._pending))
                cell = self._pending.pop(key)
            self._tune_cell(key, cell)
            tuned += 1
        return tuned

    def tune_pending(self) -> int:
        """Drain the pending queue completely (benchmarks and shutdown
        dumps call this; serving uses :meth:`tune_step`)."""
        return self.tune_step(max_cells=len(self._pending) + 1_000_000)

    def _bench_payload(self, key: Key, cell: TuneCell) -> torch.Tensor:
        """A representative payload for the cell on the store's device,
        deterministic in (planner seed, cell key): a generator seeded from
        both (the reference's ``fold_in`` of ``crc32(repr(key))``)."""
        if cell.theta is None:
            density = 0.5
        else:
            density = min(
                0.5, max(0.01, (cell.m_budget or 1) / max(cell.n_eff, 1))
            )
        crc = zlib.crc32(repr(key).encode()) & 0x7FFFFFFF
        gen = torch.Generator(device=self.store.device)
        gen.manual_seed(((self._seed & 0xFFFFFFFF) << 31) | crc)
        return _bench_mask(gen, cell.bucket, self.store.n, density)

    def _tune_cell(self, key: Key, cell: TuneCell) -> None:
        """Measure every candidate of one cell and record the winner (with
        all timings and the device fingerprint) in the table."""
        cands = self._candidates(cell)
        if not cands:
            return
        shape = (self.store.n, self.store.words)
        if len(cands) == 1:
            c = cands[0]
            self.table.put(
                key, c.path, impl=c.impl, blocks=dict(c.blocks),
                source="only", device=self._fingerprint, store_shape=shape,
            )
        else:
            payload = self._bench_payload(key, cell)
            us: Dict[str, float] = {}
            by_label: Dict[str, PlanCandidate] = {}
            for c in cands:
                fn = self._build_run(c.path, _path_answer_fn(
                    c.path, c.impl, cell.m_budget, dict(c.blocks)))
                us[c.label] = float(self._measure(fn, payload, candidate=c))
                by_label[c.label] = c
            del payload
            winner = by_label[min(us, key=us.get)]
            self.table.put(
                key, winner.path, impl=winner.impl,
                blocks=dict(winner.blocks), source="measured", us=us,
                device=self._fingerprint, store_shape=shape,
            )
        with self._lock:
            # cached prior plans for this cell are stale now
            self._plans.clear()

    # ---------------------------------------------------------------- plan
    def plan(
        self,
        scheme_plan: Any,
        bucket: int,
        mesh_state: Optional[dict] = None,
        *,
        scheme: Any = None,
        k_max: Optional[int] = None,
    ) -> ExecutionPlan:
        """One batch's wire plan -> its execution decision.

        ``scheme_plan`` is the scheme's wire-level
        :class:`~repro_torch.core.protocol.Queries`; ``bucket`` the padded
        batch size; ``mesh_state`` the serve layer's mesh residency
        (``{"mesh", "raxes", "n_pad", "rshards", ...}``; None off the
        mesh): a mesh plan is sized for one record shard
        (``n_pad // rshards`` records), carries the decision only (``run``
        is None: the serve layer runs :func:`shard_answer_fn` on each
        shard) and never queues its cell for the search. ``scheme`` (a staged SchemeProtocol) keys the autotune
        table and supplies ``costs(n)`` as the analytic prior; without it
        the plan keys on the wire kind alone. ``k_max`` marks a jagged
        multi-index bucket (the padded per-request column count,
        ``bucket % k_max == 0``): a sparse cell then races the fused multi
        form too, under its own ``+multi@<k_max>`` family. The ``index``
        kind (the direct family) plans the decision-only ``direct`` path.

        Never measures: a table hit returns the recorded search winner, a
        miss the analytic prior, and a cold cell off the mesh is queued for
        :meth:`tune_step`. Plans are cached per cell, ``k_max`` and the
        mesh residency included.
        """
        kind = scheme_plan.kind
        theta = getattr(scheme_plan, "theta", None)
        scheme_name = getattr(scheme, "name", None) or f"kind:{kind}"
        costs = scheme.costs(self.store.n) if scheme is not None else None
        on_mesh = mesh_state is not None
        mesh_key = (
            (id(mesh_state["mesh"]), mesh_state["raxes"]) if on_mesh else None
        )
        impl = self.backend.resolve(self.store.device)
        if k_max is not None and (k_max < 1 or bucket % k_max):
            raise ValueError(
                f"multi bucket {bucket} not a multiple of k_max={k_max}"
            )

        cache_key = (
            scheme_name, kind, theta, int(bucket), impl, mesh_key, k_max
        )
        cached = self._plans.get(cache_key)
        if cached is not None:
            return cached

        n_eff = (
            mesh_state["n_pad"] // mesh_state["rshards"]
            if on_mesh else self.store.n
        )
        blocks: Dict[str, Any] = {}
        m_budget = None
        chosen_impl = impl
        if kind == "index":
            path, source = "direct", "only"
        elif kind != "mask":
            raise ValueError(f"unknown wire kind {kind!r}")
        else:
            sparse = (
                theta is not None and theta < 0.5
                and self._gather_pays(theta, costs, scheme)
            )
            cell_theta = theta if sparse else None
            # the dense forms answer the whole flat bucket in one launch:
            # only the sparse gather forms have a multi variant to race
            cell_k = k_max if sparse else None
            if sparse:
                m_budget = ops.sparse_index_budget(n_eff, theta)
            cell = TuneCell(
                scheme=scheme_name, bucket=int(bucket), impl=impl,
                theta=cell_theta, n_eff=n_eff, m_budget=m_budget,
                k_max=cell_k,
            )
            if not sparse and self._parity_min_batch is not None:
                path = (
                    "parity" if bucket >= self._parity_min_batch else "fold"
                )
                source = "forced"
            else:
                key = self._table_key(
                    scheme_name, bucket, impl, cell_theta, cell_k
                )
                hit = self._table_hit(key)
                if hit is not None:
                    path = hit["path"]
                    chosen_impl = hit.get("impl", impl)
                    blocks = dict(hit.get("blocks", {}))
                    source = hit["source"]
                else:
                    path, chosen_impl, blocks = self._prior(cell)
                    source = "only" if sparse and impl == "ref" else "model"
                    if not on_mesh and source == "model":
                        self._note_pending(key, cell)

        # the direct family's gather has one physical form, owned by the
        # serve layer's index path: its plan is decision-only, like every
        # mesh plan
        run = kernel = None
        if not on_mesh and path != "direct":
            kernel = _path_answer_fn(path, chosen_impl, m_budget, blocks)
            run = self._build_run(path, kernel)
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
            run=run,
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
        """Drop every cached plan (the mesh changed); the autotune table
        survives — measurements key on shapes, not residency."""
        with self._lock:
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
    a store on the CPU). The reference races the kernel against its plain
    version through the autotune table; the port does not, so a store on
    the card is never written by the plain version. Its padding of the
    update count to a power of two, which only bounded jit retraces there,
    is not ported either."""
    if not isinstance(rows, torch.Tensor):
        rows = torch.as_tensor(np.asarray(rows, np.int64))
    rows = rows.to(device=db.device, dtype=torch.int32)
    if int(rows.shape[0]) == 0:
        return db
    impl = get_backend(backend).resolve(db.device)
    fn = ref.scatter_rows_ref if impl == "ref" else scatter_rows
    return fn(db, rows, vals.to(device=db.device))


def shard_answer_fn(plan: ExecutionPlan) -> Kernel:
    """The answer function of a plan for an operand the caller holds:
    ``(operand, payload) -> [B, W]`` where ``operand`` is a packed store
    (or a shard of one: the folds are XOR-linear, so shards' partial
    answers XOR to the whole store's) — or its bitplanes for the parity
    path. The kernel choice stays behind the ``repro_torch.kernels``
    fence: a serve layer never imports a kernel module."""
    if plan.path == "direct":
        raise ValueError("the direct family's gather has no answer kernel")
    return _path_answer_fn(plan.path, plan.impl, plan.m_budget,
                           dict(plan.blocks))
