"""Fused gather→xor→fold — Sparse-PIR's answer with the db slab on chip.

Same function as :func:`repro_torch.kernels.gather_xor.gather_xor`, but
the whole record axis of one word tile (``[n, BW]`` words) is staged in
shared memory, and the index walk then reads rows from there. Each output
word is written once, by the CTA that owns its row: the output needs no
zeroing.

On the card a launch is a grid of thread-block clusters
(:func:`fused_schedule` computes it; ``csrc/fused_slab.cuh`` runs it).
Every CTA holds the whole slab of its word tile; a cluster of C ≤ 8 CTAs
owns one word tile for a group of index rows, and its CTAs take the rows
between them. The slab comes in by one of two paths:

* ``"tma"``: the cluster's CTAs issue the slab's TMA boxes between them,
  each multicast to every CTA, so the tile leaves L2 once per cluster.
  Taken where C > 1, the store is 16-byte aligned, W % 4 == 0, a tile row
  is 16 to 256 words, and 8 bytes beside the slab hold the mbarrier.
* ``"copy"``: C = 1, the CTA copies the slab with ``cp.async``, with no
  mbarrier: the path for 8-word tiles (the TMA unit stages such short
  rows slower than ``cp.async`` on the H100), for a slab that fills the
  opt-in limit to the byte (n 7264 × 8 words = 232 448 B), for W % 4 != 0
  and for an unaligned store.

A CTA's 16 warps walk its rows side by side, one to 16 warps a row; a
lane folds the row its own id names (16-byte loads, 32 ids a coalesced
load, four more in flight).

Two shape knobs are exposed to the execution planner: ``block_w`` (the
word-tile width) and ``grid_order``. ``"qw"`` spreads the queries: one a
CTA in a multicast cluster of up to 8 (its 16 warps sharing the query's
ids), 16 a copying CTA (a warp each). ``"wq"`` packs them: 16 a CTA in a
multicast cluster, 32 a copying CTA, as the reference's "wq" serves many
queries from one resident block. Both give identical bits. Past 32 rows a
CTA, more clusters share a tile, each staging it.

The price is residency: the form only applies when ``n·BW·4`` bytes fit a
block's shared memory. :func:`fused_block_w` picks the widest power-of-two
BW that fits and returns 0 when none does — the signal the planner
(:mod:`repro_torch.kernels.backend`) uses to fall back to ``gather_xor``.
The budget is the device's opt-in shared memory per block
(:func:`fused_smem_budget`). At a million records the form only applies
per record shard; single-device stores of that size take ``gather_xor``.

:func:`fused_multi_gather_fold` is the jagged multi-index form: the index
matrix holds ``k_max`` rows per request, the ``offsets`` descriptor says
how many of them are live; a CTA owns whole requests (``"rw"`` spreads
them as ``"qw"`` spreads queries, ``"wr"`` packs them as ``"wq"`` does)
and folds their live rows side by side. Dead rows are written zero whatever their
indices hold, which are never read (:func:`jagged_row_mask` is that
contract). It launches ``csrc/fused_multi_gather_fold.cu`` (it replaces
the reference package's TPU kernel ``kernels/fused.py::_multi_kernel``),
under the same gate.

:func:`fused_gather_fold` launches ``csrc/fused_gather_fold.cu`` for
tensors on the card (it replaces the reference package's TPU kernel
``kernels/fused.py::_kernel``; bound by the bytes of the distinct rows the
indices name, as ``gather_xor`` is) and takes
:func:`fused_gather_fold_plain` only for tensors on the CPU.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from repro_torch.db.packing import WORD_DTYPE
from repro_torch.kernels import _build
from repro_torch.kernels._common import (
    check_launch, kernel_device, require, stream_ptr,
)
from repro_torch.kernels.gather_xor import _check_gather_args, gather_xor_plain

__all__ = [
    "fused_gather_fold",
    "fused_gather_fold_plain",
    "fused_multi_gather_fold",
    "fused_multi_gather_fold_plain",
    "jagged_row_mask",
    "fused_block_w",
    "fused_smem_budget",
    "fused_schedule",
    "FUSED_SMEM_FALLBACK_BYTES",
]

DEFAULT_BLOCK_W = 128

# Opt-in dynamic shared memory of one block on Hopper (227 KB). Used for
# the gate's arithmetic when no card is present to ask.
FUSED_SMEM_FALLBACK_BYTES = 232_448

# the launch's arithmetic (csrc/fused_slab.cuh): 16 warps a CTA, clusters
# of at most 8 CTAs (the portable size) that share a TMA multicast of the
# slab, at most 32 index rows a CTA before a tile takes a second cluster;
# TMA only for tile rows of 16 words or more (on an H100 it stages 8-word
# rows slower than cp.async); warps share a row only in one pass of at most
# 32 lanes x 16 words (their scratch lies over the slab)
WARPS = 16
CLUSTER_MAX = 8
ROWS_PER_CTA_MAX = 32
TMA_MIN_WORDS = 16
_ONE_PASS_WORDS = 512
STAGINGS = ("tma", "copy")
_MAX_GRID = 65535


def fused_smem_budget(device: Optional[torch.device] = None) -> int:
    """Shared-memory budget for the fused db slab: the opt-in maximum per
    block of ``device`` when that is a CUDA device, the Hopper figure for
    the CPU or no device (so the gate's arithmetic is the same wherever
    it is evaluated). The planner threads a
    ``PIRConfig.fused_vmem_budget_bytes`` override past this entirely."""
    if device is None or device.type != "cuda":
        return FUSED_SMEM_FALLBACK_BYTES
    props = torch.cuda.get_device_properties(device)
    return int(props.shared_memory_per_block_optin)


def fused_block_w(n: int, w: int, *, block_w: int = DEFAULT_BLOCK_W,
                  budget_bytes: Optional[int] = None,
                  device: Optional[torch.device] = None) -> int:
    """Widest power-of-two word block ≤ min(block_w, W) whose [n, BW]
    32-bit db slab fits the shared-memory budget; 0 when nothing
    ≥ min(8, W) words fits (the caller must fall back to ``gather_xor`` —
    a sliver block would leave most lanes idle even if it fit).
    ``budget_bytes=None`` derives the budget from ``device``
    (:func:`fused_smem_budget`)."""
    if budget_bytes is None:
        budget_bytes = fused_smem_budget(device)
    cap = max(1, min(block_w, w))
    bw = 1 << (cap.bit_length() - 1)  # round down to a power of two
    floor = min(8, bw)
    while bw > floor and n * bw * 4 > budget_bytes:
        bw //= 2
    return bw if n * bw * 4 <= budget_bytes else 0


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


@functools.lru_cache(maxsize=256)
def fused_schedule(n: int, w: int, rows: int, block_w: int, *,
                   grid_order: str = "qw", k_max: int = 1,
                   aligned: bool = True,
                   budget: int = FUSED_SMEM_FALLBACK_BYTES,
                   staging: Optional[str] = None) -> Dict[str, object]:
    """The cluster launch of one fused call: ``rows`` index rows (q, or
    requests × ``k_max`` for the multi kernel, whose CTAs own whole
    requests) against an ``[n, w]`` store in word tiles of
    ``min(block_w, w)``. Every CTA holds the whole ``[n, BW]`` slab.

    ``staging``: ``"tma"`` where a cluster of C > 1 CTAs can share one
    multicast of the slab: the store 16-byte aligned (``aligned``), W and
    BW multiples of 4, BW from 16 to 256 words, and the slab and an 8-byte
    mbarrier within ``budget``; else ``"copy"`` (C = 1, the CTA copies the
    slab itself, no mbarrier). A forced ``staging`` that cannot run
    raises. ``cluster``: ``"qw"`` / ``"rw"`` spread the requests, one a
    CTA under TMA (up to 8 CTAs a cluster), 16 index rows a copying CTA;
    ``"wq"`` / ``"wr"`` pack 16 index rows into a CTA under TMA and 32
    into a copying one. ``groups``: clusters a word tile, each staging it,
    once a CTA would own more; ``grid`` = (C, tiles, groups), x spanning a
    cluster. ``rows_per_cta`` and ``warps_per_row`` (1 to 16 warps walk
    one row; when more than one, the CTA's rows take one round of its
    warps and a tile one pass, and the warps combine through a scratch
    over the walked slab). ``smem_bytes``: one CTA's dynamic shared
    memory. Cached: the dict is shared by every call with the same
    arguments, so read it only."""
    if grid_order not in ("qw", "wq", "rw", "wr"):
        raise ValueError(f"unknown grid_order {grid_order!r}")
    if min(n, w, rows, block_w, k_max) < 1 or rows % k_max:
        raise ValueError("fused_schedule needs positive n, w, block_w, and "
                         "rows a positive multiple of k_max")
    if staging not in (None,) + STAGINGS:
        raise ValueError(f"unknown staging {staging!r}")
    bw = min(block_w, w)
    tiles = -(-w // bw)
    units = rows // k_max
    spread = grid_order in ("qw", "rw")
    can_tma = (aligned and w % 4 == 0 and bw % 4 == 0
               and TMA_MIN_WORDS <= bw <= 256)

    def plan(tma):
        want = (1 if spread else WARPS) if tma else (
            WARPS if spread else ROWS_PER_CTA_MAX)
        target = max(1, want // k_max)  # units a CTA
        cap = max(1, ROWS_PER_CTA_MAX // k_max) if tma else target
        cluster = min(CLUSTER_MAX, -(-units // target)) if tma else 1
        groups = -(-units // (cluster * cap))
        per_cta = -(-units // (cluster * groups))
        cluster = -(-units // (groups * per_cta))  # no CTA without a row
        # warps a row: when more than one, a CTA's rows take one round of
        # its warps, and their scratch lies over the walked slab
        wpq = WARPS // min(WARPS, _pow2_at_least(per_cta * k_max))
        if bw > _ONE_PASS_WORDS:
            wpq = 1
        slab_rows = max(n, WARPS) if wpq > 1 else n
        return {"cluster": cluster, "grid": (cluster, tiles, groups),
                "groups": groups, "rows_per_cta": per_cta * k_max,
                "warps_per_row": wpq, "staging": "tma" if tma else "copy",
                "block_w": bw,
                "smem_bytes": slab_rows * bw * 4 + (8 if tma else 0)}

    if staging == "tma" and not can_tma:
        raise ValueError(f"TMA staging cannot take W {w}, BW {bw}"
                         f"{'' if aligned else ' on an unaligned store'}")
    sched = plan(staging == "tma" or (staging is None and can_tma))
    if staging is None and sched["staging"] == "tma" and (
            sched["cluster"] == 1 or sched["smem_bytes"] > budget):
        sched = plan(False)  # nothing to share, or no room for the barrier
    if sched["smem_bytes"] > budget:
        raise ValueError(f"fused slab [{n}, {bw}] and its barrier need "
                         f"{sched['smem_bytes']} bytes of shared memory, "
                         f"the device offers {budget}; use gather_xor")
    if max(tiles, sched["groups"]) > _MAX_GRID:
        raise ValueError("fused kernels take at most 65535 word tiles and "
                         "row groups")
    return sched


@functools.lru_cache(maxsize=None)
def _smem_budget(device: torch.device) -> int:
    return fused_smem_budget(device)


def _check_slab(db: torch.Tensor, block_w: int) -> int:
    """The device's budget, after raising if the slab does not fit it."""
    n, w = db.shape
    budget = _smem_budget(db.device)
    bw = min(block_w, w)
    if n * bw * 4 > budget:
        raise ValueError(
            f"fused slab [{n}, {bw}] needs {n * bw * 4} bytes of shared "
            f"memory, the device offers {budget}; use gather_xor"
        )
    return budget


def _launch(db: torch.Tensor, idx: torch.Tensor,
            offsets: Optional[torch.Tensor], k_max: int,
            sched: Dict[str, object]) -> torch.Tensor:
    """One launch of the flat (``offsets`` None) or the multi kernel on
    ``sched`` (:func:`fused_schedule`'s; tests and ``chip_smoke.py`` pass
    a forced staging path here) into a new ``torch.empty`` output. Counts
    the launch on its wrapper."""
    n, w = db.shape
    rows, m = idx.shape
    out = torch.empty((rows, w), dtype=WORD_DTYPE, device=db.device)
    args = (n, w, rows // k_max if offsets is not None else rows)
    args += (k_max,) if offsets is not None else ()
    args += (m, sched["block_w"], sched["cluster"], sched["groups"],
             sched["rows_per_cta"], sched["warps_per_row"],
             STAGINGS.index(sched["staging"]), stream_ptr(db.device))
    lib = _build.library()
    with torch.cuda.device(db.device):
        if offsets is None:
            code = lib.pir_fused_gather_fold(
                db.data_ptr(), idx.data_ptr(), out.data_ptr(), *args)
            fused_gather_fold.launches += 1
            check_launch(code, "fused_gather_fold")
        else:
            code = lib.pir_fused_multi_gather_fold(
                db.data_ptr(), idx.data_ptr(), offsets.data_ptr(),
                out.data_ptr(), *args)
            fused_multi_gather_fold.launches += 1
            check_launch(code, "fused_multi_gather_fold")
    return out


def fused_gather_fold_plain(db: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (the function is ``gather_xor``'s)."""
    return gather_xor_plain(db, idx)


def fused_gather_fold(
    db: torch.Tensor,
    idx: torch.Tensor,
    *,
    block_w: int = DEFAULT_BLOCK_W,
    grid_order: str = "qw",
) -> torch.Tensor:
    """db: [n, W] int32 words; idx: [q, m] int32 (−1 = padding) -> [q, W].

    Semantics identical to ``gather_xor(db, idx)`` for every
    ``grid_order`` and ``block_w``. On the card the slab
    ``n·min(block_w, W)·4`` bytes must fit :func:`fused_smem_budget`
    (size ``block_w`` with :func:`fused_block_w`); a slab that does not
    fit raises.
    """
    if grid_order not in ("qw", "wq"):
        raise ValueError(f"grid_order must be 'qw' or 'wq', got {grid_order!r}")
    if block_w < 1:
        raise ValueError(f"block_w must be positive, got {block_w}")
    _check_gather_args(db, idx)
    if kernel_device(db, "fused_gather_fold") == "cpu":
        return fused_gather_fold_plain(db, idx)
    require(db, "db", WORD_DTYPE, 2, db.device)
    require(idx, "idx", torch.int32, 2, db.device)
    n, w = db.shape
    q, m = idx.shape
    budget = _check_slab(db, block_w)
    if q > 65535:
        raise ValueError(f"fused_gather_fold takes at most 65535 queries")
    if q == 0 or m == 0 or n == 0 or w == 0:
        return torch.zeros((q, w), dtype=WORD_DTYPE, device=db.device)
    return _launch(db, idx, None, 1, fused_schedule(
        n, w, q, block_w, grid_order=grid_order,
        aligned=db.data_ptr() % 16 == 0, budget=budget))


fused_gather_fold.launches = 0


# --------------------------------------------------------------------------
# Jagged multi-index fusion
# --------------------------------------------------------------------------
def jagged_row_mask(offsets, k_max: int, rows: int) -> torch.Tensor:
    """[rows] bool: which flat rows of the padded multi-index layout are
    live. Row ``r·k_max + i`` is live iff ``i < offsets[r+1] − offsets[r]``
    — the mask the plain version and the streaming-pair fallback apply to
    the index matrix, so every multi path answers zero on a dead row."""
    off = torch.as_tensor(offsets, dtype=torch.int32)
    r = torch.arange(rows, device=off.device) // k_max
    i = torch.arange(rows, device=off.device) % k_max
    return i < off[r + 1] - off[r]


def _check_multi_args(
    db: torch.Tensor, idx: torch.Tensor, offsets: torch.Tensor, k_max: int,
    grid_order: str,
) -> int:
    if grid_order not in ("rw", "wr"):
        raise ValueError(f"grid_order must be 'rw' or 'wr', got {grid_order!r}")
    _check_gather_args(db, idx)
    b = int(idx.shape[0])
    if k_max < 1 or b % k_max:
        raise ValueError(f"idx rows {b} not a multiple of k_max={k_max}")
    requests = b // k_max
    if offsets.dim() != 1 or offsets.shape[0] != requests + 1:
        raise ValueError(
            f"offsets must be [R+1]={requests + 1}, got {tuple(offsets.shape)}"
        )
    return requests


def fused_multi_gather_fold_plain(
    db: torch.Tensor, idx: torch.Tensor, offsets: torch.Tensor, k_max: int
) -> torch.Tensor:
    """Plain PyTorch version: the gather of the jagged-masked index
    matrix (dead rows forced to all padding)."""
    live = jagged_row_mask(offsets.to(idx.device), k_max, int(idx.shape[0]))
    return gather_xor_plain(db, torch.where(live[:, None], idx, -1))


def fused_multi_gather_fold(
    db: torch.Tensor,
    idx: torch.Tensor,
    offsets,
    *,
    k_max: int,
    block_w: int = DEFAULT_BLOCK_W,
    grid_order: str = "rw",
) -> torch.Tensor:
    """db: [n, W] int32 words; idx: [R·k_max, m] int32 (−1 = padding);
    offsets: [R+1] int32 jagged descriptor -> [R·k_max, W].

    Row ``r·k_max + i`` is ``gather_xor(db, idx[r·k_max + i])`` when
    ``i < offsets[r+1] − offsets[r]`` and zero otherwise, for every
    ``grid_order`` and ``block_w``. On the card the slab
    ``n·min(block_w, W)·4`` bytes must fit :func:`fused_smem_budget`; a
    slab that does not fit raises.
    """
    if block_w < 1:
        raise ValueError(f"block_w must be positive, got {block_w}")
    if not isinstance(offsets, torch.Tensor):
        offsets = torch.as_tensor(offsets, dtype=torch.int32, device=db.device)
    requests = _check_multi_args(db, idx, offsets, k_max, grid_order)
    if kernel_device(db, "fused_multi_gather_fold") == "cpu":
        return fused_multi_gather_fold_plain(db, idx, offsets, k_max)
    dev = db.device
    require(db, "db", WORD_DTYPE, 2, dev)
    require(idx, "idx", torch.int32, 2, dev)
    require(offsets, "offsets", torch.int32, 1, dev)
    n, w = db.shape
    m = int(idx.shape[1])
    budget = _check_slab(db, block_w)
    if requests > 65535:
        raise ValueError("fused_multi_gather_fold takes at most 65535 requests")
    if requests == 0 or m == 0 or n == 0 or w == 0:
        return torch.zeros((requests * k_max, w), dtype=WORD_DTYPE, device=dev)
    return _launch(db, idx, offsets, k_max, fused_schedule(
        n, w, requests * k_max, block_w, grid_order=grid_order, k_max=k_max,
        aligned=db.data_ptr() % 16 == 0, budget=budget))


fused_multi_gather_fold.launches = 0
