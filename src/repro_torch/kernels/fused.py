"""Fused gather→xor→fold — Sparse-PIR's answer with the db slab on chip.

Same function as :func:`repro_torch.kernels.gather_xor.gather_xor`, but
the whole record axis of one word block (``[n, BW]`` words) is staged in a
block's shared memory, and the index walk then reads rows from there. One
output write, no re-reading of device memory per selected row.

Two shape knobs are exposed to the execution planner: ``block_w`` (the
word-block width) and ``grid_order`` — ``"qw"`` gives every (query, word
block) its own thread block (the slab is staged once per query), ``"wq"``
gives every word block one thread block that stages the slab once and
serves *every* query of the batch from it.

The price is residency: the form only applies when ``n·BW·4`` bytes fit a
block's shared memory. :func:`fused_block_w` picks the widest power-of-two
BW that fits and returns 0 when none does — the signal the planner
(:mod:`repro_torch.kernels.backend`) uses to fall back to ``gather_xor``.
The budget is the device's opt-in shared memory per block
(:func:`fused_smem_budget`). At a million records the form only applies
per record shard; single-device stores of that size take ``gather_xor``.

:func:`fused_multi_gather_fold` is the jagged multi-index form: the index
matrix holds ``k_max`` rows per request, the ``offsets`` descriptor says
how many of them are live, and one thread block per (request, word block)
— ``"rw"`` — or per word block — ``"wr"`` — folds all of a request's live
rows against one staging of the slab. Dead rows answer zero whatever
their indices hold (:func:`jagged_row_mask` is that contract). It launches
``csrc/fused_multi_gather_fold.cu`` (it replaces the reference package's
TPU kernel ``kernels/fused.py::_multi_kernel``), under the same gate.

:func:`fused_gather_fold` launches ``csrc/fused_gather_fold.cu`` for
tensors on the card (it replaces the reference package's TPU kernel
``kernels/fused.py::_kernel``; bound by the bytes of the distinct rows the
indices name, as ``gather_xor`` is) and takes
:func:`fused_gather_fold_plain` only for tensors on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.db.packing import WORD_DTYPE
from repro_torch.kernels import _build
from repro_torch.kernels._common import check_launch, require, stream_ptr
from repro_torch.kernels.gather_xor import _check_gather_args, gather_xor_plain

__all__ = [
    "fused_gather_fold",
    "fused_gather_fold_plain",
    "fused_multi_gather_fold",
    "fused_multi_gather_fold_plain",
    "jagged_row_mask",
    "fused_block_w",
    "fused_smem_budget",
    "FUSED_SMEM_FALLBACK_BYTES",
]

DEFAULT_BLOCK_W = 128

# Opt-in dynamic shared memory of one block on Hopper (227 KB). Used for
# the gate's arithmetic when no card is present to ask.
FUSED_SMEM_FALLBACK_BYTES = 232_448


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
    if db.device.type == "cpu":
        return fused_gather_fold_plain(db, idx)
    require(db, "db", WORD_DTYPE, 2, db.device)
    require(idx, "idx", torch.int32, 2, db.device)
    n, w = db.shape
    q, m = idx.shape
    bw = min(block_w, w)
    budget = fused_smem_budget(db.device)
    if n * bw * 4 > budget:
        raise ValueError(
            f"fused slab [{n}, {bw}] needs {n * bw * 4} bytes of shared "
            f"memory, the device offers {budget}; use gather_xor"
        )
    if q > 65535:
        raise ValueError(f"fused_gather_fold takes at most 65535 queries")
    out = torch.zeros((q, w), dtype=WORD_DTYPE, device=db.device)
    if q == 0 or m == 0 or n == 0 or w == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(db.device):
        code = lib.pir_fused_gather_fold(
            db.data_ptr(), idx.data_ptr(), out.data_ptr(), n, w, q, m, bw,
            1 if grid_order == "wq" else 0, stream_ptr(db.device),
        )
    fused_gather_fold.launches += 1
    check_launch(code, "fused_gather_fold")
    return out


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
    if db.device.type == "cpu":
        return fused_multi_gather_fold_plain(db, idx, offsets, k_max)
    dev = db.device
    require(db, "db", WORD_DTYPE, 2, dev)
    require(idx, "idx", torch.int32, 2, dev)
    require(offsets, "offsets", torch.int32, 1, dev)
    n, w = db.shape
    m = int(idx.shape[1])
    bw = min(block_w, w)
    budget = fused_smem_budget(dev)
    if n * bw * 4 > budget:
        raise ValueError(
            f"fused slab [{n}, {bw}] needs {n * bw * 4} bytes of shared "
            f"memory, the device offers {budget}; use gather_xor"
        )
    if requests > 65535:
        raise ValueError("fused_multi_gather_fold takes at most 65535 requests")
    out = torch.zeros((requests * k_max, w), dtype=WORD_DTYPE, device=dev)
    if requests == 0 or m == 0 or n == 0 or w == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.pir_fused_multi_gather_fold(
            db.data_ptr(), idx.data_ptr(), offsets.data_ptr(), out.data_ptr(),
            n, w, requests, k_max, m, bw, 1 if grid_order == "wr" else 0,
            stream_ptr(dev),
        )
    fused_multi_gather_fold.launches += 1
    check_launch(code, "fused_multi_gather_fold")
    return out


fused_multi_gather_fold.launches = 0
