"""Gather-XOR — the Sparse-PIR server hot path — and the index compaction
in front of it.

Sparse-PIR's point (paper §4.3, Table 1) is that each server touches only
θ·n records: C_p = θ·d·n·(c_acc + c_prc). A dense fold cannot exploit
that, so this form reads *only the selected records*:

    out[q, :] = XOR_{j : idx[q, j] >= 0} db[idx[q, j], :]

``idx`` is [q, m] int32, padded with -1; m is the static index budget
(:func:`repro_torch.kernels.ops.sparse_index_budget`). Every occurrence is
folded: an id listed twice in one row cancels.
:func:`gather_xor` launches the CUDA kernel ``csrc/gather_xor.cu`` for
tensors on the card (it replaces the reference package's TPU kernel
``kernels/gather_xor.py::_kernel``; bound by the bytes of the distinct rows
it touches) and takes :func:`gather_xor_plain` only for tensors on the
CPU. The kernel reads each selected row once per word tile for a whole
group of queries when each index row is ascending (as
:func:`indices_from_mask` emits it, so on every serving path); any other
index row is walked per query in the same launch, exact and slower, and
so is a batch of one query, which shares no row.

:func:`indices_from_mask` turns the [q, n] request masks into those index
rows; on the card it launches ``csrc/indices_from_mask.cu`` (a stream
compaction: the reference computes it with a stable argsort and has no
TPU kernel for it) and on the CPU :func:`indices_from_mask_plain`.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch

from repro_torch.db.packing import WORD_DTYPE
from repro_torch.kernels import _build
from repro_torch.kernels._common import (
    check_launch, kernel_device, require, stream_ptr, xor_reduce,
)

__all__ = [
    "gather_xor",
    "gather_xor_plain",
    "gather_schedule",
    "indices_from_mask",
    "indices_from_mask_plain",
]

DEFAULT_BLOCK_W = 128
_PLAIN_CHUNK_IDX = 8192
# rows of one range (6 bytes a row of shared memory)
_MIN_RANGE_ROWS, _MAX_RANGE_ROWS = 256, 8192
_MAX_GRID_Y = 65535
# columns of one indices_from_mask block (csrc/indices_from_mask.cu TILE)
_MASK_TILE = 8192


def gather_xor_plain(db: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: index the rows, zero the padding, XOR-reduce
    (in chunks of indices so the [q, m, W] gather stays small)."""
    q, m = idx.shape
    out = db.new_zeros((q, db.shape[1]))
    for lo in range(0, m, _PLAIN_CHUNK_IDX):
        part = idx[:, lo : lo + _PLAIN_CHUNK_IDX]
        rows = db[part.clamp(min=0).long()]  # [q, chunk, W]
        rows = torch.where((part >= 0).unsqueeze(-1), rows, 0)
        out ^= xor_reduce(rows, 1)
    return out


def _check_gather_args(db: torch.Tensor, idx: torch.Tensor) -> None:
    if db.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"need db [n, W] and idx [q, m], got "
                         f"{tuple(db.shape)} and {tuple(idx.shape)}")


def gather_schedule(n: int, w: int, q: int, m: int, block_w: int,
                    sms: int) -> Dict[str, int]:
    """The kernel's grid for one launch on a card of ``sms`` SMs.

    ``rows``: the rows of one range, cut so that ranges x word tiles x
    query groups is about 8 blocks an SM (a multiple of 256, at most 8192:
    a range's query sets and its list of live rows take 6 bytes of shared
    memory a row), and so that the ranges and the walk chunks fit the
    grid's y axis. ``walk_chunks`` of ``walk_per`` ids: the blocks that
    walk any index row that is not ascending, about 4 an SM, at least 32
    ids each. A single query shares no row with another, so it is walked
    whatever its order: ``ranges`` 0 and about 16 walk blocks an SM."""
    tiles = -(-w // max(1, min(block_w, w)))
    groups = -(-q // (8 if q <= 8 else 16 if q <= 16 else 32))  # the kernel's
    walk_blocks = (16 if q == 1 else 4) * sms
    walk_chunks = max(1, min(-(-m // 32),
                             -(-walk_blocks // (tiles * groups))))
    walk_per = -(-m // walk_chunks)
    walk_chunks = -(-m // walk_per)
    target = 8 * sms
    rows = -(-n * tiles * groups // target)
    rows = min(max(rows, _MIN_RANGE_ROWS), _MAX_RANGE_ROWS)
    rows = max(rows, -(-n // (_MAX_GRID_Y - walk_chunks)))
    rows = -(-rows // _MIN_RANGE_ROWS) * _MIN_RANGE_ROWS
    return {"rows": rows, "ranges": 0 if q == 1 else -(-n // rows),
            "walk_chunks": walk_chunks, "walk_per": walk_per}


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def gather_xor(
    db: torch.Tensor,
    idx: torch.Tensor,
    *,
    block_w: int = DEFAULT_BLOCK_W,
    grid_order: str = "qwm",
) -> torch.Tensor:
    """db: [n, W] int32 words; idx: [q, m] int32 (−1 = padding) -> [q, W].

    On the card a block owns a range of rows and a tile of ``block_w``
    words for a group of queries, and reads each row that any of them
    selects once. ``grid_order`` sets which blocks the card schedules side
    by side: ``"qwm"`` puts the row ranges on the grid's fast axis
    (neighbouring blocks stream neighbouring rows of one word tile),
    ``"wqm"`` the word tiles (neighbouring blocks read one row range's
    tiles). Every setting gives identical bits."""
    if grid_order not in ("qwm", "wqm"):
        raise ValueError(
            f"grid_order must be 'qwm' or 'wqm', got {grid_order!r}"
        )
    if block_w < 1:
        raise ValueError(f"block_w must be positive, got {block_w}")
    _check_gather_args(db, idx)
    if kernel_device(db, "gather_xor") == "cpu":
        return gather_xor_plain(db, idx)
    require(db, "db", WORD_DTYPE, 2, db.device)
    require(idx, "idx", torch.int32, 2, db.device)
    n, w = db.shape
    q, m = idx.shape
    bw = min(block_w, w)
    if max(q, -(-w // max(bw, 1))) > 65535:
        raise ValueError("gather_xor takes at most 65535 queries and word "
                         "tiles")
    out = torch.zeros((q, w), dtype=WORD_DTYPE, device=db.device)
    if q == 0 or m == 0 or n == 0 or w == 0:
        return out
    sched = gather_schedule(n, w, q, m, bw, _sm_count(db.device))
    # the flags of the index rows that are not ascending, then each row's
    # offsets of the range boundaries
    scratch = torch.zeros(q * (sched["ranges"] + 2), dtype=torch.int32,
                          device=db.device)
    lib = _build.library()
    with torch.cuda.device(db.device):
        code = lib.pir_gather_xor(
            db.data_ptr(), idx.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), n, w, q, m, bw, sched["rows"],
            sched["ranges"], sched["walk_chunks"], sched["walk_per"],
            1 if grid_order == "qwm" else 0, stream_ptr(db.device),
        )
    gather_xor.launches += 1
    check_launch(code, "gather_xor")
    return out


gather_xor.launches = 0


def indices_from_mask_plain(mask: torch.Tensor, m: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`indices_from_mask`: a prefix-sum
    compaction. Each selected column's rank in its row is its output slot;
    everything else lands in a dump slot that is cut off."""
    q, n = mask.shape
    sel = mask != 0
    rank = torch.cumsum(sel, dim=1, dtype=torch.int32)  # 1-based among ones
    keep = sel & (rank <= m)
    slot = torch.where(keep, rank - 1, m).long()
    cols = torch.arange(n, dtype=torch.int32, device=mask.device).expand(q, n)
    out = torch.full((q, m + 1), -1, dtype=torch.int32, device=mask.device)
    out.scatter_(1, slot, cols)
    return out[:, :m].contiguous()


def indices_from_mask(mask: torch.Tensor, m: int) -> torch.Tensor:
    """[q, n] {0,1} request vectors -> [q, m] selected indices, -1 padded.

    The selected column ids come out in ascending order, and a row heavier
    than ``m`` keeps its *lowest* m column ids — the same set and order a
    stable sort of the ones to the front gives. ``m`` should bound the row
    weight; Sparse-PIR sizes it with
    :func:`repro_torch.kernels.ops.sparse_index_budget`, which makes a
    truncation negligibly rare.

    On the card this launches ``csrc/indices_from_mask.cu``, which reads
    uint8 and bool masks as they lie; a mask of another dtype is first
    turned into ``(mask != 0)`` bytes on the card."""
    if mask.dim() != 2:
        raise ValueError(f"need a [q, n] mask, got {tuple(mask.shape)}")
    if m < 0:
        raise ValueError(f"m must be >= 0, got {m}")
    if kernel_device(mask, "indices_from_mask") == "cpu":
        return indices_from_mask_plain(mask, m)
    q, n = mask.shape
    if max(q, n, m) >= 2**31 or q > _MAX_GRID_Y:
        raise ValueError("indices_from_mask takes at most 65535 rows and "
                         "axes below 2^31")
    if mask.dtype not in (torch.uint8, torch.bool):
        mask = (mask != 0).to(torch.uint8)
    mask = mask.contiguous()
    out = torch.empty((q, m), dtype=torch.int32, device=mask.device)
    if q == 0 or m == 0:
        return out
    if n == 0:
        return out.fill_(-1)
    scratch = torch.empty((q, -(-n // _MASK_TILE) + 1), dtype=torch.int32,
                          device=mask.device)
    lib = _build.library()
    with torch.cuda.device(mask.device):
        code = lib.pir_indices_from_mask(
            mask.data_ptr(), out.data_ptr(), scratch.data_ptr(), q, n, m,
            stream_ptr(mask.device),
        )
    indices_from_mask.launches += 1
    check_launch(code, "indices_from_mask")
    return out


indices_from_mask.launches = 0
