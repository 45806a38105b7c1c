"""Gather-XOR — the Sparse-PIR server hot path.

Sparse-PIR's point (paper §4.3, Table 1) is that each server touches only
θ·n records: C_p = θ·d·n·(c_acc + c_prc). A dense fold cannot exploit
that, so this form reads *only the selected records*:

    out[q, :] = XOR_{j : idx[q, j] >= 0} db[idx[q, j], :]

``idx`` is [q, m] int32, padded with -1; m is the static index budget
(:func:`repro_torch.kernels.ops.sparse_index_budget`).
:func:`gather_xor` launches the CUDA kernel ``csrc/gather_xor.cu`` for
tensors on the card (it replaces the reference package's TPU kernel
``kernels/gather_xor.py::_kernel``; bound by the bytes of the rows it
touches) and takes :func:`gather_xor_plain` only for tensors on the CPU.
``grid_order`` and ``block_w`` are schedule knobs: every setting gives
identical bits.
"""

from __future__ import annotations

import torch

from repro_torch.db.packing import WORD_DTYPE
from repro_torch.kernels import _build
from repro_torch.kernels._common import (
    check_launch, require, stream_ptr, xor_reduce,
)

__all__ = ["gather_xor", "gather_xor_plain", "indices_from_mask"]

DEFAULT_BLOCK_W = 128
_PLAIN_CHUNK_IDX = 8192


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


def gather_xor(
    db: torch.Tensor,
    idx: torch.Tensor,
    *,
    block_w: int = DEFAULT_BLOCK_W,
    grid_order: str = "qwm",
) -> torch.Tensor:
    """db: [n, W] int32 words; idx: [q, m] int32 (−1 = padding) -> [q, W]."""
    if grid_order not in ("qwm", "wqm"):
        raise ValueError(
            f"grid_order must be 'qwm' or 'wqm', got {grid_order!r}"
        )
    if block_w < 1:
        raise ValueError(f"block_w must be positive, got {block_w}")
    _check_gather_args(db, idx)
    if db.device.type == "cpu":
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
    lib = _build.library()
    with torch.cuda.device(db.device):
        code = lib.pir_gather_xor(
            db.data_ptr(), idx.data_ptr(), out.data_ptr(), n, w, q, m, bw,
            1 if grid_order == "qwm" else 0, stream_ptr(db.device),
        )
    gather_xor.launches += 1
    check_launch(code, "gather_xor")
    return out


gather_xor.launches = 0


def indices_from_mask(mask: torch.Tensor, m: int) -> torch.Tensor:
    """[q, n] {0,1} request vectors -> [q, m] selected indices, -1 padded.

    The selected column ids come out in ascending order, and a row heavier
    than ``m`` keeps its *lowest* m column ids — the same set and order a
    stable sort of the ones to the front gives. ``m`` should bound the row
    weight; Sparse-PIR sizes it with
    :func:`repro_torch.kernels.ops.sparse_index_budget`, which makes a
    truncation negligibly rare.

    A prefix-sum compaction: each selected column's rank in its row is its
    output slot; everything else lands in a dump slot that is cut off.
    """
    q, n = mask.shape
    sel = mask != 0
    rank = torch.cumsum(sel, dim=1, dtype=torch.int32)  # 1-based among ones
    keep = sel & (rank <= m)
    slot = torch.where(keep, rank - 1, m).long()
    cols = torch.arange(n, dtype=torch.int32, device=mask.device).expand(q, n)
    out = torch.full((q, m + 1), -1, dtype=torch.int32, device=mask.device)
    out.scatter_(1, slot, cols)
    return out[:, :m].contiguous()
