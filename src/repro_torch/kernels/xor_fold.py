"""Masked XOR fold over bit-packed records.

The Chor/Sparse-PIR server answer for a batch of queries:

    out[q, :] = XOR_{i : mask[q, i] != 0} db[i, :]

``db`` is [n, W] packed words, ``mask`` [q, n]. :func:`xor_fold` launches
the CUDA kernel ``csrc/xor_fold.cu`` for tensors on the card (it replaces
the reference package's TPU kernel ``kernels/xor_fold.py::_kernel``; bound
by bytes: the whole store streams once per tile of eight queries) and
takes :func:`xor_fold_plain` only for tensors on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.db.packing import WORD_DTYPE
from repro_torch.kernels import _build
from repro_torch.kernels._common import (
    check_launch, require, stream_ptr, xor_reduce,
)

__all__ = ["xor_fold", "xor_fold_plain"]

_PLAIN_CHUNK_ROWS = 4096


def xor_fold_plain(db: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: select, then XOR-reduce over the records, in
    chunks of rows so the [q, rows, W] selection stays small."""
    q, n = mask.shape
    out = db.new_zeros((q, db.shape[1]))
    for lo in range(0, n, _PLAIN_CHUNK_ROWS):
        rows = db[lo : lo + _PLAIN_CHUNK_ROWS]
        sel = mask[:, lo : lo + _PLAIN_CHUNK_ROWS] != 0
        picked = torch.where(sel.unsqueeze(-1), rows.unsqueeze(0), 0)
        out ^= xor_reduce(picked, 1)
    return out


def xor_fold(db: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """db: [n, W] int32 words; mask: [q, n] any integer/bool dtype
    (non-zero selects) -> [q, W] int32 words."""
    if db.dim() != 2 or mask.dim() != 2 or mask.shape[1] != db.shape[0]:
        raise ValueError(f"shapes disagree: db {tuple(db.shape)}, "
                         f"mask {tuple(mask.shape)}")
    if db.device.type == "cpu":
        return xor_fold_plain(db, mask)
    if mask.dtype != torch.uint8:
        mask = (mask != 0).to(torch.uint8)
    mask = mask.contiguous()
    require(db, "db", WORD_DTYPE, 2, db.device)
    require(mask, "mask", torch.uint8, 2, db.device)
    n, w = db.shape
    q = mask.shape[0]
    if q > 65535 * 8:
        raise ValueError(f"xor_fold takes at most {65535 * 8} queries, got {q}")
    out = torch.zeros((q, w), dtype=WORD_DTYPE, device=db.device)
    if q == 0 or n == 0 or w == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(db.device):
        code = lib.pir_xor_fold(
            db.data_ptr(), mask.data_ptr(), out.data_ptr(), n, w, q,
            stream_ptr(db.device),
        )
    xor_fold.launches += 1
    check_launch(code, "xor_fold")
    return out


xor_fold.launches = 0
