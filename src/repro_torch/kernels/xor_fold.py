"""Masked XOR fold over bit-packed records.

The Chor/Sparse-PIR server answer for a batch of queries:

    out[q, :] = XOR_{i : mask[q, i] != 0} db[i, :]

``db`` is [n, W] packed words, ``mask`` [q, n]. :func:`xor_fold` launches
one of two forms of the CUDA kernel ``csrc/xor_fold.cu`` for tensors on the
card (it replaces the reference package's TPU kernel
``kernels/xor_fold.py::_kernel``), chosen by the number of queries
(:func:`_form_for`):

- ``stream`` (few queries): the store streams past eight queries at a
  time, one AND+XOR per (row, query, word); bound by bytes at q 8;
- ``table`` (many queries): the mask is packed to bits once, then a block
  reads each store tile once for up to 256 queries and folds it by table
  lookup (the Method of Four Russians: the 16 XOR combinations of every
  4 rows are built once in shared memory, and each query XORs one entry
  per 4 rows); bound by shared-memory traffic. Its warps take 8 or 32
  queries each (:func:`_table_width`).

Both give the same bits. It takes :func:`xor_fold_plain` only for tensors
on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.db.packing import WORD_DTYPE
from repro_torch.kernels import _build
from repro_torch.kernels._common import (
    check_launch, kernel_device, require, stream_ptr, xor_reduce,
)

__all__ = ["xor_fold", "xor_fold_plain"]

_PLAIN_CHUNK_ROWS = 4096

STREAM, TABLE = "stream", "table"
FORMS = (STREAM, TABLE)
# From this many queries on, the table form is faster. Measured on an
# NVIDIA H100 80GB HBM3 (700.00 W) over the CT store (10^6 x 384 words,
# density-0.5 masks) by chip_smoke.py's switch sweep, ms stream / table:
# q 8 0.561 / 0.881, q 9 1.081 / 0.744, q 16 1.116 / 0.765, q 128 8.305
# / 2.092. The streaming form reads the store once per 8 queries, so it
# loses from the 9th on.
TABLE_MIN_QUERIES = 9
# The table form's queries a warp (8 warps a block at most): 8 below this
# many queries, 32 from it on. The same sweep, ms width 8 / 32: q 9 0.744
# / 1.163, q 32 0.885 / 1.176, q 64 1.281 / 1.305, q 96 2.567 / 2.081,
# q 256 5.078 / 3.824. Narrow warps put more warps on an SM at few
# queries; from 65 queries width 8 needs a second query group, which
# reads the store again.
TABLE_WIDTHS = (8, 32)
TABLE_WIDE_MIN_QUERIES = 65
# What the forms' grids admit: a grid's y and z axes take at most 65535
# blocks. The streaming form's z axis holds 8 queries a block, the table
# form's 8 warps of its width (256 at the width the wrapper takes there);
# both forms' y axis holds 32 words a block or more.
MAX_QUERIES = {STREAM: 65535 * 8, TABLE: 65535 * 256}
MAX_WORDS = 65535 * 32


def _form_for(q: int) -> str:
    """Which form answers ``q`` queries: a choice by shape, not a fallback
    (either form raises when it fails)."""
    return TABLE if q >= TABLE_MIN_QUERIES else STREAM


def _table_width(q: int) -> int:
    """Queries a warp of the table form takes at ``q`` queries."""
    return 32 if q >= TABLE_WIDE_MIN_QUERIES else 8


def _check_limits(form: str, q: int, w: int, width: int | None = None
                  ) -> None:
    if form not in FORMS:
        raise ValueError(f"unknown xor_fold form {form!r}; one of {FORMS}")
    limit = MAX_QUERIES[form]
    if width is not None:
        if form != TABLE or width not in TABLE_WIDTHS:
            raise ValueError(f"xor_fold's table form takes {TABLE_WIDTHS} "
                             f"queries a warp; got {width} for the {form} "
                             f"form")
        limit = 65535 * 8 * width
    if q > limit:
        raise ValueError(f"xor_fold's {form} form takes at most {limit} "
                         f"queries, got {q}")
    if w > MAX_WORDS:
        raise ValueError(f"xor_fold takes at most {MAX_WORDS} words a "
                         f"record, got {w}")


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


def _launch(db: torch.Tensor, mask: torch.Tensor, form: str,
            width: int | None = None) -> torch.Tensor:
    """Launch ``form`` of the kernel on tensors on the card (the tests force
    each form, and the table form's ``width``, through this at any shape;
    by default the table form takes :func:`_table_width`)."""
    _check_limits(form, mask.shape[0], db.shape[1], width)
    if db.device.type != "cuda":
        raise ValueError(f"xor_fold's kernels take tensors on the card, "
                         f"got {db.device}")
    if mask.dtype == torch.bool:
        mask = mask.view(torch.uint8)
    elif mask.dtype != torch.uint8:
        mask = (mask != 0).to(torch.uint8)
    mask = mask.contiguous()
    require(db, "db", WORD_DTYPE, 2, db.device)
    require(mask, "mask", torch.uint8, 2, db.device)
    n, w = db.shape
    q = mask.shape[0]
    out = torch.zeros((q, w), dtype=WORD_DTYPE, device=db.device)
    if q == 0 or n == 0 or w == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(db.device):
        if form == STREAM:
            code = lib.pir_xor_fold(
                db.data_ptr(), mask.data_ptr(), out.data_ptr(), n, w, q,
                stream_ptr(db.device),
            )
        else:
            # the mask as bits, 32 rows a word: [ceil(n / 32), q]
            bits = torch.empty((-(-n // 32), q), dtype=torch.int32,
                               device=db.device)
            code = lib.pir_xor_fold_table(
                db.data_ptr(), mask.data_ptr(), bits.data_ptr(),
                out.data_ptr(), n, w, q, width or _table_width(q),
                stream_ptr(db.device),
            )
    xor_fold.launches += 1
    xor_fold.kernel_launches[form] += 1
    check_launch(code, f"xor_fold ({form} form)")
    return out


def xor_fold(db: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """db: [n, W] int32 words; mask: [q, n] any integer/bool dtype
    (non-zero selects) -> [q, W] int32 words. ``launches`` counts every
    launch, ``kernel_launches`` each form's."""
    if db.dim() != 2 or mask.dim() != 2 or mask.shape[1] != db.shape[0]:
        raise ValueError(f"shapes disagree: db {tuple(db.shape)}, "
                         f"mask {tuple(mask.shape)}")
    form = _form_for(mask.shape[0])
    if kernel_device(db, "xor_fold") == "cuda":
        return _launch(db, mask, form)
    _check_limits(form, mask.shape[0], db.shape[1])
    return xor_fold_plain(db, mask)


xor_fold.launches = 0
xor_fold.kernel_launches = {STREAM: 0, TABLE: 0}
