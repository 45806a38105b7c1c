"""Scatter into packed rows — the delta-ingest write path.

Serving a mutable database needs one write primitive: apply a batch of
record updates ``db[rows[i]] = vals[i]`` to the packed ``[n, W]`` store on
the device and get the next version's buffer, without a round trip of the
store through the host. Reads stay on the answer kernels; this is the only
kernel that writes.

The function is **functional**: it returns a new buffer and never writes
``db`` (a snapshot pinned by an in-flight batch may still hold it; see
:mod:`repro_torch.db.live`). For a row named more than once **the last
update wins**, in index order; ``m == 0`` returns ``db`` itself. Row ids
outside ``[0, n)`` write nothing. The element type is free: int32 packed
words on the ingest path, uint8 or float32 bitplanes elsewhere; ``vals``
is cast to ``db``'s dtype.

:func:`scatter_rows` launches ``csrc/scatter_rows.cu`` for tensors on the
card (it replaces the reference package's TPU kernel
``kernels/scatter.py::_kernel``; bound by the bytes of the whole copy,
``2·n·row_bytes + 4·m``, whatever ``m`` is) and takes
:func:`scatter_rows_plain` only for tensors on the CPU. Consumers go
through :func:`repro_torch.kernels.backend.scatter_update`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (
    check_launch, kernel_device, require, stream_ptr,
)

__all__ = ["scatter_rows", "scatter_rows_plain"]


def _check_scatter_args(
    db: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor
) -> None:
    if db.dim() != 2 or rows.dim() != 1 or vals.dim() != 2:
        raise ValueError(
            f"need db [n, W], rows [m] and vals [m, W], got {tuple(db.shape)}, "
            f"{tuple(rows.shape)} and {tuple(vals.shape)}"
        )
    if vals.shape != (rows.shape[0], db.shape[1]):
        raise ValueError(
            f"vals must be [m, W] = [{rows.shape[0]}, {db.shape[1]}], got "
            f"{tuple(vals.shape)}"
        )


def scatter_rows_plain(
    db: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version. Duplicates resolve deterministically to the
    last write: each row's winner is the largest ``i`` that names it (a
    max-reduction, so its order does not matter), and only the winners are
    copied — ``index_put_``/``index_copy_`` on duplicate rows would leave
    the order to the device."""
    _check_scatter_args(db, rows, vals)
    m, n = int(rows.shape[0]), int(db.shape[0])
    if m == 0:
        return db
    r = rows.to(device=db.device, dtype=torch.int64)
    order = torch.arange(m, device=db.device)
    ok = (r >= 0) & (r < n)
    winner = torch.full((n,), -1, dtype=torch.int64, device=db.device)
    winner.scatter_reduce_(0, r[ok], order[ok], reduce="amax")
    hit = torch.nonzero(winner >= 0).squeeze(1)
    out = db.clone()
    out[hit] = vals.to(device=db.device, dtype=db.dtype)[winner[hit]]
    return out


def scatter_rows(
    db: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor
) -> torch.Tensor:
    """db: [n, W] (any element type); rows: [m] integer row ids; vals:
    [m, W] -> a new [n, W] with ``out[rows[i]] = vals[i]`` applied in
    index order (last write wins); ``db`` itself when ``m == 0``."""
    _check_scatter_args(db, rows, vals)
    on = kernel_device(db, "scatter_rows")
    if rows.shape[0] == 0:
        return db
    if on == "cpu":
        return scatter_rows_plain(db, rows, vals)
    dev = db.device
    if rows.dtype != torch.int32:
        rows = rows.to(torch.int32)
    if vals.dtype != db.dtype:
        vals = vals.to(db.dtype)
    require(db, "db", db.dtype, 2, dev)
    require(rows, "rows", torch.int32, 1, dev)
    require(vals, "vals", db.dtype, 2, dev)
    n, w = db.shape
    row_bytes = w * db.element_size()
    if row_bytes >= 2**31:
        raise ValueError("scatter_rows takes rows of fewer than 2**31 bytes")
    out = torch.empty_like(db)
    winner = torch.empty((n,), dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.pir_scatter_rows(
            db.data_ptr(), rows.data_ptr(), vals.data_ptr(), out.data_ptr(),
            winner.data_ptr(), n, int(rows.shape[0]), row_bytes,
            stream_ptr(dev),
        )
    scatter_rows.launches += 1
    check_launch(code, "scatter_rows")
    return out


scatter_rows.launches = 0
