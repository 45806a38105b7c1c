"""The Sparse-PIR plan's masks, drawn and written in one pass.

Column (b, j) of a Sparse-PIR batch gets Hamming weight ``w_q[b]`` at
``j == q_idx[b]`` and ``w_even[b, j]`` elsewhere; its ones sit on a
uniformly random w-subset of the d server slots, independent of every
other column. :func:`sparse_masks` returns the ``[d, B, n]`` uint8 masks
(``out[s, b, j] = 1`` where slot s is in column (b, j)'s subset), which
``backend.prepare`` and ``indices_from_mask`` consume.

The subset is drawn by Floyd's algorithm in min(w, d − w) steps (where
w > d/2 it draws the zeros and flips), each step one 64-bit uniform from
Philox4x32-10 under the plan's key (``key[0]``, ``key[1]``: 32 bits each)
with counter (column id lo, column id hi, step // 2, 0), column id
``b·n + j``; a call gives two draws, (words 0, 1) then (2, 3) as (lo, hi).
A draw x maps to [0, k) as ``floor(x·k / 2^64)``.

:func:`sparse_masks` launches ``csrc/sparse_masks.cu`` for tensors on the
card (it replaces no TPU kernel: the reference ranks the slots with
``jnp.argsort``, ``src/repro/core/sparse.py:109``; bound by the output's
d·B·n bytes) and takes :func:`sparse_masks_plain`, the same steps in torch
int64 arithmetic over the whole column grid, only for tensors on the CPU.
The two agree bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (
    check_launch, kernel_device, require, stream_ptr,
)

__all__ = ["sparse_masks", "sparse_masks_plain", "philox4x32_10"]

_LO32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # Philox4x32's multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # its key increments


def _mulhilo(m: int, x):
    """(hi, lo) 32-bit halves of ``m·x`` for a 32-bit constant ``m`` and
    ``x`` in [0, 2^32) (an int or an int64 tensor), exactly: ``x`` is split
    in 16-bit halves so that no product passes 2^48."""
    a = (x & 0xFFFF) * m
    b = (x >> 16) * m
    s = ((b & 0xFFFF) << 16) + a
    return (b >> 16) + (s >> 32), s & _LO32


def philox4x32_10(ctr, key):
    """Philox4x32-10 (Salmon et al., SC 2011): four 32-bit counter words
    (ints or int64 tensors in [0, 2^32)) and two key words -> four 32-bit
    output words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _LO32, (k1 + _W1) & _LO32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _check_args(w_even, w_q, q_idx, key, d: int) -> None:
    if w_even.dim() != 2 or w_q.dim() != 1 or q_idx.dim() != 1:
        raise ValueError(
            f"need w_even [B, n], w_q [B] and q_idx [B], got "
            f"{tuple(w_even.shape)}, {tuple(w_q.shape)} and "
            f"{tuple(q_idx.shape)}")
    b = w_even.shape[0]
    if w_q.shape[0] != b or q_idx.shape[0] != b:
        raise ValueError(f"w_q and q_idx must have B = {b} entries, got "
                         f"{w_q.shape[0]} and {q_idx.shape[0]}")
    if tuple(key.shape) != (2,):
        raise ValueError(f"key must be [2], got {tuple(key.shape)}")
    if not 1 <= d <= 255:
        raise ValueError(f"sparse_masks takes 1 <= d <= 255, got {d}")


def sparse_masks_plain(
    w_even: torch.Tensor, w_q: torch.Tensor, q_idx: torch.Tensor,
    key: torch.Tensor, d: int,
) -> torch.Tensor:
    """Plain PyTorch version: the kernel's Philox and Floyd steps, one step
    at a time over every column at once (the set lives in the ``[d, B·n]``
    output itself), then the flip of the columns that drew their zeros."""
    _check_args(w_even, w_q, q_idx, key, d)
    b, n = w_even.shape
    dev = w_even.device
    cols = b * n
    j = torch.arange(n, device=dev)
    q = q_idx.to(device=dev, dtype=torch.int64)
    w = torch.where(j == q[:, None], w_q.to(dev, torch.int64)[:, None],
                    w_even.to(torch.int64)).reshape(cols)
    flip = 2 * w > d
    k = torch.where(flip, d - w, w)
    out = torch.zeros((d, cols), dtype=torch.uint8, device=dev)
    col = torch.arange(cols, dtype=torch.int64, device=dev)
    k0, k1 = (int(v) & _LO32 for v in key.tolist())
    bound = d - k  # step i draws from [0, bound + i]
    for i in range(int(k.max()) if cols else 0):
        if i % 2 == 0:
            r = philox4x32_10((col & _LO32, col >> 32, i >> 1, 0), (k0, k1))
        lo, hi = (r[0], r[1]) if i % 2 == 0 else (r[2], r[3])
        active = i < k
        top = bound + i
        span = top + 1
        t = torch.where(active, (hi * span + ((lo * span) >> 32)) >> 32, 0)
        taken = out.gather(0, t[None])[0].bool()
        slot = torch.where(active, torch.where(taken, top, t), 0)[None]
        out.scatter_(0, slot, out.gather(0, slot) | active[None])
    out ^= flip.to(torch.uint8)[None]
    return out.reshape(d, b, n)


def sparse_masks(
    w_even: torch.Tensor, w_q: torch.Tensor, q_idx: torch.Tensor,
    key: torch.Tensor, d: int,
) -> torch.Tensor:
    """w_even: [B, n] uint8 even-parity column weights; w_q: [B] uint8
    weights of the queried columns; q_idx: [B] integer queried columns in
    [0, n); key: [2] int64 Philox key words (their low 32 bits) -> [d, B, n]
    uint8 masks."""
    _check_args(w_even, w_q, q_idx, key, d)
    if kernel_device(w_even, "sparse_masks") == "cpu":
        return sparse_masks_plain(w_even, w_q, q_idx, key, d)
    dev = w_even.device
    q_idx = q_idx.to(device=dev, dtype=torch.int64)
    require(w_even, "w_even", torch.uint8, 2, dev)
    require(w_q, "w_q", torch.uint8, 1, dev)
    require(q_idx, "q_idx", torch.int64, 1, dev)
    require(key, "key", torch.int64, 1, dev)
    b, n = w_even.shape
    out = torch.empty((d, b, n), dtype=torch.uint8, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.pir_sparse_masks(
            w_even.data_ptr(), w_q.data_ptr(), q_idx.data_ptr(),
            key.data_ptr(), out.data_ptr(), b, n, d, stream_ptr(dev),
        )
    sparse_masks.launches += 1
    check_launch(code, "sparse_masks")
    return out


sparse_masks.launches = 0
