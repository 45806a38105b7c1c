"""Standalone server answer paths over the kernels.

``server_answer_*`` are the server paths as plain functions (examples,
tests, measurements). ``auto`` picks a path from the batch size and θ;
the *serving* pipeline goes through the execution planner
(:mod:`repro_torch.kernels.backend`) instead, for which
:func:`parity_crossover_batch` is the prior of the fold/parity choice.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.gather_xor import gather_xor, indices_from_mask
from repro_torch.kernels.parity_matmul import parity_matmul_packed
from repro_torch.kernels.xor_fold import xor_fold

__all__ = [
    "server_answer_fold",
    "server_answer_parity",
    "server_answer_sparse",
    "server_answer_auto",
    "sparse_index_budget",
    "parity_crossover_batch",
    "PARITY_NEVER_WINS",
]


def server_answer_fold(db_packed: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Fold path: [n, W] db, [q, n] mask -> [q, W] words."""
    return xor_fold(db_packed, mask)


def server_answer_parity(db_planes: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Parity path: [n, Bbits] planes, [q, n] mask -> packed [q, W] words
    (the kernel packs the bits in its epilogue)."""
    return parity_matmul_packed(mask, db_planes)


def server_answer_sparse(
    db_packed: torch.Tensor, mask: torch.Tensor, theta: float, **kw
) -> torch.Tensor:
    """Sparse gather path: only θ·n records touched (Table 1 C_p)."""
    m = sparse_index_budget(db_packed.shape[0], theta)
    return gather_xor(db_packed, indices_from_mask(mask, m), **kw)


def sparse_index_budget(n: int, theta: float, slack_sigmas: float = 6.0) -> int:
    """Static per-query index budget: θ·n + 6σ of Binomial(n, θ), rounded
    up to a multiple of 8. P[weight > budget] < 1e-9 (Chernoff)."""
    mean = theta * n
    sigma = math.sqrt(n * theta * (1.0 - theta))
    m = int(math.ceil(mean + slack_sigmas * sigma))
    return min(n, -(-m // 8) * 8)


# A batch size no scheduler bucket reaches: "the parity path never wins".
PARITY_NEVER_WINS = 1 << 30


def parity_crossover_batch(n: int, record_bits: int) -> int:
    """Batch size from which the parity path beats the fold — the prior of
    the execution planner's fold/parity choice. Measured, not modelled:

    on an NVIDIA H100 80GB HBM3 (power limit 700.00 W, ``chip_smoke.py``
    phase ``crossover``, the full 12 288 bit columns, the planes held
    n-contiguous as the planner holds them) ``xor_fold`` (its table form
    from 9 queries on) against ``parity_matmul_packed`` took, in ms at
    buckets 8 / 32 / 64 / 128 / 256 / 512 / 1024 (one run):

    - n cut to 65 536: fold 0.0554 / 0.0780 / 0.1108 / 0.171 / 0.295 /
      0.558 / 1.046, parity 0.287 / 0.287 / 0.289 / 0.298 / 0.356 / 0.563
      / 1.054. From 512 up the two paths are level, within 3 % either
      way: in eight runs of the phase parity first won at 512 four
      times, at 1024 three times and at no bucket once. 512, the smallest
      of those answers, is kept; it is a tie, not a crossover;
    - n = 10^6 (no 512): fold 0.562 / 0.859 / 1.309 / 2.070 / 3.820 / — /
      15.0, parity 4.08 / 4.17 / 4.23 / 4.19 / 4.73 / — / 23.9: the fold
      wins at every bucket (eight runs).

    The fold's table form reads the packed store once per 256 queries and
    pays shared-memory reads in proportion to q; the parity kernel reads
    the planes (one byte per record bit, 8x the store) once, whatever q up
    to about 256, and carries a fixed cost (launch, the output's zeroing,
    the last wave's tail) that weighs at small n. So the fold gains on
    parity as n grows. Between and beyond the two measured sizes the
    function takes the nearer one's on a log scale: 512 below n = 256 000
    (about the geometric mean of 65 536 and 10^6), never from there. Both
    sides grow alike with the record width (the fold reads 4 bytes a
    word, the parity kernel one a bit), so ``record_bits`` does not move
    the crossover to first order; both measurements are at 12 288 bits.
    """
    del record_bits  # see above
    return 512 if n < 256_000 else PARITY_NEVER_WINS


def server_answer_auto(
    db_packed: torch.Tensor,
    db_planes: Optional[torch.Tensor],
    mask: torch.Tensor,
    theta: Optional[float] = None,
) -> torch.Tensor:
    q, n = mask.shape
    if theta is not None and theta < 0.5:
        return server_answer_sparse(db_packed, mask, theta)
    if db_planes is not None and q >= parity_crossover_batch(
        n, db_packed.shape[1] * 32
    ):
        return server_answer_parity(db_planes, mask)
    return server_answer_fold(db_packed, mask)
