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

from repro_torch.db import packing
from repro_torch.kernels.gather_xor import gather_xor, indices_from_mask
from repro_torch.kernels.parity_matmul import parity_matmul
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
    """Parity path: [n, Bbits] planes, [q, n] mask -> packed [q, W] words."""
    return packing.pack_bits(parity_matmul(mask, db_planes))


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

    on an NVIDIA H100 80GB HBM3 (power limit 700.00 W, 2026-10-16,
    ``chip_smoke.py`` phase ``crossover``: n cut to 65 536 records, the
    full 12 288 bit columns) ``xor_fold`` took 0.060 / 0.46 / 3.2 ms at
    buckets 8 / 128 / 1024 and ``parity_matmul`` + ``pack_bits`` 5.0 /
    7.3 / 47.9 ms: the parity path lost at every scheduler bucket, by 15×
    or more. The fold streams the packed store once per eight queries;
    the integer product reads the same records as eight times the bytes
    (one uint8 per bit) and does 2·q·n·B operations on top. So the
    function returns :data:`PARITY_NEVER_WINS`, above any bucket; a
    faster parity kernel has to re-measure before it lowers this.
    """
    del n, record_bits  # the ratio held across every bucket measured
    return PARITY_NEVER_WINS


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
