"""Sparse-PIR (paper §4.3): sparse Chor request vectors.

Each column of the d×n query matrix is sampled by d Bernoulli(θ) trials
conditioned on even parity (non-queried records) or odd parity (the sought
record). The paper's equivalent sampling procedure — pick a
parity-correct Hamming weight from the conditioned binomial pmf, then a
uniform vector of that weight — is what is implemented, because it is
rejection-free: the weights are drawn over the whole [B, n] column grid,
and :func:`~repro_torch.kernels.sparse_masks.sparse_masks` draws each
column's uniform subset of that weight under a Philox key and writes the
[d, B, n] masks in one pass.

Server logic is *identical* to Chor (the server may be agnostic, §4.3);
only the expected row weight drops from n/2 to θ·n, which the gather_xor
kernel exploits (C_p = θ·d·n·(c_acc+c_prc), Table 1).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import chor
from repro_torch.db import packing
from repro_torch.kernels.sparse_masks import sparse_masks

__all__ = [
    "MAX_CARD_DRAWS",
    "parity_weight_logits",
    "SparsePre",
    "precompute_query_randomness",
    "assemble_query_matrix",
    "gen_query_matrix",
    "gen_queries",
    "server_answer",
    "reconstruct",
    "retrieve",
    "expected_row_weight",
]

server_answer = chor.server_answer
reconstruct = chor.reconstruct

# the most draws one torch.multinomial call makes right on a CUDA
# generator: on an H100 with torch 2.11, 2^30 - 1 draws came out right and
# 2^30 + 1 wrote out of bounds, which spoils the process's CUDA context
# (scripts/multinomial_probe.py). A plan draws B·n column weights, so
# :func:`_categorical` draws a larger count in calls of at most this many
MAX_CARD_DRAWS = (1 << 30) - 1


def parity_weight_logits(d: int, theta: float) -> np.ndarray:
    """log pmf of the Hamming weight of d Bernoulli(θ) trials, conditioned
    on parity. Returns [2, d+1]: row 0 = even weights, row 1 = odd weights
    (invalid parities at -inf). Host-side constant (d is small)."""
    w = np.arange(d + 1, dtype=np.float64)
    log_comb = np.array(
        [math.lgamma(d + 1) - math.lgamma(k + 1) - math.lgamma(d - k + 1)
         for k in range(d + 1)]
    )
    if theta >= 0.5:
        # log(theta) == log(1-theta); avoid log(0) when theta == 0.5 exactly
        log_pmf = log_comb + d * math.log(0.5)
    else:
        log_pmf = log_comb + w * math.log(theta) + (d - w) * math.log1p(-theta)
    out = np.full((2, d + 1), -np.inf)
    out[0, 0::2] = log_pmf[0::2]
    out[1, 1::2] = log_pmf[1::2]
    return out


@dataclasses.dataclass(frozen=True)
class SparsePre:
    """The query-independent half of a Sparse-PIR batch plan.

    ``w_even`` are the even-parity weights for every column, ``w_q`` the
    odd-parity weights the queried columns will be switched to, and
    ``key`` the Philox key under which each column's slots are drawn.
    :func:`assemble_query_matrix` finishes the plan with one
    :func:`~repro_torch.kernels.sparse_masks.sparse_masks` call.
    Single-use by contract. Weights are stored uint8 (d ≤ 255), so a batch
    holds B·n + B + 16 bytes.
    """

    w_even: torch.Tensor  # [B, n] uint8 even-parity column weights
    w_q: torch.Tensor     # [B] uint8 odd-parity weights for queried columns
    key: torch.Tensor     # [2] int64 Philox key words, each in [0, 2^32)
    n: int
    d: int

    @property
    def batch(self) -> int:
        return int(self.w_even.shape[0])


def _categorical(
    gen: torch.Generator, logits: np.ndarray, count: int
) -> torch.Tensor:
    """``count`` uint8 draws from softmax(logits) (at most 256 classes). A
    weight at -inf gets probability exactly 0 — that is what enforces the
    parity.

    A count within ``MAX_CARD_DRAWS`` is one ``torch.multinomial`` call; a
    larger one is drawn in calls of at most that many, one after another
    from ``gen``, each written into one preallocated uint8 tensor (the
    int64 of a single call would be 8 bytes a draw: 12 GB at 1.5·10^9)."""
    logits = logits - logits[np.isfinite(logits)].max()
    probs = torch.tensor(np.exp(logits), dtype=torch.float32,
                         device=gen.device)
    if count <= MAX_CARD_DRAWS:
        return torch.multinomial(probs, count, replacement=True,
                                 generator=gen).to(torch.uint8)
    out = torch.empty((count,), dtype=torch.uint8, device=gen.device)
    for lo in range(0, count, MAX_CARD_DRAWS):
        hi = min(count, lo + MAX_CARD_DRAWS)
        out[lo:hi] = torch.multinomial(probs, hi - lo, replacement=True,
                                       generator=gen)
    return out


def precompute_query_randomness(
    gen: torch.Generator, n: int, d: int, theta: float, b: int
) -> SparsePre:
    """Pre-sample the query-independent randomness for a [B]-batch."""
    if d < 2:
        raise ValueError(f"Sparse-PIR needs d >= 2 servers, got {d}")
    if d > 255:
        raise ValueError(f"uint8 weight storage needs d <= 255, got {d}")
    logits = parity_weight_logits(d, theta)
    w_even = _categorical(gen, logits[0], b * n).reshape(b, n)
    w_q = _categorical(gen, logits[1], b)
    # the uniform choice of `w` slots out of d is drawn at assembly, from
    # Philox under this key: nothing of size B·n·d is held in the plan
    key = torch.randint(0, 1 << 32, (2,), generator=gen, device=gen.device,
                        dtype=torch.int64)
    return SparsePre(w_even=w_even, w_q=w_q, key=key, n=n, d=d)


def assemble_query_matrix(pre: SparsePre, q_idx: torch.Tensor) -> torch.Tensor:
    """Finish a precomputed plan for the actual indices: [d, B, n] uint8."""
    (b,) = q_idx.shape
    if b != pre.batch:
        raise ValueError(f"pre built for batch {pre.batch}, got {b}")
    return sparse_masks(pre.w_even, pre.w_q, q_idx, pre.key, pre.d)


def gen_query_matrix(
    gen: torch.Generator, n: int, d: int, theta: float, q_idx: torch.Tensor
) -> torch.Tensor:
    """Sample the query matrices for a batch: returns [d, B, n] uint8 bits.

    Column parity is even everywhere except at q_idx (odd), so rows XOR to
    one-hot(q_idx). Each column's weight follows the parity-conditioned
    Binomial(d, θ); positions of the ones are uniform given the weight.
    """
    (b,) = q_idx.shape
    return assemble_query_matrix(
        precompute_query_randomness(gen, n, d, theta, b), q_idx
    )


def gen_queries(
    gen: torch.Generator, n: int, d: int, theta: float, q_idx: torch.Tensor
) -> torch.Tensor:
    """Packed wire format: [d, B, ceil(n/32)] words."""
    return packing.pack_bits(gen_query_matrix(gen, n, d, theta, q_idx))


def expected_row_weight(n: int, theta: float) -> float:
    """E[ones per request vector] = θ·n (paper §4.3)."""
    return theta * n


def retrieve(
    gen: torch.Generator, store, d: int, theta: float, q_idx: torch.Tensor
) -> torch.Tensor:
    """End-to-end Sparse-PIR retrieval (reference path): [B] -> [B, W]."""
    masks = gen_query_matrix(gen, store.n, d, theta, q_idx)  # [d, B, n]
    responses = torch.stack([server_answer(store.packed, m) for m in masks])
    return reconstruct(responses)
