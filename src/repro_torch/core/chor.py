"""Chor et al. (1995) IT-PIR — the paper's perfectly-private baseline.

Client: build d binary request vectors of length n whose XOR is e_Q (all
zeros except a 1 at the sought index). Server: XOR every record whose bit
is set. Client: XOR the d responses to recover record Q.

All functions are batch-first: ``q_idx`` has shape [B] and queries are
generated for all B users at once. Request vectors are produced
bit-packed ([d, B, ceil(n/32)] words, the wire format) and as {0,1} masks
on demand. Randomness comes from an explicit ``torch.Generator`` on the
tensors' device.

``server_answer`` is the single-store server path of the staged schemes'
``answer`` stage: the ``xor_fold`` kernel for a store on the card, its
plain version for a store on the CPU. The planned production server paths
live in :mod:`repro_torch.kernels.backend`.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.db import packing
from repro_torch.db.store import RecordStore
from repro_torch.kernels._common import xor_reduce
from repro_torch.kernels.xor_fold import xor_fold

__all__ = [
    "ChorPre",
    "precompute_queries",
    "assemble_queries",
    "gen_queries",
    "query_masks",
    "server_answer",
    "reconstruct",
    "retrieve",
]


@dataclasses.dataclass(frozen=True)
class ChorPre:
    """The query-independent half of a Chor batch plan.

    ``rand`` ([d−1, B, Wn] words) are the first d−1 request vectors — pure
    randomness, independent of which records the batch asks for — and
    ``fold`` ([B, Wn]) is their XOR. Only the last vector depends on the
    queried indices (``fold ^ e_Q``). Single-use by contract: reusing one
    ChorPre for two batches would correlate the adversary's views across
    those batches.
    """

    rand: torch.Tensor  # [d-1, B, Wn] words
    fold: torch.Tensor  # [B, Wn] words
    n: int

    @property
    def d(self) -> int:
        return int(self.rand.shape[0]) + 1

    @property
    def batch(self) -> int:
        return int(self.rand.shape[1])


def precompute_queries(
    gen: torch.Generator, n: int, d: int, b: int
) -> ChorPre:
    """Pre-generate the query-independent randomness for a [B]-batch."""
    if d < 2:
        raise ValueError(f"Chor PIR needs d >= 2 servers, got {d}")
    wn = packing.words_per_record(n)
    # uniform over all 2^32 word values: the full int32 range
    rand = torch.randint(
        -(2**31), 2**31, (d - 1, b, wn), dtype=packing.WORD_DTYPE,
        generator=gen, device=gen.device,
    )
    return ChorPre(rand=rand, fold=xor_reduce(rand, 0), n=n)


def assemble_queries(pre: ChorPre, q_idx: torch.Tensor) -> torch.Tensor:
    """Finish a precomputed plan for the actual indices: [d, B, Wn]."""
    (b,) = q_idx.shape
    if b != pre.batch:
        raise ValueError(f"pre built for batch {pre.batch}, got {b}")
    q_idx = q_idx.to(pre.fold.device).long()
    word = q_idx // packing.WORD_BITS
    bit = (q_idx % packing.WORD_BITS).to(packing.WORD_DTYPE)
    # packed one-hot e_Q (1 << 31 wraps to the sign bit: the right word)
    e_q = torch.zeros_like(pre.fold)
    e_q[torch.arange(b, device=e_q.device), word] = (
        torch.ones_like(bit) << bit
    )
    last = pre.fold ^ e_q
    return torch.cat([pre.rand, last.unsqueeze(0)], dim=0)


def gen_queries(
    gen: torch.Generator, n: int, d: int, q_idx: torch.Tensor
) -> torch.Tensor:
    """Request vectors for a batch of queries: packed bits, shape
    [d, B, Wn] with Wn = ceil(n/32); the element-wise XOR over axis 0
    unpacks to one-hot(q_idx, n)."""
    (b,) = q_idx.shape
    return assemble_queries(precompute_queries(gen, n, d, b), q_idx)


def query_masks(q_packed: torch.Tensor, n: int) -> torch.Tensor:
    """[d, B, Wn] packed request vectors -> [d, B, n] {0,1} uint8 masks
    (one server at a time, so the 32-bit intermediate of the unpack stays
    a single server's size)."""
    if q_packed.dim() < 3:
        return packing.unpack_bits(q_packed, n)
    return torch.stack([packing.unpack_bits(s, n) for s in q_packed])


def server_answer(db_packed: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Server: XOR-fold the selected packed records (the ``xor_fold``
    kernel on the card, its plain version on the CPU).

    db_packed: [n, W] words; mask: [B, n] {0,1}; returns [B, W] words.
    """
    return xor_fold(db_packed, mask)


def reconstruct(responses: torch.Tensor) -> torch.Tensor:
    """XOR the per-server responses: [d, B, W] -> [B, W] words."""
    return xor_reduce(responses, 0)


def retrieve(
    gen: torch.Generator, store: RecordStore, d: int, q_idx: torch.Tensor
) -> torch.Tensor:
    """End-to-end Chor retrieval (reference path): [B] indices -> [B, W]."""
    q = gen_queries(gen, store.n, d, q_idx)
    masks = query_masks(q, store.n)  # [d, B, n]
    responses = torch.stack([server_answer(store.packed, m) for m in masks])
    return reconstruct(responses)
