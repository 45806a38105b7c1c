"""Direct Requests (paper §4.1) and the Naive Dummy scheme (§3.1).

Direct Requests: the client sends its real query plus p−1 *distinct* dummy
indices, partitioned evenly over the d databases; each database simply
returns the records asked of it (C_p = p·c_acc — no XOR processing).

Naive Dummies (§3.1) is the single-database special case (d = 1); it is NOT
ε-private (Vulnerability Thm 1) and exists here so the adversary game can
show the unbounded likelihood ratio.

The server's gather is ``index_select`` on the packed store: the reference
computes it with ``jnp.take`` outside any TPU kernel, so there is no kernel
to port. Randomness comes from an explicit ``torch.Generator`` on the
tensors' device; its stream cannot replay the reference's, so the two
packages agree on the law of the requests, not on their bits.
"""

from __future__ import annotations

import torch

from repro_torch.db.store import RecordStore
from repro_torch.kernels._common import xor_reduce

__all__ = [
    "gen_queries",
    "server_answer",
    "select_response",
    "retrieve",
]

# elements of the [rows, n−1] uniform keys drawn at once when choosing the
# dummies: bounds the draw to 256 MB of float32 at any batch
_KEY_CHUNK_ELEMS = 1 << 26


def _distinct_dummies(gen: torch.Generator, n: int, k: int, b: int
                      ) -> torch.Tensor:
    """[b, k] int64: each row a uniform k-subset of [0, n) (no repeats),
    from the k largest of n iid uniform keys, in chunks of rows."""
    rows_per = max(1, _KEY_CHUNK_ELEMS // max(n, 1))
    parts = []
    for lo in range(0, b, rows_per):
        keys = torch.rand((min(rows_per, b - lo), n), generator=gen,
                          device=gen.device)
        parts.append(torch.topk(keys, k, dim=1, sorted=False).indices)
    return torch.cat(parts)


def gen_queries(
    gen: torch.Generator, n: int, d: int, p: int, q_idx: torch.Tensor
) -> torch.Tensor:
    """Sample p distinct indices containing q_idx, shuffled, split over d.

    Returns [d, B, p//d] int32 — the requests each database receives.
    Matches Algorithm 4.1: p−1 dummies uniform over [0, n) \\ {Q} without
    repeats, the real query hidden at a uniformly random position.
    """
    if p % d != 0:
        raise ValueError(f"p must be a multiple of d (p={p}, d={d})")
    if not (1 < p <= n):
        raise ValueError(f"need 1 < p <= n, got p={p}, n={n}")
    (b,) = q_idx.shape
    dev = gen.device
    q = q_idx.to(dev).long()
    # p−1 distinct dummies from [0, n−1), then shifted past q
    dummies = _distinct_dummies(gen, n - 1, p - 1, b)
    dummies = dummies + (dummies >= q[:, None]).long()
    req = torch.cat([q[:, None], dummies], dim=1)  # [B, p]
    # a uniform permutation of each row
    order = torch.argsort(torch.rand((b, p), generator=gen, device=dev),
                          dim=1)
    req = torch.gather(req, 1, order)
    return req.reshape(b, d, p // d).permute(1, 0, 2).to(
        torch.int32).contiguous()


def server_answer(db_packed: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain gather: [n, W] records, [B, k] indices -> [B, k, W]."""
    return db_packed.index_select(0, idx.reshape(-1).long()).reshape(
        *idx.shape, db_packed.shape[1])


def select_response(
    requests: torch.Tensor, responses: torch.Tensor, q_idx: torch.Tensor
) -> torch.Tensor:
    """Pick the record matching the real query.

    requests: [d, B, k] indices; responses: [d, B, k, W]; q_idx: [B].
    Returns [B, W]. Exactly one (server, slot) matches per batch element
    because the p indices are distinct, so the XOR over the masked
    responses is that one record.
    """
    hit = requests == q_idx.to(requests.device)[None, :, None]
    picked = torch.where(hit[..., None], responses,
                         torch.zeros((), dtype=responses.dtype,
                                     device=responses.device))
    d, b, k, w = responses.shape
    return xor_reduce(picked.permute(0, 2, 1, 3).reshape(d * k, b, w), 0)


def retrieve(
    gen: torch.Generator, store: RecordStore, d: int, p: int,
    q_idx: torch.Tensor,
) -> torch.Tensor:
    """End-to-end Direct Requests (reference path): [B] -> [B, W]."""
    reqs = gen_queries(gen, store.n, d, p, q_idx)
    resp = torch.stack([server_answer(store.packed, r) for r in reqs])
    return select_response(reqs, resp, q_idx)
